"""The paper's evaluation on the port: Table 3 (its left half, the unit-gate
hardware proxies; its right half, the error metrics), Table 4 (Sobel edge
detection) and Fig. 5 (K-means colour quantisation), printed beside the
paper's values.

    python -m repro_torch.launch.paper [--only table3_hw|table3|table4|fig5] [--device cpu]

The work runs on the card unless ``--device cpu`` is given (the hardware
proxies are arithmetic on the netlists of ``core/hw_model.py`` and run on
the host either way).  The E2AFS rows
of Table 4 and Fig. 5 go through the fused ``sobel`` and ``kmeans_assign``
kernels (on the CPU: their plain versions); the other units run their plain
datapaths.  Fig. 5 runs at the paper's 256 x 256.  The images are the
procedural stand-ins of :mod:`repro_torch.apps.images`, so Table 4 and Fig. 5
are compared with the paper by ordering, not by value.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.apps import kmeans, sobel
from repro_torch.apps.images import IMAGE_NAMES, rgb_test_image, test_image
from repro_torch.apps.metrics_img import psnr, ssim
from repro_torch.core import error_metrics, get_unit, hw_model

__all__ = ["UNITS", "PAPER_TABLE3", "PAPER_TABLE4_AVG", "table3_hw", "table3", "table4", "fig5",
           "main"]

UNITS = ("esas", "cwaha4", "cwaha8", "e2afs")

# The paper's Table 3: MED, MRED (e-2), NMED (e-2), MSE, EDmax over FP16
PAPER_TABLE3 = {
    "esas": (0.4625, 1.7508, 0.1807, 2.041, 12.33),
    "cwaha4": (0.5436, 2.1823, 0.2124, 2.079, 11.34),
    "cwaha8": (0.2891, 1.1436, 0.1129, 0.899, 8.68),
    "e2afs": (0.4024, 1.5264, 0.1572, 1.414, 9.98),
}
# The paper's Table 4 averages over its four images: PSNR, SSIM
PAPER_TABLE4_AVG = {
    "esas": (45.964, 0.9923),
    "cwaha4": (45.374, 0.9906),
    "cwaha8": (46.946, 0.9944),
    "e2afs": (46.388, 0.9941),
}


def md_table(headers, rows) -> str:
    out = ["| " + " | ".join(headers) + " |", "|" + "|".join("---" for _ in headers) + "|"]
    out += ["| " + " | ".join(str(c) for c in r) + " |" for r in rows]
    return "\n".join(out)


def table3_hw() -> dict:
    """Table 3's left half: the unit-gate proxies of each design, calibrated
    on the E2AFS row, beside the paper's Artix-7 figures."""
    t = hw_model.calibrated_table()
    rows = []
    for name in UNITS:
        c, p = t[name], hw_model.PAPER_TABLE3[name]
        rows.append([name, f"{c['luts_proxy']:.0f} ({p['luts']})",
                     f"{c['dp_mw_proxy']:.2f} ({p['dp_mw']})",
                     f"{c['cpd_ns_proxy']:.2f} ({p['cpd_ns']})",
                     f"{c['pdp_pj_proxy']:.1f} ({p['pdp_pj']})"])
    print("\n== Table 3 (hardware proxies, calibrated on the E2AFS row) ==")
    print(md_table(["design", "LUT proxy (paper)", "DP mW proxy (paper)",
                    "CPD ns proxy (paper)", "PDP pJ proxy (paper)"], rows))
    print("(baseline netlists are reconstructions)")
    return t


def table3(device=None) -> dict:
    """Exhaustive FP16 error metrics of every design, and of E2AFS-R."""
    out, rows = {}, []
    for name in UNITS:
        m = error_metrics(get_unit(name).sqrt, device=device)
        p = PAPER_TABLE3[name]
        out[name] = m
        rows.append([name, f"{m.med:.4f} ({p[0]})", f"{m.mred * 100:.4f} ({p[1]})",
                     f"{m.nmed * 100:.4f} ({p[2]})", f"{m.mse:.3f} ({p[3]})",
                     f"{m.ed_max:.2f} ({p[4]})"])
    m = error_metrics(get_unit("e2afs").rsqrt, reference="rsqrt", device=device)
    out["e2afs_rsqrt"] = m
    rows.append(["e2afs-R (rsqrt)", f"{m.med:.4f}", f"{m.mred * 100:.4f}",
                 f"{m.nmed * 100:.4f}", f"{m.mse:.3f}", f"{m.ed_max:.2f}"])
    print("\n== Table 3 (FP16 error metrics, ours (paper)) ==")
    print(md_table(["design", "MED", "MRED e-2", "NMED e-2", "MSE", "EDmax"], rows))
    return out


def table4(device=None, n: int = 256) -> dict:
    """Sobel edge maps of the four stand-in images through each unit, PSNR
    and SSIM against the exact-sqrt edge map."""
    per_image = {}
    for name in IMAGE_NAMES:
        img = test_image(name, n)
        exact = sobel.edge_map(img, "exact", device=device)
        per_image[name] = {}
        for u in UNITS:
            approx = sobel.edge_map(img, u, use_kernel=u == "e2afs", device=device)
            per_image[name][u] = {"psnr": psnr(exact, approx), "ssim": ssim(exact, approx)}
    rows = []
    for u in UNITS:
        ps = [per_image[name][u]["psnr"] for name in IMAGE_NAMES]
        ss = [per_image[name][u]["ssim"] for name in IMAGE_NAMES]
        p = PAPER_TABLE4_AVG[u]
        rows.append([u, *(f"{v:.2f}" for v in ps), f"{np.mean(ps):.2f} ({p[0]})",
                     f"{np.mean(ss):.4f} ({p[1]})"])
    print(f"\n== Table 4 (Sobel PSNR per image, average PSNR and SSIM (paper); {n} x {n} "
          f"stand-ins) ==")
    print(md_table(["design", *IMAGE_NAMES, "avg PSNR", "avg SSIM"], rows))
    return per_image


def fig5(device=None, n: int = 256, k: int = 20, iters: int = 12) -> dict:
    """K-means colour quantisation of the peppers stand-in through each unit
    (and exact), PSNR and SSIM of the grey levels against the original."""
    rgb = rgb_test_image("peppers", n)
    out = {}
    for u in UNITS + ("exact",):
        quant, _ = kmeans.kmeans_quantize(rgb, k=k, iters=iters, sqrt_unit=u,
                                          fused=u == "e2afs", device=device)
        gray_q, gray_o = quant.mean(-1), rgb.mean(-1)
        out[u] = {"psnr": psnr(gray_o, gray_q), "ssim": ssim(gray_o, gray_q)}
    print(f"\n== Fig. 5 (K-means K={k}, {iters} iterations, peppers stand-in {n} x {n}) ==")
    print(md_table(["design", "PSNR", "SSIM"],
                   [[u, f"{r['psnr']:.2f}", f"{r['ssim']:.4f}"] for u, r in out.items()]))
    gap = abs(out["e2afs"]["psnr"] - out["cwaha8"]["psnr"])
    print(f"  |e2afs - cwaha8| PSNR gap: {gap:.2f} dB (paper: 'closely aligned')")
    return out


PARTS = {"table3_hw": lambda device: table3_hw(), "table3": table3, "table4": table4,
         "fig5": fig5}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=sorted(PARTS), default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for name, part in PARTS.items():
        if args.only in (None, name):
            part(device=args.device)


if __name__ == "__main__":
    main()
