"""The torch port's paper-evaluation path held against the JAX package.

Inputs are made with numpy (from a seed, or the procedural stand-in images)
and go through ``repro`` and ``repro_torch`` as numpy arrays, on the CPU,
where each kernel wrapper runs its plain version.  The CUDA kernels are held
against those plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

Tolerances and their reasons:
* ESAS and CWAHA sqrt, and their composed rsqrt: bit-identical (integer
  datapaths; the reciprocal is a correctly rounded division on both sides).
* error metrics: equal to 1e-12 relative (the same float64 numpy arithmetic
  on the same bits).
* stand-in images, PSNR, SSIM: equal (the same numpy code).
* ``ref_sobel``, ``edge_map``, ``evaluate_units``: bit-identical (the same
  float32 operations in the same order, each rounded on its own).
* ``ref_kmeans_assign``: assignments and counts equal, sums within 1e-6
  relative (only the order of the float32 sums differs).
* ``lloyd``: 12 iterations from the same starting centroids; the sums'
  order compounds through the centroid updates, so centroids within 1e-3
  absolute (pixel values are in [0, 255]) and at least 99.9% of the
  assignments equal.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.apps import images as jax_images
from repro.apps import kmeans as jax_kmeans
from repro.apps import metrics_img as jax_metrics_img
from repro.apps import sobel as jax_sobel
from repro.core import available_units as jax_available_units
from repro.core import error_metrics as jax_error_metrics
from repro.core import get_unit as jax_get_unit
from repro.core import metrics as jax_metrics
from repro.core import numerics as jax_numerics
from repro.kernels.kmeans.ref import ref_kmeans_assign as jax_ref_kmeans_assign
from repro.kernels.sobel.ref import ref_sobel as jax_ref_sobel
from repro_torch.apps import images, kmeans, metrics_img, sobel
from repro_torch.core import available_units, error_metrics, get_unit, metrics, numerics
from repro_torch.kernels import dispatch
from repro_torch.kernels.kmeans import ops as kmeans_ops
from repro_torch.kernels.kmeans.ref import ref_kmeans_assign
from repro_torch.kernels.sobel import ops as sobel_ops
from repro_torch.kernels.sobel.ref import ref_sobel
from repro_torch.launch import paper

_NP = {"fp16": np.float16, "bf16": ml_dtypes.bfloat16, "fp32": np.float32}
_NP_INT = {"fp16": np.int16, "bf16": np.int16, "fp32": np.int32}
_TORCH = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}
_TORCH_INT = {"fp16": torch.int16, "bf16": torch.int16, "fp32": torch.int32}
BASELINES = ("esas", "cwaha4", "cwaha8")


def _patterns(name):
    """Every fp16/bf16 bit pattern, or the fp32 grid plus specials."""
    if name == "fp32":
        a = np.asarray(jax_metrics.sampled_normal_values(jax_numerics.FP32))
        a = np.concatenate([a, np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -2.0, 1e-40,
                                         -1e-40], np.float32)])
    else:
        a = np.arange(1 << 16, dtype=np.uint16).view(_NP[name])
    return a, torch.from_numpy(a.view(_NP_INT[name]).copy()).view(_TORCH[name])


def _n_differ(jax_out, torch_out, name):
    a = np.asarray(jax_out)
    same = a.view(_NP_INT[name]) == torch_out.view(_TORCH_INT[name]).numpy()
    both_nan = np.isnan(a.astype(np.float32)) & torch.isnan(torch_out.float()).numpy()
    return int((~(same | both_nan)).sum())


# -- core: baselines and metrics --------------------------------------------

@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
@pytest.mark.parametrize("name", ["fp16", "bf16", "fp32"])
@pytest.mark.parametrize("unit", BASELINES)
def test_baseline_units_bit_identical(unit, name, op):
    a, t = _patterns(name)
    ours = getattr(get_unit(unit), op)(t)
    ref = getattr(jax_get_unit(unit), op)(jnp.asarray(a))
    assert ours.dtype == t.dtype
    assert _n_differ(ref, ours, name) == 0


def test_available_units_match():
    assert available_units() == jax_available_units()
    with pytest.raises(ValueError, match="CWAHA variants"):
        from repro_torch.core.cwaha import cwaha_sqrt

        cwaha_sqrt(torch.ones(3), k=5)


@pytest.mark.parametrize("name", ["fp16", "bf16"])
def test_positive_normal_values_match(name):
    ours = metrics.positive_normal_values(getattr(numerics, name.upper()))
    ref = np.asarray(jax_metrics.positive_normal_values(getattr(jax_numerics, name.upper())))
    assert ours.dtype == _TORCH[name]
    np.testing.assert_array_equal(ours.view(torch.int16).numpy(), ref.view(np.int16))
    with pytest.raises(ValueError, match="16-bit"):
        metrics.positive_normal_values(numerics.FP32)


@pytest.mark.parametrize("fmt", ["fp16", "fp32"])
@pytest.mark.parametrize("unit", ["esas", "cwaha4", "cwaha8", "e2afs", "e2afs-R"])
def test_error_metrics_match(unit, fmt):
    op, reference = ("rsqrt", "rsqrt") if unit == "e2afs-R" else ("sqrt", "sqrt")
    name = "e2afs" if unit == "e2afs-R" else unit
    ours = error_metrics(getattr(get_unit(name), op), getattr(numerics, fmt.upper()),
                         reference=reference, mans_per_exp=64, device="cpu")
    ref = jax_error_metrics(getattr(jax_get_unit(name), op), getattr(jax_numerics, fmt.upper()),
                            reference=reference, mans_per_exp=64)
    for key, value in ref.as_dict().items():
        assert getattr(ours, key) == pytest.approx(value, rel=1e-12, abs=0), key
    assert str(ours) == str(ref)


def test_error_metrics_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        error_metrics(get_unit("e2afs").sqrt)


# -- apps: images and image metrics -------------------------------------------

@pytest.mark.parametrize("name", images.IMAGE_NAMES)
def test_images_match(name):
    np.testing.assert_array_equal(images.test_image(name, 96), jax_images.test_image(name, 96))
    np.testing.assert_array_equal(images.rgb_test_image(name, 40),
                                  jax_images.rgb_test_image(name, 40))


def test_psnr_ssim_match():
    rng = np.random.default_rng(0)
    a = images.test_image("boat", 64)
    b = np.clip(a + rng.normal(0, 5, a.shape), 0, 255)
    assert metrics_img.psnr(a, b) == jax_metrics_img.psnr(a, b)
    assert metrics_img.ssim(a, b) == jax_metrics_img.ssim(a, b)
    assert metrics_img.psnr(a, a) == float("inf")


# -- Sobel ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3), (34, 131), (67, 93), "house"])
def test_ref_sobel_bit_identical(shape):
    if shape == "house":
        img = images.test_image("house", 64)
    else:
        img = np.random.default_rng(sum(shape)).uniform(0, 255, shape)
    x = img.astype(np.float32)
    for unit in ("e2afs", "exact", "cwaha8"):
        ours = ref_sobel(torch.from_numpy(x), sqrt_unit=unit)
        ref = np.asarray(jax_ref_sobel(jnp.asarray(x), sqrt_unit=unit))
        assert ours.shape == (x.shape[0] - 2, x.shape[1] - 2)
        np.testing.assert_array_equal(ours.numpy().view(np.int32), ref.view(np.int32))
    # the wrapper's CPU route is the plain version, and launches nothing
    dispatch.reset_launch_counts()
    img = torch.from_numpy(x)
    assert torch.equal(sobel_ops.sobel_magnitude(img), ref_sobel(img))
    assert dispatch.launch_counts()["sobel"] == 0


@pytest.mark.parametrize("unit", ["exact", "esas", "cwaha4", "cwaha8", "e2afs"])
def test_edge_map_matches(unit):
    img = images.test_image("barbara", 64)
    ours = sobel.edge_map(img, unit, device="cpu")
    assert ours.dtype == np.float64
    np.testing.assert_array_equal(ours, jax_sobel.edge_map(img, unit))
    if unit == "e2afs":  # the kernel route's plain version on the CPU
        np.testing.assert_array_equal(sobel.edge_map(img, unit, use_kernel=True, device="cpu"),
                                      ours)


def test_evaluate_units_matches():
    img = images.test_image("peppers", 64)
    assert sobel.evaluate_units(img, device="cpu") == jax_sobel.evaluate_units(img)


def test_edge_map_refuses():
    img = images.test_image("house", 16)
    with pytest.raises(ValueError, match="requires sqrt_unit='e2afs'"):
        sobel.edge_map(img, "esas", use_kernel=True, device="cpu")
    if not torch.cuda.is_available():  # no device named: the card, which is missing here
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sobel.edge_map(img, "e2afs")


# -- K-means ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 127, 513])
@pytest.mark.parametrize("k", [8, 20])
def test_ref_kmeans_assign_matches(n, k):
    rng = np.random.default_rng(n * 100 + k)
    px = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    cent = rng.uniform(0, 255, (k, 3)).astype(np.float32)
    a, s, c = ref_kmeans_assign(torch.from_numpy(px), torch.from_numpy(cent))
    ra, rs, rc = (np.asarray(v) for v in jax_ref_kmeans_assign(jnp.asarray(px), jnp.asarray(cent)))
    assert a.dtype == torch.int32 and s.shape == (k, 3) and c.shape == (k,)
    np.testing.assert_array_equal(a.numpy(), ra)
    np.testing.assert_array_equal(c.numpy(), rc)
    np.testing.assert_allclose(s.numpy(), rs, rtol=1e-6, atol=0)
    # the wrapper's CPU route is the plain version, also over a batch
    a2, s2, c2 = kmeans_ops.kmeans_assign(torch.from_numpy(px)[None].expand(2, n, 3),
                                          torch.from_numpy(cent)[None].expand(2, k, 3))
    assert a2.shape == (2, n) and torch.equal(a2[1], a) and torch.equal(c2[0], c)
    torch.testing.assert_close(s2[1], s, rtol=1e-6, atol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_lloyd_matches_from_the_same_start(fused):
    rgb = images.rgb_test_image("peppers", 48)
    pix = jnp.asarray(rgb.reshape(-1, 3), jnp.float32)
    cent0 = jax_kmeans._init_centroids(pix, jax.random.key(0), 8)
    ref_cent, ref_assign = jax_kmeans._lloyd(pix, cent0, iters=12, sqrt_unit="e2afs", fused=False)
    cent, assign = kmeans.lloyd(torch.from_numpy(np.array(pix)), torch.from_numpy(np.array(cent0)),
                                iters=12, sqrt_unit="e2afs", fused=fused)
    np.testing.assert_allclose(cent.numpy(), np.asarray(ref_cent), rtol=0, atol=1e-3)
    assert float((assign.numpy() == np.asarray(ref_assign)).mean()) >= 0.999
    with pytest.raises(ValueError, match="requires sqrt_unit='e2afs'"):
        kmeans.lloyd(torch.from_numpy(np.array(pix)), torch.from_numpy(np.array(cent0)),
                     iters=1, sqrt_unit="esas", fused=True)


def test_update_centroids_matches():
    rng = np.random.default_rng(3)
    cent, sums = rng.uniform(0, 255, (6, 3)).astype(np.float32), rng.uniform(0, 1e4, (6, 3))
    sums = sums.astype(np.float32)
    counts = np.array([0, 1, 7, 0, 300, 2], np.float32)
    ours = kmeans.update_centroids(*(torch.from_numpy(v) for v in (cent, sums, counts)))
    ref = jax_kmeans.update_centroids(jnp.asarray(cent), jnp.asarray(sums), jnp.asarray(counts))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_kmeans_quantize_batch_equals_per_image():
    rgbs = np.stack([images.rgb_test_image(name, 24) for name in images.IMAGE_NAMES[:3]])
    quant, cent = kmeans.kmeans_quantize_batch(rgbs, k=6, iters=5, seed=4, device="cpu")
    assert quant.shape == rgbs.shape and cent.shape == (3, 6, 3) and quant.dtype == np.float64
    for i in range(3):
        q, c = kmeans.kmeans_quantize(rgbs[i], k=6, iters=5, seed=4 + i, fused=True, device="cpu")
        np.testing.assert_array_equal(quant[i], q)
        np.testing.assert_array_equal(cent[i], c)


def test_kmeans_quantize_fused_equals_broadcast_on_cpu():
    rgb = images.rgb_test_image("house", 32)
    q1, c1 = kmeans.kmeans_quantize(rgb, k=8, iters=6, fused=False, device="cpu")
    q2, c2 = kmeans.kmeans_quantize(rgb, k=8, iters=6, fused=True, device="cpu")
    np.testing.assert_array_equal(q1, q2)
    assert len(np.unique(q1.reshape(-1, 3), axis=0)) <= 8 and c1.shape == (8, 3)
    # distinct starting pixels, from a CPU generator seeded from the seed
    pix = torch.from_numpy(rgb.reshape(-1, 3).astype(np.float32))
    start = kmeans.init_centroids(pix, 0, 8)
    assert torch.equal(start, kmeans.init_centroids(pix, 0, 8))
    assert not torch.equal(start, kmeans.init_centroids(pix, 1, 8))


def test_kmeans_evaluate_units_orders():
    rgb = images.rgb_test_image("peppers", 32)
    res = kmeans.evaluate_units(rgb, k=8, device="cpu")
    assert set(res) == {"esas", "cwaha4", "cwaha8", "e2afs", "exact"}
    assert all(np.isfinite(r["psnr"]) and 0 < r["ssim"] <= 1 for r in res.values())


# -- the paper entry point ------------------------------------------------------

def test_paper_entry_point_on_cpu(capsys):
    t3 = paper.table3(device="cpu")
    assert t3["e2afs"].med == pytest.approx(0.4024, abs=5e-5)  # the paper's MED
    t4 = paper.table4(device="cpu", n=128)
    avg = {u: np.mean([t4[name][u]["psnr"] for name in images.IMAGE_NAMES]) for u in paper.UNITS}
    assert avg["cwaha8"] > avg["e2afs"] > avg["esas"]  # the paper's Table 4 ordering
    f5 = paper.fig5(device="cpu", n=32, k=8, iters=4)
    assert set(f5) == set(paper.UNITS) | {"exact"}
    out = capsys.readouterr().out
    assert "Table 3" in out and "Table 4" in out and "Fig. 5" in out
