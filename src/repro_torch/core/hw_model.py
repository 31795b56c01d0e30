"""Analytical unit-gate hardware cost model for the left half of the
paper's Table 3 (the port's own copy of the unit-gate part of
``repro.core.hw_model``, with the same netlists and constants).

Each design is a netlist of adders, muxes and ROM bits, costed by a
unit-gate model and calibrated to the paper's Artix-7 scale with one global
factor per metric, fit on the E2AFS row: the one datapath reproduced bit
for bit from the paper, so its netlist is known, not reconstructed.  The
baseline netlists are reconstructions (the ESAS one is level-1 only, so
simpler than the real design).  These are proxies, never measured watts.

Unit-gate conventions (Parhami, "Computer Arithmetic"):
  * adder: area 5 gate-eq/bit; FPGA carry-chain depth 2 + width/4
  * 2:1 mux: area 3 gate-eq/bit, depth 1
  * ROM: area 0.25 gate-eq/bit, depth 1 (LUT-mapped table)
  * fixed shifts and bit concatenation: wiring, free
Switching proxy: adders 0.5/bit, muxes 0.25/bit, ROM 0.125/bit, plus a
floor of 6 for the I/O registers.

Critical paths (the exponent and mantissa paths run in parallel; the
mantissa dominates):
  E2AFS : add12(man+341) -> mux(y_hi) -> add11(x1.5 via t+t>>1) -> mux(parity)
  ESAS  : add11(x1.5) -> mux(parity)
  CWAHA : ROM lookup -> mux(parity)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["Netlist", "NETLISTS", "cost", "calibrated_table", "PAPER_TABLE3", "ChipModel",
           "H100_SXM", "chip_for_device"]


@dataclasses.dataclass(frozen=True)
class Netlist:
    """(width, count) component inventories and an explicit critical path."""

    adders: Tuple[Tuple[int, int], ...] = ()
    muxes: Tuple[Tuple[int, int], ...] = ()
    rom_bits: int = 0
    critical_path: Tuple[Tuple[str, int], ...] = ()


NETLISTS: Dict[str, Netlist] = {
    # E2AFS (from the paper): exponent sub+add (5b, parallel); mantissa:
    # man+341 (12b), the even path's constant subtract (11b), the x1.5 adder
    # (11b); muxes: y_hi select (11b), parity select (11b)
    "e2afs": Netlist(
        adders=((5, 2), (12, 1), (11, 2)),
        muxes=((11, 2),),
        critical_path=(("add", 12), ("mux", 11), ("add", 11), ("mux", 11)),
    ),
    # ESAS reconstruction (level 1 only): exponent pair, x1.5 adder, parity mux
    "esas": Netlist(
        adders=((5, 2), (11, 2)),
        muxes=((11, 1),),
        critical_path=(("add", 11), ("add", 11), ("mux", 11)),
    ),
    # CWAHA-k reconstruction: exponent pair, two ROM tables, parity mux
    "cwaha4": Netlist(
        adders=((5, 2),),
        muxes=((10, 1),),
        rom_bits=2 * 4 * 10,
        critical_path=(("rom", 10), ("mux", 10)),
    ),
    "cwaha8": Netlist(
        adders=((5, 2),),
        muxes=((10, 1),),
        rom_bits=2 * 8 * 10,
        critical_path=(("rom", 10), ("mux", 10)),
    ),
}

_AREA = {"add": 5.0, "mux": 3.0, "rom": 0.25}
_TOGGLE = {"add": 0.5, "mux": 0.25, "rom": 0.125}

# The paper's Table 3 (left half), for calibration and printing side by side
PAPER_TABLE3 = {
    "esas": {"luts": 54, "dp_mw": 7.98, "cpd_ns": 5.242, "pdp_pj": 41.8312},
    "cwaha4": {"luts": 25, "dp_mw": 8.88, "cpd_ns": 5.027, "pdp_pj": 44.6398},
    "cwaha8": {"luts": 45, "dp_mw": 9.99, "cpd_ns": 5.732, "pdp_pj": 57.2627},
    "e2afs": {"luts": 37, "dp_mw": 7.63, "cpd_ns": 4.639, "pdp_pj": 35.3955},
}


def cost(name: str) -> Dict[str, float]:
    """Raw unit-gate metrics: area (gate-eq), depth (gate delays), switching."""
    n = NETLISTS[name]
    area = sum(w * c * _AREA["add"] for w, c in n.adders)
    area += sum(w * c * _AREA["mux"] for w, c in n.muxes)
    area += n.rom_bits * _AREA["rom"]
    depth = 0.0
    for kind, width in n.critical_path:
        depth += (2.0 + width / 4.0) if kind == "add" else 1.0
    switching = sum(w * c * _TOGGLE["add"] for w, c in n.adders)
    switching += sum(w * c * _TOGGLE["mux"] for w, c in n.muxes)
    switching += n.rom_bits * _TOGGLE["rom"]
    switching += 6.0  # I/O register floor
    return {"area": area, "depth": depth, "switching": switching}


# ---------------------------------------------------------------------------
# Chip-level roofline constants
# ---------------------------------------------------------------------------
#
# The unit-gate model above prices one datapath; kernel tiling needs what one
# chip sustains a second and what one block of a launch costs.  The
# roofline that narrows a tile sweep (kernels/tuning.py) and the dry run's
# roofline (launch/dryrun.py) read them from here.


@dataclasses.dataclass(frozen=True)
class ChipModel:
    """Per-chip roofline terms for the tile-time prior (the reference's
    dataclass, field for field).

    ``peak_flops`` is the op rate the tile's work is priced at, ``hbm_bw``
    the device memory rate, ``vmem_bytes`` the fast memory a tile must fit
    in (a block's shared memory on the card), ``step_overhead_s`` the fixed
    cost of one grid step (one block of a launch on the card)."""

    name: str
    peak_flops: float  # op/s the tile pipeline retires
    hbm_bw: float  # bytes/s
    vmem_bytes: int  # per-block fast-memory budget a tile must fit in
    step_overhead_s: float  # fixed cost per grid step


H100_SXM = ChipModel(
    name="nvidia-h100-sxm",
    # dense bf16 tensor-core peak, NVIDIA H100 SXM data sheet (989.4 TFLOP/s
    # at the 700 W limit)
    peak_flops=989.4e12,
    # HBM3 rate, the same data sheet; the rate every bound in PERF.md uses
    hbm_bw=3.35e12,
    # shared memory one block can use (232,448 bytes of the SM's 256 KB),
    # the CUDA C++ programming guide's table for compute capability 9.0
    vmem_bytes=232_448,
    # fitted: RMSNorm's (8, 2560) bfloat16 decode launch, which moves 82 KB
    # (0.000026 ms at the HBM rate) in 8 blocks, took 0.00214 ms of device
    # time on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 5, the
    # kernel table of PERF.md): (0.00214 - 0.000026) ms / 8 blocks.  Phase 20
    # prints the same fit from its own run.
    step_overhead_s=(0.00214e-3 - 0.000026e-3) / 8,
)

# the name torch.cuda.get_device_name gives the card H100_SXM models (the
# PCIe and NVL parts have other rates and names)
_H100_NAME = "NVIDIA H100 80GB HBM3"


def chip_for_device(device) -> ChipModel:
    """The chip model of ``device``'s card: :data:`H100_SXM` for an H100.
    Raises for the CPU and for any other card, naming it, rather than
    guessing its constants."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no chip model for device {device}: the tile prior models the card")
    name = torch.cuda.get_device_name(device)
    if name != _H100_NAME:
        raise ValueError(f"no chip model for {name!r}: only the H100 ({H100_SXM.name}) is "
                         f"modelled")
    return H100_SXM


def calibrated_table() -> Dict[str, Dict[str, float]]:
    """The raw metrics scaled to the paper's units by the E2AFS row alone."""
    ref_raw = cost("e2afs")
    ref_paper = PAPER_TABLE3["e2afs"]
    k_lut = ref_paper["luts"] / ref_raw["area"]
    k_cpd = ref_paper["cpd_ns"] / ref_raw["depth"]
    k_dp = ref_paper["dp_mw"] / ref_raw["switching"]
    out = {}
    for name in NETLISTS:
        raw = cost(name)
        luts = raw["area"] * k_lut
        cpd = raw["depth"] * k_cpd
        dp = raw["switching"] * k_dp
        out[name] = {
            "luts_proxy": luts,
            "cpd_ns_proxy": cpd,
            "dp_mw_proxy": dp,
            "pdp_pj_proxy": cpd * dp,
        }
    return out
