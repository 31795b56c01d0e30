"""The torch port's core datapaths held bit-for-bit against the JAX package.

Inputs are every fp16 and bf16 bit pattern and the fp32 grid of
``sampled_normal_values``; they go through ``repro.core`` and
``repro_torch.core`` as numpy arrays.  Also: the paper's Table 2 example,
the rsqrt specials, the unit registry, and a scan showing that the port and
``chip_smoke.py`` import neither ``jax`` nor ``repro``.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import e2afs as jax_e2afs
from repro.core import get_unit as jax_get_unit
from repro.core import metrics as jax_metrics
from repro.core import numerics as jax_numerics
from repro_torch.core import e2afs, metrics, numerics
from repro_torch.core import get_unit

REPO = Path(__file__).resolve().parents[1]

# The suite runs in parallel worker processes beside one another's XLA
# thread pools, where torch's CPU threads spin on a shared machine and slow
# every small op many-fold (the port's trainer tests read about 30 times
# their time alone).  pytest imports every test module at collection, so this
# puts torch on one thread for the whole test run in every worker.
torch.set_num_threads(1)

_NP_DTYPE = {"fp16": np.float16, "bf16": ml_dtypes.bfloat16, "fp32": np.float32}
_TORCH_INT = {"fp16": torch.int16, "bf16": torch.int16, "fp32": torch.int32}
_NP_INT = {"fp16": np.int16, "bf16": np.int16, "fp32": np.int32}


def _domain(name):
    """(numpy array for JAX, torch tensor) over the format's test domain."""
    if name == "fp32":
        a = np.asarray(jax_metrics.sampled_normal_values(jax_numerics.FP32))
        specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, 1e-40, -1e-40,
                             np.finfo(np.float32).max, np.finfo(np.float32).tiny], np.float32)
        a = np.concatenate([a, specials])
    else:
        a = np.arange(1 << 16, dtype=np.uint16).view(_NP_DTYPE[name])
    t = torch.from_numpy(a.view(_NP_INT[name]).copy()).view(getattr(numerics, name.upper()).dtype)
    return a, t


def _bits_equal(jax_out, torch_out, name):
    """Bit-identical, with any NaN equal to any NaN."""
    a = np.asarray(jax_out).view(_NP_INT[name])
    b = torch_out.view(_TORCH_INT[name]).numpy()
    a_nan = np.isnan(np.asarray(jax_out).astype(np.float32))
    b_nan = torch.isnan(torch_out.float()).numpy()
    same = (a == b) | (a_nan & b_nan)
    return same


@pytest.mark.parametrize("name", ["fp16", "bf16", "fp32"])
def test_format_descriptor_matches(name):
    j = getattr(jax_numerics, name.upper())
    t = getattr(numerics, name.upper())
    for attr in ("bias", "exp_mask", "man_mask", "one", "total_bits"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for value in (0.045, 0.3333, 0.5, 1 / 3):
        assert t.q(value) == j.q(value)


@pytest.mark.parametrize("name", ["fp16", "bf16", "fp32"])
def test_decompose_compose_match(name):
    a, t = _domain(name)
    jf = getattr(jax_numerics, name.upper())
    tf = getattr(numerics, name.upper())
    j_fields = jax_numerics.decompose(jnp.asarray(a), jf)
    t_fields = numerics.decompose(t, tf)
    for jx, tx in zip(j_fields, t_fields):
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    back = numerics.compose(*t_fields, tf)
    assert _bits_equal(a, back, name).all()
    # out-of-range exponents wrap to the format's width, as the reference
    sign, exp, man = (torch.zeros(4, dtype=torch.int32),
                      torch.tensor([-3, tf.exp_mask + 2, 1 << tf.exp_bits, 7], dtype=torch.int32),
                      torch.tensor([1, 2, 3, tf.man_mask], dtype=torch.int32))
    j = jax_numerics.compose(jnp.asarray(sign.numpy()), jnp.asarray(exp.numpy()),
                             jnp.asarray(man.numpy()), jf)
    assert _bits_equal(np.asarray(j), numerics.compose(sign, exp, man, tf), name).all()


@pytest.mark.parametrize("name", ["fp16", "bf16", "fp32"])
def test_apply_specials_matches(name):
    a, t = _domain(name)
    jf, tf = getattr(jax_numerics, name.upper()), getattr(numerics, name.upper())
    result = torch.ones_like(t)
    fields = numerics.decompose(t, tf)
    for ftz in (True, False):
        out = numerics.apply_specials(result, t, *fields, tf, ftz=ftz)
        jfields = jax_numerics.decompose(jnp.asarray(a), jf)
        jout = jax_numerics.apply_specials(jnp.ones_like(jnp.asarray(a)), jnp.asarray(a),
                                           *jfields, jf, ftz=ftz)
        assert _bits_equal(jout, out, name).all()


@pytest.mark.parametrize("fn", ["e2afs_sqrt", "e2afs_rsqrt", "e2afs_sqrt_positive"])
@pytest.mark.parametrize("name", ["fp16", "bf16", "fp32"])
def test_e2afs_bit_identical(fn, name):
    a, t = _domain(name)
    same = _bits_equal(getattr(jax_e2afs, fn)(jnp.asarray(a)), getattr(e2afs, fn)(t), name)
    assert same.all(), f"{int((~same).sum())} of {same.size} patterns differ"


@pytest.mark.parametrize("name", ["fp16", "bf16", "fp32"])
def test_format_constants(name):
    """The intercepts round half-to-even, as Python's round (bf16's 178.5 ->
    178; C's roundf would give 179)."""
    want = {
        "fp16": (46, 341, (2030, 1835, 1428, 1336)),
        "bf16": (6, 43, (254, 229, 178, 167)),
        "fp32": (377487, 2795923, (16629760, 15032320, 11698176, 10944512)),
    }[name]
    c = e2afs.format_constants(getattr(numerics, name.upper()))
    got = (c["c_even"], c["c_odd"],
           tuple(c["rsqrt_intercepts"][k] for k in ((0, 0), (0, 1), (1, 0), (1, 1))))
    assert got == want


def test_e2afs_constants_match_the_reference():
    """The public ``E2AFS_CONSTANTS`` (the paper's Q-grid region constants)
    equal the reference's."""
    assert e2afs.E2AFS_CONSTANTS == jax_e2afs.E2AFS_CONSTANTS


def test_unit_is_exact_matches_the_reference():
    """``SqrtUnit.is_exact`` for every unit, as the reference's."""
    from repro.core import available_units as jax_available_units
    from repro_torch.core import available_units

    assert available_units() == jax_available_units()
    assert [get_unit(n).is_exact for n in available_units()] == [
        jax_get_unit(n).is_exact for n in jax_available_units()]
    assert get_unit("exact").is_exact and not get_unit("e2afs").is_exact


def test_e2afs_fp16_config_mirrors_the_reference():
    """The registry's ``e2afs-fp16`` id: the paper's unit evaluation
    (``E2AFSConfig``, not an LM), field for field the reference's, full and
    smoke; an override replaces a field as for the models."""
    import dataclasses

    from repro.configs import get_config as jax_get_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.configs.e2afs_fp16 import E2AFSConfig

    assert "e2afs-fp16" in ARCH_IDS
    for ours, theirs in ((get_config("e2afs-fp16"), jax_get_config("e2afs-fp16")),
                         (get_smoke_config("e2afs-fp16"), jax_smoke_config("e2afs-fp16"))):
        assert isinstance(ours, E2AFSConfig)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert get_config("e2afs-fp16", fmt="bf16").fmt == "bf16"


def test_table2_worked_example():
    """0x785A -> 0 10110 1000100001 (196.125), as the paper's Table 2."""
    x = torch.tensor([0x785A], dtype=torch.int16).view(torch.float16)
    bits = int(e2afs.e2afs_sqrt(x).view(torch.int16).item()) & 0xFFFF
    assert bits == 0b0_10110_1000100001
    assert float(e2afs.e2afs_sqrt(x)) == 196.125


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_rsqrt_subnormal_policy(dtype):
    """Under ftz a positive subnormal is zero to the datapath: +inf (the
    oracle's contract); a negative subnormal is NaN; rsqrt(+inf) = 0."""
    tiny = torch.finfo(dtype).tiny
    x = torch.tensor([tiny / 4, -tiny / 4, 0.0, -0.0, float("inf")], dtype=dtype)
    assert x[0] > 0 and x[0] < tiny  # really subnormal
    out = e2afs.e2afs_rsqrt(x)
    assert torch.isposinf(out[0]) and torch.isnan(out[1])
    assert torch.isposinf(out[2]) and torch.isposinf(out[3]) and out[4] == 0


def test_sampled_grid_matches():
    np.testing.assert_array_equal(
        metrics.sampled_normal_values().numpy(),
        np.asarray(jax_metrics.sampled_normal_values(jax_numerics.FP32)),
    )


@pytest.mark.parametrize("unit", ["exact", "e2afs"])
@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
def test_get_unit_matches(unit, op):
    x = np.random.default_rng(0).uniform(1e-3, 1e3, 4096).astype(np.float32)
    ours = getattr(get_unit(unit), op)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jax_get_unit(unit), op)(jnp.asarray(x)))
    if unit == "e2afs":
        np.testing.assert_array_equal(ours, ref)
    else:  # IEEE sqrt is correctly rounded; rsqrt within two float32 ulps
        np.testing.assert_allclose(ours, ref, rtol=2.4e-7, atol=0)


def test_get_unit_kernel_route_on_cpu_is_the_datapath():
    x = torch.from_numpy(np.random.default_rng(1).uniform(0.1, 10, 999).astype(np.float32))
    unit = get_unit("e2afs", kernel=True)
    assert unit.kernel_default
    assert torch.equal(unit.sqrt(x), e2afs.e2afs_sqrt(x))
    assert torch.equal(unit.rsqrt(x), e2afs.e2afs_rsqrt(x))
    with pytest.raises(ValueError, match="no kernel route"):
        get_unit("exact", kernel=True)
    with pytest.raises(ValueError, match="unknown sqrt unit"):
        get_unit("esas-typo")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {str(p.relative_to(REPO / "src" / "repro_torch")) for p in files[:-1]}
    assert {"core/esas.py", "core/cwaha.py", "core/metrics.py", "kernels/sobel/ops.py",
            "kernels/sobel/ref.py", "kernels/kmeans/ops.py", "kernels/kmeans/ref.py",
            "apps/images.py", "apps/metrics_img.py", "apps/sobel.py", "apps/kmeans.py",
            "launch/paper.py", "kernels/adam/ops.py", "kernels/adam/ref.py", "optim/adamw.py",
            "optim/compression.py", "data/pipeline.py", "checkpoint/checkpoint.py",
            "launch/steps.py", "launch/train.py"} <= scanned
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad
