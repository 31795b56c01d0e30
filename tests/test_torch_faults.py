"""The torch port's fault model, sqrt-unit ladders, select norms and the
unit-gate hardware model held against the JAX package on the CPU.

Inputs are numpy arrays from fixed seeds (or every fp16/bf16 bit pattern),
fed to ``repro`` and ``repro_torch`` alike.  Strengths:

* bit-identical: the fault hash (``_mix32``, ``fault_mask``,
  ``_bit_choice``), the e2afs datapath under faults on every fp16 and bf16
  pattern (both sites, a pinned and a hashed bit), the esas and cwaha units
  under faults, the kernel route under faults (the reference's Pallas
  kernel interpreted) but for ROADMAP C.2's positive subnormal rsqrt,
  ``corrupt_logits``, the dispatch injector's draws and
  ``calibrated_table``;
* the exact unit under faults: identical wherever the clean sqrt is (the
  flip hashes the output's bits, so an output whose bits differ may strike
  differently: NaN payloads, and bf16 subnormals that XLA flushes); the
  composed rsqrt of every baseline leaves out the elements that XLA's bf16
  arithmetic flushes (ROADMAP C.8), see the test;
* the select norms, on rows whose sums are exact in float32: rows at the
  e2afs (faulted) and esas rungs bit-identical, rows at the exact rung
  within ROADMAP C.13's tolerance (float32 rtol 1e-6, one bf16 ulp).

NaN compares equal to NaN throughout: XLA's bf16 arithmetic gives NaNs its
canonical payload.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jax_faults
from repro.core import hw_model as jax_hw
from repro.core.units import get_unit as jax_get_unit
from repro.layers import norms as jax_norms
from repro_torch.core import faults, hw_model
from repro_torch.core.units import get_unit, resolve_ladder
from repro_torch.launch import paper
from repro_torch.layers import norms

_JDT = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
_INT = {torch.float16: np.uint16, torch.bfloat16: np.uint16, torch.float32: np.uint32}
SEEDS = [0, 7, 123456789, 2**32 + 5, 2**40 + 3, -1, -(2**33) - 17]


def _patterns(dtype):
    """Every bit pattern of a 16-bit float, as a torch tensor and a jax array."""
    u = np.arange(1 << 16, dtype=np.uint16)
    return (torch.from_numpy(u.view(np.int16)).view(dtype),
            jax.lax.bitcast_convert_type(jnp.asarray(u), _JDT[dtype]))


def _bits(x):
    if isinstance(x, torch.Tensor):
        width = {2: torch.int16, 4: torch.int32}[x.element_size()]
        return x.view(width).numpy().view(_INT[x.dtype])
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16 if x.dtype.itemsize == 2
                                                    else jnp.uint32))


def _nan(x):
    return (torch.isnan(x).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.isnan(x)))


def _same(ours, ref):
    """Elementwise: the same bits, or NaN in both (XLA's bf16 arithmetic
    gives NaNs its canonical payload)."""
    return (_bits(ours) == _bits(ref)) | (_nan(ours) & _nan(ref))


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def test_mix32_matches_reference():
    w = np.concatenate([_words(4096, 0), np.array([0, 1, 2**31, 2**32 - 1], np.uint32)])
    ours = faults._mix32(torch.from_numpy(w.astype(np.int64))).numpy()
    ref = np.asarray(jax_faults._mix32(jnp.asarray(w)))
    np.testing.assert_array_equal(ours, ref.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_mask_and_bit_choice_match_reference(seed):
    w = _words(8192, 1).reshape(64, 128)
    as_int32 = torch.from_numpy(w.view(np.int32))  # negative words included
    for rate in (1e-2, 0.5, 1.0):
        np.testing.assert_array_equal(faults.fault_mask(as_int32, rate, seed).numpy(),
                                      np.asarray(jax_faults.fault_mask(jnp.asarray(w), rate,
                                                                       seed)))
    for width, pinned in ((10, None), (7, None), (23, None), (8, 3), (5, 12)):
        np.testing.assert_array_equal(
            faults._bit_choice(as_int32, seed, width, pinned).numpy(),
            np.asarray(jax_faults._bit_choice(jnp.asarray(w), seed, width, pinned)))
    assert not faults.fault_mask(as_int32, 0.0, seed).any()


_FAULTS = [("sqrt_man", 1e-2, None), ("sqrt_man", 1.0, None), ("sqrt_man", 0.3, 2),
           ("sqrt_exp", 1e-2, None), ("sqrt_exp", 1.0, 3)]


@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("site,rate,bit", _FAULTS)
def test_e2afs_faulted_datapath_bit_identical(site, rate, bit, dtype, op):
    from repro.core import e2afs as jax_e2afs
    from repro_torch.core import e2afs

    cfg = faults.FaultConfig(site, rate, seed=11, bit=bit)
    jcfg = jax_faults.FaultConfig(site, rate, seed=11, bit=bit)
    x, jx = _patterns(dtype)
    ours = getattr(e2afs, f"e2afs_{op}")(x, faults=cfg)
    ref = getattr(jax_e2afs, f"e2afs_{op}")(jx, faults=jcfg)
    assert _same(ours, ref).all()
    clean = getattr(e2afs, f"e2afs_{op}")(x)
    assert not _same(clean, ours).all()  # the faults struck


def _flushed(x, dtype):
    """Zero or subnormal in its 16-bit format."""
    exp_bits = 5 if dtype == torch.float16 else 8
    return ((_bits(x) >> (15 - exp_bits)) & ((1 << exp_bits) - 1)) == 0


@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
@pytest.mark.parametrize("name", ["esas", "cwaha4", "cwaha8", "exact"])
def test_units_under_faults_match_reference(name, op):
    """Without an in-datapath hook, both packages flip the sqrt's output
    register, and a rsqrt under faults is ``1 / sqrt`` of the faulted sqrt.
    Held where the clean sqrt is bit-identical: everywhere for esas and
    cwaha; for exact all but NaN outputs (torch keeps an input's payload
    and a negative input's sign) and bf16 subnormals (XLA flushes them,
    ROADMAP C.8).  The rsqrt leaves out
    the elements whose faulted sqrt or result is zero or subnormal: XLA
    flushes bf16 subnormal operands and results of ``1 / y`` (C.8)."""
    for dtype in (torch.float16, torch.bfloat16):
        x, jx = _patterns(dtype)
        clean, jclean = get_unit(name).sqrt(x), jax_get_unit(name).sqrt(jx)
        clean_same = _bits(clean) == _bits(jclean)
        if name == "exact":
            assert (clean_same | (_nan(clean) & _nan(jclean))
                    | (_flushed(x, dtype) & (dtype == torch.bfloat16))).all()
        else:
            assert clean_same.all()
        for site, rate, bit in (("sqrt_man", 0.05, None), ("sqrt_exp", 1.0, 1)):
            unit = get_unit(name, faults=faults.FaultConfig(site, rate, seed=5, bit=bit))
            junit = jax_get_unit(name, faults=jax_faults.FaultConfig(site, rate, seed=5, bit=bit))
            ours = getattr(unit, op)(x)
            keep = clean_same
            if op == "rsqrt":
                keep = keep & ~(_flushed(unit.sqrt(x), dtype) | _flushed(ours, dtype))
            assert keep.mean() > 0.45, (dtype, site, keep.mean())
            same = _same(ours, getattr(junit, op)(jx))
            assert same[keep].all(), (dtype, site, int((~same[keep]).sum()))


@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_kernel_route_with_faults_matches_reference(dtype, op):
    """The kernel route flips the kernel's output register, in both
    packages; the reference's Pallas kernel runs interpreted.  The only
    difference is ROADMAP C.2: the Pallas rsqrt gives 0 for a positive
    subnormal where the datapath (and the port's kernel) gives +inf."""
    cfg = faults.FaultConfig("sqrt_man", 0.05, seed=9)
    x, jx = _patterns(dtype)
    ours = getattr(get_unit("e2afs", kernel=True, faults=cfg), op)(x)
    ref = getattr(jax_get_unit("e2afs", kernel=True,
                               faults=jax_faults.FaultConfig("sqrt_man", 0.05, seed=9)), op)(jx)
    differ = ~_same(ours, ref)
    xb = _bits(x)
    exp_bits = 5 if dtype == torch.float16 else 8
    man_mask = (1 << (15 - exp_bits)) - 1
    pos_sub = ((xb >> 15) == 0) & ((xb >> (15 - exp_bits)) == 0) & ((xb & man_mask) != 0)
    if op == "sqrt":
        assert not differ.any()
    else:
        assert not (differ & ~pos_sub).any()
    # the kernel route is the output-register flip of the clean kernel output
    clean = getattr(get_unit("e2afs", kernel=True), op)(x)
    assert _same(ours, faults.flip_float_bits(clean, cfg)).all()


@pytest.mark.parametrize("site", ["logit_nan", "logit_inf"])
@pytest.mark.parametrize("seed", [3, 2**35 + 1])
def test_corrupt_logits_and_hook_match_reference(site, seed):
    lg = np.random.default_rng(2).standard_normal((8, 1000)).astype(np.float32) * 5
    cfg = faults.FaultConfig(site, 1e-2, seed=seed)
    ours = faults.logits_hook(cfg)(torch.from_numpy(lg)).numpy()
    ref = np.asarray(jax_faults.logits_hook(jax_faults.FaultConfig(site, 1e-2, seed=seed))(
        jnp.asarray(lg)))
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    assert 0 < (~np.isfinite(ours)).sum() < lg.size
    assert faults.logits_hook(faults.FaultConfig("sqrt_man", 1e-2)) is None
    assert faults.logits_hook(None) is None


def test_fault_config_validates_and_dispatch_injector_replays():
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultConfig("cosmic_ray", 0.1)
    with pytest.raises(ValueError, match="rate"):
        faults.FaultConfig("sqrt_man", 1.5)
    with pytest.raises(ValueError, match="dispatch"):
        faults.DispatchFaultInjector(faults.FaultConfig("sqrt_man", 0.1))
    for seed, rate in ((4, 0.25), (2**40, 0.5)):
        ours = faults.DispatchFaultInjector(faults.FaultConfig("dispatch", rate, seed=seed))
        ref = jax_faults.DispatchFaultInjector(jax_faults.FaultConfig("dispatch", rate, seed=seed))
        draws = [ours.should_fail() for _ in range(1000)]
        assert draws == [ref.should_fail() for _ in range(1000)]
        assert 0 < sum(draws) < 1000
        ours.reset()
        assert draws == [ours.should_fail() for _ in range(1000)]
    assert random.Random(4).random() == faults.DispatchFaultInjector(
        faults.FaultConfig("dispatch", 1.0, seed=4))._rng.random()


def test_resolve_ladder_puts_faults_on_rung_zero_only():
    cfg = faults.FaultConfig("sqrt_man", 0.1, seed=1)
    units = resolve_ladder(("e2afs", "esas", "exact"), faults=cfg)
    assert [u.name for u in units] == ["e2afs", "esas", "exact"]
    assert units[0].faults == cfg and units[1].faults is None and units[2].faults is None
    for bad, match in ((("exact",), ">= 2 rungs"), (("e2afs", "esas"), "end at 'exact'")):
        with pytest.raises(ValueError, match=match):
            resolve_ladder(bad)
    # a non-sqrt site leaves the unit clean, as in the reference
    assert get_unit("e2afs", faults=faults.FaultConfig("logit_nan", 0.5)).faults is None


_LADDER = ("e2afs", "esas", "exact")


def _select_case(dtype, kind, seed):
    """Rows of small integers times a power of two per row, width 32: every
    sum of the norm is exact in float32, so both packages see the same mean
    square and variance, and only the rsqrt rungs can part."""
    rng = np.random.default_rng(seed)
    b, d = 64, 32
    x = (rng.integers(-8, 9, (b, 3, d)) * 2.0 ** rng.integers(-6, 4, (b, 1, 1))).astype(
        np.float32)
    scale = (rng.standard_normal(d) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(d) * 0.1).astype(np.float32)
    levels = rng.integers(0, len(_LADDER), b).astype(np.int32)
    cfg = faults.FaultConfig("sqrt_man", 0.2, seed=seed)
    jcfg = jax_faults.FaultConfig("sqrt_man", 0.2, seed=seed)
    xt = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(x).astype(_JDT[dtype])
    if kind == "rmsnorm":
        ours = norms.rmsnorm_select(torch.from_numpy(scale), xt, torch.from_numpy(levels),
                                    ladder=_LADDER, faults=cfg)
        ref = jax_norms.rmsnorm_select(jnp.asarray(scale), jx, jnp.asarray(levels),
                                       ladder=_LADDER, faults=jcfg)
    else:
        ours = norms.layernorm_select(torch.from_numpy(scale), torch.from_numpy(bias), xt,
                                      torch.from_numpy(levels), ladder=_LADDER, faults=cfg)
        ref = jax_norms.layernorm_select(jnp.asarray(scale), jnp.asarray(bias), jx,
                                         jnp.asarray(levels), ladder=_LADDER, faults=jcfg)
    return ours, ref, levels


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_norms_match_reference(dtype, kind, seed):
    """Rows at the e2afs rung (faulted) and the esas rung bit-identical to
    the reference; rows at the exact rung within ROADMAP C.13's two float32
    ulps of the rsqrt (float32 rtol 1e-6), one ulp of the output in bf16."""
    ours, ref, levels = _select_case(dtype, kind, seed)
    same = _same(ours, ref)
    approx = levels < 2
    assert same[approx].all(), np.nonzero(~same[approx].all(axis=(1, 2)))
    o, r = ours.float().numpy()[~approx], np.asarray(ref.astype(jnp.float32))[~approx]
    if dtype == torch.float32:
        np.testing.assert_allclose(o, r, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_less(np.abs(o - r), np.ldexp(1.0, np.frexp(np.abs(r))[1] - 8)
                                     + 1e-30)
    assert set(levels.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_rung_rows_equal_the_single_unit_norm(dtype):
    """A row at level j is the single-unit norm through rung j (rung 0 with
    the faults), bit for bit: the ladder only selects."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 2, 32)).astype(np.float32)).to(dtype)
    scale = torch.from_numpy((rng.standard_normal(32) * 0.1).astype(np.float32))
    levels = torch.tensor([0, 1, 2, 2, 1, 0], dtype=torch.int32)
    cfg = faults.FaultConfig("sqrt_man", 0.5, seed=2)
    got = norms.rmsnorm_select(scale, x, levels, ladder=_LADDER, faults=cfg)
    for i, lv in enumerate(levels.tolist()):
        want = norms.rmsnorm(scale, x, sqrt_unit=_LADDER[lv], faults=cfg if lv == 0 else None)
        assert torch.equal(got[i], want[i]), (i, lv)
    with pytest.raises(ValueError, match="fault-injection hook"):
        norms.rmsnorm(scale, x, sqrt_unit="e2afs", fused=True, faults=cfg)


def test_calibrated_table_equals_reference(capsys):
    assert hw_model.calibrated_table() == jax_hw.calibrated_table()
    assert {n: hw_model.cost(n) for n in hw_model.NETLISTS} == {
        n: jax_hw.cost(n) for n in jax_hw.NETLISTS}
    assert hw_model.PAPER_TABLE3 == jax_hw.PAPER_TABLE3
    assert paper.table3_hw() == jax_hw.calibrated_table()
    assert "| e2afs | 37 (37) | 7.63 (7.63) | 4.64 (4.639) | 35.4 (35.3955) |" in (
        capsys.readouterr().out)
