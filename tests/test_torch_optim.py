"""The torch port's optimizer path held against the JAX package: the sqrt
units' gradients, the adam kernel's plain version, AdamW, the global-norm
clip, int8 gradient compression and the synthetic data.

Tolerances, with their reasons:

* unit gradients: bit-identical over the float32 grid of
  ``core/metrics.py::sampled_normal_values``, except where the port's
  gradient or its derivative factor is a float32 subnormal: XLA on the CPU
  flushes those to zero (ROADMAP C.8) and torch does not, so there the
  reference must read exactly 0;
* the adam plain version: bit-identical to the reference's
  ``ref_adam_update``.  Not to the Pallas kernel in interpret mode (ROADMAP
  C.9): XLA contracts that kernel's updates into FMAs,
  ``m = fma(1 - b1, g, b1 * m)`` and ``v = fma(b2, v, (1 - b2) * g * g)``,
  which the reference's eager ``ref_adam_update`` does not (a quarter of m
  and v differ, by up to 15 ulps where the two terms nearly cancel).  The test holds the kernel's m
  and v bit-identical to those FMA forms (emulated in float64) and its p
  within 2 ulps of the plain version's (measured: 2);
* the schedule over steps 0-2000: float32 ``pow`` and ``cos`` of two
  libraries within 1 ulp, and lr, b1c and b2c within one ulp of the terms
  they cancel from (see the test);
* AdamW and the clip: float32 within 1e-6 relative, or 1e-6 of the
  tensor's largest value (sums in another order; the reference's fused
  route also contracts as above);
* compression and data: equal.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_unit as jax_get_unit
from repro.core.e2afs import e2afs_sqrt_positive as jax_sqrt_positive
from repro.core.metrics import sampled_normal_values
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.kernels.adam import ops as jax_adam_ops
from repro.kernels.adam.ref import ref_adam_update as jax_ref_adam
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_compression
from repro_torch.core import e2afs, get_unit
from repro_torch.data import DataConfig, SyntheticLM, host_slice
from repro_torch.kernels import dispatch
from repro_torch.kernels.adam.ops import adam_update
from repro_torch.kernels.adam.ref import ref_adam_update
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, compress_decompress,
                               compress_init, cosine_lr, global_norm_clip)
from repro_torch.optim.adamw import bias_corrections

TINY = np.finfo(np.float32).tiny
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _ulps(a, b):
    """Largest distance in float32 ulps (same-sign finite values)."""
    return int(np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64)).max())


# ---------------------------------------------------------------------------
# unit gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
@pytest.mark.parametrize("unit", ["e2afs", "esas", "cwaha4", "cwaha8", "e2afs-kernel"])
def test_unit_gradient_bit_identical(unit, op):
    """Each unit's gradient against the reference's.  "e2afs-kernel" is the
    kernel route, ``get_unit("e2afs", kernel=True)``: the JAX side runs its
    Pallas kernel interpreted, as the JAX package's tests run it on the CPU,
    and the port's route takes its plain version on a CPU tensor."""
    name, _, route = unit.partition("-")
    kernel = route == "kernel"
    x = np.asarray(sampled_normal_values())
    ct = np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
    y_j, vjp = jax.vjp(getattr(jax_get_unit(name, kernel=kernel), op), jnp.asarray(x))
    g_j = np.asarray(vjp(jnp.asarray(ct))[0])

    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y_t = getattr(get_unit(name, kernel=kernel), op)(xt)
    y_t.backward(torch.from_numpy(ct))
    g_t = xt.grad.numpy()

    assert np.array_equal(_bits(y_j), _bits(y_t.detach().numpy()))
    differ = _bits(g_j) != _bits(g_t)
    # every difference is a subnormal the reference flushed: its value is 0
    # and the port's is below |ct| times the smallest normal
    flushed = (g_j == 0) & (np.abs(g_t) < np.abs(ct).max() * TINY)
    assert not (differ & ~flushed).any(), np.flatnonzero(differ & ~flushed)[:10]
    if op == "sqrt":  # 0.5 / y never comes near the subnormal range here
        assert not differ.any()


@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
def test_kernel_route_has_the_plain_routes_gradient_and_exact_uses_autograd(op):
    """The kernel route differentiates as the plain route does (the
    reference's kernel route is a ``custom_jvp`` with the plain route's
    rules), and an input that needs no gradient goes through with no
    autograd state."""
    x = np.asarray([0.25, 4.0, 0.7, 1e-6, 3e6], np.float32)
    ct = np.asarray([1.0, -2.0, 0.5, 3.0, 0.25], np.float32)
    grads = []
    for unit in (get_unit("e2afs"), get_unit("e2afs", kernel=True)):
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        y = getattr(unit, op)(xt)
        assert y.grad_fn is not None
        y.backward(torch.from_numpy(ct))
        grads.append(xt.grad.numpy())
        assert getattr(unit, op)(torch.from_numpy(x)).grad_fn is None
        with torch.no_grad():
            assert getattr(unit, op)(xt).grad_fn is None
    assert np.array_equal(_bits(grads[0]), _bits(grads[1]))
    assert np.all(np.isfinite(grads[1]) & (grads[1] != 0))

    xt = torch.tensor([0.25, 4.0], requires_grad=True)
    getattr(get_unit("exact"), op)(xt).sum().backward()
    want = [1.0, 0.25] if op == "sqrt" else [-4.0, -1.0 / 16]
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-7)


# ---------------------------------------------------------------------------
# the adam kernel's plain version
# ---------------------------------------------------------------------------


def _adam_inputs(n, seed, *, zero_state=False):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 0.01).astype(np.float32)
    g[::7] = 0.0  # zero gradients: padded-vocab rows of embed get them
    if zero_state:
        m = np.zeros(n, np.float32)
        v = np.zeros(n, np.float32)
    else:
        m = (rng.standard_normal(n) * 1e-3).astype(np.float32)
        v = (np.abs(rng.standard_normal(n)) * 1e-5).astype(np.float32)
        m[::11] = v[::11] = 0.0  # rows that never had a gradient
    return p, g, m, v


def _fma(a, b, c):
    """float32 a * b + c rounded once (the float64 product is exact)."""
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(np.float32)


def _sched(step, lr=3e-4):
    s = np.float32(step)
    one = np.float32(1)
    return np.array([lr, one - np.float32(0.9) ** s, one - np.float32(0.95) ** s], np.float32)


@pytest.mark.parametrize("step", [1, 2, 1000])
@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("n", [1, 127, 4097])
def test_adam_plain_version_matches_the_reference(n, zero_state, step):
    p, g, m, v = _adam_inputs(n, n + step, zero_state=zero_state)
    sched = _sched(step)
    jkw = dict(lr=jnp.float32(sched[0]), b1c=jnp.float32(sched[1]), b2c=jnp.float32(sched[2]),
               **HYPER)
    args = [jnp.asarray(a) for a in (p, g, m, v)]
    ref = jax_ref_adam(*args, **jkw)
    kernel = jax_adam_ops.adam_update(*args, **jkw)  # Pallas, interpret mode on the CPU
    ours = ref_adam_update(*(torch.from_numpy(a) for a in (p, g, m, v)), torch.from_numpy(sched),
                           **HYPER)
    for name, r, o in zip("pmv", ref, ours):
        assert np.array_equal(_bits(r), _bits(o.numpy())), name  # bit-identical
    f32 = np.float32
    fma_m = _fma(f32(1 - 0.9), g, f32(0.9) * m)
    fma_v = _fma(f32(0.95), v, f32(1 - 0.95) * g * g)
    assert np.array_equal(_bits(kernel[1]), _bits(fma_m))
    assert np.array_equal(_bits(kernel[2]), _bits(fma_v))
    assert _ulps(kernel[0], ours[0].numpy()) <= 2  # m and v's difference, carried on


@pytest.mark.parametrize("p_dtype,g_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.bfloat16)])
def test_adam_plain_version_bf16_operands(p_dtype, g_dtype):
    p, g, m, v = _adam_inputs(1000, 3)
    pt, gt = torch.from_numpy(p).to(p_dtype), torch.from_numpy(g).to(g_dtype)
    jp, jg = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                     else jnp.float32) for t in (pt, gt))
    sched = _sched(5)
    ref = jax_ref_adam(jp, jg, jnp.asarray(m), jnp.asarray(v), lr=jnp.float32(sched[0]),
                       b1c=jnp.float32(sched[1]), b2c=jnp.float32(sched[2]), **HYPER)
    ours = ref_adam_update(pt, gt, torch.from_numpy(m), torch.from_numpy(v),
                           torch.from_numpy(sched), **HYPER)
    assert ours[0].dtype == p_dtype
    np.testing.assert_array_equal(np.asarray(ref[0], np.float32), ours[0].float().numpy())
    for r, o in zip(ref[1:], ours[1:]):
        assert np.array_equal(_bits(r), _bits(o.numpy()))


def test_sqrt_positive_equals_the_unit_on_nonnegative_values():
    """The kernel's sqrt (e2afs_sqrt_positive) and the plain version's
    (the unit's e2afs_sqrt, with ftz) agree on every v_hat >= 0: zero,
    float32 subnormals and normals."""
    x = np.concatenate([[0.0, 1e-45, 1e-40, TINY / 2], np.asarray(sampled_normal_values())])
    x = x.astype(np.float32)
    ours_pos = e2afs.e2afs_sqrt_positive(torch.from_numpy(x)).numpy()
    ours_unit = get_unit("e2afs").sqrt(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(ours_pos), _bits(ours_unit))
    assert np.array_equal(_bits(ours_pos), _bits(jax_sqrt_positive(jnp.asarray(x))))
    assert (ours_pos[:4] == 0).all()


def test_adam_wrapper_updates_in_place_on_the_cpu():
    p, g, m, v = (torch.from_numpy(a) for a in _adam_inputs(300, 9))
    sched = torch.from_numpy(_sched(3))
    want = ref_adam_update(p, g, m, v, sched, **HYPER)
    ids = [t.data_ptr() for t in (p, m, v)]
    dispatch.reset_launch_counts()
    out = adam_update(p, g, m, v, sched, **HYPER)
    assert [t.data_ptr() for t in out] == ids
    for o, w in zip(out, want):
        assert torch.equal(o, w)
    assert dispatch.launch_counts()["adam"] == 0  # the CPU never launches


# ---------------------------------------------------------------------------
# AdamW, the schedule, the clip, compression
# ---------------------------------------------------------------------------


def test_schedule_within_one_ulp_of_its_terms():
    """lr, b1c and b2c as float32 device tensors, against the reference's.
    torch's and XLA's float32 ``pow`` and ``cos`` differ by an ulp; the
    cancellations in ``1 - b**s`` and ``1 + cos(pi * frac)`` then read as up
    to 2 ulps of b2c and 158 ulps of a tiny lr near the end of the decay
    (ROADMAP C.10).  So: ``b**s`` within 1 ulp, b1c and b2c within one ulp of
    ``b**s`` or of themselves, lr within one ulp of the peak lr."""
    cfg = AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=2000)
    jcfg = jax_adamw.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=2000)
    steps = np.arange(0, 2001, dtype=np.int32)
    j_lr = np.asarray(jax.vmap(lambda s: jax_adamw.cosine_lr(jcfg, s))(jnp.asarray(steps)))
    t_lr = cosine_lr(cfg, torch.from_numpy(steps)).numpy()
    assert t_lr.dtype == np.float32
    assert (np.abs(t_lr - j_lr) <= np.spacing(np.float32(cfg.lr))).all()
    sf = jnp.asarray(steps).astype(jnp.float32)
    t_bc = bias_corrections(cfg, torch.from_numpy(steps))
    for b, t_c in zip((jcfg.b1, jcfg.b2), t_bc):
        j_pow = np.asarray(b ** sf)
        t_pow = torch.pow(torch.tensor(b, dtype=torch.float32),
                          torch.from_numpy(steps).float()).numpy()
        normal = t_pow >= TINY  # XLA flushes the subnormal tail of 0.9**s to 0
        assert _ulps(j_pow[normal], t_pow[normal]) <= 1
        j_c = np.asarray(1.0 - b ** sf)
        assert (np.abs(t_c.numpy() - j_c) <= np.maximum(np.spacing(j_pow), np.spacing(j_c))).all()
    assert float(t_bc[0][0]) == 0.0


def _tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 48), "b": (48,), "c": (3, 32, 16)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in shapes.items()}
    return p, g


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("fused", [False, True])
def test_adamw_update_matches_the_reference(fused, clip):
    p, g = _tree(1)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip, sqrt_unit="e2afs",
              fused=fused)
    jcfg, cfg = jax_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jstate = jax_adamw.adamw_init(jp)
    tp = {k: torch.from_numpy(a.copy()) for k, a in p.items()}
    tstate = adamw_init(tp)
    for step in range(3):
        grads = {k: a * (step + 1) for k, a in g.items()}
        jp, jstate, jm = jax_adamw.adamw_update(jcfg, {k: jnp.asarray(a) for k, a in grads.items()},
                                                jstate, jp)
        tgrads = {k: torch.from_numpy(a.copy()) for k, a in grads.items()}
        out_p, tstate, tm = adamw_update(cfg, tgrads, tstate, tp)
        assert out_p is tp  # in place
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        if clip is not None:
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        for k in p:
            for ours, ref in ((tp[k], jp[k]), (tstate["m"][k], jstate["m"][k]),
                              (tstate["v"][k], jstate["v"][k])):
                ref = np.asarray(ref)
                np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6,
                                           atol=1e-6 * np.abs(ref).max())
    assert int(tstate["step"]) == int(jstate["step"]) == 3


def test_fused_adamw_requires_e2afs():
    p, g = _tree(2)
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    with pytest.raises(ValueError, match="e2afs"):
        adamw_update(AdamWConfig(fused=True, sqrt_unit="exact"),
                     {k: torch.from_numpy(a) for k, a in g.items()}, adamw_init(tp), tp)


@pytest.mark.parametrize("unit", ["exact", "e2afs"])
def test_global_norm_clip_scales_in_place(unit):
    _, g = _tree(3)
    jg, jnorm = jax_adamw.global_norm_clip({k: jnp.asarray(a) for k, a in g.items()}, 1.0, unit)
    tg = {k: torch.from_numpy(a.copy()) for k, a in g.items()}
    ptrs = {k: t.data_ptr() for k, t in tg.items()}
    out, tnorm = global_norm_clip(tg, 1.0, unit)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for k in g:
        assert out[k].data_ptr() == ptrs[k]
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jg[k]), rtol=1e-6)


def test_compress_decompress_matches_the_reference():
    _, g = _tree(4)
    jres = jax_compression.compress_init({k: jnp.asarray(a) for k, a in g.items()})
    tres = compress_init({k: torch.from_numpy(a) for k, a in g.items()})
    for step in range(3):
        grads = {k: a * (1 + step) for k, a in g.items()}
        jg, jres = jax_compression.compress_decompress(
            {k: jnp.asarray(a) for k, a in grads.items()}, jres)
        tg = {k: torch.from_numpy(a.copy()) for k, a in grads.items()}
        compress_decompress(tg, tres)
        for k in g:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_synthetic_batches_equal_the_reference(n_hosts):
    cfg = dict(vocab=512, seq_len=128, global_batch=8, seed=3)
    ours, ref = SyntheticLM(DataConfig(**cfg)), JaxSyntheticLM(JaxDataConfig(**cfg))
    for step in (0, 1, 17):
        for host in range(n_hosts):
            a = ours.batch(step, host_id=host, n_hosts=n_hosts)
            b = ref.batch(step, host_id=host, n_hosts=n_hosts)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert host_slice(8, 1, 2) == slice(4, 8)


def test_batch_digest_pinned():
    """The digest the reference's own pipeline test pins."""
    b = SyntheticLM(DataConfig(vocab=512, seq_len=128, global_batch=8, seed=3)).batch(17)
    assert b["tokens"][0, :8].tolist() == [31, 295, 2, 509, 142, 281, 41, 9]
    assert int(b["tokens"].sum()) == 211076
    assert hashlib.sha256(b["tokens"].tobytes()).hexdigest() == (
        "7d67c87d2c3042de0912064cec451c464bd65e32d63c881c0c127b8413f35cd6")
