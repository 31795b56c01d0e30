"""The torch port's kernel modules against the JAX package's.

On the CPU each wrapper runs its plain version; these tests hold those plain
versions against the JAX oracles (``ref``) and the Pallas kernels in
interpret mode (``ops``), on the same numpy inputs.  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and by ``chip_smoke.py``.

Tolerances and their reasons:
* e2afs sqrt/rsqrt: bit-identical (integer datapath).  Against the Pallas
  kernel the only difference allowed is rsqrt of a positive subnormal,
  where the Pallas kernel returns 0 and the port (like the oracle) +inf.
* rmsnorm: float32 within 1e-6 relative, bfloat16 within one ulp; only the
  order of the float32 sum of squares differs.
* decode attention: float32 atol 1e-5; bfloat16 atol 1e-2 and rtol 1e-2
  (the reference's own kernel-vs-oracle bf16 tolerance): sums run in
  another order, and bf16 rounds weights and outputs after them.
"""
import itertools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import metrics as jax_metrics
from repro.core import numerics as jax_numerics
from repro.kernels.attention import ops as jax_attn
from repro.kernels.e2afs_sqrt import ops as jax_e2afs_ops
from repro.kernels.e2afs_sqrt import ref as jax_e2afs_ref
from repro.kernels.rmsnorm import ops as jax_rms_ops
from repro.layers import norms as jax_norms
from repro_torch.kernels import dispatch
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.e2afs_sqrt import ops as e2afs_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import ref_rmsnorm

_NP = {"fp16": np.float16, "bf16": ml_dtypes.bfloat16, "fp32": np.float32}
_NP_INT = {"fp16": np.int16, "bf16": np.int16, "fp32": np.int32}
_TORCH = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}
_TORCH_INT = {"fp16": torch.int16, "bf16": torch.int16, "fp32": torch.int32}


def _patterns(name):
    if name == "fp32":
        a = np.asarray(jax_metrics.sampled_normal_values(jax_numerics.FP32))
        a = np.concatenate([a, np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -2.0, 1e-40,
                                         -1e-40, 1e-45], np.float32)])
    else:
        a = np.arange(1 << 16, dtype=np.uint16).view(_NP[name])
    return a, torch.from_numpy(a.view(_NP_INT[name]).copy()).view(_TORCH[name])


def _differs(jax_out, torch_out, name):
    a = np.asarray(jax_out)
    ai = a.view(_NP_INT[name])
    bi = torch_out.view(_TORCH_INT[name]).numpy()
    both_nan = np.isnan(a.astype(np.float32)) & torch.isnan(torch_out.float()).numpy()
    return ~((ai == bi) | both_nan)


# ---------------------------------------------------------------------------
# e2afs sqrt / rsqrt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
@pytest.mark.parametrize("name", ["fp16", "bf16", "fp32"])
def test_e2afs_matches_oracle(op, name):
    a, t = _patterns(name)
    ref = getattr(jax_e2afs_ref, f"ref_{op}")(jnp.asarray(a))
    assert not _differs(ref, getattr(e2afs_ops, op)(t), name).any()


@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
@pytest.mark.parametrize("name", ["fp16", "bf16", "fp32"])
def test_e2afs_matches_pallas_interpret(op, name):
    """Bit-identical to the Pallas kernel except rsqrt of positive
    subnormals: the Pallas kernel gives 0 there, the port +inf."""
    a, t = _patterns(name)
    pallas = np.asarray(getattr(jax_e2afs_ops, op)(jnp.asarray(a), interpret=True))
    ours = getattr(e2afs_ops, op)(t)
    bad = _differs(pallas, ours, name)
    if op == "sqrt":
        assert not bad.any()
        return
    f = a.astype(np.float32)
    pos_sub = (f > 0) & (f < np.finfo(_NP[name]).tiny) if name != "bf16" else (
        (f > 0) & (f < float(ml_dtypes.finfo(ml_dtypes.bfloat16).tiny)))
    np.testing.assert_array_equal(bad, pos_sub)
    assert pos_sub.any()
    assert (pallas[pos_sub] == 0).all() and torch.isposinf(ours[torch.from_numpy(pos_sub)]).all()


@pytest.mark.parametrize("k", range(8))
@pytest.mark.parametrize("name", ["fp16", "bf16", "fp32"])
def test_e2afs_output_takes_the_inputs_address_mod_16(name, k):
    """The kernel reads x and writes y in 16-byte vectors from x's first
    16-byte boundary, so the wrapper's output lies at x's address mod 16,
    whatever view x is (base[k:] here), with x's shape."""
    base = torch.zeros(3 * 67 + 8, dtype=_TORCH[name])
    x = base[k:k + 3 * 67].view(3, 67)
    y = e2afs_ops._output_like(x)
    assert y.data_ptr() % 16 == x.data_ptr() % 16
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_contiguous()


def test_e2afs_kernel_refusals():
    """What the CUDA kernel does not take is refused before any launch (the
    checks run on any device)."""
    with pytest.raises(ValueError, match="float16/bfloat16/float32"):
        e2afs_ops._check(torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        e2afs_ops._check(torch.ones(4, 8)[:, ::2])
    with pytest.raises(ValueError, match="runs on the card"):
        e2afs_ops.scalar_design(torch.ones(4), rsqrt=False)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


def _ulps(ours: torch.Tensor, ref: np.ndarray, man_bits: int) -> float:
    r = ref.astype(np.float32)
    _, e = np.frexp(r)
    ulp = np.ldexp(np.ones_like(r), e - 1 - man_bits)
    return float((np.abs(ours.float().numpy() - r) / ulp).max())


def _rms_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.1, 10)
    s = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, s


@pytest.mark.parametrize("shape", [(6, 64), (3, 5, 128), (4, 2560)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas_and_layer(shape, dtype):
    x, s = _rms_inputs(shape, sum(shape))
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    pallas = np.asarray(jax_rms_ops.rmsnorm(xj, jnp.asarray(s), interpret=True).astype(jnp.float32))
    layer = np.asarray(jax_norms.rmsnorm(jnp.asarray(s), xj, sqrt_unit="e2afs").astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    ours = rms_ops.rmsnorm(xt, torch.from_numpy(s).to(xt.dtype))
    assert ours.dtype == xt.dtype and ours.shape == xt.shape
    for ref in (pallas, layer):
        if dtype == "float32":
            np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=0)
        else:
            assert _ulps(ours, ref, 7) <= 1.0


def test_rmsnorm_plain_version_is_the_kernel_oracle():
    x, s = _rms_inputs((5, 96), 3)
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    assert torch.equal(rms_ops.rmsnorm(xt, st), ref_rmsnorm(xt, st))
    exact = ref_rmsnorm(xt, st, sqrt_unit="exact")
    torch.testing.assert_close(rms_ops.rmsnorm(xt, st), exact, rtol=0.1, atol=0.1)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def _attn_inputs(b, t, h, kv, hd, quantized, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, (b, t, kv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (b, t, kv, hd)).astype(np.int8)
        ks = (rng.uniform(0.001, 0.02, (b, t, kv))).astype(np.float32)
        vs = (rng.uniform(0.001, 0.02, (b, t, kv))).astype(np.float32)
    else:
        k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
        v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
        ks = vs = None
    # rows at the start, in the middle, at the last line and past the end
    pos = np.array([0, 3, t // 2, t - 1, t, 3 * t][:b], np.int32)
    return q, k, v, pos, ks, vs


def _attn_cases():
    """(h, kv, hd, dtype, wrap, quantized): G = 4 and 1 at hd 16 in every
    combination; the shapes the kernel pads or runs in passes (G = 3, 5, 7
    and 20; head_dim 24 and 80, a line of 3 and 10 vectors) in two."""
    for h, kv in ((8, 2), (4, 4)):
        for dtype, wrap, quantized in itertools.product(("float32", "bfloat16"), (False, True),
                                                        (False, True)):
            yield pytest.param(h, kv, 16, dtype, wrap, quantized,
                               id=f"{h}-{kv}-{dtype}-{wrap}-{quantized}")
    for h, kv, hd in ((6, 2, 16), (5, 1, 16), (14, 2, 16), (20, 1, 16), (8, 2, 24), (4, 4, 80)):
        for dtype, wrap, quantized in (("float32", True, False), ("bfloat16", False, True)):
            yield pytest.param(h, kv, hd, dtype, wrap, quantized,
                               id=f"{h}-{kv}-hd{hd}-{dtype}-{wrap}-{quantized}")


@pytest.mark.parametrize("h,kv,hd,dtype,wrap,quantized", _attn_cases())
def test_decode_attention_matches_pallas(quantized, wrap, dtype, h, kv, hd):
    """The port's decode attention against the JAX package's kernel in
    interpret mode, over the reference's shape domain.  Tolerance: 1e-5
    absolute in float32, 1e-2 absolute and relative in bf16 (the same
    function, its sums taken in another order and rounded to bf16)."""
    b, t = 6, 16
    q, k, v, pos, ks, vs = _attn_inputs(b, t, h, kv, hd, quantized, h * 10 + kv)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    scale = hd**-0.5
    # the JAX route takes the int8 cache pre-cast to q's dtype; the port's
    # kernel reads int8 as stored
    jout = jax_attn.decode_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt),
        jnp.asarray(pos), None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), scale=scale, wrap=wrap, interpret=True)
    qt = torch.from_numpy(np.array(jnp.asarray(q).astype(jdt).astype(jnp.float32))).to(tdt)
    if quantized:
        kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    else:
        kt = torch.from_numpy(np.array(jnp.asarray(k).astype(jdt).astype(jnp.float32))).to(tdt)
        vt = torch.from_numpy(np.array(jnp.asarray(v).astype(jdt).astype(jnp.float32))).to(tdt)
    ours = attn_ops.decode_attention(
        qt, kt, vt, torch.from_numpy(pos), None if ks is None else torch.from_numpy(ks),
        None if vs is None else torch.from_numpy(vs), scale=scale, wrap=wrap)
    assert ours.dtype == tdt and tuple(ours.shape) == (b, h, hd)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(jout.astype(jnp.float32)),
                               atol=tol, rtol=0 if dtype == "float32" else 1e-2)


def test_decode_attention_masks_unwritten_lines():
    """Row 0 (pos 0) sees one line: perturbing a later line leaves it alone,
    while a wrapped ring row sees every line."""
    q, k, v, pos, _, _ = _attn_inputs(6, 16, 8, 2, 16, False, 5)
    args = [torch.from_numpy(a) for a in (q, k, v, pos)]
    out = attn_ops.decode_attention(*args, scale=0.25, wrap=True)
    k2 = args[1].clone()
    k2[:, 9] += 100.0
    out2 = attn_ops.decode_attention(args[0], k2, args[2], args[3], scale=0.25, wrap=True)
    assert torch.equal(out[0], out2[0])
    assert not torch.equal(out[5], out2[5])


# ---------------------------------------------------------------------------
# dispatch: routes and launch counts
# ---------------------------------------------------------------------------


def test_cpu_tensors_never_count_launches():
    dispatch.reset_launch_counts()
    x = torch.rand(4, 128) + 0.1
    e2afs_ops.sqrt(x)
    e2afs_ops.rsqrt(x)
    rms_ops.rmsnorm(x, torch.zeros(128))
    q, k, v, pos, ks, vs = _attn_inputs(2, 8, 4, 2, 8, True, 1)
    attn_ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, ks, vs)), scale=0.3)
    assert set(dispatch.launch_counts().values()) == {0}
    assert set(dispatch.launch_counts()) == set(dispatch.KNOWN)


def test_set_backend_round_trip():
    prev = dispatch.set_backend("reference")
    try:
        assert prev == "auto"
        assert not dispatch.use_kernel(torch.zeros(1))
    finally:
        assert dispatch.set_backend(prev) == "reference"
    assert dispatch.set_backend(None) == "auto"
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.set_backend("interpret")


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no kernel route"):
        dispatch.use_kernel(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        dispatch.use_kernel(torch.zeros(1), torch.zeros(1, device="meta"))


@pytest.mark.parametrize("case,match", [
    ("long_line", "head_dim"),
    ("head_dim", "head_dim"),
    ("scales", "need k_scale and v_scale"),
    ("pos", "int32"),
    ("dtype", "k/v must be int8"),
    ("empty", "at least one line"),
])
def test_decode_attention_refusals(case, match):
    """What the CUDA kernel does not take is refused before any launch (the
    checks run on any device)."""
    q, k, v, pos, ks, vs = (torch.from_numpy(a) if a is not None else None
                            for a in _attn_inputs(2, 8, 8, 2, 16, False, 4))
    if case == "long_line":  # past 256
        q, k, v = torch.ones(2, 8, 264), torch.ones(2, 8, 2, 264), torch.ones(2, 8, 2, 264)
    elif case == "head_dim":  # not a multiple of a float32 line's 4-element vectors
        q, k, v = torch.ones(2, 8, 10), torch.ones(2, 8, 2, 10), torch.ones(2, 8, 2, 10)
    elif case == "scales":
        k, v = k.to(torch.int8), v.to(torch.int8)
    elif case == "pos":
        pos = pos.long()
    elif case == "dtype":
        k = k.double()
    elif case == "empty":
        k, v = k[:, :0], v[:, :0]
    with pytest.raises(ValueError, match=match):
        attn_ops._check(q, k, v, pos, ks, vs)


def test_decode_attention_takes_the_reference_domain():
    """The wrapper's checks accept every shape of the reference kernel's
    domain that ``decode_attention.cu`` takes (any group, head_dim a
    multiple of the line's vector width up to 256, bf16, float32 and int8
    caches) and refuse the rest by head_dim, on fake tensors; on the fake
    kernel route a call counts one launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    groups = tuple(range(1, 21)) + (24, 32, 48, 64)
    with FakeTensorMode():
        pos = torch.empty(2, dtype=torch.int32)
        for q_dtype, kv_dtype in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
                                  (torch.float32, torch.float32), (torch.float32, torch.int8)):
            vec = 4 if kv_dtype == torch.float32 else 8
            quantized = kv_dtype == torch.int8
            scales = (torch.empty(2, 5, 2),) * 2 if quantized else (None, None)
            for hd in range(1, 265):
                k = torch.empty(2, 5, 2, hd, dtype=kv_dtype)
                if hd % vec == 0 and hd <= 256:
                    # every group at a few widths, a few groups at every width
                    for g in groups if hd in (vec, 80, 96, 256) else (1, 5, 48):
                        q = torch.empty(2, 2 * g, hd, dtype=q_dtype)
                        assert attn_ops._check(q, k, k, pos, *scales) == quantized
                else:
                    q = torch.empty(2, 6, hd, dtype=q_dtype)
                    with pytest.raises(ValueError, match="head_dim"):
                        attn_ops._check(q, k, k, pos, *scales)
        dispatch.reset_launch_counts()
        with dispatch.fake_cpu_kernel_route():
            for g, hd in ((5, 256), (48, 128), (3, 80)):
                q = torch.empty(2, g, hd, dtype=torch.bfloat16)
                k = torch.empty(2, 7, 1, hd, dtype=torch.bfloat16)
                out = attn_ops.decode_attention(q, k, k, pos, scale=hd**-0.5, wrap=True)
                assert tuple(out.shape) == (2, g, hd)
        assert dispatch.launch_details() == {"decode_attention wrap": 3}
    dispatch.reset_launch_counts()


def test_launch_details_tally_variants():
    """A wrapper may name the variant it launched (decode attention: "wrap"
    or "no wrap"); the tally sits beside the kernel's count and resets with
    it."""
    dispatch.reset_launch_counts()
    try:
        for detail in ("wrap", "wrap", "no wrap"):
            dispatch.count_launch("decode_attention", detail)
        dispatch.count_launch("rmsnorm")
        assert dispatch.launch_counts()["decode_attention"] == 3
        assert dispatch.launch_counts()["rmsnorm"] == 1
        assert dispatch.launch_details() == {"decode_attention wrap": 2,
                                             "decode_attention no wrap": 1}
    finally:
        dispatch.reset_launch_counts()
    assert dispatch.launch_details() == {} and set(dispatch.launch_counts().values()) == {0}


def test_captured_launches_count_at_each_replay():
    """Launches counted while a CUDA graph is captured stay out of the
    totals (a capture launches nothing) and are added once a replay; a
    capture inside a capture is refused."""
    dispatch.reset_launch_counts()
    try:
        dispatch.count_launch("rmsnorm")
        with dispatch.capture_launches() as record:
            dispatch.count_launch("decode_attention", "wrap")
            dispatch.count_launch("rmsnorm")
            dispatch.count_launch("rmsnorm")
            with pytest.raises(RuntimeError, match="already"):
                with dispatch.capture_launches():
                    pass
        assert dispatch.launch_counts()["rmsnorm"] == 1
        assert dispatch.launch_counts()["decode_attention"] == 0
        assert record.counts["rmsnorm"] == 2 and record.counts["decode_attention"] == 1
        for _ in range(3):
            dispatch.replay_launches(record)
        assert dispatch.launch_counts()["rmsnorm"] == 7
        assert dispatch.launch_counts()["decode_attention"] == 3
        assert dispatch.launch_details() == {"decode_attention wrap": 3}
        dispatch.count_launch("rmsnorm")  # counting goes on to the totals after the capture
        assert dispatch.launch_counts()["rmsnorm"] == 8
    finally:
        dispatch.reset_launch_counts()
