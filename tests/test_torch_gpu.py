"""The torch port's CUDA kernels on the card, each against its plain version.

Every test here is marked ``gpu`` and skips without a CUDA device (decided
in the ``cuda_device`` fixture, never at import).  The file imports no JAX,
so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: e2afs bit-identical; RMSNorm float32 within 1e-6 relative, bf16
``T(x * inv)`` within one ulp (zero scale) and the scaled output within two
(the ``1 + scale`` multiply stretches a one-ulp step, then rounds); decode
attention float32 atol 1e-5, bf16 within two ulps at each (slot, head) row's
largest output; Sobel bit-identical; K-means assignments and counts equal,
sums within 1e-6 relative of a float64 sum of the same assignments (the
kernel's fixed-order tree) and within 1e-5 of the plain version (cuBLAS
sums of up to 262,144 terms in its own order), bit-identical from run to
run; adam bit-identical (p, m and v; one training step on the kernel route
against the plain route too); speculative verify rows bit-identical to the
sequential steps, replayed spec chunks to eager ones, spec tokens to the
plain engine's; whisper-small's kernel route within 4 bf16 ulps of the
largest |logit| of its plain route, tokens identical, and its cross-K/V
slot step replayed bit-identical to the eager one; an engine on the
card's one-device mesh, exact or tensor parallel, bit-identical to the
unsharded engine, and a pool restored onto it bit for bit; the sharded
train step on that mesh bit-identical to the unsharded step, with the same
launches.  Only the order of float32 sums differs between a kernel and its
plain version.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.metrics import sampled_normal_values
from repro_torch.kernels import dispatch
from repro_torch.kernels.adam import ops as adam_ops
from repro_torch.kernels.adam.ref import ref_adam_update
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.e2afs_sqrt import ops as e2afs_ops
from repro_torch.kernels.kmeans import ops as kmeans_ops
from repro_torch.kernels.kmeans.ref import ref_kmeans_assign
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import ref_rmsnorm
from repro_torch.kernels.sobel import ops as sobel_ops
from repro_torch.kernels.sobel.ref import ref_sobel
from repro_torch.launch.engine import Engine, Request
from repro_torch.models import lm

pytestmark = pytest.mark.gpu

_INT = {torch.float16: torch.int16, torch.bfloat16: torch.int16, torch.float32: torch.int32}
_MAN_BITS = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _plain(fn, *args, **kw):
    prev = dispatch.set_backend("reference")
    try:
        return fn(*args, **kw)
    finally:
        dispatch.set_backend(prev)


def _ulps(y, r, at=None):
    """max |y - r| in ulps of r's dtype, taken at ``at`` (default r)."""
    _, e = torch.frexp((r if at is None else at).float())
    ulp = torch.ldexp(torch.ones_like(r, dtype=torch.float32), e - 1 - _MAN_BITS[r.dtype])
    return float(((y.float() - r.float()).abs() / ulp).max())


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_e2afs_bit_identical(cuda_device, dtype):
    if dtype == torch.float32:
        x = sampled_normal_values()
        x = torch.cat([x, torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                                        -2.0, 1e-40, -1e-40])])
    else:
        x = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(dtype)
    x = x.to(cuda_device)
    dispatch.reset_launch_counts()
    for op in ("sqrt", "rsqrt"):
        ours = getattr(e2afs_ops, op)(x)
        plain = _plain(getattr(e2afs_ops, op), x)
        same = (ours.view(_INT[dtype]) == plain.view(_INT[dtype])) | (
            torch.isnan(ours) & torch.isnan(plain))
        assert bool(same.all()), f"{op}: {int((~same).sum())} patterns differ"
    assert dispatch.launch_counts()["e2afs_sqrt"] == 1
    assert dispatch.launch_counts()["e2afs_rsqrt"] == 1


def _same_bits(a, b):
    """Bit-identical, NaN as NaN."""
    ai, bi = a.view(_INT[a.dtype]), b.view(_INT[b.dtype])
    return bool(((ai == bi) | (torch.isnan(a) & torch.isnan(b))).all())


def _e2afs_inputs(n, dtype, dev, seed):
    """Positive normals over 16 binades, with the specials (+-0, +-inf, NaN,
    a negative normal, +-subnormal) written at the head, in the middle and
    at the tail."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.exp(torch.empty(n, device=dev).uniform_(-5.5, 5.5, generator=g)).to(dtype)
    sub = torch.finfo(dtype).tiny / 4
    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), -2.0, sub,
                             -sub], device=dev).to(dtype)
    where = sorted({i for i in [*range(9), *range(n // 2 - 4, n // 2 + 5), *range(n - 9, n)]
                    if 0 <= i < n})
    for j, i in enumerate(where):
        x[i] = specials[j % len(specials)]
    return x


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_e2afs_kernel_route_gradient_equals_plain_route(cuda_device, dtype):
    """The kernel route differentiates (ROADMAP C.14): its gradient is the
    plain route's, bit for bit, from one forward launch and none on the
    backward.  Positive normal inputs only (fp16 rsqrt of a subnormal is
    ROADMAP C.2)."""
    from repro_torch.core import get_unit

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.exp(torch.empty(1 << 20, device=cuda_device).uniform_(-4, 4, generator=g)).to(dtype)
    ct = torch.randn(x.shape, generator=g, device=cuda_device).to(dtype)
    for op in ("sqrt", "rsqrt"):
        grads = []
        for kernel in (True, False):
            xt = x.clone().requires_grad_(True)
            dispatch.reset_launch_counts()
            y = getattr(get_unit("e2afs", kernel=kernel), op)(xt)
            forward = dispatch.launch_counts()
            y.backward(ct)
            torch.cuda.synchronize()
            assert forward[f"e2afs_{op}"] == int(kernel)
            assert dispatch.launch_counts() == forward, "the backward launched a kernel"
            grads.append(xt.grad)
        assert torch.equal(grads[0].view(_INT[dtype]), grads[1].view(_INT[dtype]))
        assert bool(torch.isfinite(grads[0]).all())


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 6, 7, 8, 9, 15, 16, 17, 31, 32, 33, 1_000_003,
                               2**20 + 3])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_e2afs_any_length(cuda_device, dtype, n):
    """Lengths around the 16-byte vectors (4 or 8 values) and the unroll,
    specials at the head, in the body and at the tail; two calls give the
    same bits."""
    x = _e2afs_inputs(n, dtype, cuda_device, n)
    for op in (e2afs_ops.sqrt, e2afs_ops.rsqrt):
        ours = op(x)
        assert ours.shape == x.shape and ours.dtype == dtype
        assert torch.equal(ours.view(_INT[dtype]), op(x).view(_INT[dtype])), "two calls differ"
        assert _same_bits(ours, _plain(op, x))


@pytest.mark.parametrize("k", range(1, 8))
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_e2afs_unaligned_views(cuda_device, dtype, k):
    """x = base[k:] starts k elements past a 16-byte boundary: the output
    takes x's address mod 16, and the bits are those of an aligned copy."""
    base = _e2afs_inputs(4099 + k, dtype, cuda_device, k)
    x = base[k:]
    for op in (e2afs_ops.sqrt, e2afs_ops.rsqrt):
        ours = op(x)
        assert ours.data_ptr() % 16 == x.data_ptr() % 16 and ours.is_contiguous()
        assert _same_bits(ours, _plain(op, x))
        assert torch.equal(ours.view(_INT[dtype]), op(x.clone()).view(_INT[dtype]))


@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_e2afs_datapath_on_every_pattern(cuda_device, dtype, op):
    """The kernel's lean datapath gives the general one's bits on all 2^16
    or 2^32 patterns, by vectors and one value at a time."""
    assert e2afs_ops.unit_mismatches(dtype, rsqrt=op == "rsqrt", device=cuda_device) == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_e2afs_first_design_gives_the_same_bits(cuda_device, dtype):
    """The first design, timed beside the kernel by chip_smoke.py phase 5."""
    x = _e2afs_inputs(100_003, dtype, cuda_device, 5)
    for rsqrt, op in ((False, e2afs_ops.sqrt), (True, e2afs_ops.rsqrt)):
        assert torch.equal(e2afs_ops.scalar_design(x, rsqrt=rsqrt).view(_INT[dtype]),
                           op(x).view(_INT[dtype]))


@pytest.mark.parametrize("shape", [(8, 2560), (1024, 2560), (8 * 32 * 16, 128)] + [
    (rows, d) for rows in (1, 3, 4096) for d in (100, 128, 1152, 2560)] + [
    (3, 12288), (3, 40000)] + [
    # gemma3-1b serving: decode and prefill rows of 1152, qk-norm rows of 256
    (8, 1152), (8 * 2048, 1152), (8, 256), (8 * 4, 256), (8 * 2048, 256), (8 * 2048 * 4, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches_plain(cuda_device, dtype, shape):
    """Every layout of rmsnorm.cu: rows of a block (d = 1152, 2560), rows
    wider than a block's threads (12288) and than its registers (40000),
    rows that share a warp (d = 128), and the one-element loads (d = 100, and
    x not on a 16-byte boundary)."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    s = (0.1 * torch.randn(shape[-1], generator=g, device=cuda_device)).to(dtype)
    # the same values one element past a 16-byte boundary, still contiguous
    unaligned = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)[1:].view(shape)
    unaligned.copy_(x)
    for scale, limit in ((torch.zeros_like(s), 1.0), (s, 2.0)):
        plain = ref_rmsnorm(x, scale)
        ours = rms_ops.rmsnorm(x, scale)
        assert torch.equal(ours, rms_ops.rmsnorm(x, scale)), "two calls differ"
        for out in (ours, rms_ops.rmsnorm(unaligned, scale)):
            if dtype == torch.float32:
                torch.testing.assert_close(out, plain, rtol=1e-6, atol=0)
            else:
                assert _ulps(out, plain) <= limit


def _attn_case(dev, b, t, h, kv, hd, dtype, quantized, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, hd, generator=g, device=dev).to(dtype)
    if quantized:
        k, v = (torch.randint(-127, 128, (b, t, kv, hd), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8) for _ in range(2))
        ks, vs = (torch.rand(b, t, kv, generator=g, device=dev) * 0.02 + 1e-3
                  for _ in range(2))
    else:
        k, v = (torch.randn(b, t, kv, hd, generator=g, device=dev).to(dtype) for _ in range(2))
        ks = vs = None
    # mixed rows: the first line, early, middle, the last line, at and past the end
    rows = [0, 3, t // 2, t - 1, t, 3 * t]
    pos = torch.tensor([rows[i % len(rows)] for i in range(b)], dtype=torch.int32, device=dev)
    return q, k, v, pos, ks, vs


_LENGTHS = ("1", "chunk-1", "chunk", "chunk+1", "576", "4096")


def _one_chunk(q, kv, k_dtype):
    """The longest cache that decode_attention.cu keeps as one chunk for
    these shapes (a tile: 32 lines of a bf16 hd = 128 cache)."""
    b, _, hd = q.shape
    t = 1
    while attn_ops.plan(q, torch.empty(b, t + 1, kv, hd, dtype=k_dtype, device="meta"))[
            "chunks"] == 1:
        t += 1
    return t


def _length(name, q, kv, k_dtype):
    """A named cache length: around the longest one-chunk cache, or a
    serving length."""
    if not name.startswith("chunk"):
        return int(name)
    return _one_chunk(q, kv, k_dtype) + {"chunk-1": -1, "chunk": 0, "chunk+1": 1}[name]


def _assert_attention_close(out, plain, dtype):
    assert out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, atol=1e-5, rtol=0)
    else:
        row = plain.float().abs().amax(dim=-1, keepdim=True).to(dtype)
        assert _ulps(out, plain, at=row.expand_as(plain)) <= 2.0


@pytest.mark.parametrize("length", _LENGTHS)
@pytest.mark.parametrize("group", [1, 2, 4, 8, 3, 5, 7, 9, 14, 20])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain(cuda_device, quantized, dtype, group, length):
    """decode_attention.cu against the plain version: the instantiated
    groups 1, 2, 4 and 8 on 32 query heads, and groups it runs padded (3 as
    4, 5 as 6, 7 as 8, 9 as 10, 14 as 16) or in passes (20: two of 10) on
    32 // G KV heads; float and int8 caches, wrap off and on, mixed per-row
    positions, cache lengths around one chunk and at the serving lengths.
    Two calls are bit-identical."""
    b, hd = 6, 128
    kv = 32 // group
    h = kv * group
    q = torch.empty(b, h, hd, dtype=dtype, device=cuda_device)
    t = _length(length, q, kv, torch.int8 if quantized else dtype)
    q, k, v, pos, ks, vs = _attn_case(cuda_device, b, t, h, kv, hd, dtype, quantized, t + group)
    for wrap in (False, True):
        plain = attn_ops.ref_decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        ours = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        again = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        assert torch.equal(ours, again), "two calls differ"
        _assert_attention_close(ours, plain, dtype)


@pytest.mark.parametrize("t", [512, 2112])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_gemma3_shapes(cuda_device, dtype, quantized, t):
    """gemma3-1b's decode layer: 8 slots, one KV head of four query heads,
    head_dim 256 (a float32 line is 64 vectors: two a lane), a window
    layer's 512-line ring and a global layer's 2112 lines, wrap off and on,
    mixed per-row positions.  Two calls are bit-identical."""
    b, h, kv, hd = 8, 4, 1, 256
    q, k, v, pos, ks, vs = _attn_case(cuda_device, b, t, h, kv, hd, dtype, quantized, t + 7)
    for wrap in (False, True):
        plain = attn_ops.ref_decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        ours = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        again = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        assert torch.equal(ours, again), "two calls differ"
        _assert_attention_close(ours, plain, dtype)


@pytest.mark.parametrize("length", ("chunk-1", "chunk", "chunk+1", "576", "4096"))
@pytest.mark.parametrize("group,hd", [(6, 128), (12, 128), (16, 128), (3, 80), (5, 96),
                                      (7, 80), (9, 96), (14, 80), (20, 96), (1, 80), (5, 24),
                                      (10, 192), (3, 136)])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_wide_groups(cuda_device, dtype, quantized, group, hd, length):
    """The groups of starcoder2-15b (12 query heads a KV head), mixtral-8x22b
    (6) and qwen3-moe-235b-a22b (16) at head_dim 128 on 4 KV heads: G = 6
    and 12 take the per-head shuffles, 16 the halving reduction; padded and
    multi-pass groups on lines of a non-power-of-two vector count: head_dim
    80 and 96 (phi-2, Phi-3-mini: 10 and 12 vectors of bf16, 20 and 24 of
    float32), 24 (an int8 line of three 8-byte vectors), 192 and 136 (a
    float32 line of 48 and 34 vectors, two a lane); float and int8 caches,
    wrap off and on, mixed per-row positions, around one chunk and at the
    serving lengths.  Two calls are bit-identical."""
    b, kv = 6, 4
    h = kv * group
    q = torch.empty(b, h, hd, dtype=dtype, device=cuda_device)
    t = _length(length, q, kv, torch.int8 if quantized else dtype)
    q, k, v, pos, ks, vs = _attn_case(cuda_device, b, t, h, kv, hd, dtype, quantized, t + group)
    for wrap in (False, True):
        plain = attn_ops.ref_decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        ours = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        again = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        assert torch.equal(ours, again), "two calls differ"
        _assert_attention_close(ours, plain, dtype)


def test_decode_attention_in_runs_of_slots(cuda_device):
    """More chunks than the blocks that fit on the card at once: the call
    launches once for each run of slots that fits, and still matches."""
    b, h, kv, hd, t, dtype = 40, 32, 4, 128, 4096, torch.bfloat16
    q, k, v, pos, ks, vs = _attn_case(cuda_device, b, t, h, kv, hd, dtype, False, 5)
    assert attn_ops.plan(q, k)["slots"] < b
    plain = attn_ops.ref_decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=True)
    ours = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=True)
    assert torch.equal(ours, attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5,
                                                       wrap=True)), "two calls differ"
    _assert_attention_close(ours, plain, dtype)


@pytest.mark.parametrize("h,kv,passes,group", [(32, 8, 1, 4), (30, 6, 1, 6), (48, 1, 3, 16)])
@pytest.mark.parametrize("b", [1, 8, 256])
@pytest.mark.parametrize("t", [1, 31, 32, 33, 576, 4096, 32768])
def test_decode_attention_plan_covers_every_line(cuda_device, b, t, h, kv, passes, group):
    """The split: S chunks of chunk_lines cover lines 0..t-1 once, no chunk
    is empty, a cache of one tile (32 bf16 lines of hd = 128) is one chunk,
    a launch takes between 1 and b slots, and the workspace holds the chunk
    maxima, sums and partial outputs of a launch's slots, a pass's heads
    padded to the group it runs as (G = 4 as it is, 5 as 6, 48 in three
    passes of 16, a launch each)."""
    hd = 128
    q = torch.empty(b, h, hd, dtype=torch.bfloat16, device=cuda_device)
    k = torch.empty(b, t, kv, hd, dtype=torch.bfloat16, device="meta")
    p = attn_ops.plan(q, k)
    s, cl = p["chunks"], p["chunk_lines"]
    assert (p["passes"], p["group"]) == (passes, group)
    assert (s - 1) * cl < t <= s * cl
    if t <= 32:
        assert s == 1
    elif b * kv * 2 <= torch.cuda.get_device_properties(cuda_device).multi_processor_count:
        # room on the card for two chunks a (slot, KV head)
        assert s > 1
    assert 1 <= p["slots"] <= b
    rows = kv * group  # workspace rows a slot
    assert p["workspace"] == (p["slots"] * rows * s * (hd + 2) if s > 1 else 0)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = torch.ones(4, 256, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        rms_ops.rmsnorm(x[:, ::2], torch.zeros(128, device=cuda_device))
    with pytest.raises(ValueError, match="scale must be"):
        rms_ops.rmsnorm(x, torch.zeros(256, device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="float16/bfloat16/float32"):
        e2afs_ops.sqrt(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        e2afs_ops.rsqrt(x[:, ::2])
    q = torch.ones(2, 4, 16, device=cuda_device)
    k = torch.ones(2, 8, 2, 16, device=cuda_device)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        attn_ops.decode_attention(q, k, k, pos.long(), scale=0.25)
    with pytest.raises(ValueError, match="head_dim"):  # not a multiple of 4
        attn_ops.decode_attention(torch.ones(2, 4, 18, device=cuda_device),
                                  torch.ones(2, 8, 2, 18, device=cuda_device),
                                  torch.ones(2, 8, 2, 18, device=cuda_device), pos, scale=0.25)
    with pytest.raises(ValueError, match="need k_scale and v_scale"):
        attn_ops.decode_attention(q, k.to(torch.int8), k.to(torch.int8), pos, scale=0.25)


@pytest.mark.parametrize("window", [None, 6])
def test_model_kernels_match_plain_versions(cuda_device, window):
    """float32 smoke model on the card: the kernel route and the plain
    versions give the same greedy tokens; the kernel route launches every
    norm and decode-attention kernel it should, the plain route none.  With
    window 6, every layer slides: its cache is a 6-line ring, which the
    prompt of 8 and the 16 steps wrap around."""
    extra = {} if window is None else {"block_pattern": ("window",), "window": window}
    cfg = get_smoke_config("qwen3-4b", act_dtype="float32", sqrt_unit="e2afs",
                           decode_kernel="fused", **extra)
    model = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    b, s, gen = 2, 8, 16
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (b, s)))
    prompt = prompt.to(cuda_device)
    out = {}
    for backend, route in (("auto", "fused"), ("reference", "reference")):
        prev = dispatch.set_backend(backend)
        try:
            c = cfg.replace(decode_kernel=route)
            dispatch.reset_launch_counts()
            cache = lm.init_cache(c, b, s + gen, device=cuda_device)
            assert cache["k"].shape[2] == (s + gen if window is None else window)
            logits, cache = lm.prefill(model, c, cache, prompt, last_logit_only=True)
            toks, _, _ = lm.generate_scan(model, c, cache, logits.argmax(-1), s, gen)
            out[backend] = (logits, toks, dispatch.launch_counts())
        finally:
            dispatch.set_backend(prev)
    torch.testing.assert_close(out["auto"][0], out["reference"][0], atol=1e-4, rtol=0)
    assert torch.equal(out["auto"][1], out["reference"][1])
    assert out["auto"][2]["rmsnorm"] == (4 * cfg.n_layers + 1) * (1 + gen)
    assert out["auto"][2]["decode_attention"] == cfg.n_layers * gen
    assert set(out["reference"][2].values()) == {0}


def test_gemma3_smoke_model_kernels_match_plain_versions(cuda_device):
    """gemma3-1b's smoke config (five window layers of 8 to one global) in
    float32 on the card: a prompt of 12 wraps the window layers' 8-line
    rings at prefill and the 16 steps wrap them again.  The kernel route and
    the plain versions give the same greedy tokens; the kernel route
    launches decode attention with wrap on every window layer and off on
    every global one, the plain route nothing."""
    cfg = get_smoke_config("gemma3-1b", act_dtype="float32", sqrt_unit="e2afs",
                           decode_kernel="fused")
    model = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    b, s, gen = 2, 12, 16
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (b, s)))
    prompt = prompt.to(cuda_device)
    out = {}
    for backend, route in (("auto", "fused"), ("reference", "reference")):
        prev = dispatch.set_backend(backend)
        try:
            c = cfg.replace(decode_kernel=route)
            dispatch.reset_launch_counts()
            cache = lm.init_cache(c, b, s + gen, device=cuda_device)
            assert [layer["k"].shape[1] for layer in cache] == [
                cfg.window if block == "window" else s + gen for block in cfg.blocks]
            logits, cache = lm.prefill(model, c, cache, prompt, last_logit_only=True)
            toks, _, _ = lm.generate_scan(model, c, cache, logits.argmax(-1), s, gen)
            out[backend] = (logits, toks, dispatch.launch_counts(), dispatch.launch_details())
        finally:
            dispatch.set_backend(prev)
    torch.testing.assert_close(out["auto"][0], out["reference"][0], atol=1e-4, rtol=0)
    assert torch.equal(out["auto"][1], out["reference"][1])
    windows = cfg.blocks.count("window")
    assert out["auto"][2]["rmsnorm"] == (4 * cfg.n_layers + 1) * (1 + gen)
    assert out["auto"][2]["decode_attention"] == cfg.n_layers * gen
    assert out["auto"][3] == {"decode_attention wrap": windows * gen,
                              "decode_attention no wrap": (cfg.n_layers - windows) * gen}
    assert set(out["reference"][2].values()) == {0}


def test_sqrt_normal_matches_the_general_sqrt(cuda_device):
    """The Sobel and K-means kernels' lean E2AFS sqrt gives the general
    datapath's bits on every positive normal float32 from 1e-12 up."""
    first = int(torch.tensor(1e-12).view(torch.int32))
    assert e2afs_ops.sqrt_normal_mismatches(first, 0x7F800000, cuda_device) == 0


# W = 3, 4, 5 and 7 mod 8 and H not a multiple of the kernel's 8-row strip;
# 3 x W and H x 3; the frames; a few NaN and infinite pixels.  offset 1
# starts the image 4 bytes past an aligned address, so no row takes the
# 16-byte loads.
@pytest.mark.parametrize("shape", [(3, 3), (4, 1000), (67, 93), (34, 131), (256, 256),
                                   (19, 12), (21, 2047), (3, 517), (613, 3), (1080, 1920),
                                   (2160, 3840)])
@pytest.mark.parametrize("offset", [0, 1])
def test_sobel_bit_identical(cuda_device, shape, offset):
    g = torch.Generator(device=cuda_device).manual_seed(shape[0] * shape[1])
    flat = torch.rand(offset + shape[0] * shape[1], generator=g, device=cuda_device) * 255
    flat[offset + 7::97] = float("nan")  # the plain version's specials: NaN and +inf out
    flat[offset + 50::89] = float("inf")
    img = flat[offset:].view(shape)
    dispatch.reset_launch_counts()
    ours = sobel_ops.sobel_magnitude(img)
    assert dispatch.launch_counts()["sobel"] == 1
    plain = ref_sobel(img)
    assert ours.shape == (shape[0] - 2, shape[1] - 2)
    assert torch.equal(ours.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(ours.view(torch.int32), sobel_ops.sobel_magnitude(img).view(torch.int32))


def _kmeans_inputs(dev, b, n, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    px = torch.rand(b, n, 3, generator=g, device=dev) * 255
    cent = torch.rand(b, k, 3, generator=g, device=dev) * 255
    return px, cent


def _check_kmeans(got, px, cent):
    assign, sums, counts = got
    ra, rs, rc = ref_kmeans_assign(px, cent)
    assert torch.equal(assign, ra) and torch.equal(counts, rc)
    onehot = torch.nn.functional.one_hot(ra.long(), cent.shape[-2]).double()
    exact = onehot.transpose(-1, -2) @ px.double()
    torch.testing.assert_close(sums.double(), exact, rtol=1e-6, atol=0)
    torch.testing.assert_close(sums, rs, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [1, 513, 2048, 2049, 65536])
@pytest.mark.parametrize("k", [1, 3, 8, 20, 256])
def test_kmeans_assign_matches_plain(cuda_device, n, k):
    px, cent = _kmeans_inputs(cuda_device, 1, n, k, n + k)
    px, cent = px[0], cent[0]
    dispatch.reset_launch_counts()
    first = kmeans_ops.kmeans_assign(px, cent)
    assert dispatch.launch_counts()["kmeans_assign"] == 1
    assert first[0].shape == (n,) and first[1].shape == (k, 3) and first[2].shape == (k,)
    _check_kmeans(first, px, cent)
    again = kmeans_ops.kmeans_assign(px, cent)  # deterministic: no float atomics
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("b,n", [(5, 70_000), (16, 512 * 512)])  # the latter: the deployment batch
def test_kmeans_assign_batch_is_per_image(cuda_device, b, n):
    px, cent = _kmeans_inputs(cuda_device, b, n, 20, 7)
    batch = kmeans_ops.kmeans_assign(px, cent)
    _check_kmeans(batch, px, cent)
    assert all(torch.equal(a, b) for a, b in zip(batch, kmeans_ops.kmeans_assign(px, cent)))
    for i in range(b):
        one = kmeans_ops.kmeans_assign(px[i].contiguous(), cent[i].contiguous())
        assert all(torch.equal(a[i], b) for a, b in zip(batch, one))


def test_kmeans_and_sobel_refuse_what_they_do_not_take(cuda_device):
    px, cent = _kmeans_inputs(cuda_device, 1, 100, 257, 1)
    with pytest.raises(ValueError, match="K <= 256"):
        kmeans_ops.kmeans_assign(px[0], cent[0])
    with pytest.raises(ValueError, match="contiguous"):
        kmeans_ops.kmeans_assign(px[0, ::2], cent[0, :8])
    with pytest.raises(ValueError, match="float32"):
        kmeans_ops.kmeans_assign(px[0].double(), cent[0, :8].double())
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        kmeans_ops.kmeans_assign(torch.ones(10, 4, device=cuda_device), cent[0, :8])
    img = torch.ones(16, 16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        sobel_ops.sobel_magnitude(img[:, ::2])
    with pytest.raises(ValueError, match="H, W >= 3"):
        sobel_ops.sobel_magnitude(img[:2].contiguous())


def test_paper_path_on_the_card_matches_the_cpu(cuda_device):
    """Table 3's metrics, Table 4's edge maps (kernel route) and the K-means
    batch on the card against the same entry points on the CPU."""
    from repro_torch.apps import images, kmeans, sobel
    from repro_torch.core import error_metrics, get_unit

    for name in ("esas", "cwaha4", "cwaha8", "e2afs"):
        assert (error_metrics(get_unit(name).sqrt, device=cuda_device)
                == error_metrics(get_unit(name).sqrt, device="cpu"))
    img = images.test_image("barbara", 128)
    np.testing.assert_array_equal(sobel.edge_map(img, "e2afs", use_kernel=True, device=cuda_device),
                                  sobel.edge_map(img, "e2afs", device="cpu"))
    np.testing.assert_array_equal(sobel.edge_map(img, "exact", device=cuda_device),
                                  sobel.edge_map(img, "exact", device="cpu"))
    rgbs = np.stack([images.rgb_test_image(name, 64) for name in images.IMAGE_NAMES])
    dispatch.reset_launch_counts()
    quant, cent = kmeans.kmeans_quantize_batch(rgbs, k=8, iters=6, device=cuda_device)
    assert dispatch.launch_counts()["kmeans_assign"] == 7  # one per iteration + the last assignment
    for i in range(len(rgbs)):
        q, c = kmeans.kmeans_quantize(rgbs[i], k=8, iters=6, seed=i, fused=True, device=cuda_device)
        np.testing.assert_array_equal(quant[i], q)
        np.testing.assert_array_equal(cent[i], c)


def _adam_case(dev, n, p_dtype, g_dtype, step, seed):
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import bias_corrections

    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randn(n, generator=gen, device=dev).to(p_dtype)
    g = (torch.randn(n, generator=gen, device=dev) * 0.01).to(g_dtype)
    g[::7] = 0
    m = torch.randn(n, generator=gen, device=dev) * 1e-3
    v = torch.rand(n, generator=gen, device=dev) * 1e-5
    m[::11] = 0
    v[::11] = 0
    b1c, b2c = bias_corrections(AdamWConfig(), torch.tensor(step, device=dev))
    return p, g, m, v, torch.stack([torch.tensor(1e-3, device=dev), b1c, b2c])


@pytest.mark.parametrize("n", [1, 1000, 3 * 2**20 + 5])
@pytest.mark.parametrize("p_dtype,g_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("step", [1, 1000])
def test_adam_bit_identical(cuda_device, n, p_dtype, g_dtype, step):
    p, g, m, v, sched = _adam_case(cuda_device, n, p_dtype, g_dtype, step, n + step)
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    want = ref_adam_update(p, g, m, v, sched, **hyper)
    dispatch.reset_launch_counts()
    got = adam_ops.adam_update(p, g, m, v, sched, **hyper)  # in place
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["adam"] == 1
    assert got[0] is p and got[1] is m and got[2] is v
    for ours, plain in zip(got, want):
        assert ours.dtype == plain.dtype
        ib = _INT[ours.dtype]
        assert torch.equal(ours.view(ib), plain.view(ib))


def test_adam_refuses_what_the_kernel_does_not_take(cuda_device):
    p, g, m, v, sched = _adam_case(cuda_device, 64, torch.float32, torch.float32, 1, 0)
    with pytest.raises(ValueError, match="contiguous"):
        adam_ops.adam_update(p[::2], g[::2], m[::2], v[::2], sched)
    with pytest.raises(ValueError, match="float32 m, v"):
        adam_ops.adam_update(p, g, m.to(torch.bfloat16), v, sched)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        adam_ops.adam_update(p.half(), g, m, v, sched)
    with pytest.raises(ValueError, match="one shape"):
        adam_ops.adam_update(p, g[:32], m, v, sched)
    with pytest.raises(ValueError, match="different devices"):
        adam_ops.adam_update(p, g, m, v, sched.cpu())


def test_training_step_kernel_route_equals_plain_route(cuda_device):
    """One AdamW update of qwen3-4b at full width (one layer deep) from the
    same parameters and gradients: the adam kernel route and the plain
    route give bit-identical p, m and v."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_fn
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    cfg = get_config("qwen3-4b", n_layers=1, sqrt_unit="e2afs")
    model = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device,
                    trainable=True)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (1, 128), generator=gen, device=cuda_device)
    total, _ = loss_fn(model, cfg, {"tokens": tokens, "labels": tokens.roll(-1, 1)})
    total.backward()
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, fused=True, sqrt_unit="e2afs")
    out = []
    for backend in ("auto", "reference"):
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        state = adamw_init(params)
        prev = dispatch.set_backend(backend)
        try:
            dispatch.reset_launch_counts()
            adamw_update(opt_cfg, grads, state, params)
            out.append((params, state, dispatch.launch_counts()["adam"]))
        finally:
            dispatch.set_backend(prev)
    assert out[0][2] == len(out[0][0]) and out[1][2] == 0
    for n in out[0][0]:
        assert torch.equal(out[0][0][n].view(torch.int32), out[1][0][n].view(torch.int32)), n
        for key in ("m", "v"):
            assert torch.equal(out[0][1][key][n].view(torch.int32),
                               out[1][1][key][n].view(torch.int32)), (key, n)


# ---------------------------------------------------------------------------
# The engine's decode chunk as a CUDA graph
# ---------------------------------------------------------------------------

_ENGINE_CASES = [(arch, act_dtype, quantized) for arch in ("qwen3-4b", "gemma3-1b")
                 for act_dtype in ("bfloat16", "float32") for quantized in (False, True)]


def _engine(dev, arch, act_dtype, quantized, **kw):
    """An engine of three slots of 40 lines (past gemma3-1b's smoke window of
    8) at smoke width, on the decode-attention and RMSNorm kernels."""
    cfg = get_smoke_config(arch, act_dtype=act_dtype, sqrt_unit="e2afs", decode_kernel="fused")
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return cfg, Engine(model, cfg, num_slots=3, cache_len=40, chunk=4, quantized_kv=quantized,
                       **kw)


def _trace(cfg):
    """Five requests: prompts 3 to 12 (past the smoke window), budgets 2 to
    9, one arriving later than the rest."""
    rng = np.random.default_rng(1)
    shapes = ((5, 9), (12, 3), (3, 7), (8, 2), (4, 6))
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=budget, arrival_s=0.05 if i == 4 else 0.0)
            for i, (n, budget) in enumerate(shapes)]


def _pool_bits_equal(a, b):
    return all(torch.equal(x, y) if not x.is_floating_point() else _same_bits(x, y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("arch,act_dtype,quantized", _ENGINE_CASES)
def test_graphed_chunk_equals_the_eager_chunk(cuda_device, arch, act_dtype, quantized):
    """From one pool state (three requests admitted, one of which spends its
    budget mid-chunk), a replay of the captured chunk and the same chunk run
    eagerly give bit-identical tokens, emission masks, tok, pos, active,
    remaining and cache tensors; N replays count N times the eager chunk's
    launches, by kernel and by variant."""
    cfg, eng = _engine(cuda_device, arch, act_dtype, quantized)
    eng.warmup(prompt_lens={3, 5, 12})
    assert list(eng._graphs) == [()]
    for slot, req in enumerate(_trace(cfg)[:3]):
        eng._admit(req, slot, 0.0)
    start = [t.clone() for t in lm.pool_tensors(eng.pool)]

    def chunk(run):
        for t, s0 in zip(lm.pool_tensors(eng.pool), start):
            t.copy_(s0)
        dispatch.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        return ([t.clone() for t in lm.pool_tensors(eng.pool)] + [eng._packed.clone()],
                dispatch.launch_counts(), dispatch.launch_details())

    eager, eager_counts, eager_details = chunk(eng._chunk_eager)
    graphed, graph_counts, graph_details = chunk(eng._decode_chunk)
    assert _pool_bits_equal(graphed, eager)
    assert graph_counts == eager_counts and graph_details == eager_details
    assert eager_counts["decode_attention"] == eng.chunk * cfg.n_layers
    assert eager_counts["rmsnorm"] == eng.chunk * (4 * cfg.n_layers + 1)
    dispatch.reset_launch_counts()
    for _ in range(3):
        eng._decode_chunk()
    assert dispatch.launch_counts() == {k: 3 * v for k, v in eager_counts.items()}
    assert dispatch.launch_details() == {k: 3 * v for k, v in eager_details.items()}


@pytest.mark.parametrize("arch,act_dtype,quantized", _ENGINE_CASES)
def test_staggered_request_equals_the_request_alone(cuda_device, arch, act_dtype, quantized):
    """Five requests through three slots (staggered admissions, reused
    slots, a late arrival): each one's tokens are bit-identical to the same
    request served alone in a pool of the same size."""
    cfg, eng = _engine(cuda_device, arch, act_dtype, quantized)
    eng.warmup(prompt_lens={3, 4, 5, 8, 12})
    reqs = _trace(cfg)
    done = eng.run(reqs)
    assert eng.stats["n_ok"] == len(reqs)
    for r in reqs:
        eng.reset()
        alone = eng.run([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)])
        assert len(done[r.uid].tokens) == r.max_new_tokens
        np.testing.assert_array_equal(done[r.uid].tokens, alone[r.uid].tokens)


def test_sampling_on_the_card(cuda_device):
    """Sampled tokens follow the request's stream, not its slot, on the card
    too; the stream's hash words are the CPU's bit for bit."""
    _, eng_first = _engine(cuda_device, "qwen3-4b", "float32", False, temperature=0.8,
                           top_k=8, seed=3)
    cfg, eng_second = _engine(cuda_device, "qwen3-4b", "float32", False, temperature=0.8,
                              top_k=8, seed=3)
    target = dict(uid=7, prompt=np.arange(4, dtype=np.int32), max_new_tokens=9)
    filler = dict(uid=1, prompt=np.arange(3, dtype=np.int32), max_new_tokens=2)
    a = eng_first.run([Request(**target), Request(**filler, arrival_s=1e-4)])[7].tokens
    b = eng_second.run([Request(**target, arrival_s=1e-4), Request(**filler)])[7].tokens
    np.testing.assert_array_equal(a, b)
    assert len(a) == 9 and a.min() >= 0 and a.max() < cfg.vocab
    keys = torch.tensor([[3, 7], [0xFFFFFFFF, 0x7FFFFFFF]], dtype=torch.int64).to(torch.uint32)
    pos = torch.tensor([0, 2_000_000_000], dtype=torch.int32)
    cpu = lm._stream_bits(keys, pos, cfg.padded_vocab)
    assert torch.equal(lm._stream_bits(keys.to(cuda_device), pos.to(cuda_device),
                                       cfg.padded_vocab).cpu(), cpu)


# ---------------------------------------------------------------------------
# Seeded faults and accuracy-SLO ladders on the card
# ---------------------------------------------------------------------------

_FAULT_CASES = [("sqrt_man", 1e-2, None), ("sqrt_man", 1.0, 3), ("sqrt_exp", 1e-2, None),
                ("sqrt_exp", 1.0, 2)]


def _fault_inputs(dtype):
    """Every fp16/bf16 pattern, or the float32 grid with the specials."""
    if dtype == torch.float32:
        return torch.cat([sampled_normal_values(), torch.tensor(
            [0.0, -0.0, float("inf"), -float("inf"), float("nan"), -2.0, 1e-40, -1e-40])])
    return torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(dtype)


def _normal(y):
    """Elementwise: a normal number in y's format."""
    exp_bits = {torch.float16: 5, torch.bfloat16: 8, torch.float32: 8}[y.dtype]
    man_bits = _MAN_BITS[y.dtype]
    bits = y.view(_INT[y.dtype]).to(torch.int64)
    exp = (bits >> man_bits) & ((1 << exp_bits) - 1)
    return (exp > 0) & (exp < (1 << exp_bits) - 1)


@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_faulted_datapath_on_the_card_equals_the_cpu(cuda_device, dtype, op):
    """The e2afs datapath under every fault case (both sites, a hashed and a
    pinned bit, rates 1e-2 and 1.0) gives the CPU's bits on the card."""
    from repro_torch.core import e2afs, faults

    x = _fault_inputs(dtype)
    fn = getattr(e2afs, f"e2afs_{op}")
    for site, rate, bit in _FAULT_CASES:
        cfg = faults.FaultConfig(site, rate, seed=2**33 + 7, bit=bit)
        cpu = fn(x, faults=cfg)
        card = fn(x.to(cuda_device), faults=cfg).cpu()
        assert _same_bits(card, cpu), (site, rate, bit)
        assert not _same_bits(cpu, fn(x))  # the faults struck


def test_fault_hash_words_on_the_card_equal_the_cpu(cuda_device):
    from repro_torch.core import faults

    w = torch.randint(-2**31, 2**31, (4096,), generator=torch.Generator().manual_seed(0),
                      dtype=torch.int64).to(torch.int32).reshape(64, 64)
    for seed in (0, 7, 2**32 + 5, -3):
        assert torch.equal(faults._entropy(w.to(cuda_device), seed).cpu(),
                           faults._entropy(w, seed))
        assert torch.equal(faults.fault_mask(w.to(cuda_device), 0.3, seed).cpu(),
                           faults.fault_mask(w, 0.3, seed))
    words = w.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(faults._mix32(words.to(cuda_device)).cpu(), faults._mix32(words))


@pytest.mark.parametrize("op", ["sqrt", "rsqrt"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_kernel_route_under_faults(cuda_device, dtype, op):
    """``get_unit("e2afs", kernel=True, faults=)`` launches the kernel once
    and flips its output register: it equals ``flip_float_bits`` of the
    clean kernel output everywhere, and the plain faulted route (the flip
    inside the datapath) wherever the clean output is a normal number."""
    from repro_torch.core import faults, get_unit

    x = _fault_inputs(dtype).to(cuda_device)
    for site, rate, bit in _FAULT_CASES:
        cfg = faults.FaultConfig(site, rate, seed=5, bit=bit)
        dispatch.reset_launch_counts()
        y = getattr(get_unit("e2afs", kernel=True, faults=cfg), op)(x)
        assert dispatch.launch_counts()[f"e2afs_{op}"] == 1
        clean = getattr(get_unit("e2afs", kernel=True), op)(x)
        assert _same_bits(y, faults.flip_float_bits(clean, cfg))
        plain = getattr(get_unit("e2afs", faults=cfg), op)(x)
        normal = _normal(clean)
        assert _same_bits(y[normal], plain[normal]), (site, rate, bit)


_LADDER = ("e2afs", "esas", "exact")
_LEVELS = [0, 1, 2, 0, 1, 2, 0, 2]


def _decode_from(model, cfg, cache, tok, start, steps, levels=None, hook=None):
    """``decode_slots_scan`` from a copy of a prefilled cache; returns
    (tokens, every step's float32 logits (b, steps, vocab), the cache)."""
    cache = {k: v.clone() for k, v in cache.items()}
    b = tok.shape[0]
    dev = tok.device
    logits = []

    def record(lg):
        logits.append(lg.clone())
        return lg

    toks = lm.decode_slots_scan(
        model, cfg, cache, tok.clone(), torch.full((b,), start, dtype=torch.int32, device=dev),
        torch.ones(b, dtype=torch.bool, device=dev),
        torch.full((b,), steps, dtype=torch.int32, device=dev), steps,
        unit_levels=levels, logits_hook=record)[0]
    return toks, torch.stack(logits, 1), cache


def test_ladder_rows_are_independent(cuda_device):
    """Smoke width, bf16, 8 slots at rungs [0, 1, 2, 0, 1, 2, 0, 2] of
    ("e2afs", "esas", "exact"): every row's tokens, logits and cache are
    bit-identical to the same row of a run with all slots at its rung; the
    all-"exact" run is ``exact_twin``'s; rung 0 of every norm on the RMSNorm
    kernel (the clean e2afs route), the decode-attention kernel on every
    step."""
    cfg = get_smoke_config("qwen3-4b", sqrt_unit="e2afs", decode_kernel="fused",
                           sqrt_ladder=_LADDER)
    model = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    b, s, steps = len(_LEVELS), 12, 6
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    cache = lm.init_cache(cfg, b, s + steps, device=cuda_device)
    logits, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    levels = torch.tensor(_LEVELS, dtype=torch.int32, device=cuda_device)
    dispatch.reset_launch_counts()
    mixed = _decode_from(model, cfg, cache, tok, s, steps, levels)
    counts = {k: v for k, v in dispatch.launch_counts().items() if v}
    assert counts == {"rmsnorm": (4 * cfg.n_layers + 1) * steps,
                      "decode_attention": cfg.n_layers * steps}
    uniform = [_decode_from(model, cfg, cache, tok, s, steps, torch.full_like(levels, lv))
               for lv in range(len(_LADDER))]
    for i, lv in enumerate(_LEVELS):
        want = uniform[lv]
        assert torch.equal(mixed[0][i], want[0][i]), i
        assert _same_bits(mixed[1][i], want[1][i]), i
        for key in cache:
            assert _same_bits(mixed[2][key][:, i], want[2][key][:, i]), (i, key)
    twin = _decode_from(model, lm.exact_twin(cfg), cache, tok, s, steps)
    assert torch.equal(twin[0], uniform[2][0]) and _same_bits(twin[1], uniform[2][1])


def test_ladder_and_faulted_steps_capture_in_a_cuda_graph(cuda_device):
    """``decode_slots_step`` with ``unit_levels`` (a device tensor), sqrt
    faults and a NaN ``logits_hook`` reads nothing back to the host: two
    steps captured as one CUDA graph replay bit-identical to the same steps
    run eagerly from one pool state."""
    from repro_torch.core import faults

    cfg = get_smoke_config("qwen3-4b", sqrt_unit="e2afs", decode_kernel="fused",
                           sqrt_ladder=_LADDER,
                           sqrt_faults=faults.FaultConfig("sqrt_man", 0.05, seed=7))
    model = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    b, s = len(_LEVELS), 12
    pool = lm.init_pool_state(cfg, b, s + 8, device=cuda_device)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    logits, _ = lm.prefill_into_slots(model, cfg, pool["cache"], prompt,
                                      torch.arange(b, device=cuda_device))
    pool["tok"].copy_(logits[:, -1:].argmax(-1))
    pool["pos"].fill_(s)
    pool["active"].fill_(True)
    pool["remaining"].fill_(8)
    levels = torch.tensor(_LEVELS, dtype=torch.int32, device=cuda_device)
    hook = faults.logits_hook(faults.FaultConfig("logit_nan", 0.01, seed=3))
    toks = torch.zeros((b, 2), dtype=torch.int32, device=cuda_device)
    emitted = torch.zeros((b, 2), dtype=torch.bool, device=cuda_device)
    start = [t.clone() for t in lm.pool_tensors(pool)]

    def steps():
        for i in range(2):
            lm.decode_slots_step(model, cfg, pool, toks, emitted, i, unit_levels=levels,
                                 logits_hook=hook)

    def outcome(run):
        for t, s0 in zip(lm.pool_tensors(pool), start):
            t.copy_(s0)
        run()
        torch.cuda.synchronize()
        return [t.clone() for t in lm.pool_tensors(pool)] + [toks.clone(), emitted.clone()]

    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        eager = outcome(steps)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with dispatch.capture_launches(), torch.cuda.graph(graph):
        steps()
    replayed = outcome(graph.replay)
    assert _pool_bits_equal(replayed, eager)


# ---------------------------------------------------------------------------
# The engine's robustness layers on the card: health signals in the
# captured chunk, a restore in place, dispatch failures
# ---------------------------------------------------------------------------


def _poison_slot(eng, slot):
    """NaN in every cache line of one slot: its logits go NaN from the next
    step on, and its neighbours must not see it."""
    layers = eng.pool["cache"] if isinstance(eng.pool["cache"], list) else [eng.pool["cache"]]
    ax = 1 if isinstance(eng.pool["cache"], dict) else 0
    for layer in layers:
        for name, leaf in layer.items():
            if leaf.is_floating_point() and name in ("k", "v"):
                leaf.select(ax, slot).fill_(float("nan"))


@pytest.mark.parametrize("act_dtype", ["bfloat16", "float32"])
def test_graphed_chunk_with_health_equals_the_eager_chunk(cuda_device, act_dtype):
    """Detectors on, one of three slots poisoned with NaN: a replay of the
    captured chunk and the same chunk eagerly give bit-identical pool
    tensors and packed buffer, the health columns included; only the
    poisoned slot latches ``bad``, and the next replay from a clean pool
    latches nothing (the latches are zeroed inside the graph) and gives
    the neighbours the tokens they had beside the poisoned slot."""
    cfg, eng = _engine(cuda_device, "qwen3-4b", act_dtype, False)
    assert eng.detectors
    eng.warmup(prompt_lens={3, 5, 12})
    assert eng._graphs
    for slot, req in enumerate(_trace(cfg)[:3]):
        eng._admit(req, slot, 0.0)
    clean = [t.clone() for t in lm.pool_tensors(eng.pool)]
    _poison_slot(eng, 1)
    start = [t.clone() for t in lm.pool_tensors(eng.pool)]

    def chunk(run, state):
        for t, s0 in zip(lm.pool_tensors(eng.pool), state):
            t.copy_(s0)
        out = run()
        torch.cuda.synchronize()
        return [t.clone() for t in lm.pool_tensors(eng.pool)] + [eng._packed.clone()], out

    eager, _ = chunk(eng._chunk_eager, start)
    graphed, host = chunk(eng._decode_chunk, start)
    assert _pool_bits_equal(graphed, eager)
    bad, mx = host[3], host[4]
    assert bad.tolist() == [False, True, False] and np.isnan(mx[1])
    assert np.isfinite(mx[[0, 2]]).all() and (mx[[0, 2]] > 0).all()
    assert int(eng.pool["tok"][1, 0]) in range(cfg.vocab)  # the argmax of a NaN row
    _, again = chunk(eng._decode_chunk, clean)
    assert not again[3].any() and np.isfinite(again[4]).all()
    np.testing.assert_array_equal(again[0][[0, 2]], host[0][[0, 2]])


@pytest.mark.parametrize("arch,quantized", [("qwen3-4b", False), ("qwen3-4b", True),
                                            ("gemma3-1b", False)])
def test_restore_in_place_keeps_the_captured_graph(cuda_device, tmp_path, arch, quantized):
    """A snapshot of a live pool (bf16 or int8 cache, bool ``active``,
    uint32 ``keys``) restores bit for bit into another engine whose chunk
    was captured before, in place: the tensors keep their addresses, and a
    replay from the restored state equals the same chunk run eagerly."""
    cfg, eng = _engine(cuda_device, arch, "bfloat16", quantized)
    eng.warmup(prompt_lens={3, 5, 12})
    for slot, req in enumerate(_trace(cfg)[:3]):
        eng._admit(req, slot, 0.0)
    eng._decode_chunk()
    eng.snapshot(tmp_path, step=1)
    saved = [t.clone() for t in lm.pool_tensors(eng.pool)]

    _, other = _engine(cuda_device, arch, "bfloat16", quantized)
    other.warmup(prompt_lens={3, 5, 12})
    addresses = [t.data_ptr() for t in lm.pool_tensors(other.pool)]
    other._restore_snapshot(tmp_path, 1, Engine._read_snapshot_meta(tmp_path, 1))
    assert [t.data_ptr() for t in lm.pool_tensors(other.pool)] == addresses
    assert _pool_bits_equal(list(lm.pool_tensors(other.pool)), saved)
    restored = [t.clone() for t in lm.pool_tensors(other.pool)]

    def chunk(run):
        for t, s0 in zip(lm.pool_tensors(other.pool), restored):
            t.copy_(s0)
        run()
        torch.cuda.synchronize()
        return [t.clone() for t in lm.pool_tensors(other.pool)] + [other._packed.clone()]

    assert _pool_bits_equal(chunk(other._decode_chunk), chunk(other._chunk_eager))


def test_dispatch_exhaustion_leaves_the_pool_unchanged(cuda_device):
    """Dispatch faults at rate 0.4 are retried around admissions and
    replays; an outage (every dispatch failing) struck before a replay
    raises DispatchFault after the retry budget with every pool tensor as
    the last chunk left it; after ``reset()`` the same engine serves the
    trace with the clean engine's tokens."""
    from repro_torch.core.faults import DispatchFault, DispatchFaultInjector, FaultConfig

    cfg, clean = _engine(cuda_device, "qwen3-4b", "bfloat16", False)
    clean.warmup(prompt_lens={3, 5, 12})
    reqs = _trace(cfg)[:4]
    want = clean.run([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                      for r in reqs])
    _, eng = _engine(cuda_device, "qwen3-4b", "bfloat16", False,
                     faults=FaultConfig("dispatch", rate=0.4, seed=5), dispatch_backoff_s=1e-4)
    eng.warmup(prompt_lens={3, 5, 12})
    assert eng._graphs
    for slot, req in enumerate(reqs[:3]):
        eng._admit(req, slot, 0.0)
    eng._decode_chunk()
    torch.cuda.synchronize()
    before = [t.clone() for t in lm.pool_tensors(eng.pool)] + [eng._packed.clone()]
    schedule, eng._injector = eng._injector, DispatchFaultInjector(
        FaultConfig("dispatch", rate=1.0))
    eng.max_dispatch_retries = 2
    with pytest.raises(DispatchFault, match="max_dispatch_retries=2"):
        eng._decode_chunk()
    torch.cuda.synchronize()
    assert _pool_bits_equal(list(lm.pool_tensors(eng.pool)) + [eng._packed], before)
    eng._injector, eng.max_dispatch_retries = schedule, 3
    eng.reset()
    done = eng.run([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                    for r in reqs])
    for r in reqs:
        np.testing.assert_array_equal(done[r.uid].tokens, want[r.uid].tokens)
    assert eng.stats["dispatch_retries"] == eng.stats["dispatch_faults"] > 0


# ---------------------------------------------------------------------------
# The accuracy SLO on the card: level-0 rows on the fused route, canaries and
# rungs inside the captured chunk, one graph a firing pattern
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_level_0_rows_take_the_fused_route(cuda_device, dtype):
    """A clean e2afs ladder on CUDA tensors: a row at level 0 of
    ``rmsnorm_select`` is bit for bit the RMSNorm kernel's output (the route
    without levels, one launch), a row at level 1 the exact norm; and a
    smoke model's ``decode_slots_scan`` with every slot at level 0 gives the
    tokens, logits and cache of the same decode without levels."""
    from repro_torch.layers import norms

    cfg = get_smoke_config("qwen3-4b", act_dtype="bfloat16" if dtype == torch.bfloat16
                           else "float32", sqrt_unit="e2afs", decode_kernel="fused")
    lcfg = cfg.replace(sqrt_ladder=("e2afs", "exact"))
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((6, 3, 2560), generator=g, device=cuda_device).to(dtype)
    scale = (0.1 * torch.randn(2560, generator=g, device=cuda_device)).to(dtype)
    levels = torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.int32, device=cuda_device)
    dispatch.reset_launch_counts()
    got = norms.rmsnorm_cfg(scale, x, lcfg, levels=levels)
    assert dispatch.launch_counts()["rmsnorm"] == 1
    fused = norms.rmsnorm_cfg(scale, x, cfg)
    exact = norms.rmsnorm(scale, x, sqrt_unit="exact")
    for i, lv in enumerate(levels.tolist()):
        assert _same_bits(got[i], (fused if lv == 0 else exact)[i]), (i, lv)

    model = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    b, s, steps = 4, 12, 6
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    cache = lm.init_cache(cfg, b, s + steps, device=cuda_device)
    logits, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    plain = _decode_from(model, cfg, cache, tok, s, steps)
    zeros = _decode_from(model, lcfg, cache, tok, s, steps,
                         torch.zeros(b, dtype=torch.int32, device=cuda_device))
    assert torch.equal(plain[0], zeros[0]) and _same_bits(plain[1], zeros[1])
    assert all(_same_bits(plain[2][k], zeros[2][k]) for k in cache)


def _slo_engine(dev, stride, **kw):
    from repro_torch.launch.engine import AccuracySLO

    return _engine(dev, "qwen3-4b", "bfloat16", False, slo=AccuracySLO(
        canary_stride=stride, rel_err_budget=1e9, divergence_budget=None, promote_after=None),
        **kw)


def test_graphed_chunk_with_canaries_and_levels_equals_the_eager_chunk(cuda_device):
    """Canaries every 8 steps over chunks of 4 (two firing patterns, two
    graphs in one memory pool) and rungs [1, 0, 1]: from one pool state
    each pattern's replay and the same chunk run eagerly give bit-identical
    pool tensors and packed buffer, the canary columns included; the firing
    chunk counts its canaries and runs one more decode-attention launch a
    layer, the other none."""
    cfg, eng = _slo_engine(cuda_device, 8)
    eng.warmup(prompt_lens={3, 5, 12})
    assert sorted(eng._graphs) == [(), (0,)]
    for slot, level in enumerate((1, 0, 1)):
        eng._set_level(slot, level)
    eng._write_levels()
    for slot, req in enumerate(_trace(cfg)[:3]):
        eng._admit(req, slot, 0.0)
    start = [t.clone() for t in lm.pool_tensors(eng.pool)]

    def chunk(run):
        for t, s0 in zip(lm.pool_tensors(eng.pool), start):
            t.copy_(s0)
        dispatch.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        return ([t.clone() for t in lm.pool_tensors(eng.pool)] + [eng._packed.clone()],
                dispatch.launch_counts(), out)

    for k, fire in ((0, (0,)), (1, ())):
        eng._chunks_total = k
        eager, eager_counts, _ = chunk(eng._chunk_eager)
        graphed, graph_counts, host = chunk(eng._decode_chunk)
        assert _pool_bits_equal(graphed, eager), fire
        assert graph_counts == eager_counts
        assert graph_counts["decode_attention"] == cfg.n_layers * (eng.chunk + len(fire))
        assert graph_counts["rmsnorm"] == (4 * cfg.n_layers + 1) * eng.chunk
        checks = host[5]
        assert checks.tolist() == ([1, 1, 1] if fire else [0, 0, 0])
        if fire:  # the exact rung's rows equal the shadow; the e2afs row does not
            assert host[7][[0, 2]].tolist() == [0.0, 0.0] and host[7][1] > 0


@pytest.mark.parametrize("stride", [None, 2, 3, 8])
def test_one_graph_per_firing_pattern(cuda_device, stride):
    """``warmup`` captures one graph for each firing pattern of the lifetime
    clock (chunks of 4: stride None and 2 one each, 3 three, 8 two), and
    the engine replays the coming chunk's: a run of three requests serves
    the tokens of the SLO-free engine."""
    cfg, eng = _slo_engine(cuda_device, stride)
    eng.warmup(prompt_lens={3, 5, 12})
    want = {None: [()], 2: [(0, 2)], 3: [(0, 3), (1,), (2,)], 8: [(), (0,)]}[stride]
    assert sorted(eng._graphs) == want == eng._patterns()
    _, plain = _engine(cuda_device, "qwen3-4b", "bfloat16", False)
    plain.warmup(prompt_lens={3, 5, 12})
    reqs = _trace(cfg)[:3]
    fresh = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    done, want_done = eng.run(reqs), plain.run(fresh)
    for r in reqs:
        np.testing.assert_array_equal(done[r.uid].tokens, want_done[r.uid].tokens)
    assert len(eng._graphs) == len(want)


def test_slo_none_keeps_the_plain_chunk(cuda_device, monkeypatch):
    """Without ``slo=`` the chunk is the plain engine's: one graph, no rung
    tensor, no canary columns, one decode forward a step in the capture,
    and a replay's launches those of ``chunk`` plain steps."""
    cfg, eng = _engine(cuda_device, "qwen3-4b", "bfloat16", False)
    forwards = []
    step = lm.decode_step
    monkeypatch.setattr(lm, "decode_step", lambda *a, **k: forwards.append(1) or step(*a, **k))
    eng.warmup(prompt_lens={3})
    assert list(eng._graphs) == [()] and eng._levels is None and eng._canary is None
    assert eng._packed.shape[1] == 2 * eng.chunk + 3
    assert len(forwards) == 2 * eng.chunk  # the eager run on the side stream, the capture
    dispatch.reset_launch_counts()
    eng._decode_chunk()
    counts = {k: v for k, v in dispatch.launch_counts().items() if v}
    assert counts == {"rmsnorm": (4 * cfg.n_layers + 1) * eng.chunk,
                      "decode_attention": cfg.n_layers * eng.chunk}


# ---------------------------------------------------------------------------
# Speculative decoding on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,act_dtype,quantized", _ENGINE_CASES)
def test_verify_rows_equal_sequential_steps_on_the_card(cuda_device, arch, act_dtype, quantized):
    """A verify block of 4 rows on three slots (positions 5, 11, 12: past
    gemma3-1b's window of 8, so its rings wrap inside the block): row j's
    logits bit-identical to the sequential step at pos + j, through
    ``decode_attention`` (4 launches a layer, at the pool's 3 rows), the
    cache after an all-row commit the sequential loop's, and after a
    zero-row commit the pre-step cache, bit for bit."""
    cfg = get_smoke_config(arch, act_dtype=act_dtype, sqrt_unit="e2afs", decode_kernel="fused")
    _verify_rows_case(cuda_device, cfg, quantized)


@pytest.mark.parametrize("arch,heads", [("starcoder2-15b", (12, 1)), ("qwen3-4b", (12, 2)),
                                        ("gemma3-1b", (16, 1)), ("gemma3-1b", (10, 2))])
@pytest.mark.parametrize("act_dtype", ["bfloat16", "float32"])
def test_verify_rows_with_wide_groups(cuda_device, arch, heads, act_dtype):
    """The same as above with 12, 6, 16 and 5 query heads a KV head (the
    groups of starcoder2-15b, mixtral-8x22b, qwen3-moe-235b-a22b and a
    recurrentgemma-2b rank on a 2-wide 'model' axis, which the kernel runs
    padded to 6) on smoke models: starcoder2's LayerNorm stack, a global
    stack and gemma3-1b's wrapped rings."""
    h, kv = heads
    cfg = get_smoke_config(arch, act_dtype=act_dtype, sqrt_unit="e2afs", decode_kernel="fused",
                           n_heads=h, n_kv_heads=kv)
    _verify_rows_case(cuda_device, cfg, False)


def _verify_rows_case(cuda_device, cfg, quantized):
    model = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    b, sq, plens = 3, 4, (5, 11, 12)
    cache = lm.init_cache(cfg, b, 40, quantized=quantized, device=cuda_device)
    rng = np.random.default_rng(2)
    tok = torch.zeros((b, 1), dtype=torch.int32, device=cuda_device)
    for slot, s in enumerate(plens):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, s))).to(cuda_device)
        logits, _ = lm.prefill_into_slots(model, cfg, cache, prompt,
                                          torch.tensor([slot], device=cuda_device))
        tok[slot] = logits[0, -1].argmax().to(torch.int32)
    pos = torch.tensor(plens, dtype=torch.int32, device=cuda_device)
    before = [t.clone() for t in lm._cache_leaves(cache)]
    seq = lm.slot_rows_like(cfg, cache, b)
    for dst, src in zip(lm._cache_leaves(seq), before):
        dst.copy_(src)
    fed, seq_logits, t = [tok], [], tok
    for j in range(sq):
        lg, _ = lm.decode_step(model, cfg, seq, t, pos + j)
        seq_logits.append(lg[:, -1])
        t = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        fed.append(t)
    block = torch.cat(fed[:sq], dim=1)
    dispatch.reset_launch_counts()
    vlogits, old = lm.decode_verify_step(model, cfg, cache, block, pos)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["decode_attention"] == cfg.n_layers * sq
    for j in range(sq):
        assert _same_bits(vlogits[:, j], seq_logits[j]), j
    assert _pool_bits_equal(lm._cache_leaves(cache), lm._cache_leaves(seq))
    lm.commit_verify_cache(cfg, cache, old, pos, torch.zeros_like(pos))
    assert _pool_bits_equal(lm._cache_leaves(cache), before)


def _spec_engine(dev, arch, act_dtype, quantized, draft, **kw):
    """``_engine``'s pool with speculation at k = 3: n-gram drafting, or a
    draft model of the same config with other weights."""
    from repro_torch.launch.engine import SpecConfig

    if draft:
        cfg = get_smoke_config(arch, act_dtype=act_dtype, sqrt_unit="e2afs",
                               decode_kernel="fused")
        dmodel = lm.init(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
        kw["draft_model"] = (dmodel, cfg)
    return _engine(dev, arch, act_dtype, quantized,
                   spec=SpecConfig(k=3, draft="model" if draft else "ngram"), **kw)


_SPEC_CASES = [(arch, act_dtype, quantized, False) for arch, act_dtype, quantized in _ENGINE_CASES
               ] + [("qwen3-4b", "bfloat16", False, True), ("gemma3-1b", "bfloat16", False, True)]


@pytest.mark.parametrize("arch,act_dtype,quantized,draft", _SPEC_CASES)
def test_graphed_spec_chunk_equals_the_eager_chunk(cuda_device, arch, act_dtype, quantized,
                                                   draft):
    """From one pool state, a replay of the captured speculative chunk and
    the same chunk run eagerly give bit-identical pool tensors, history,
    draft cache and packed buffer (tokens and emission bits of chunk * 4
    columns, the accepted drafts and spec steps); the verify runs
    ``decode_attention`` k+1 times a layer a step, and with a draft model
    k + k+1 times a draft layer more."""
    cfg, eng = _spec_engine(cuda_device, arch, act_dtype, quantized, draft)
    eng.warmup(prompt_lens={3, 5, 12})
    assert list(eng._graphs) == [()]
    for slot, req in enumerate(_trace(cfg)[:3]):
        eng._admit(req, slot, 0.0)
    state = lm.pool_tensors(eng.pool) + eng._spec_tensors()
    start = [t.clone() for t in state]

    def chunk(run):
        for t, s0 in zip(state, start):
            t.copy_(s0)
        dispatch.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        return [t.clone() for t in state] + [eng._packed.clone()], dispatch.launch_counts()

    eager, eager_counts = chunk(eng._chunk_eager)
    graphed, graph_counts = chunk(eng._decode_chunk)
    assert _pool_bits_equal(graphed, eager)
    assert graph_counts == eager_counts
    per_step = cfg.n_layers * 4 + (cfg.n_layers * (3 + 4) if draft else 0)
    assert eager_counts["decode_attention"] == eng.chunk * per_step
    assert eng._packed.shape[1] == 2 * eng.chunk * 4 + 1 + 2 + 2
    assert int(eng._packed[:, -1].sum()) > 0  # spec steps ran


@pytest.mark.parametrize("arch,act_dtype,quantized,draft", _SPEC_CASES)
def test_spec_engine_equals_the_plain_engine_on_the_card(cuda_device, arch, act_dtype,
                                                         quantized, draft):
    """Five requests through three slots (staggered admissions, reused
    slots, rings past the window, a late arrival): the speculative engine
    serves the plain engine's tokens, and counts its steps and drafts."""
    cfg, eng = _spec_engine(cuda_device, arch, act_dtype, quantized, draft)
    _, plain = _engine(cuda_device, arch, act_dtype, quantized)
    lens = {3, 4, 5, 8, 12}
    eng.warmup(prompt_lens=lens)
    plain.warmup(prompt_lens=lens)
    done, want = eng.run(_trace(cfg)), plain.run(_trace(cfg))
    for uid, c in want.items():
        np.testing.assert_array_equal(done[uid].tokens, c.tokens)
    assert eng.stats["spec_steps"] > 0 and 0.0 <= eng.stats["acceptance_rate"] <= 1.0


# ---------------------------------------------------------------------------
# The LayerNorm and mixture-of-experts families on the card
# ---------------------------------------------------------------------------


def _moe_on(dev, arch, act_dtype="float32"):
    from repro_torch.layers import moe

    cfg = get_smoke_config(arch, act_dtype=act_dtype)
    module = moe.MoE(cfg, dtype=getattr(torch, act_dtype), device="cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    card = moe.MoE(cfg, dtype=getattr(torch, act_dtype), device=dev)
    card.load_state_dict(module.state_dict())
    return cfg, module, card


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_moe_apply_on_the_card_equals_the_cpu(cuda_device, arch, cf):
    """``moe_apply`` at float32 on the card against the CPU: identical
    routing (choices, positions, drops), y within 1e-5 plus 1e-6 relative
    and the aux loss within 1e-6; no host read (``torch.cuda``'s sync debug
    mode raises on one); a router tie goes to the lower expert on the card
    as on the CPU (a stable sort)."""
    from repro_torch.layers import moe

    cfg, cpu, card = _moe_on(cuda_device, arch)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(4))
    y, aux = moe.moe_apply(cpu, cfg, x, capacity_factor=cf)
    xc = x.to(cuda_device)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yc, auxc = moe.moe_apply(card, cfg, xc, capacity_factor=cf)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    cap = moe.capacity(cfg, 16, cf)
    for a, b in zip(moe.route(cpu.router, x, cfg.moe.top_k, cap)[2:],
                    moe.route(card.router, x.to(cuda_device), cfg.moe.top_k, cap)[2:]):
        assert torch.equal(a, b.cpu())
    torch.testing.assert_close(yc.cpu(), y, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(auxc.cpu(), aux, atol=1e-6, rtol=0)
    with torch.no_grad():  # experts 1 and 2 tied for first place on positive inputs
        for m in (cpu, card):
            m.router[:, 1] = m.router[:, 0].abs() + 0.5
            m.router[:, 2] = m.router[:, 1]
    xa = x.abs()
    want = moe.route(cpu.router, xa, cfg.moe.top_k, cap)[2]
    got = moe.route(card.router, xa.to(cuda_device), cfg.moe.top_k, cap)[2]
    assert bool((want[..., 0] == 1).all() & (want[..., 1] == 2).all())
    assert torch.equal(got.cpu(), want)


_FAMILY_CASES = [("starcoder2-15b", "bfloat16"), ("mixtral-8x22b", "bfloat16"),
                 ("qwen3-moe-235b-a22b", "bfloat16"), ("qwen3-moe-235b-a22b", "float32")]


@pytest.mark.parametrize("arch,act_dtype", _FAMILY_CASES)
def test_family_chunk_is_captured_and_replays_the_eager_chunk(cuda_device, arch, act_dtype):
    """The engine's decode chunk of a LayerNorm model (e2afs_rsqrt launches,
    no RMSNorm) and of MoE models (the routing inside the graph) captures,
    and a replay gives the eager chunk's pool tensors and packed buffer bit
    for bit, with the same launches."""
    cfg, eng = _engine(cuda_device, arch, act_dtype, False)
    eng.warmup(prompt_lens={3, 5, 12})
    assert list(eng._graphs) == [()]
    for slot, req in enumerate(_trace(cfg)[:3]):
        eng._admit(req, slot, 0.0)
    start = [t.clone() for t in lm.pool_tensors(eng.pool)]

    def chunk(run):
        for t, s0 in zip(lm.pool_tensors(eng.pool), start):
            t.copy_(s0)
        dispatch.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        return ([t.clone() for t in lm.pool_tensors(eng.pool)] + [eng._packed.clone()],
                dispatch.launch_counts())

    eager, eager_counts = chunk(eng._chunk_eager)
    graphed, graph_counts = chunk(eng._decode_chunk)
    assert _pool_bits_equal(graphed, eager)
    assert graph_counts == eager_counts
    norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if cfg.qk_norm else 0)
    assert eager_counts["decode_attention"] == eng.chunk * cfg.n_layers
    if cfg.norm == "layernorm":
        assert eager_counts["rmsnorm"] == 0 and eager_counts["e2afs_rsqrt"] == eng.chunk * norms
    else:
        assert eager_counts["rmsnorm"] == eng.chunk * norms


@pytest.mark.parametrize("arch", ["starcoder2-15b", "qwen3-moe-235b-a22b"])
def test_family_staggered_request_equals_the_request_alone(cuda_device, arch):
    """Five requests through three slots on the card: each one's tokens
    equal the same request alone in a pool of the same size (a MoE prompt
    routes as its own group, a decode step each row alone)."""
    cfg, eng = _engine(cuda_device, arch, "bfloat16", False)
    eng.warmup(prompt_lens={3, 4, 5, 8, 12})
    reqs = _trace(cfg)
    done = eng.run(reqs)
    assert eng.stats["n_ok"] == len(reqs)
    for r in reqs:
        eng.reset()
        alone = eng.run([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)])
        np.testing.assert_array_equal(done[r.uid].tokens, alone[r.uid].tokens)


# -- the recurrent families (recurrentgemma-2b's G = 10, the SSD and RG-LRU) --

@pytest.mark.parametrize("t", [2048, 2112])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_ten_heads_a_kv_head(cuda_device, dtype, quantized, t):
    """recurrentgemma-2b's window layer: 8 slots, one KV head of 10 query
    heads (G = 10: per-head shuffles, the warps' partial outputs through the
    ring in two passes), head_dim 256 (a float32 line of 64 vectors, two a
    lane), bf16 and float32 activations, float and int8 caches, the
    2048-line ring and 2112 lines, wrap off and on, mixed per-row positions.
    Two calls are bit-identical."""
    b, h, kv, hd = 8, 10, 1, 256
    q, k, v, pos, ks, vs = _attn_case(cuda_device, b, t, h, kv, hd, dtype, quantized, t + 10)
    for wrap in (False, True):
        plain = attn_ops.ref_decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        ours = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        again = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        assert torch.equal(ours, again), "two calls differ"
        _assert_attention_close(ours, plain, dtype)


def test_decode_attention_refuses_a_float32_line_of_ten_heads(cuda_device):
    """A float32 line longer than 256 (head_dim 260 of ten heads) is refused
    with an error naming head_dim, never served by the plain version."""
    q = torch.ones(1, 10, 260, device=cuda_device)
    k = torch.ones(1, 8, 1, 260, device=cuda_device)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        attn_ops.decode_attention(q, k, k, pos, scale=0.0625)


_RECURRENT = ("mamba2-2.7b", "recurrentgemma-2b")


def _recurrent_model(dev, arch, act_dtype="float32"):
    cfg = get_smoke_config(arch, act_dtype=act_dtype, sqrt_unit="e2afs", decode_kernel="fused")
    model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for _, p in lm.constant_start_parameters(model):
            p.add_(0.3 * torch.randn(p.shape, generator=gen).to(p.dtype))
    return cfg, model.to(dev)


def _cache_tensors(cache):
    return [t for layer in (cache if isinstance(cache, list) else [cache])
            for _, t in sorted(layer.items())]


@pytest.mark.parametrize("arch", _RECURRENT)
def test_recurrent_model_on_the_card_matches_the_cpu(cuda_device, arch):
    """Both recurrent families at smoke width in float32: prefill over 13
    tokens (past recurrentgemma's ring of 8) and 6 decode steps on the
    card, on the kernels (RMSNorm, e2afs_sqrt in each RG-LRU, decode
    attention in each window layer, each counted), against the CPU: logits
    and every state within 1e-4 of max(1, max |value|) (cuBLAS sums in
    another order), greedy tokens identical."""
    cfg, model = _recurrent_model(torch.device("cpu"), arch)
    gpu_model = _recurrent_model(cuda_device, arch)[1]
    prompt = torch.randint(0, cfg.vocab, (2, 13), generator=torch.Generator().manual_seed(2))
    out = {}
    for dev, m in (("cpu", model), ("cuda", gpu_model)):
        dispatch.reset_launch_counts()
        cache = lm.init_cache(cfg, 2, 19, device=dev)
        logits, cache = lm.prefill(m, cfg, cache, prompt.to(dev))
        toks, _, cache = lm.generate_scan(m, cfg, cache, logits[:, -1:].argmax(-1), 13, 6)
        out[dev] = (logits.cpu(), toks.cpu(), [t.cpu() for t in _cache_tensors(cache)],
                    dispatch.launch_counts())
    rglru_layers, windows = cfg.blocks.count("rglru"), cfg.blocks.count("window")
    norms = (2 if arch == "recurrentgemma-2b" else 1) * cfg.n_layers + 1
    counts = out["cuda"][3]
    assert counts["rmsnorm"] == 7 * norms
    assert counts["e2afs_sqrt"] == 7 * rglru_layers
    assert counts["decode_attention"] == 6 * windows
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0, atol=0)
    for a, b in zip([out["cuda"][0]] + out["cuda"][2], [out["cpu"][0]] + out["cpu"][2]):
        err = float((a.float() - b.float()).abs().max())
        assert err <= 1e-4 * max(1.0, float(b.float().abs().max())), err


@pytest.mark.parametrize("arch", _RECURRENT)
@pytest.mark.parametrize("act_dtype", ["bfloat16", "float32"])
def test_recurrent_chunk_is_captured_and_replays_the_eager_chunk(cuda_device, arch, act_dtype):
    """The engine's decode chunk of a recurrent model captures, and a replay
    gives the eager chunk's pool tensors (the states updated in place, never
    rebound) and packed buffer bit for bit, with the same launches."""
    cfg, model = _recurrent_model(cuda_device, arch, act_dtype)
    eng = Engine(model, cfg, num_slots=3, cache_len=40, chunk=4)
    eng.warmup(prompt_lens={3, 5, 12})
    assert list(eng._graphs) == [()]
    for slot, req in enumerate(_trace(cfg)[:3]):
        eng._admit(req, slot, 0.0)
    start = [t.clone() for t in lm.pool_tensors(eng.pool)]

    def chunk(run):
        for t, s0 in zip(lm.pool_tensors(eng.pool), start):
            t.copy_(s0)
        dispatch.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        return ([t.clone() for t in lm.pool_tensors(eng.pool)] + [eng._packed.clone()],
                dispatch.launch_counts())

    eager, eager_counts = chunk(eng._chunk_eager)
    graphed, graph_counts = chunk(eng._decode_chunk)
    assert _pool_bits_equal(graphed, eager)
    assert not _pool_bits_equal(eager[:len(start)], start), "the chunk moved no state"
    assert graph_counts == eager_counts
    assert eager_counts["e2afs_sqrt"] == eng.chunk * cfg.blocks.count("rglru")
    assert eager_counts["decode_attention"] == eng.chunk * cfg.blocks.count("window")


@pytest.mark.parametrize("arch", _RECURRENT)
def test_recurrent_canaries_on_the_card_leave_the_pool_untouched(cuda_device, arch):
    """Canaries at stride 1 with budgets that never trip, captured: every
    token and every pool tensor bit-identical to the engine without an SLO
    (the shadow's recurrent states are dropped, not written), the trace
    queued at once so that both engines fill the same slots."""
    from repro_torch.launch.engine import AccuracySLO

    cfg, model = _recurrent_model(cuda_device, arch, "bfloat16")
    quiet = AccuracySLO(canary_stride=1, rel_err_budget=1e9, divergence_budget=None,
                        promote_after=None)
    plain = Engine(model, cfg, num_slots=3, cache_len=40, chunk=4)
    canary = Engine(model, cfg, num_slots=3, cache_len=40, chunk=4, slo=quiet)

    def trace():  # every request queued at 0: the slots do not follow the host's clock
        return [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                for r in _trace(cfg)]

    want, got = plain.run(trace()), canary.run(trace())
    assert canary.stats["canary_checks"] > 0 and canary._graphs
    for uid, c in want.items():
        np.testing.assert_array_equal(got[uid].tokens, c.tokens)
    assert _pool_bits_equal(lm.pool_tensors(canary.pool), lm.pool_tensors(plain.pool))


@pytest.mark.parametrize("arch", _RECURRENT)
def test_recurrent_staggered_request_equals_the_request_alone(cuda_device, arch):
    """Five requests through three slots on the card (reused slots, a late
    arrival): each one's tokens equal the same request alone in a pool of
    the same size (admission overwrites a reused slot's whole state)."""
    cfg, model = _recurrent_model(cuda_device, arch, "bfloat16")
    eng = Engine(model, cfg, num_slots=3, cache_len=40, chunk=4)
    eng.warmup(prompt_lens={3, 4, 5, 8, 12})
    reqs = _trace(cfg)
    done = eng.run(reqs)
    assert eng.stats["n_ok"] == len(reqs)
    for r in reqs:
        eng.reset()
        alone = eng.run([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)])
        np.testing.assert_array_equal(done[r.uid].tokens, alone[r.uid].tokens)


def test_capture_holds_off_the_garbage_collector(cuda_device):
    """A chunk is captured with the collector off (a dead engine's graph it
    collected mid-capture would be destroyed on the capturing stream and
    fail the capture), and the collector is back on after."""
    import gc

    cfg, eng = _engine(cuda_device, "qwen3-4b", "bfloat16", False)
    dead = _engine(cuda_device, "qwen3-4b", "bfloat16", False)[1]
    dead.warmup(prompt_lens={3})
    dead.cycle = dead  # only the cyclic collector frees it, and its graph
    del dead
    seen = []
    chunk = eng._chunk_eager

    def recording(*args, **kw):
        seen.append(gc.isenabled())
        return chunk(*args, **kw)

    eng._chunk_eager = recording
    assert gc.isenabled()
    eng.warmup(prompt_lens={3})
    assert eng._graphs and seen[-1] is False and gc.isenabled()


# -- whisper-small: the encoder-decoder (G = 1 at head_dim 64, cross K/V) --

@pytest.mark.parametrize("t", [8, 192, 576])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_one_head_a_kv_head_of_64(cuda_device, quantized, t):
    """whisper-small's decoder self-attention: 8 slots, 12 KV heads of one
    query head each (G = 1), head_dim 64 (8 lanes a bf16 line), bf16,
    float and int8 caches, wrap off and on, mixed per-row positions, t up
    to its 192-line cache and past it.  Two calls are bit-identical."""
    b, h, kv, hd, dtype = 8, 12, 12, 64, torch.bfloat16
    q, k, v, pos, ks, vs = _attn_case(cuda_device, b, t, h, kv, hd, dtype, quantized, t + 1)
    for wrap in (False, True):
        plain = attn_ops.ref_decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        ours = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        again = attn_ops.decode_attention(q, k, v, pos, ks, vs, scale=hd**-0.5, wrap=wrap)
        assert torch.equal(ours, again), "two calls differ"
        _assert_attention_close(ours, plain, dtype)


def _whisper_model(dev, act_dtype="float32"):
    """whisper-small's smoke config on the kernels, every constant-start
    leaf (LayerNorm scales and biases, the GELU biases) moved off its start,
    with seeded audio (2, 8, 64) and a 6-token prompt."""
    cfg = get_smoke_config("whisper-small", act_dtype=act_dtype, sqrt_unit="e2afs",
                           decode_kernel="fused")
    model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for _, p in lm.constant_start_parameters(model):
            p.add_(0.3 * torch.randn(p.shape, generator=gen).to(p.dtype))
    g = torch.Generator().manual_seed(2)
    audio = torch.randn(2, cfg.encoder.n_ctx, cfg.d_model, generator=g)
    prompt = torch.randint(0, cfg.vocab, (2, 6), generator=g)
    return cfg, model.to(dev), audio.to(dev), prompt.to(dev)


@pytest.mark.parametrize("act_dtype", ["bfloat16", "float32"])
def test_whisper_kernel_route_equals_the_plain_route(cuda_device, act_dtype):
    """``precompute_cross``, ``prefill`` and 8 greedy steps with
    ``cross_kv`` at smoke width on the card: the kernel route (an
    e2afs_rsqrt a LayerNorm, decode attention at G = 1) against the plain
    versions: logits within 4 bf16 ulps of the largest |logit|, tokens
    identical; the kernel route's launches counted (5 encoder norms, 7 a
    decoder forward, 2 decode attention a step), the plain route's none."""
    cfg, model, audio, prompt = _whisper_model(cuda_device, act_dtype)
    out = {}
    for backend, route in (("auto", "fused"), ("reference", "reference")):
        prev = dispatch.set_backend(backend)
        try:
            c = cfg.replace(decode_kernel=route)
            dispatch.reset_launch_counts()
            ckv, _ = lm.precompute_cross(model, c, audio)
            cache = lm.init_cache(c, 2, 14, device=cuda_device)
            logits, cache = lm.prefill(model, c, cache, prompt, cross_kv=ckv,
                                       last_logit_only=True)
            toks, _, _ = lm.generate_scan(model, c, cache, logits.argmax(-1), 6, 8, cross_kv=ckv)
            out[backend] = (logits.float(), toks, dispatch.launch_counts())
        finally:
            dispatch.set_backend(prev)
    ref = out["reference"][0]
    _, e = torch.frexp(ref.abs().max())
    limit = 4 * 2.0 ** (int(e) - 1 - _MAN_BITS[torch.bfloat16])  # 4 bf16 ulps at max |logit|
    assert float((out["auto"][0] - ref).abs().max()) <= limit
    assert torch.equal(out["auto"][1], out["reference"][1])
    assert out["auto"][2]["e2afs_rsqrt"] == 5 + 7 * 9
    assert out["auto"][2]["decode_attention"] == 2 * 8
    assert set(out["reference"][2].values()) == {0}


@pytest.mark.parametrize("act_dtype", ["bfloat16", "float32"])
def test_cross_kv_slot_step_replays_the_eager_step(cuda_device, act_dtype):
    """``decode_slots_step(cross_kv=)`` over a pool whose cross K/V rows
    were written in place at admission (``prefill_into_slots(pool_cross_kv=)``),
    captured as a CUDA graph: from one pool state, a replay and the eager
    step give every pool tensor and the step's tokens bit for bit, with the
    same launches."""
    cfg, model, audio, prompt = _whisper_model(cuda_device, act_dtype)
    ckv, _ = lm.precompute_cross(model, cfg, audio)
    pool = lm.init_pool_state(cfg, 3, 16, device=cuda_device)
    pool_ckv = {k: torch.zeros((t.shape[0], 3) + t.shape[2:], dtype=t.dtype, device=cuda_device)
                for k, t in ckv.items()}
    slots = torch.tensor([2, 0], device=cuda_device)
    logits, _ = lm.prefill_into_slots(model, cfg, pool["cache"], prompt, slots, cross_kv=ckv,
                                      pool_cross_kv=pool_ckv)
    assert torch.equal(pool_ckv["ck"][:, 2], ckv["ck"][:, 0])
    pool["tok"][slots] = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    pool["pos"][slots] = 6
    pool["active"][slots] = True
    pool["remaining"][slots] = 5
    toks = torch.zeros((3, 1), dtype=torch.int32, device=cuda_device)
    emitted = torch.zeros((3, 1), dtype=torch.bool, device=cuda_device)
    state = lm.pool_tensors(pool) + [toks, emitted]
    start = [t.clone() for t in state]

    def step():
        lm.decode_slots_step(model, cfg, pool, toks, emitted, 0, cross_kv=pool_ckv)

    def outcome(run):
        for t, s0 in zip(state, start):
            t.copy_(s0)
        dispatch.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        return [t.clone() for t in state], dispatch.launch_counts()

    eager, eager_counts = outcome(step)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with dispatch.capture_launches() as launches, torch.cuda.graph(graph):
        step()

    def replay():
        graph.replay()
        dispatch.replay_launches(launches)

    graphed, graph_counts = outcome(replay)
    assert _pool_bits_equal(graphed, eager)
    assert not _pool_bits_equal(eager, start), "the step moved nothing"
    assert graph_counts == eager_counts
    assert eager_counts["decode_attention"] == cfg.n_layers


# ---------------------------------------------------------------------------
# Sharded serving on the card's one-device mesh (the host has one card:
# multi-rank collectives are held on 4 gloo ranks in tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_mesh():
    """A (data=1, model=1) mesh over a one-rank NCCL group that the mesh
    builder starts; the group is destroyed after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's mesh runs NCCL")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    started = not dist.is_initialized()
    mesh = make_production_mesh(shape=(1, 1))
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "tensor_parallel"])
def test_mesh_engine_equals_unsharded_on_the_card(card_mesh, exact):
    """An Engine on the one-device mesh, in exact mode and under the default
    tensor-parallel rules (a one-wide 'model' axis splits no sum): a replay
    of its captured chunk bit-identical to the eager chunk, the trace's
    tokens and launches identical to the unsharded engine's, and the pool's
    DTensors still on their placements."""
    from repro_torch.distributed import sharding

    dev = torch.device("cuda")
    cfg, plain = _engine(dev, "qwen3-4b", "bfloat16", False)
    plain.warmup(prompt_lens={3, 4, 5, 8, 12})
    reqs = _trace(cfg)
    dispatch.reset_launch_counts()
    ref = plain.run(reqs)
    ref_counts = dispatch.launch_counts()
    rules = sharding.serve_rules(cfg, card_mesh, replicate_params=exact)
    eng = Engine(plain.model, cfg, num_slots=3, cache_len=40, chunk=4, mesh=card_mesh,
                 rules=rules)
    del plain
    eng.warmup(prompt_lens={3, 4, 5, 8, 12})
    assert list(eng._graphs) == [()]
    for slot, req in enumerate(reqs[:3]):
        eng._admit(req, slot, 0.0)
    start = [t.clone() for t in lm.pool_tensors(eng.pool)]

    def chunk(run):
        for t, s0 in zip(lm.pool_tensors(eng.pool), start):
            t.copy_(s0)
        run()
        torch.cuda.synchronize()
        return [t.clone() for t in lm.pool_tensors(eng.pool)] + [eng._packed.clone()]

    assert _pool_bits_equal(chunk(eng._decode_chunk), chunk(eng._chunk_eager))
    eng.reset()
    dispatch.reset_launch_counts()
    done = eng.run(reqs)
    assert dispatch.launch_counts() == ref_counts
    for r in reqs:
        np.testing.assert_array_equal(done[r.uid].tokens, ref[r.uid].tokens)
    want = sharding.serve_pool_tree(eng._pool_sh)
    for dt, sh, t in zip(lm.pool_tensors(eng._dpool), lm.pool_tensors(want),
                         lm.pool_tensors(eng.pool)):
        assert dt.placements == sh.placements and dt.to_local().data_ptr() == t.data_ptr()
        assert dt.device.type == "cuda"


def test_restore_onto_the_card_mesh(card_mesh, tmp_path):
    """``checkpoint.restore(shardings=)``: a pool written from plain tensors
    restores onto the card's mesh as DTensors on the card, with the
    placements of ``serve_pool_shardings`` and the same bits; saved again
    from the DTensors, it restores bit-identical without shardings."""
    from repro_torch import checkpoint
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import Sharding

    cfg = get_smoke_config("qwen3-4b", sqrt_unit="e2afs")
    pool = lm.init_pool_state(cfg, 4, 16, quantized=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for t in lm.pool_tensors(pool):
        t.copy_(torch.randint(0, 100, t.shape, generator=gen).to(t.dtype))
    checkpoint.save(tmp_path, 1, {"pool": pool})
    sh = sharding.serve_pool_tree(sharding.serve_pool_shardings(
        cfg, card_mesh, sharding.serve_rules(cfg, card_mesh), num_slots=4, cache_len=16,
        quantized=True))
    like = lm.init_pool_state(cfg, 4, 16, quantized=True, abstract=True)
    out = checkpoint.restore(tmp_path, 1, {"pool": like}, shardings={"pool": sh})["pool"]
    for got, s, want in zip(lm.pool_tensors(out), lm.pool_tensors(sh), lm.pool_tensors(pool)):
        assert isinstance(s, Sharding) and got.placements == s.placements
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.to_local().cpu(), want)
    checkpoint.save(tmp_path, 2, {"pool": out})
    back = checkpoint.restore(tmp_path, 2, {"pool": pool})["pool"]
    for got, want in zip(lm.pool_tensors(back), lm.pool_tensors(pool)):
        assert torch.equal(got, want)


def _served(done, eng):
    return ({uid: (c.tokens.tolist(), c.status, c.trips, c.unit_final, repr(c.unit_trips))
             for uid, c in done.items()},
            {k: eng.stats[k] for k in ("faults_detected", "exact_fallbacks", "canary_checks",
                                       "canary_divergences", "demotions", "promotions")})


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "tensor_parallel"])
def test_mesh_faulted_engine_equals_unsharded_on_the_card(card_mesh, exact):
    """Phase 19f at smoke width: sqrt mantissa flips in every norm (the
    unfused datapath, each element hashed at its global index) on the
    one-device mesh give the unsharded faulted engine's tokens, statuses
    and counters, exact or tensor parallel."""
    from repro_torch.core.faults import FaultConfig
    from repro_torch.distributed import sharding

    dev = torch.device("cuda")
    faults = FaultConfig("sqrt_man", 0.05, seed=7)
    cfg, plain = _engine(dev, "qwen3-4b", "bfloat16", False, faults=faults)
    reqs = _trace(cfg)
    ref = _served(plain.run(reqs), plain)
    eng = Engine(plain.model, cfg, num_slots=3, cache_len=40, chunk=4, faults=faults,
                 mesh=card_mesh, rules=sharding.serve_rules(cfg, card_mesh,
                                                            replicate_params=exact))
    del plain
    eng.warmup(prompt_lens={3, 4, 5, 8, 12})
    assert _served(eng.run(reqs), eng) == ref


def test_mesh_slo_engine_equals_unsharded_on_the_card(card_mesh):
    """Phase 19g at smoke width: the accuracy SLO under a pinned high-bit
    sqrt schedule (canaries every other step demote the struck slots) on
    the one-device mesh in exact mode: the unsharded SLO engine's tokens,
    rung trails and counters, and its rungs after the run."""
    from repro_torch.core.faults import FaultConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch.engine import AccuracySLO

    dev = torch.device("cuda")
    kw = dict(faults=FaultConfig("sqrt_man", 1.0, seed=7, bit=21),
              slo=AccuracySLO(canary_stride=2, rel_err_budget=0.05, divergence_budget=0,
                              promote_after=2))
    cfg, plain = _engine(dev, "qwen3-4b", "bfloat16", False, **kw)
    reqs = _trace(cfg)
    ref = _served(plain.run(reqs), plain)
    assert ref[1]["canary_checks"] and ref[1]["demotions"]
    eng = Engine(plain.model, cfg, num_slots=3, cache_len=40, chunk=4, mesh=card_mesh,
                 rules=sharding.serve_rules(cfg, card_mesh, replicate_params=True), **kw)
    levels = plain.unit_levels
    del plain
    assert _served(eng.run(reqs), eng) == ref and eng.unit_levels == levels


@pytest.mark.parametrize("arch", ["starcoder2-15b", "mixtral-8x22b", "qwen3-moe-235b-a22b",
                                  "mamba2-2.7b", "recurrentgemma-2b", "whisper-small"])
def test_mesh_family_equals_unsharded_on_the_card(card_mesh, arch):
    """Phase 19h at smoke width: each family on the kernels (constant starts
    moved), ``precompute_cross``/``prefill``/``generate_scan`` with
    ``mesh=`` under the default tensor-parallel rules: the unsharded run's
    logits and tokens, bit for bit."""
    from repro_torch.distributed import sharding

    dev = torch.device("cuda")
    cfg = get_smoke_config(arch, sqrt_unit="e2afs", decode_kernel="fused")
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for _, p in lm.constant_start_parameters(model):
            p.add_((0.3 * torch.randn(p.shape, generator=gen, device=dev)).to(p.dtype))
    b, s, n = 3, 12, 8
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    audio = (torch.randn(b, cfg.encoder.n_ctx, cfg.d_model, generator=gen, device=dev)
             if cfg.kind == "encdec" else None)
    rules = sharding.serve_rules(cfg, card_mesh)
    out = []
    for m, mesh in ((model, None), (sharding.place_model(model, cfg, card_mesh, rules),
                                    card_mesh)):
        ckv = None if audio is None else lm.precompute_cross(m, cfg, audio, mesh=mesh)[0]
        cache = lm.init_cache(cfg, b, s + n, device=dev)
        logits, cache = lm.prefill(m, cfg, cache, prompt, cross_kv=ckv, mesh=mesh)
        toks, _, _ = lm.generate_scan(m, cfg, cache, logits[:, -1:].argmax(-1), s, n,
                                      cross_kv=ckv, mesh=mesh)
        out.append((logits, toks))
    assert _same_bits(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# The sharded train step (train_rules) on the card's one-device mesh: the
# unsharded step's bits and launches (multi-rank training is held on 4 gloo
# ranks in tests/test_torch_mesh_train.py)
# ---------------------------------------------------------------------------

TRAIN_MESH_ARCHS = ("qwen3-4b", "gemma3-1b", "starcoder2-15b", "deepseek-67b", "internvl2-76b",
                    "mixtral-8x22b", "qwen3-moe-235b-a22b", "mamba2-2.7b", "recurrentgemma-2b",
                    "whisper-small")


def _train_mesh_runs(mesh, arch, microbatches=1, steps=2):
    """``steps`` train steps of the smoke model (bf16 activations, e2afs,
    fused AdamW, constant starts moved) on the kernels, unsharded and under
    ``train_rules`` on ``mesh``: per run (losses, grad norms, params, m, v,
    launches)."""
    from repro_torch.configs.shapes import ShapeCase, input_specs
    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    cfg = get_smoke_config(arch, sqrt_unit="e2afs")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, fused=True, sqrt_unit="e2afs")
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = {}
    for name, spec in input_specs(cfg, ShapeCase("train", 16, 4, "train")).items():
        shape = tuple(spec.shape)
        batch[name] = (torch.randint(0, cfg.vocab, shape, generator=gen, device=dev,
                                     dtype=torch.int32) if name in ("tokens", "labels") else
                       torch.ones(shape, device=dev) if name == "loss_mask" else
                       torch.randn(shape, generator=gen, device=dev).to(spec.dtype))
    runs = []
    for m in (None, mesh):
        model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                        trainable=True)
        g = torch.Generator(device=dev).manual_seed(1)
        with torch.no_grad():
            for _, p in lm.constant_start_parameters(model):
                p.add_(0.1 * torch.randn(p.shape, generator=g, device=dev))
        if m is None:
            opt = adamw_init(model)
        else:
            model, opt = sharding.place_train_state(model, cfg, m, sharding.train_rules(cfg, m))
        step = make_train_step(cfg, opt_cfg, microbatches=microbatches, mesh=m)
        dispatch.reset_launch_counts()
        metrics = [step(model, opt, batch)[2] for _ in range(steps)]
        torch.cuda.synchronize()
        runs.append(([x["loss"] for x in metrics], [x["grad_norm"] for x in metrics],
                     {n: p.detach() for n, p in model.named_parameters()}, opt["m"], opt["v"],
                     dispatch.launch_counts()))
    return runs


def _train_runs_equal(a, b):
    same = lambda x, y: torch.equal(x.view(torch.int32), y.view(torch.int32))  # noqa: E731
    return (all(same(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))
            and all(same(a[i][n], b[i][n]) for i in (2, 3, 4) for n in a[i]))


@pytest.mark.parametrize("arch", TRAIN_MESH_ARCHS)
def test_train_mesh_step_equals_unsharded_on_the_card(card_mesh, arch):
    """Two train steps under ``train_rules`` on the one-device mesh: every
    collective skipped, so the losses, grad norms and every leaf of params,
    m and v equal the unsharded steps' bit for bit, with the same launches
    (adam once a leaf a step: the kernel route, no plain fallback)."""
    plain, sharded = _train_mesh_runs(card_mesh, arch)
    assert _train_runs_equal(plain, sharded)
    assert sharded[5] == plain[5] and sharded[5]["adam"] == 2 * len(plain[2])
    assert sharded[5]["e2afs_rsqrt"] > 0


def test_train_mesh_microbatches_equal_unsharded_on_the_card(card_mesh):
    plain, sharded = _train_mesh_runs(card_mesh, "qwen3-4b", microbatches=2)
    assert _train_runs_equal(plain, sharded) and sharded[5] == plain[5]


# ---------------------------------------------------------------------------
# tiles: every candidate of a tiled kernel gives the default's bits; a sweep
# persists its winner and the next call is a cache hit that launches it
# ---------------------------------------------------------------------------


def _tile_inputs(name, dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(7)
    if name.startswith("e2afs"):
        x = (torch.rand(shape, generator=g, device=dev) * 1e4 - 10).to(dtype)
        flat = x.view(-1)
        flat[:5] = torch.tensor([0.0, -0.0, -1.0, float("inf"), float("nan")]).to(dtype)
        return (x,)
    if name == "rmsnorm":
        x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
        return (x, (torch.randn(shape[-1:], generator=g, device=dev) * 0.1).to(dtype))
    if name == "sobel":
        return (torch.rand(shape, generator=g, device=dev) * 255,)
    p, gr, m = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    v = torch.rand(shape, generator=g, device=dev) * 1e-2
    return (p.to(dtype), gr.to(dtype), m * 0.1, v, torch.tensor([1e-3, 0.5, 0.25], device=dev))


_TILED = {"e2afs_sqrt": lambda *a, **k: e2afs_ops._sqrt(*a, **k),
          "e2afs_rsqrt": lambda *a, **k: e2afs_ops._rsqrt(*a, **k),
          "rmsnorm": rms_ops.rmsnorm, "sobel": sobel_ops.sobel_magnitude}


def _tiled_call(name, args, **kw):
    if name == "adam":  # in place: on copies, returning p, m and v
        p, g, m, v, sched = args
        return adam_ops.adam_update(p.clone(), g, m.clone(), v.clone(), sched, **kw)
    return (_TILED[name](*args, **kw),)


def _bit_views(ts):
    return [t.contiguous().view(_INT[t.dtype]) for t in ts]


@pytest.mark.parametrize("name,shape,dtype", [
    ("e2afs_sqrt", (1000003,), torch.float32), ("e2afs_sqrt", (3, 7, 4099), torch.bfloat16),
    ("e2afs_rsqrt", (1000003,), torch.float16), ("e2afs_rsqrt", (8, 512, 2560), torch.float32),
    ("rmsnorm", (8, 2560), torch.bfloat16), ("rmsnorm", (256, 128), torch.bfloat16),
    ("rmsnorm", (9000, 128), torch.float32), ("rmsnorm", (65536, 256), torch.bfloat16),
    ("rmsnorm", (37, 100), torch.float32), ("rmsnorm", (5, 9000), torch.bfloat16),
    ("sobel", (67, 93), torch.float32), ("sobel", (2160, 3840), torch.float32),
    ("sobel", (3, 3), torch.float32), ("sobel", (1001, 7), torch.float32),
    ("adam", (100003,), torch.float32), ("adam", (2560, 9728), torch.float32),
    ("adam", (1000,), torch.bfloat16)])
def test_every_tile_gives_the_default_s_bits(cuda_device, name, shape, dtype):
    spec = dispatch.get(name).tiling
    args = _tile_inputs(name, cuda_device, shape, dtype)
    want = _bit_views(_tiled_call(name, args, block=spec.default))
    for cand in spec.candidates:
        got = _bit_views(_tiled_call(name, args, block=cand))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), cand
        assert dispatch.last_blocks()[name] == tuple(cand)


def test_e2afs_tiles_on_unaligned_views(cuda_device):
    base = torch.rand(70001, device=cuda_device) + 0.01
    for k in (1, 3):
        x = base[k:]
        want = e2afs_ops._sqrt(x, block=(256, 4))
        for cand in dispatch.get("e2afs_sqrt").tiling.candidates:
            assert torch.equal(e2afs_ops._sqrt(x, block=cand).view(torch.int32),
                               want.view(torch.int32))


def test_kernels_refuse_a_tile_they_do_not_take(cuda_device):
    x = torch.rand(64, 256, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        e2afs_ops._sqrt(x, block=(64, 3))
    with pytest.raises(RuntimeError, match="CUDA error"):
        rms_ops.rmsnorm(x, torch.zeros(256, device=cuda_device), block=(3,))
    with pytest.raises(ValueError, match="only the tile"):
        kmeans_ops.kmeans_assign(torch.rand(10, 3, device=cuda_device),
                                 torch.rand(2, 3, device=cuda_device), block=(512,))


@pytest.mark.parametrize("name,shape,dtype", [("e2afs_sqrt", (8, 512, 2560), torch.float32),
                                              ("rmsnorm", (131072, 128), torch.bfloat16),
                                              ("adam", (2560, 9728), torch.float32)])
def test_sweep_persists_its_winner_and_the_next_call_hits(cuda_device, tmp_path, monkeypatch,
                                                          name, shape, dtype):
    from repro_torch.kernels import tuning

    monkeypatch.setenv(tuning.ENV_CACHE, str(tmp_path / "tune.json"))
    monkeypatch.delenv(tuning.ENV_AUTOTUNE, raising=False)
    dispatch.forget_choices()
    try:
        args = _tile_inputs(name, cuda_device, shape, dtype)
        before = [t.clone() for t in args]
        want = _bit_views(_tiled_call(name, args, block=dispatch.get(name).tiling.default))
        got = _bit_views(_tiled_call(name, args, tune=True))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in  # a sweep leaves the args as they were
                   zip(_bit_views(args[:4]), _bit_views(before[:4])))
        entries = json.loads((tmp_path / "tune.json").read_text())["entries"]
        (key, entry), = entries.items()
        assert key == tuning.problem_key(name, args)
        winner = tuple(entry["block"])
        assert winner in dispatch.get(name).tiling.candidates and entry["timings_us"]
        dispatch.forget_choices()
        tuning._mem.clear()

        def boom(*a, **k):
            raise AssertionError("a sweep ran on a cache hit")

        monkeypatch.setattr(tuning, "sweep", boom)
        _tiled_call(name, args)
        assert dispatch.last_blocks()[name] == winner
    finally:
        dispatch.forget_choices()
