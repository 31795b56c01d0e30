"""The torch port's dense decoder held against the JAX package.

The reference initialises ``get_smoke_config("qwen3-4b", ...)`` (and
gemma3-1b's and deepseek-67b's, below) with
``lm.init(cfg, jax.random.key(0))``; its parameters cross over as numpy
arrays through ``repro_torch.models.convert.params_from_numpy``.  JAX runs
its own routes (the Pallas decode-attention kernel in interpret mode for
``decode_kernel="fused"``); the port runs its plain versions on the CPU.

Tolerances: float32 logits atol 1e-4 and caches atol 1e-5 (sums in another
order); int8 cache codes and greedy tokens identical at float32.  bfloat16
logits atol 5e-2: the two frameworks round bf16 intermediates at different
places.  gemma3-1b's int8 prefill: see
``test_mixed_prefill_logits_and_per_layer_caches`` (one code on a rounding
boundary).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import faults as jax_faults
from repro.layers import attention as jax_attn
from repro.models import lm as jax_lm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import faults
from repro_torch.kernels import dispatch
from repro_torch.launch import serve
from repro_torch.layers import attention as attn
from repro_torch.models import convert, lm

B, S, GEN = 2, 8, 16

# the reference's entry points, jitted (the config and lengths static): run
# eagerly, each call compiles its layer scan anew; jitted, each config and
# shape compiles once for the whole file, shared by the tests that repeat it
_jprefill = jax.jit(jax_lm.prefill, static_argnums=1, static_argnames="last_logit_only")
_jdecode = jax.jit(jax_lm.decode_step, static_argnums=1)
_jgenerate = jax.jit(jax_lm.generate_scan, static_argnums=(1, 5))


def _configs(**kw):
    return jax_smoke_config("qwen3-4b", **kw), get_smoke_config("qwen3-4b", **kw)


@pytest.fixture(scope="module")
def jax_params():
    cache = {}

    def get(act_dtype):
        if act_dtype not in cache:
            jcfg, _ = _configs(act_dtype=act_dtype, sqrt_unit="e2afs")
            params, _ = jax_lm.init(jcfg, jax.random.key(0))
            cache[act_dtype] = (params, jax.tree.map(np.asarray, params))
        return cache[act_dtype]

    return get


def _prompt(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x).astype(np.float32))


def _both(jax_params, act_dtype="float32", quantized=False, decode_kernel=None):
    jcfg, tcfg = _configs(act_dtype=act_dtype, sqrt_unit="e2afs", decode_kernel=decode_kernel)
    params, tree = jax_params(act_dtype)
    model = convert.params_from_numpy(tcfg, tree, device="cpu")
    prompt = _prompt(jcfg.vocab)
    jcache, _ = jax_lm.init_cache(jcfg, B, S + GEN, quantized=quantized)
    tcache = lm.init_cache(tcfg, B, S + GEN, quantized=quantized, device="cpu")
    return jcfg, tcfg, params, model, prompt, jcache, tcache


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_logits_and_cache(jax_params, quantized):
    jcfg, tcfg, params, model, prompt, jcache, tcache = _both(jax_params, quantized=quantized)
    jlog, jcache = _jprefill(params, jcfg, jcache, jnp.asarray(prompt))
    tlog, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt))
    assert tuple(tlog.shape) == (B, S, jcfg.vocab)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=0)
    for key in jcache:
        atol = 0 if key in ("k", "v") and quantized else 1e-5
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), atol=atol, rtol=0)
    last, _ = lm.prefill(model, tcfg,
                         lm.init_cache(tcfg, B, S + GEN, quantized=quantized, device="cpu"),
                         torch.from_numpy(prompt), last_logit_only=True)
    assert tuple(last.shape) == (B, 1, jcfg.vocab)
    np.testing.assert_allclose(_np(last), _np(tlog[:, -1:]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_logits_and_cache(jax_params, quantized, per_row):
    jcfg, tcfg, params, model, prompt, jcache, tcache = _both(jax_params, quantized=quantized)
    jlog, jcache = _jprefill(params, jcfg, jcache, jnp.asarray(prompt))
    _, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt))
    tok = np.asarray(jnp.argmax(jlog[:, -1:], axis=-1)).astype(np.int32)
    pos = np.array([S, S - 3], np.int32) if per_row else S
    jl, jcache = _jdecode(params, jcfg, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl, tcache = lm.decode_step(model, tcfg, tcache, torch.from_numpy(tok),
                                torch.from_numpy(pos) if per_row else pos)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
    for key in jcache:
        atol = 0 if key in ("k", "v") and quantized else 1e-5
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), atol=atol, rtol=0)


@pytest.mark.parametrize("decode_kernel", [None, "fused"])
@pytest.mark.parametrize("quantized", [False, True])
def test_generate_scan_tokens_identical(jax_params, quantized, decode_kernel):
    jcfg, tcfg, params, model, prompt, jcache, tcache = _both(
        jax_params, quantized=quantized, decode_kernel=decode_kernel)
    jlog, jcache = _jprefill(params, jcfg, jcache, jnp.asarray(prompt), last_logit_only=True)
    tlog, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt), last_logit_only=True)
    jt, jnext, _ = _jgenerate(params, jcfg, jcache, jnp.argmax(jlog, axis=-1), S, GEN)
    tt, tnext, _ = lm.generate_scan(model, tcfg, tcache, tlog.argmax(dim=-1), S, GEN)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))


def test_bfloat16_within_tolerance(jax_params):
    jcfg, tcfg, params, model, prompt, jcache, tcache = _both(
        jax_params, act_dtype="bfloat16", decode_kernel="fused")
    jlog, jcache = _jprefill(params, jcfg, jcache, jnp.asarray(prompt), last_logit_only=True)
    tlog, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt), last_logit_only=True)
    assert tlog.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=5e-2, rtol=0)
    tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    jl, _ = _jdecode(params, jcfg, jcache, jnp.asarray(tok), S)
    tl, _ = lm.decode_step(model, tcfg, tcache, torch.from_numpy(tok), S)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=5e-2, rtol=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_window_model_cache_is_the_window(jax_params, quantized):
    """A uniform sliding-window model (window 6) with a prompt of 8 and a
    24-line cache: both packages give every layer a ring of
    min(cache_len, window) = 6 lines, so decode attends to the last 6
    tokens only.  float32 logits atol 1e-4 (sums in another order); greedy
    tokens identical over 16 steps."""
    kw = dict(act_dtype="float32", sqrt_unit="e2afs", block_pattern=("window",), window=6)
    jcfg, tcfg = _configs(**kw)
    params, tree = jax_params("float32")
    model = convert.params_from_numpy(tcfg, tree, device="cpu")
    prompt = _prompt(jcfg.vocab)
    cache_len = 24
    jcache, _ = jax_lm.init_cache(jcfg, B, cache_len, quantized=quantized)
    tcache = lm.init_cache(tcfg, B, cache_len, quantized=quantized, device="cpu")
    assert tcache["k"].shape[2] == jcache["k"].shape[2] == tcfg.window
    jlog, jcache = _jprefill(params, jcfg, jcache, jnp.asarray(prompt), last_logit_only=True)
    tlog, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt), last_logit_only=True)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=0)
    tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    jl, _ = _jdecode(params, jcfg, jcache, jnp.asarray(tok), S)
    tl, _ = lm.decode_step(model, tcfg, {k: v.clone() for k, v in tcache.items()},
                           torch.from_numpy(tok), S)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
    jt, jnext, _ = _jgenerate(params, jcfg, jcache, jnp.asarray(tok), S, GEN)
    tt, tnext, _ = lm.generate_scan(model, tcfg, tcache, torch.from_numpy(tok), S, GEN)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))


# ---------------------------------------------------------------------------
# attention layer routes against the reference layer
# ---------------------------------------------------------------------------


def _layer(seed=1):
    jcfg, tcfg = _configs(act_dtype="float32", sqrt_unit="e2afs")
    rng = np.random.default_rng(seed)
    d, h, kv, hd = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.d_head
    p = {"wq": rng.standard_normal((d, h, hd)) * 0.2, "wk": rng.standard_normal((d, kv, hd)) * 0.2,
         "wv": rng.standard_normal((d, kv, hd)) * 0.2, "wo": rng.standard_normal((h, hd, d)) * 0.1,
         "q_norm": rng.standard_normal(hd) * 0.1, "k_norm": rng.standard_normal(hd) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    module = attn.Attention(tcfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, value in p.items():
            getattr(module, name).copy_(torch.from_numpy(value))
    x = rng.standard_normal((3, 1, d)).astype(np.float32)
    return jcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()}, module, x


@pytest.mark.parametrize("route", [None, "fused", "reference"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("pos", [[2, 5, 20], 4])
def test_attention_decode_routes_match_reference(route, quantized, pos):
    """Per-row and scalar positions, a ring window of 12 (row 3 has wrapped),
    float and int8 caches; out and the written cache against the JAX layer."""
    jcfg, tcfg, jp, module, x = _layer()
    rng = np.random.default_rng(7)
    jcache = jax_attn.init_kv_cache(jcfg, 3, 12, jnp.float32, quantized=quantized)
    # a cache that already holds lines, so the mask and the ring write matter
    fill = {k: (rng.integers(-100, 100, v.shape).astype(np.int8) if v.dtype == jnp.int8 else
                rng.uniform(0.001, 0.01, v.shape).astype(np.float32) if "scale" in k else
                rng.standard_normal(v.shape).astype(np.float32)) for k, v in jcache.items()}
    jcache = {k: jnp.asarray(v) for k, v in fill.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in fill.items()}
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos
    jout, jc = jax_attn.attention_decode(jp, jcfg, jnp.asarray(x), jcache, jpos, window=12,
                                         kernel=route)
    tout, tc = attn.attention_decode(module, tcfg, torch.from_numpy(x), tcache, tpos, window=12,
                                     kernel=route)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    for key in jc:
        atol = 0 if jc[key].dtype == jnp.int8 else 1e-5
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), atol=atol, rtol=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_attention_prefill_chunked_matches_reference(quantized):
    """q_chunk=4 over 8 tokens takes the chunked path on both sides."""
    jcfg, tcfg, jp, module, _ = _layer(2)
    x = np.random.default_rng(3).standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    positions = np.arange(8)
    jcache = jax_attn.init_kv_cache(jcfg, 2, 10, jnp.float32, quantized=quantized)
    tcache = attn.init_kv_cache(tcfg, 2, 10, torch.float32, quantized=quantized)
    jout, jc = jax_attn.attention_prefill(jp, jcfg, jnp.asarray(x), jcache, jnp.asarray(positions),
                                          q_chunk=4)
    tout, tc = attn.attention_prefill(module, tcfg, torch.from_numpy(x), tcache,
                                      torch.from_numpy(positions), q_chunk=4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    whole, _ = attn.attention_prefill(module, tcfg, torch.from_numpy(x),
                                      attn.init_kv_cache(tcfg, 2, 10, torch.float32,
                                                         quantized=quantized),
                                      torch.from_numpy(positions))
    np.testing.assert_allclose(tout.numpy(), whole.numpy(), atol=1e-6, rtol=0)
    for key in jc:
        atol = 0 if jc[key].dtype == jnp.int8 else 1e-5
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), atol=atol, rtol=0)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    """float32 rotation; cos/sin of large angles may differ in the last
    float32 bits between the two libraries."""
    from repro.layers.rope import apply_rope as jax_apply_rope
    from repro_torch.layers.rope import apply_rope

    x = np.random.default_rng(5).standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 570
    ref = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta))
    ours = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=theta)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# serve, entry points and config rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_serve_scan_matches_loop(quantized_kv):
    scan, stats = serve.generate("qwen3-4b", mode="scan", reps=1, verbose=False,
                                 quantized_kv=quantized_kv, device="cpu")
    loop, _ = serve.generate("qwen3-4b", mode="loop", reps=1, verbose=False,
                             quantized_kv=quantized_kv, device="cpu")
    assert tuple(scan.shape) == (2, 8 + 16)
    assert torch.equal(scan, loop)
    assert stats["device"] == "cpu" and stats["decode_tok_s"] > 0


def test_serve_refuses_a_mesh():
    """A mesh serves the scan path only (``tests/test_torch_mesh.py`` holds
    it); the per-token loop refuses one, with the reference's message."""
    with pytest.raises(ValueError, match="only wired into mode='scan'"):
        serve.generate("qwen3-4b", mode="loop", mesh=object(), device="cpu")


def test_serve_main_cli(capsys):
    serve.main(["--device", "cpu", "--gen-len", "2", "--prompt-len", "3"])
    assert "[serve] qwen3-4b mode=scan on cpu" in capsys.readouterr().out


def test_entry_points_need_the_card_or_an_explicit_cpu(monkeypatch, jax_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(cfg, jax_params("float32")[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.generate("qwen3-4b", verbose=False)
    assert lm.init(cfg, device="cpu").embed.device.type == "cpu"


def test_init_draws_the_reference_law():
    cfg = get_smoke_config("qwen3-4b", act_dtype="float32")
    model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    w = model.layers[0].mlp.wi_gate
    assert float(w.abs().max()) <= 2.0 / cfg.d_model**0.5 + 1e-6  # truncated at 2 sigma
    assert abs(float(w.std()) * cfg.d_model**0.5 - 0.88) < 0.05  # std of N(0,1) cut at +-2
    assert float(model.layers[0].ln1.abs().max()) == 0.0  # norm scales start at zero
    assert lm.param_count(model) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(
            jax_lm.init(jax_smoke_config("qwen3-4b"), jax.random.key(0), abstract=True)[0]))


def test_full_width_config_mirrors_reference():
    from repro.configs import get_config as jax_get_config

    ours, ref = get_config("qwen3-4b"), jax_get_config("qwen3-4b")
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
                  "qk_norm", "rope_theta", "act_dtype", "padded_vocab"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.padded_vocab == 152064


@pytest.mark.parametrize("override,match", [
    ({"pos": "sinusoidal", "d_model": 63}, "sinusoidal"),  # the table needs an even width
    ({"mlp_act": "relu"}, "unknown MLP activation"),
    ({"kind": "encdec"}, "encoder-decoder"),  # without cfg.encoder
    ({"sqrt_ladder": ("exact", "esas")}, "ladder"),  # the last rung is not "exact"
    ({"sqrt_ladder": ("e2afs", "exact")}, "ladder"),  # rung 0 is not sqrt_unit ("exact")
    ({"decode_kernel": "flash"}, "unknown decode kernel"),
])
def test_validate_rejects_what_the_port_does_not_run(override, match):
    with pytest.raises(ValueError, match=match):
        get_smoke_config("qwen3-4b", **override)


def test_params_from_numpy_rejects_a_short_tree(jax_params):
    tree = dict(jax_params("float32")[1])
    del tree["unembed"]
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy(get_smoke_config("qwen3-4b"), tree, device="cpu")


def test_cpu_model_never_counts_launches(jax_params):
    _, tcfg, _, model, prompt, _, tcache = _both(jax_params, decode_kernel="fused")
    dispatch.reset_launch_counts()
    logits, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt), last_logit_only=True)
    lm.generate_scan(model, tcfg, tcache, logits.argmax(-1), S, 2)
    assert set(dispatch.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# gemma3-1b (five window layers to one global) and deepseek-67b, smoke configs
# ---------------------------------------------------------------------------

MIX_S, MIX_GEN = 12, 16  # the prompt is longer than gemma3-1b's smoke window (8)
MIX_ARCHS = ("gemma3-1b", "deepseek-67b")


@pytest.fixture(scope="module")
def mixed_runs():
    """Per (arch, quantized, decode_kernel): the reference's weights as a
    numpy tree, the prompt, and the JAX package's prefill logits, caches
    after prefill, greedy tokens and next token, each computed once."""
    trees, runs = {}, {}

    def get(arch, quantized=False, decode_kernel=None):
        key = (arch, quantized, decode_kernel)
        if arch not in trees:
            params, _ = jax_lm.init(jax_smoke_config(arch, act_dtype="float32",
                                                     sqrt_unit="e2afs"), jax.random.key(0))
            trees[arch] = (params, jax.tree.map(np.asarray, params))
        if key not in runs:
            jcfg = jax_smoke_config(arch, act_dtype="float32", sqrt_unit="e2afs",
                                    decode_kernel=decode_kernel)
            params = trees[arch][0]
            prompt = np.random.default_rng(1).integers(0, jcfg.vocab, (B, MIX_S)).astype(np.int32)
            jcache, _ = jax_lm.init_cache(jcfg, B, MIX_S + MIX_GEN, quantized=quantized)
            jlog, jcache = _jprefill(params, jcfg, jcache, jnp.asarray(prompt))
            after = jax.tree.map(np.asarray, jcache)
            jt, jnext, _ = _jgenerate(params, jcfg, jcache, jnp.argmax(jlog[:, -1:], axis=-1),
                                      MIX_S, MIX_GEN)
            runs[key] = {"prompt": prompt, "logits": np.asarray(jlog), "cache": after,
                         "tokens": np.asarray(jt), "next": np.asarray(jnext)}
        return trees[arch][1], runs[key]

    return get


def _port_prefill(arch, tree, prompt, quantized=False, decode_kernel=None):
    tcfg = get_smoke_config(arch, act_dtype="float32", sqrt_unit="e2afs",
                            decode_kernel=decode_kernel)
    model = convert.params_from_numpy(tcfg, tree, device="cpu")
    tcache = lm.init_cache(tcfg, B, MIX_S + MIX_GEN, quantized=quantized, device="cpu")
    tlog, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt))
    return tcfg, model, tlog, tcache


def _layer_caches(cfg, cache):
    """Per-layer cache dicts of either form, as numpy."""
    if isinstance(cache, list):
        return [{k: _np(v) for k, v in c.items()} for c in cache]
    return [{k: _np(v[i]) for k, v in cache.items()} for i in range(cfg.n_layers)]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", MIX_ARCHS)
def test_mixed_prefill_logits_and_per_layer_caches(mixed_runs, arch, quantized):
    """A prompt of 12: gemma3-1b's window layers keep the last 8 tokens in an
    8-line ring (rolled so token p sits at line p % 8), its global layers
    and every deepseek-67b layer keep all 12 of 28 lines.  Float caches:
    logits atol 1e-4, caches atol 1e-5 (sums in another order).  int8
    caches: scales atol 1e-5, and the codes identical but for at most two a
    layer that differ by one: a K or V value that the two frameworks put
    1e-6 apart can sit on a rounding boundary of its code (one such code in
    gemma3-1b's layer 5 here), and that one code moves the logits by up to
    about 5e-3, so int8 logits are held to atol 1e-2 (the greedy tokens,
    below, stay identical)."""
    tree, ref = mixed_runs(arch, quantized)
    tcfg, _, tlog, tcache = _port_prefill(arch, tree, ref["prompt"], quantized)
    assert isinstance(tcache, list) != tcfg.uniform
    np.testing.assert_allclose(_np(tlog), ref["logits"], atol=1e-2 if quantized else 1e-4, rtol=0)
    want_lines = [tcfg.window if b == "window" else MIX_S + MIX_GEN for b in tcfg.blocks]
    ours = _layer_caches(tcfg, tcache)
    theirs = _layer_caches(tcfg, ref["cache"])
    assert [c["k"].shape[1] for c in ours] == [c["k"].shape[1] for c in theirs] == want_lines
    for layer, (mine, want) in enumerate(zip(ours, theirs)):
        assert mine.keys() == want.keys()
        for key in want:
            if key in ("k", "v") and quantized:
                off = np.abs(mine[key] - want[key])
                assert off.max() <= 1 and (off > 0).sum() <= 2, (layer, key, off.max(),
                                                                  (off > 0).sum())
            else:
                np.testing.assert_allclose(mine[key], want[key], atol=1e-5, rtol=0,
                                           err_msg=f"layer {layer} {key}")


@pytest.mark.parametrize("decode_kernel", [None, "fused"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", MIX_ARCHS)
def test_mixed_generate_scan_tokens_identical(mixed_runs, arch, quantized, decode_kernel):
    """Prefill then 16 greedy steps, float32: tokens identical to the JAX
    package's, on the inline route and the decode-attention kernel's (its
    plain version on the CPU; the Pallas kernel interpreted on the JAX
    side), with the window layers' rings wrapped at prefill and again in
    decode."""
    tree, ref = mixed_runs(arch, quantized, decode_kernel)
    tcfg, model, tlog, tcache = _port_prefill(arch, tree, ref["prompt"], quantized, decode_kernel)
    tt, tnext, _ = lm.generate_scan(model, tcfg, tcache, tlog[:, -1:].argmax(dim=-1), MIX_S,
                                    MIX_GEN)
    np.testing.assert_array_equal(tt.numpy(), ref["tokens"])
    np.testing.assert_array_equal(tnext.numpy(), ref["next"])


@pytest.mark.parametrize("per_row", [False, True])
def test_mixed_decode_step_logits_and_caches(mixed_runs, per_row):
    """One gemma3-1b decode step after the prompt, at one position or one per
    row: logits atol 1e-4, every layer's cache atol 1e-5."""
    tree, ref = mixed_runs("gemma3-1b")
    tcfg, model, tlog, tcache = _port_prefill("gemma3-1b", tree, ref["prompt"])
    jcfg = jax_smoke_config("gemma3-1b", act_dtype="float32", sqrt_unit="e2afs")
    params = jax.tree.map(jnp.asarray, tree)
    jcache = jax.tree.map(jnp.asarray, ref["cache"])
    tok = ref["logits"][:, -1:].argmax(-1).astype(np.int32)
    pos = np.array([MIX_S, MIX_S + 5], np.int32) if per_row else MIX_S
    jl, jcache = _jdecode(params, jcfg, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl, tcache = lm.decode_step(model, tcfg, tcache, torch.from_numpy(tok),
                                torch.from_numpy(pos) if per_row else pos)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
    for layer, (mine, want) in enumerate(zip(_layer_caches(tcfg, tcache),
                                             _layer_caches(tcfg, jcache))):
        for key in want:
            np.testing.assert_allclose(mine[key], want[key], atol=1e-5, rtol=0,
                                       err_msg=f"layer {layer} {key}")


@pytest.mark.parametrize("arch", MIX_ARCHS)
def test_full_width_mixed_and_deepseek_configs_mirror_reference(arch):
    from repro.configs import get_config as jax_get_config

    ours, ref = get_config(arch), jax_get_config(arch)
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
                  "qk_norm", "rope_theta", "act_dtype", "padded_vocab", "block_pattern",
                  "window", "tie_embeddings", "blocks", "uniform"):
        assert getattr(ours, field) == getattr(ref, field), field
    smoke, ref_smoke = get_smoke_config(arch), jax_smoke_config(arch)
    assert dataclasses_fields(smoke) == dataclasses_fields(ref_smoke)


def dataclasses_fields(cfg):
    return {f: getattr(cfg, f) for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                                         "d_head", "d_ff", "vocab", "window", "block_pattern")}


def test_gemma3_param_count_matches_reference():
    """1.0 B parameters at full width (no allocation: meta tensors on our
    side, abstract shapes on the reference's)."""
    from repro.configs import get_config as jax_get_config

    ours = lm.param_count(lm.LM(get_config("gemma3-1b"), device="meta"))
    theirs = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax_lm.init(jax_get_config("gemma3-1b"), jax.random.key(0), abstract=True)[0]))
    assert ours == theirs and 0.99e9 < ours < 1.01e9


def test_serve_generate_gemma3_scan_matches_loop():
    scan, _ = serve.generate("gemma3-1b", mode="scan", reps=1, verbose=False, prompt_len=12,
                             device="cpu")
    loop, _ = serve.generate("gemma3-1b", mode="loop", reps=1, verbose=False, prompt_len=12,
                             device="cpu")
    assert tuple(scan.shape) == (2, 12 + 16)
    assert torch.equal(scan, loop)


# ---------------------------------------------------------------------------
# Accuracy-SLO ladders and seeded faults through the slot-pool decode
# ---------------------------------------------------------------------------

LADDER = ("e2afs", "esas", "exact")
LEVELS = np.array([0, 1, 2], dtype=np.int32)  # one slot at each rung
SLOT_S, SLOT_STEPS = 10, 12


@pytest.fixture(scope="module")
def ladder_trees():
    """The reference's float32 weights per arch, as (params, numpy tree)."""
    trees = {}

    def get(arch):
        if arch not in trees:
            params, _ = jax_lm.init(jax_smoke_config(arch, act_dtype="float32",
                                                     sqrt_unit="e2afs"), jax.random.key(0))
            trees[arch] = (params, jax.tree.map(np.asarray, params))
        return trees[arch]

    return get


def _slot_runs(ladder_trees, arch, *, sqrt_faults, unit_levels, hook=None, record=None):
    """Prefill 3 slots, then ``decode_slots_scan`` in both packages from the
    same weights and prompt; returns (port tokens, reference tokens)."""
    params, tree = ladder_trees(arch)
    kw = dict(act_dtype="float32", sqrt_unit="e2afs", sqrt_ladder=LADDER)
    jcfg = jax_smoke_config(arch, sqrt_faults=sqrt_faults and jax_faults.FaultConfig(
        *sqrt_faults), **kw)  # (site, rate, seed, bit)
    tcfg = get_smoke_config(arch, sqrt_faults=sqrt_faults and faults.FaultConfig(*sqrt_faults),
                            **kw)
    b = len(LEVELS)
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab, (b, SLOT_S)).astype(np.int32)
    cache_len = SLOT_S + SLOT_STEPS
    pos, active = np.full(b, SLOT_S, np.int32), np.ones(b, bool)
    remaining = np.full(b, SLOT_STEPS, np.int32)

    jcache, _ = jax_lm.init_cache(jcfg, b, cache_len)
    jlog, jcache = _jprefill(params, jcfg, jcache, jnp.asarray(prompt))
    jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
    jhook = hook and jax_faults.logits_hook(jax_faults.FaultConfig(*hook))
    jt = jax_lm.decode_slots_scan(params, jcfg, jcache, jtok, pos, active, remaining, SLOT_STEPS,
                                  unit_levels=None if unit_levels is None else
                                  jnp.asarray(unit_levels), logits_hook=jhook)[0]

    model = convert.params_from_numpy(tcfg, tree, device="cpu")
    tcache = lm.init_cache(tcfg, b, cache_len, device="cpu")
    tlog, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt))
    ttok = tlog[:, -1:].argmax(dim=-1).to(torch.int32)
    thook = hook and faults.logits_hook(faults.FaultConfig(*hook))
    if record is not None:
        inner = thook

        def thook(lg):
            record.append((lg.clone(), inner(lg)))
            return record[-1][1]

    tt = lm.decode_slots_scan(model, tcfg, tcache, ttok, torch.from_numpy(pos),
                              torch.from_numpy(active), torch.from_numpy(remaining), SLOT_STEPS,
                              unit_levels=None if unit_levels is None else
                              torch.from_numpy(unit_levels), logits_hook=thook)[0]
    return tt.numpy(), np.asarray(jt)


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-1b"])
def test_ladder_and_faults_decode_slots_scan_tokens_identical(ladder_trees, arch):
    """Float32, three slots at rungs 0, 1 and 2 of ("e2afs", "esas",
    "exact"), the prompt and rung 0 under sqrt_man faults: greedy tokens
    identical to the JAX package's, and the faults and the rungs change
    them.  The schedule strikes every rsqrt in mantissa bit 20 (rate 1.0,
    a pinned bit): a partial-rate schedule hashes the datapath's output
    bits, which follow the float32 mean square, and the two frameworks sum
    it in another order (ROADMAP C.17); ``test_torch_faults.py`` holds that
    schedule bit for bit on every pattern."""
    ours, ref = _slot_runs(ladder_trees, arch, sqrt_faults=("sqrt_man", 1.0, 7, 20),
                           unit_levels=LEVELS)
    np.testing.assert_array_equal(ours, ref)
    clean, clean_ref = _slot_runs(ladder_trees, arch, sqrt_faults=None,
                                  unit_levels=np.zeros_like(LEVELS))
    np.testing.assert_array_equal(clean, clean_ref)
    assert not np.array_equal(ours, clean)


def test_logits_hook_nan_positions_match_the_reference(ladder_trees):
    """NaN logits from ``logits_hook`` at rate 1e-2 in the port's
    ``decode_slots_scan``: every step's NaN positions are the reference's
    ``corrupt_logits`` of the port's pre-hook logits, and the greedy tokens
    are taken from the struck logits (the first NaN of a struck row)."""
    record = []
    ours, _ = _slot_runs(ladder_trees, "qwen3-4b", sqrt_faults=None, unit_levels=None,
                         hook=("logit_nan", 1e-2, 3), record=record)
    assert len(record) == SLOT_STEPS
    struck = 0
    for i, (pre, post) in enumerate(record):
        want = np.asarray(jax_faults.corrupt_logits(jnp.asarray(pre.numpy()),
                                                    jax_faults.FaultConfig("logit_nan", 1e-2, 3)))
        np.testing.assert_array_equal(np.isnan(post.numpy()), np.isnan(want))
        np.testing.assert_array_equal(post.numpy()[~np.isnan(want)], want[~np.isnan(want)])
        if i + 1 < SLOT_STEPS:
            np.testing.assert_array_equal(ours[:, i + 1], post.argmax(dim=-1).numpy())
        struck += int(np.isnan(want).sum())
    assert struck > 0


def test_decode_step_levels_need_a_ladder(jax_params):
    _, tcfg, _, model, prompt, _, tcache = _both(jax_params)
    with pytest.raises(ValueError, match="unit_levels requires cfg.sqrt_ladder"):
        lm.decode_step(model, tcfg, tcache, torch.from_numpy(prompt[:, :1]), 0,
                       unit_levels=torch.zeros(B, dtype=torch.int32))


def test_exact_twin_is_the_clean_exact_config():
    cfg = get_smoke_config("qwen3-4b", sqrt_unit="e2afs", sqrt_ladder=LADDER,
                           sqrt_faults=faults.FaultConfig("sqrt_man", 0.1))
    twin = lm.exact_twin(cfg)
    assert (twin.sqrt_unit, twin.sqrt_faults, twin.sqrt_ladder) == ("exact", None, None)
    assert lm.exact_twin(twin) is twin
