"""The torch port's recurrent families held against the JAX package:
mamba2-2.7b (the chunked SSD mixer, ``pos="none"``) and recurrentgemma-2b
(RG-LRU blocks and sliding-window attention, 2:1), each at its smoke config.

Each family's weights are drawn once (a module-scoped fixture) by the
port's ``lm.init``, the reference's law and constant starts, then every
leaf with a constant start is moved off it with seeded noise: the norm
scales, and the mixers' ``conv_w``, ``lam``, ``a_log``, ``dt_bias`` and
``d_skip``.  A fresh RG-LRU block computes nothing (``conv_w`` starts at
zero, so its recurrence input is zero), and a parity test on fresh weights
would pass whatever the port computed there.  The weights cross to the
reference as its tree of numpy arrays (``convert.params_to_numpy``); the
port's side loads the same tree.  No JAX ``Engine`` runs here: the engine
cases hold the port against itself.

Tolerances (``ATOL`` below, :func:`_close`): float32 logits, outputs and
states within 5e-5 of max(1, the tensor's largest |value|).  The
contractions, the cumulative sums and the conv's decode form sum in another
order than XLA's, and XLA may fuse a multiply-add of the RG-LRU's scan:
the readings are up to about 1e-5 on logits of magnitude 16 and 1.1e-4 on
SSM states of magnitude 10 after 130 tokens.  Greedy tokens identical.
Prefill against stepping ``decode_step`` over the prompt (both in the
port): the same limit.  bfloat16 prefill logits within 3e-2 of the largest
|logit| (``BF16_REL``): the frameworks round bf16 intermediates at
different places (XLA keeps a fusion's intermediates in float32), and the
recurrences carry each rounding on: the readings are 2.0e-2 for mamba2
(0.070 at 3.5) and 1.4e-2 for recurrentgemma (0.19 at 13.4, where a bf16
ulp is 0.0625), so ``test_torch_model.py``'s absolute 5e-2 cannot hold.
Gradients within 5e-5 of each leaf's largest |value| (``test_torch_train.py``'s
e2afs limit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import FaultConfig as JaxFaultConfig
from repro.launch import steps as jax_steps
from repro.layers import rglru as jax_rglru
from repro.layers import ssd as jax_ssd
from repro.models import lm as jax_lm
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.faults import FaultConfig
from repro_torch.launch import serve, steps, train
from repro_torch.launch.engine import AccuracySLO, Engine, Request, SpecConfig
from repro_torch.layers import rglru, ssd
from repro_torch.models import convert, lm

ARCHS = ("mamba2-2.7b", "recurrentgemma-2b")
ATOL = 5e-5
BF16_REL = 3e-2
B, GEN = 2, 8
# mamba2's prompt of 130 front-pads to two chunks of 128; recurrentgemma's
# 13 wraps its 8-line rings
PROMPT = {"mamba2-2.7b": 130, "recurrentgemma-2b": 13}

_prefill = jax.jit(jax_lm.prefill, static_argnums=1)
_generate = jax.jit(jax_lm.generate_scan, static_argnums=(1, 5))
_loss_grad = jax.jit(jax.value_and_grad(jax_steps.loss_fn, has_aux=True), static_argnums=1)
_mixer = {
    "mamba2-2.7b": (jax.jit(jax_ssd.ssd_train, static_argnums=1,
                            static_argnames=("chunk", "return_state")),
                    jax.jit(jax_ssd.ssd_decode, static_argnums=1)),
    "recurrentgemma-2b": (jax.jit(jax_rglru.rglru_train, static_argnums=1,
                                  static_argnames="return_state"),
                          jax.jit(jax_rglru.rglru_decode, static_argnums=1)),
}


@pytest.fixture(scope="module")
def trees():
    """arch -> (the reference's parameters, the same as numpy arrays), in
    float32, off their constant starts."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = get_smoke_config(arch, act_dtype="float32")
            model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for _, p in lm.constant_start_parameters(model):
                    p.add_(0.3 * torch.randn(p.shape, generator=gen))
            tree = convert.params_to_numpy(model)
            cache[arch] = (jax.tree.map(jnp.asarray, tree), tree)
        return cache[arch]

    return get


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _both(trees, arch, **kw):
    jcfg, tcfg = jax_smoke_config(arch, **kw), get_smoke_config(arch, **kw)
    params, tree = trees(arch)
    return jcfg, tcfg, params, convert.params_from_numpy(tcfg, tree, device="cpu")


def _close(got, want, what=""):
    """max |got - want| within ATOL of max(1, max |want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err, top = float(np.abs(got - want).max(initial=0)), float(np.abs(want).max(initial=0))
    assert err <= ATOL * max(1.0, top), f"{what}: max |diff| {err:.3g} at max |value| {top:.3g}"


def _cache_pairs(jcache, tcache):
    layers = zip(jcache, tcache) if isinstance(tcache, list) else [(jcache, tcache)]
    return [(key, j[key], t[key]) for j, t in layers for key in j]


def _mixer_pair(trees, arch, cfg):
    """Layer 0's mixer in both packages (float32)."""
    _, tree = trees(arch)
    layers = tree["layers"]
    p = {k: (v[0] if isinstance(layers, dict) else v)
         for k, v in (layers if isinstance(layers, dict) else layers[0])["mixer"].items()}
    module = (ssd.SSD if arch == "mamba2-2.7b" else rglru.RGLRU)(cfg, dtype=torch.float32,
                                                                  device="cpu")
    with torch.no_grad():
        for name, value in p.items():
            getattr(module, name).copy_(torch.from_numpy(np.array(value)))
    return {k: jnp.asarray(v) for k, v in p.items()}, module


@pytest.mark.parametrize("s", [2, 13])
@pytest.mark.parametrize("unit", ["exact", "e2afs"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_matches_the_reference(trees, arch, unit, s):
    """The mixer alone (layer 0's weights) over (2, s, d): the training
    form's output and the state it returns, then one decode step from that
    state, within ATOL.  The SSD runs chunks of 8, so s = 13 front-pads to
    two chunks; s = 2 is shorter than the conv's 3-line tail."""
    cfg = get_smoke_config(arch, act_dtype="float32", sqrt_unit=unit)
    jcfg = jax_smoke_config(arch, act_dtype="float32", sqrt_unit=unit)
    p, module = _mixer_pair(trees, arch, cfg)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jtrain, jdecode = _mixer[arch]
    if arch == "mamba2-2.7b":
        jy, jst = jtrain(p, jcfg, jnp.asarray(x), chunk=8, return_state=True)
        ty, tst = ssd.ssd_train(module, cfg, torch.from_numpy(x), chunk=8, return_state=True)
        decode = ssd.ssd_decode
    else:
        jy, jst = jtrain(p, jcfg, jnp.asarray(x), return_state=True)
        ty, tst = rglru.rglru_train(module, cfg, torch.from_numpy(x), return_state=True)
        decode = rglru.rglru_decode
    _close(ty, jy, "y")
    for key in jst:
        assert tuple(tst[key].shape) == tuple(jst[key].shape), key
        _close(tst[key], jst[key], key)
    jy1, jst1 = jdecode(p, jcfg, jnp.asarray(x1), jst)
    ty1, tst1 = decode(module, cfg, torch.from_numpy(x1), tst)
    _close(ty1, jy1, "decode y")
    for key in jst1:
        _close(tst1[key], jst1[key], key)


def test_linear_scan_is_the_recurrence():
    """The RG-LRU's log-depth scan equals the step-by-step recurrence
    h_t = a_t h_{t-1} + b_t at every length from 1 to 9 and at 33."""
    g = torch.Generator().manual_seed(0)
    for n in list(range(1, 10)) + [33]:
        a, b = torch.rand(2, n, 3, generator=g), torch.randn(2, n, 3, generator=g)
        h, want = torch.zeros(2, 3), []
        for t in range(n):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(rglru.linear_scan(a, b)[1], torch.stack(want, 1),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("unit", ["exact", "e2afs"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_tokens_match_the_reference(trees, arch, unit):
    """Prefill logits and every cache tensor (states and rings) within ATOL,
    then 8 greedy tokens through ``generate_scan`` identical."""
    jcfg, tcfg, params, model = _both(trees, arch, act_dtype="float32", sqrt_unit=unit)
    s = PROMPT[arch]
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab, (B, s)).astype(np.int32)
    jcache, _ = jax_lm.init_cache(jcfg, B, s + GEN)
    tcache = lm.init_cache(tcfg, B, s + GEN, device="cpu")
    jlog, jcache = _prefill(params, jcfg, jcache, jnp.asarray(prompt))
    tlog, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt))
    _close(tlog, jlog, "logits")
    for key, j, t in _cache_pairs(jcache, tcache):
        assert tuple(t.shape) == tuple(j.shape) and _np(t).dtype == _np(j).dtype, key
        _close(t, j, key)
    jt, jnext, _ = _generate(params, jcfg, jcache, jnp.argmax(jlog[:, -1:], -1), jnp.int32(s),
                             GEN)
    tt, tnext, _ = lm.generate_scan(model, tcfg, tcache, tlog[:, -1:].argmax(-1), s, GEN)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_state_equals_stepping(trees, arch):
    """One prefill against ``decode_step`` over the prompt a token at a time
    (the port alone): the last logits and every state within ATOL (the
    chunked and scanned forms against the O(1) step)."""
    _, cfg, _, model = _both(trees, arch, act_dtype="float32", sqrt_unit="e2afs")
    s = PROMPT[arch]
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (B, s)).astype(
        np.int32))
    pre, pcache = lm.prefill(model, cfg, lm.init_cache(cfg, B, s, device="cpu"), prompt)
    scache = lm.init_cache(cfg, B, s, device="cpu")
    for i in range(s):
        step, scache = lm.decode_step(model, cfg, scache, prompt[:, i:i + 1], i)
    _close(step[:, -1], pre[:, -1], "logits")
    for key, a, b in _cache_pairs(pcache, scache):
        _close(b, a, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_logits(trees, arch):
    """bfloat16 activations: prefill logits within BF16_REL of the largest
    |logit| of the reference."""
    jcfg, tcfg, params, model = _both(trees, arch, act_dtype="bfloat16", sqrt_unit="e2afs")
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab, (B, 12)).astype(np.int32)
    jlog, _ = _prefill(params, jcfg, jax_lm.init_cache(jcfg, B, 12)[0], jnp.asarray(prompt))
    tlog, _ = lm.prefill(model, tcfg, lm.init_cache(tcfg, B, 12, device="cpu"),
                         torch.from_numpy(prompt))
    assert tlog.dtype == torch.bfloat16
    top = float(np.abs(_np(jlog)).max())
    err = float(np.abs(_np(tlog) - _np(jlog)).max())
    assert err <= BF16_REL * top, f"max |diff| {err:.3g} at max |logit| {top:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(trees, arch):
    """e2afs, float32, block remat, 2 rows of 24 tokens: the loss within
    1e-5 and every gradient, the mixers' included, within 5e-5 of its
    leaf's largest |value|."""
    jcfg, tcfg, params, _ = _both(trees, arch, act_dtype="float32", sqrt_unit="e2afs")
    _, tree = trees(arch)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (B, 24)).astype(np.int32),
             "labels": rng.integers(0, tcfg.vocab, (B, 24)).astype(np.int32),
             "loss_mask": (rng.random((B, 24)) < 0.9).astype(np.float32)}
    (j_total, _), j_grads = _loss_grad(params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    total, _ = steps.loss_fn(model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(j_total), atol=1e-5)
    t_grads = convert.named_to_tree({n: p.grad for n, p in model.named_parameters()},
                                    tcfg.n_layers, stacked=tcfg.uniform)
    worst = {}
    for path, g_ref in jax.tree_util.tree_flatten_with_path(j_grads)[0]:
        node = t_grads
        for key in path:
            node = node[key.idx if hasattr(key, "idx") else key.key]
        g_ref = np.asarray(g_ref)
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        worst[name] = float(np.abs(node - g_ref).max() / max(np.abs(g_ref).max(), 1e-30))
    assert any("mixer" in n for n in worst)
    assert max(worst.values()) <= 5e-5, worst


def test_rglru_under_pinned_sqrt_faults_matches_the_reference(trees):
    """recurrentgemma-2b under ``sqrt_man`` at rate 1.0 with a pinned bit
    (every rsqrt of the norms and every RG-LRU sqrt flips mantissa bit 20,
    so the schedule does not hang on the hash of a float32 sum's bits, C.17):
    prefill logits and every state and ring within ATOL."""
    kw = dict(act_dtype="float32", sqrt_unit="e2afs")
    jcfg, tcfg, params, model = _both(trees, "recurrentgemma-2b", **kw)
    jcfg = jcfg.replace(sqrt_faults=JaxFaultConfig("sqrt_man", 1.0, seed=3, bit=20))
    tcfg = tcfg.replace(sqrt_faults=FaultConfig("sqrt_man", 1.0, seed=3, bit=20))
    s = PROMPT["recurrentgemma-2b"]
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab, (B, s)).astype(np.int32)
    jlog, jcache = _prefill(params, jcfg, jax_lm.init_cache(jcfg, B, s + GEN)[0],
                            jnp.asarray(prompt))
    tlog, tcache = lm.prefill(model, tcfg, lm.init_cache(tcfg, B, s + GEN, device="cpu"),
                              torch.from_numpy(prompt))
    clean, _ = lm.prefill(model, tcfg.replace(sqrt_faults=None),
                          lm.init_cache(tcfg, B, s + GEN, device="cpu"), torch.from_numpy(prompt))
    assert not torch.equal(tlog, clean), "the faults changed nothing"
    _close(tlog, jlog, "logits")
    for key, j, t in _cache_pairs(jcache, tcache):
        _close(t, j, key)


def test_ssd_gradient_stays_finite_where_the_reference_overflows(trees):
    """ROADMAP C.28: with a decay of about 12 a token (``dt_bias`` 12) over
    a chunk of 13, the upper triangle's ``exp(seg)`` passes float32's range;
    the reference masks after the exp, so its gradient is 0 * inf = NaN
    there, and the port masks before it.  The outputs agree within ATOL, and
    every gradient of the port (the input's and each mixer leaf's) is
    finite where the reference's is not."""
    arch = "mamba2-2.7b"
    cfg = get_smoke_config(arch, act_dtype="float32")
    jcfg = jax_smoke_config(arch, act_dtype="float32")
    p, module = _mixer_pair(trees, arch, cfg)
    p = dict(p, dt_bias=jnp.full_like(p["dt_bias"], 12.0))
    with torch.no_grad():
        module.dt_bias.fill_(12.0)
    x = np.random.default_rng(7).standard_normal((B, 13, cfg.d_model)).astype(np.float32)
    jy, jgrads = jax.value_and_grad(
        lambda q, v: jax_ssd.ssd_train(q, jcfg, v).sum(), argnums=(0, 1))(p, jnp.asarray(x))
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jgrads))
    module.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = ssd.ssd_train(module, cfg, tx).sum()
    ty.backward()
    _close(ty.detach(), jy, "sum of y")
    for name, g in [("x", tx.grad)] + [(n, q.grad) for n, q in module.named_parameters()]:
        assert g is not None and bool(torch.isfinite(g).all()), name


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_and_parameter_count_mirror_the_reference(arch):
    """The full config equals the reference's field for field, and the
    port's model (on the meta device) counts the reference's abstract
    init's parameters."""
    ours, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert arch in ARCH_IDS
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax_lm.init(ref, jax.random.key(0), abstract=True)[0]))
    assert lm.param_count(lm.LM(ours, device=torch.device("meta"))) == n_ref


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_the_reference_layout(trees, arch):
    """``params_from_numpy`` then ``params_to_numpy`` gives the reference's
    tree back, path for path and bit for bit: mamba2's ``mixer`` leaves
    stacked (L, ...), recurrentgemma's list of RG-LRU and window layers."""
    _, tree = trees(arch)
    cfg = get_smoke_config(arch, act_dtype="float32")
    back = convert.params_to_numpy(convert.params_from_numpy(cfg, tree, device="cpu"))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    ref = jax.tree_util.tree_flatten_with_path(jax_lm.init(
        jax_smoke_config(arch), jax.random.key(0), abstract=True)[0])[0]
    assert [p for p, _ in ref] == [p for p, _ in flat_b]


@pytest.mark.parametrize("arch", ARCHS)
def test_constant_starts_match_the_reference(arch):
    """``lm.init``'s mixer leaves that the reference's ``ssd_init`` or
    ``rglru_init`` start at a constant hold the same constant (SSD's conv_w
    and d_skip at one, a_log and dt_bias at zero; the RG-LRU's conv_w and
    lam at zero), and every drawn leaf's spread is the reference's within
    15% (the RG-LRU's w_r and w_i at scale 0.5)."""
    from repro.layers.param import DenseInit

    cfg = get_smoke_config(arch, act_dtype="float32")
    ini = DenseInit(jax.random.key(0))
    (jax_ssd.ssd_init if arch == "mamba2-2.7b" else jax_rglru.rglru_init)(ini, cfg)
    ref, _ = ini.build()
    model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ours = dict(model.layers[0].mixer.named_parameters())
    assert set(ours) == set(ref)
    constants = 0
    for name, a in ref.items():
        a, b = np.asarray(a), ours[name].numpy()
        if np.all(a == a.flat[0]):
            constants += 1
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            assert abs(b.std() / a.std() - 1) < 0.15, name
    assert constants == len(type(model.layers[0].mixer).CONSTANT_START)
    assert model.layers[0].ln1.abs().max() == 0 and model.ln_f.abs().max() == 0


def test_quantized_kv_keeps_the_states_float(trees):
    """recurrentgemma-2b with ``quantized=True``: the window layers' K/V int8
    with float32 scales, the RG-LRU states as they are (``conv`` in the
    activation dtype, ``h`` float32), the reference's layout; prefill's
    logits, states and int8 codes and scales against the reference's
    within ATOL (of 127 for a code: identical)."""
    arch = "recurrentgemma-2b"
    jcfg, tcfg, params, model = _both(trees, arch, act_dtype="float32", sqrt_unit="e2afs")
    s = PROMPT[arch]
    jcache, _ = jax_lm.init_cache(jcfg, B, s + GEN, quantized=True)
    tcache = lm.init_cache(tcfg, B, s + GEN, quantized=True, device="cpu")
    for key, j, t in _cache_pairs(jcache, tcache):
        assert tuple(t.shape) == tuple(j.shape) and t.numpy().dtype == np.asarray(j).dtype, key
    assert {t.dtype for c in tcache for k, t in c.items() if k in ("k", "v")} == {torch.int8}
    assert {c["h"].dtype for c in tcache if "h" in c} == {torch.float32}
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab, (B, s)).astype(np.int32)
    jlog, jcache = _prefill(params, jcfg, jcache, jnp.asarray(prompt))
    tlog, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt))
    _close(tlog, jlog, "logits")
    for key, j, t in _cache_pairs(jcache, tcache):
        _close(t, j, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generate_reports_token_exactness(arch):
    """``serve.generate`` runs both ids; ``token_exact_vs_loop`` is the
    reference's ``cfg.moe is None`` (True), and the scan path's tokens equal
    the per-token loop's."""
    toks, stats = serve.generate(arch, gen_len=6, reps=1, verbose=False, device="cpu")
    assert stats["token_exact_vs_loop"] == (jax_smoke_config(arch).moe is None) is True
    loop, _ = serve.generate(arch, gen_len=6, reps=1, verbose=False, device="cpu", mode="loop")
    torch.testing.assert_close(toks, loop, rtol=0, atol=0)


def test_train_loop_runs_recurrentgemma():
    """``launch.train`` on recurrentgemma-2b's smoke config: finite losses,
    the last below the first."""
    _, _, losses = train.train_loop("recurrentgemma-2b", steps=4, seq=32, batch=2, log_every=100,
                                    device="cpu")
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


# -- the engine, the port against itself ------------------------------------


@pytest.fixture(scope="module")
def served(trees):
    """arch -> (cfg, model): float32, e2afs, the weights of ``trees``."""
    return {arch: _both(trees, arch, act_dtype="float32", sqrt_unit="e2afs")[1::2]
            for arch in ARCHS}


def _trace(vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((5, 7), (12, 3), (2, 6), (9, 2), (4, 5))[:n]
    return [Request(uid=i, prompt=rng.integers(0, vocab, s).astype(np.int32),
                    max_new_tokens=budget) for i, (s, budget) in enumerate(shapes)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_staggered_requests_equal_each_alone(served, arch):
    """Five requests through two slots (staggered admissions, reused slots,
    a 2-token prompt): each request's tokens equal the same request alone
    in a pool of the same shape."""
    cfg, model = served[arch]
    eng = Engine(model, cfg, num_slots=2, cache_len=24, chunk=3)
    reqs = _trace(cfg.vocab)
    done = eng.run(reqs)
    assert eng.stats["n_ok"] == len(reqs)
    for r in reqs:
        eng.reset()
        np.testing.assert_array_equal(done[r.uid].tokens, eng.run([r])[r.uid].tokens,
                                      err_msg=f"uid {r.uid}")


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slot_sees_no_stale_state(served, arch):
    """One slot serves a long request, then a short one: the short one's
    tokens equal its run in a fresh engine (admission overwrites the whole
    state row, the conv tail of a 2-token prompt included)."""
    cfg, model = served[arch]
    first, second = _trace(cfg.vocab)[1], _trace(cfg.vocab)[2]
    eng = Engine(model, cfg, num_slots=1, cache_len=24, chunk=3)
    done = eng.run([first, second])
    fresh = Engine(model, cfg, num_slots=1, cache_len=24, chunk=3).run([second])
    np.testing.assert_array_equal(done[second.uid].tokens, fresh[second.uid].tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_canaries_leave_tokens_and_pool_untouched(served, arch):
    """Shadow-exact canaries on every step (stride 1) with budgets that never
    trip: every token and every pool tensor bit-identical to the same
    engine without an SLO.  The shadow reads the pool's recurrent states
    and drops its own; were it to write them, the served step would read a
    state advanced twice."""
    cfg, model = served[arch]
    quiet = AccuracySLO(canary_stride=1, rel_err_budget=1e9, divergence_budget=None,
                        promote_after=None)
    plain = Engine(model, cfg, num_slots=2, cache_len=24, chunk=3)
    canary = Engine(model, cfg, num_slots=2, cache_len=24, chunk=3, slo=quiet)
    want, got = plain.run(_trace(cfg.vocab)), canary.run(_trace(cfg.vocab))
    assert canary.stats["canary_checks"] > 0
    for uid, c in want.items():
        np.testing.assert_array_equal(got[uid].tokens, c.tokens, err_msg=f"uid {uid}")
    for a, b in zip(lm.pool_tensors(plain.pool), lm.pool_tensors(canary.pool)):
        assert torch.equal(a, b)


def test_snapshot_resume_mid_decode(served, tmp_path):
    """recurrentgemma-2b killed after two chunks (a snapshot of its states
    and rings mid-decode) and resumed by ``Engine.resume``: every request's
    tokens equal the uninterrupted run's; the snapshot reads back through
    the reference's ``checkpoint.restore`` onto its abstract pool, leaf for
    leaf."""
    arch = "recurrentgemma-2b"
    cfg, model = served[arch]
    kw = dict(num_slots=2, cache_len=24, chunk=3)
    want = Engine(model, cfg, **kw).run(_trace(cfg.vocab))
    eng = Engine(model, cfg, snapshot_dir=tmp_path, **kw)
    done = eng.run(_trace(cfg.vocab), max_chunks=2)
    eng.snapshot(step=5)
    like = {"pool": jax_lm.init_pool_state(jax_smoke_config(arch, act_dtype="float32"), 2, 24,
                                           abstract=True)}
    flat = jax.tree_util.tree_flatten_with_path(jax_checkpoint.restore(tmp_path, 5, like))[0]
    got = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(a)
           for path, a in flat}
    names = ([f"pool/cache/{i}/{k}" for i, layer in enumerate(eng.pool["cache"])
              for k in sorted(layer)]
             + [f"pool/{k}" for k in ("tok", "pos", "active", "remaining", "keys")])
    assert set(got) == set(names) and "pool/cache/0/h" in got
    for name, t in zip(names, lm.pool_tensors(eng.pool)):
        np.testing.assert_array_equal(got[name], t.numpy(), err_msg=name)
    done.update(Engine.resume(model, cfg, tmp_path).run())
    assert sorted(done) == sorted(want)
    for uid, c in want.items():
        np.testing.assert_array_equal(done[uid].tokens, c.tokens, err_msg=f"uid {uid}")


@pytest.mark.parametrize("arch", ARCHS)
def test_speculation_refuses_recurrent_models(served, arch):
    """As the reference: a recurrent state cannot be verified position-
    parallel, so ``Engine(spec=)`` refuses both families."""
    cfg, model = served[arch]
    with pytest.raises(ValueError, match="attention-only"):
        Engine(model, cfg, spec=SpecConfig(k=2))
