"""The torch port's LayerNorm, vision-stub and mixture-of-experts families
held against the JAX package: starcoder2-15b (LayerNorm, GELU MLP),
internvl2-76b (vision tokens in front of the text), mixtral-8x22b (experts
over a window stack) and qwen3-moe-235b-a22b (128 experts of which 8, with
qk-norm), each at its smoke config.

Each family's weights are drawn once (a module-scoped fixture) by the
port's ``lm.init``, the reference's law, with every norm parameter and
GELU bias then moved off its constant start (so that a LayerNorm's scale
and bias, or a bias, in the wrong place would show), and cross to the
reference as its tree of numpy arrays (``convert.params_to_numpy``, which
skips the reference's init compile); the port's side loads the same tree
through ``convert.params_from_numpy``.
No JAX ``Engine`` runs here: the engine cases hold the port against itself
(staggered requests against the same requests alone, speculation against
the plain engine).

Tolerances: float32 logits, caches and the router's aux loss within 1e-5
(sums in another order: the readings are about 3e-6); the experts' output,
whose entries reach about 20 at smoke width (the reference's fan-in is the
expert count), within 1e-5 plus 1e-6 relative; greedy tokens, routing
choices, buffer positions and drops identical; gradients within 5e-5 of
each leaf's largest |value| (the e2afs limit of ``test_torch_train.py``,
for the same reason); bfloat16 logits within 5e-2 (``test_torch_model.py``'s:
the frameworks round bf16 intermediates at different places) for the dense
families.  A bf16 MoE model is held layer by layer instead: the smoke
router's probabilities sit within 3e-4 of each other, so a one-ulp bf16
difference in a hidden state can flip a choice and move a token's logits by
several units (mixtral's prefill reads 3.5); ``moe_apply`` on the same bf16
input keeps the reference's routing and is within two bf16 ulps of the
largest |y|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import steps as jax_steps
from repro.layers import moe as jax_moe
from repro.models import lm as jax_lm
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import serve, steps
from repro_torch.launch.engine import Engine, Request, SpecConfig
from repro_torch.layers import moe
from repro_torch.models import convert, lm

FAMILIES = ("starcoder2-15b", "internvl2-76b", "mixtral-8x22b", "qwen3-moe-235b-a22b")
B, GEN = 2, 8
# mixtral's smoke window is 8 lines: a 12-token prompt wraps its rings
PROMPT = {"mixtral-8x22b": 12}


# the reference's entry points, jitted (the config static): one XLA compile
# a call instead of one a primitive in eager dispatch
_prefill = jax.jit(jax_lm.prefill, static_argnums=1)
_generate = jax.jit(jax_lm.generate_scan, static_argnums=(1, 5))
_forward = jax.jit(jax_lm.forward, static_argnums=1)
_loss_grad = jax.jit(jax.value_and_grad(jax_steps.loss_fn, has_aux=True), static_argnums=1)
_moe_apply = jax.jit(jax_moe.moe_apply, static_argnums=1, static_argnames="capacity_factor")



@pytest.fixture(scope="module")
def trees():
    """arch -> (the reference's parameters, the same as numpy arrays), in
    float32 whatever the activation dtype or unit of a case, as the
    reference keeps its masters."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = get_smoke_config(arch, act_dtype="float32")
            model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for _, p in lm.constant_start_parameters(model):
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
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


def _cache_pairs(jcache, tcache):
    layers = zip(jcache, tcache) if isinstance(tcache, list) else [(jcache, tcache)]
    return [(key, j[key], t[key]) for j, t in layers for key in j]


@pytest.mark.parametrize("unit", ["exact", "e2afs"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_greedy_tokens_match_the_reference(trees, arch, unit):
    """Prefill logits and every cache tensor within 1e-5, then 8 greedy
    tokens through ``generate_scan`` identical (mixtral's rings wrapped by
    the prompt; MoE prefill drops follow the prompt length on both sides)."""
    jcfg, tcfg, params, model = _both(trees, arch, act_dtype="float32", sqrt_unit=unit)
    s = PROMPT.get(arch, 8)
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab, (B, s)).astype(np.int32)
    jcache, _ = jax_lm.init_cache(jcfg, B, s + GEN)
    tcache = lm.init_cache(tcfg, B, s + GEN, device="cpu")
    jlog, jcache = _prefill(params, jcfg, jcache, jnp.asarray(prompt))
    tlog, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt))
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-5, rtol=0)
    for key, j, t in _cache_pairs(jcache, tcache):
        assert tuple(t.shape) == tuple(j.shape), key
        np.testing.assert_allclose(_np(t), _np(j), atol=1e-5, rtol=0, err_msg=key)
    if "window" in tcfg.blocks:
        assert tcache["k"].shape[2] == tcfg.window < s
    jt, jnext, _ = _generate(params, jcfg, jcache, jnp.argmax(jlog[:, -1:], -1), jnp.int32(s),
                             GEN)
    tt, tnext, _ = lm.generate_scan(model, tcfg, tcache, tlog[:, -1:].argmax(-1), s, GEN)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))


def _moe_pair(trees, arch):
    """Layer 0's experts of ``arch`` in both packages (float32)."""
    _, tree = trees(arch)
    cfg = get_smoke_config(arch, act_dtype="float32")
    p = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    module = moe.MoE(cfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, value in p.items():
            getattr(module, name).copy_(torch.from_numpy(np.array(value)))
    return cfg, {k: jnp.asarray(v) for k, v in p.items()}, module


def _reference_routing(p, cfg, x, cf):
    """The reference's routing, step for step (``repro.layers.moe``):
    (chosen experts, positions in their buffers, keep)."""
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    b, s, _ = x.shape
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    flat = onehot.reshape(b, s * k, e)
    pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(b, s, k, e) * onehot).sum(-1)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < max(k, int(cf * s * k / e)))


@pytest.mark.parametrize("arch,cf", [("mixtral-8x22b", 1.25), ("mixtral-8x22b", 0.5),
                                     ("qwen3-moe-235b-a22b", 0.5)])
def test_moe_apply_matches_the_reference(trees, arch, cf):
    """``moe_apply`` alone on 2 rows of 16 tokens: y within 1e-5 plus 1e-6
    relative, the aux loss within 1e-5, and the same choices, buffer positions and drops as the
    reference's routing; at capacity factor 0.5 the reference drops
    choices (asserted)."""
    cfg, p, module = _moe_pair(trees, arch)
    x = np.random.default_rng(5).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jy, jaux = _moe_apply(p, cfg, jnp.asarray(x), capacity_factor=cf)
    ty, taux = moe.moe_apply(module, cfg, torch.from_numpy(x), capacity_factor=cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5, rtol=0)
    idx, pos, keep = _reference_routing(p, cfg, jnp.asarray(x), cf)
    cap = moe.capacity(cfg, 16, cf)
    _, _, tidx, tpos, tkeep = moe.route(module.router, torch.from_numpy(x), cfg.moe.top_k, cap)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    if cf < 1:
        assert not keep.all(), "the reference drops no choice at this shape"


@pytest.mark.parametrize("tie", ["first", "second"])
def test_router_ties_break_toward_the_lower_expert(tie):
    """A router whose columns 1 and 2 are equal gives those experts equal
    probabilities: tied for first place, or for second behind expert 0.
    ``jax.lax.top_k`` takes the lower index first; so does the port (a
    stable sort), with the same order of choices and the same y."""
    cfg = get_smoke_config("mixtral-8x22b", act_dtype="float32")
    d = cfg.d_model
    rng = np.random.default_rng(7)
    w = np.abs(rng.standard_normal(d)).astype(np.float32) * 0.1
    lead = {"first": 0.5, "second": 3.0}[tie]
    router = np.stack([lead * w, w, w, -w], axis=1)
    p = {"router": router}
    for name, shape in (("wi_gate", (4, d, 128)), ("wi_up", (4, d, 128)), ("wo", (4, 128, d))):
        p[name] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    module = moe.MoE(cfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, value in p.items():
            getattr(module, name).copy_(torch.from_numpy(value))
    x = np.abs(rng.standard_normal((1, 6, d))).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    idx, _, _ = _reference_routing(jp, cfg, jnp.asarray(x), 1.25)
    want = {"first": [1, 2], "second": [0, 1]}[tie]
    assert (idx == want).all(), idx
    _, _, tidx, _, _ = moe.route(module.router, torch.from_numpy(x), 2, 3)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    jy, _ = _moe_apply(jp, cfg, jnp.asarray(x))
    ty, _ = moe.moe_apply(module, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-6)


def test_route_takes_given_choices(trees):
    """``route(choices=)`` with the router's own choices reproduces its
    output; other choices take those experts' renormalised probabilities
    as gates and their own buffer positions."""
    cfg, _, module = _moe_pair(trees, "qwen3-moe-235b-a22b")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 16, cfg.d_model)).astype(
        np.float32))
    own = moe.route(module.router, x, 2, 4)
    again = moe.route(module.router, x, 2, 4, choices=own[2])
    for a, b in zip(own, again):
        assert torch.equal(a, b)
    flipped = own[2].flip(-1)
    probs, gates, idx, pos, keep = moe.route(module.router, x, 2, 4, choices=flipped)
    assert torch.equal(idx, flipped) and torch.equal(gates, own[1].flip(-1))
    assert torch.equal(keep, pos < 4)


def test_vision_forward_gives_text_logits(trees):
    """internvl2-76b's forward: ``vision @ vision_proj`` in front of the
    tokens, positions over both, logits over the text positions only,
    within 1e-5 of the reference; a batch without vision is refused."""
    jcfg, tcfg, params, model = _both(trees, "internvl2-76b", act_dtype="float32",
                                      sqrt_unit="e2afs")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (B, 10)).astype(np.int32),
             "vision": rng.standard_normal((B, tcfg.vision_tokens, tcfg.d_model)).astype(
                 np.float32)}
    jlog, _ = _forward(params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    tlog, aux = lm.forward(model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(tlog.shape) == (B, 10, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-5, rtol=0)
    assert float(aux["moe_aux"]) == 0.0
    with pytest.raises(ValueError, match="vision"):
        lm.forward(model, tcfg, {"tokens": torch.from_numpy(batch["tokens"])})


def test_moe_loss_aux_and_gradients_match_the_reference(trees):
    """mixtral-8x22b (e2afs, float32, block remat: each layer's forward,
    its router included, recomputed in the backward) over 2 rows of 24
    tokens, its window of 8 inside: the forward's ``moe_aux`` (the layers'
    mean) and the loss within 1e-5, and every gradient within 5e-5 of its
    leaf's largest |value|, the routers' included."""
    jcfg, tcfg, params, _ = _both(trees, "mixtral-8x22b", act_dtype="float32", sqrt_unit="e2afs")
    assert tcfg.remat == "block"
    _, tree = trees("mixtral-8x22b")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (B, 24)).astype(np.int32),
             "labels": rng.integers(0, tcfg.vocab, (B, 24)).astype(np.int32),
             "loss_mask": (rng.random((B, 24)) < 0.9).astype(np.float32)}
    (j_total, j_metrics), j_grads = _loss_grad(params, jcfg,
                                               {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    total, metrics = steps.loss_fn(model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    aux = float(metrics["moe_aux"].detach())
    assert aux > 0
    np.testing.assert_allclose(aux, float(j_metrics["moe_aux"]), atol=1e-5)
    np.testing.assert_allclose(float(total.detach()), float(j_total), atol=1e-5)
    t_grads = convert.named_to_tree({n: p.grad for n, p in model.named_parameters()},
                                    tcfg.n_layers, stacked=True)
    worst = {}
    for path, g_ref in jax.tree_util.tree_flatten_with_path(j_grads)[0]:
        node = t_grads
        for key in path:
            node = node[key.key]
        g_ref = np.asarray(g_ref)
        worst["/".join(k.key for k in path)] = float(np.abs(node - g_ref).max()
                                                     / np.abs(g_ref).max())
    assert "layers/moe/router" in worst
    assert max(worst.values()) <= 5e-5, worst


@pytest.mark.parametrize("arch", ["starcoder2-15b", "internvl2-76b"])
def test_bf16_prefill_logits(trees, arch):
    """bfloat16 activations: prefill logits within 5e-2 of the reference."""
    jcfg, tcfg, params, model = _both(trees, arch, act_dtype="bfloat16", sqrt_unit="e2afs")
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab, (B, 8)).astype(np.int32)
    jlog, _ = _prefill(params, jcfg, jax_lm.init_cache(jcfg, B, 8)[0], jnp.asarray(prompt))
    tlog, _ = lm.prefill(model, tcfg, lm.init_cache(tcfg, B, 8, device="cpu"),
                         torch.from_numpy(prompt))
    assert tlog.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=5e-2, rtol=0)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_bf16_moe_apply(trees, arch):
    """bfloat16 experts on the same bf16 input: the reference's choices,
    positions and drops (capacity factor 0.5), and y within two bf16 ulps
    of the largest |y|."""
    cfg, p, module = _moe_pair(trees, arch)
    module = module.to(torch.bfloat16)
    x = np.random.default_rng(6).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jy, _ = _moe_apply(p, cfg.replace(act_dtype="bfloat16"), jx, capacity_factor=0.5)
    ty, _ = moe.moe_apply(module, cfg, xb, capacity_factor=0.5)
    assert ty.dtype == torch.bfloat16
    idx, pos, keep = _reference_routing(p, cfg, jx.astype(jnp.float32), 0.5)
    _, _, tidx, tpos, tkeep = moe.route(module.router, xb, cfg.moe.top_k,
                                        moe.capacity(cfg, 16, 0.5))
    np.testing.assert_array_equal(tidx.numpy(), idx)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    ref = _np(jy)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(_np(ty) - ref).max() <= 2 * ulp


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_round_trip_through_the_reference_layout(trees, arch):
    """``params_from_numpy`` then ``params_to_numpy`` gives the reference's
    tree back, path for path and bit for bit: LayerNorm's ``*_scale`` and
    ``*_bias``, ``moe/{router, wi_gate, wi_up, wo}`` stacked (L, E, d, f),
    ``vision_proj``."""
    _, tree = trees(arch)
    cfg = get_smoke_config(arch, act_dtype="float32")
    back = convert.params_to_numpy(convert.params_from_numpy(cfg, tree, device="cpu"))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    layers = back["layers"]
    if cfg.moe is not None:
        assert layers["moe"]["wi_gate"].shape == (cfg.n_layers, cfg.moe.n_experts, cfg.d_model,
                                                  cfg.moe.d_ff_expert)
    assert ("ln1_scale" in layers) == (cfg.norm == "layernorm")
    assert ("vision_proj" in back) == bool(cfg.vision_tokens)


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_config_and_parameter_count_mirror_the_reference(arch):
    """The full config equals the reference's field for field, and the
    port's model (on the meta device) counts the reference's abstract
    init's parameters."""
    ours, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax_lm.init(ref, jax.random.key(0), abstract=True)[0]))
    assert lm.param_count(lm.LM(ours, device=torch.device("meta"))) == n_ref


def test_registry_knows_the_ported_ids_and_validate_keeps_its_refusals():
    assert set(FAMILIES) <= set(ARCH_IDS)
    for override, match in (({"block_pattern": ("ssd",)}, "ssd blocks need cfg.ssm"),
                            ({"mlp_act": "relu"}, "unknown MLP activation"),
                            ({"kind": "encdec"}, "encoder-decoder"),  # without an encoder
                            ({"pos": "sinusoidal", "d_model": 63}, "sinusoidal"),
                            ({"norm": "batchnorm"}, "unknown norm")):
        with pytest.raises(ValueError, match=match):
            get_smoke_config("starcoder2-15b", **override)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_generate_reports_token_exactness(arch):
    """``serve.generate`` runs every new id; ``token_exact_vs_loop`` is the
    reference's ``cfg.moe is None``, and where it is True the scan path's
    tokens equal the per-token loop's."""
    toks, stats = serve.generate(arch, gen_len=6, reps=1, verbose=False, device="cpu")
    assert stats["token_exact_vs_loop"] == (jax_smoke_config(arch).moe is None)
    if stats["token_exact_vs_loop"]:
        loop, _ = serve.generate(arch, gen_len=6, reps=1, verbose=False, device="cpu",
                                 mode="loop")
        torch.testing.assert_close(toks, loop, rtol=0, atol=0)


def test_layernorm_ladder_level_0_is_the_plain_norm():
    """starcoder2's smoke model with the ladder ("e2afs", "esas", "exact"):
    a decode step with rows at levels (0, 2) gives row 0 the logits of the
    model without a ladder and row 1 those of its exact twin, bit for bit."""
    cfg = get_smoke_config("starcoder2-15b", act_dtype="float32", sqrt_unit="e2afs")
    laddered = cfg.replace(sqrt_ladder=("e2afs", "esas", "exact")).validate()
    model = lm.init(cfg, torch.Generator().manual_seed(2), device="cpu")
    prompt = torch.randint(0, cfg.vocab, (B, 6), generator=torch.Generator().manual_seed(3))
    out = {}
    for name, c, levels in (("plain", cfg, None), ("exact", lm.exact_twin(cfg), None),
                            ("ladder", laddered, torch.tensor([0, 2], dtype=torch.int32))):
        cache = lm.init_cache(c, B, 8, device="cpu")
        _, cache = lm.prefill(model, cfg, cache, prompt)
        out[name], _ = lm.decode_step(model, c, cache, prompt[:, -1:], 6, unit_levels=levels)
    assert torch.equal(out["ladder"][0], out["plain"][0])
    assert torch.equal(out["ladder"][1], out["exact"][1])
    assert not torch.equal(out["plain"][1], out["exact"][1])


def _trace(vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((5, 7), (12, 3), (3, 6), (9, 2), (4, 5))[:n]
    return [Request(uid=i, prompt=rng.integers(0, vocab, s).astype(np.int32),
                    max_new_tokens=budget) for i, (s, budget) in enumerate(shapes)]


def test_speculation_on_starcoder2_gives_the_plain_engines_tokens():
    """A LayerNorm model speculates: n-gram drafting at k = 3 serves the
    plain engine's tokens through 2 slots."""
    cfg = get_smoke_config("starcoder2-15b", act_dtype="float32", sqrt_unit="e2afs")
    model = lm.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    kw = dict(num_slots=2, cache_len=24, chunk=3)
    want = Engine(model, cfg, **kw).run(_trace(cfg.vocab))
    eng = Engine(model, cfg, spec=SpecConfig(k=3), **kw)
    done = eng.run(_trace(cfg.vocab))
    for uid, c in want.items():
        np.testing.assert_array_equal(done[uid].tokens, c.tokens, err_msg=f"uid {uid}")
    assert eng.stats["spec_steps"] > 0


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_moe_engine_staggered_requests_equal_each_alone(arch):
    """Five requests through two slots (staggered admissions, reused slots,
    mixtral's rings past the window): each request's tokens equal the same
    request alone in a pool of the same shape, since admission routes each
    prompt as its own group and a decode step routes each row alone."""
    cfg = get_smoke_config(arch, act_dtype="float32", sqrt_unit="e2afs")
    model = lm.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    eng = Engine(model, cfg, num_slots=2, cache_len=24, chunk=3)
    reqs = _trace(cfg.vocab)
    done = eng.run(reqs)
    assert eng.stats["n_ok"] == len(reqs)
    for r in reqs:
        eng.reset()
        alone = eng.run([r])
        np.testing.assert_array_equal(done[r.uid].tokens, alone[r.uid].tokens,
                                      err_msg=f"uid {r.uid}")
