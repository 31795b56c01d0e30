"""The torch port's encoder-decoder (whisper-small at its smoke config: 2
encoder and 2 decoder layers, d 64, 8 audio frames) held against the JAX
package.

The weights are drawn once in float32 by the port's ``lm.init`` (the
reference's law and constant starts; the reference's own eager init takes
about 6 s here), and every leaf with a constant start (LayerNorm scales at
one, their biases and the GELU MLP's at zero) is moved off it with seeded
noise, since a zero bias would hold nothing; then the same tree of numpy
arrays goes to both packages, to the port through
``convert.params_from_numpy``.  The audio
frames are seeded numpy normals, as the reference's tests draw them from
``jax.random``.  The reference's entry points are jitted once for the file
(the config static), so the tests that repeat a call share its compile.

Tolerances (``ATOL``, :func:`_close`): float32 logits, encoder outputs and
cross K/V within 5e-5 of max(1, the tensor's largest |value|): the
contractions and the LayerNorm reductions sum in another order than XLA's,
and the decode-step sinusoid's float32 ``pow``/``sin``/``cos`` may differ by
an ulp (ROADMAP C.10).  Gradients within 5e-5 of each leaf's largest |value|
(``test_torch_train.py``'s e2afs limit).  Greedy tokens identical.  Inside
the port, prefill's last logits equal the decode loop's bit for bit (bf16,
as the reference's ``test_prefill_encdec_with_cross_kv``), and a request
admitted at a staggered step equals itself alone in the pool.
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
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro_torch import checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import steps
from repro_torch.launch.engine import Engine, SpecConfig
from repro_torch.models import convert, lm

# one torch thread, as tests/test_torch_core.py sets for the whole run: the
# suite's workers share the machine with one another's XLA thread pools
torch.set_num_threads(1)

ARCH = "whisper-small"
ATOL = 5e-5
B, S, GEN = 2, 6, 8

_forward = jax.jit(jax_lm.forward, static_argnums=1)
_cross = jax.jit(jax_lm.precompute_cross, static_argnums=1)
_decode = jax.jit(jax_lm.decode_step, static_argnums=1)
_prefill = jax.jit(jax_lm.prefill, static_argnums=1, static_argnames="last_logit_only")
_generate = jax.jit(jax_lm.generate_scan, static_argnums=(1, 5))
_loss_grad = jax.jit(jax.value_and_grad(jax_steps.loss_fn, has_aux=True), static_argnums=1)


@pytest.fixture(scope="module")
def ref():
    """(the reference's float32 parameters, the same tree as numpy arrays,
    the port's model on them, the audio frames, the prompt)."""
    jcfg, cfg = _cfgs()
    drawn = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for _, p in lm.constant_start_parameters(drawn):
            p.add_(0.3 * torch.randn(p.shape, generator=gen))
    tree = convert.params_to_numpy(drawn)
    model = convert.params_from_numpy(cfg, tree, device="cpu")
    data = np.random.default_rng(2)
    audio = data.standard_normal((B, jcfg.encoder.n_ctx, jcfg.d_model)).astype(np.float32)
    prompt = data.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return jax.tree.map(jnp.asarray, tree), tree, model, audio, prompt


def _cfgs(**kw):
    kw = {"act_dtype": "float32", "sqrt_unit": "e2afs", **kw}
    return jax_smoke_config(ARCH, **kw), get_smoke_config(ARCH, **kw)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, what=""):
    """max |got - want| within ATOL of max(1, max |want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err, top = float(np.abs(got - want).max(initial=0)), float(np.abs(want).max(initial=0))
    assert err <= ATOL * max(1.0, top), f"{what}: max |diff| {err:.3g} at max |value| {top:.3g}"


@pytest.fixture(scope="module")
def cross(ref):
    """Both packages' ``precompute_cross`` on the same frames."""
    params, _, model, audio, _ = ref
    jcfg, tcfg = _cfgs()
    jckv, jenc = _cross(params, jcfg, jnp.asarray(audio))
    tckv, tenc = lm.precompute_cross(model, tcfg, torch.from_numpy(audio))
    return (jckv, jenc), (tckv, tenc)


def test_config_mirrors_the_reference_and_validates():
    """The full and smoke configs equal the reference's field for field and
    validate (the refusal of encoder-decoder models is gone); the port's
    model counts the reference's abstract init's parameters, its encoder and
    cross leaves included; an enc-dec config without an encoder is refused
    as the reference's ``validate`` refuses it."""
    assert ARCH in ARCH_IDS
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
            jax_lm.init(theirs, jax.random.key(0), abstract=True)[0]))
        assert lm.param_count(lm.LM(ours, device=torch.device("meta"))) == n_ref
    with pytest.raises(ValueError, match="encoder-decoder models need cfg.encoder"):
        get_smoke_config(ARCH, encoder=None)


def test_init_keeps_the_reference_layout_and_constant_starts():
    """``lm.init`` builds the encoder (stacked in the reference), each
    decoder layer's ``xattn`` and ``lnx`` and ``enc_extra``'s
    ``enc_ln_f``, leaf for leaf in the reference's tree, with its constant
    starts: LayerNorm scales at one, biases at zero."""
    cfg = get_smoke_config(ARCH, act_dtype="float32")
    model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ours = jax.tree_util.tree_flatten_with_path(convert.params_to_numpy(model))[0]
    theirs = jax.tree_util.tree_flatten_with_path(
        jax_lm.init(jax_smoke_config(ARCH), jax.random.key(0), abstract=True)[0])[0]
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    assert [a.shape for _, a in ours] == [a.shape for _, a in theirs]
    named = dict(model.named_parameters())
    assert {"encoder.1.attn.wq", "layers.0.xattn.wo", "layers.1.lnx_scale",
            "enc_extra.enc_ln_f_bias"} <= set(named)
    for name, p in named.items():
        if name.endswith("_scale"):
            assert bool((p == 1).all()), name
        elif name.endswith(("_bias", ".bi", ".bo")):
            assert bool((p == 0).all()), name


def test_forward_logits_match_the_reference(ref):
    """``forward`` over the tokens with ``batch["audio"]``: the encoder, the
    decoder's causal and cross attention, logits within ATOL; a batch
    without audio is refused with the expected shape."""
    params, _, model, audio, prompt = ref
    jcfg, tcfg = _cfgs()
    jlogits, _ = _forward(params, jcfg, {"tokens": jnp.asarray(prompt),
                                         "audio": jnp.asarray(audio)})
    tlogits, _ = lm.forward(model, tcfg, {"tokens": torch.from_numpy(prompt),
                                          "audio": torch.from_numpy(audio)})
    _close(tlogits, jlogits, "logits")
    with pytest.raises(ValueError, match=r"batch\['audio'\] of shape \(2, 8, 64\)"):
        lm.forward(model, tcfg, {"tokens": torch.from_numpy(prompt)})


def test_gradients_match_the_reference(ref):
    """One loss and its gradient (remat "block": the encoder's layers and
    the decoder's rematerialised): the loss within ATOL, every gradient
    finite, more than half the parameters with a nonzero gradient (as the
    reference's ``test_train_step_no_nans``), each leaf within ATOL of its
    largest |value|, the encoder's and the cross leaves included."""
    params, tree, _, audio, prompt = ref
    jcfg, tcfg = _cfgs(remat="block")
    labels = np.roll(prompt, -1, axis=1)
    batch = {"tokens": prompt, "labels": labels, "audio": audio}
    (jtotal, _), jgrads = _loss_grad(params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    total, _ = steps.loss_fn(model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    _close(total, jtotal, "loss")
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert sum(int((g != 0).sum()) for g in grads.values()) > 0.5 * lm.param_count(model)
    ours = jax.tree_util.tree_flatten_with_path(convert.named_to_tree(grads, tcfg.n_layers,
                                                                      stacked=True))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, g), (_, j) in zip(ours, theirs):
        j = np.asarray(j)
        err = float(np.abs(g - j).max())
        assert err <= ATOL * max(1.0, float(np.abs(j).max())), (jax.tree_util.keystr(path), err)


def test_precompute_cross_matches_the_reference(cross):
    """The encoder's output and every decoder layer's cross K/V, stacked
    (L, b, frames, kv, hd) as the reference's, within ATOL."""
    (jckv, jenc), (tckv, tenc) = cross
    _close(tenc, jenc, "enc_out")
    assert sorted(tckv) == ["ck", "cv"]
    for key in ("ck", "cv"):
        assert tuple(tckv[key].shape) == (2, B, 8, 4, 16)
        _close(tckv[key], jckv[key], key)


@pytest.mark.parametrize("pos", [0, 5])
def test_decode_step_with_cross_kv_matches_the_reference(ref, cross, pos):
    """One ``decode_step(cross_kv=)`` at a scalar position (the step's
    sinusoid computed on the device): logits (b, 1, vocab) finite and within
    ATOL, the written cache lines too; as the reference's
    ``test_encdec_decode``.  A (b,) position vector of the same value gives
    the scalar step's logits bit for bit."""
    params, _, model, _, _ = ref
    (jckv, _), (tckv, _) = cross
    jcfg, tcfg = _cfgs()
    tok = np.array([[3], [7]], np.int32)
    jcache, _ = jax_lm.init_cache(jcfg, B, 16)
    jlogits, jcache = _decode(params, jcfg, jcache, jnp.asarray(tok), jnp.int32(pos),
                              cross_kv=jckv)
    tcache = lm.init_cache(tcfg, B, 16, device="cpu")
    tlogits, tcache = lm.decode_step(model, tcfg, tcache, torch.from_numpy(tok), pos,
                                     cross_kv=tckv)
    assert tuple(tlogits.shape) == (B, 1, tcfg.vocab) and bool(torch.isfinite(tlogits).all())
    _close(tlogits, jlogits, "logits")
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], key)
    rows, _ = lm.decode_step(model, tcfg, lm.init_cache(tcfg, B, 16, device="cpu"),
                             torch.from_numpy(tok), torch.full((B,), pos, dtype=torch.int32),
                             cross_kv=tckv)
    assert torch.equal(rows, tlogits)


def test_prefill_equals_the_decode_loop_bit_for_bit(ref):
    """bf16, e2afs: ``prefill(cross_kv=)``'s last logits equal stepping
    ``decode_step(cross_kv=)`` over the prompt, bit for bit (the reference's
    ``test_prefill_encdec_with_cross_kv``), though prefill adds the float64
    position table and the step its float32 sinusoid."""
    _, tree, _, audio, prompt = ref
    cfg = get_smoke_config(ARCH, sqrt_unit="e2afs")
    model = convert.params_from_numpy(cfg, tree, device="cpu")
    ckv, _ = lm.precompute_cross(model, cfg, torch.from_numpy(audio))
    cache = lm.init_cache(cfg, B, 12, device="cpu")
    for i in range(S):
        loop, cache = lm.decode_step(model, cfg, cache, torch.from_numpy(prompt[:, i:i + 1]), i,
                                     cross_kv=ckv)
    pre, _ = lm.prefill(model, cfg, lm.init_cache(cfg, B, 12, device="cpu"),
                        torch.from_numpy(prompt), cross_kv=ckv)
    assert torch.equal(loop[:, -1], pre[:, -1])


def test_greedy_tokens_match_the_reference(ref, cross):
    """``prefill`` then ``generate_scan`` with ``cross_kv``: the prefill's
    last logits within ATOL and the greedy tokens identical to the JAX
    package's."""
    params, _, model, _, prompt = ref
    (jckv, _), (tckv, _) = cross
    jcfg, tcfg = _cfgs()
    jcache, _ = jax_lm.init_cache(jcfg, B, S + GEN)
    jlogits, jcache = _prefill(params, jcfg, jcache, jnp.asarray(prompt), cross_kv=jckv,
                               last_logit_only=True)
    jtoks, _, _ = _generate(params, jcfg, jcache, jnp.argmax(jlogits[:, -1:], -1), S, GEN,
                            cross_kv=jckv)
    tcache = lm.init_cache(tcfg, B, S + GEN, device="cpu")
    tlogits, tcache = lm.prefill(model, tcfg, tcache, torch.from_numpy(prompt), cross_kv=tckv,
                                 last_logit_only=True)
    ttoks, _, _ = lm.generate_scan(model, tcfg, tcache, tlogits[:, -1:].argmax(-1), S, GEN,
                                   cross_kv=tckv)
    _close(tlogits, jlogits, "prefill logits")
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def _slot_run(model, cfg, ckv_rows, prompts, admit_at, n_steps, slots=3):
    """Requests admitted into a pool of ``slots`` at the given steps
    (``prefill_into_slots`` with each request's cross K/V written into the
    pool's, in place), decoded one step at a time by ``decode_slots_scan``
    over the pool's cross K/V.  Returns each request's emitted tokens."""
    cache_len = 24
    pool = lm.init_pool_state(cfg, slots, cache_len, device="cpu")
    pool_ckv = {k: torch.zeros((t.shape[0], slots) + tuple(t.shape[2:]), dtype=t.dtype)
                for k, t in ckv_rows.items()}
    out = {r: [] for r in admit_at}
    where = {}
    for step in range(n_steps):
        for r, at in admit_at.items():
            if at == step:
                slot = len(where)
                where[r] = slot
                rows = {k: t[:, r:r + 1] for k, t in ckv_rows.items()}
                logits, _ = lm.prefill_into_slots(
                    model, cfg, pool["cache"], torch.from_numpy(prompts[r:r + 1]),
                    torch.tensor([slot]), cross_kv=rows, pool_cross_kv=pool_ckv)
                pool["tok"][slot] = logits[0, -1].argmax().to(torch.int32)
                pool["pos"][slot] = prompts.shape[1]
                pool["active"][slot] = True
                pool["remaining"][slot] = GEN
        toks, emitted = lm.decode_slots_scan(model, cfg, pool["cache"], pool["tok"], pool["pos"],
                                             pool["active"], pool["remaining"], 1,
                                             cross_kv=pool_ckv)[:2]
        for r, slot in where.items():
            if bool(emitted[slot, 0]):
                out[r].append(int(toks[slot, 0]))
    return out


def test_staggered_slots_equal_each_request_alone(ref, cross):
    """Two requests admitted at steps 0 and 3 into a pool of three slots,
    each with its own audio's cross K/V landed in the pool's rows: each
    emits exactly what it emits alone in the pool, and what
    ``generate_scan`` gives it at batch 1."""
    _, _, model, _, prompt = ref
    _, (tckv, _) = cross
    _, tcfg = _cfgs()
    both = _slot_run(model, tcfg, tckv, prompt, {0: 0, 1: 3}, 3 + GEN)
    for r in (0, 1):
        alone = _slot_run(model, tcfg, tckv, prompt, {r: 0}, GEN)[r]
        assert both[r] == alone and len(alone) == GEN
        rows = {k: t[:, r:r + 1] for k, t in tckv.items()}
        cache = lm.init_cache(tcfg, 1, S + GEN, device="cpu")
        logits, cache = lm.prefill(model, tcfg, cache, torch.from_numpy(prompt[r:r + 1]),
                                   cross_kv=rows, last_logit_only=True)
        solo, _, _ = lm.generate_scan(model, tcfg, cache, logits[:, -1:].argmax(-1), S, GEN,
                                      cross_kv=rows)
        assert solo[0].tolist() == alone


def test_params_and_checkpoints_cross_between_the_packages(ref, tmp_path):
    """``params_from_numpy`` then ``params_to_numpy`` gives the reference's
    tree back bit for bit, ``encoder`` stacked and ``enc_extra`` included;
    a checkpoint the port writes carries the reference's leaf names
    (``params_encoder_attn_wq``, ``params_enc_extra_enc_ln_f_scale``) and
    restores in the reference, and the reference's restores in the port."""
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import adamw_init

    params, tree, _, _, _ = ref
    _, tcfg = _cfgs()
    model = convert.params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    back = convert.params_to_numpy(model)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)

    checkpoint.save(tmp_path / "port", 2, {"params": back})
    names = [leaf["name"] for leaf in checkpoint.checkpoint.json.loads(
        (tmp_path / "port" / "step-2" / "manifest.json").read_text())["leaves"]]
    assert {"params_encoder_attn_wq", "params_enc_extra_enc_ln_f_scale",
            "params_layers_xattn_wk", "params_layers_lnx_bias"} <= set(names)
    out = jax_checkpoint.restore(tmp_path / "port", 2, {"params": params})
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(out["params"])[0], flat_a):
        np.testing.assert_array_equal(np.asarray(a), b)

    moved = jax.tree.map(lambda a: a + 0.5, params)
    jax_checkpoint.save(tmp_path / "ref", 4, {"params": moved, "opt": {"step": jnp.int32(4)}})
    fresh = lm.init(tcfg, torch.Generator().manual_seed(9), device="cpu", trainable=True)
    opt = adamw_init(fresh)
    like = ttrain.state_tree(fresh, opt)
    like = {"params": like["params"], "opt": {"step": like["opt"]["step"]}}
    restored = checkpoint.restore(tmp_path / "ref", 4, like)
    for name, a in convert.tree_to_named(restored["params"],
                                         dict(fresh.named_parameters())).items():
        np.testing.assert_array_equal(np.asarray(a), convert.tree_to_named(
            jax.tree.map(np.asarray, moved), [name])[name], err_msg=name)


def test_sinusoidal_decoder_verify_rows_equal_sequential_steps():
    """A decoder-only model with sinusoidal positions (qwen3-4b's smoke
    config, float32): each row of one ``decode_verify_step`` adds the
    sinusoid of its own position and equals the sequential ``decode_step``
    there, bit for bit."""
    cfg = get_smoke_config("qwen3-4b", act_dtype="float32", sqrt_unit="e2afs", pos="sinusoidal")
    model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, cfg.vocab, (B, 4), generator=torch.Generator().manual_seed(1))
    cache = lm.init_cache(cfg, B, 16, device="cpu")
    logits, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
    seq = lm.slot_rows_like(cfg, cache, B)
    for name in cache:
        seq[name].copy_(cache[name])
    tok, pos, fed, want = logits[:, -1].argmax(-1).to(torch.int32)[:, None], 4, [], []
    for _ in range(3):
        fed.append(tok)
        lg, _ = lm.decode_step(model, cfg, seq, tok, torch.full((B,), pos, dtype=torch.int32))
        want.append(lg[:, -1])
        tok, pos = lg[:, -1].argmax(-1).to(torch.int32)[:, None], pos + 1
    got, _ = lm.decode_verify_step(model, cfg, cache, torch.cat(fed, dim=1),
                                   torch.full((B,), 4, dtype=torch.int32))
    for j, w in enumerate(want):
        assert torch.equal(got[:, j], w), j


def test_speculation_refuses_encoder_decoder_models(ref):
    """As the reference: speculation covers attention-only decoder LMs, so
    ``Engine(spec=)`` and the spec scan refuse an encoder-decoder."""
    _, _, model, _, _ = ref
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="kind='encdec'"):
        Engine(model, tcfg, spec=SpecConfig(k=2))
    pool = lm.init_pool_state(tcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="attention-only decoder"):
        lm.decode_slots_spec_scan(model, tcfg, pool["cache"], pool["tok"], pool["pos"],
                                  pool["active"], pool["remaining"],
                                  torch.zeros((2, 16), dtype=torch.int32), 1, k=2)
