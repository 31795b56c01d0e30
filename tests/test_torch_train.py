"""The torch port's training forward and checkpoints held against the JAX
package: the loss and its gradients, remat, float32 masters, and
checkpoints in both directions.  The trainer is ``test_torch_trainer.py``.

Tolerances, with their reasons:

* loss and every parameter's gradient at the qwen3-4b smoke config
  (float32 activations, weights from the reference's ``lm.init``), with
  both the query-chunk and the loss-chunk loops running: s = 256 with the
  query chunk set to 64 and the loss chunk to 128 in both packages (the
  defaults, 1024, would need s = 2048, several times slower on the CPU for
  the same code paths).  The loss within 1e-6 relative; each gradient
  within 1e-5 of its leaf's largest |value| for "exact" (sums in another
  order) and 5e-5 for "e2afs" (both read about 1.2e-6, here and at the
  default chunks with s = 2048).  E2AFS's rsqrt steps at the mantissa MSB,
  so a row whose mean square lands one ulp apart in the two frameworks may
  move by a few percent there; the looser limit leaves room for one such
  crossing in a small leaf, and the test prints the reading;
* the same at gemma3-1b's smoke config (mixed window and global layers,
  the reference's list of layers, the window layers on the banded query
  chunks), e2afs within 2e-4, the sensitivity of one leaf of the
  reference itself (see the test);
* ``remat="block"`` and ``"minimal"`` against ``"none"`` in the port: equal
  gradients (the recomputed forward is the same arithmetic; at s = 256
  under torch's deterministic algorithms, which fix the order of the
  embedding's scattered sum); "minimal" against the reference's within the
  e2afs limit above;
* checkpoints: bit-identical, bfloat16 included, in both directions, for
  stacked and list-of-layers trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ck
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import steps as jax_steps
from repro.layers import attention as jax_attn
from repro.models import lm as jax_lm
from repro_torch import checkpoint as ck
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.layers import attention as attn
from repro_torch.models import convert, lm

S_LONG, Q_CHUNK, LOSS_CHUNK = 256, 64, 128

# the reference's loss and gradients, jitted (the config static): one XLA
# compile a config instead of eager dispatch of every primitive.  Every call
# runs under ``small_chunks``, so every trace sees the same chunk sizes.
_jax_loss_grad = jax.jit(jax.value_and_grad(jax_steps.loss_fn, has_aux=True), static_argnums=1)


@pytest.fixture(scope="module")
def jax_tree():
    params, _ = jax_lm.init(jax_smoke_config("qwen3-4b", act_dtype="float32"), jax.random.key(0))
    return params, jax.tree.map(np.asarray, params)


def _batch(vocab, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "loss_mask": (rng.random((b, s)) < 0.9).astype(np.float32)}


def _port_grads(tcfg, tree, batch):
    model = convert.params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    total, metrics = steps.loss_fn(model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    grads = convert.named_to_tree({n: p.grad for n, p in model.named_parameters()},
                                  tcfg.n_layers, stacked=tcfg.uniform)
    return float(total.detach()), metrics, grads


def _key(k):
    """A tree path entry's dict key or list index."""
    return getattr(k, "key", getattr(k, "idx", None))


def _gradient_errors(j_grads, t_grads):
    """{leaf path: max |port - reference| / max |reference|} over every leaf."""
    worst = {}
    for path, g_ref in jax.tree_util.tree_flatten_with_path(j_grads)[0]:
        node = t_grads
        for key in path:
            node = node[_key(key)]
        g_ref = np.asarray(g_ref)
        assert node.shape == g_ref.shape
        worst["/".join(str(_key(key)) for key in path)] = float(
            np.abs(node - g_ref).max() / np.abs(g_ref).max())
    return worst


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages' query chunk and loss chunk, cut so that s = 256 runs
    both chunk loops (restored after the test)."""
    for fn in (jax_attn.attention_train, attn.attention_train):
        monkeypatch.setitem(fn.__kwdefaults__, "q_chunk", Q_CHUNK)
    monkeypatch.setattr(jax_steps, "LOSS_CHUNK", LOSS_CHUNK)
    monkeypatch.setattr(steps, "LOSS_CHUNK", LOSS_CHUNK)


@pytest.mark.parametrize("unit,limit", [("exact", 1e-5), ("e2afs", 5e-5)])
def test_loss_and_gradients_match_the_reference(jax_tree, small_chunks, unit, limit):
    params, tree = jax_tree
    jcfg = jax_smoke_config("qwen3-4b", act_dtype="float32", sqrt_unit=unit)
    tcfg = get_smoke_config("qwen3-4b", act_dtype="float32", sqrt_unit=unit)
    batch = _batch(jcfg.vocab, 2, S_LONG)
    (j_total, j_metrics), j_grads = _jax_loss_grad(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    t_total, t_metrics, t_grads = _port_grads(tcfg, tree, batch)
    np.testing.assert_allclose(t_total, float(j_total), rtol=1e-6)
    np.testing.assert_allclose(float(t_metrics["loss"].detach()), float(j_metrics["loss"]),
                               rtol=1e-6)
    worst = _gradient_errors(j_grads, t_grads)
    print(f"{unit}: gradient error / leaf max: {worst}")
    assert max(worst.values()) <= limit, worst


@pytest.fixture(scope="module")
def gemma_tree():
    params, _ = jax_lm.init(jax_smoke_config("gemma3-1b", act_dtype="float32"), jax.random.key(0))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("unit,limit", [("exact", 1e-5), ("e2afs", 2e-4)])
def test_mixed_loss_and_gradients_match_the_reference(gemma_tree, small_chunks, unit, limit):
    """gemma3-1b's smoke config (five window layers of 8 to one global; the
    reference keeps its layers as a list): s = 256 with the query chunk cut
    to 64, so every window layer runs the banded chunks (a band of 8 + 64
    lines a chunk) and the global layer the full-width ones.  The loss
    within 1e-6 relative; each gradient within 1e-5 ("exact") of its leaf's
    largest |value|, as for qwen3-4b above.  "e2afs": 2e-4.  Its rsqrt
    steps at the mantissa MSB, and here one leaf is that sensitive: the
    reference's own gradient of layers/5/attn/wq moves by 1.10e-4 of its
    largest value when every embedding entry moves by one ulp (1.7e-6 with
    "exact"); the port reads 1.09e-4 there and at most 2.5e-5 elsewhere."""
    params, tree = gemma_tree
    jcfg = jax_smoke_config("gemma3-1b", act_dtype="float32", sqrt_unit=unit)
    tcfg = get_smoke_config("gemma3-1b", act_dtype="float32", sqrt_unit=unit)
    batch = _batch(jcfg.vocab, 2, S_LONG, seed=3)
    (j_total, _), j_grads = _jax_loss_grad(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    t_total, _, t_grads = _port_grads(tcfg, tree, batch)
    assert isinstance(t_grads["layers"], list) and len(t_grads["layers"]) == tcfg.n_layers
    np.testing.assert_allclose(t_total, float(j_total), rtol=1e-6)
    worst = _gradient_errors(j_grads, t_grads)
    print(f"{unit}: gradient error / leaf max: {worst}")
    assert max(worst.values()) <= limit, worst


@pytest.mark.parametrize("s,q_chunk", [(32, 8), (48, 16), (40, 40)])
def test_window_training_attention_matches_the_reference_layer(s, q_chunk):
    """attention_train in "window" mode (window 8) against the JAX layer,
    float32, with the banded chunks (q_chunk 8 and 16: bands of 16 and 24
    lines) and without (one chunk): out atol 1e-5, and the banded port
    equal to its own unchunked run within 1e-6."""
    jcfg = jax_smoke_config("gemma3-1b", act_dtype="float32", sqrt_unit="e2afs")
    tcfg = get_smoke_config("gemma3-1b", act_dtype="float32", sqrt_unit="e2afs")
    rng = np.random.default_rng(s)
    d, h, kv, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.d_head
    p = {"wq": rng.standard_normal((d, h, hd)) * 0.2, "wk": rng.standard_normal((d, kv, hd)) * 0.2,
         "wv": rng.standard_normal((d, kv, hd)) * 0.2, "wo": rng.standard_normal((h, hd, d)) * 0.1,
         "q_norm": rng.standard_normal(hd) * 0.1, "k_norm": rng.standard_normal(hd) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    module = attn.Attention(tcfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, value in p.items():
            getattr(module, name).copy_(torch.from_numpy(value))
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    ref = jax_attn.attention_train({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                                   jnp.asarray(x), mode="window", window=8, q_chunk=q_chunk)
    ours = attn.attention_train(module, tcfg, torch.from_numpy(x), mode="window", window=8,
                                q_chunk=q_chunk)
    whole = attn.attention_train(module, tcfg, torch.from_numpy(x), mode="window", window=8,
                                 q_chunk=s)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.detach().numpy(), whole.detach().numpy(), atol=1e-6, rtol=0)


def test_mixed_params_round_trip_through_the_reference_layout(gemma_tree):
    """A mixed model's tree is the reference's list of per-layer dicts, both
    ways, leaf for leaf."""
    _, tree = gemma_tree
    cfg = get_smoke_config("gemma3-1b", act_dtype="float32")
    model = convert.params_from_numpy(cfg, tree, device="cpu", trainable=True)
    assert not model.stacked
    back = convert.params_to_numpy(model)
    assert isinstance(back["layers"], list)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_mixed_training_state_checkpoints_cross_between_the_packages(tmp_path, gemma_tree):
    """A gemma3-1b training state written by the port restores in the
    reference under its ``layers_<i>_...`` leaf names, and one written by
    the reference restores in the port's trainer state, bit for bit."""
    from repro.optim.adamw import adamw_init as jax_adamw_init
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import adamw_init

    params, tree = gemma_tree
    cfg = get_smoke_config("gemma3-1b", act_dtype="float32")
    model = convert.params_from_numpy(cfg, tree, device="cpu", trainable=True)
    opt = adamw_init(model)
    with torch.no_grad():
        for i, t in enumerate(opt["m"].values()):
            t.fill_(0.5 + i)
    ck.save(tmp_path / "port", 3, ttrain.state_tree(model, opt))
    names = [leaf["name"] for leaf in ck.checkpoint.json.loads(
        (tmp_path / "port" / "step-3" / "manifest.json").read_text())["leaves"]]
    assert "params_layers_5_attn_wq" in names and "opt_m_layers_0_mlp_wo" in names
    j_state = {"params": params, "opt": jax_adamw_init(params)}
    out = jax_ck.restore(tmp_path / "port", 3, j_state)
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(out["params"])[0],
                              jax.tree_util.tree_flatten_with_path(tree)[0]):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(out["opt"]["m"]["layers"][0]["mlp"]["wo"]),
                                  opt["m"]["layers.0.mlp.wo"].numpy())

    j_state["opt"]["v"] = jax.tree.map(lambda a: a + 0.25, j_state["opt"]["v"])
    jax_ck.save(tmp_path / "ref", 4, j_state)
    fresh = lm.init(cfg, torch.Generator().manual_seed(9), device="cpu", trainable=True)
    fresh_opt = adamw_init(fresh)
    like = ttrain.state_tree(fresh, fresh_opt)
    ttrain.load_state(fresh, fresh_opt, ck.restore(tmp_path / "ref", 4, like))
    for name, p in fresh.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      convert.tree_to_named(tree, [name])[name])
    assert float(fresh_opt["v"]["layers.3.attn.wk"].min()) == 0.25


def test_remat_block_equals_none():
    cfg = get_smoke_config("qwen3-4b", act_dtype="float32", sqrt_unit="e2afs", remat="none")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, 2, 64, seed=1).items()}
    grads = []
    for remat in ("none", "block"):
        c = cfg.replace(remat=remat)
        model = lm.init(c, torch.Generator().manual_seed(5), device="cpu", trainable=True)
        total, _ = steps.loss_fn(model, c, batch)
        total.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for the test: the embedding's
    scattered gradient (``index_put_`` with accumulation) otherwise sums
    its duplicate tokens in a varying order on the CPU at s = 256."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def test_remat_minimal_equals_none_and_the_reference(jax_tree, small_chunks, deterministic):
    """``remat="minimal"`` (the attention scores recomputed in the backward,
    through both chunk loops at s = 256) gives the port's "none" gradients
    bit for bit, and the reference's "minimal" gradients within this file's
    e2afs limit."""
    params, tree = jax_tree
    batch = _batch(jax_smoke_config("qwen3-4b").vocab, 2, S_LONG, seed=2)
    grads = {}
    for remat in ("none", "minimal"):
        cfg = get_smoke_config("qwen3-4b", act_dtype="float32", sqrt_unit="e2afs", remat=remat)
        total, _, grads[remat] = _port_grads(cfg, tree, batch)
    flat_none, tree_none = jax.tree_util.tree_flatten_with_path(grads["none"])
    flat_min, tree_min = jax.tree_util.tree_flatten_with_path(grads["minimal"])
    assert tree_none == tree_min
    for (path, a), (_, b) in zip(flat_none, flat_min):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    jcfg = jax_smoke_config("qwen3-4b", act_dtype="float32", sqrt_unit="e2afs", remat="minimal")
    (j_total, _), j_grads = _jax_loss_grad(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(total, float(j_total), rtol=1e-6)
    worst = _gradient_errors(j_grads, grads["minimal"])
    assert max(worst.values()) <= 5e-5, worst


def test_forward_returns_the_padded_vocab_and_trains_float32_masters():
    cfg = get_smoke_config("qwen3-4b", sqrt_unit="e2afs", vocab=250)  # padded to 256
    model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu", trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    logits, aux = lm.forward(model, cfg, {"tokens": tokens})
    assert logits.shape == (2, 16, cfg.padded_vocab) and logits.dtype == torch.bfloat16
    assert float(aux["moe_aux"]) == 0.0
    serving = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in serving.parameters())


def test_validate_rejects_an_unknown_remat():
    assert get_smoke_config("qwen3-4b", remat="minimal").remat == "minimal"
    with pytest.raises(ValueError, match="unknown remat 'selective'"):
        get_smoke_config("qwen3-4b", remat="selective")


def test_params_round_trip_through_the_reference_layout(jax_tree):
    _, tree = jax_tree
    cfg = get_smoke_config("qwen3-4b", act_dtype="float32")
    back = convert.params_to_numpy(convert.params_from_numpy(cfg, tree, device="cpu",
                                                             trainable=True))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints (ports of tests/substrates/test_checkpoint.py's cases)
# ---------------------------------------------------------------------------


@pytest.fixture
def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)},
            "opt": {"m": torch.zeros(3, 4), "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(t):
    return [leaf for _, leaf in ck.checkpoint._flatten(t)]


def test_checkpoint_round_trip(tmp_path, tree):
    ck.save(tmp_path, 5, tree)
    out = ck.restore(tmp_path, 5, tree)
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_latest_step(tmp_path, tree):
    assert ck.latest_step(tmp_path) is None
    for step in (1, 10, 3):
        ck.save(tmp_path, step, tree)
    assert ck.latest_step(tmp_path) == 10


def test_checkpoint_partial_write_is_invisible(tmp_path, tree):
    ck.save(tmp_path, 2, tree)
    (tmp_path / "tmp-9").mkdir()
    (tmp_path / "step-9").mkdir()  # no manifest: incomplete
    assert ck.latest_step(tmp_path) == 2


def test_checkpoint_async_then_restore(tmp_path, tree):
    ck.save_async(tmp_path, 4, tree).join()
    out = ck.restore(tmp_path, 4, tree)
    assert torch.equal(out["params"]["w"], tree["params"]["w"])


def test_checkpoint_idempotent_save(tmp_path, tree):
    assert ck.save(tmp_path, 6, tree) == ck.save(tmp_path, 6, tree)


def test_checkpoint_stale_tmp_swept(tmp_path, tree):
    ck.save(tmp_path, 2, tree)
    stale = tmp_path / "tmp-7"
    stale.mkdir()
    (stale / "params_w.npy").write_bytes(b"half a leaf")
    assert ck.latest_step(tmp_path) == 2 and not stale.exists()
    stale.mkdir()
    ck.save(tmp_path, 8, tree)
    assert not stale.exists() and ck.latest_step(tmp_path) == 8


def test_checkpoint_async_error_reraised(tmp_path, tree):
    ck.wait_pending()
    clash = tmp_path / "ck"
    clash.write_text("not a directory")
    ck.save_async(clash, 1, tree).join()
    with pytest.raises(ck.CheckpointError, match="step 1"):
        ck.wait_pending()
    ck.wait_pending()  # delivered once


def test_checkpoint_missing_step_names_latest(tmp_path, tree):
    ck.save(tmp_path, 3, tree)
    with pytest.raises(ck.CheckpointError, match=r"step-9.*latest committed step.*3"):
        ck.restore(tmp_path, 9, tree)


@pytest.mark.parametrize("damage,match", [
    ("delete", r"torn.*params_w\.npy"),
    ("corrupt", r"params_w\.npy.*unreadable"),
])
def test_checkpoint_torn_or_corrupt_leaf_named(tmp_path, tree, damage, match):
    ck.save(tmp_path, 5, tree)
    leaf = tmp_path / "step-5" / "params_w.npy"
    if damage == "delete":
        leaf.unlink()
    else:
        leaf.write_bytes(b"\x00\x01garbage")
    with pytest.raises(ck.CheckpointError, match=match):
        ck.restore(tmp_path, 5, tree)


def test_checkpoint_shape_mismatch_names_leaf(tmp_path, tree):
    ck.save(tmp_path, 5, tree)
    wrong = {"params": {"w": torch.zeros(2, 2), "b": torch.ones(4)}, "opt": tree["opt"]}
    with pytest.raises(ck.CheckpointError, match=r"params_w.*shape"):
        ck.restore(tmp_path, 5, wrong)


def test_checkpoint_ignores_extra_leaves(tmp_path, tree):
    ck.save(tmp_path, 5, {**tree, "extra": torch.arange(3)})
    out = ck.restore(tmp_path, 5, tree)
    assert "extra" not in out and torch.equal(out["params"]["w"], tree["params"]["w"])


def test_checkpoint_bf16_round_trip_and_no_shardings(tmp_path):
    t16 = {"w": torch.arange(8.0, dtype=torch.bfloat16) / 3, "i": torch.arange(3)}
    ck.save(tmp_path, 1, t16)
    out = ck.restore(tmp_path, 1, t16)
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], t16["w"])
    assert torch.equal(out["i"], t16["i"])
    # restoring onto shardings takes a Sharding a leaf (held on a mesh in
    # tests/test_torch_mesh.py); anything else is refused, naming the leaf
    # (leaves in sorted order: 'i' first)
    with pytest.raises(TypeError, match="leaf 'i' is NoneType, not a"):
        ck.restore(tmp_path, 1, t16, shardings={"w": None, "i": None})


def _cross_tree(seed):
    rng = np.random.default_rng(seed)
    w16 = rng.standard_normal((5, 7)).astype(np.float32)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32), "w16": w16},
            "opt": {"step": np.int32(9)}}


def test_a_step_written_by_the_reference_restores_in_the_port(tmp_path):
    src = _cross_tree(0)
    jtree = {"params": {"w": jnp.asarray(src["params"]["w"]),
                        "w16": jnp.asarray(src["params"]["w16"]).astype(jnp.bfloat16)},
             "opt": {"step": jnp.int32(9)}}
    jax_ck.save(tmp_path, 3, jtree)
    like = {"params": {"w": torch.zeros(3, 4), "w16": torch.zeros(5, 7, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    out = ck.restore(tmp_path, 3, like)
    np.testing.assert_array_equal(out["params"]["w"].numpy(), src["params"]["w"])
    want16 = np.asarray(jtree["params"]["w16"]).view(np.int16)
    np.testing.assert_array_equal(out["params"]["w16"].view(torch.int16).numpy(), want16)
    assert int(out["opt"]["step"]) == 9


def test_a_step_written_by_the_port_restores_in_the_reference(tmp_path):
    src = _cross_tree(1)
    ptree = {"params": {"w": torch.from_numpy(src["params"]["w"]),
                        "w16": torch.from_numpy(src["params"]["w16"]).to(torch.bfloat16)},
             "opt": {"step": torch.tensor(9, dtype=torch.int32)}}
    ck.save(tmp_path, 3, ptree)
    like = {"params": {"w": jnp.zeros((3, 4)), "w16": jnp.zeros((5, 7), jnp.bfloat16)},
            "opt": {"step": jnp.int32(0)}}
    out = jax_ck.restore(tmp_path, 3, like)
    np.testing.assert_array_equal(np.asarray(out["params"]["w"]), src["params"]["w"])
    assert out["params"]["w16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["params"]["w16"]).view(np.int16),
                                  ptree["params"]["w16"].view(torch.int16).numpy())
    assert int(out["opt"]["step"]) == 9
