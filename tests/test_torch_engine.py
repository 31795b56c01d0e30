"""The torch port's slot pool and continuous-batching engine held against the
JAX package.

Both packages run the smoke configs of qwen3-4b (a uniform stack) and
gemma3-1b (five window layers of 8 to one global: ring caches) in float32
with ``sqrt_unit="e2afs"``; the reference's weights cross over through
``convert.params_from_numpy``, and prompts are drawn with numpy.  The JAX
side runs as its own tests and engine run it: admission through
``lm.prefill_into_slots``, the decode chunk as a jitted
``lm.decode_slots_scan``, and ``solo_generate`` as the parity reference.
The port runs its plain versions on the CPU (its CUDA graph of the chunk is
held on the card by ``tests/test_torch_gpu.py``).

Tolerances: greedy tokens, emission masks and the pool's vectors identical;
``prefill_into_slots`` logits atol 1e-4 and cache rows atol 1e-5 (sums in
another order), int8 codes identical (``test_prefill_logits_and_cache``'s
limits).  Sampling cannot match ``jax.random``'s bits (ROADMAP C.15), so it
is held by its properties: reproducible across slots and runs, ``top_k=1``
equal to greedy, and the Gumbel-max law.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.engine import solo_generate as jax_solo_generate
from repro.models import lm as jax_lm
from repro_torch.configs import get_smoke_config
from repro_torch.launch import engine
from repro_torch.launch.engine import Engine, Request, run_static_baseline, solo_generate
from repro_torch.models import convert, lm

ARCHS = ("qwen3-4b", "gemma3-1b")
POOL_CACHE = 32


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX cfg, JAX params, port cfg, port model), the port's
    model built from the reference's weights; each made once."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = jax_smoke_config(arch, act_dtype="float32", sqrt_unit="e2afs")
            params, _ = jax_lm.init(jcfg, jax.random.key(0))
            tcfg = get_smoke_config(arch, act_dtype="float32", sqrt_unit="e2afs")
            model = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                              device="cpu")
            made[arch] = (jcfg, params, tcfg, model)
        return made[arch]

    return get


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(cache):
    """Cache leaves of either form, as (path, array) pairs in one order."""
    layers = cache if isinstance(cache, list) else [cache]
    return [(f"{i}/{name}", layer[name]) for i, layer in enumerate(layers)
            for name in sorted(layer)]


_DTYPES = {"int32": torch.int32, "bool": torch.bool, "uint32": torch.uint32,
           "float32": torch.float32, "int8": torch.int8, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# Pool primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_pool_state_and_rows_take_the_references_layout(arch, quantized):
    """``init_pool_state`` and ``slot_rows_like`` give the reference's shapes
    and dtypes (a uniform stack's batch on axis 1, a mixed stack's per-layer
    list on axis 0), and ``insert_cache_slots`` lands the same rows where the
    reference does, in place."""
    kw = dict(act_dtype="float32", sqrt_unit="e2afs")
    jcfg, tcfg = jax_smoke_config(arch, **kw), get_smoke_config(arch, **kw)
    jpool = jax_lm.init_pool_state(jcfg, 3, 20, quantized=quantized)
    tpool = lm.init_pool_state(tcfg, 3, 20, quantized=quantized, device="cpu")
    assert set(tpool) == set(jpool)
    for name in ("tok", "pos", "active", "remaining", "keys"):
        assert tuple(tpool[name].shape) == jpool[name].shape, name
        assert tpool[name].dtype == _DTYPES[str(jpool[name].dtype)], name
    jleaves, tleaves = _leaves(jpool["cache"]), _leaves(tpool["cache"])
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape and t.dtype == _DTYPES[str(j.dtype)], path
    jrows = jax_lm.slot_rows_like(jcfg, jpool["cache"], 2)
    trows = lm.slot_rows_like(tcfg, tpool["cache"], 2)
    rng = np.random.default_rng(0)
    for (path, t), (_, j) in zip(_leaves(trows), _leaves(jrows)):
        assert tuple(t.shape) == j.shape and t.dtype == _DTYPES[str(j.dtype)], path
        t.copy_(torch.from_numpy(rng.integers(-100, 100, t.shape).astype(np.float32)))
    jrows = jax.tree.map(jnp.asarray, _tree_like(jrows, trows))
    addresses = [t.data_ptr() for _, t in _leaves(tpool["cache"])]
    jcache = jax_lm.insert_cache_slots(jcfg, jpool["cache"], jrows, [2, 0])
    tcache = lm.insert_cache_slots(tcfg, tpool["cache"], trows, torch.tensor([2, 0]))
    assert tcache is tpool["cache"]
    assert [t.data_ptr() for _, t in _leaves(tcache)] == addresses
    for (path, t), (_, j) in zip(_leaves(tcache), _leaves(jcache)):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32), err_msg=path)


def _tree_like(jtree, ttree):
    """The port's cache rows as numpy, in the reference's tree form."""
    if isinstance(ttree, list):
        return [{k: v.numpy() for k, v in layer.items()} for layer in ttree]
    return {k: v.numpy() for k, v in ttree.items()}


@pytest.mark.parametrize("arch,quantized", [("qwen3-4b", False), ("qwen3-4b", True),
                                            ("gemma3-1b", False)])
def test_prefill_into_slots_logits_and_rows(models, arch, quantized):
    """Two prompts of 12 admitted into slots (3, 1) of a 4-slot pool of 28
    lines (past gemma3-1b's smoke window of 8, so its rings wrap): logits
    atol 1e-4, the landed rows atol 1e-5 (int8 codes identical), every other
    row still zero."""
    jcfg, params, tcfg, model = models(arch)
    prompt = np.stack([_prompt(jcfg.vocab, 12, 5), _prompt(jcfg.vocab, 12, 6)])
    jcache, _ = jax_lm.init_cache(jcfg, 4, 28, quantized=quantized)
    tcache = lm.init_cache(tcfg, 4, 28, quantized=quantized, device="cpu")
    jlog, jcache = jax_lm.prefill_into_slots(params, jcfg, jcache, jnp.asarray(prompt),
                                             jnp.asarray([3, 1]))
    tlog, tcache = lm.prefill_into_slots(model, tcfg, tcache, torch.from_numpy(prompt),
                                         torch.tensor([3, 1]))
    assert tuple(tlog.shape) == (2, 1, jcfg.vocab)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=1e-4, rtol=0)
    ax = 1 if tcfg.uniform else 0
    for (path, t), (_, j) in zip(_leaves(tcache), _leaves(jcache)):
        atol = 0 if quantized and path.endswith(("/k", "/v")) else 1e-5
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol,
                                   rtol=0, err_msg=path)
        assert not t.index_select(ax, torch.tensor([0, 2])).any(), path


# ---------------------------------------------------------------------------
# Slot-scheduled decode: staggered admissions against the JAX package
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg, steps, eos_id):
    """The reference's decode chunk as its engine runs it: one jit."""
    return jax.jit(lambda p, c, tok, pos, act, rem: jax_lm.decode_slots_scan(
        p, jcfg, c, tok, pos, act, rem, steps, eos_id=eos_id))


class _JaxPool:
    """The reference's pool driven by hand (as ``test_engine_slots.py``)."""

    def __init__(self, cfg, params, num_slots, quantized):
        self.cfg, self.params = cfg, params
        st = jax_lm.init_pool_state(cfg, num_slots, POOL_CACHE, quantized=quantized)
        self.cache, self.tok, self.pos = st["cache"], st["tok"], st["pos"]
        self.active, self.remaining = st["active"], st["remaining"]

    def admit(self, prompt, slot, budget):
        logits, self.cache = jax_lm.prefill_into_slots(self.params, self.cfg, self.cache,
                                                       jnp.asarray(prompt)[None],
                                                       jnp.asarray([slot]))
        self.tok = self.tok.at[slot, 0].set(jnp.argmax(logits[0, -1]).astype(jnp.int32))
        self.pos = self.pos.at[slot].set(len(prompt))
        self.active = self.active.at[slot].set(True)
        self.remaining = self.remaining.at[slot].set(budget)

    def decode(self, steps, eos_id):
        toks, emitted, self.tok, self.pos, self.active, self.remaining, self.cache = (
            _jax_decode(self.cfg, steps, eos_id)(self.params, self.cache, self.tok, self.pos,
                                                 self.active, self.remaining))
        return np.asarray(toks), np.asarray(emitted)

    def vectors(self):
        return [np.asarray(a) for a in (self.tok, self.pos, self.active, self.remaining)]


class _TorchPool:
    """The port's pool driven the same way through its own primitives."""

    def __init__(self, cfg, model, num_slots, quantized):
        self.cfg, self.model = cfg, model
        self.st = lm.init_pool_state(cfg, num_slots, POOL_CACHE, quantized=quantized,
                                     device="cpu")

    def admit(self, prompt, slot, budget):
        st = self.st
        logits, _ = lm.prefill_into_slots(self.model, self.cfg, st["cache"],
                                          torch.from_numpy(prompt)[None], torch.tensor([slot]))
        st["tok"][slot] = logits[0, -1].argmax().to(torch.int32)
        st["pos"][slot] = len(prompt)
        st["active"][slot] = True
        st["remaining"][slot] = budget

    def decode(self, steps, eos_id):
        st = self.st
        toks, emitted, *_ = lm.decode_slots_scan(self.model, self.cfg, st["cache"], st["tok"],
                                                 st["pos"], st["active"], st["remaining"],
                                                 steps, eos_id=eos_id)
        return toks.numpy(), emitted.numpy()

    def vectors(self):
        return [self.st[k].numpy().copy() for k in ("tok", "pos", "active", "remaining")]


def _expected(solo, eos):
    """A request's tokens under EOS early exit: its solo run up to and
    including the first EOS."""
    hit = np.flatnonzero(solo == eos)
    return solo[: hit[0] + 1] if len(hit) else solo


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_staggered_slots_match_the_reference_and_solo_runs(models, arch, quantized):
    """One two-slot scenario a model and cache type: S (prompt 3, budget 5)
    in slot 1; four steps later L (prompt 12, past gemma3-1b's window of 8)
    joins in slot 0 mid-decode, and S runs out of budget one step after;
    once L has spent its budget, R (prompt 4) takes L's slot (its 12 + 6
    lines of KV stale behind R's 4) and stops at the EOS, a token of R's
    solo run that S's and L's do not emit.  The port's tokens, emission
    masks and pool vectors equal the reference's at every chunk, and each
    request's tokens equal its JAX ``solo_generate`` run; the budget-spent
    slot's pending token is the next token of its solo run."""
    jcfg, params, tcfg, model = models(arch)
    S, L, R = (_prompt(jcfg.vocab, n, seed) for n, seed in ((3, 1), (12, 2), (4, 3)))

    def solo(prompt, n):
        return jax_solo_generate(params, jcfg, prompt, n, cache_len=POOL_CACHE,
                                 quantized_kv=quantized)

    sol_s, sol_l, sol_r = solo(S, 5), solo(L, 7), solo(R, 6)
    eos = next(int(t) for t in sol_r[1:] if t not in sol_s and t not in sol_l[:6])
    runs = []
    for pool in (_JaxPool(jcfg, params, 2, quantized), _TorchPool(tcfg, model, 2, quantized)):
        chunks = []
        pool.admit(S, 1, 5)
        chunks.append(pool.decode(4, eos))
        pool.admit(L, 0, 6)
        chunks.append(pool.decode(4, eos))
        chunks.append(pool.decode(4, eos))
        after_l = pool.vectors()
        pool.admit(R, 0, 6)
        chunks.append(pool.decode(4, eos))
        runs.append((chunks, after_l, pool.vectors()))
    (jchunks, jafter, jend), (tchunks, tafter, tend) = runs
    for i, ((jt, je), (tt, te)) in enumerate(zip(jchunks, tchunks)):
        np.testing.assert_array_equal(tt, jt, err_msg=f"chunk {i} tokens")
        np.testing.assert_array_equal(te, je, err_msg=f"chunk {i} emitted")
    for mine, want in zip(tafter + tend, jafter + jend):
        np.testing.assert_array_equal(mine, want)
    toks = np.concatenate([t for t, _ in tchunks], axis=1)
    emitted = np.concatenate([e for _, e in tchunks], axis=1)
    slot1 = toks[1][emitted[1]]
    np.testing.assert_array_equal(slot1, sol_s)  # the whole budget, no EOS in it
    slot0 = toks[0][emitted[0]]
    np.testing.assert_array_equal(slot0[:6], sol_l[:6])
    np.testing.assert_array_equal(slot0[6:], _expected(sol_r, eos))
    assert len(slot0[6:]) < 6  # R stopped at its EOS, before its budget
    assert int(tafter[0][0, 0]) == int(sol_l[6])  # L's pending token chains on
    assert not tend[2].any()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _requests(vocab, n, *, seed=0, prompts=(3, 5), gens=(2, 4, 7)):
    """The trace of ``tests/launch/test_engine.py::_requests``."""
    rng = np.random.RandomState(seed)
    return [Request(uid=i,
                    prompt=rng.randint(0, vocab, size=int(rng.choice(prompts))).astype(np.int32),
                    max_new_tokens=int(rng.choice(gens)), arrival_s=float(i) * 1e-3)
            for i in range(n)]


@pytest.fixture(scope="module")
def qwen(models):
    _, _, tcfg, model = models("qwen3-4b")
    return tcfg, model


def _solo(model, cfg, req, cache_len=24):
    return solo_generate(model, cfg, req.prompt, req.max_new_tokens, cache_len=cache_len)


def test_engine_serves_the_trace_token_exact_against_the_reference(models):
    """Seven requests of mixed lengths through two slots: every request
    completes with its budget, and its tokens equal the JAX package's
    ``solo_generate`` (and the port's own)."""
    jcfg, params, tcfg, model = models("qwen3-4b")
    reqs = _requests(tcfg.vocab, 7)
    eng = Engine(model, tcfg, num_slots=2, cache_len=24, chunk=3)
    eng.warmup(prompt_lens={3, 5})
    done = eng.run(reqs)
    assert set(done) == {r.uid for r in reqs}
    for r in reqs:
        c = done[r.uid]
        assert c.status == "ok" and c.prompt_len == len(r.prompt)
        assert c.finished_s >= c.admitted_s >= 0.0
        want = jax_solo_generate(params, jcfg, r.prompt, r.max_new_tokens, cache_len=24)
        np.testing.assert_array_equal(c.tokens, want)
        np.testing.assert_array_equal(_solo(model, tcfg, r), want)
    assert eng.stats["n_requests"] == 7 and eng.stats["n_ok"] == 7
    assert eng.stats["total_tokens"] == sum(r.max_new_tokens for r in reqs)
    assert eng.stats["decode_chunks"] > 0 and eng.stats["tok_s"] > 0


def test_engine_eos_truncates_completion(qwen):
    cfg, model = qwen
    probe = Request(uid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=8)
    solo = _solo(model, cfg, probe)
    eos = int(solo[2])
    stop = int(np.flatnonzero(solo == eos)[0])
    reqs = [probe, Request(uid=1, prompt=np.arange(5, dtype=np.int32), max_new_tokens=3)]
    eng = Engine(model, cfg, num_slots=1, cache_len=24, chunk=4, eos_id=eos)
    done = eng.run(reqs)
    np.testing.assert_array_equal(done[0].tokens, solo[: stop + 1])
    assert 1 <= len(done[1].tokens) <= 3  # served after slot 0 freed early


def test_engine_reset_allows_reuse(qwen):
    cfg, model = qwen
    reqs = _requests(cfg.vocab, 3)
    eng = Engine(model, cfg, num_slots=2, cache_len=24, chunk=3)
    a = eng.run(reqs)
    eng.reset()
    assert all(not t.any() for t in lm.pool_tensors(eng.pool))
    b = eng.run(reqs)
    for uid in a:
        np.testing.assert_array_equal(a[uid].tokens, b[uid].tokens)


def test_engine_validation_names_request_and_field(qwen):
    """Malformed requests are rejected before any slot state is touched,
    naming the request and the field, even behind a valid request."""
    cfg, model = qwen
    eng = Engine(model, cfg, num_slots=1, cache_len=24, chunk=2)
    good = Request(uid=1, prompt=np.arange(3, dtype=np.int32), max_new_tokens=2)
    cases = [
        (Request(uid=40, prompt=np.zeros(0, np.int32), max_new_tokens=2),
         r"request 40: field 'prompt' needs >= 1 prompt token"),
        (Request(uid=41, prompt=np.zeros(2, np.int32), max_new_tokens=0),
         r"request 41: field 'max_new_tokens'.*budget"),
        (Request(uid=42, prompt=np.zeros((2, 2), np.int32), max_new_tokens=2),
         r"request 42: field 'prompt'.*1-D"),
        (Request(uid=43, prompt=np.zeros(3, np.float32), max_new_tokens=2),
         r"request 43: field 'prompt'.*integer"),
        (Request(uid=44, prompt=np.arange(3, dtype=np.int32), max_new_tokens=2.5),
         r"request 44: field 'max_new_tokens'"),
        (Request(uid=45, prompt=np.arange(3, dtype=np.int32), max_new_tokens=2,
                 deadline_s=-1.0),
         r"request 45: field 'deadline_s'"),
        (Request(uid=46, prompt=np.zeros(20, np.int32), max_new_tokens=8),
         r"request 46: .*exceeds the dense cache_len \(24\)"),
    ]
    for bad, pattern in cases:
        with pytest.raises(ValueError, match=pattern):
            eng.run([good, bad])
        assert all(o is None for o in eng._owner) and not any(eng._emitted)
        assert not eng.pool["active"].any()
        eng.reset()


def test_engine_takes_only_the_plain_options(qwen):
    """The pool shape is checked; the reference's options are taken:
    speculation's (``tests/test_torch_spec.py``) and the mesh's, None being
    the one-device engine (``tests/test_torch_mesh.py`` holds a mesh); an
    unknown keyword is refused; the statuses are the reference's five."""
    cfg, model = qwen
    with pytest.raises(ValueError, match="num_slots"):
        Engine(model, cfg, num_slots=0, cache_len=24)
    with pytest.raises(TypeError):
        Engine(model, cfg, num_slots=1, cache_len=24, mesh_shape=(2, 2))
    eng = Engine(model, cfg, num_slots=1, cache_len=24, spec=None, draft_model=None,
                 mesh=None, rules=None)
    assert eng.spec is None and eng.mesh is None
    assert engine.STATUSES == ("ok", "degraded", "evicted", "failed", "rejected")


def test_window_only_stack_may_outgrow_the_cache(qwen):
    """A stack with no global layer is sub-quadratic: its rings wrap, so a
    request longer than the cache is accepted (the dense check applies only
    where a global layer needs every line)."""
    cfg, _ = qwen
    window = cfg.replace(block_pattern=("window",), window=6).validate()
    assert window.is_subquadratic and not cfg.is_subquadratic
    model = lm.init(window, device="cpu")
    eng = Engine(model, window, num_slots=1, cache_len=8, chunk=4)
    done = eng.run([Request(uid=0, prompt=np.arange(7, dtype=np.int32), max_new_tokens=6)])
    assert done[0].status == "ok" and len(done[0].tokens) == 6


def test_engine_global_deadline_returns_partial_results(qwen):
    """Global deadline expiry evicts instead of raising: finished work is
    kept, a request arriving after the deadline comes back empty and never
    admitted.  The idle pool waits for the deadline, not the late arrival."""
    cfg, model = qwen
    reqs = [Request(uid=0, prompt=np.arange(3, dtype=np.int32), max_new_tokens=4),
            Request(uid=1, prompt=np.arange(3, dtype=np.int32), max_new_tokens=4,
                    arrival_s=120.0)]
    eng = Engine(model, cfg, num_slots=1, cache_len=24, chunk=2)
    done = eng.run(reqs, deadline_s=1.0)
    assert done[0].status == "ok" and len(done[0].tokens) == 4
    assert done[1].status == "evicted"
    assert len(done[1].tokens) == 0 and done[1].admitted_s == -1.0
    assert eng.stats["deadline_expired"] and eng.stats["makespan_s"] < 60.0
    assert eng.stats["n_ok"] == 1 and eng.stats["n_evicted"] == 1


def test_engine_per_request_deadline_evicts_only_that_request(qwen):
    cfg, model = qwen
    doomed = Request(uid=0, prompt=np.arange(3, dtype=np.int32), max_new_tokens=4,
                     deadline_s=1e-9)
    healthy = Request(uid=1, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4)
    eng = Engine(model, cfg, num_slots=2, cache_len=24, chunk=2)
    done = eng.run([doomed, healthy])
    assert done[0].status == "evicted" and done[1].status == "ok"
    np.testing.assert_array_equal(done[1].tokens, _solo(model, cfg, healthy))


def test_static_baseline_completes_all(qwen):
    cfg, model = qwen
    reqs = _requests(cfg.vocab, 5)
    done, stats = run_static_baseline(model, cfg, reqs, num_slots=2)
    assert set(done) == {r.uid for r in reqs}
    for r in reqs:
        assert len(done[r.uid].tokens) == r.max_new_tokens
    assert stats["n_groups"] == 3 and stats["n_requests"] == 5 and stats["tok_s"] > 0


def test_queue_ordering_tie_breaks_by_uid(qwen):
    """Equal arrivals are served in uid order: with one slot, admission
    times rise with uid, and the tokens still equal each solo run."""
    cfg, model = qwen
    reqs = [Request(uid=u, prompt=np.arange(3, dtype=np.int32) + u, max_new_tokens=2)
            for u in (3, 0, 2, 1)]
    eng = Engine(model, cfg, num_slots=1, cache_len=24, chunk=2)
    done = eng.run(reqs)
    admits = [done[u].admitted_s for u in (0, 1, 2, 3)]
    assert admits == sorted(admits)
    assert all(done[u].finished_s <= done[u + 1].admitted_s + 1e-9 for u in (0, 1, 2))
    for r in reqs:
        np.testing.assert_array_equal(done[r.uid].tokens, _solo(model, cfg, r))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _serve_target(model, cfg, target_first, **kw):
    """uid 7 served beside a filler; arrival order decides the slots."""
    target = Request(uid=7, prompt=np.arange(4, dtype=np.int32), max_new_tokens=5,
                     arrival_s=0.0 if target_first else 1e-4)
    filler = Request(uid=1, prompt=np.arange(3, dtype=np.int32), max_new_tokens=2,
                     arrival_s=1e-4 if target_first else 0.0)
    eng = Engine(model, cfg, num_slots=2, cache_len=24, chunk=2, **kw)
    return eng.run([target, filler])[7].tokens


def test_sampling_reproducible_across_slots_and_runs(qwen):
    """Every sampled token, the first included, comes from the request's
    (seed, uid) stream at its position: slot 0 or slot 1, the same tokens,
    run after run; another seed gives another stream."""
    cfg, model = qwen
    kw = dict(temperature=0.8, top_k=8, seed=3)
    a = _serve_target(model, cfg, True, **kw)
    b = _serve_target(model, cfg, False, **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, _serve_target(model, cfg, True, **kw))
    assert len(a) == 5 and a.min() >= 0 and a.max() < cfg.vocab
    others = [_serve_target(model, cfg, True, temperature=0.8, top_k=8, seed=s)
              for s in (4, 5, 6)]
    assert any(not np.array_equal(a, o) for o in others)


def test_top_k_one_is_greedy(qwen):
    cfg, model = qwen
    np.testing.assert_array_equal(_serve_target(model, cfg, True, temperature=0.8, top_k=1),
                                  _serve_target(model, cfg, True))


def test_sampling_draws_the_gumbel_max_law():
    """Over 40,000 request streams, each token's frequency is within 0.01 of
    softmax(logits / temperature), with top_k keeping the k largest."""
    n = 40_000
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5]]).expand(n, 5).contiguous()
    keys = torch.zeros((n, 2), dtype=torch.uint32)
    keys[:, 0] = 11
    keys[:, 1] = torch.arange(n, dtype=torch.int32).to(torch.uint32)
    pos = torch.full((n,), 9, dtype=torch.int32)
    for top_k, temperature in ((0, 1.0), (0, 0.5), (3, 1.0)):
        got = lm.sample_tokens(logits, pos, keys, temperature, top_k)
        assert got.dtype == torch.int32
        freq = torch.bincount(got.long(), minlength=5).double() / n
        lg = logits[0].double() / temperature
        if top_k:
            lg = torch.where(lg >= lg.topk(top_k).values[-1], lg, float("-inf"))
        assert float((freq - torch.softmax(lg, dim=0)).abs().max()) < 0.01, (top_k, freq)
    greedy = lm.sample_tokens(torch.tensor([[1.0, 3.0, 3.0]]), pos[:1], None, 0.0, 0)
    assert greedy.tolist() == [1]  # the first index on ties, as jnp.argmax
    # the stream's words, pinned (the hash is core.faults._mix32, the fault model's)
    keys = torch.tensor([[3, 7], [0xFFFFFFFF, 0x7FFFFFFF]], dtype=torch.int64).to(torch.uint32)
    words = lm._stream_bits(keys, torch.tensor([0, 2_000_000_000], dtype=torch.int32), 6)
    assert words.tolist() == [
        [2867087696, 1138866074, 703359632, 939383032, 22083434, 1822093297],
        [1316949154, 1845148630, 617509348, 1537871161, 3938082606, 3756077568]]
