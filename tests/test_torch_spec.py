"""The torch port's speculative decoding held against the JAX package:
draft-and-verify over the slot pool (``lm.decode_verify_step``,
``commit_verify_cache``, ``draft_ngram``, ``decode_slots_spec_scan``) and
``Engine(spec=SpecConfig(...), draft_model=...)``, the cases of
``tests/models/test_spec_decode.py`` and ``tests/launch/test_engine_spec.py``.

Both packages run the float32 smoke configs with ``sqrt_unit="e2afs"``
(qwen3-4b: dense and int8 caches; gemma3-1b: rings of an 8-line window);
the port's weights cross over through ``convert.params_to_numpy`` and
traces are drawn with numpy from a seed.  The port runs its plain versions
on the CPU; the card's tests are in ``tests/test_torch_gpu.py``.

Limits, all exact: a verify row's logits equal the sequential step's bit for
bit within the port, and a commit leaves the cache bit for bit where the
sequential loop leaves it (a zero-row commit: where it was); greedy tokens
equal the port's non-speculative tokens and the JAX package's speculative
ones, and the spec steps and accepted drafts equal the reference's.  The
JAX side runs in one module-scoped fixture (its compiles dominate the
file's time).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.engine import Engine as JaxEngine
from repro.launch.engine import Request as JaxRequest
from repro.launch.engine import SpecConfig as JaxSpecConfig
from repro.models import lm as jax_lm
from repro_torch.configs import get_smoke_config
from repro_torch.core.faults import FaultConfig
from repro_torch.launch.engine import AccuracySLO, Engine, Request, SpecConfig, solo_generate
from repro_torch.layers import rowwise
from repro_torch.models import convert, lm
from repro_torch.models.config import MoESpec

KW = dict(act_dtype="float32", sqrt_unit="e2afs")
CACHE = 24
_SETUPS: dict = {}


def _setup(arch, *, seed=0):
    """(JAX cfg, JAX params, port cfg, port model) at smoke width: the port's
    model drawn from ``seed`` and carried across to the reference's tree with
    ``convert.params_to_numpy`` (which skips the reference's init compile)."""
    key = (arch, seed)
    if key not in _SETUPS:
        cfg = get_smoke_config(arch, **KW)
        model = lm.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
        params = jax.tree.map(jax.numpy.asarray, convert.params_to_numpy(model))
        _SETUPS[key] = (jax_smoke_config(arch, **KW), params, cfg, model)
    return _SETUPS[key]


def _requests(vocab, n, *, seed=0, prompts=(3, 9), gens=(2, 4, 7), cls=Request):
    rng = np.random.RandomState(seed)
    return [cls(uid=i, prompt=rng.randint(0, vocab, size=int(rng.choice(prompts))).astype(np.int32),
                max_new_tokens=int(rng.choice(gens))) for i in range(n)]


def _same_tokens(a, b):
    assert set(a) == set(b)
    for uid in a:
        np.testing.assert_array_equal(a[uid].tokens, b[uid].tokens, err_msg=f"uid {uid}")


def _leaves(cache):
    return [t.clone() for t in lm._cache_leaves(cache)]


def _bits_equal(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8)) if a.is_floating_point() \
        else torch.equal(a, b)


def _cache_equal(cache, leaves):
    return all(_bits_equal(x, y) for x, y in zip(lm._cache_leaves(cache), leaves))


# the engine cases held against the reference: (arch, int8 cache, drafting, k)
ENGINE_CASES = [("qwen3-4b", False, "ngram", 3), ("qwen3-4b", True, "ngram", 1),
                ("gemma3-1b", False, "ngram", 3), ("qwen3-4b", False, "model", 2)]


def _draft_pair(pkg):
    """The draft model of the model-drafting cases: qwen3-4b's smoke config
    with weights from seed 1."""
    jcfg, params, cfg, model = _setup("qwen3-4b", seed=1)
    return (params, jcfg) if pkg == "jax" else (model, cfg)


def _spec_engine(model, cfg, *, k=3, draft="ngram", pkg="port", **kw):
    cls = Engine if pkg == "port" else JaxEngine
    spec = (SpecConfig if pkg == "port" else JaxSpecConfig)(k=k, draft=draft)
    if draft == "model":
        kw["draft_model"] = _draft_pair(pkg)
    kw.setdefault("num_slots", 2)
    kw.setdefault("cache_len", CACHE)
    kw.setdefault("chunk", 3)
    return cls(model, cfg, spec=spec, **kw)


# -- the verify primitives, within the port -----------------------------------


def _verify_fixture(arch, *, quantized=False, prompt_len=4, k=3, cache_len=24, b=2, seed=0):
    """A prefilled cache, the k+1 tokens greedy sequential decode feeds from
    it, each step's logits and the cache after the k+1 steps."""
    _, _, cfg, model = _setup(arch)
    rng = np.random.RandomState(seed)
    prompts = torch.from_numpy(rng.randint(0, cfg.vocab, size=(b, prompt_len)).astype(np.int32))
    cache = lm.init_cache(cfg, b, cache_len, quantized=quantized, device="cpu")
    logits, cache = lm.prefill(model, cfg, cache, prompts, last_logit_only=True)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((b,), prompt_len, dtype=torch.int32)
    seq_cache = lm.slot_rows_like(cfg, cache, b)
    for dst, src in zip(lm._cache_leaves(seq_cache), lm._cache_leaves(cache)):
        dst.copy_(src)
    fed, seq_logits, t, p = [tok], [], tok, pos.clone()
    for _ in range(k + 1):
        lg, _ = lm.decode_step(model, cfg, seq_cache, t, p)
        seq_logits.append(lg[:, -1])
        t = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        fed.append(t)
        p = p + 1
    return cfg, model, cache, torch.cat(fed[:k + 1], dim=1), pos, seq_logits, seq_cache


CACHES = [("qwen3-4b", False), ("qwen3-4b", True), ("gemma3-1b", False)]
CACHE_IDS = ["dense", "int8", "ring"]


@pytest.mark.parametrize("arch,quantized", CACHES, ids=CACHE_IDS)
def test_verify_rows_equal_sequential_steps(arch, quantized):
    """Row j of one verify forward is the sequential ``decode_step`` at
    ``pos + j``, bit for bit, and the lines it wrote (a commit of every row,
    a no-op) are the sequential loop's cache, bit for bit."""
    cfg, model, cache, block, pos, seq_logits, seq_cache = _verify_fixture(arch,
                                                                        quantized=quantized)
    vlogits, old = lm.decode_verify_step(model, cfg, cache, block, pos)
    for j in range(block.shape[1]):
        assert _bits_equal(vlogits[:, j], seq_logits[j]), j
    full = torch.full((block.shape[0],), block.shape[1], dtype=torch.int32)
    lm.commit_verify_cache(cfg, cache, old, pos, full)
    assert _cache_equal(cache, _leaves(seq_cache))


@pytest.mark.parametrize("arch,quantized", CACHES, ids=CACHE_IDS)
def test_commit_zero_rows_is_bitwise_noop(arch, quantized):
    """Every row rejected (an inactive slot): the commit writes back every
    line and int8 scale the verify overwrote, bit for bit."""
    cfg, model, cache, block, pos, _, _ = _verify_fixture(arch, quantized=quantized)
    before = _leaves(cache)
    _, old = lm.decode_verify_step(model, cfg, cache, block, pos)
    assert not _cache_equal(cache, before)
    lm.commit_verify_cache(cfg, cache, old, pos, torch.zeros(block.shape[0], dtype=torch.int32))
    assert _cache_equal(cache, before)


@pytest.mark.parametrize("n", [1, 2])
def test_commit_mid_prefix_then_sequential_continues_exactly(n):
    """Commit n rows, step the rest sequentially: logits and the final cache
    land bit for bit on the all-sequential run."""
    cfg, model, cache, block, pos, seq_logits, seq_cache = _verify_fixture("qwen3-4b")
    _, old = lm.decode_verify_step(model, cfg, cache, block, pos)
    lm.commit_verify_cache(cfg, cache, old, pos, torch.full((block.shape[0],), n,
                                                            dtype=torch.int32))
    t, p = block[:, n:n + 1], pos + n
    for j in range(n, block.shape[1]):
        lg, _ = lm.decode_step(model, cfg, cache, t, p)
        assert _bits_equal(lg[:, -1], seq_logits[j]), j
        t, p = lg[:, -1].argmax(-1).to(torch.int32)[:, None], p + 1
    assert _cache_equal(cache, _leaves(seq_cache))


def test_commit_partial_ring_wraparound_rolls_back():
    """The block straddles the wrap of an 8-line ring (prompt 12): the
    rejected rows overwrote live lines, and the rollback restores them bit
    for bit so the sequential continuation stays exact."""
    cfg, model, cache, block, pos, seq_logits, seq_cache = _verify_fixture(
        "gemma3-1b", prompt_len=12, cache_len=14, b=1)
    _, old = lm.decode_verify_step(model, cfg, cache, block, pos)
    lm.commit_verify_cache(cfg, cache, old, pos, torch.ones(1, dtype=torch.int32))
    t, p = block[:, 1:2], pos + 1
    for j in range(1, block.shape[1]):
        lg, _ = lm.decode_step(model, cfg, cache, t, p)
        assert _bits_equal(lg[:, -1], seq_logits[j]), j
        t, p = lg[:, -1].argmax(-1).to(torch.int32)[:, None], p + 1
    assert _cache_equal(cache, _leaves(seq_cache))


@pytest.mark.parametrize("b,n_out,transposed", [(2, 128, False), (1, 64, False),
                                                (2, 256, True)])
def test_rowwise_matmul_rows_equal_the_b_row_product(b, n_out, transposed):
    """``rowwise.matmul`` gives every row of a (b, 4, K) block the bits of
    the b-row product, on whichever route the library's shapes call for
    (here on the CPU: batch 1, and the tied unembed's transposed layout, take
    the row-by-row route at these widths); the route is cached."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((n_out, 64) if transposed else (64, n_out))
                         .astype(np.float32))
    w = w.T if transposed else w
    x = torch.from_numpy(rng.standard_normal((b, 4, 64)).astype(np.float32))
    got = rowwise.matmul(x, w)
    for j in range(4):
        assert _bits_equal(got[:, j], x[:, j].contiguous() @ w), j
    assert rowwise._key(x, w) in rowwise.ROUTES


def test_draft_ngram_lookup_and_fallback():
    """The prompt-lookup drafter continues the most recent earlier match,
    repeats the token with no (or a truncated) match, never reads past the
    written history, and equals the reference's on random histories."""
    hist = np.array([[5, 9, 7, 5, 3, 0, 0, 0],
                     [1, 2, 3, 4, 0, 0, 0, 0],
                     [6, 2, 6, 0, 0, 0, 0, 0]], np.int32)
    tok, pos = np.array([5, 8, 6], np.int32), np.array([5, 4, 3], np.int32)
    drafts = lm.draft_ngram(*(torch.from_numpy(a) for a in (hist, tok, pos)), k=2).numpy()
    np.testing.assert_array_equal(drafts, [[3, 5], [8, 8], [6, 6]])
    rng = np.random.default_rng(5)
    for k in (1, 3, 6):
        hist = rng.integers(0, 4, (6, 16)).astype(np.int32)
        tok = rng.integers(0, 4, 6).astype(np.int32)
        pos = rng.integers(0, 17, 6).astype(np.int32)
        want = np.asarray(jax_lm.draft_ngram(hist, tok, pos, k))
        got = lm.draft_ngram(*(torch.from_numpy(a) for a in (hist, tok, pos)), k=k).numpy()
        np.testing.assert_array_equal(got, want)


# -- the spec scan --------------------------------------------------------------


class _Pool:
    """A slot pool over either package's slot primitives, the history row
    the drafter reads beside it (the reference's test pool)."""

    def __init__(self, pkg, arch, b, cache_len, *, quantized=False, draft=None):
        jcfg, params, cfg, model = _setup(arch)
        self.pkg, self.b = pkg, b
        if pkg == "jax":
            self.cfg, self.model = jcfg, params
            self.cache, _ = jax_lm.init_cache(jcfg, b, cache_len, quantized=quantized)
        else:
            self.cfg, self.model = cfg, model
            self.cache = lm.init_cache(cfg, b, cache_len, quantized=quantized, device="cpu")
        self.state = {"tok": np.zeros((b, 1), np.int32), "pos": np.zeros(b, np.int32),
                      "active": np.zeros(b, bool), "remaining": np.zeros(b, np.int32),
                      "hist": np.zeros((b, cache_len), np.int32)}
        if pkg == "port":
            self.state = {k: torch.from_numpy(v) for k, v in self.state.items()}
        self.draft = None
        if draft is not None:
            dj, dp, dc, dm = _setup(arch, seed=draft)
            if pkg == "jax":
                self.draft = dict(draft_params=dp, draft_cfg=dj,
                                  draft_cache=jax_lm.init_cache(dj, b, cache_len)[0])
            else:
                self.draft = dict(draft_model=dm, draft_cfg=dc,
                                  draft_cache=lm.init_cache(dc, b, cache_len, device="cpu"))

    def admit(self, prompt, slot, budget):
        st, s = self.state, prompt.shape[0]
        if self.pkg == "jax":
            logits, self.cache = jax_lm.prefill_into_slots(self.model, self.cfg, self.cache,
                                                           prompt[None], np.array([slot]))
            if self.draft:
                _, self.draft["draft_cache"] = jax_lm.prefill_into_slots(
                    self.draft["draft_params"], self.draft["draft_cfg"],
                    self.draft["draft_cache"], prompt[None], np.array([slot]))
            st = {k: np.array(v) for k, v in st.items()}
            st["tok"][slot, 0] = int(np.argmax(np.asarray(logits[0, -1])))
        else:
            slots = torch.tensor([slot])
            logits, _ = lm.prefill_into_slots(self.model, self.cfg, self.cache,
                                              torch.from_numpy(prompt)[None], slots)
            if self.draft:
                lm.prefill_into_slots(self.draft["draft_model"], self.draft["draft_cfg"],
                                      self.draft["draft_cache"], torch.from_numpy(prompt)[None],
                                      slots)
            st["tok"][slot, 0] = int(logits[0, -1].argmax())
        st["pos"][slot], st["active"][slot], st["remaining"][slot] = s, True, budget
        st["hist"][slot, :s] = prompt if self.pkg == "jax" else torch.from_numpy(prompt)
        self.state = st

    def decode(self, steps, k=None, **kw):
        st = self.state
        args = (self.model, self.cfg, self.cache, st["tok"], st["pos"], st["active"],
                st["remaining"])
        if k is None:  # the port's non-speculative scan
            out = lm.decode_slots_scan(*args, steps, **kw)
            return out[0].numpy(), out[1].numpy()
        mod = jax_lm if self.pkg == "jax" else lm
        out = mod.decode_slots_spec_scan(*args, st["hist"], steps, k=k, **(self.draft or {}),
                                         **kw)
        if self.pkg == "jax":
            (toks, emitted, st["tok"], st["pos"], st["active"], st["remaining"], self.cache,
             st["hist"]) = out[:8]
            if self.draft:
                self.draft["draft_cache"] = out[10]
        self.accepted = np.asarray(out[8]) + getattr(self, "accepted", 0)
        return np.asarray(out[0]), np.asarray(out[1])


def _staggered(pkg, arch, *, k, quantized=False, draft=None, plens=(5, 7, 3), budgets=(6, 6, 6),
               stagger=2, cache_len=32, seed=1):
    """Admit one request a slot at ``stagger``-step offsets and decode the
    pool to the end: each slot's emitted stream, and the pool."""
    cfg = _setup(arch)[2]
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab, size=s).astype(np.int32) for s in plens]
    pool = _Pool(pkg, arch, len(plens), cache_len, quantized=quantized, draft=draft)
    chunks = []
    for i, (p, g) in enumerate(zip(prompts, budgets)):
        pool.admit(p, i, g)
        if stagger and i < len(plens) - 1:
            chunks.append(pool.decode(stagger, k))
    chunks.append(pool.decode(max(budgets), k))
    assert not np.asarray(pool.state["active"]).any()
    toks = np.concatenate([t for t, _ in chunks], axis=1)
    emitted = np.concatenate([e for _, e in chunks], axis=1)
    return [toks[i][emitted[i]] for i in range(len(plens))], prompts, pool


@pytest.mark.parametrize("k,quantized,ref", [(1, True, False), (3, False, True)],
                         ids=["k1-int8", "k3-dense"])
def test_spec_scan_matches_slots_scan_and_reference(k, quantized, ref):
    """Three requests in a 3-slot pool, one scan to the end: the port's spec
    scan emits each slot's stream of its own ``decode_slots_scan``, and (at
    k = 3; k = 1 and 2 against the reference run in the Engine cases below,
    whose JAX engine calls the same scan) the JAX package's spec scan's
    stream, with the same drafts accepted a slot.  The port's staggered
    admissions are held to solo runs below."""
    spec, _, pool = _staggered("port", "qwen3-4b", k=k, quantized=quantized, stagger=0)
    plain, _, _ = _staggered("port", "qwen3-4b", k=None, quantized=quantized, stagger=0)
    for i in range(3):
        np.testing.assert_array_equal(spec[i], plain[i], err_msg=f"slot {i}")
    if ref:
        jax_streams, _, jpool = _staggered("jax", "qwen3-4b", k=k, quantized=quantized,
                                           stagger=0)
        for i in range(3):
            np.testing.assert_array_equal(spec[i], jax_streams[i], err_msg=f"slot {i}")
        np.testing.assert_array_equal(pool.accepted, jpool.accepted)


@pytest.mark.parametrize("arch,quantized,k,draft,plens,stagger", [
    ("qwen3-4b", False, 3, None, (5, 7, 3), 2),
    ("qwen3-4b", True, 3, None, (5, 7, 3), 2),
    ("gemma3-1b", False, 3, None, (5, 7, 3), 2),
    ("gemma3-1b", False, 3, None, (12, 3), 2),   # the block straddles the ring's wrap
    ("qwen3-4b", False, 2, None, (4,), 0),       # one request alone
    ("qwen3-4b", False, 4, None, (5, 7, 3), 2),
    ("qwen3-4b", False, 2, 0, (5, 7, 3), 2),     # the target drafting for itself
    ("qwen3-4b", False, 2, 99, (5, 7, 3), 2),    # a draft model of other weights
    ("gemma3-1b", False, 3, 99, (12, 3), 2),     # model drafting over wrapping rings
], ids=["dense", "int8", "ring", "ring-wrap", "solo", "k4", "draft-same", "draft-other",
        "draft-ring"])
def test_spec_staggered_matches_solo(arch, quantized, k, draft, plens, stagger):
    """Each slot's speculative stream is the request's solo greedy run,
    for every cache family and draft quality."""
    _, _, cfg, model = _setup(arch)
    streams, prompts, _ = _staggered("port", arch, k=k, quantized=quantized, draft=draft,
                                     plens=plens, budgets=(6,) * len(plens), stagger=stagger)
    for i, p in enumerate(prompts):
        solo = solo_generate(model, cfg, p, 6, cache_len=32, quantized_kv=quantized)
        np.testing.assert_array_equal(streams[i], solo, err_msg=f"slot {i}")


def test_spec_eos_truncates_commit():
    """An EOS inside a verify block: the commit stops at the EOS row and the
    stream ends where the sequential run's does."""
    _, _, cfg, model = _setup("qwen3-4b")
    prompt = np.random.RandomState(3).randint(0, cfg.vocab, size=5).astype(np.int32)
    solo = solo_generate(model, cfg, prompt, 8, cache_len=32)
    eos = int(solo[3])
    stop = int(np.flatnonzero(solo == eos)[0])
    pool = _Pool("port", "qwen3-4b", 1, 32)
    pool.admit(prompt, 0, 8)
    toks, emitted = pool.decode(8, 3, eos_id=eos)
    np.testing.assert_array_equal(toks[0][emitted[0]], solo[:stop + 1])
    assert not pool.state["active"][0]


# -- the Engine -------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's speculative Engine on each of ENGINE_CASES, the
    first with a snapshot a chunk."""
    out = {}
    for case in ENGINE_CASES:
        arch, quantized, draft, k = case
        jcfg, params, cfg, _ = _setup(arch)
        kw = {}
        if case == ENGINE_CASES[0]:  # with a snapshot a chunk, for the port to resume
            kw = dict(snapshot_dir=tmp_path_factory.mktemp("jax-spec"), snapshot_every_chunks=1)
            out["snapshot"] = kw["snapshot_dir"]
        eng = _spec_engine(params, jcfg, k=k, draft=draft, pkg="jax", quantized_kv=quantized,
                           **kw)
        out[case] = (eng.run(_requests(cfg.vocab, 5, cls=JaxRequest)), dict(eng.stats))
    return out


@pytest.mark.parametrize("case", ENGINE_CASES, ids=["dense", "int8-k1", "ring", "draft-model"])
def test_spec_engine_matches_nonspec_and_reference(case, jax_runs):
    """The same trace through the port's speculative engine, its
    non-speculative twin and the JAX package's speculative engine: the
    tokens identical, and each request's spec steps and accepted drafts the
    reference's."""
    arch, quantized, draft, k = case
    _, _, cfg, model = _setup(arch)
    base = Engine(model, cfg, num_slots=2, cache_len=CACHE, chunk=3, quantized_kv=quantized)
    done_b = base.run(_requests(cfg.vocab, 5))
    eng = _spec_engine(model, cfg, k=k, draft=draft, quantized_kv=quantized)
    done = eng.run(_requests(cfg.vocab, 5))
    jdone, jstats = jax_runs[case]
    _same_tokens(done, done_b)
    _same_tokens(done, jdone)
    for uid, c in done.items():
        assert (c.spec_steps, c.spec_accepted) == (jdone[uid].spec_steps,
                                                   jdone[uid].spec_accepted), uid
    for key in ("spec_steps", "spec_accepted", "accepted_per_step", "acceptance_rate"):
        assert eng.stats[key] == jstats[key], key
    assert eng.stats["spec_steps"] > 0


def test_spec_engine_stats_and_completion_fields():
    """The acceptance accounting: per run (steps, accepted drafts, their
    ratio and share of the drafts proposed) and per completion; a
    non-speculative engine reports none.  The packed host copy widens to
    chunk * (k+1) token and emission columns plus two."""
    _, _, cfg, model = _setup("qwen3-4b")
    base = Engine(model, cfg, num_slots=2, cache_len=CACHE, chunk=3)
    done_b = base.run(_requests(cfg.vocab, 6, seed=3))
    spec = _spec_engine(model, cfg, k=3)
    done = spec.run(_requests(cfg.vocab, 6, seed=3))
    _same_tokens(done, done_b)
    st = spec.stats
    assert st["spec_steps"] > 0 and st["spec_accepted"] >= 0
    assert st["accepted_per_step"] == st["spec_accepted"] / st["spec_steps"] <= 3
    assert st["acceptance_rate"] == st["spec_accepted"] / (3 * st["spec_steps"]) <= 1.0
    assert sum(c.spec_steps for c in done.values()) <= st["spec_steps"]
    assert "spec_steps" not in base.stats
    for c in done.values():
        assert c.spec_steps > 0 and 0.0 <= c.accepted_per_step <= 3
        assert c.accepted_per_step == c.spec_accepted / c.spec_steps
    assert all(c.spec_steps == 0 and c.accepted_per_step == 0.0 for c in done_b.values())
    assert spec._packed.shape == (2, 2 * 3 * 4 + 1 + 2 + 2)


def test_spec_engine_eos():
    """An EOS the trace emits ends each request where the non-speculative
    engine ends it, mid-block."""
    _, _, cfg, model = _setup("qwen3-4b")
    reqs = _requests(cfg.vocab, 5, gens=(7,))
    eos = int(Engine(model, cfg, num_slots=2, cache_len=CACHE, chunk=3).run(reqs)[0].tokens[2])
    done_b = Engine(model, cfg, num_slots=2, cache_len=CACHE, chunk=3, eos_id=eos).run(
        _requests(cfg.vocab, 5, gens=(7,)))
    done = _spec_engine(model, cfg, eos_id=eos).run(_requests(cfg.vocab, 5, gens=(7,)))
    _same_tokens(done, done_b)
    assert done[0].tokens[-1] == eos and len(done[0].tokens) < 7


def test_spec_quarantined_slot_degrades_to_exact():
    """Logit NaNs at rate 1.0 trip the detectors on committed rows: every
    request is served alone on the exact datapath, as the solo exact run."""
    _, _, cfg, model = _setup("qwen3-4b")
    reqs = _requests(cfg.vocab, 4, seed=1)
    eng = _spec_engine(model, cfg, faults=FaultConfig("logit_nan", rate=1.0, seed=3))
    done = eng.run(reqs)
    assert eng.stats["faults_detected"] > 0
    ecfg = lm.exact_twin(cfg)
    for r in reqs:
        assert done[r.uid].status == "degraded"
        np.testing.assert_array_equal(
            done[r.uid].tokens, solo_generate(model, ecfg, r.prompt, r.max_new_tokens,
                                              cache_len=CACHE))


def test_spec_canary_reads_only_on_clean_run():
    """Canaries on row 0 every 2 spec steps, with budgets that never trip:
    the tokens of the canary-free spec engine, and no request audited more
    often than its slot ran spec steps."""
    _, _, cfg, model = _setup("qwen3-4b")
    plain = _spec_engine(model, cfg).run(_requests(cfg.vocab, 5, seed=2, gens=(4, 6)))
    eng = _spec_engine(model, cfg, slo=AccuracySLO(canary_stride=2, rel_err_budget=1e6,
                                                   divergence_budget=None, promote_after=None))
    done = eng.run(_requests(cfg.vocab, 5, seed=2, gens=(4, 6)))
    _same_tokens(done, plain)
    assert eng.stats["canary_checks"] > 0 and eng.unit_levels == (0, 0)
    for c in done.values():
        assert c.canary_checks <= c.spec_steps


def test_spec_demoted_slot_decodes_nonspec_and_exact():
    """A pinned sqrt-mantissa bit demotes both slots to "exact"; demoted
    slots accept no draft, and requests admitted after the demotion serve
    the exact rung's solo tokens."""
    _, _, cfg, model = _setup("qwen3-4b")
    eng = _spec_engine(model, cfg, faults=FaultConfig("sqrt_man", 1.0, seed=7, bit=21),
                       slo=AccuracySLO(canary_stride=2, rel_err_budget=0.05,
                                       divergence_budget=0, promote_after=None))
    eng.run(_requests(cfg.vocab, 4, seed=4))
    assert eng.unit_levels == (1, 1)
    probes = _requests(cfg.vocab, 4, seed=9, gens=(4, 6))
    done = eng.run(probes)
    ecfg = lm.exact_twin(cfg)
    for r in probes:
        np.testing.assert_array_equal(
            done[r.uid].tokens, solo_generate(model, ecfg, r.prompt, r.max_new_tokens,
                                              cache_len=CACHE))
    assert eng.stats["spec_steps"] > 0 and eng.stats["spec_accepted"] == 0


def test_spec_kill_resume_token_parity(tmp_path):
    """Killed at a chunk boundary mid-speculation, resumed from the autosave
    (``spec`` from the snapshot, the history rebuilt from the slots'
    prompts and emissions): the merged completions are an uninterrupted
    run's."""
    _, _, cfg, model = _setup("qwen3-4b")
    ref = _spec_engine(model, cfg).run(_requests(cfg.vocab, 5, seed=6))
    eng = _spec_engine(model, cfg, snapshot_dir=tmp_path / "ck", snapshot_every_chunks=1,
                       journal=tmp_path / "wal.jsonl")
    partial = eng.run(_requests(cfg.vocab, 5, seed=6), max_chunks=2)
    assert eng.stats["killed"]
    live = [s for s, o in enumerate(eng._owner) if o is not None]
    eng2 = Engine.resume(model, cfg, tmp_path / "ck", journal=tmp_path / "wal.jsonl")
    assert eng2.spec == SpecConfig(k=3)
    for s in live:  # the history: the prompt, then the emitted tokens
        fed = np.concatenate([eng._owner[s].prompt, eng._emitted[s]])
        np.testing.assert_array_equal(eng2._hist[s, :len(fed)].numpy(), fed)
    _same_tokens({**partial, **eng2.run()}, ref)


def test_spec_resume_without_spec_override_disables_it(tmp_path):
    """``spec=None`` at resume: the restored pool decodes without
    speculation, to the same tokens."""
    _, _, cfg, model = _setup("qwen3-4b")
    ref = Engine(model, cfg, num_slots=2, cache_len=CACHE, chunk=3).run(
        _requests(cfg.vocab, 4, seed=8))
    eng = _spec_engine(model, cfg, snapshot_dir=tmp_path / "ck", snapshot_every_chunks=1)
    partial = eng.run(_requests(cfg.vocab, 4, seed=8), max_chunks=2)
    eng2 = Engine.resume(model, cfg, tmp_path / "ck", spec=None)
    assert eng2.spec is None
    _same_tokens({**partial, **eng2.run()}, ref)


def test_jax_spec_snapshot_resumes_in_the_port(jax_runs):
    """The JAX package's speculative engine's snapshot after two chunks
    resumes in the port with its ``spec`` and the history rebuilt: every
    request it held (in a slot, continuing its stream, or queued) finishes
    with the JAX engine's uninterrupted tokens."""
    _, _, cfg, model = _setup("qwen3-4b")
    eng = Engine.resume(model, cfg, jax_runs["snapshot"], step=2)
    assert eng.spec == SpecConfig(k=3) and eng._chunks_total == 2
    assert any(o is not None for o in eng._owner) and eng._queue
    done = eng.run()
    jdone = jax_runs[ENGINE_CASES[0]][0]
    assert done and len(done) < len(jdone)
    for uid, c in done.items():
        np.testing.assert_array_equal(c.tokens, jdone[uid].tokens, err_msg=f"uid {uid}")


def _refusal(case, tmp_path):
    _, _, cfg, model = _setup("qwen3-4b")
    gemma = _setup("gemma3-1b")
    ssd = cfg.replace(block_pattern=("ssd",))
    moe = cfg.replace(moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=32))
    zero = torch.zeros((1,), dtype=torch.int32)
    return {
        "sampling": lambda: _spec_engine(model, cfg, temperature=0.7),
        "k0": lambda: SpecConfig(k=0),
        "draft-name": lambda: SpecConfig(draft="oracle"),
        "window": lambda: _spec_engine(gemma[3], gemma[2], k=8),
        "cache_len": lambda: _spec_engine(model, cfg, k=4, cache_len=4),
        "recurrent": lambda: Engine(None, ssd, spec=SpecConfig()),
        "moe": lambda: Engine(None, moe, spec=SpecConfig()),
        "verify-recurrent": lambda: lm.decode_verify_step(None, ssd, None,
                                                          torch.zeros((1, 2), dtype=torch.int32),
                                                          zero),
        "scan-window": lambda: lm.decode_slots_spec_scan(
            gemma[3], gemma[2], None, torch.zeros((1, 1), dtype=torch.int32), zero,
            torch.ones(1, dtype=torch.bool), torch.ones(1, dtype=torch.int32),
            torch.zeros((1, 8), dtype=torch.int32), 1, k=8),
        "model-without-draft": lambda: Engine(model, cfg, spec=SpecConfig(draft="model")),
        "draft-without-spec": lambda: Engine(model, cfg, draft_model=(model, cfg)),
        "draft-snapshots": lambda: _spec_engine(model, cfg, draft="model",
                                                snapshot_dir=tmp_path,
                                                snapshot_every_chunks=1),
        "draft-snapshot-call": lambda: _spec_engine(model, cfg, draft="model").snapshot(tmp_path),
    }[case]


@pytest.mark.parametrize("case,match", [
    ("sampling", "greedy-only"), ("k0", "k must be >= 1"), ("draft-name", "draft must be"),
    ("window", "window"), ("cache_len", "cache_len"), ("recurrent", "attention-only"),
    ("moe", "attention-only"), ("verify-recurrent", "attention-only"),
    ("scan-window", "window"), ("model-without-draft", "draft_model"),
    ("draft-without-spec", "no effect"), ("draft-snapshots", "n-gram"),
    ("draft-snapshot-call", "n-gram"),
])
def test_spec_refusals(case, match, tmp_path):
    """What speculation does not take is refused up front, as the
    reference refuses it: sampling, k < 1, an unknown draft source, a block
    wider than the window or the cache, recurrent or MoE stacks, a draft
    model without ``spec`` (or the reverse), and snapshots under a draft
    model."""
    with pytest.raises(ValueError, match=match):
        _refusal(case, tmp_path)()
