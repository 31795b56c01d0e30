"""The torch port's engine robustness layers held against the JAX package:
health detectors, quarantine, the exact fallback and dispatch retries; then
snapshot/resume, the request journal and overload shedding.

Both packages run the float32 smoke config of qwen3-4b (gemma3-1b for the
ring cache) with ``sqrt_unit="e2afs"``; the reference's weights cross over
through ``convert.params_from_numpy``, and traces are drawn with numpy as
``tests/models/parity.py::random_requests`` draws them.  The port runs its
plain versions on the CPU (the captured chunk with its health signals is
held on the card by ``tests/test_torch_gpu.py``).

Limits: greedy tokens identical.  A zero-fault engine with detectors on
equals the JAX package's ``solo_generate``; a degraded request equals the
port's own exact solo run, and its first two tokens the JAX package's
(torch's and XLA's exact rsqrt differ by up to 2 ulps, ROADMAP C.13).
Seeded chaos replays are held within the port (a partial-rate schedule
hashes float bits that follow each framework's sum order, C.17); across
packages, a rate-1.0 NaN schedule gives equal statuses, trips and counters,
and a rate-0.4 dispatch schedule equal dispatch counters (both draw from
``random.Random(seed)``).  Health signals: ``bad`` equal, ``mx`` within rtol
1e-5.  The JAX ``Engine`` runs at most three times, in module-scoped
fixtures.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import FaultConfig as JaxFaultConfig
from repro.launch.engine import SHED_POLICIES as JAX_SHED_POLICIES
from repro.launch.engine import STATUSES as JAX_STATUSES
from repro.launch.engine import Engine as JaxEngine
from repro.launch.engine import Request as JaxRequest
from repro.models import lm as jax_lm
from repro_torch.configs import get_smoke_config
from repro_torch.core.faults import DispatchFault, DispatchFaultInjector, FaultConfig
from repro_torch.launch import engine, kill_resume
from repro_torch.launch.engine import (SHED_POLICIES, STATUSES, AccuracySLO, Engine, Request,
                                      solo_generate)
from repro_torch.launch.journal import RequestJournal, read_journal, replay_plan
from repro_torch.models import convert, lm

ROOT = Path(__file__).resolve().parents[1]
KW = dict(act_dtype="float32", sqrt_unit="e2afs")
CACHE = 24


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, JAX params, port cfg, port model): qwen3-4b at smoke width,
    the port's model built from the reference's weights."""
    jcfg = jax_smoke_config("qwen3-4b", **KW)
    params, _ = jax_lm.init(jcfg, jax.random.key(0))
    tcfg = get_smoke_config("qwen3-4b", **KW)
    model = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, tcfg, model


# the reference's ``launch.engine.solo_generate`` (prefill, then greedy
# ``generate_scan``) with both calls jitted (the config and lengths static):
# run eagerly, each call compiles its layer scans anew; jitted, each config
# and shape compiles once for the whole file
_jax_prefill = jax.jit(jax_lm.prefill, static_argnums=1, static_argnames="last_logit_only")
_jax_generate = jax.jit(jax_lm.generate_scan, static_argnums=(1, 5))


def jax_solo_generate(params, cfg, prompt, max_new_tokens, *, cache_len):
    prompt = jnp.asarray(prompt, jnp.int32)[None]
    cache, _ = jax_lm.init_cache(cfg, 1, cache_len)
    logits, cache = _jax_prefill(params, cfg, cache, prompt, last_logit_only=True)
    toks, _, _ = _jax_generate(params, cfg, cache, jnp.argmax(logits[:, -1:], axis=-1),
                               prompt.shape[1], max_new_tokens)
    return np.asarray(toks)[0]


def _requests(vocab, n, *, seed=0, prompts=(3, 5), gens=(2, 4, 7), cls=Request):
    """``parity.random_requests``: all due at 0, so the schedule (admission
    order, chunk contents) is deterministic."""
    rng = np.random.RandomState(seed)
    return [cls(uid=i, prompt=rng.randint(0, vocab, size=int(rng.choice(prompts))).astype(np.int32),
                max_new_tokens=int(rng.choice(gens))) for i in range(n)]


def _fresh(reqs):
    return [dataclasses.replace(r) for r in reqs]


def _solo(model, cfg, req, cache_len=CACHE, quantized=False):
    return solo_generate(model, cfg, req.prompt, req.max_new_tokens, cache_len=cache_len,
                         quantized_kv=quantized)


@pytest.fixture(scope="module")
def jax_solo(setup):
    """The JAX package's ``solo_generate`` of a request (its first ``n``
    tokens) on a config of the reference, cached across tests."""
    params = setup[1]

    @functools.lru_cache(maxsize=None)
    def run(jcfg, prompt: tuple, n: int):
        return jax_solo_generate(params, jcfg, np.asarray(prompt, np.int32), n, cache_len=CACHE)

    return lambda jcfg, req, n=None: run(jcfg, tuple(int(x) for x in req.prompt),
                                         n or req.max_new_tokens)


def _engine(model, cfg, **kw):
    return Engine(model, cfg, num_slots=2, cache_len=CACHE, chunk=3, **kw)


# ---------------------------------------------------------------------------
# 5a: health detectors, quarantine, the exact fallback, dispatch retries
# (tests/launch/test_engine_faults.py)
# ---------------------------------------------------------------------------


def test_zero_fault_detectors_token_exact(setup, jax_solo):
    """Detectors on, no faults: tokens equal the JAX package's solo runs,
    every status ok, every fault counter zero."""
    jcfg, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 5)
    eng = _engine(model, cfg)
    assert eng.detectors
    done = eng.run(_fresh(reqs))
    assert set(done) == {r.uid for r in reqs}
    for r in reqs:
        c = done[r.uid]
        assert c.status == "ok" and c.trips == 0
        np.testing.assert_array_equal(c.tokens, jax_solo(jcfg, r))
    s = eng.stats
    assert s["n_ok"] == 5 and s["faults_detected"] == 0
    assert s["exact_fallbacks"] == 0 and s["dispatch_faults"] == 0
    assert not s["deadline_expired"]


def test_logit_faults_degrade_to_exact_bit_exact(setup, jax_solo):
    """NaN activation injection: the latch trips the poisoned slots, the
    ladder lands on the exact datapath, and the degraded tokens equal the
    port's exact solo run; their first two tokens the JAX package's."""
    jcfg, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 4)
    eng = _engine(model, cfg, faults=FaultConfig("logit_nan", rate=0.5, seed=1))
    done = eng.run(_fresh(reqs))
    assert set(done) == {r.uid for r in reqs}
    degraded = [r for r in reqs if done[r.uid].status == "degraded"]
    assert degraded, "the seeded schedule should trip at least one slot"
    assert all(done[r.uid].status in ("ok", "degraded") for r in reqs)
    ecfg = lm.exact_twin(cfg)
    for r in degraded:
        assert done[r.uid].trips >= 1
        np.testing.assert_array_equal(done[r.uid].tokens, _solo(model, ecfg, r))
        np.testing.assert_array_equal(done[r.uid].tokens[:2],
                                      jax_solo(jax_lm.exact_twin(jcfg), r, 2))
    assert eng.stats["faults_detected"] == eng.stats["exact_fallbacks"] == len(degraded)


def test_sqrt_exponent_faults_trip_sentinel(setup):
    """High-bit exponent flips in the rsqrt datapath blow the logits up; the
    sentinel or the latch quarantines the slot and the fallback gives the
    clean exact tokens."""
    _, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 3)
    eng = _engine(model, cfg, faults=FaultConfig("sqrt_exp", rate=0.3, seed=2, bit=7))
    assert eng.cfg.sqrt_faults is not None  # the schedule rides the serving config
    done = eng.run(_fresh(reqs))
    assert {done[r.uid].status for r in reqs} <= {"ok", "degraded"}
    assert any(done[r.uid].status == "degraded" for r in reqs)
    for r in reqs:
        if done[r.uid].status == "degraded":
            np.testing.assert_array_equal(done[r.uid].tokens, _solo(model, lm.exact_twin(cfg), r))


def test_quarantine_retries_before_fallback(setup):
    """With a retry budget a tripped request gets fresh approximate-path
    attempts first; a value-deterministic schedule trips each, so the trips
    end at retries + 1 and the ladder still lands exact."""
    _, _, cfg, model = setup
    req = _requests(cfg.vocab, 1)[0]
    eng = Engine(model, cfg, num_slots=1, cache_len=CACHE, chunk=3,
                 faults=FaultConfig("logit_nan", rate=1.0, seed=3), quarantine_retries=2)
    c = eng.run([dataclasses.replace(req)])[req.uid]
    assert c.status == "degraded" and c.trips == 3
    assert eng.stats["quarantine_retries"] == 2
    assert eng.stats["faults_detected"] == 3 and eng.stats["exact_fallbacks"] == 1
    np.testing.assert_array_equal(c.tokens, _solo(model, lm.exact_twin(cfg), req))


def test_dispatch_faults_retried_transparently(setup):
    """Injected dispatch failures raise before the device call, so retries
    with backoff serve the clean run's tokens."""
    _, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 4)
    clean = _engine(model, cfg).run(_fresh(reqs))
    eng = _engine(model, cfg, faults=FaultConfig("dispatch", rate=0.4, seed=5))
    done = eng.run(_fresh(reqs))
    for r in reqs:
        assert done[r.uid].status == "ok"
        np.testing.assert_array_equal(done[r.uid].tokens, clean[r.uid].tokens)
    assert eng.stats["dispatch_faults"] > 0
    assert eng.stats["dispatch_retries"] == eng.stats["dispatch_faults"]


def test_dispatch_fault_exhaustion_escalates(setup):
    """A schedule that never succeeds escalates as DispatchFault after the
    retry budget, with the pool untouched: an outage struck mid-serve leaves
    every pool tensor as the last chunk left it, and after ``reset()`` the
    same engine serves the trace."""
    _, _, cfg, model = setup
    req = _requests(cfg.vocab, 1)[0]
    eng = Engine(model, cfg, num_slots=1, cache_len=CACHE, chunk=3,
                 faults=FaultConfig("dispatch", rate=1.0, seed=0), max_dispatch_retries=2,
                 dispatch_backoff_s=1e-4)
    with pytest.raises(DispatchFault, match="max_dispatch_retries"):
        eng.run([dataclasses.replace(req)])
    assert not any(t.any() for t in lm.pool_tensors(eng.pool))

    reqs = _requests(cfg.vocab, 3)
    eng = _engine(model, cfg, faults=FaultConfig("dispatch", rate=0.4, seed=5),
                  dispatch_backoff_s=1e-4)
    for slot, r in enumerate(reqs[:2]):
        eng._admit(r, slot, 0.0)
    eng._decode_chunk()
    before = [t.clone() for t in lm.pool_tensors(eng.pool)]
    schedule = eng._injector
    eng._injector = DispatchFaultInjector(FaultConfig("dispatch", rate=1.0))
    with pytest.raises(DispatchFault, match="4 consecutive times"):
        eng._decode_chunk()
    assert all(torch.equal(a, b) for a, b in zip(lm.pool_tensors(eng.pool), before))
    eng._injector = schedule
    eng.reset()
    done = eng.run(_fresh(reqs))
    for r in reqs:
        np.testing.assert_array_equal(done[r.uid].tokens, _solo(model, cfg, r))


def test_seeded_schedule_replays_identically(setup):
    """The whole chaos run (statuses, trips, tokens, counters) is a function
    of the seed: reset() and a rerun reproduce it."""
    _, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 5)
    eng = _engine(model, cfg, faults=FaultConfig("logit_inf", rate=0.4, seed=7))
    drop = ("makespan_s", "tok_s")
    first = eng.run(_fresh(reqs))
    stats1 = {k: v for k, v in eng.stats.items() if k not in drop}
    eng.reset()
    second = eng.run(_fresh(reqs))
    stats2 = {k: v for k, v in eng.stats.items() if k not in drop}
    for r in reqs:
        assert first[r.uid].status == second[r.uid].status
        assert first[r.uid].trips == second[r.uid].trips
        np.testing.assert_array_equal(first[r.uid].tokens, second[r.uid].tokens)
    assert stats1 == stats2


def test_failed_status_when_exact_path_unhealthy(setup):
    """If even the exact datapath gives non-finite logits (poisoned
    weights), the ladder bottoms out at status 'failed', no tokens."""
    _, params, cfg, _ = setup
    bad = convert.params_from_numpy(cfg, jax.tree.map(lambda p: np.asarray(p) * np.nan, params),
                                    device="cpu")
    req = _requests(cfg.vocab, 1)[0]
    eng = Engine(bad, cfg, num_slots=1, cache_len=CACHE, chunk=3)
    c = eng.run([dataclasses.replace(req)])[req.uid]
    assert c.status == "failed" and len(c.tokens) == 0
    assert eng.stats["n_failed"] == 1 and eng.stats["exact_fallbacks"] == 1


def test_every_request_gets_a_structured_status(setup):
    """Activation faults, a per-request deadline and more requests than
    slots: the statuses partition the trace and the counters agree."""
    _, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 6)
    reqs[4] = dataclasses.replace(reqs[4], deadline_s=1e-9)  # evicted at t=0
    eng = _engine(model, cfg, faults=FaultConfig("logit_nan", rate=0.3, seed=11))
    done = eng.run(_fresh(reqs))
    assert set(done) == {r.uid for r in reqs}
    assert all(c.status in STATUSES for c in done.values())
    assert done[reqs[4].uid].status == "evicted"
    s = eng.stats
    assert sum(s[f"n_{st}"] for st in STATUSES) == len(reqs) == s["n_requests"]
    assert s["n_degraded"] + s["n_failed"] == s["exact_fallbacks"]


# ---------------------------------------------------------------------------
# 5a against the JAX Engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(setup, tmp_path_factory):
    """The JAX Engine on one trace of five requests: (a) every logit NaN
    with two quarantine retries, (b) dispatch faults at rate 0.4 (its
    tokens are the uninterrupted run's), (c) snapshots every chunk and a
    journal, killed at chunk boundary 2."""
    jcfg, params, cfg, _ = setup
    reqs = _requests(cfg.vocab, 5, cls=JaxRequest)
    kw = dict(num_slots=2, cache_len=CACHE, chunk=3)
    out = {}
    for name, faults, extra in (("nan", JaxFaultConfig("logit_nan", rate=1.0, seed=3),
                                 dict(quarantine_retries=2)),
                                ("dispatch", JaxFaultConfig("dispatch", rate=0.4, seed=5),
                                 dict(dispatch_backoff_s=1e-4))):
        eng = JaxEngine(params, jcfg, faults=faults, **kw, **extra)
        out[name] = (eng.run(_fresh(reqs)), dict(eng.stats))
    d = tmp_path_factory.mktemp("jax-snapshot")
    eng = JaxEngine(params, jcfg, snapshot_dir=d / "snap", snapshot_every_chunks=1,
                    journal=d / "journal.jsonl", **kw)
    out["killed"] = (eng.run(_fresh(reqs), max_chunks=2), dict(eng.stats))
    out["dir"] = d
    out["reqs"] = reqs
    return out


def _port_reqs(reqs):
    return [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]


def test_fault_and_dispatch_counters_equal_the_reference(setup, jax_runs):
    """One trace through both engines: under every logit NaN with two
    quarantine retries, statuses, trips and every counter equal the JAX
    Engine's, and the degraded tokens' first two are its; under dispatch
    faults at rate 0.4, the dispatch counters and the tokens equal its.  The
    port's stats keys are the reference's."""
    _, _, cfg, model = setup
    reqs = _port_reqs(jax_runs["reqs"])
    for name, faults, extra in (("nan", FaultConfig("logit_nan", rate=1.0, seed=3),
                                 dict(quarantine_retries=2)),
                                ("dispatch", FaultConfig("dispatch", rate=0.4, seed=5),
                                 dict(dispatch_backoff_s=1e-4))):
        jdone, jstats = jax_runs[name]
        eng = _engine(model, cfg, faults=faults, **extra)
        done = eng.run(_fresh(reqs))
        assert set(eng.stats) == set(jstats)
        for key in eng.stats:
            if key not in ("makespan_s", "tok_s", "mean_queue_depth"):
                assert eng.stats[key] == jstats[key], (name, key)
        assert eng.stats["mean_queue_depth"] == pytest.approx(jstats["mean_queue_depth"])
        for r in reqs:
            assert (done[r.uid].status, done[r.uid].trips) == (jdone[r.uid].status,
                                                               jdone[r.uid].trips), name
            n = 2 if name == "nan" else len(done[r.uid].tokens)
            np.testing.assert_array_equal(done[r.uid].tokens[:n], jdone[r.uid].tokens[:n])
    assert jax_runs["nan"][1]["n_degraded"] == len(reqs)
    assert jax_runs["dispatch"][1]["dispatch_faults"] > 0
    assert STATUSES == JAX_STATUSES and SHED_POLICIES == JAX_SHED_POLICIES


def test_health_signals_equal_the_reference(setup):
    """``decode_slots_scan(with_health=True)``: ``bad`` equal to the
    reference's, ``mx`` within rtol 1e-5 (NaN where it is NaN), tokens and
    the pool vectors equal."""
    jcfg, params, cfg, model = setup
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (4, 5)).astype(np.int32)
    scale = np.array([1e6, 1.0, 1.0, 1.0], np.float32)[:, None]
    poison = np.array([0.0, np.nan, 0.0, np.nan], np.float32)[:, None]
    active = np.array([True, True, True, False])
    remaining = np.array([4, 4, 2, 4], np.int32)

    jcache, _ = jax_lm.init_cache(jcfg, 4, 16)
    jlog, jcache = _jax_prefill(params, jcfg, jcache, jnp.asarray(prompt), last_logit_only=True)
    jout = jax_lm.decode_slots_scan(
        params, jcfg, jcache, jnp.argmax(jlog[:, -1:], -1).astype(jnp.int32),
        jnp.full(4, 5, jnp.int32), jnp.asarray(active), jnp.asarray(remaining), 4,
        with_health=True, logits_hook=lambda lg: lg * scale + poison)
    tcache = lm.init_cache(cfg, 4, 16, device="cpu")
    tlog, tcache = lm.prefill(model, cfg, tcache, torch.from_numpy(prompt), last_logit_only=True)
    ts, tp = torch.from_numpy(scale), torch.from_numpy(poison)
    tout = lm.decode_slots_scan(model, cfg, tcache, tlog[:, -1:].argmax(-1).to(torch.int32),
                                torch.full((4,), 5, dtype=torch.int32), torch.from_numpy(active),
                                torch.from_numpy(remaining), 4, with_health=True,
                                logits_hook=lambda lg: lg * ts + tp)
    assert len(tout) == len(jout) == 9
    for i in (0, 1, 2, 3, 4, 5, 7):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]), err_msg=str(i))
    np.testing.assert_array_equal(tout[7].numpy(), [False, True, False, False])
    mx, jmx = tout[8].numpy(), np.asarray(jout[8])
    assert mx.dtype == np.float32 and np.isnan(mx[1]) and mx[3] == 0.0 and mx[0] > 1e4
    np.testing.assert_allclose(mx, jmx, rtol=1e-5)


def test_tripped_row_stays_isolated(setup):
    """A slot with NaN in every cache line and in its logits decodes beside
    two clean slots: the clean ones emit their solo runs' tokens, only the
    poisoned one latches ``bad``, and the token it feeds next is still a
    valid id (the argmax of a NaN row is the NaN's index, inside the
    vocab)."""
    _, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 3, prompts=(5,), gens=(7,))
    prompt = torch.from_numpy(np.stack([r.prompt for r in reqs]))
    cache = lm.init_cache(cfg, 3, CACHE, device="cpu")
    logits, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
    for name, leaf in cache.items():
        leaf[:, 1] = float("nan")
    poison = torch.tensor([0.0, float("nan"), 0.0])[:, None]
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    toks, emitted, tok, *_, bad, mx = lm.decode_slots_scan(
        model, cfg, cache, tok, torch.full((3,), 5, dtype=torch.int32),
        torch.ones(3, dtype=torch.bool), torch.full((3,), 7, dtype=torch.int32), 7,
        with_health=True, logits_hook=lambda lg: lg + poison)
    for i in (0, 2):
        np.testing.assert_array_equal(toks[i].numpy(), _solo(model, cfg, reqs[i]))
        assert torch.isfinite(cache["k"][:, i]).all() and torch.isfinite(cache["v"][:, i]).all()
    assert bad.tolist() == [False, True, False]
    assert 0 <= int(tok[1, 0]) < cfg.vocab and 0 <= int(toks[1].min())


# ---------------------------------------------------------------------------
# 5b: snapshot/resume and the journal (tests/launch/test_engine_snapshot.py)
# ---------------------------------------------------------------------------


def _audit(jpath, reqs, ref):
    """Exactly-once completion and tokens equal to ``ref``, from the
    journal alone."""
    assert kill_resume.audit(jpath, reqs, ref) == []


def _kill_and_resume(model, cfg, reqs, ref, tmp_path, *, k, quantized=False, chunk=3,
                     num_slots=2):
    """One chaos round: serve with autosave and journal, die at chunk
    boundary ``k`` (``max_chunks``: the durable state a SIGKILL leaves),
    resume from disk alone, drain, audit."""
    snap, jpath = tmp_path / f"snap-{k}", tmp_path / f"journal-{k}.jsonl"
    eng = Engine(model, cfg, num_slots=num_slots, cache_len=CACHE, chunk=chunk,
                 quantized_kv=quantized, snapshot_dir=snap, snapshot_every_chunks=1,
                 journal=jpath)
    seg1 = eng.run(_fresh(reqs), max_chunks=k)
    assert eng.stats["killed"] == (len(seg1) < len(reqs))
    del eng, seg1
    eng2 = Engine.resume(model, cfg, snap, journal=jpath, chunk=chunk)
    seg2 = eng2.run([])
    assert all(c.status == "ok" for c in seg2.values())
    _audit(jpath, reqs, ref)
    return eng2


def test_kill_at_every_chunk_boundary_dense(setup, tmp_path):
    """For EVERY chunk boundary k, k = 0 (before any snapshot) included:
    kill, resume, and recover exactly once with the solo runs' tokens."""
    _, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 4)
    ref = {r.uid: _solo(model, cfg, r) for r in reqs}
    probe = _engine(model, cfg)
    probe.run(_fresh(reqs))
    total = probe.stats["decode_chunks"]
    assert total >= 2
    for k in range(total + 1):
        _kill_and_resume(model, cfg, reqs, ref, tmp_path, k=k)


def test_kill_and_resume_int8_cache(setup, tmp_path):
    """The int8 pool's codes and scales round-trip and decode continues
    token-exact."""
    _, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 3, gens=(2, 4))
    ref = {r.uid: _solo(model, cfg, r, quantized=True) for r in reqs}
    _kill_and_resume(model, cfg, reqs, ref, tmp_path, k=2, quantized=True)


def test_kill_and_resume_ring_cache(tmp_path):
    """gemma3-1b's mixed stack (a list of per-layer caches, rings of the
    window): per-slot ring positions survive the cut mid-flight."""
    cfg = get_smoke_config("gemma3-1b", **KW)
    model = lm.init(cfg, device="cpu")
    reqs = _requests(cfg.vocab, 3, gens=(2, 4))
    ref = {r.uid: _solo(model, cfg, r) for r in reqs}
    _kill_and_resume(model, cfg, reqs, ref, tmp_path, k=2)


@pytest.mark.parametrize("arch,quantized", [("qwen3-4b", False), ("qwen3-4b", True),
                                            ("gemma3-1b", False)])
def test_snapshot_round_trips_every_pool_leaf(setup, tmp_path, arch, quantized):
    """A snapshot holds every pool tensor under the reference's leaf names
    (``pool_cache_<k>`` for a stacked cache, ``pool_cache_<i>_<k>`` for a
    list of layers) and restores bit for bit into a fresh engine's pool, in
    place: bool ``active`` and uint32 ``keys`` included."""
    cfg = setup[2] if arch == "qwen3-4b" else get_smoke_config(arch, **KW)
    model = setup[3] if arch == "qwen3-4b" else lm.init(cfg, device="cpu")
    eng = Engine(model, cfg, num_slots=3, cache_len=CACHE, chunk=2, quantized_kv=quantized,
                 seed=2**32 + 9)
    reqs = _requests(cfg.vocab, 3)
    for slot, r in enumerate(reqs[:2]):
        eng._admit(r, slot, 0.0)
    eng._decode_chunk()
    path = eng.snapshot(tmp_path)
    names = {leaf["name"] for leaf in json.loads((path / "manifest.json").read_text())["leaves"]}
    want = {"meta", "pool_tok", "pool_pos", "pool_active", "pool_remaining", "pool_keys"}
    if cfg.uniform:
        want |= {f"pool_cache_{k}" for k in eng.pool["cache"]}
    else:
        want |= {f"pool_cache_{i}_{k}" for i, layer in enumerate(eng.pool["cache"]) for k in layer}
    assert names == want
    other = Engine(model, cfg, num_slots=3, cache_len=CACHE, chunk=2, quantized_kv=quantized,
                   seed=2**32 + 9)
    addresses = [t.data_ptr() for t in lm.pool_tensors(other.pool)]
    other._restore_snapshot(tmp_path, 0, Engine._read_snapshot_meta(tmp_path, 0))
    assert [t.data_ptr() for t in lm.pool_tensors(other.pool)] == addresses
    for a, b in zip(lm.pool_tensors(other.pool), lm.pool_tensors(eng.pool)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert other.pool["keys"].dtype == torch.uint32 and int(other.pool["keys"][1, 0]) == 9
    assert [o.uid if o else None for o in other._owner] == [0, 1, None]


def test_journal_only_replay_without_snapshot(setup, tmp_path):
    """No snapshot ever committed: the write-ahead ``accepted`` records
    alone replay every request (the ``journal_replays`` stat)."""
    _, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 3, gens=(2, 4))
    jpath = tmp_path / "journal.jsonl"
    journal = RequestJournal(jpath)
    for r in reqs:
        journal.accepted(r)
    journal.close()
    eng = Engine.resume(model, cfg, tmp_path / "never-written", journal=jpath, num_slots=2,
                        cache_len=CACHE, chunk=3)
    done = eng.run([])
    assert eng.stats["journal_replays"] == len(reqs)
    assert set(done) == {r.uid for r in reqs}
    for r in reqs:
        np.testing.assert_array_equal(done[r.uid].tokens, _solo(model, cfg, r))
    _audit(jpath, reqs, {r.uid: _solo(model, cfg, r) for r in reqs})


def test_resume_rejects_pool_shape_change_and_a_mesh(setup, tmp_path):
    """The pool's shape is part of the snapshot: another num_slots raises.
    faults= and slo= resume."""
    _, _, cfg, model = setup
    eng = Engine(model, cfg, num_slots=2, cache_len=CACHE, chunk=3, snapshot_dir=tmp_path)
    eng.snapshot()
    with pytest.raises(ValueError, match="num_slots"):
        Engine.resume(model, cfg, tmp_path, num_slots=4)
    for kw in (dict(faults=FaultConfig(site="sqrt_man", rate=0.1)), dict(slo=AccuracySLO())):
        again = Engine.resume(model, cfg, tmp_path, **kw)
        assert (again.faults, again.slo) == (kw.get("faults"), kw.get("slo"))


def test_snapshot_requires_directory(setup):
    _, _, cfg, model = setup
    eng = Engine(model, cfg, num_slots=1, cache_len=CACHE)
    with pytest.raises(ValueError, match="snapshot_dir"):
        eng.snapshot()
    with pytest.raises(ValueError, match="snapshot_dir"):
        Engine(model, cfg, num_slots=1, cache_len=CACHE, snapshot_every_chunks=1)


def test_journal_tolerates_torn_tail(tmp_path):
    """A writer killed mid-append leaves a partial final line; the reader
    drops it.  Corruption mid-file still raises."""
    p = tmp_path / "j.jsonl"
    journal = RequestJournal(p)
    journal.append("accepted", uid=1, prompt=[1], max_new_tokens=1, arrival_s=0.0,
                   deadline_s=None)
    journal.append("finished", uid=1, status="ok", n_tokens=1, tokens=[7])
    journal.close()
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"kind": "accepted", "uid": 2, "pro')  # torn by the kill
    assert [r["kind"] for r in read_journal(p)] == ["accepted", "finished"]
    corrupt = tmp_path / "corrupt.jsonl"
    corrupt.write_text('{"kind": "accepted"}\nnot json at all\n{"kind": "x"}\n')
    with pytest.raises(ValueError, match="line 2"):
        read_journal(corrupt)


def test_jax_snapshot_resumes_in_the_port(setup, jax_runs):
    """A snapshot and journal the JAX Engine wrote, killed at chunk boundary
    2, resume in the port (its pool written in place, the sampling words
    rebuilt from (seed, uid)) and drain to the JAX package's uninterrupted
    tokens, every request finished exactly once across both packages'
    segments."""
    _, _, cfg, model = setup
    d = jax_runs["dir"]
    assert jax_runs["killed"][1]["killed"]
    reqs = _port_reqs(jax_runs["reqs"])
    eng = Engine.resume(model, cfg, d / "snap", journal=d / "journal.jsonl")
    assert (eng.num_slots, eng.cache_len, eng.chunk) == (2, CACHE, 3)
    live = [s for s, o in enumerate(eng._owner) if o is not None]
    assert live and all(int(eng.pool["keys"][s, 1]) == eng._owner[s].uid for s in live)
    eng.run([])
    _audit(d / "journal.jsonl", reqs, {u: c.tokens for u, c in jax_runs["dispatch"][0].items()})


def test_port_snapshot_reads_back_in_the_reference(setup, tmp_path):
    """A snapshot the port wrote reads back through the reference's
    ``Engine._read_snapshot_meta`` and ``checkpoint.restore``: the same
    meta and every pool leaf equal."""
    jcfg, _, cfg, model = setup
    eng = Engine(model, cfg, num_slots=2, cache_len=CACHE, chunk=3, snapshot_dir=tmp_path)
    reqs = _requests(cfg.vocab, 3)
    eng.run(_fresh(reqs), max_chunks=2)
    eng.snapshot(step=7)
    meta = JaxEngine._read_snapshot_meta(tmp_path, 7)
    assert meta == Engine._read_snapshot_meta(tmp_path, 7)
    assert meta["engine"]["num_slots"] == 2 and meta["chunks_total"] == 2
    like = {"pool": jax_lm.init_pool_state(jcfg, 2, CACHE, abstract=True)}
    flat = jax.tree_util.tree_flatten_with_path(jax_checkpoint.restore(tmp_path, 7, like))[0]
    got = {"/".join(str(p.key) for p in path): np.asarray(a) for path, a in flat}
    names = ([f"pool/cache/{k}" for k in sorted(eng.pool["cache"])]
             + [f"pool/{k}" for k in ("tok", "pos", "active", "remaining", "keys")])
    assert set(got) == set(names)
    for name, t in zip(names, lm.pool_tensors(eng.pool)):
        np.testing.assert_array_equal(got[name], t.numpy(), err_msg=name)
        assert got[name].dtype == t.numpy().dtype, name


def test_kill_resume_smoke_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.kill_resume --device cpu``: a child
    serves with autosave and a journal, is SIGKILLed once the journal shows
    progress, and the parent's resume finishes every request exactly once
    with each request's tokens served alone."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.kill_resume",
                           "--device", "cpu", "--dir", str(tmp_path)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK: exactly-once completion" in proc.stdout


# ---------------------------------------------------------------------------
# 5b: overload shedding (tests/launch/test_engine_overload.py)
# ---------------------------------------------------------------------------


def _burst(vocab, n, *, seed=0, gen=6, deadline_s=None):
    """n requests all due at t=0: a burst far beyond one slot's capacity."""
    rng = np.random.RandomState(seed)
    dl = deadline_s if deadline_s is not None else [None] * n
    return [Request(uid=i, prompt=rng.randint(0, vocab, size=3).astype(np.int32),
                    max_new_tokens=gen, deadline_s=dl[i]) for i in range(n)]


def _one_slot(model, cfg, **kw):
    eng = Engine(model, cfg, num_slots=1, cache_len=CACHE, chunk=4, **kw)
    eng.warmup(prompt_lens={3})
    return eng


def test_bounded_queue_reject_new(setup):
    """1 slot, a 6-request burst, max_queue=2: the queue never passes its
    bound, the excess is rejected (never admitted, no tokens), and every
    request that took a slot equals its solo run."""
    _, _, cfg, model = setup
    reqs = _burst(cfg.vocab, 6)
    eng = _one_slot(model, cfg, max_queue=2, shed_policy="reject-new")
    done = eng.run(reqs)
    assert set(done) == {r.uid for r in reqs}
    assert eng.stats["peak_queue_depth"] <= 2
    rejected = {u for u, c in done.items() if c.status == "rejected"}
    served = {u for u, c in done.items() if c.status == "ok"}
    assert rejected and served and rejected | served == set(done)
    assert eng.stats["shed_rejections"] == eng.stats["n_rejected"] == len(rejected)
    for u in rejected:
        c = done[u]
        assert c.admitted_s == -1.0 and len(c.tokens) == 0 and c.latency_s >= 0.0
    for u in served:
        np.testing.assert_array_equal(done[u].tokens, _solo(model, cfg, reqs[u]))
    # reject-new sheds from the tail: the earliest arrivals survive
    assert served == set(sorted(done)[: len(served)])


@pytest.mark.parametrize("policy,deadlines,victim", [
    # uid 3 has no deadline (infinite): the victim, though uid 1's generous
    # deadline arrived earlier
    ("evict-latest-deadline", [None, 500.0, 400.0, None], 3),
    # uid 1's 1 ms deadline is hopeless: it goes, shed or evicted
    ("shed-by-slo", [None, 0.001, 500.0, 500.0], 1),
])
def test_shed_policy_picks_its_victim(setup, policy, deadlines, victim):
    _, _, cfg, model = setup
    reqs = _burst(cfg.vocab, 4, deadline_s=deadlines)
    done = _one_slot(model, cfg, max_queue=2, shed_policy=policy).run(reqs)
    want = ("rejected",) if policy == "evict-latest-deadline" else ("rejected", "evicted")
    assert done[victim].status in want and len(done[victim].tokens) == 0
    assert all(done[u].status == "ok" for u in range(4) if u != victim)


def test_unbounded_by_default(setup):
    """Without max_queue nothing is ever rejected."""
    _, _, cfg, model = setup
    reqs = _burst(cfg.vocab, 5, gen=3)
    eng = _one_slot(model, cfg)
    done = eng.run(reqs)
    assert all(c.status == "ok" for c in done.values())
    assert eng.stats["n_rejected"] == 0
    assert eng.stats["peak_queue_depth"] == len(reqs) - 1  # all but the admitted head
    assert eng.stats["mean_queue_depth"] >= 0.0


def test_backpressure_stats_surface(setup):
    _, _, cfg, model = setup
    eng = _one_slot(model, cfg, max_queue=1)
    eng.run(_burst(cfg.vocab, 4, gen=3))
    for key in ("peak_queue_depth", "mean_queue_depth", "shed_rejections", "snapshots_written",
                "journal_replays", "n_rejected", "killed", "dispatch_faults"):
        assert key in eng.stats, key
    assert eng.stats["peak_queue_depth"] <= 1
    assert eng.stats["snapshots_written"] == 0  # no autosave configured


def test_invalid_admission_config_rejected(setup):
    _, _, cfg, model = setup
    with pytest.raises(ValueError, match="shed_policy"):
        Engine(model, cfg, num_slots=1, cache_len=CACHE, shed_policy="nope")
    with pytest.raises(ValueError, match="max_queue"):
        Engine(model, cfg, num_slots=1, cache_len=CACHE, max_queue=0)
    with pytest.raises(ValueError, match="snapshot_every_chunks"):
        Engine(model, cfg, num_slots=1, cache_len=CACHE, snapshot_dir=".",
               snapshot_every_chunks=0)
    assert "rejected" in engine.STATUSES and len(SHED_POLICIES) == 3
