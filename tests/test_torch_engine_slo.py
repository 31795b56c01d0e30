"""The torch port's accuracy-SLO engine held against the JAX package:
shadow-exact canaries, the per-slot datapath ladder, demotion and promotion
hysteresis, per-rung admission, snapshot and journal persistence of the
rungs, and telemetry (``tests/launch/test_engine_slo.py``'s contract).

Both packages run the float32 smoke config of qwen3-4b with
``sqrt_unit="e2afs"``; the reference's weights cross over through
``convert.params_from_numpy``, and traces are drawn with numpy as
``tests/models/parity.py::random_requests`` draws them.  The port runs its
plain versions on the CPU (the captured chunk with canaries and levels is
held on the card by ``tests/test_torch_gpu.py``).  The JAX ``Engine`` runs
three times, in one module-scoped fixture.

Limits: greedy tokens identical, within the port and across packages;
canary checks, divergences, demotion trails (chunk, level, unit) and rungs
equal; the max relative logit error of the canaries within rtol 1e-4 of the
reference's (its logits part from the reference's in the last float32 bits:
the fused norm's sum order, and torch's exact rsqrt within two ulps of
XLA's, ROADMAP C.13).  The demotion pressure is a rate-1.0 pinned-bit
``sqrt_man`` schedule: a partial-rate schedule hashes float bits that follow
each framework's sum order (C.17).  A level-0 row of the ladder is
bit-identical to the norm without levels (C.16).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import FaultConfig as JaxFaultConfig
from repro.launch.engine import AccuracySLO as JaxAccuracySLO
from repro.launch.engine import Engine as JaxEngine
from repro.launch.engine import Request as JaxRequest
from repro.models import lm as jax_lm
from repro_torch.configs import get_smoke_config
from repro_torch.core.faults import FaultConfig
from repro_torch.layers import norms
from repro_torch.launch.engine import AccuracySLO, Engine, Request, solo_generate
from repro_torch.launch.journal import read_journal, replay_unit_levels
from repro_torch.launch.telemetry import Telemetry, read_telemetry
from repro_torch.models import convert, lm

KW = dict(act_dtype="float32", sqrt_unit="e2afs")
CACHE = 24
REL_RTOL = 1e-4

# a pinned high mantissa bit at rate 1.0 makes every rung-0 rsqrt wildly
# wrong and is value-deterministic, so the demotion chunks are reproducible
PRESSURE = dict(site="sqrt_man", rate=1.0, seed=7, bit=21)
GUARD = dict(canary_stride=2, rel_err_budget=0.05, divergence_budget=0, promote_after=None)
READ_ONLY = dict(canary_stride=2, rel_err_budget=1e9, divergence_budget=None,
                 promote_after=None)
RESUME = dict(canary_stride=5, rel_err_budget=0.05, divergence_budget=None, promote_after=None)


def _requests(vocab, n, *, seed=0, prompts=(3, 5), gens=(4, 6), cls=Request):
    """``parity.random_requests``: all due at 0, so admission order and chunk
    contents are deterministic."""
    rng = np.random.RandomState(seed)
    return [cls(uid=i, prompt=rng.randint(0, vocab, size=int(rng.choice(prompts))).astype(np.int32),
                max_new_tokens=int(rng.choice(gens))) for i in range(n)]


def _probes(vocab, cls=Request):
    return [cls(100 + r.uid, r.prompt, r.max_new_tokens)
            for r in _requests(vocab, 3, seed=2, cls=cls)]


# the persistence trace: one request primes slot 0 (canaries at lifetime
# steps 0 and 5 demote it), then two more run while slot 1 is still on rung 0
def _prime(cls=Request):
    return [cls(uid=0, prompt=np.arange(3, dtype=np.int32), max_new_tokens=8)]


def _trace(cls=Request):
    return [cls(uid=u, prompt=np.arange(3, dtype=np.int32) + u, max_new_tokens=7)
            for u in (1, 2)]


def _trail(c):
    return [(e["event"], e["chunk"], e["level"], e["unit"]) for e in c.unit_trips]


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, JAX params, port cfg, port model): qwen3-4b at smoke width,
    the port's model built from the reference's weights."""
    jcfg = jax_smoke_config("qwen3-4b", **KW)
    params, _ = jax_lm.init(jcfg, jax.random.key(0))
    tcfg = get_smoke_config("qwen3-4b", **KW)
    model = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def jax_runs(setup, tmp_path_factory):
    """The JAX package's engine on the read-only canary run, the guarded run
    under pressure (then the probes into its demoted slots), and the
    persistence trace killed after one chunk with a snapshot a chunk."""
    jcfg, params, cfg, _ = setup
    out = {}
    eng = JaxEngine(params, jcfg, num_slots=2, cache_len=CACHE, chunk=3,
                    slo=JaxAccuracySLO(**READ_ONLY))
    out["read_only"] = (eng.run(_requests(cfg.vocab, 5, cls=JaxRequest)), dict(eng.stats))
    eng = JaxEngine(params, jcfg, num_slots=2, cache_len=CACHE, chunk=3,
                    faults=JaxFaultConfig(**PRESSURE), slo=JaxAccuracySLO(**GUARD))
    done = eng.run(_requests(cfg.vocab, 4, seed=1, cls=JaxRequest))
    out["guard"] = (done, dict(eng.stats), eng.unit_levels)
    out["probes"] = eng.run(_probes(cfg.vocab, JaxRequest))
    d = tmp_path_factory.mktemp("jax-slo")
    eng = JaxEngine(params, jcfg, num_slots=2, cache_len=CACHE, chunk=2,
                    faults=JaxFaultConfig(**PRESSURE), slo=JaxAccuracySLO(**RESUME),
                    snapshot_dir=d / "snap", snapshot_every_chunks=1, journal=d / "j.jsonl")
    eng.run(_prime(JaxRequest))
    eng.run(_trace(JaxRequest), max_chunks=1)
    out["resume"] = (d, eng.unit_levels, eng.stats["killed"])
    return out


def _engine(model, cfg, *, slots=2, chunk=3, **kw):
    return Engine(model, cfg, num_slots=slots, cache_len=CACHE, chunk=chunk, **kw)


def _pressured(model, cfg, slo, **kw):
    return _engine(model, cfg, faults=FaultConfig(**PRESSURE), slo=AccuracySLO(**slo), **kw)


# ---------------------------------------------------------------------------
# The anchor: a level-0 row is the plain path (C.16), and canaries read only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_level_0_rows_equal_the_norm_without_levels(dtype, monkeypatch):
    """A clean e2afs ladder: a row at level 0 of ``rmsnorm_select`` is bit
    for bit ``rmsnorm_cfg`` without levels, through the same route (one
    call of the fused kernel's wrapper, whose plain version runs here), and
    a row at level 1 the single-unit exact norm."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    calls = []
    kernel = rms_ops.rmsnorm
    monkeypatch.setattr(rms_ops, "rmsnorm", lambda *a, **k: calls.append(1) or kernel(*a, **k))
    cfg = get_smoke_config("qwen3-4b", sqrt_unit="e2afs", sqrt_ladder=("e2afs", "exact"))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((6, 2, 96)).astype(np.float32)).to(dtype)
    scale = torch.from_numpy((rng.standard_normal(96) * 0.1).astype(np.float32)).to(dtype)
    levels = torch.tensor([0, 1, 0, 0, 1, 1], dtype=torch.int32)
    got = norms.rmsnorm_cfg(scale, x, cfg, levels=levels)
    assert len(calls) == 1
    plain = norms.rmsnorm_cfg(scale, x, cfg)
    assert len(calls) == 2
    exact = norms.rmsnorm(scale, x, sqrt_unit="exact")
    for i, lv in enumerate(levels.tolist()):
        want = plain if lv == 0 else exact
        assert torch.equal(got[i].view(torch.uint8), want[i].view(torch.uint8)), (i, lv)


def test_all_zero_levels_decode_as_the_plain_path(setup):
    """``decode_slots_scan`` with every slot at level 0 gives the tokens,
    logits and cache of the same decode without levels, bit for bit."""
    _, _, cfg, model = setup
    lcfg = cfg.replace(sqrt_ladder=("e2afs", "exact"))
    b, s, steps = 3, 5, 4
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (b, s)))
    runs = []
    for c, levels in ((cfg, None), (lcfg, torch.zeros(b, dtype=torch.int32))):
        cache = lm.init_cache(c, b, s + steps, device="cpu")
        logits, cache = lm.prefill(model, c, cache, prompt, last_logit_only=True)
        seen = []
        toks = lm.decode_slots_scan(
            model, c, cache, logits[:, -1:].argmax(-1).to(torch.int32),
            torch.full((b,), s, dtype=torch.int32), torch.ones(b, dtype=torch.bool),
            torch.full((b,), steps, dtype=torch.int32), steps, unit_levels=levels,
            logits_hook=lambda lg: seen.append(lg.clone()) or lg)[0]
        runs.append((toks, torch.stack(seen), cache))
    (t0, l0, c0), (t1, l1, c1) = runs
    assert torch.equal(t0, t1) and torch.equal(l0.view(torch.int32), l1.view(torch.int32))
    assert all(torch.equal(c0[k], c1[k]) for k in c0)


def test_decode_slots_scan_canaries_match_the_reference(setup):
    """``decode_slots_scan(canary_stride=2, canary_offset=1)`` over three
    slots at rungs [0, 1, 0] of ("e2afs", "exact"), one of them spending its
    budget mid-run, in both packages: tokens and the canary checks and
    divergences equal, the max and summed relative errors within rtol 1e-4
    (the summed one is a mean over the vocab, summed in each framework's
    order); the exact rung's row agrees with its shadow exactly."""
    jcfg, params, cfg, model = setup
    ladder = ("e2afs", "exact")
    jcfg, cfg = jcfg.replace(sqrt_ladder=ladder), cfg.replace(sqrt_ladder=ladder)
    b, s, steps = 3, 5, 6
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (b, s)).astype(np.int32)
    levels = np.array([0, 1, 0], np.int32)
    pos, active = np.full(b, s, np.int32), np.ones(b, bool)
    remaining = np.array([steps, steps, 2], np.int32)

    jcache, _ = jax_lm.init_cache(jcfg, b, s + steps)
    jlog, jcache = jax_lm.prefill(params, jcfg, jcache, prompt, last_logit_only=True)
    jout = jax_lm.decode_slots_scan(
        params, jcfg, jcache, jax.numpy.argmax(jlog[:, -1:], axis=-1).astype(np.int32), pos,
        active, remaining, steps, unit_levels=levels, canary_stride=2, canary_offset=1)
    tcache = lm.init_cache(cfg, b, s + steps, device="cpu")
    tlog, tcache = lm.prefill(model, cfg, tcache, torch.from_numpy(prompt), last_logit_only=True)
    tout = lm.decode_slots_scan(
        model, cfg, tcache, tlog[:, -1:].argmax(-1).to(torch.int32), torch.from_numpy(pos),
        torch.from_numpy(active), torch.from_numpy(remaining), steps,
        unit_levels=torch.from_numpy(levels), canary_stride=2, canary_offset=1)
    assert len(tout) == len(jout) == 11
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    (cc, cd, cmr, crs), jstats = tout[7:], [np.asarray(a) for a in jout[7:]]
    assert cc.tolist() == jstats[0].tolist() == [3, 3, 1]  # lifetime steps 2, 4, 6
    assert cd.tolist() == jstats[1].tolist()
    np.testing.assert_allclose(cmr.numpy(), jstats[2], rtol=REL_RTOL)
    np.testing.assert_allclose(crs.numpy(), jstats[3], rtol=REL_RTOL)
    assert float(cmr[1]) == float(crs[1]) == 0.0 and float(cmr[0]) > 0.0


def test_stride_none_bit_exact_vs_slo_free_engine(setup):
    """``AccuracySLO(canary_stride=None)``: the ladder routes every slot at
    rung 0 and no canary fires; tokens equal the SLO-free engine's, and the
    audit fields are present."""
    _, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 5)
    base = _engine(model, cfg)
    base.warmup(prompt_lens={3, 5})
    done0 = base.run(reqs)
    eng = _engine(model, cfg, slo=AccuracySLO(canary_stride=None))
    eng.warmup(prompt_lens={3, 5})
    done1 = eng.run(_requests(cfg.vocab, 5))
    for r in reqs:
        np.testing.assert_array_equal(done1[r.uid].tokens, done0[r.uid].tokens)
    assert eng.stats["canary_checks"] == 0 and eng.stats["demotions"] == 0
    assert eng._packed.shape == base._packed.shape  # no canary columns
    c = done1[reqs[0].uid]
    assert c.unit_final == "e2afs" and c.canary_checks == 0 and c.unit_trips == ()
    assert done0[reqs[0].uid].unit_final is None


def test_canaries_are_read_only(setup, jax_runs):
    """Canaries every 2 steps with budgets that never trip: tokens equal the
    SLO-free engine's (the shadow's cache writes do not survive), and the
    canary counts equal the JAX engine's on the same run, the max relative
    error within rtol 1e-4."""
    _, _, cfg, model = setup
    reqs = _requests(cfg.vocab, 5)
    done0 = _engine(model, cfg).run(reqs)
    eng = _engine(model, cfg, slo=AccuracySLO(**READ_ONLY))
    eng.warmup(prompt_lens={3, 5})
    done1 = eng.run(_requests(cfg.vocab, 5))
    jdone, jstats = jax_runs["read_only"]
    for r in reqs:
        np.testing.assert_array_equal(done1[r.uid].tokens, done0[r.uid].tokens)
        np.testing.assert_array_equal(done1[r.uid].tokens, jdone[r.uid].tokens)
        assert done1[r.uid].canary_checks == jdone[r.uid].canary_checks
    st = eng.stats
    assert st["canary_checks"] == jstats["canary_checks"] > 0
    assert st["canary_divergences"] == jstats["canary_divergences"]
    assert 0.0 < st["canary_max_rel_err"] < 1.0  # the e2afs datapath's own drift
    np.testing.assert_allclose(st["canary_max_rel_err"], jstats["canary_max_rel_err"],
                               rtol=REL_RTOL)
    assert st["demotions"] == 0 and eng.unit_levels == (0, 0)


@pytest.mark.parametrize("arch,quantized", [("qwen3-4b", True), ("gemma3-1b", False)])
def test_canaries_leave_no_shadow_state(arch, quantized):
    """A canary on every step over an int8 cache (the shadow also writes
    the line's scales) and over gemma3-1b's ring caches (prompts past the
    smoke window of 8): tokens and every pool tensor at the end equal the
    SLO-free engine's, bit for bit."""
    cfg = get_smoke_config(arch, **KW)
    model = lm.init(cfg, device="cpu")
    reqs = _requests(cfg.vocab, 4, seed=3, prompts=(3, 12), gens=(4, 6))
    runs = []
    for slo in (None, AccuracySLO(**{**READ_ONLY, "canary_stride": 1})):
        eng = _engine(model, cfg, quantized_kv=quantized, slo=slo)
        done = eng.run([dataclasses.replace(r) for r in reqs])
        runs.append((done, lm.pool_tensors(eng.pool), eng.stats["canary_checks"]))
    (done0, pool0, _), (done1, pool1, checks) = runs
    assert checks > 0
    for r in reqs:
        np.testing.assert_array_equal(done1[r.uid].tokens, done0[r.uid].tokens)
    assert all(torch.equal(a, b) for a, b in zip(pool0, pool1))


def test_slo_validation(setup):
    _, _, cfg, model = setup
    with pytest.raises(ValueError, match="canary_stride"):
        AccuracySLO(canary_stride=0)
    with pytest.raises(ValueError, match="rel_err_budget"):
        AccuracySLO(rel_err_budget=0.0)
    with pytest.raises(ValueError, match="divergence_budget"):
        AccuracySLO(divergence_budget=-1)
    with pytest.raises(ValueError, match="promote_after"):
        AccuracySLO(promote_after=0)
    with pytest.raises(ValueError, match="rung 0"):
        Engine(model, cfg, num_slots=1, cache_len=CACHE, slo=AccuracySLO(ladder=("exact", "exact")))
    with pytest.raises(ValueError, match="exact"):
        Engine(model, cfg, num_slots=1, cache_len=CACHE, slo=AccuracySLO(ladder=("e2afs", "esas")))
    with pytest.raises(TypeError, match="AccuracySLO"):
        Engine(model, cfg, num_slots=1, cache_len=CACHE, slo={"canary_stride": 2})
    assert dataclasses.asdict(AccuracySLO()) == dataclasses.asdict(JaxAccuracySLO())


@pytest.mark.parametrize("stride,chunk,want", [
    (None, 8, [()]), (32, 8, [(), (0,)]), (8, 8, [(0,)]), (2, 3, [(0, 2), (1,)]),
    (5, 2, [(), (0,), (1,)])])
def test_one_graph_per_firing_pattern(setup, stride, chunk, want):
    """The firing patterns of a chunk, from the lifetime step clock: at most
    ``stride / gcd(stride, chunk)`` of them; ``warmup`` captures each (one
    graph apiece on the card)."""
    _, _, cfg, model = setup
    eng = _engine(model, cfg, chunk=chunk, slo=AccuracySLO(canary_stride=stride))
    assert eng._patterns() == sorted(want)
    assert [eng._firing(k) for k in range(3)] == [
        lm.canary_steps(chunk, stride, k * chunk) for k in range(3)]


def test_a_step_without_a_canary_computes_none(setup, monkeypatch):
    """Stride 6 over chunks of 3: the chunk whose step 0 is a multiple of 6
    runs one shadow decode (on ``exact_twin``), the next runs none; the
    stats and packed columns come back zero from a chunk without one."""
    _, _, cfg, model = setup
    calls = []
    step = lm.decode_step
    monkeypatch.setattr(lm, "decode_step", lambda m, c, *a, **k: calls.append(
        c.sqrt_unit) or step(m, c, *a, **k))
    eng = _engine(model, cfg, slo=AccuracySLO(canary_stride=6, rel_err_budget=1e9))
    for slot, r in enumerate(_requests(cfg.vocab, 2)):
        eng._admit(r, slot, 0.0)
    per_chunk = []
    for k in range(2):
        calls.clear()
        eng._chunks_total = k
        out = eng._decode_chunk()
        per_chunk.append((list(calls), out[5].tolist()))
    assert per_chunk == [(["exact", "e2afs", "e2afs", "e2afs"], [1, 1]),
                         (["e2afs"] * 3, [0, 0])]


# ---------------------------------------------------------------------------
# The ladder: demotion, promotion, per-rung admission
# ---------------------------------------------------------------------------


def test_seeded_pressure_demotes_and_post_demotion_is_exact(setup, tmp_path):
    """Rate-1.0 pinned-bit pressure on rung 0: both slots demote to "exact",
    the journal's trail rebuilds the rungs, and fresh requests admitted
    into the demoted slots (prefill and decode on the exact rung) give the
    exact solo run's tokens."""
    _, _, cfg, model = setup
    jpath = tmp_path / "journal.jsonl"
    eng = _pressured(model, cfg, GUARD, journal=jpath)
    eng.warmup(prompt_lens={3, 5})
    done = eng.run(_requests(cfg.vocab, 4, seed=1))
    st = eng.stats
    assert st["demotions"] >= 1 and st["canary_divergences"] >= 1
    assert eng.unit_levels == (1, 1) and eng.unit_names == ("exact", "exact")
    recs = read_journal(jpath)
    assert any(r["kind"] == "demoted" for r in recs)
    assert replay_unit_levels(recs) == {0: 1, 1: 1}
    tripped = [c for c in done.values() if any(e["event"] == "demoted" for e in c.unit_trips)]
    assert tripped and all(c.unit_final == "exact" for c in tripped)
    probes = _probes(cfg.vocab)
    done_p = eng.run(probes)
    assert eng._levels.tolist() == [1, 1]  # the device rungs the chunks read
    ecfg = lm.exact_twin(eng.cfg)
    for r in probes:
        c = done_p[r.uid]
        assert c.unit_final == "exact" and c.unit_trips == ()
        np.testing.assert_array_equal(
            c.tokens, solo_generate(model, ecfg, r.prompt, r.max_new_tokens, cache_len=CACHE))


def test_demotion_matches_the_reference(setup, jax_runs):
    """The guarded run under pressure in both packages: tokens, each
    request's demotion trail (event, chunk, level, unit), canary checks and
    divergences, the final rungs and the probes into the demoted slots
    equal; the max relative error within rtol 1e-4."""
    _, _, cfg, model = setup
    eng = _pressured(model, cfg, GUARD)
    done = eng.run(_requests(cfg.vocab, 4, seed=1))
    jdone, jstats, jlevels = jax_runs["guard"]
    for u, c in done.items():
        j = jdone[u]
        np.testing.assert_array_equal(c.tokens, j.tokens)
        assert _trail(c) == _trail(j)
        assert (c.unit_final, c.canary_checks, c.canary_divergences) == (
            j.unit_final, j.canary_checks, j.canary_divergences)
    for k in ("canary_checks", "canary_divergences", "demotions", "promotions"):
        assert eng.stats[k] == jstats[k], k
    np.testing.assert_allclose(eng.stats["canary_max_rel_err"], jstats["canary_max_rel_err"],
                               rtol=REL_RTOL)
    assert eng.unit_levels == jlevels == (1, 1)
    done_p = eng.run(_probes(cfg.vocab))
    for u, c in done_p.items():
        np.testing.assert_array_equal(c.tokens, jax_runs["probes"][u].tokens)


def test_clean_run_never_demotes(setup):
    """The guard's budgets without faults and without the divergence
    trigger: the e2afs datapath's relative error stays under 5%."""
    _, _, cfg, model = setup
    slo = AccuracySLO(**{**GUARD, "divergence_budget": None})
    eng = _engine(model, cfg, slo=slo)
    eng.run(_requests(cfg.vocab, 4, seed=1))
    assert eng.stats["canary_checks"] > 0 and eng.stats["demotions"] == 0
    assert eng.unit_levels == (0, 0)


def test_promotion_hysteresis(setup, tmp_path):
    """A vanishing budget demotes on the first canary; at the exact rung
    every canary is clean (bit-identical to the shadow), so after
    ``promote_after`` of them the slot climbs back, and the journal's last
    trip is the slot's rung."""
    _, _, cfg, model = setup
    jpath = tmp_path / "journal.jsonl"
    slo = AccuracySLO(canary_stride=2, rel_err_budget=1e-6, divergence_budget=None,
                      promote_after=2)
    eng = _engine(model, cfg, slots=1, slo=slo, journal=jpath)
    eng.run([Request(uid=0, prompt=np.arange(3, dtype=np.int32), max_new_tokens=16)])
    assert eng.stats["demotions"] >= 1 and eng.stats["promotions"] >= 1
    recs = read_journal(jpath)
    kinds = [r["kind"] for r in recs if r["kind"] in ("demoted", "promoted")]
    assert "demoted" in kinds and "promoted" in kinds
    assert replay_unit_levels(recs).get(0) == eng.unit_levels[0]


# ---------------------------------------------------------------------------
# Persistence: snapshot/resume mid-demotion, the journal, across packages
# ---------------------------------------------------------------------------


def _resumable(model, cfg, path=None):
    kw = {} if path is None else dict(snapshot_dir=path / "snap", snapshot_every_chunks=1,
                                      journal=path / "j.jsonl")
    return _pressured(model, cfg, RESUME, chunk=2, **kw)


@pytest.fixture(scope="module")
def uninterrupted(setup):
    """The persistence trace served without a cut: (engine, completions)."""
    _, _, cfg, model = setup
    eng = _resumable(model, cfg)
    eng.run(_prime())
    assert eng.unit_levels == (1, 0)
    return eng, eng.run(_trace())


def test_snapshot_resume_mid_demotion_matches_uninterrupted(setup, uninterrupted, tmp_path):
    """Killed with slot 0 on "exact" and slot 1 still on "e2afs": the resumed
    engine restores the rungs and the SLO from the snapshot, and drains to
    the uninterrupted run's tokens and rungs."""
    _, _, cfg, model = setup
    ref, done_ref = uninterrupted
    eng = _resumable(model, cfg, tmp_path)
    eng.run(_prime())
    eng.run(_trace(), max_chunks=1)
    assert eng.stats["killed"] and eng.unit_levels == (1, 0)
    del eng
    eng2 = Engine.resume(model, cfg, tmp_path / "snap", journal=tmp_path / "j.jsonl",
                         faults=FaultConfig(**PRESSURE))
    assert eng2.unit_levels == (1, 0)
    assert eng2.slo == AccuracySLO(**RESUME)
    done2 = eng2.run([])
    for uid in (1, 2):
        np.testing.assert_array_equal(done2[uid].tokens, done_ref[uid].tokens)
    assert eng2.unit_levels == ref.unit_levels == (1, 1)


def test_jax_snapshot_mid_demotion_resumes_in_the_port(setup, uninterrupted, jax_runs):
    """The same cut made by the JAX engine: its snapshot (format 1 with the
    ``slo`` block) and journal resume in the port, mid-demotion, and drain
    to the uninterrupted tokens and rungs."""
    _, _, cfg, model = setup
    d, jlevels, killed = jax_runs["resume"]
    assert killed and jlevels == (1, 0)
    eng = Engine.resume(model, cfg, d / "snap", journal=d / "j.jsonl",
                        faults=FaultConfig(**PRESSURE))
    assert eng.unit_levels == (1, 0) and eng.slo == AccuracySLO(**RESUME)
    done = eng.run([])
    for uid in (1, 2):
        np.testing.assert_array_equal(done[uid].tokens, uninterrupted[1][uid].tokens)
    assert eng.unit_levels == (1, 1)


def test_port_snapshot_reads_back_in_the_reference(setup, tmp_path):
    """A port snapshot taken mid-demotion reads back through the reference's
    ``_read_snapshot_meta``: the engine's SLO rebuilds as the reference's
    ``AccuracySLO`` and the ladder block is the port's."""
    _, _, cfg, model = setup
    eng = _resumable(model, cfg)
    eng.run(_prime())
    eng.run(_trace(), max_chunks=1)
    eng.snapshot(tmp_path, step=3)
    meta = JaxEngine._read_snapshot_meta(tmp_path, 3)
    assert meta == Engine._read_snapshot_meta(tmp_path, 3)
    assert JaxAccuracySLO(**meta["engine"]["slo"]) == JaxAccuracySLO(**RESUME)
    assert meta["slo"]["unit_levels"] == [1, 0]
    assert set(meta["slo"]) == {"unit_levels", "clean_streak", "rung_div", "canary_checks",
                                "canary_divergences", "events"}


def test_journal_only_resume_reconstructs_rungs(setup, tmp_path):
    """No snapshot: the demoted/promoted trail alone restores the rungs."""
    _, _, cfg, model = setup
    jpath = tmp_path / "j.jsonl"
    eng = _pressured(model, cfg, GUARD, journal=jpath)
    eng.run(_requests(cfg.vocab, 4, seed=1))
    assert eng.unit_levels == (1, 1)
    del eng
    eng2 = Engine.resume(model, cfg, None, journal=jpath, num_slots=2, cache_len=CACHE, chunk=3,
                         faults=FaultConfig(**PRESSURE), slo=AccuracySLO(**GUARD))
    assert eng2.unit_levels == (1, 1)


def test_journal_unknown_kind_tolerated(setup, tmp_path):
    """A record kind the reader does not know is skipped, not fatal."""
    _, _, cfg, model = setup
    jpath = tmp_path / "j.jsonl"
    eng = _engine(model, cfg, slots=1, journal=jpath)
    eng.run([Request(uid=0, prompt=np.arange(3, dtype=np.int32), max_new_tokens=4)])
    del eng
    with open(jpath, "a", encoding="utf-8") as f:
        f.write('{"kind": "from_the_future", "t": 0.0, "payload": 1}\n')
    recs = read_journal(jpath)
    assert any(r["kind"] == "from_the_future" for r in recs)
    assert replay_unit_levels(recs) == {}
    eng2 = Engine.resume(model, cfg, None, journal=jpath, num_slots=1, cache_len=CACHE, chunk=3)
    done = eng2.run([Request(uid=5, prompt=np.arange(3, dtype=np.int32), max_new_tokens=2)])
    assert done[5].status == "ok" and 0 not in done


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------


def test_engine_emits_chunk_records(setup, tmp_path):
    """One record a chunk with the reference's fields; its tokens and canary
    checks add up to the run's, and the rung histogram to the pool."""
    _, _, cfg, model = setup
    tpath = tmp_path / "telem.jsonl"
    eng = _engine(model, cfg, slo=AccuracySLO(**READ_ONLY), telemetry=tpath)
    eng.run(_requests(cfg.vocab, 4))
    assert eng.stats["telemetry"] == str(tpath)
    recs = read_telemetry(tpath)
    assert len(recs) == eng.stats["decode_chunks"]
    for r in recs:
        assert set(r) == {"kind", "t", "chunk", "active_slots", "slot_occupancy", "queue_depth",
                          "tokens", "tok_s", "canary_checks", "canary_divergences",
                          "canary_max_rel", "unit_levels"}
        assert r["kind"] == "chunk" and 0.0 <= r["slot_occupancy"] <= 1.0
    assert [r["chunk"] for r in recs] == list(range(1, len(recs) + 1))
    assert sum(r["tokens"] for r in recs) == eng.stats["total_tokens"]
    assert sum(r["canary_checks"] for r in recs) == eng.stats["canary_checks"]
    assert all(sum(r["unit_levels"].values()) == 2 for r in recs)


def test_telemetry_emitted_without_slo_too(setup, tmp_path):
    _, _, cfg, model = setup
    tpath = tmp_path / "telem.jsonl"
    eng = _engine(model, cfg, slots=1, telemetry=Telemetry(tpath))
    eng.run([Request(uid=0, prompt=np.arange(3, dtype=np.int32), max_new_tokens=4)])
    recs = read_telemetry(tpath)
    assert recs and all(r["canary_checks"] == 0 for r in recs)
    assert recs[0]["unit_levels"] == {"e2afs": 1}


def test_torn_tail_tolerated(tmp_path):
    tpath = tmp_path / "telem.jsonl"
    t = Telemetry(tpath)
    t.emit({"kind": "chunk", "chunk": 1})
    t.emit({"kind": "chunk", "chunk": 2})
    t.close()
    with open(tpath, "a", encoding="utf-8") as f:
        f.write('{"kind": "chunk", "chu')  # killed mid-append
    assert [r["chunk"] for r in read_telemetry(tpath)] == [1, 2]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "chunk"}\nnot json\n{"kind": "chunk"}\n')
    with pytest.raises(ValueError, match="corrupt"):
        read_telemetry(bad)
    with pytest.raises(ValueError, match="mode"):
        Telemetry(tpath, mode="x")
