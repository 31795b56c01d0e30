"""Continuous-batching serving engine: slot-scheduled decode over a KV-cache
pool with per-request positions (torch port of ``repro.launch.engine``).

* a **slot pool** (:func:`lm.init_pool_state`): one KV cache of
  ``num_slots`` batch rows, each row an independent request with its own
  position, liveness, budget and sampling key;
* a **scheduler** that admits queued requests into freed slots mid-decode:
  :func:`lm.prefill_into_slots` prefills the prompt into staging rows and
  lands them in the live pool with whole-row writes, in place;
* **chunked decode**: between admission points the pool advances by
  ``chunk`` steps of :func:`lm.decode_slots_step`.  On the card the chunk is
  one captured CUDA graph over the pool's tensors, replayed once a chunk
  (the counterpart of the reference's one jitted ``lax.scan``); on the CPU
  the same steps run eagerly.  A chunk ends in ONE device-to-host copy:
  tokens, emission mask, liveness and the health signals together;
* per-slot EOS / budget early exit, global and per-request deadlines, and
  per-request sampling streams (greedy by default).

Fault tolerance: with ``detectors=True`` (default) the chunk also latches
two per-slot health signals (a non-finite logit latch and a max-|logit|
sentinel), zeroed by the chunk's first op so every replay starts clean.  A
tripped slot is quarantined: its request is re-queued for up to
``quarantine_retries`` approximate-path attempts, then served alone on the
exact datapath (``lm.exact_twin``; status ``degraded``, or ``failed`` if
even that gives non-finite logits).  Injected dispatch failures
(``faults=`` with ``site="dispatch"``) raise before the device call, never
inside a replay, and are retried with exponential backoff.

Crash consistency and overload: :meth:`Engine.snapshot` writes the whole
serving state (the pool and the host's request records) through
``checkpoint.save``'s atomic commit in the reference's format;
``snapshot_every_chunks=`` autosaves at the chunk boundary.
:meth:`Engine.resume` writes the latest snapshot into the new engine's pool
tensors in place and reconciles the write-ahead journal
(``launch/journal.py``): finished requests are never served again, accepted
ones missing from the snapshot are replayed.  ``max_queue=`` bounds the
due-request queue and ``shed_policy`` picks what is turned away (status
``rejected``).

Accuracy SLO (``slo=AccuracySLO(...)``): every slot decodes on a rung of a
datapath ladder (approximate -> exact; rung 0 the configured unit), its
rung a (b,) int32 device tensor beside the pool that the captured chunk
reads.  Every ``canary_stride`` steps of the engine's lifetime step clock a
shadow-exact canary recomputes the step on ``lm.exact_twin`` and compares
logits; a slot whose canaries blow the budgets demotes one rung, and climbs
back after ``promote_after`` clean canaries.  The rung is slot-scoped and
sticky: a request admitted into a demoted slot prefills on its rung.
Which steps of a chunk fire is known on the host before the chunk, so on
the card each firing pattern is a graph of its own (at most ``stride /
gcd(stride, chunk)``), sharing one memory pool; a step that fires no
canary computes nothing for it.  ``telemetry=`` streams one JSONL record
a chunk (``launch/telemetry.py``).

Speculative decoding (``spec=SpecConfig(k=...)``, greedy only): each step
of a chunk drafts ``k`` tokens a slot (prompt lookup over the slot's
fed-token history ``hist``, or a small draft model, ``draft_model=``),
verifies the block of ``k+1`` rows in one forward and commits the longest
agreeing prefix, rolling the rejected rows' cache lines back
(``lm.decode_slots_spec_step``).  The spec chunk is captured like the plain
one, a graph a canary firing pattern; its host copy carries ``chunk *
(k+1)`` token and emission columns and the per-slot accepted drafts and
spec steps.  The tokens are the non-speculative engine's, token for token;
a slot on a demoted rung accepts no draft.

A request decoded in a staggered slot emits the tokens of the same request
alone in a pool of the same size (greedy); on the CPU they equal a solo
``prefill`` + ``generate_scan`` run (:func:`solo_generate`).

Sharded serving (``mesh=``, ``rules=``; one process a rank, every rank
building the same Engine): the weights are placed by ``rules``
(``distributed.sharding.place_model``) and the pool by
``serve_pool_shardings``, the pool's tensors DTensors whose local blocks the
steps update in place.  In the exact mode (``serve_rules(...,
replicate_params=True)``) a rank owns a contiguous block of slots and its
decode chunk runs no collective; under the default tensor-parallel rules a
rank holds a block of the heads, hidden units and vocabulary, and the
layers reduce and gather across the 'model' axis.  The host scheduler is
the same program on every rank and must take the same decisions: the
chunk's one host copy is an all-gather of every rank's slot rows, rank 0's
clock is broadcast wherever the loop reads the time, a slot is admitted
(prefilled) only by the ranks that hold it, at its local row (every rank
runs the prefill where experts shard over a wider axis than the slot's
ranks: their collectives span it), and rank 0 alone writes the journal,
the telemetry and the snapshots' files.  Every family serves on a mesh:
dense, window, MoE (experts over 'data' too), SSD and RG-LRU, and query
heads over one replicated KV head.

Faults and the accuracy SLO on a mesh: a sqrt-site strike hashes each
element's index in the whole tensor (``core.faults.block``; the chunk's
scope declares the pool's rows, ``{"batch": num_slots}``), and the logits
hook strikes a slot's row at its global row, so the exact mode strikes the
elements the one-device engine strikes.  The seeded dispatch schedule
draws alike on every rank (every rank dispatches every admission and
chunk).  The health latches and the canary stats ride the chunk's
all-gather, so quarantine, the exact fallback, the ladder's rungs and the
telemetry counters decide alike everywhere; a rank's rung tensor holds its
slot rows' rungs.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint
from repro_torch.core.faults import DispatchFault, DispatchFaultInjector, FaultConfig
from repro_torch.core.faults import logits_hook as _make_logits_hook
from repro_torch.core.units import resolve_ladder
from repro_torch.distributed import sharding
from repro_torch.distributed.constraints import maybe_axis_rules, mesh_axes
from repro_torch.kernels import dispatch
from repro_torch.launch.journal import (RequestJournal, read_journal, replay_plan,
                                        replay_unit_levels)
from repro_torch.launch.telemetry import Telemetry
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

__all__ = ["AccuracySLO", "SpecConfig", "Request", "Completion", "Engine",
           "run_static_baseline", "solo_generate", "STATUSES", "SHED_POLICIES"]

# Completion.status values, in degradation order:
#   ok       -- served on the configured (possibly approximate) datapath
#   degraded -- health detectors tripped; served alone on the exact datapath
#   evicted  -- deadline expiry (global or per-request); tokens are partial
#   failed   -- the exact datapath itself produced non-finite logits
#   rejected -- shed by admission control before taking a slot (overload)
STATUSES = ("ok", "degraded", "evicted", "failed", "rejected")

# Admission-control shed policies (active only with ``max_queue=`` set):
#   reject-new            -- shed from the queue tail: the most recent
#                            arrival is turned away first
#   evict-latest-deadline -- shed the queued request whose effective
#                            deadline (arrival + deadline_s; none = infinity)
#                            is furthest away
#   shed-by-slo           -- shed the queued request with the smallest
#                            deadline slack now; deadline-free requests shed
#                            newest first
SHED_POLICIES = ("reject-new", "evict-latest-deadline", "shed-by-slo")

# snapshot meta-blob layout version (the reference's)
_SNAPSHOT_FORMAT = 1


@dataclasses.dataclass(frozen=True)
class AccuracySLO:
    """Accuracy service-level objective for :class:`Engine` (``slo=``).

    * ``ladder``: datapath rung names, approximate -> exact.  None resolves
      to ``(cfg.sqrt_unit, "exact")``.  Rung 0 must be the serving config's
      ``sqrt_unit`` and the last rung ``"exact"``; only rung 0 sees
      injected sqrt faults, so one demotion steps out of a fault schedule.
    * ``canary_stride``: one shadow-exact canary per slot every this many
      decode steps of the engine's lifetime step clock (the cadence
      survives chunk boundaries, resets and resume).  None: never canary;
      the ladder still routes, and served tokens equal an SLO-free engine's.
    * ``rel_err_budget``: demote a slot one rung when a chunk's worst canary
      max relative logit error (max|served - exact| / max|exact|) exceeds
      this.
    * ``divergence_budget``: demote when more than this many canary argmax
      divergences accumulate at the slot's current rung (0: the first
      divergent token demotes).  None disables the divergence trigger.
    * ``promote_after``: promote one rung back after this many consecutive
      clean canaries (hysteresis).  None: demotions stick for the engine's
      lifetime.
    """

    ladder: Optional[tuple] = None
    canary_stride: Optional[int] = 32
    rel_err_budget: float = 0.25
    divergence_budget: Optional[int] = 0
    promote_after: Optional[int] = 4

    def __post_init__(self):
        if self.ladder is not None:
            object.__setattr__(self, "ladder", tuple(self.ladder))
        if self.canary_stride is not None and self.canary_stride < 1:
            raise ValueError(f"canary_stride must be >= 1 when set (None = never canary); "
                             f"got {self.canary_stride}")
        if not self.rel_err_budget > 0:
            raise ValueError(f"rel_err_budget must be positive, got {self.rel_err_budget}")
        if self.divergence_budget is not None and self.divergence_budget < 0:
            raise ValueError(f"divergence_budget must be >= 0 when set, "
                             f"got {self.divergence_budget}")
        if self.promote_after is not None and self.promote_after < 1:
            raise ValueError(f"promote_after must be >= 1 when set (None = demotions "
                             f"stick), got {self.promote_after}")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding config for :class:`Engine` (``spec=``).

    * ``k``: drafts proposed a step; a step commits 1..k+1 tokens a slot
      (the agreeing drafts and the verify's own next token).  A stack with
      sliding-window layers needs ``k + 1 <= window``.
    * ``draft``: ``"ngram"`` drafts from the slot's own fed-token history
      (no extra model); ``"model"`` continues a small draft model given to
      the engine as ``draft_model=(draft_model, draft_cfg)``, which keeps
      its own slot cache in step with the committed tokens.

    Correctness never depends on the drafts: row 0 of every verify block is
    the committed token, so ``draft`` moves only the acceptance rate."""

    k: int = 3
    draft: str = "ngram"

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec.k must be >= 1 draft tokens, got {self.k}")
        if self.draft not in ("ngram", "model"):
            raise ValueError(f"spec.draft must be 'ngram' or 'model', got {self.draft!r}")


def _device_of(model: lm.LM) -> torch.device:
    return model.embed.device


@torch.no_grad()
def _prefill_alone(model: lm.LM, cfg: ModelConfig, prompt, *, cache_len: int,
                   quantized_kv: bool, cache=None):
    """One request's prompt through a batch-1 :func:`lm.prefill` on the
    model's device, into ``cache`` (default: a fresh one).  Returns (last
    logits (1, 1, vocab), cache, prompt length)."""
    dev = _device_of(model)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32, device=dev)
    if prompt.ndim == 1:
        prompt = prompt[None]
    if cache is None:
        cache = lm.init_cache(cfg, 1, cache_len, quantized=quantized_kv, device=dev)
    logits, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
    return logits, cache, prompt.shape[1]


@torch.no_grad()
def solo_generate(model: lm.LM, cfg: ModelConfig, prompt, max_new_tokens: int, *,
                  cache_len: int, quantized_kv: bool = False) -> np.ndarray:
    """The parity reference: one request alone, batch 1, on the model's
    device (prefill + greedy :func:`lm.generate_scan`).  Returns its
    ``max_new_tokens`` tokens."""
    logits, cache, s = _prefill_alone(model, cfg, prompt, cache_len=cache_len,
                                      quantized_kv=quantized_kv)
    toks, _, _ = lm.generate_scan(model, cfg, cache, logits[:, -1:].argmax(dim=-1), s,
                                  max_new_tokens)
    return toks[0].cpu().numpy()


@dataclasses.dataclass
class Request:
    """One serving request: ``prompt`` (s,) integer tokens, a generation
    budget and an arrival offset (seconds from trace start; 0 = already
    queued).  ``deadline_s`` (optional) bounds the request's wall-clock
    residency from its arrival: once overdue it is evicted with whatever
    tokens it has (status ``evicted``)."""

    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Completion:
    """A finished request: its emitted tokens and its timeline (arrival,
    admission into a slot, finish; seconds from trace start).  ``status`` is
    one of :data:`STATUSES`; ``trips`` counts how many times the health
    detectors quarantined the request.  A request that never took a slot
    (evicted or rejected from the queue) has ``admitted_s=-1.0`` and no
    tokens.

    With an accuracy SLO the request also carries its canary audit trail:
    ``unit_final`` names the rung its slot sat on when it finished,
    ``canary_checks``/``canary_divergences`` count the canaries (and argmax
    disagreements) run against it, and ``unit_trips`` holds every demotion
    and promotion while it held the slot.  Without an SLO (or for a request
    that never took a slot) they keep their defaults.

    With speculative decoding ``spec_steps`` counts the draft-and-verify
    steps the request's slot ran while it held it and ``spec_accepted`` the
    drafts they accepted; :attr:`accepted_per_step` is their ratio."""

    uid: int
    prompt_len: int
    tokens: np.ndarray  # emitted tokens (<= max_new_tokens; ends at EOS)
    arrival_s: float
    admitted_s: float
    finished_s: float
    status: str = "ok"
    trips: int = 0
    unit_final: Optional[str] = None
    canary_checks: int = 0
    canary_divergences: int = 0
    unit_trips: tuple = ()
    spec_steps: int = 0
    spec_accepted: int = 0

    @property
    def latency_s(self) -> float:
        """End-to-end request latency: arrival to final token, seconds."""
        return self.finished_s - self.arrival_s

    @property
    def accepted_per_step(self) -> float:
        """Mean drafts accepted a speculative step for this request (0..k;
        0.0 without speculation or for a request that never took a slot)."""
        return self.spec_accepted / self.spec_steps if self.spec_steps else 0.0


@dataclasses.dataclass
class _Ticket:
    """A queue entry: the request and its quarantine count so far."""

    req: Request
    trips: int = 0


def _ticket_record(t: _Ticket) -> dict:
    """A JSON record of one queued or in-flight request: the fields of the
    journal's ``accepted`` record, and its trips."""
    r = t.req
    return {
        "uid": int(r.uid),
        "prompt": [int(x) for x in np.asarray(r.prompt)],
        "max_new_tokens": int(r.max_new_tokens),
        "arrival_s": float(r.arrival_s),
        "deadline_s": None if r.deadline_s is None else float(r.deadline_s),
        "trips": int(t.trips),
    }


def _ticket_from_record(rec: dict, *, arrival_s: float = 0.0) -> _Ticket:
    """A queue ticket from a snapshot or journal record.  The dead run's
    clock means nothing here: a restored request is due at once
    (``arrival_s=0``) and its ``deadline_s`` window restarts at resume."""
    req = Request(uid=int(rec["uid"]), prompt=np.asarray(rec["prompt"], np.int32),
                  max_new_tokens=int(rec["max_new_tokens"]), arrival_s=arrival_s,
                  deadline_s=rec.get("deadline_s"))
    return _Ticket(req, trips=int(rec.get("trips", 0)))


class Engine:
    """Slot-pool scheduler around the admit step and the decode chunk.

    Typical use::

        eng = Engine(model, cfg, num_slots=4, cache_len=64)
        eng.warmup(prompt_lens={6, 8})
        done = eng.run(requests)          # {uid: Completion}

    The pool lives on the model's device.  On the card the first decode
    chunk (in :meth:`warmup`, or else in :meth:`run`) runs eagerly on a side
    stream and is then captured as one CUDA graph over the pool's tensors;
    every later chunk is one replay.  A capture or replay that fails raises.
    With canaries, each firing pattern of a chunk has its graph, captured
    the first time it comes (:meth:`warmup` captures them all).

    ``slo=`` takes an :class:`AccuracySLO` and ``telemetry=`` a path or a
    :class:`~repro_torch.launch.telemetry.Telemetry`; ``spec=`` a
    :class:`SpecConfig`, with ``draft_model=(model, cfg)`` for model
    drafting.

    ``mesh=`` (a ``launch.mesh`` DeviceMesh over the whole process group;
    every rank builds the same Engine from the same whole model and drives
    it with the same requests) runs the scheduler on the mesh, ``rules=``
    defaulting to ``serve_rules(cfg, mesh)`` (tensor parallel; see the
    module docstring).  With ``serve_rules(..., replicate_params=True)``
    the tokens are bit-identical to the one-device engine's, ``faults=``
    and ``slo=`` included: a fault site hashes each element's global index
    (the rank's rows at their slots), and the SLO's rungs and canary stats
    are the rank's slot rows of the engine's.  ``spec=`` does not run on a
    mesh (ValueError, as in the reference).
    """

    def __init__(self, model: lm.LM, cfg: ModelConfig, *, num_slots: int = 4,
                 cache_len: int = 64, quantized_kv: bool = False, chunk: int = 8,
                 eos_id: Optional[int] = None, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, faults: Optional[FaultConfig] = None, detectors: bool = True,
                 logit_sentinel: float = 1e4, quarantine_retries: int = 0,
                 max_dispatch_retries: int = 3, dispatch_backoff_s: float = 0.001,
                 max_queue: Optional[int] = None, shed_policy: str = "reject-new",
                 snapshot_dir=None, snapshot_every_chunks: Optional[int] = None,
                 journal=None, slo: Optional[AccuracySLO] = None, telemetry=None,
                 spec: Optional[SpecConfig] = None, draft_model: Optional[tuple] = None,
                 mesh=None, rules=None):
        if num_slots < 1 or cache_len < 2 or chunk < 1:
            raise ValueError(
                f"need num_slots >= 1, cache_len >= 2, chunk >= 1 "
                f"(got {num_slots}, {cache_len}, {chunk})"
            )
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES} (got {shed_policy!r})")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 when set (got {max_queue})")
        if snapshot_every_chunks is not None:
            if snapshot_every_chunks < 1:
                raise ValueError(f"snapshot_every_chunks must be >= 1 when set "
                                 f"(got {snapshot_every_chunks})")
            if snapshot_dir is None:
                raise ValueError("snapshot_every_chunks needs snapshot_dir= (nowhere to "
                                 "commit the autosaves)")
        if spec is not None:
            if not isinstance(spec, SpecConfig):
                raise TypeError(f"spec must be a SpecConfig (got {type(spec)!r})")
            if temperature != 0.0 or top_k != 0:
                raise ValueError("speculative decoding is greedy-only (the acceptance rule "
                                 "compares argmaxes); drop temperature/top_k or spec=")
            if mesh is not None:
                raise ValueError("speculative decoding does not run on a mesh yet; drop "
                                 "mesh= or spec=")
            lm._validate_spec_cfg(cfg)
            lm._validate_spec_k(cfg, spec.k)
            if spec.k + 1 > cache_len:
                raise ValueError(f"spec.k+1={spec.k + 1} exceeds cache_len ({cache_len})")
            if spec.draft == "model":
                if draft_model is None:
                    raise ValueError("spec.draft='model' needs draft_model=(draft_model, "
                                     "draft_cfg)")
                dcfg = draft_model[1]
                lm._validate_spec_cfg(dcfg, what="draft model")
                if dcfg.vocab != cfg.vocab:
                    raise ValueError(f"draft vocab {dcfg.vocab} != target vocab {cfg.vocab}")
                if snapshot_dir is not None or snapshot_every_chunks is not None:
                    raise ValueError("snapshots cover n-gram speculation only: the n-gram "
                                     "history rebuilds from slot metadata at resume, but a "
                                     "draft-model KV cache does not serialize in snapshot "
                                     "format 1; use spec.draft='ngram' with snapshot_dir=")
        elif draft_model is not None:
            raise ValueError("draft_model= without spec= has no effect; pass "
                             "spec=SpecConfig(draft='model')")
        if mesh is not None:
            if mesh.size() != dist.get_world_size():
                raise ValueError(f"the engine's mesh must span the process group: mesh of "
                                 f"{mesh.size()} ranks, world size {dist.get_world_size()}")
        self.spec = spec
        self._draft_model = draft_model if spec is not None and spec.draft == "model" else None
        # sqrt-site fault schedules ride the serving config; activation faults
        # become a logits hook inside the decode chunk; dispatch faults stay
        # on the host.  The exact fallback strips all of them (exact_twin).
        if faults is not None and faults.targets_sqrt:
            cfg = cfg.replace(sqrt_faults=faults)
        if slo is not None and not isinstance(slo, AccuracySLO):
            raise TypeError(f"slo must be an AccuracySLO (got {type(slo)!r})")
        self.slo = slo
        self._ladder: Optional[tuple] = None
        if slo is not None:
            ladder = slo.ladder if slo.ladder is not None else (cfg.sqrt_unit, "exact")
            if ladder[0] != cfg.sqrt_unit:
                raise ValueError(
                    f"slo.ladder rung 0 must be the serving config's sqrt_unit "
                    f"{cfg.sqrt_unit!r} (got {ladder[0]!r}): the ladder demotes from the "
                    f"configured datapath")
            resolve_ladder(ladder)  # names and shape, before any device work
            self._ladder = tuple(ladder)
            # the ladder rides the config: decode then takes the rung vector
            cfg = cfg.replace(sqrt_ladder=self._ladder)
        self._canary_stride = (0 if slo is None or slo.canary_stride is None
                               else int(slo.canary_stride))
        self.mesh = mesh
        self.rules = rules if rules is not None or mesh is None else sharding.serve_rules(cfg, mesh)
        # rank 0 alone writes the host's files on a mesh; the others read them
        self._writer = mesh is None or dist.get_rank() == 0
        self._telemetry = (telemetry if telemetry is None or isinstance(telemetry, Telemetry)
                           else Telemetry(telemetry)) if self._writer else None
        # experts sharded over a mesh axis: their collectives span ranks that
        # do not hold an admitted slot, so every rank runs each admission
        self._admit_everywhere = False
        if mesh is not None:  # this rank's blocks of the weights
            model = sharding.place_model(model, cfg, mesh, self.rules)
            if cfg.moe is not None:
                with maybe_axis_rules(mesh, self.rules):
                    self._admit_everywhere = bool(mesh_axes(("expert",),
                                                            (cfg.moe.n_experts,), 0))
        self.model = model
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.quantized_kv = quantized_kv
        self.chunk = chunk
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.snapshot_dir = None if snapshot_dir is None else Path(snapshot_dir)
        self.snapshot_every_chunks = snapshot_every_chunks
        journal = (journal if journal is None or isinstance(journal, RequestJournal)
                   else RequestJournal(journal))
        self._journal_path = None if journal is None else journal.path
        self._journal = journal if self._writer else None
        self.faults = faults
        self.detectors = detectors
        self.logit_sentinel = float(logit_sentinel)
        self.quarantine_retries = int(quarantine_retries)
        self.max_dispatch_retries = int(max_dispatch_retries)
        self.dispatch_backoff_s = float(dispatch_backoff_s)
        self._injector = (DispatchFaultInjector(faults)
                          if faults is not None and faults.targets_dispatch else None)
        self._hook = _make_logits_hook(faults)
        self.device = _device_of(model)
        # on a mesh the pool's DTensors (``_dpool``) and this rank's blocks
        # of them (``pool``, which every step updates in place); the rank
        # holds slots [_row0, _row0 + its rows)
        self._dpool = self._pool_sh = None
        self._row0 = 0
        if mesh is None:
            self.pool = lm.init_pool_state(cfg, num_slots, cache_len, quantized=quantized_kv,
                                           device=self.device)
        else:
            self._pool_sh = sharding.serve_pool_shardings(
                cfg, mesh, self.rules, num_slots=num_slots, cache_len=cache_len,
                quantized=quantized_kv)
            self._dpool = sharding.zeros_tree(
                lm.init_pool_state(cfg, num_slots, cache_len, quantized=quantized_kv,
                                   abstract=True),
                sharding.serve_pool_tree(self._pool_sh))
            self.pool = sharding.local_tree(self._dpool)
            self._row0 = sharding.local_rows(num_slots, self._pool_sh["vec"]).start
        b_local = self.pool["tok"].shape[0]
        self._slots = torch.arange(b_local, device=self.device)
        dev = self.device

        def zeros(dtype):
            return torch.zeros(b_local, dtype=dtype, device=dev)

        # the health latches (bad, mx) and the canary stats (checks,
        # divergences, max and summed relative error) of the chunk, zeroed
        # by its first op
        self._health = (zeros(torch.bool), zeros(torch.float32)) if detectors else None
        self._canary = (tuple(zeros(dt) for dt in (torch.int32, torch.int32, torch.float32,
                                                   torch.float32))
                        if self._canary_stride else None)
        # the per-slot ladder rungs the chunk reads; the host writes them in
        # place at a chunk boundary after a rung changed
        self._levels = zeros(torch.int32) if slo is not None else None
        # speculation: the fed-token history (the n-gram source), the draft
        # model's slot cache, and the chunk's accepted drafts and spec steps
        # a slot (zeroed by its first op); all cleared by reset()
        self._hist = self._dcache = self._spec_counts = None
        if spec is not None:
            self._hist = torch.zeros((num_slots, cache_len), dtype=torch.int32, device=dev)
            if self._draft_model is not None:
                self._dcache = lm.init_cache(self._draft_model[1], num_slots, cache_len,
                                             device=dev)
            self._spec_counts = (zeros(torch.int32), zeros(torch.int32))
        # the tokens a slot feeds in a chunk: one a step, k+1 a spec step
        self._width = chunk * (spec.k + 1 if spec is not None else 1)
        # what a chunk hands to the host in one copy, int32: tokens fed
        # (b, width), emission mask (b, width), liveness after the chunk (b,),
        # with detectors bad (b,) and mx's float32 bits (b,), with canaries
        # their checks, divergences and the float32 bits of the max and
        # summed relative errors (4 x (b,)), with speculation the accepted
        # drafts and spec steps (2 x (b,))
        cols = (2 * self._width + 1 + 2 * detectors + 4 * (self._canary is not None)
                + 2 * (spec is not None))
        self._packed = torch.zeros((b_local, cols), dtype=torch.int32, device=dev)
        # the captured chunk, one graph a firing pattern of canary steps:
        # {pattern: (graph, the launches a replay adds)}
        self._graphs: dict = {}
        self._restored_step: Optional[int] = None  # the snapshot step a resume restored
        self.reset()

    # -- pool state ---------------------------------------------------------

    def reset(self):
        """Zero the pool in place (all slots free, every rung 0), empty the
        queues and rewind the dispatch fault schedule.  The pool keeps its
        tensors, so a captured chunk stays valid.  The lifetime chunk
        counter (the default snapshot step and the canaries' clock)
        survives, so autosaves never collide."""
        for t in lm.pool_tensors(self.pool) + self._spec_tensors():
            t.zero_()
        b = self.num_slots
        self._owner: list = [None] * b
        self._emitted: list = [[] for _ in range(b)]
        self._admitted_s = [0.0] * b
        self._trips = [0] * b
        self._queue: deque = deque()  # due tickets waiting for a slot
        self._arrivals: deque = deque()  # accepted tickets not yet due
        self._dispatch_faults = 0
        self._dispatch_retries = 0
        self._snapshots_written = 0
        self._journal_replays = 0
        self._chunks_total = getattr(self, "_chunks_total", 0)
        # accuracy-SLO slot state (inert without slo=): the rung each slot
        # decodes at, the promotion streak, divergences at the current rung,
        # and the occupant's canary audit (reset at admission; the rung
        # itself is slot-scoped and sticky)
        self._unit_levels = np.zeros(b, np.int32)
        self._levels_stale = False
        if self._levels is not None:
            self._levels.zero_()
        self._clean_streak = np.zeros(b, np.int32)
        self._rung_div = np.zeros(b, np.int32)
        self._slot_canary_checks = np.zeros(b, np.int64)
        self._slot_canary_div = np.zeros(b, np.int64)
        self._slot_events: list = [[] for _ in range(b)]
        # speculation's counters: per occupant (reset at admission) and for
        # the engine's lifetime
        self._slot_spec_steps = np.zeros(b, np.int64)
        self._slot_spec_acc = np.zeros(b, np.int64)
        self._spec_steps_total = getattr(self, "_spec_steps_total", 0)
        self._spec_acc_total = getattr(self, "_spec_acc_total", 0)
        if self._injector is not None:
            self._injector.reset()

    def _spec_tensors(self) -> list:
        """The speculation state beside the pool (the history and the draft
        cache's leaves), never reallocated: a graph holds their addresses."""
        if self.spec is None:
            return []
        return [self._hist] + (lm._cache_leaves(self._dcache) if self._dcache is not None else [])

    def _row(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's block of the pool, or None where
        another rank holds it."""
        r = slot - self._row0
        return r if 0 <= r < self._slots.shape[0] else None

    def _scope(self, rows: Optional[int] = None):
        """The rule scope of a device step: the mesh's, or none.  Its tensors'
        rows are blocks of ``rows`` (default: the pool's slots)."""
        return maybe_axis_rules(self.mesh, self.rules,
                                {"batch": self.num_slots if rows is None else rows})

    def _now(self, clock: Callable[[], float], t0: float) -> float:
        """Seconds since ``t0`` on rank 0's ``clock``, which every rank of a
        mesh reads (a broadcast), so their schedulers decide alike."""
        now = clock() - t0
        if self.mesh is None or self.mesh.size() == 1:
            return now
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0)
        return float(t.item())

    @property
    def unit_levels(self) -> tuple:
        """Per-slot ladder rungs (0: the serving datapath); empty without an
        accuracy SLO."""
        if self._ladder is None:
            return ()
        return tuple(int(x) for x in self._unit_levels)

    @property
    def unit_names(self) -> tuple:
        """Per-slot datapath names at the current rungs; empty without an
        accuracy SLO."""
        if self._ladder is None:
            return ()
        return tuple(self._ladder[int(x)] for x in self._unit_levels)

    def _set_level(self, slot: int, level: int) -> None:
        self._unit_levels[slot] = level
        self._levels_stale = True

    def warmup(self, prompt_lens):
        """Admit one request of each prompt length and run one decode chunk
        (on the card: each firing pattern's eager run and capture), off the
        serving clock, then reset the pool.  The reset wipes restored state:
        warm an engine up before restoring into it, not after
        :meth:`resume`."""
        for s in sorted(set(int(s) for s in prompt_lens)):
            self._admit(Request(uid=-1, prompt=np.zeros(s, np.int32), max_new_tokens=1),
                        slot=0, now=0.0)
        patterns = self._patterns() if self.device.type == "cuda" else [self._firing()]
        for fire in patterns:
            self._dispatch(self._run_chunk, fire)
        self.reset()

    # -- crash consistency: snapshot / resume / journal replay --------------

    def snapshot(self, ckpt_dir=None, *, step: Optional[int] = None) -> Path:
        """Write the whole live serving state through ``checkpoint.save``'s
        atomic commit and return the committed directory: the pool as
        ``{"pool": ...}`` (every cache leaf and the per-slot vectors, under
        the reference's leaf names) and the host's records as a JSON
        ``"meta"`` blob (per-slot requests with their emitted tokens and
        trips, the pending queue, the engine's shape), in the reference's
        snapshot format 1.  ``step`` defaults to the lifetime chunk count."""
        ckpt_dir = ckpt_dir if ckpt_dir is not None else self.snapshot_dir
        if ckpt_dir is None:
            raise ValueError("snapshot needs a directory: pass ckpt_dir= or "
                             "construct the Engine with snapshot_dir=")
        if self._draft_model is not None:
            raise ValueError("snapshot covers n-gram speculation only (the draft-model KV "
                             "cache does not serialize in snapshot format 1)")
        step = self._chunks_total if step is None else int(step)
        slots_meta = []
        for slot in range(self.num_slots):
            req = self._owner[slot]
            if req is None:
                slots_meta.append(None)
                continue
            rec = _ticket_record(_Ticket(req, self._trips[slot]))
            rec["emitted"] = [int(x) for x in self._emitted[slot]]
            slots_meta.append(rec)
        meta = {
            "format": _SNAPSHOT_FORMAT,
            "engine": {
                "num_slots": self.num_slots,
                "cache_len": self.cache_len,
                "quantized_kv": self.quantized_kv,
                "chunk": self.chunk,
                "eos_id": self.eos_id,
                "temperature": self.temperature,
                "top_k": self.top_k,
                "seed": self.seed,
                "max_queue": self.max_queue,
                "shed_policy": self.shed_policy,
                "slo": None if self.slo is None else dataclasses.asdict(self.slo),
                # additive key: readers without speculation ignore it
                "spec": None if self.spec is None else dataclasses.asdict(self.spec),
            },
            "chunks_total": int(self._chunks_total),
            "slots": slots_meta,
            # pending work in service order: the due queue, then future
            # arrivals; all of it is due at once after a resume
            "queue": [_ticket_record(t) for t in self._queue]
            + [_ticket_record(t) for t in self._arrivals],
        }
        if self._ladder is not None:
            # additive key (the format is unchanged): the ladder state; the
            # journal's demoted/promoted records are its flushed shadow
            meta["slo"] = {
                "unit_levels": [int(x) for x in self._unit_levels],
                "clean_streak": [int(x) for x in self._clean_streak],
                "rung_div": [int(x) for x in self._rung_div],
                "canary_checks": [int(x) for x in self._slot_canary_checks],
                "canary_divergences": [int(x) for x in self._slot_canary_div],
                "events": [list(e) for e in self._slot_events],
            }
        blob = np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8)
        pool = self.pool if self.mesh is None else self._dpool
        path = checkpoint.save(ckpt_dir, step, {"pool": pool, "meta": blob})
        self._snapshots_written += 1
        if self._journal is not None:
            self._journal.snapshot(step)
        return path

    @staticmethod
    def _read_snapshot_meta(ckpt_dir, step: int) -> dict:
        """The host-metadata blob of a committed snapshot alone (the pool's
        shape depends on it)."""
        final = Path(ckpt_dir) / f"step-{step}"
        man_path = final / "manifest.json"
        if not man_path.exists():
            raise checkpoint.CheckpointError(f"no committed engine snapshot at {final}")
        manifest = json.loads(man_path.read_text())
        entry = next((leaf for leaf in manifest["leaves"] if leaf["name"] == "meta"), None)
        if entry is None:
            raise checkpoint.CheckpointError(
                f"snapshot {final} has no 'meta' leaf — not an engine snapshot")
        meta = json.loads(np.load(final / entry["file"]).tobytes().decode("utf-8"))
        if meta.get("format") != _SNAPSHOT_FORMAT:
            raise checkpoint.CheckpointError(
                f"snapshot {final} has format {meta.get('format')!r}; this "
                f"build reads format {_SNAPSHOT_FORMAT}")
        return meta

    @classmethod
    def resume(cls, model: lm.LM, cfg: ModelConfig, ckpt_dir=None, *, step: Optional[int] = None,
               journal=None, mesh=None, rules=None, **overrides) -> "Engine":
        """Rebuild a crashed engine: restore the latest committed snapshot
        under ``ckpt_dir`` (if any), then reconcile the write-ahead journal
        on top.  Restored in-flight slots continue decoding and restored
        queue entries are served first, ahead of new requests passed to
        :meth:`run`.

        * Journal reconciliation: uids journaled ``finished`` are dropped
          from the restored state; ``accepted`` uids with no finished record
          and no place in the snapshot are replayed from their journal
          fields (the ``journal_replays`` stat).
        * Overrides: scheduling options (``chunk``, ``detectors``,
          ``max_queue``, ``snapshot_every_chunks``, ...) may be overridden;
          the pool's shape (``num_slots``, ``cache_len``, ``quantized_kv``)
          is part of the snapshot and cannot change.
        * With no snapshot committed, the engine is built from
          ``overrides`` alone and recovery is journal replay only.
        * A snapshot the JAX package wrote restores too (the same format);
          the sampling words of its occupied slots are rebuilt from (seed,
          uid), the port's stream (ROADMAP C.15, C.18).
        * A snapshot of a speculative engine restores its ``spec`` (unless
          ``spec=`` overrides it, None turning speculation off); the n-gram
          history, which the snapshot does not hold, is rebuilt from the
          slots' prompts and emitted tokens.
        * Elastic resharding: ``mesh=`` (and ``rules=``) lands a snapshot
          taken on one mesh shape on another: the pool's leaves are read on
          the host and placed by ``serve_pool_shardings`` (one device to a
          mesh and back).

        Do not call :meth:`warmup` on the result (it resets the pool)."""
        if step is None and ckpt_dir is not None:
            step = checkpoint.latest_step(ckpt_dir)
        meta = None
        if step is not None:
            meta = cls._read_snapshot_meta(ckpt_dir, step)
            e = meta["engine"]
            kw = {k: e[k] for k in ("num_slots", "cache_len", "quantized_kv", "chunk",
                                    "eos_id", "temperature", "top_k", "seed")}
            kw["max_queue"] = e.get("max_queue")
            kw["shed_policy"] = e.get("shed_policy", "reject-new")
            if e.get("slo") is not None:
                kw["slo"] = AccuracySLO(**e["slo"])
            if e.get("spec") is not None:
                kw["spec"] = SpecConfig(**e["spec"])
            for frozen in ("num_slots", "cache_len", "quantized_kv"):
                if frozen in overrides and overrides[frozen] != kw[frozen]:
                    raise ValueError(
                        f"resume cannot change {frozen}: the snapshot pool "
                        f"was shaped with {kw[frozen]!r} (got "
                        f"{overrides[frozen]!r}); the pool shape is part of "
                        f"the serialized state"
                    )
            kw.update(overrides)
        else:
            kw = dict(overrides)
        if journal is not None:
            kw.setdefault("journal", journal)
        if ckpt_dir is not None:
            kw.setdefault("snapshot_dir", ckpt_dir)
        eng = cls(model, cfg, mesh=mesh, rules=rules, **kw)
        if step is not None:
            eng._restore_snapshot(ckpt_dir, step, meta)
        eng._replay_journal()
        return eng

    def _restore_snapshot(self, ckpt_dir, step: int, meta: dict) -> None:
        """Install a committed snapshot: its pool written into this engine's
        pool tensors in place (a graph captured on them stays valid; on a
        mesh each rank's block, placed by the pool's shardings), and the
        host's slot and queue records."""
        if self.mesh is None:
            restored = checkpoint.restore(ckpt_dir, step, {"pool": self.pool})["pool"]
        else:
            restored = checkpoint.restore(
                ckpt_dir, step, {"pool": self._dpool},
                shardings={"pool": sharding.serve_pool_tree(self._pool_sh)})["pool"]
            restored = sharding.local_tree(restored)
        for t, r in zip(lm.pool_tensors(self.pool), lm.pool_tensors(restored)):
            t.copy_(r)
        del restored
        for slot, rec in enumerate(meta["slots"]):
            if rec is None:
                continue
            t = _ticket_from_record(rec)
            self._owner[slot] = t.req
            self._emitted[slot] = [int(x) for x in rec.get("emitted", [])]
            self._admitted_s[slot] = 0.0  # clocks restart at resume
            self._trips[slot] = t.trips
            self._set_stream(slot, t.req.uid)
        self._queue = deque(_ticket_from_record(r) for r in meta["queue"])
        self._chunks_total = int(meta["chunks_total"])
        self._restored_step = int(step)
        if self.spec is not None:
            # the history is not in the snapshot: hist[p] is the token fed at
            # position p, the prompt then the emitted tokens, so a resumed
            # slot drafts from what an uninterrupted run would hold
            hist = np.zeros((self.num_slots, self.cache_len), np.int32)
            for slot, rec in enumerate(meta["slots"]):
                if rec is not None:
                    fed = (list(rec["prompt"]) + rec.get("emitted", []))[:self.cache_len]
                    hist[slot, :len(fed)] = fed
            self._hist.copy_(torch.from_numpy(hist))
        s = meta.get("slo")
        if s is not None and self._ladder is not None:
            top = len(self._ladder) - 1
            self._unit_levels = np.clip(np.asarray(s["unit_levels"], np.int64), 0,
                                        top).astype(np.int32)
            self._levels_stale = True
            self._clean_streak = np.asarray(s["clean_streak"], np.int32)
            self._rung_div = np.asarray(s["rung_div"], np.int32)
            self._slot_canary_checks = np.asarray(s["canary_checks"], np.int64)
            self._slot_canary_div = np.asarray(s["canary_divergences"], np.int64)
            self._slot_events = [list(e) for e in s["events"]]

    def _replay_journal(self) -> None:
        """Reconcile the write-ahead journal with the restored state:
        finished uids are done exactly once (dropped everywhere); accepted
        uids neither queued nor in a slot are replayed."""
        if self._journal_path is None:
            return
        records = read_journal(self._journal_path)
        if not records:
            return
        finished, accepted = replay_plan(records)
        for slot in range(self.num_slots):
            owner = self._owner[slot]
            if owner is not None and owner.uid in finished:
                # free the slot and clear its liveness (the row decays
                # harmlessly, as in quarantine)
                self._owner[slot] = None
                self._emitted[slot] = []
                if self._row(slot) is not None:
                    self.pool["active"][self._row(slot)] = False
        self._queue = deque(t for t in self._queue if t.req.uid not in finished)
        present = ({t.req.uid for t in self._queue}
                   | {o.uid for o in self._owner if o is not None})
        for uid, rec in accepted.items():
            if uid not in present:
                self._queue.append(_ticket_from_record({**rec, "trips": 0}))
                self._journal_replays += 1
        if self._ladder is not None:
            # ladder trips journaled after the restored snapshot override its
            # rungs; with no snapshot the whole trail rebuilds them, so a
            # crash in degraded mode resumes degraded either way
            recs = records
            if self._restored_step is not None:
                marks = [i for i, r in enumerate(records)
                         if r.get("kind") == "snapshot" and r.get("step") == self._restored_step]
                if marks:
                    recs = records[marks[-1] + 1:]
            top = len(self._ladder) - 1
            for slot, lv in replay_unit_levels(recs).items():
                if 0 <= slot < self.num_slots:
                    self._set_level(slot, min(max(int(lv), 0), top))

    # -- admission ----------------------------------------------------------

    def _validate(self, req: Request):
        """Reject a malformed request up front, naming the request id and the
        offending field, before it can touch any slot state."""
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1:
            raise ValueError(
                f"request {req.uid}: field 'prompt' must be a 1-D token "
                f"array (got shape {prompt.shape})"
            )
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(
                f"request {req.uid}: field 'prompt' must hold integer token "
                f"ids (got dtype {prompt.dtype})"
            )
        s = int(prompt.shape[0])
        if s < 1:
            raise ValueError(
                f"request {req.uid}: field 'prompt' needs >= 1 prompt token "
                f"(got {s})"
            )
        if not isinstance(req.max_new_tokens, (int, np.integer)) or req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.uid}: field 'max_new_tokens' needs an integer "
                f"generation budget >= 1 (got {req.max_new_tokens!r})"
            )
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(
                f"request {req.uid}: field 'deadline_s' must be positive "
                f"when set (got {req.deadline_s})"
            )
        if not self.cfg.is_subquadratic and s + req.max_new_tokens > self.cache_len:
            # a dense (global-attention) cache is not a ring: positions past
            # cache_len would wrap onto the request's own KV
            raise ValueError(
                f"request {req.uid}: fields 'prompt' ({s}) + 'max_new_tokens' "
                f"budget ({req.max_new_tokens}) exceeds the dense cache_len "
                f"({self.cache_len}); allocate a larger pool"
            )

    def _dispatch(self, fn, *args):
        """Run a device step under the dispatch fault schedule: an injected
        failure raises BEFORE the call (the pool tensors stay untouched), is
        retried with exponential backoff up to ``max_dispatch_retries``, and
        only then escalates as :class:`DispatchFault`."""
        if self._injector is None:
            return fn(*args)
        attempts = 0
        while self._injector.should_fail():
            attempts += 1
            self._dispatch_faults += 1
            if attempts > self.max_dispatch_retries:
                raise DispatchFault(
                    f"dispatch failed {attempts} consecutive times "
                    f"(max_dispatch_retries={self.max_dispatch_retries})"
                )
            self._dispatch_retries += 1
            time.sleep(self.dispatch_backoff_s * (2 ** (attempts - 1)))
        return fn(*args)

    def _set_stream(self, slot: int, uid: int):
        """The slot's sampling words: the request's stream (seed, uid),
        keyed by uid, not by slot (on the ranks that hold the slot)."""
        row = self._row(slot)
        if row is not None:
            self.pool["keys"][row, 0] = self.seed & 0xFFFFFFFF
            self.pool["keys"][row, 1] = uid & 0x7FFFFFFF

    def _rung_cfg(self, level: int) -> ModelConfig:
        """The config a slot on ladder rung ``level`` prefills with: the
        serving config at rung 0, else the rung's unit, fault-free and
        ladder-free (the KV cache depends on the datapath through the
        qk-norm, so a demoted slot prefills on its rung too)."""
        if level == 0:
            return self.cfg
        return self.cfg.replace(sqrt_unit=self._ladder[level], sqrt_faults=None,
                                sqrt_ladder=None)

    def _admit_device(self, req: Request, slot: int):
        """Prefill ``req`` into ``slot`` of the live pool on the slot's rung
        and draw its first token from the request's own stream, at the
        position of the prompt's last token, as every later token draws at
        its own.  On a mesh only the ranks that hold the slot do, at its
        local row."""
        row = self._row(slot)
        if row is None and not self._admit_everywhere:
            return
        pool, dev = self.pool, self.device
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32, device=dev)[None]
        s = prompt.shape[1]
        cfg = self._rung_cfg(int(self._unit_levels[slot]))
        if row is None:  # the same prefill into a scratch row, for its collectives
            lm.prefill_into_slots(self.model, cfg, lm.slot_rows_like(cfg, pool["cache"], 1),
                                  prompt, self._slots[:1], mesh=self.mesh, rules=self.rules)
            return
        logits, _ = lm.prefill_into_slots(self.model, cfg, pool["cache"], prompt,
                                          self._slots[row:row + 1], mesh=self.mesh,
                                          rules=self.rules)
        self._set_stream(slot, req.uid)
        last_pos = torch.full((1,), s - 1, dtype=torch.int32, device=dev)
        pool["tok"][row] = lm.sample_tokens(logits[:, -1].float(), last_pos,
                                            pool["keys"][row:row + 1], self.temperature,
                                            self.top_k)
        pool["pos"][row] = s
        pool["active"][row] = True
        pool["remaining"][row] = int(req.max_new_tokens)
        if self.spec is not None:
            # the prompt is the slot's fed history; what a previous occupant
            # left past it stays masked (the drafter reads p < pos only)
            w = min(s, self.cache_len)
            self._hist[slot, :w] = prompt[0, :w]
            if self._draft_model is not None:
                dmodel, dcfg = self._draft_model
                lm.prefill_into_slots(dmodel, dcfg, self._dcache, prompt,
                                      self._slots[slot:slot + 1])

    def _admit(self, req: Request, slot: int, now: float, trips: int = 0):
        self._validate(req)
        self._dispatch(self._admit_device, req, slot)
        self._owner[slot] = req
        self._emitted[slot] = []
        self._admitted_s[slot] = now
        self._trips[slot] = trips
        # the occupant's canary audit resets; the rung is the slot's
        self._slot_canary_checks[slot] = 0
        self._slot_canary_div[slot] = 0
        self._slot_events[slot] = []
        self._slot_spec_steps[slot] = 0
        self._slot_spec_acc[slot] = 0

    # -- the decode chunk ---------------------------------------------------

    def _firing(self, chunks: Optional[int] = None) -> tuple:
        """The steps of a chunk that fire a canary, from the lifetime clock:
        the chunk after ``chunks`` chunks (default: the coming one)."""
        chunks = self._chunks_total if chunks is None else chunks
        return lm.canary_steps(self.chunk, self._canary_stride, chunks * self.chunk)

    def _patterns(self) -> list:
        """Every firing pattern the lifetime clock gives a chunk: the clock
        comes back to the same phase after ``stride / gcd(stride, chunk)``
        chunks."""
        n = self._canary_stride // math.gcd(self._canary_stride, self.chunk) or 1
        return sorted({self._firing(k) for k in range(n)})

    def _chunk_eager(self, fire: Optional[tuple] = None):
        """``chunk`` decode steps (speculative steps with ``spec=``) over the
        pool, eagerly, into the packed buffer, the canary on the steps in
        ``fire`` (default: the coming chunk's); the health latches, canary
        stats and spec counters are zeroed first."""
        c, w = self.chunk, self._width
        fire = self._firing() if fire is None else fire
        latches = (self._health or ()) + (self._canary or ()) + (self._spec_counts or ())
        for t in latches:
            t.zero_()
        toks, emitted = self._packed[:, :w], self._packed[:, w:2 * w]
        draft = None if self._dcache is None else (*self._draft_model, self._dcache)
        # a slot on a demoted rung decodes one row a step: its row 0 is the
        # sequential demoted step
        demoted = None if self._levels is None or self.spec is None else self._levels > 0
        with self._scope():
            for i in range(c):
                if self.spec is None:
                    lm.decode_slots_step(self.model, self.cfg, self.pool, toks, emitted, i,
                                         eos_id=self.eos_id, temperature=self.temperature,
                                         top_k=self.top_k, unit_levels=self._levels,
                                         logits_hook=self._hook, health=self._health,
                                         canary=i in fire, canary_stats=self._canary)
                    continue
                lm.decode_slots_spec_step(
                    self.model, self.cfg, self.pool, self._hist, toks, emitted, i,
                    k=self.spec.k, counts=self._spec_counts, eos_id=self.eos_id,
                    unit_levels=self._levels, spec_disable=demoted, logits_hook=self._hook,
                    health=self._health, canary=i in fire, canary_stats=self._canary,
                    draft=draft)
        self._packed[:, 2 * w] = self.pool["active"]
        for j, t in enumerate(latches):
            self._packed[:, 2 * w + 1 + j] = t.view(torch.int32) if t.is_floating_point() else t

    def _capture(self, fire: tuple):
        """This chunk eagerly on a side stream (it loads every kernel, plans
        each launch and warms the allocator), then the same steps captured as
        one CUDA graph over the pool's tensors and the packed buffer, in the
        memory pool of the graphs captured before.  The capture launches
        nothing: the launches it counts become what each replay adds.

        The garbage collector is held off during the capture: a dead
        engine's graph that it collected mid-capture would be
        destroyed on a capturing stream, which CUDA refuses, and the capture
        would fail (a cuBLAS call in it reports the invalidated capture)."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._chunk_eager(fire)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        mempool = next(iter(self._graphs.values()))[0].pool() if self._graphs else None
        collecting = gc.isenabled()
        gc.disable()
        try:
            with dispatch.capture_launches() as launches, torch.cuda.graph(graph, pool=mempool):
                self._chunk_eager(fire)
        finally:
            if collecting:
                gc.enable()
        self._graphs[fire] = (graph, launches)

    def _write_levels(self):
        """Write the host's rungs into the device tensor the chunk reads, in
        place, if one changed since the last write (never inside a chunk:
        a graph holds the tensor's address, not a host copy)."""
        if self._levels_stale:
            rows = self._unit_levels[self._row0:self._row0 + self._levels.shape[0]]
            self._levels.copy_(torch.from_numpy(rows))
            self._levels_stale = False

    def _run_chunk(self, fire: tuple):
        self._write_levels()
        if self.device.type != "cuda":
            self._chunk_eager(fire)
        elif fire not in self._graphs:
            self._capture(fire)
        else:
            graph, launches = self._graphs[fire]
            graph.replay()
            dispatch.replay_launches(launches)

    def _decode_chunk(self):
        """Advance the pool one chunk.  Returns numpy (tokens fed (b, width),
        emitted (b, width) bool, active (b,) bool, bad (b,) bool, mx (b,)
        float32, canary checks (b,) int32, divergences (b,) int32, max
        relative error (b,) float32, summed relative error (b,) float32),
        read in one copy, ``width`` the chunk's steps times the rows a step
        (k+1 with ``spec=``); without detectors or canaries their columns are
        zeros.  With speculation the chunk's accepted drafts and spec steps
        come in the same copy and are added to the slots' counters."""
        self._dispatch(self._run_chunk, self._firing())
        packed = self._packed
        if self.mesh is not None:  # every rank's slot rows, in slot order
            packed = sharding.gather(packed, self._pool_sh["tok"])
        packed = packed.cpu().numpy()
        w, b = self._width, self.num_slots
        col = 2 * w + 1

        def take(n):
            nonlocal col
            out = packed[:, col:col + n]
            col += n
            return out

        bad, mx = (take(2).T if self._health is not None
                   else (np.zeros(b, np.int32), np.zeros(b, np.int32)))
        cc, cd, cmr, crs = take(4).T if self._canary is not None else (np.zeros(b, np.int32),) * 4
        if self.spec is not None:
            acc, steps = take(2).T
            self._slot_spec_acc += acc
            self._slot_spec_steps += steps
            self._spec_acc_total += int(acc.sum())
            self._spec_steps_total += int(steps.sum())

        def f32(bits):
            return np.ascontiguousarray(bits).view(np.float32)

        return (packed[:, :w], packed[:, w:2 * w].astype(bool), packed[:, 2 * w].astype(bool),
                bad.astype(bool), f32(mx), cc, cd, f32(cmr), f32(crs))

    def _slo_update(self, cc, cd, cmr, counters) -> None:
        """Apply one chunk's canary stats to the per-slot ladder: demote a
        slot one rung when it blew a budget this chunk, promote one rung
        after ``promote_after`` consecutive clean canaries.  Runs before the
        chunk's finish bookkeeping, so a request that ends this chunk sees
        its final rung and whole canary trail in its Completion."""
        slo, ladder = self.slo, self._ladder
        top = len(ladder) - 1
        for slot in range(self.num_slots):
            n = int(cc[slot])
            if n == 0:
                continue  # no canary fired for this slot this chunk
            dv, mr = int(cd[slot]), float(cmr[slot])
            counters["canary_checks"] += n
            counters["canary_divergences"] += dv
            counters["canary_max_rel_err"] = max(counters["canary_max_rel_err"], mr)
            self._slot_canary_checks[slot] += n
            self._slot_canary_div[slot] += dv
            self._rung_div[slot] += dv
            level = int(self._unit_levels[slot])
            owner = self._owner[slot]
            uid = None if owner is None else owner.uid
            over_div = (slo.divergence_budget is not None
                        and int(self._rung_div[slot]) > slo.divergence_budget)
            if over_div or mr > slo.rel_err_budget:
                self._clean_streak[slot] = 0
                if level < top:
                    level += 1
                    self._set_level(slot, level)
                    self._rung_div[slot] = 0
                    counters["demotions"] += 1
                    self._slot_events[slot].append({
                        "event": "demoted", "level": level, "unit": ladder[level],
                        "chunk": int(self._chunks_total), "max_rel_err": mr,
                        "divergences": dv})
                    if self._journal is not None:
                        self._journal.demoted(slot, uid, level, ladder[level])
            elif dv:
                self._clean_streak[slot] = 0  # divergent within budget: the streak restarts
            elif level > 0:
                self._clean_streak[slot] += n
                if (slo.promote_after is not None
                        and int(self._clean_streak[slot]) >= slo.promote_after):
                    level -= 1
                    self._set_level(slot, level)
                    self._clean_streak[slot] = 0
                    self._rung_div[slot] = 0
                    counters["promotions"] += 1
                    self._slot_events[slot].append({
                        "event": "promoted", "level": level, "unit": ladder[level],
                        "chunk": int(self._chunks_total)})
                    if self._journal is not None:
                        self._journal.promoted(slot, uid, level, ladder[level])

    # -- degradation and overload -------------------------------------------

    def _exact_fallback(self, req: Request):
        """The bottom rung of the degradation ladder: serve one request alone
        on the exact, fault-free datapath (greedy, batch 1).  Returns
        (tokens, healthy): ``healthy=False`` when even the exact path gives
        non-finite logits (status ``failed``)."""
        ecfg = lm.exact_twin(self.cfg)
        cache = None
        if self.mesh is not None:  # this rank's block of a one-row cache
            like = lm.init_cache(ecfg, 1, self.cache_len, quantized=self.quantized_kv,
                                 abstract=True)
            cache = sharding.local_tree(sharding.zeros_tree(like, sharding.shardings_for(
                lm.cache_specs(ecfg, quantized=self.quantized_kv), self.mesh, self.rules, like)))
        with self._scope(rows=1):
            logits, cache, s = _prefill_alone(self.model, ecfg, req.prompt,
                                              cache_len=self.cache_len,
                                              quantized_kv=self.quantized_kv, cache=cache)
            if not bool(torch.isfinite(logits[:, -1].float()).all()):
                return np.zeros(0, np.int32), False
            toks, _, _ = lm.generate_scan(self.model, ecfg, cache, logits[:, -1:].argmax(dim=-1),
                                          s, req.max_new_tokens)
        out = toks[0].cpu().numpy()
        if self.eos_id is not None:  # the slot path's rule: EOS emitted, then stop
            hits = np.nonzero(out == self.eos_id)[0]
            if hits.size:
                out = out[: hits[0] + 1]
        return out.astype(np.int32), True

    def _shed_victim(self, now: float) -> _Ticket:
        """The queued ticket admission control drops, per ``shed_policy``
        (see :data:`SHED_POLICIES`)."""
        q = self._queue
        if self.shed_policy == "reject-new":
            return q[-1]
        if self.shed_policy == "evict-latest-deadline":
            def effective_deadline(t):
                r = t.req
                dl = float("inf") if r.deadline_s is None else r.arrival_s + r.deadline_s
                return (dl, r.arrival_s, r.uid)
            return max(q, key=effective_deadline)

        # shed-by-slo: the smallest deadline slack loses; deadline-free
        # requests have infinite slack and shed newest first
        def slack(t):
            r = t.req
            s = float("inf") if r.deadline_s is None else (r.arrival_s + r.deadline_s) - now
            return (s, -r.arrival_s, -r.uid)
        return min(q, key=slack)

    # -- the serve loop -----------------------------------------------------

    def run(self, requests=(), *, deadline_s: float = 600.0,
            max_chunks: Optional[int] = None,
            clock: Optional[Callable[[], float]] = None) -> dict:
        """Serve ``requests`` (admitted no earlier than their ``arrival_s``,
        on ``clock`` from call start; equal arrivals in uid order) until all
        complete.  Returns {uid: Completion}, one per request with a
        structured ``status``; aggregate stats and fault counters go to
        ``self.stats``.  Nothing raises mid-batch but an exhausted dispatch
        retry budget.  On an engine built by :meth:`resume`, restored work is
        served first (``requests`` may be empty).  The whole trace is
        validated before serving starts.

        Deadlines evict: when the global ``deadline_s`` expires, in-flight
        requests are evicted with their partial tokens and queued ones with
        none (``admitted_s=-1.0``).  A request's own ``deadline_s`` (from its
        arrival) evicts just that request.

        With detectors on, a slot whose chunk tripped them (a non-finite
        logit, or max |logit| above ``logit_sentinel``) is quarantined: its
        emissions are discarded and the request re-queued at the front for
        up to ``quarantine_retries`` approximate-path attempts, after which
        it is served on the exact datapath (``degraded``; ``failed`` if even
        that is unhealthy).

        Overload: with ``max_queue=`` the due-request queue is bounded; past
        the bound ``shed_policy`` picks the tickets turned away (status
        ``rejected``, no tokens, ``admitted_s=-1.0``).

        Crash consistency: with a ``journal``, every request's ``accepted``
        record is fsynced before any device work and every terminal status
        writes a ``finished`` record; ``snapshot_every_chunks=`` autosaves.
        ``max_chunks=`` is the chaos hook: stop dead at that chunk boundary,
        with no draining and no terminal records for in-flight work, as a
        SIGKILL leaves it (``stats["killed"]``).

        ``clock`` (seconds; default ``time.perf_counter``, the wall clock)
        is every time the loop reads: arrivals, deadlines, ``Completion``
        times and ``stats``.  A deterministic clock (one that advances a
        fixed step a reading) makes admission order and slots a function of
        the trace alone, whatever the host's load."""
        requests = list(requests)
        for req in requests:
            self._validate(req)
        ordered = sorted(requests, key=lambda r: (r.arrival_s, r.uid))
        if self._journal is not None:
            for req in ordered:  # write-ahead: durable before any slot work
                self._journal.accepted(req)
        self._arrivals.extend(_Ticket(r) for r in ordered)
        queue, arrivals = self._queue, self._arrivals
        done: dict = {}
        counters = {"faults_detected": 0, "quarantine_retries": 0, "exact_fallbacks": 0,
                    "deadline_evictions": 0, "shed_rejections": 0, "canary_checks": 0,
                    "canary_divergences": 0, "canary_max_rel_err": 0.0, "demotions": 0,
                    "promotions": 0}
        clock = time.perf_counter if clock is None else clock
        t0 = clock()
        decode_chunks = 0
        spec0 = (self._spec_acc_total, self._spec_steps_total)
        peak_queue_depth = len(queue)
        queue_depth_sum = 0
        queue_depth_samples = 0
        telemetry_tokens = 0
        expired = False
        killed = False

        def finish(req, tokens, status, now, admitted_s, trips=0, slot=None):
            audit = {}
            if slot is not None and self._ladder is not None:
                audit = dict(unit_final=self._ladder[int(self._unit_levels[slot])],
                             canary_checks=int(self._slot_canary_checks[slot]),
                             canary_divergences=int(self._slot_canary_div[slot]),
                             unit_trips=tuple(self._slot_events[slot]))
            if slot is not None and self.spec is not None:
                audit.update(spec_steps=int(self._slot_spec_steps[slot]),
                             spec_accepted=int(self._slot_spec_acc[slot]))
            done[req.uid] = Completion(uid=req.uid, prompt_len=len(req.prompt),
                                       tokens=np.asarray(tokens, np.int32),
                                       arrival_s=req.arrival_s, admitted_s=admitted_s,
                                       finished_s=now, status=status, trips=trips, **audit)
            if self._journal is not None:
                self._journal.finished(req.uid, status, done[req.uid].tokens)

        def overdue(req, now):
            return req.deadline_s is not None and now > req.arrival_s + req.deadline_s

        while queue or arrivals or any(o is not None for o in self._owner):
            now = self._now(clock, t0)
            if now > deadline_s:
                expired = True
                break
            if max_chunks is not None and decode_chunks >= max_chunks:
                killed = True  # chaos hook: die at the chunk boundary
                break
            while arrivals and arrivals[0].req.arrival_s <= now:
                queue.append(arrivals.popleft())
            # evict overdue queued requests before they can take a slot
            if any(overdue(t.req, now) for t in queue):
                kept = deque()
                for t in queue:
                    if overdue(t.req, now):
                        counters["deadline_evictions"] += 1
                        finish(t.req, [], "evicted", now, -1.0, t.trips)
                    else:
                        kept.append(t)
                queue.clear()
                queue.extend(kept)
            for slot in range(self.num_slots):
                if self._owner[slot] is None and queue:
                    t = queue.popleft()
                    self._admit(t.req, slot, now, trips=t.trips)
                    if self._journal is not None:
                        self._journal.admitted(t.req.uid, slot)
            # admission control: what could not take a slot waits in a
            # bounded queue; past the bound the shed policy turns work away
            while self.max_queue is not None and len(queue) > self.max_queue:
                victim = self._shed_victim(now)
                queue.remove(victim)
                counters["shed_rejections"] += 1
                finish(victim.req, [], "rejected", now, -1.0, victim.trips)
            depth = len(queue)
            peak_queue_depth = max(peak_queue_depth, depth)
            queue_depth_sum += depth
            queue_depth_samples += 1
            if not any(o is not None for o in self._owner):
                # pool idle: on the wall clock, sleep until the next arrival
                # or the deadline; another clock is read again at once
                if arrivals and clock is time.perf_counter:
                    time.sleep(max(0.0, min(arrivals[0].req.arrival_s, deadline_s) - now))
                continue
            toks, emitted, active, bad, mx, cc, cd, cmr, _ = self._decode_chunk()
            decode_chunks += 1
            self._chunks_total += 1
            now = self._now(clock, t0)
            if self._canary is not None:
                # the ladder first: a request finishing this chunk carries
                # its final rung and canary trail
                self._slo_update(cc, cd, cmr, counters)
            for slot in range(self.num_slots):
                req = self._owner[slot]
                if req is None:
                    continue
                # a NaN mx compares False, but `bad` has latched then
                if self.detectors and (bool(bad[slot]) or float(mx[slot]) > self.logit_sentinel):
                    # quarantine: free the slot (its device row decays
                    # harmlessly: row isolation and budget exhaustion) and
                    # discard every emission; a retry starts clean
                    counters["faults_detected"] += 1
                    trips = self._trips[slot] + 1
                    self._owner[slot] = None
                    if trips <= self.quarantine_retries:
                        counters["quarantine_retries"] += 1
                        queue.appendleft(_Ticket(req, trips))
                    else:
                        counters["exact_fallbacks"] += 1
                        tokens, healthy = self._exact_fallback(req)
                        now = self._now(clock, t0)
                        finish(req, tokens, "degraded" if healthy else "failed", now,
                               self._admitted_s[slot], trips, slot)
                    continue
                self._emitted[slot].extend(toks[slot][emitted[slot]].tolist())
                if not active[slot]:  # finished: free the slot for reuse
                    finish(req, self._emitted[slot], "ok", now, self._admitted_s[slot],
                           self._trips[slot], slot)
                    self._owner[slot] = None
                elif overdue(req, now):  # per-request deadline: partial tokens
                    counters["deadline_evictions"] += 1
                    finish(req, self._emitted[slot], "evicted", now, self._admitted_s[slot],
                           self._trips[slot], slot)
                    self._owner[slot] = None
            if self._journal is not None:
                live = [(o.uid, len(self._emitted[s])) for s, o in enumerate(self._owner)
                        if o is not None]
                if live:
                    self._journal.progress(live)
            if self._telemetry is not None:
                chunk_tokens = int(emitted.sum())
                telemetry_tokens += chunk_tokens
                self._emit_telemetry(now, depth, chunk_tokens, telemetry_tokens / max(now, 1e-9),
                                     cc, cd, cmr)
            # autosave at the chunk boundary, after the host bookkeeping: the
            # durable cut exactly-once recovery is proved against
            if (self.snapshot_every_chunks is not None
                    and decode_chunks % self.snapshot_every_chunks == 0):
                self.snapshot()
        if expired:
            now = self._now(clock, t0)
            for slot, req in enumerate(self._owner):
                if req is not None:
                    counters["deadline_evictions"] += 1
                    finish(req, self._emitted[slot], "evicted", now, self._admitted_s[slot],
                           self._trips[slot], slot)
                    self._owner[slot] = None
            for t in list(queue) + list(arrivals):
                counters["deadline_evictions"] += 1
                finish(t.req, [], "evicted", now, -1.0, t.trips)
            queue.clear()
            arrivals.clear()
        makespan = clock() - t0
        total_tokens = sum(len(c.tokens) for c in done.values())
        self.stats = {
            "makespan_s": makespan,
            "total_tokens": total_tokens,
            "tok_s": total_tokens / max(makespan, 1e-9),
            "decode_chunks": decode_chunks,
            "n_requests": len(done),
            "deadline_expired": expired,
            "killed": killed,
            "dispatch_faults": self._dispatch_faults,
            "dispatch_retries": self._dispatch_retries,
            "peak_queue_depth": peak_queue_depth,
            "mean_queue_depth": (queue_depth_sum / queue_depth_samples
                                 if queue_depth_samples else 0.0),
            "snapshots_written": self._snapshots_written,
            "journal_replays": self._journal_replays,
            "telemetry": None if self._telemetry is None else str(self._telemetry.path),
            **counters,
            **{f"n_{s}": sum(c.status == s for c in done.values()) for s in STATUSES},
        }
        if self.spec is not None:
            acc = self._spec_acc_total - spec0[0]
            steps = self._spec_steps_total - spec0[1]
            # drafts accepted a spec step (0..k), and as a share of the
            # drafts proposed (0..1)
            self.stats.update(spec_steps=steps, spec_accepted=acc,
                              accepted_per_step=acc / max(steps, 1),
                              acceptance_rate=acc / max(steps * self.spec.k, 1))
        return done

    def _emit_telemetry(self, now, depth, tokens, tok_s, cc, cd, cmr):
        """One ``kind="chunk"`` record from what the chunk's host copy
        brought back (``launch/telemetry.py``)."""
        n_active = sum(o is not None for o in self._owner)
        if self._ladder is not None:
            hist: dict = {}
            for name in self.unit_names:
                hist[name] = hist.get(name, 0) + 1
        else:
            hist = {self.cfg.sqrt_unit: self.num_slots}
        self._telemetry.emit({
            "kind": "chunk", "t": now, "chunk": int(self._chunks_total),
            "active_slots": n_active, "slot_occupancy": n_active / self.num_slots,
            "queue_depth": depth, "tokens": tokens, "tok_s": tok_s,
            "canary_checks": int(np.sum(cc)), "canary_divergences": int(np.sum(cd)),
            "canary_max_rel": float(np.max(cmr)) if len(cmr) else 0.0,
            "unit_levels": hist})


def run_static_baseline(model: lm.LM, cfg: ModelConfig, requests, *, num_slots: int = 4,
                        quantized_kv: bool = False) -> tuple:
    """The lock-step scheduler as a baseline: requests are served in
    arrival-order groups of ``num_slots``; each group waits for its last
    arrival, right-pads every prompt to the group's longest and decodes the
    group's largest budget for every row.  Only each request's own
    ``max_new_tokens`` count as useful tokens.  A throughput yardstick, not
    an output-correct server: a request shorter than its group's longest
    decodes from the padded prompt.  Returns ({uid: Completion}, stats)."""
    dev = _device_of(model)
    reqs = sorted(requests, key=lambda r: (r.arrival_s, r.uid))
    groups = [reqs[i:i + num_slots] for i in range(0, len(reqs), num_slots)]
    done: dict = {}

    def solve(group, g_len):
        s_max = max(len(r.prompt) for r in group)
        prompts = np.zeros((len(group), s_max), np.int32)
        for i, r in enumerate(group):
            prompts[i, :len(r.prompt)] = r.prompt
        cache = lm.init_cache(cfg, len(group), s_max + g_len, quantized=quantized_kv, device=dev)
        logits, cache = lm.prefill(model, cfg, cache, torch.as_tensor(prompts, device=dev),
                                   last_logit_only=True)
        toks, _, _ = lm.generate_scan(model, cfg, cache, logits[:, -1:].argmax(dim=-1), s_max,
                                      g_len)
        return toks.cpu().numpy()

    t0 = time.perf_counter()
    prev_end = 0.0
    for group in groups:
        g_len = max(r.max_new_tokens for r in group)
        start = max(prev_end, max(r.arrival_s for r in group))
        now = time.perf_counter() - t0
        if now < start:  # the batch cannot form before its last member arrives
            time.sleep(start - now)
        toks = solve(group, g_len)
        end = prev_end = time.perf_counter() - t0
        for i, r in enumerate(group):
            done[r.uid] = Completion(uid=r.uid, prompt_len=len(r.prompt),
                                     tokens=toks[i, :r.max_new_tokens], arrival_s=r.arrival_s,
                                     admitted_s=start, finished_s=end)
    makespan = time.perf_counter() - t0
    total_tokens = sum(len(c.tokens) for c in done.values())
    stats = {"makespan_s": makespan, "total_tokens": total_tokens,
             "tok_s": total_tokens / max(makespan, 1e-9), "n_groups": len(groups),
             "n_requests": len(done)}
    return done, stats
