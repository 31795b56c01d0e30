"""Continuous-batching serving engine: slot-scheduled decode over a KV-cache
pool with per-request positions (torch port of the plain path of
``repro.launch.engine``).

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
  tokens, emission mask and liveness together;
* per-slot EOS / budget early exit, global and per-request deadlines, and
  per-request sampling streams (greedy by default).

A request decoded in a staggered slot emits the tokens of the same request
alone in a pool of the same size (greedy); on the CPU they equal a solo
``prefill`` + ``generate_scan`` run (:func:`solo_generate`).  Health
detectors, canaries and SLO ladders, snapshots and the journal, overload
shedding and speculation are not ported yet (ROADMAP A.5).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

__all__ = ["Request", "Completion", "Engine", "run_static_baseline", "solo_generate",
           "STATUSES"]

# Completion.status values:
#   ok      -- served to its budget or its EOS
#   evicted -- deadline expiry (global or per-request); tokens are partial
STATUSES = ("ok", "evicted")


def _device_of(model: lm.LM) -> torch.device:
    return model.embed.device


@torch.no_grad()
def solo_generate(model: lm.LM, cfg: ModelConfig, prompt, max_new_tokens: int, *,
                  cache_len: int, quantized_kv: bool = False) -> np.ndarray:
    """The parity reference: one request alone, batch 1, on the model's
    device (prefill + greedy :func:`lm.generate_scan`).  Returns its
    ``max_new_tokens`` tokens."""
    dev = _device_of(model)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32, device=dev)
    if prompt.ndim == 1:
        prompt = prompt[None]
    cache = lm.init_cache(cfg, 1, cache_len, quantized=quantized_kv, device=dev)
    logits, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
    toks, _, _ = lm.generate_scan(model, cfg, cache, logits[:, -1:].argmax(dim=-1),
                                  prompt.shape[1], max_new_tokens)
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
    admission into a slot, finish; seconds from trace start).  A request
    evicted from the queue (never admitted) has ``admitted_s=-1.0`` and no
    tokens."""

    uid: int
    prompt_len: int
    tokens: np.ndarray  # emitted tokens (<= max_new_tokens; ends at EOS)
    arrival_s: float
    admitted_s: float
    finished_s: float
    status: str = "ok"

    @property
    def latency_s(self) -> float:
        """End-to-end request latency: arrival to final token, seconds."""
        return self.finished_s - self.arrival_s


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
    """

    def __init__(self, model: lm.LM, cfg: ModelConfig, *, num_slots: int = 4,
                 cache_len: int = 64, quantized_kv: bool = False, chunk: int = 8,
                 eos_id: Optional[int] = None, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0):
        if num_slots < 1 or cache_len < 2 or chunk < 1:
            raise ValueError(
                f"need num_slots >= 1, cache_len >= 2, chunk >= 1 "
                f"(got {num_slots}, {cache_len}, {chunk})"
            )
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
        self.device = _device_of(model)
        self.pool = lm.init_pool_state(cfg, num_slots, cache_len, quantized=quantized_kv,
                                       device=self.device)
        self._slots = torch.arange(num_slots, device=self.device)
        # what a chunk hands to the host in one copy: tokens fed (b, chunk),
        # emission mask (b, chunk) and liveness after the chunk (b,), int32
        self._packed = torch.zeros((num_slots, 2 * chunk + 1), dtype=torch.int32,
                                   device=self.device)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: Optional[dispatch.Launches] = None
        self.reset()

    # -- pool state ---------------------------------------------------------

    def reset(self):
        """Zero the pool in place (all slots free) and empty the queues.  The
        pool keeps its tensors, so a captured chunk stays valid."""
        for t in lm.pool_tensors(self.pool):
            t.zero_()
        b = self.num_slots
        self._owner: list = [None] * b
        self._emitted: list = [[] for _ in range(b)]
        self._admitted_s = [0.0] * b
        self._queue: deque = deque()  # due requests waiting for a slot
        self._arrivals: deque = deque()  # accepted requests not yet due

    def warmup(self, prompt_lens):
        """Admit one request of each prompt length and run one decode chunk
        (on the card: the chunk's eager run and its capture), off the serving
        clock, then reset the pool."""
        for s in sorted(set(int(s) for s in prompt_lens)):
            self._admit(Request(uid=-1, prompt=np.zeros(s, np.int32), max_new_tokens=1),
                        slot=0, now=0.0)
        self._decode_chunk()
        self.reset()

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

    def _admit(self, req: Request, slot: int, now: float):
        """Prefill ``req`` into ``slot`` of the live pool and draw its first
        token from the request's own stream (seed, uid), at the position of
        the prompt's last token, as every later token draws at its own."""
        self._validate(req)
        pool, dev = self.pool, self.device
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32, device=dev)[None]
        s = prompt.shape[1]
        logits, _ = lm.prefill_into_slots(self.model, self.cfg, pool["cache"], prompt,
                                          self._slots[slot:slot + 1])
        pool["keys"][slot, 0] = self.seed & 0xFFFFFFFF
        pool["keys"][slot, 1] = req.uid & 0x7FFFFFFF  # the stream is keyed by uid, not slot
        last_pos = torch.full((1,), s - 1, dtype=torch.int32, device=dev)
        pool["tok"][slot] = lm.sample_tokens(logits[:, -1].float(), last_pos,
                                             pool["keys"][slot:slot + 1], self.temperature,
                                             self.top_k)
        pool["pos"][slot] = s
        pool["active"][slot] = True
        pool["remaining"][slot] = int(req.max_new_tokens)
        self._owner[slot] = req
        self._emitted[slot] = []
        self._admitted_s[slot] = now

    # -- the decode chunk ---------------------------------------------------

    def _chunk_eager(self):
        """``chunk`` decode steps over the pool, eagerly, into the packed
        buffer."""
        c = self.chunk
        toks, emitted = self._packed[:, :c], self._packed[:, c:2 * c]
        for i in range(c):
            lm.decode_slots_step(self.model, self.cfg, self.pool, toks, emitted, i,
                                 eos_id=self.eos_id, temperature=self.temperature,
                                 top_k=self.top_k)
        self._packed[:, 2 * c] = self.pool["active"]

    def _capture(self):
        """This chunk eagerly on a side stream (it loads every kernel, plans
        each launch and warms the allocator), then the same steps captured as
        one CUDA graph over the pool's tensors and the packed buffer.  The
        capture launches nothing: the launches it counts become what each
        replay adds."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._chunk_eager()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with dispatch.capture_launches() as launches, torch.cuda.graph(graph):
            self._chunk_eager()
        self._graph, self._graph_launches = graph, launches

    def _decode_chunk(self):
        """Advance the pool one chunk.  Returns numpy (tokens fed (b, chunk),
        emitted (b, chunk) bool, active (b,) bool), read in one copy."""
        if self.device.type != "cuda":
            self._chunk_eager()
        elif self._graph is None:
            self._capture()
        else:
            self._graph.replay()
            dispatch.replay_launches(self._graph_launches)
        packed = self._packed.cpu().numpy()
        c = self.chunk
        return packed[:, :c], packed[:, c:2 * c].astype(bool), packed[:, 2 * c].astype(bool)

    # -- the serve loop -----------------------------------------------------

    def run(self, requests=(), *, deadline_s: float = 600.0) -> dict:
        """Serve ``requests`` (admitted no earlier than their ``arrival_s``,
        on the wall clock from call start; equal arrivals in uid order) until
        all complete.  Returns {uid: Completion}; aggregate stats go to
        ``self.stats``.

        Deadlines evict instead of raising: when the global ``deadline_s``
        expires, in-flight requests are evicted with their partial tokens and
        queued ones with none (``admitted_s=-1.0``).  A request's own
        ``deadline_s`` (from its arrival) evicts just that request.  The
        whole trace is validated before serving starts."""
        requests = list(requests)
        for req in requests:
            self._validate(req)
        self._arrivals.extend(sorted(requests, key=lambda r: (r.arrival_s, r.uid)))
        queue, arrivals = self._queue, self._arrivals
        done: dict = {}
        t0 = time.perf_counter()
        decode_chunks = 0
        expired = False

        def finish(req, tokens, status, now, admitted_s):
            done[req.uid] = Completion(uid=req.uid, prompt_len=len(req.prompt),
                                       tokens=np.asarray(tokens, np.int32),
                                       arrival_s=req.arrival_s, admitted_s=admitted_s,
                                       finished_s=now, status=status)

        def overdue(req, now):
            return req.deadline_s is not None and now > req.arrival_s + req.deadline_s

        while queue or arrivals or any(o is not None for o in self._owner):
            now = time.perf_counter() - t0
            if now > deadline_s:
                expired = True
                break
            while arrivals and arrivals[0].arrival_s <= now:
                queue.append(arrivals.popleft())
            # evict overdue queued requests before they can take a slot
            for req in [r for r in queue if overdue(r, now)]:
                queue.remove(req)
                finish(req, [], "evicted", now, -1.0)
            for slot in range(self.num_slots):
                if self._owner[slot] is None and queue:
                    self._admit(queue.popleft(), slot, now)
            if not any(o is not None for o in self._owner):
                if arrivals:  # pool idle: sleep until the next arrival or the deadline
                    time.sleep(max(0.0, min(arrivals[0].arrival_s, deadline_s) - now))
                continue
            toks, emitted, active = self._decode_chunk()
            decode_chunks += 1
            now = time.perf_counter() - t0
            for slot in range(self.num_slots):
                req = self._owner[slot]
                if req is None:
                    continue
                self._emitted[slot].extend(toks[slot][emitted[slot]].tolist())
                if not active[slot]:  # finished: free the slot for reuse
                    finish(req, self._emitted[slot], "ok", now, self._admitted_s[slot])
                    self._owner[slot] = None
                elif overdue(req, now):  # per-request deadline: partial tokens
                    finish(req, self._emitted[slot], "evicted", now, self._admitted_s[slot])
                    self._owner[slot] = None
        if expired:
            now = time.perf_counter() - t0
            for slot, req in enumerate(self._owner):
                if req is not None:
                    finish(req, self._emitted[slot], "evicted", now, self._admitted_s[slot])
                    self._owner[slot] = None
            for req in list(queue) + list(arrivals):
                finish(req, [], "evicted", now, -1.0)
            queue.clear()
            arrivals.clear()
        makespan = time.perf_counter() - t0
        total_tokens = sum(len(c.tokens) for c in done.values())
        self.stats = {
            "makespan_s": makespan,
            "total_tokens": total_tokens,
            "tok_s": total_tokens / max(makespan, 1e-9),
            "decode_chunks": decode_chunks,
            "n_requests": len(done),
            "deadline_expired": expired,
            **{f"n_{s}": sum(c.status == s for c in done.values()) for s in STATUSES},
        }
        return done


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
