"""Write-ahead request journal (the port's own copy of
``repro.launch.journal``, in the same JSONL records, so either package reads
the other's journal): an append-only log of request lifecycle records,
written *before* the corresponding device work, so a killed serving process
never silently drops an accepted request.

One record per line, ``{"kind": ..., "t": <wall-clock seconds>, ...}``:

    accepted   uid, prompt (token list), max_new_tokens, arrival_s,
               deadline_s: the durable intake record, written (and fsynced)
               before the request can touch any slot state
    admitted   uid, slot: the request landed in a pool slot
    progress   slots: [[uid, n_tokens], ...]: per-chunk emission counts
               (informational; not fsynced, the snapshot is the durable
               progress record)
    finished   uid, status, n_tokens, tokens: the durable completion record;
               once it is fsynced the request is done exactly once, and a
               resume must not serve it again
    snapshot   step: an engine snapshot committed at this point
    demoted    slot, uid, level, unit: an accuracy-SLO ladder trip
    promoted   slot, uid, level, unit: the recovery, one rung up

Readers tolerate unknown kinds: a reader replaying a newer writer's journal
skips what it does not understand instead of failing the resume.

Durable records (``accepted``/``finished``/``snapshot``) are flushed and
fsynced per append; ``progress``/``admitted`` records are flushed but not
fsynced.  The reader tolerates exactly one torn record, a partial final
line from a writer killed mid-append, and rejects corruption anywhere else.

Recovery contract (consumed by ``Engine.resume``): a uid with a ``finished``
record is complete, and is dropped from any restored snapshot state; a uid
with an ``accepted`` record but no ``finished`` record and no presence in the
snapshot is replayed from its journal fields.  Every accepted request then
ends with exactly one ``finished`` record across all run segments.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

__all__ = ["RequestJournal", "read_journal", "replay_plan", "replay_unit_levels"]

# record kinds that must survive a kill the instant append() returns
_DURABLE = ("accepted", "finished", "snapshot")


class RequestJournal:
    """Append-only JSONL journal.  Opens lazily in append mode, so several
    run segments pointed at the same path extend one history."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = None

    def _file(self):
        if self._f is None or self._f.closed:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a", encoding="utf-8")
        return self._f

    def append(self, kind: str, **fields) -> dict:
        rec = {"kind": kind, "t": time.time(), **fields}
        f = self._file()
        f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        f.flush()
        if kind in _DURABLE:
            os.fsync(f.fileno())
        return rec

    # -- lifecycle shorthands ------------------------------------------------

    def accepted(self, req) -> dict:
        """The write-ahead intake record: call it BEFORE any device work."""
        return self.append(
            "accepted",
            uid=int(req.uid),
            prompt=[int(x) for x in np.asarray(req.prompt)],
            max_new_tokens=int(req.max_new_tokens),
            arrival_s=float(req.arrival_s),
            deadline_s=None if req.deadline_s is None else float(req.deadline_s),
        )

    def admitted(self, uid: int, slot: int) -> dict:
        return self.append("admitted", uid=int(uid), slot=int(slot))

    def progress(self, slot_counts) -> dict:
        """``slot_counts``: iterable of (uid, total emitted tokens so far)."""
        return self.append("progress", slots=[[int(u), int(n)] for u, n in slot_counts])

    def finished(self, uid: int, status: str, tokens) -> dict:
        toks = [int(x) for x in tokens]
        return self.append("finished", uid=int(uid), status=status, n_tokens=len(toks),
                           tokens=toks)

    def snapshot(self, step: int) -> dict:
        return self.append("snapshot", step=int(step))

    def demoted(self, slot: int, uid, level: int, unit: str) -> dict:
        """An accuracy-SLO ladder trip (flushed, not fsynced: the snapshot's
        meta is the durable record)."""
        return self.append("demoted", slot=int(slot), uid=None if uid is None else int(uid),
                           level=int(level), unit=unit)

    def promoted(self, slot: int, uid, level: int, unit: str) -> dict:
        return self.append("promoted", slot=int(slot), uid=None if uid is None else int(uid),
                           level=int(level), unit=unit)

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()


def read_journal(path) -> list:
    """Parse a journal back into records.  A torn FINAL line (a writer killed
    mid-append) is skipped; a corrupt line anywhere else raises ValueError
    naming the line number: that is corruption, not a crash artifact."""
    p = Path(path)
    if not p.exists():
        return []
    lines = p.read_text(encoding="utf-8").splitlines()
    records = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            if i == len(lines) - 1:
                break  # torn tail from a kill mid-append: expected, drop it
            raise ValueError(f"journal {p} line {i + 1} is corrupt mid-file: {e}") from e
    return records


def replay_plan(records) -> tuple:
    """Split journal records into the resume decision inputs:
    ``(finished, accepted_unfinished)``, both ``{uid: record}``.  The second
    holds every accepted request with no finished record; whether each is
    replayed or already lives in the snapshot is the engine's call."""
    finished = {r["uid"]: r for r in records if r.get("kind") == "finished"}
    accepted = {r["uid"]: r for r in records
                if r.get("kind") == "accepted" and r["uid"] not in finished}
    return finished, accepted


def replay_unit_levels(records) -> dict:
    """The accuracy-SLO per-slot ladder levels from the ``demoted``/
    ``promoted`` trail: ``{slot: level}``, the last record winning.  Slots
    with no such record are absent (they stay at rung 0)."""
    levels: dict = {}
    for r in records:
        if r.get("kind") in ("demoted", "promoted"):
            levels[int(r["slot"])] = int(r["level"])
    return levels
