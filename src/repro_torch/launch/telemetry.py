"""Serving telemetry (the port's own copy of ``repro.launch.telemetry``, in
the same JSONL records, so either package reads the other's stream): an
append-only stream of per-chunk gauges.

The engine emits one record per decode chunk at the chunk boundary, from
numbers its one host copy a chunk already brought back: telemetry adds no
device synchronisation.  Records are flushed per emit but never fsynced
(telemetry is observability, not recovery: the journal and the snapshots
own durability).

Record schema (kind="chunk"):

    t                   wall-clock seconds since the run started
    chunk               lifetime chunk counter (monotonic across resets)
    active_slots        occupied slots at the end of the chunk
    slot_occupancy      active_slots / num_slots
    queue_depth         due-request queue depth at the chunk boundary
    tokens              tokens emitted this chunk
    tok_s               running decode throughput (emitted / elapsed)
    canary_checks       shadow-exact canaries run this chunk (0 without an SLO)
    canary_divergences  canary argmax disagreements this chunk
    canary_max_rel      max relative logit error over this chunk's canaries
    unit_levels         histogram {unit name: slots at that rung}

Readers tolerate unknown fields (the journal's forward-compatibility
contract); :func:`read_telemetry` drops a torn final line.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ["Telemetry", "read_telemetry"]


class Telemetry:
    """JSONL gauge emitter.  ``mode="a"`` (default) extends one history
    across run segments; ``mode="w"`` truncates the file on first use."""

    def __init__(self, path, *, mode: str = "a"):
        if mode not in ("a", "w"):
            raise ValueError(f"mode must be 'a' or 'w', got {mode!r}")
        self.path = Path(path)
        self._mode = mode
        self._f = None

    def _file(self):
        if self._f is None or self._f.closed:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, self._mode, encoding="utf-8")
            self._mode = "a"  # a reopen after close() keeps the history
        return self._f

    def emit(self, record: dict) -> dict:
        f = self._file()
        f.write(json.dumps(record, separators=(",", ":"), default=float) + "\n")
        f.flush()
        return record

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()


def read_telemetry(path) -> list:
    """Parse a telemetry stream: a torn final line (an emitter killed
    mid-append) is dropped, corruption anywhere else raises ValueError."""
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
                break
            raise ValueError(f"telemetry {p} line {i + 1} is corrupt: {e}") from e
    return records
