"""Kill-and-resume smoke of the port's ``Engine``: a real ``SIGKILL`` mid-serve,
then recovery (the counterpart of the JAX package's
``tools/kill_resume_smoke.py``).

``run(max_chunks=)`` simulates the kill inside one process; this smoke kills
a serving *process* (no atexit, no flush, no interpreter teardown) and
shows that the snapshot and the write-ahead journal recover it:

1. the parent serves each request of a smoke-width trace alone in a pool of
   the engine's shape: the reference tokens (on the CPU they equal a batch-1
   ``solo_generate`` run, which it checks too);
2. a child process serves the whole trace with ``snapshot_every_chunks=1``
   and a journal, and is ``SIGKILL``ed as soon as the journal shows decode
   progress with a snapshot committed (so the resume restores one, and
   replays the journal on top);
3. the parent resumes from what the dead child left on disk, drains, and
   audits the journal: every request finished exactly once, with the
   reference tokens.

If the child finishes before the kill lands, the run is still a (weaker)
recovery check and the audit must still pass.

Usage (the card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.kill_resume [--device cpu] [--dir D]
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ARCH = "qwen3-4b"
N_REQUESTS = 10
NUM_SLOTS = 2
CACHE_LEN = 24
CHUNK = 3
KILL_TIMEOUT_S = 300.0


def _setup(device):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.engine import Request
    from repro_torch.models import lm

    cfg = get_smoke_config(ARCH, sqrt_unit="e2afs")
    model = lm.init(cfg, device=device)  # weights from a generator seeded with 0
    rng = np.random.RandomState(0)
    reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab, size=int(rng.choice([3, 5]))).astype(
                np.int32), max_new_tokens=int(rng.choice([7, 12]))) for i in range(N_REQUESTS)]
    return cfg, model, reqs


def _engine(model, cfg, **kw):
    from repro_torch.launch.engine import Engine

    return Engine(model, cfg, num_slots=NUM_SLOTS, cache_len=CACHE_LEN, chunk=CHUNK, **kw)


def serve(workdir: Path, device) -> None:
    """Child: serve the trace with autosave and a journal.  The parent
    SIGKILLs this process mid-serve; nothing here relies on a clean exit."""
    cfg, model, reqs = _setup(device)
    _engine(model, cfg, snapshot_dir=workdir / "snap", snapshot_every_chunks=1,
            journal=workdir / "journal.jsonl").run(reqs)


def _journal_has_snapshot(jpath: Path) -> bool:
    """True once the child has journaled a decode chunk and the snapshot
    after it: the window where a kill lands mid-flight."""
    try:
        text = jpath.read_text(encoding="utf-8")
    except OSError:
        return False
    return '"kind":"snapshot"' in text


def audit(jpath, reqs, ref) -> list:
    """The recovery contract read from the journal alone: every request of
    ``reqs`` accepted and finished exactly once, its finished tokens equal
    to ``ref[uid]``.  Returns what failed (empty when it holds)."""
    from repro_torch.launch.journal import read_journal, replay_plan

    records = read_journal(jpath)
    finished, accepted_unfinished = replay_plan(records)
    counts: dict = {}
    for rec in records:
        if rec["kind"] == "finished":
            counts[rec["uid"]] = counts.get(rec["uid"], 0) + 1
    failures = []
    if accepted_unfinished:
        failures.append(f"accepted but never finished: {sorted(accepted_unfinished)}")
    if set(counts) != {r.uid for r in reqs}:
        failures.append(f"finished uids {sorted(counts)} != accepted {[r.uid for r in reqs]}")
    dupes = {u: n for u, n in counts.items() if n != 1}
    if dupes:
        failures.append(f"not exactly-once: {dupes}")
    for r in reqs:
        if r.uid in finished and not np.array_equal(
                np.asarray(finished[r.uid]["tokens"], np.int32), ref[r.uid]):
            failures.append(f"uid {r.uid}: tokens differ from the reference")
    return failures


def smoke(workdir: Path, device) -> int:
    """The parent's side; returns the exit code (0 when the audit passes)."""
    from repro_torch import checkpoint
    from repro_torch.launch.engine import Engine, solo_generate
    from repro_torch.launch.journal import read_journal

    jpath = workdir / "journal.jsonl"
    cfg, model, reqs = _setup(device)
    alone = _engine(model, cfg)
    ref = {}
    for r in reqs:
        alone.reset()
        ref[r.uid] = alone.run([r])[r.uid].tokens
    print(f"[parent] reference: {len(reqs)} requests each alone in a pool of {NUM_SLOTS} slots "
          f"({ARCH} smoke width, {cfg.act_dtype}, {model.embed.device})", flush=True)
    failures = []
    if model.embed.device.type == "cpu":
        for r in reqs:
            if not np.array_equal(ref[r.uid], solo_generate(model, cfg, r.prompt,
                                                            r.max_new_tokens,
                                                            cache_len=CACHE_LEN)):
                failures.append(f"uid {r.uid}: alone in the pool != solo_generate")

    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    child = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.kill_resume", "--serve",
                              "--dir", str(workdir), "--device", str(model.embed.device)],
                             env=env)
    print(f"[parent] child serving (pid {child.pid}); waiting for a journaled snapshot",
          flush=True)
    t0 = time.time()
    killed = False
    try:
        while time.time() - t0 < KILL_TIMEOUT_S:
            if child.poll() is not None:
                break  # finished before the kill: still audited below
            if _journal_has_snapshot(jpath):
                os.kill(child.pid, signal.SIGKILL)
                killed = True
                break
            time.sleep(0.005)
        else:
            print("[parent] FAIL: the child journaled no snapshot before the timeout")
            return 1
    finally:
        if child.poll() is None and not killed:
            child.kill()
        child.wait()
    if child.returncode not in (0, -signal.SIGKILL):
        print(f"[parent] FAIL: the child exited with {child.returncode}")
        return 1
    print(f"[parent] child {'SIGKILLed mid-serve' if killed else 'finished before the kill'} "
          f"after {time.time() - t0:.2f} s", flush=True)

    pre_kill = sum(1 for r in read_journal(jpath) if r["kind"] == "finished")
    step = checkpoint.latest_step(workdir / "snap")
    t1 = time.perf_counter()
    eng = Engine.resume(model, cfg, workdir / "snap", journal=jpath, chunk=CHUNK)
    resume_s = time.perf_counter() - t1
    done = eng.run([])
    print(f"[parent] the child had finished {pre_kill}/{len(reqs)}; the resume from snapshot "
          f"step {step} ({resume_s:.3f} s) served {len(done)} more "
          f"({eng.stats['journal_replays']} journal replays)")
    failures += audit(jpath, reqs, ref)
    if failures:
        for f in failures:
            print(f"[parent] FAIL: {f}")
        return 1
    print(f"[parent] OK: exactly-once completion, {len(reqs)}/{len(reqs)} token-identical to "
          f"the reference (killed={killed})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--dir", type=Path, default=None,
                    help="working directory for the snapshots and the journal "
                         "(default: a new temporary one)")
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)  # the child
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.serve:
        serve(args.dir, device)
        return 0
    if args.dir is not None:
        args.dir.mkdir(parents=True, exist_ok=True)
        return smoke(args.dir, device)
    with tempfile.TemporaryDirectory(prefix="kill-resume-") as d:
        return smoke(Path(d), device)


if __name__ == "__main__":
    sys.exit(main())
