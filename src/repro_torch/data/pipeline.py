"""Deterministic synthetic LM data pipeline (the port's own copy of
``repro.data.pipeline``, numpy only; batches equal to the reference's).

Production-shaped: per-host sharding (each host materializes only its slice
of the global batch), deterministic batch derivation from (seed, step) so a
restarted/elastically-resized job replays the exact stream, and sequence
packing of variable-length documents.

The token stream is a learnable mixture (Zipf unigrams + a planted bigram
transition table + repeated-span structure) so that small-model loss curves
actually move."""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "host_slice"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bigram_rank: int = 64  # planted structure strength


class SyntheticLM:
    """Deterministic synthetic corpus: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        v = cfg.vocab
        # planted bigram table: each token has a few likely successors
        self._succ = rng.randint(0, v, size=(v, 4))
        # Zipf-ish unigram distribution
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._unigram = p / p.sum()
        # inverse-cdf table for vectorized unigram draws: one O(v) cumsum at
        # construction instead of per token inside rng.choice(p=...)
        self._unigram_cdf = np.cumsum(self._unigram)

    def _doc(self, rng: np.random.RandomState, length: int) -> np.ndarray:
        # all randomness precomputed in 3 vectorized draws (the per-token
        # rng.choice(p=...) rebuilt its O(v) cdf every call and made batch
        # materialization the bottleneck at serving/bench scale); the chain
        # walk itself is sequential (tok feeds the bigram lookup) but is now
        # pure table lookups.  Still deterministic per rng state, so the
        # batch-from-(seed, step) contract holds (a pinned digest of one
        # batch guards the exact stream).
        v = self.cfg.vocab
        uni = np.minimum(
            np.searchsorted(self._unigram_cdf, rng.random_sample(length + 1)),
            v - 1,
        )
        follow = rng.random_sample(length) < 0.75  # follow planted bigram
        succ_j = rng.randint(0, 4, size=length)
        out = np.empty(length, dtype=np.int32)
        tok = int(uni[0])
        succ = self._succ
        for i in range(length):
            out[i] = tok
            tok = int(succ[tok, succ_j[i]]) if follow[i] else int(uni[i + 1])
        # repeated-span structure: copy an earlier span forward
        if length > 32 and rng.rand() < 0.5:
            span = rng.randint(4, length // 4)
            src = rng.randint(0, length - 2 * span)
            dst = rng.randint(src + span, length - span)
            out[dst : dst + span] = out[src : src + span]
        return out

    def batch(self, step: int, *, host_id: int = 0, n_hosts: int = 1) -> dict:
        """Returns this host's slice of the global batch for ``step``:
        {"tokens", "labels", "loss_mask"} with seq packing."""
        cfg = self.cfg
        assert cfg.global_batch % n_hosts == 0
        b_local = cfg.global_batch // n_hosts
        tokens = np.empty((b_local, cfg.seq_len), np.int32)
        mask = np.ones((b_local, cfg.seq_len), np.float32)
        for r in range(b_local):
            # deterministic per (seed, step, global_row)
            g_row = host_id * b_local + r
            rng = np.random.RandomState(
                (cfg.seed * 1_000_003 + step * 9176 + g_row) % 2**31
            )
            # pack documents until the row is full
            pos = 0
            while pos < cfg.seq_len:
                doc_len = min(int(rng.randint(32, 1 + cfg.seq_len)), cfg.seq_len - pos)
                tokens[r, pos : pos + doc_len] = self._doc(rng, doc_len)
                if pos > 0:
                    mask[r, pos] = 0.0  # don't predict across doc boundary
                pos += doc_len
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        mask[:, -1] = 0.0
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}


def host_slice(global_batch: int, host_id: int, n_hosts: int) -> slice:
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)
