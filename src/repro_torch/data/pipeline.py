"""Synthetic-but-learnable token pipeline (the port's copy of
``repro.data.pipeline``: numpy only, the same batches).

Deterministic and STATELESS-RESUMABLE: batch t is a pure function of
(seed, t), so restoring a checkpoint at step t resumes the exact data
stream with no pipeline state to persist beyond the step counter — the
property elastic restarts need. Data is host-sharded: each data-parallel
host materializes only its slice.

The stream has learnable structure (noisy modular-affine next-token rule),
so a ~100M model's loss drops well below ln(vocab) within a few hundred
steps — used by the end-to-end training example.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05
    mult: int = 31
    add: int = 7


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1):
        """Batch for ``step``; host ``shard`` of ``n_shards`` gets rows
        [shard * b/n : (shard+1) * b/n]."""
        cfg = self.cfg
        b = cfg.global_batch // n_shards
        rng = np.random.default_rng((cfg.seed, step, shard))
        toks = np.empty((b, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, b)
        noise = rng.random((b, cfg.seq_len)) < cfg.noise
        rand = rng.integers(0, cfg.vocab, (b, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = (toks[:, t] * cfg.mult + cfg.add) % cfg.vocab
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
