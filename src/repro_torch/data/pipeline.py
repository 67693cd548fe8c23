"""Deterministic, shard-aware synthetic data pipeline (a copy of the
reference's ``data/pipeline.py``: numpy only, so its batches are the
reference's byte for byte).

Every batch is a pure function of ``(seed, step, global position)`` — no
iterator state. Consequences that matter at cluster scale:

* **exact resume**: a restored step recomputes exactly the batches it would
  have seen (the data cursor is the step number in the checkpoint);
* **elastic re-sharding**: a host owns rows by *global position*, so when
  the data-parallel width changes, the global batch sequence is unchanged —
  only the row->host mapping moves;
* **no input stragglers**: generation is compute-trivial and local.

Token streams mix a Zipf-ish unigram draw with shifted-window structure so
the LM loss actually decreases (examples/train_lm.py) — pure-uniform tokens
have no learnable signal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.7      # fraction of positions copied from context
    copy_offset: int = 16        # structural dependency distance
    zipf_a: float = 1.2


def _fold(*ints: int) -> np.random.Generator:
    seed = 0x9E3779B97F4A7C15
    for i in ints:
        seed = ((seed ^ (i + 1)) * 0xBF58476D1CE4E5B9) % (2**64)
        seed ^= seed >> 31
    return np.random.default_rng(seed % (2**63))


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks ** (-cfg.zipf_a)
    return p / p.sum()


class SyntheticLM:
    """tokens[b, s] + labels[b, s] per step, sharded by global row."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(cfg)

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = _fold(cfg.seed, step, row)
        n = cfg.seq_len + 1
        off = cfg.copy_offset
        pad = (-n) % off
        total = n + pad
        fresh = rng.choice(cfg.vocab_size, size=total, p=self._probs)
        # Markov copy chains at distance `off`: position i keeps the value of
        # i - off with prob `structure`, else redraws. Vectorised per chain:
        # value[k] = fresh[last change point <= k].
        chains = total // off
        change = rng.random((chains, off)) >= cfg.structure
        change[0, :] = True
        kidx = np.arange(chains)[:, None] * np.ones((1, off), dtype=np.int64)
        last_change = np.maximum.accumulate(np.where(change, kidx, -1), axis=0)
        fresh2d = fresh.reshape(chains, off)
        toks = fresh2d[last_change, np.arange(off)[None, :]].reshape(total)[:n]
        return toks.astype(np.int32)

    def batch(
        self,
        step: int,
        shard_id: int = 0,
        num_shards: int = 1,
    ) -> Dict[str, np.ndarray]:
        """The shard's slice of the global batch for ``step``."""
        cfg = self.cfg
        if cfg.global_batch % num_shards:
            raise ValueError(
                f"global_batch {cfg.global_batch} !% num_shards {num_shards}"
            )
        rows_per = cfg.global_batch // num_shards
        rows = range(shard_id * rows_per, (shard_id + 1) * rows_per)
        data = np.stack([self._row(step, r) for r in rows])
        return {
            "tokens": data[:, :-1],
            "labels": data[:, 1:].copy(),
        }

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        return self.batch(step, 0, 1)

    def iterate(
        self, start_step: int = 0, shard_id: int = 0, num_shards: int = 1
    ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, shard_id, num_shards)
            step += 1
