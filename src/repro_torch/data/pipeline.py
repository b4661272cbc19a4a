"""Deterministic, shard-aware token data pipeline (a copy of
``repro.data.pipeline``: numpy only, so the two packages give the same
batches; ``make_frames`` waits for the encoder-decoder architecture,
ROADMAP queue 1, item 15).

Two sources:
  * SyntheticLM — seeded Zipf-ish token stream (self-contained; used by the
    examples and tests; deterministic per (seed, step, shard)).
  * MemmapDataset — packed uint16/uint32 token files (np.memmap), the
    production path for real corpora.

Determinism & fault tolerance: batch `i` of shard `s` depends only on
(seed, i, s), so a restarted job resumes mid-epoch from the checkpointed
step counter without data skew (checkpoint/ stores the step).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    shard_id: int = 0       # data-parallel shard of this host
    num_shards: int = 1


class SyntheticLM:
    """Zipf-distributed tokens with local n-gram structure (so loss can
    actually decrease in the examples)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch must divide num_shards")
        self.local_batch = cfg.global_batch // cfg.num_shards

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard_id]))
        B, S = self.local_batch, cfg.seq_len
        # zipf over vocab, clipped
        toks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        toks = (toks - 1) % cfg.vocab
        # inject copy structure: second half repeats the first half shifted
        half = (S + 1) // 2
        toks[:, half:half * 2] = toks[:, :half]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapDataset:
    """Packed token file: flat array of token ids, sampled in (S+1) windows.

    Window offsets are deterministic in (seed, step, shard): production
    restart-safety without an index server.
    """

    def __init__(self, path: str, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.local_batch = cfg.global_batch // cfg.num_shards
        if len(self.data) < cfg.seq_len + 1:
            raise ValueError("dataset smaller than one sequence")

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard_id]))
        B, S = self.local_batch, cfg.seq_len
        starts = rng.integers(0, len(self.data) - S - 1, size=B)
        win = np.stack([np.asarray(self.data[s:s + S + 1]) for s in starts])
        win = win.astype(np.int64) % cfg.vocab
        return {"tokens": win[:, :-1].astype(np.int32),
                "labels": win[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

