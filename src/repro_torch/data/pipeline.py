"""Deterministic, resumable, shardable data pipeline.

Sources: synthetic LM streams (seeded, reproducible) and memory-mapped
token files. The pipeline state is a single (epoch, cursor) pair saved in
every checkpoint, so restart/elastic-rescale resumes exactly: each data
shard reads disjoint strided slices derived from (host_index, n_hosts),
and changing n_hosts re-partitions without replaying (cursor is global).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    source: str = "synthetic"       # synthetic | file
    path: Optional[str] = None      # token file (np.uint32 flat) for "file"
    # markov-ish synthetic structure so loss can actually go down
    synthetic_order: int = 2


@dataclass
class DataState:
    cursor: int = 0                 # global step counter

    def to_dict(self):
        return {"cursor": self.cursor}

    @staticmethod
    def from_dict(d):
        return DataState(cursor=int(d.get("cursor", 0)))


class TokenSource:
    def batch_tokens(self, cursor: int, host: int, n_hosts: int,
                     cfg: DataConfig) -> np.ndarray:
        raise NotImplementedError


class SyntheticSource(TokenSource):
    """Seeded per-(cursor, row) token generation; a low-order structure
    makes next-token prediction learnable (quickstart's loss decreases)."""

    def batch_tokens(self, cursor, host, n_hosts, cfg):
        b_local = cfg.global_batch // n_hosts
        rows = host * b_local + np.arange(b_local)
        out = np.empty((b_local, cfg.seq_len + 1), np.int32)
        for i, r in enumerate(rows):
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + cursor) * 65_537 + int(r))
            x = rng.integers(0, cfg.vocab, size=cfg.seq_len + 1,
                             dtype=np.int32)
            # structure: token[t] depends on token[t-2] half the time
            mask = rng.random(cfg.seq_len + 1) < 0.5
            shifted = np.roll((x * 31 + 7) % cfg.vocab, cfg.synthetic_order)
            out[i] = np.where(mask, shifted, x)
        return out


class FileSource(TokenSource):
    def __init__(self, path: str):
        self.tokens = np.memmap(path, dtype=np.uint32, mode="r")

    def batch_tokens(self, cursor, host, n_hosts, cfg):
        b_local = cfg.global_batch // n_hosts
        need = cfg.seq_len + 1
        n_windows = len(self.tokens) // need
        rows = (cursor * cfg.global_batch + host * b_local
                + np.arange(b_local)) % n_windows
        return np.stack([
            np.asarray(self.tokens[r * need:(r + 1) * need], dtype=np.int32)
            for r in rows])


def make_source(cfg: DataConfig) -> TokenSource:
    if cfg.source == "file":
        assert cfg.path, "file source needs cfg.path"
        return FileSource(cfg.path)
    return SyntheticSource()


class Pipeline:
    """Iterator of {'tokens','targets'} with explicit, saveable state."""

    def __init__(self, cfg: DataConfig, host: int = 0, n_hosts: int = 1,
                 state: Optional[DataState] = None):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host = host
        self.n_hosts = n_hosts
        self.state = state or DataState()
        self.source = make_source(cfg)

    def next_batch(self) -> Dict[str, np.ndarray]:
        toks = self.source.batch_tokens(self.state.cursor, self.host,
                                        self.n_hosts, self.cfg)
        self.state = DataState(cursor=self.state.cursor + 1)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
