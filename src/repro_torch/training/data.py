"""Synthetic token pipeline: deterministic, shardable, zero-storage.

Generates language-model batches from a counter-based PRNG so any host can
materialize its own shard without coordination — the pattern real pipelines
use for data-parallel determinism (seed = f(step, shard)).  A light Zipf
token distribution + Markov-ish structure gives the loss something learnable
for the quickstart/train examples.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import Family, ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """next-token-predictable stream: token_{t+1} = f(token_t) + noise."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed random "grammar": each token has a likely successor
        self.successor = rng.integers(0, v, size=v)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, cfg.zipf_a)
        self.base_p = p / p.sum()

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + shard)
        b = cfg.batch // num_shards
        toks = np.empty((b, cfg.seq_len), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=b, p=self.base_p)
        follow = rng.random((b, cfg.seq_len - 1)) < 0.8
        noise = rng.choice(cfg.vocab_size, size=(b, cfg.seq_len - 1),
                           p=self.base_p)
        for t in range(1, cfg.seq_len):
            toks[:, t] = np.where(follow[:, t - 1],
                                  self.successor[toks[:, t - 1]],
                                  noise[:, t - 1])
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, step: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Family-aware synthetic batch (embeds stubs for VLM/audio)."""
    rng = np.random.default_rng(seed * 7919 + step)
    if cfg.is_encdec:
        return {
            "src_embeds": rng.standard_normal(
                (batch, seq_len, cfg.d_model)).astype(np.float32) * 0.02,
            "tgt_tokens": rng.integers(0, cfg.vocab_size,
                                       (batch, seq_len)).astype(np.int32),
        }
    if cfg.family == Family.VLM:
        pos = np.broadcast_to(np.arange(seq_len, dtype=np.int32)[None, None],
                              (3, batch, seq_len)).copy()
        return {
            "embeds": rng.standard_normal(
                (batch, seq_len, cfg.d_model)).astype(np.float32) * 0.02,
            "positions": pos,
            "labels": rng.integers(0, cfg.vocab_size,
                                   (batch, seq_len)).astype(np.int32),
        }
    data = SyntheticLM(DataConfig(batch, seq_len, cfg.vocab_size, seed))
    return data.batch_at(step)
