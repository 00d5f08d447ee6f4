"""Synthetic LM token streams (Zipfian n-gram process): a copy of
``repro/data/synthetic_lm.py`` (numpy only).

Deterministic per (seed, index): the pipeline's only checkpoint state is its
cursor. The generator has genuine next-token structure (a latent bigram
table) so tiny-model training loss visibly decreases — useful for e2e
trainer tests and example programs without shipping a corpus.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int = 256
    seq_len: int = 128
    zipf_a: float = 1.2
    bigram_strength: float = 0.7


def _bigram_table(seed: int, cfg: LMDataConfig) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xB16]))
    return rng.integers(0, cfg.vocab_size,
                        size=(cfg.vocab_size,)).astype(np.int64)


def generate_sequence(seed: int, index: int, cfg: LMDataConfig) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    table = _bigram_table(seed, cfg)
    ranks = rng.zipf(cfg.zipf_a, size=cfg.seq_len + 1)
    base = np.minimum(ranks - 1, cfg.vocab_size - 1).astype(np.int64)
    seq = np.empty(cfg.seq_len + 1, np.int64)
    seq[0] = base[0]
    follow = rng.random(cfg.seq_len) < cfg.bigram_strength
    for i in range(1, cfg.seq_len + 1):
        seq[i] = table[seq[i - 1]] if follow[i - 1] else base[i]
    return seq


def generate_batch(seed: int, start_index: int, batch_size: int,
                   cfg: LMDataConfig) -> Dict[str, np.ndarray]:
    seqs = np.stack([generate_sequence(seed, start_index + i, cfg)
                     for i in range(batch_size)])
    return {"tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32)}
