"""Deterministic, seekable synthetic data pipeline.

Batches are a pure function of (seed, step): resuming training at step k
after a crash reproduces the exact token stream with zero iterator state
to checkpoint — the step number in the train checkpoint IS the data
cursor.  The stream mixes a Zipfian unigram background with repeated
"phrase" n-grams so small models have learnable structure (loss drops
measurably within a few hundred steps in examples/train_demo.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_phrases: int = 64
    phrase_len: int = 8


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # zipfian unigram distribution
        ranks = np.arange(1, v + 1)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._phrases = root.integers(
            0, v, size=(cfg.n_phrases, cfg.phrase_len))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(b, s + 1), p=self._probs)
        # splice in phrases: deterministic local structure
        n_splice = max(1, s // (4 * cfg.phrase_len))
        for i in range(b):
            idx = rng.integers(0, cfg.n_phrases, size=n_splice)
            pos = rng.integers(0, s + 1 - cfg.phrase_len, size=n_splice)
            for j, p in zip(idx, pos):
                toks[i, p:p + cfg.phrase_len] = self._phrases[j]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
