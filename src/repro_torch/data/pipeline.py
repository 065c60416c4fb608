"""Deterministic synthetic data pipeline with sequence packing.

No external datasets are available offline, so the corpus is a seeded
Zipf-distributed token stream with injected n-gram structure (so loss
measurably decreases during training). Documents of variable length are
packed into fixed-length training sequences (the same packing the paper's
prefill-side SP stage assumes), with next-token labels.

The port's copy of the JAX package's ``data/pipeline.py``: the same
``(vocab, seq, batch, seed)`` gives bit-equal numpy batches on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    ngram_order: int = 3


class SyntheticCorpus:
    """Seeded document stream: Zipf unigrams + a sticky n-gram transition
    table, giving a learnable (non-uniform) conditional distribution."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        # sparse "grammar": each context token prefers a few successors
        self.n_succ = 4
        self.succ = self.rng.randint(0, v, size=(v, self.n_succ))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks ** 1.2)
        self.unigram /= self.unigram.sum()

    def _doc(self) -> np.ndarray:
        n = max(8, int(self.rng.exponential(self.cfg.mean_doc_len)))
        out = np.empty(n, np.int32)
        out[0] = self.rng.choice(self.cfg.vocab_size, p=self.unigram)
        for i in range(1, n):
            if self.rng.rand() < 0.7:   # follow grammar
                out[i] = self.succ[out[i - 1], self.rng.randint(self.n_succ)]
            else:
                out[i] = self.rng.choice(self.cfg.vocab_size, p=self.unigram)
        return out

    def packed_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite iterator of {tokens, labels} packed to (B, S)."""
        cfg = self.cfg
        buf = np.empty(0, np.int32)
        need = cfg.global_batch * (cfg.seq_len + 1)
        while True:
            while len(buf) < need:
                buf = np.concatenate([buf, self._doc()])
            chunk = buf[:need].reshape(cfg.global_batch, cfg.seq_len + 1)
            buf = buf[need:]
            yield {"tokens": chunk[:, :-1].copy(),
                   "labels": chunk[:, 1:].copy()}


def make_batch_iter(vocab_size: int, seq_len: int, global_batch: int,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    return SyntheticCorpus(
        DataConfig(vocab_size, seq_len, global_batch, seed)).packed_batches()
