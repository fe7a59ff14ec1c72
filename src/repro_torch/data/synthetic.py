"""Deterministic, shard-aware synthetic LM token streams (twin of
``TokenPipeline`` in ``src/repro/data/synthetic.py``).

Zipfian unigrams with an order-2 Markov mixing, deterministic per
(seed, step, shard).  The streams are numpy, so a batch here is
bit-identical to the JAX package's for the same arguments.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {self.n_shards} shards")
        return self.global_batch // self.n_shards

    def unigram_probs(self) -> np.ndarray:
        probs = 1.0 / np.arange(1, self.vocab_size + 1)
        return probs / probs.sum()

    def batch(self, step: int) -> dict:
        """{"tokens": (local_batch, seq_len) int32} on the CPU."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        B, S, V = self.local_batch, self.seq_len, self.vocab_size
        base = rng.choice(V, size=(B, S), p=self.unigram_probs())
        # order-2 structure: with prob .5, token t = (t-1 + t-2) % V
        mix = rng.random((B, S)) < 0.5
        for t in range(2, S):
            base[:, t] = np.where(mix[:, t],
                                  (base[:, t - 1] + base[:, t - 2]) % V,
                                  base[:, t])
        return {"tokens": torch.from_numpy(base.astype(np.int32))}
