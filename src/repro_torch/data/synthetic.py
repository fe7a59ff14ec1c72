"""Deterministic synthetic data (twin of ``src/repro/data/synthetic.py``).

* ``TokenPipeline`` — LM token streams: Zipfian unigrams with an order-2
  Markov mixing, deterministic per (seed, step, shard), and an
  encoder-decoder's source frames or a vlm's image patches beside them
  (``batch_with_aux``); with
  ``dirichlet_alpha`` > 0 each shard's unigrams are tilted by a
  Dirichlet(alpha) reweighting keyed on (seed, shard) only — the
  federated cohort's non-IID clients (DESIGN.md §13);
* ``interpolated_regression`` / ``regression_batch`` — the paper's Fig. 4
  least squares with an exact interpolant;
* ``teacher_classification`` / ``class_batch`` — 32x32x3 images (NHWC)
  labelled by a fixed random linear teacher.

Everything is drawn with numpy, so a batch here is bit-identical to the
JAX package's for the same arguments.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# SeedSequence domain tag of the per-shard Dirichlet tilt stream (the JAX
# package's): independent of the per-(seed, step, shard) batch streams
_DIRICHLET_TAG = 0xD161_C4E7


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    # > 0: non-IID shards — a per-shard Dirichlet(alpha) reweighting of
    # the zipf unigrams, keyed on (seed, shard) only; small alpha puts
    # each shard's mass on a few shard-specific symbols
    dirichlet_alpha: float = 0.0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {self.n_shards} shards")
        return self.global_batch // self.n_shards

    def unigram_probs(self) -> np.ndarray:
        """This shard's unigram distribution: zipf, Dirichlet-tilted when
        ``dirichlet_alpha`` > 0 — a function of (seed, shard,
        dirichlet_alpha, vocab_size), never of the step or n_shards."""
        V = self.vocab_size
        probs = 1.0 / np.arange(1, V + 1)
        probs /= probs.sum()
        if self.dirichlet_alpha > 0:
            trng = np.random.default_rng(np.random.SeedSequence(
                [self.seed, _DIRICHLET_TAG, self.shard]))
            # gamma weights ~ the un-normalized Dirichlet sample; the
            # floor guards tiny-alpha underflow to an all-zero draw
            w = np.maximum(trng.gamma(self.dirichlet_alpha, 1.0, size=V),
                           1e-300)
            probs = probs * w
            probs /= probs.sum()
        return probs

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

    def batch_with_aux(self, step: int, cfg) -> dict:
        """:meth:`batch` plus the stubbed modality input of a vlm or an
        encoder-decoder config: ``image_embed`` (local_batch, n_patches,
        d_model) or ``src_embed`` (local_batch, seq_len, d_model), f32
        standard normals from the ``(seed + 7, step, shard)`` stream,
        JAX's draw bit for bit."""
        b = self.batch(step)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 7, step, self.shard]))
        if cfg.family == "vlm":
            b["image_embed"] = torch.from_numpy(rng.standard_normal(
                (self.local_batch, cfg.n_patches, cfg.d_model),
                dtype=np.float32))
        if cfg.family == "encdec":
            b["src_embed"] = torch.from_numpy(rng.standard_normal(
                (self.local_batch, self.seq_len, cfg.d_model),
                dtype=np.float32))
        return b


def interpolated_regression(n: int, d: int, *, feature_std: float = 1.0,
                            seed: int = 0):
    """Least squares with an exact interpolant: (A (n, d), b (n,),
    x_star (d,)) f32 with ``b = A @ x_star`` (in f64, then rounded)."""
    rng = np.random.default_rng(seed)
    x_star = rng.standard_normal(d)
    A = rng.standard_normal((n, d)) * feature_std
    b = A @ x_star
    return tuple(torch.from_numpy(v.astype(np.float32))
                 for v in (A, b, x_star))


def regression_batch(A, b, batch_size: int, step: int, seed: int = 0):
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    idx = torch.from_numpy(rng.integers(0, A.shape[0], batch_size))
    return A[idx], b[idx]


def teacher_classification(n: int, *, n_classes: int = 100, seed: int = 0,
                           image: bool = True):
    """(x, y): x (n, 32, 32, 3) f32 images (or (n, 3072) vectors), y (n,)
    int32 labels of a fixed random linear teacher, so an
    over-parameterized net can interpolate."""
    rng = np.random.default_rng(seed)
    shape = (n, 32, 32, 3) if image else (n, 3072)
    x = rng.standard_normal(shape).astype(np.float32)
    feats = x.reshape(n, -1)
    W = rng.standard_normal((feats.shape[1], n_classes)) / np.sqrt(
        feats.shape[1])
    y = np.argmax(feats @ W, axis=1)
    return torch.from_numpy(x), torch.from_numpy(y.astype(np.int32))


def class_batch(x, y, batch_size: int, step: int, seed: int = 0):
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    idx = torch.from_numpy(rng.integers(0, x.shape[0], batch_size))
    return {"x": x[idx], "y": y[idx]}
