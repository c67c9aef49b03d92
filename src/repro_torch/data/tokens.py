"""Deterministic synthetic token pipeline (offline LM pretraining stand-in),
a numpy copy of the reference's ``repro/data/tokens.py``.

A stateless ``(seed, step) -> batch`` map: any process can recompute any
batch, so a restart needs only the step counter, never an iterator's state.
The draws are the reference's, ``np.random.default_rng(SeedSequence([seed,
step]))`` in the same order, so both packages' batches are equal bit for
bit.

Sequences are a learnable mixture: a random affine recurrence
(token_{t+1} ≈ a·token_t + b mod V with noise) per sequence, so small
models show a falling loss.
"""
from __future__ import annotations

import numpy as np


def batch_at(seed: int, step: int, batch: int, seq: int, vocab: int,
             noise: float = 0.1) -> dict[str, np.ndarray]:
    """Returns {"tokens": (B, S) int32, "labels": (B, S) int32}:
    labels[t] = tokens[t + 1] (next-token prediction), the last label -1
    (ignored)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    a = rng.integers(1, 17, size=(batch, 1))
    b = rng.integers(0, vocab, size=(batch, 1))
    t0 = rng.integers(0, vocab, size=(batch, 1))
    idx = np.arange(seq)[None, :]
    toks = (t0 + a * idx + b * (idx // 7)) % vocab
    flip = rng.random((batch, seq)) < noise
    toks = np.where(flip, rng.integers(0, vocab, size=(batch, seq)), toks)
    toks = toks.astype(np.int32)
    labels = np.concatenate(
        [toks[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    return {"tokens": toks, "labels": labels}


class TokenPipeline:
    """An iterator over :func:`batch_at` that keeps only its step
    counter."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int,
                 start_step: int = 0):
        self.seed, self.batch, self.seq, self.vocab = seed, batch, seq, vocab
        self.step = start_step

    def next(self) -> dict[str, np.ndarray]:
        out = batch_at(self.seed, self.step, self.batch, self.seq, self.vocab)
        self.step += 1
        return out
