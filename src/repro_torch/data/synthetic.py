"""Deterministic synthetic LM corpus (offline C4/WikiText-2 stand-in).

The port's own copy of ``repro.data.synthetic``: numpy only, and
bit-identical tokens for the same seed, so the JAX package and the port
calibrate and evaluate on the same batches.

A Zipf–Markov process: each token is either the deterministic successor of
the previous token under a fixed random permutation (probability
``p_copy``) or an i.i.d. draw from a Zipf marginal. This gives the stream
(a) a heavy-tailed unigram distribution (realistic embedding-gather
behavior and covariance spectra for NBL calibration) and (b) learnable
bigram structure, so perplexity separates good models from broken ones
(used by the SLEB baseline and eval/).

Everything is a pure function of (seed, shape): calibration replays
reproduce bit-identical batches. The port has no encoder frontend yet, so
``calib_factory`` yields no ``"enc"`` (ROADMAP.md §C).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class ZipfMarkov:
    def __init__(self, vocab_size: int, *, zipf_a: float = 1.2,
                 p_copy: float = 0.6, seed: int = 0):
        self.vocab = vocab_size
        self.p_copy = p_copy
        rng = np.random.default_rng(seed)
        self.succ = rng.permutation(vocab_size)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        probs = ranks ** -zipf_a
        self.marginal = probs / probs.sum()

    def sample(self, batch: int, seq: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng((seed, 0xC0FFEE))
        iid = rng.choice(self.vocab, size=(batch, seq), p=self.marginal)
        copy = rng.random((batch, seq)) < self.p_copy
        out = np.empty((batch, seq), np.int32)
        out[:, 0] = iid[:, 0]
        for t in range(1, seq):
            out[:, t] = np.where(copy[:, t], self.succ[out[:, t - 1]],
                                 iid[:, t])
        return out


def lm_batches(vocab_size: int, batch: int, seq: int, n_batches: int, *,
               seed: int = 0, start_step: int = 0,
               proc: ZipfMarkov | None = None) -> Iterator[dict]:
    """Yields {"tokens", "labels"} with next-token labels (-1 on the final
    position). Batch ``i`` depends only on (seed, start_step + i)."""
    proc = proc or ZipfMarkov(vocab_size, seed=seed)
    for i in range(start_step, start_step + n_batches):
        toks = proc.sample(batch, seq, seed * 1_000_003 + i)
        labels = np.full_like(toks, -1)
        labels[:, :-1] = toks[:, 1:]
        yield {"tokens": toks, "labels": labels}


def calib_factory(cfg, *, batch: int = 4, seq: int = 128,
                  n_batches: int = 8, seed: int = 1234):
    """Data factory for core.calibrate — the paper's "256 C4 samples of
    context t" (scaled down by default; sizes are caller-controlled).
    Each call of the factory replays the same batches (numpy arrays)."""
    def factory():
        yield from lm_batches(cfg.vocab_size, batch, seq, n_batches,
                              seed=seed)
    return factory
