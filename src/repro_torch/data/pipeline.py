"""Deterministic data pipeline (port of ``repro.data.pipeline``): synthetic
token streams and calibration sets.

Pure numpy and identical to the JAX package's module, so both packages draw
the same token batches from the same seed: structured synthetic language
(Zipfian unigrams, a Markov-style repeat with a fixed offset, copy motifs),
enough signal for fine-tunes to diverge and for calibration to see realistic
activations.  Every batch is a pure function of (seed, step).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Zipf + Markov synthetic language over a given vocab."""
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def _zipf_probs(self) -> np.ndarray:
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = ranks ** -self.zipf_a
        return p / p.sum()

    def sample(self, step: int, batch: int, seq_len: int) -> np.ndarray:
        """(batch, seq_len) int32 tokens; pure function of (seed, step)."""
        rng = self._rng(step)
        probs = self._zipf_probs()
        toks = rng.choice(self.vocab_size, size=(batch, seq_len), p=probs)
        # Markov-ish structure: with p=0.3 repeat of (t-1 + fixed offset)
        offs = rng.integers(1, 17)
        rep = rng.random((batch, seq_len)) < 0.3
        shifted = (np.roll(toks, 1, axis=1) + offs) % self.vocab_size
        toks = np.where(rep, shifted, toks)
        # copy motifs: short spans repeated later in the sequence
        if seq_len >= 4 * self.motif_len:
            for b in range(batch):
                src = rng.integers(0, seq_len // 2 - self.motif_len)
                dst = rng.integers(seq_len // 2, seq_len - self.motif_len)
                toks[b, dst:dst + self.motif_len] = \
                    toks[b, src:src + self.motif_len]
        return toks.astype(np.int32)

    def lm_batch(self, step: int, batch: int, seq_len: int) -> dict:
        toks = self.sample(step, batch, seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_iterator(vocab_size: int, batch: int, seq_len: int,
                        seed: int = 0, start_step: int = 0
                        ) -> Iterator[dict]:
    """Resumable batch stream (pass the restored step to resume exactly)."""
    src = SyntheticLM(vocab_size, seed)
    step = start_step
    while True:
        yield src.lm_batch(step, batch, seq_len)
        step += 1


def calib_stream(vocab_size: int, n_samples: int, seq_len: int,
                 seed: int = 1234, batch: int = 5) -> Iterator[dict]:
    """Calibration sampler: the paper's 50-sample layer cache / 150-sample
    end-to-end budget maps to n_samples sequences here."""
    src = SyntheticLM(vocab_size, seed)
    for step in range(0, max(1, n_samples // batch)):
        yield src.lm_batch(10_000 + step, batch, seq_len)
