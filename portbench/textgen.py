"""Seeded synthetic text: Zipf unigrams with repeated n-gram motifs.

A copy of the generator of `repro_torch.data.pipeline.SyntheticLM`
(numpy only), kept here so that the benchmark's inputs do not move when
the program's data pipeline does.  Row `row` of batch `step` is a pure
function of (seed, step, row).
"""
from __future__ import annotations

import numpy as np

__all__ = ["TextGen"]


class TextGen:
    def __init__(self, vocab_size: int, seq_len: int, seed: int,
                 zipf_a: float = 1.3, motif_len: int = 8,
                 motif_repeat: int = 4):
        self.vocab_size, self.seq_len, self.seed = vocab_size, seq_len, seed
        self.motif_len, self.motif_repeat = motif_len, motif_repeat
        p = np.arange(1, vocab_size + 1, dtype=np.float64) ** (-zipf_a)
        self._p = p / p.sum()

    def row(self, step: int, row: int) -> np.ndarray:
        """int32 [seq_len]: Zipf tokens with a motif planted
        `motif_repeat` times."""
        rng = np.random.default_rng((self.seed, step, row))
        toks = rng.choice(self.vocab_size, size=self.seq_len,
                          p=self._p).astype(np.int32)
        mlen = min(self.motif_len, max(self.seq_len // 2, 1))
        motif = rng.integers(0, self.vocab_size, size=mlen).astype(np.int32)
        for _ in range(self.motif_repeat):
            at = int(rng.integers(0, max(self.seq_len - mlen, 1)))
            toks[at:at + mlen] = motif
        return toks

    def batch(self, step: int, rows: int) -> np.ndarray:
        """int32 [rows, seq_len]."""
        return np.stack([self.row(step, r) for r in range(rows)])
