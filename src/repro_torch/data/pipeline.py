"""Deterministic sharded synthetic-token pipeline.

The port's own copy of `repro.data.pipeline` (numpy only, unchanged but
for this note): batches are array-equal to the JAX package's for the
same (seed, step, shard, n_micro).  The trainer moves them to the device.

Production behaviours that matter at scale and are modelled here:
  * per-host sharding: each host materialises only its slice of the
    global batch (shard_id / num_shards);
  * deterministic resume: batch t is a pure function of (seed, step), so
    restoring step k after a failure replays the exact stream with no
    state files (the paper-style trace order stays stable too);
  * microbatch splitting for gradient accumulation;
  * a mixture of synthetic "documents" (zipf unigrams + repeated n-gram
    motifs) so the LM loss actually falls during the examples' training
    runs instead of flat-lining on uniform noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "host_shard"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    motif_repeat: int = 4


def host_shard(global_batch: int, shard_id: int, num_shards: int
               ) -> tuple[int, int]:
    """[start, size) slice of the global batch owned by this host."""
    assert global_batch % num_shards == 0, (global_batch, num_shards)
    per = global_batch // num_shards
    return shard_id * per, per


class SyntheticLM:
    """Stateless batch generator: `batch(step)` is deterministic."""

    def __init__(self, cfg: DataConfig, shard_id: int = 0,
                 num_shards: int = 1):
        self.cfg = cfg
        self.start, self.per_host = host_shard(cfg.global_batch, shard_id,
                                               num_shards)
        # fixed unigram distribution (zipf over vocab)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def batch(self, step: int, n_micro: int = 1) -> dict:
        """Returns {"tokens": int32 [B_host, S]} (or [n_micro, B/n, S])."""
        cfg = self.cfg
        rows = []
        for b in range(self.per_host):
            rng = np.random.default_rng(
                (cfg.seed, step, self.start + b))
            toks = rng.choice(cfg.vocab_size, size=cfg.seq_len,
                              p=self._p).astype(np.int32)
            # plant motifs: repeated n-grams give the model learnable
            # structure (copy heads drive the loss down)
            mlen = min(cfg.motif_len, max(cfg.seq_len // 2, 1))
            motif = rng.integers(0, cfg.vocab_size,
                                 size=mlen).astype(np.int32)
            for r in range(cfg.motif_repeat):
                at = int(rng.integers(0, max(cfg.seq_len - mlen, 1)))
                toks[at:at + mlen] = motif
            rows.append(toks)
        tokens = np.stack(rows)
        if n_micro > 1:
            assert self.per_host % n_micro == 0
            tokens = tokens.reshape(n_micro, self.per_host // n_micro,
                                    cfg.seq_len)
        return {"tokens": tokens}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
