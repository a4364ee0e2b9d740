"""Deterministic synthetic data pipeline (a copy of `repro.data.pipeline`;
numpy only, byte-identical arrays).

Every batch is a pure function of (seed, step, shard) — any host can
recompute any shard.  This is the straggler/elasticity story: a replacement
host joining mid-run (or a fast host covering for a slow one) regenerates
its shard without coordination or data-server state (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticTokens", "SyntheticBatches", "host_shard_slice"]


def host_shard_slice(global_batch: int, n_hosts: int, host_id: int) -> slice:
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    """Zipf-distributed token stream with local n-gram structure so the loss
    actually decreases during example training runs."""
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int, shard: slice | None = None) -> np.ndarray:
        sl = shard or slice(0, self.global_batch)
        rows = range(sl.start, sl.stop)
        out = np.empty((len(rows), self.seq_len), np.int32)
        for i, r in enumerate(rows):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 65_537 + r)
            # zipf head + repeated motif gives learnable structure
            base = rng.zipf(1.5, size=self.seq_len).astype(np.int64)
            motif = rng.integers(0, self.vocab, size=8)
            pos = rng.integers(0, max(self.seq_len - 8, 1), size=self.seq_len // 16)
            row = np.minimum(base, self.vocab - 1)
            for p in pos:
                row[p:p + 8] = motif
            out[i] = row.astype(np.int32)
        return out


@dataclasses.dataclass(frozen=True)
class SyntheticBatches:
    """Arch-aware batch maker (tokens / frames / image embeds)."""
    cfg: "object"           # ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int, shard: slice | None = None) -> dict:
        cfg = self.cfg
        toks = SyntheticTokens(cfg.vocab, self.seq_len, self.global_batch,
                               self.seed)
        sl = shard or slice(0, self.global_batch)
        n = sl.stop - sl.start
        rng = np.random.default_rng(self.seed * 7919 + step)
        if cfg.encoder_decoder:
            dec = max(self.seq_len // cfg.dec_ratio, 16)
            return {
                "frames": rng.standard_normal(
                    (n, self.seq_len, cfg.d_model)).astype(np.float32) * 0.02,
                "tokens": SyntheticTokens(cfg.vocab, dec, self.global_batch,
                                          self.seed).batch(step, sl),
            }
        if cfg.n_image_tokens:
            text = max(self.seq_len - cfg.n_image_tokens, 16)
            return {
                "tokens": SyntheticTokens(cfg.vocab, text, self.global_batch,
                                          self.seed).batch(step, sl),
                "image_embeds": rng.standard_normal(
                    (n, cfg.n_image_tokens, cfg.d_model)).astype(np.float32) * 0.02,
            }
        return {"tokens": toks.batch(step, sl)}
