"""Deterministic synthetic LM data pipeline (step-indexed => restart-safe).

A copy of ``repro/data/lm.py``, numpy only and unchanged: any reordered
draw would change every batch.

``batch_for_step(step)`` is a pure function of (seed, step): after a crash and
restore-from-checkpoint, training replays exactly the same remaining batches —
the property the fault-tolerance integration test asserts.  The token stream is
a Zipf-ish unigram mix with short-range repetition so tiny models have
something learnable.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LMDataConfig", "SyntheticLMData"]


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0


class SyntheticLMData:
    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks**1.1
        self.probs = probs / probs.sum()
        self.base_seed = int(rng.integers(0, 2**31 - 1))

    def batch_for_step(self, step: int, extras: dict | None = None) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((self.base_seed, step))
        toks = rng.choice(cfg.vocab, size=(cfg.batch, cfg.seq_len), p=self.probs)
        # short-range repetition: copy spans back by 3 with prob .3 (learnable)
        rep = rng.random((cfg.batch, cfg.seq_len)) < 0.3
        toks[:, 3:] = np.where(rep[:, 3:], toks[:, :-3], toks[:, 3:])
        out = {"tokens": toks.astype(np.int32)}
        if extras:
            for name, shape in extras.items():
                out[name] = rng.normal(0, 0.02, size=(cfg.batch, *shape)).astype(
                    np.float32
                )
        return out
