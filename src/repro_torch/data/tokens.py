"""Deterministic synthetic LM token pipeline.

The port's own copy of ``repro.data.tokens`` (numpy only): the same
order-2 hashed Markov chain with random jumps, drawn from the same
``SeedSequence([seed, step])``, so ``batch_at(step)`` is bitwise the
reference's.  A batch depends only on (seed, step), so a resumed run
needs no data-pipeline state beyond the step counter.

``pack_documents`` LPT-packs variable-length documents into token-budget
bins with the port's ``pipeline/scheduler.part_lpt``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.pipeline.scheduler import part_lpt


class TokenStream:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """``inputs``/``targets`` (B, S) int32, ``mask`` (B, S) float32."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b, s, v = self.batch, self.seq, self.vocab
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        toks[:, 1] = rng.integers(0, v, b)
        rng.integers(1, v, b)       # the reference draws an unused multiplier
        for t in range(2, s + 1):
            # order-2 hashed markov chain + occasional random jumps
            a = toks[:, t - 1].astype(np.int64)
            c = toks[:, t - 2].astype(np.int64)
            nxt = ((a * 1103515245 + c * 12345 + 6364136) % 2147483647) % v
            jump = rng.random(b) < 0.05
            nxt = np.where(jump, rng.integers(0, v, b), nxt)
            toks[:, t] = nxt.astype(np.int32)
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:],
                "mask": np.ones((b, s), np.float32)}


def pack_documents(lengths, budget: int, m_bins: int):
    """LPT-pack variable-length documents into ``m_bins`` token-budget
    bins; returns each bin's document ids (``budget`` is not enforced, as
    in the reference)."""
    ids = list(range(len(lengths)))
    costs = {i: float(lengths[i]) for i in ids}
    return part_lpt(ids, m_bins, costs).queues
