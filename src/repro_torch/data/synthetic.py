"""Deterministic synthetic LM data pipeline (a numpy copy of the JAX
package's ``repro.data.synthetic``: the same batches, bit for bit).

Stateless-seeded: ``batch(step)`` is a pure function of (seed, step), so a
restarted trial resumes bit-exactly from its checkpointed step — the trial-
level fault-tolerance contract (DESIGN.md §7) needs no data-state file.

The token stream is a learnable second-order Markov-ish process (a mixture of
copy/offset rules over a small latent alphabet) rather than iid noise, so a
real model trained on it shows a *decreasing* loss curve — required for the
early-stopping experiments to exercise meaningful learning curves.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticLMDataset"]


class SyntheticLMDataset:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        embed_dim: Optional[int] = None,  # set for embed_inputs (stub frontends)
    ):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.embed_dim = embed_dim
        # fixed random "grammar": a per-token successor permutation π with a
        # small second-order correction — learnable as an embedding lookup, so
        # small models show clearly decreasing loss curves within ~100 steps.
        g = np.random.default_rng(seed ^ 0x5EED)  # invariant: fresh-rng -- a fixed grammar derived from the seed alone; nothing to checkpoint
        self._perm = g.permutation(vocab_size)
        self._noise_p = 0.1
        self._emb = (
            (g.standard_normal((vocab_size, embed_dim)) / np.sqrt(embed_dim)).astype(
                np.float32
            )
            if embed_dim
            else None
        )

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 20) ^ step)  # invariant: fresh-rng -- stateless per-step generator f(seed, step); nothing to checkpoint or replay
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        toks = np.zeros((b, s + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, v, b)
        noise = rng.random((b, s + 1)) < self._noise_p
        rand = rng.integers(0, v, (b, s + 1))
        for t in range(1, s + 1):
            nxt = self._perm[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = self._tokens(step)
        inputs = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        if self._emb is not None:
            return {"inputs": self._emb[inputs], "labels": labels}
        return {"inputs": inputs, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
