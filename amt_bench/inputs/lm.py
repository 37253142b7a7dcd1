"""The LM cells' inputs, made by the benchmark from ``--seed`` and handed
alike to the program and to the reference: seeded weights made on the card,
and the token batches.

``SyntheticLMDataset`` is a frozen copy of ``repro_torch/data/synthetic.py``
(commit 34e7d4a): a learnable copy/offset Markov stream, ``batch(step)`` a
pure function of (seed, step)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class SyntheticLMDataset:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        g = np.random.default_rng(seed ^ 0x5EED)
        self._perm = g.permutation(vocab_size)
        self._noise_p = 0.1

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 20) ^ step)
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
        return {"inputs": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def layout(model: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, init std; 0 for a norm's zero gain) of every weight of
    the configuration's LM, in the program's parameter order and names."""
    d, v = model["d_model"], model["vocab_size"]
    hq, hkv, dh = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    e, f = model["moe"]["num_experts"], model["moe"]["d_expert"]
    out = [("embed", (v, d), d ** -0.5), ("final_norm", (d,), 0.0)]
    for i in range(model["num_layers"]):
        b = f"blocks.{i}."
        out += [(b + "ln1", (d,), 0.0), (b + "ln2", (d,), 0.0),
                (b + "attn.wq", (d, hq, dh), d ** -0.5), (b + "attn.wk", (d, hkv, dh), d ** -0.5),
                (b + "attn.wv", (d, hkv, dh), d ** -0.5),
                (b + "attn.wo", (hq, dh, d), (hq * dh) ** -0.5),
                (b + "mlp.router", (d, e), d ** -0.5), (b + "mlp.w1", (e, d, f), d ** -0.5),
                (b + "mlp.w2", (e, f, d), f ** -0.5), (b + "mlp.w3", (e, d, f), d ** -0.5)]
    return out


def make_weights(model: dict, seed: int, device):
    """The weights as one float32 buffer made on ``device`` by a single
    ``torch.Generator`` draw, and {name: view of it}: normal draws times
    each weight's init std, zeros for the norms' gains."""
    import torch

    lay = layout(model)
    total = sum(int(np.prod(s)) for _, s, _ in lay)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    views, off = {}, 0
    for name, shape, std in lay:
        n = int(np.prod(shape))
        view = flat[off:off + n].view(shape)
        if std == 0.0:
            view.zero_()
        else:
            view.mul_(std)
        views[name] = view
        off += n
    return flat, views
