"""The hybrid Granite cells' inputs, made by the benchmark from ``--seed`` and
handed alike to the program and to the reference: the model's settings read
from the configuration file (the published ``config.json`` keys), the
weights' layout in the program's parameter names and order, and seeded
weights made on the card. Batches are ``inputs/lm.py``'s
``SyntheticLMDataset``.

Inits: normal draws times each matrix's std (d_in^-0.5), zeros for the
norms' gains (stored as 1 + g) and the conv bias, ones for D, and
Mamba-2's published rule for A and Δ's bias: A uniform in [1, 16], stored
as log A; Δ log-uniform in [1e-3, 1e-1] (floored at 1e-4), stored as
softplus⁻¹(Δ). The uniform draws are Φ of the same normal draws."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)
DT_FLOOR = 1e-4


def settings(conf: dict) -> Dict[str, object]:
    """The model's sizes from the configuration file: the cut depth's layer
    kinds ("mamba" or "attention", the first ``num_hidden_layers`` of
    ``layer_types``) and the expert share (the router scores
    ``router_experts``; ``num_local_experts`` are held, from
    ``first_held``)."""
    share = conf["expert_share"]
    heads, head_dim = conf["mamba_n_heads"], conf["mamba_d_head"]
    if heads * head_dim != conf["mamba_expand"] * conf["hidden_size"]:
        raise ValueError("mamba_n_heads · mamba_d_head must be mamba_expand · hidden_size")
    return {
        "d": conf["hidden_size"], "vocab": conf["vocab_size"],
        "kinds": list(conf["layer_types"][: conf["num_hidden_layers"]]),
        "hq": conf["num_attention_heads"], "hkv": conf["num_key_value_heads"],
        "dh": conf["hidden_size"] // conf["num_attention_heads"],
        "heads": heads, "head_dim": head_dim, "d_state": conf["mamba_d_state"],
        "groups": conf["mamba_n_groups"], "d_conv": conf["mamba_d_conv"],
        "chunk": conf["mamba_chunk_size"],
        "experts": share["router_experts"], "held": conf["num_local_experts"],
        "first_held": share["first_held"], "top_k": conf["num_experts_per_tok"],
        "d_expert": conf["intermediate_size"], "d_shared": conf["shared_intermediate_size"],
        "eps": conf["rms_norm_eps"], "embed_mult": float(conf["embedding_multiplier"]),
        "attn_scale": conf["attention_multiplier"], "res_mult": conf["residual_multiplier"],
        "logits_scaling": float(conf["logits_scaling"]),
        "capacity_factor": conf["assumed"]["moe"]["capacity_factor"],
        "aux_loss_weight": conf["assumed"]["moe"]["aux_loss_weight"],
    }


def layout(conf: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, std) of every weight, in the program's parameter
    order and names; init is "normal", "zeros", "ones", "a_log" or
    "dt_bias"."""
    m = settings(conf)
    d, v = m["d"], m["vocab"]
    hq, hkv, dh = m["hq"], m["hkv"], m["dh"]
    h, di = m["heads"], m["heads"] * m["head_dim"]
    conv_dim = di + 2 * m["groups"] * m["d_state"]
    e, held, f, fs = m["experts"], m["held"], m["d_expert"], m["d_shared"]
    out = [("embed", (v, d), "normal", d ** -0.5), ("final_norm", (d,), "zeros", 0.0)]
    for i, kind in enumerate(m["kinds"]):
        b = f"blocks.{i}."
        out += [(b + "ln1", (d,), "zeros", 0.0), (b + "ln2", (d,), "zeros", 0.0)]
        if kind == "mamba":
            x = b + "mixer."
            out += [(x + "in_proj", (d, di + conv_dim + h), "normal", d ** -0.5),
                    (x + "conv_w", (m["d_conv"], conv_dim), "normal", m["d_conv"] ** -0.5),
                    (x + "conv_b", (conv_dim,), "zeros", 0.0),
                    (x + "dt_bias", (h,), "dt_bias", 0.0), (x + "a_log", (h,), "a_log", 0.0),
                    (x + "d_skip", (h,), "ones", 0.0), (x + "norm", (di,), "zeros", 0.0),
                    (x + "out_proj", (di, d), "normal", di ** -0.5)]
        elif kind == "attention":
            out += [(b + "attn.wq", (d, hq, dh), "normal", d ** -0.5),
                    (b + "attn.wk", (d, hkv, dh), "normal", d ** -0.5),
                    (b + "attn.wv", (d, hkv, dh), "normal", d ** -0.5),
                    (b + "attn.wo", (hq, dh, d), "normal", (hq * dh) ** -0.5)]
        else:
            raise ValueError(f"unknown layer type {kind!r}")
        out += [(b + "mlp.router", (d, e), "normal", d ** -0.5),
                (b + "mlp.w1", (held, d, f), "normal", d ** -0.5),
                (b + "mlp.w2", (held, f, d), "normal", f ** -0.5),
                (b + "mlp.w3", (held, d, f), "normal", d ** -0.5),
                (b + "mlp.shared_w1", (d, fs), "normal", d ** -0.5),
                (b + "mlp.shared_w3", (d, fs), "normal", d ** -0.5),
                (b + "mlp.shared_w2", (fs, d), "normal", fs ** -0.5)]
    return out


def parameters(conf: dict) -> int:
    return sum(int(np.prod(s)) for _, s, _, _ in layout(conf))


def make_weights(conf: dict, seed: int, device):
    """The weights as one float32 buffer made on ``device`` by a single
    ``torch.Generator`` normal draw, and {name: view of it}."""
    import torch

    lay = layout(conf)
    total = sum(int(np.prod(s)) for _, s, _, _ in lay)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    views, off = {}, 0
    for name, shape, init, std in lay:
        n = int(np.prod(shape))
        view = flat[off:off + n].view(shape)
        if init == "normal":
            view.mul_(std)
        elif init == "zeros":
            view.zero_()
        elif init == "ones":
            view.fill_(1.0)
        else:
            u = 0.5 * (1.0 + torch.erf(view / math.sqrt(2.0)))  # Φ: uniform in (0, 1)
            if init == "a_log":
                view.copy_(torch.log(A_RANGE[0] + (A_RANGE[1] - A_RANGE[0]) * u))
            else:
                lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
                dt = torch.exp(lo + u * (hi - lo)).clamp(min=DT_FLOOR)
                view.copy_(dt + torch.log(-torch.expm1(-dt)))
        views[name] = view
        off += n
    return flat, views
