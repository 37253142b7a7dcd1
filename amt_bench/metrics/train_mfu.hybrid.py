"""Train entry (``training/train_step.py::make_train_step``) of the hybrid
Granite cells: the whole step's share of the card's bf16 peak (%), in the
manner of ``train_mfu``: the step's useful operations times the steps
completed after the profiled part of the traced window, over those steps'
seconds times the peak.

The operations are counted here from the configuration file's published
keys and frozen with this file: 6 FLOPs a token for every active weight —
each Mamba-2 mixer's in_proj, depthwise conv and out_proj, each attention
layer's q, k, v and o, every layer's router, shared expert and the held
experts' routed share (top_k · held/E of an expert a token: the part of
the layer this card computes), two norm gains a layer, and the tied head —
plus 3 × 4·Hq·Dh·(S/2) a token for each causal attention layer's score and
value products, plus 3 × the SSD's chunked products a token in each Mamba-2
layer at ``mamba_chunk_size`` L: C·Bᵀ and its product with Δx over the
causal half of a chunk (2·(L/2)·G·N + 2·(L/2)·H·P), the chunk states and
their read-out (2 · 2·H·P·N). Remat's recomputed forward is not useful
work and is not counted."""

from amt_bench.peaks import peaks_of


def step_flops(conf: dict, batch: int, seq: int) -> float:
    d, v = conf["hidden_size"], conf["vocab_size"]
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    dh = d // hq
    h, p, n, g = (conf["mamba_n_heads"], conf["mamba_d_head"], conf["mamba_d_state"],
                  conf["mamba_n_groups"])
    di, chunk = h * p, conf["mamba_chunk_size"]
    conv_dim = di + 2 * g * n
    e = conf["expert_share"]["router_experts"]
    held, k = conf["num_local_experts"], conf["num_experts_per_tok"]
    f, fs = conf["intermediate_size"], conf["shared_intermediate_size"]
    kinds = conf["layer_types"][: conf["num_hidden_layers"]]
    n_mamba = sum(1 for t in kinds if t == "mamba")
    n_attn = len(kinds) - n_mamba
    mixer = d * (di + conv_dim + h) + conf["mamba_d_conv"] * conv_dim + di * d
    attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    ffn = d * e + 3 * d * fs + k * held / e * 3 * d * f
    active = n_mamba * mixer + n_attn * attn + len(kinds) * (ffn + 2 * d) + d
    tokens = batch * seq
    ssd = 2 * (chunk / 2) * g * n + 2 * (chunk / 2) * h * p + 2 * 2 * h * p * n
    flops = 6.0 * (active + d * v) * tokens
    flops += n_attn * 3.0 * 4.0 * hq * dh * (seq / 2.0) * tokens
    flops += n_mamba * 3.0 * ssd * tokens
    return flops


def read(rec):
    part = rec.get("unprofiled") or {"steps": rec.get("steps"), "s": rec.get("window_s")}
    if not part["steps"]:
        return None
    wl = rec["workload"]
    flops = step_flops(rec["conf"], wl["global_batch"], wl["seq_len"]) * part["steps"]
    return 100.0 * flops / (part["s"] * peaks_of(rec["device_name"])["bf16"])
