"""Train entry (``training/train_step.py::make_train_step``): the whole
step's share of the card's bf16 peak (%): the model's useful operations a
step times the steps completed after the profiled part of the traced
window (the profiler slows the device while it records), over those
steps' seconds times the peak.

The operations are ``repro_torch/launch/roofline.py::model_flops`` for a
training step (commit 34e7d4a), frozen here for the attention + MoE decoder:
6 FLOPs a token for every active weight of the blocks (the routed experts'
top-k share) and for the tied head, and 3 × 4·Hq·Dh·(S/2) a token for each
causal attention layer's score and value products."""

from amt_bench.peaks import peaks_of


def step_flops(model: dict, batch: int, seq: int) -> float:
    d, v = model["d_model"], model["vocab_size"]
    hq, hkv, dh = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    moe = model["moe"]
    attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    mlp_active = d * moe["num_experts"] + moe["top_k"] * 3 * d * moe["d_expert"]
    layers = model["num_layers"]
    backbone_active = layers * (attn + mlp_active + 2 * d) + d
    tokens = batch * seq
    flops = 6.0 * backbone_active * tokens + 6.0 * d * v * tokens
    flops += layers * 3.0 * 4.0 * hq * dh * (seq / 2.0) * batch * seq
    return flops


def read(rec):
    part = rec.get("unprofiled") or {"steps": rec.get("steps"), "s": rec.get("window_s")}
    if not part["steps"]:
        return None
    wl = rec["workload"]
    flops = step_flops(rec["conf"]["model"], wl["global_batch"], wl["seq_len"]) * part["steps"]
    return 100.0 * flops / (part["s"] * peaks_of(rec["device_name"])["bf16"])
