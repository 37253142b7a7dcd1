"""The hybrid Granite cell (``granite-4.0-h-small.train4k``) on the CPU at
small sizes: its configuration file against the published config, the
inputs' layout against the program's parameters, a sound run correct and
each planted fault past a limit, and the readers of its per-layer metrics
on synthetic spans, counters and device traces."""

import json

import pytest

from amt_bench import harness
from amt_bench.harness import DeviceTrace

CELL = "granite-4.0-h-small.train4k"
#: published widths cut to a CPU's size (the cut depth, the 72-expert
#: router, top-10 and the 8 held experts kept); float32 compute
SMALL = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
         "mamba_n_heads": 4, "mamba_d_head": 32, "mamba_d_state": 8, "mamba_chunk_size": 8,
         "vocab_size": 97, "intermediate_size": 32, "shared_intermediate_size": 48,
         "port": {"compute_dtype": "float32"}}
TRAFFIC = {"global_batch": 4, "seq_len": 24, "microbatches": 2}
CATALOG_CONFIG = {  # the catalog row's ``config`` (granite-4.0-h-small's config.json)
    "attention_bias": False, "attention_multiplier": 0.0078125, "embedding_multiplier": 12,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 768,
    "logits_scaling": 16, "mamba_chunk_size": 256, "mamba_conv_bias": True,
    "mamba_d_conv": 4, "mamba_d_head": 64, "mamba_d_state": 128, "mamba_expand": 2,
    "mamba_n_groups": 1, "mamba_n_heads": 128, "mamba_proj_bias": False,
    "max_position_embeddings": 131072, "model_type": "granitemoehybrid",
    "normalization_function": "rmsnorm", "num_attention_heads": 32, "num_experts_per_tok": 10,
    "num_hidden_layers": 40, "num_key_value_heads": 8, "num_local_experts": 72,
    "position_embedding_type": "nope", "residual_multiplier": 0.22, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 10000, "shared_intermediate_size": 1536,
    "tie_word_embeddings": True, "vocab_size": 100352}


def _runner():
    return harness.load_module("runners", "train_hybrid")


def _conf():
    return harness.cell_files(CELL)[2]


def test_config_file_is_the_published_config_cut_as_it_says():
    conf = _conf()
    reduced = set(conf["reduced"])
    assert reduced == {"num_hidden_layers", "num_local_experts"}
    for key, value in CATALOG_CONFIG.items():
        if key in reduced:
            assert conf["published"][key] == value, key
        else:
            assert conf[key] == value, key
    kinds = ["attention" if i % 10 == 5 else "mamba" for i in range(40)]
    assert conf["layer_types"] == kinds
    assert conf["num_hidden_layers"] == 10 and conf["num_local_experts"] == 8
    assert conf["expert_share"]["router_experts"] == 72
    assert conf["expert_share"]["ways"] * conf["num_local_experts"] == 72


def test_parameters_and_layout_are_the_programs():
    from amt_bench.inputs.granite_hybrid import layout, parameters
    from repro_torch.models import build_model

    conf = _conf()
    assert parameters(conf) == conf["parameters"] == 2_320_321_152
    model = build_model(_runner().model_config(conf), impl="torch", device="cpu")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert [n for n, *_ in layout(conf)] == list(shapes)
    assert {n: s for n, s, *_ in layout(conf)} == shapes


def test_weights_follow_the_mamba2_rule():
    import torch

    from amt_bench.inputs.granite_hybrid import A_RANGE, DT_RANGE, make_weights

    conf = harness.merged(_conf(), SMALL)
    _, views = make_weights(conf, 5, torch.device("cpu"))
    a = torch.exp(views["blocks.0.mixer.a_log"])
    dt = torch.nn.functional.softplus(views["blocks.0.mixer.dt_bias"])
    assert A_RANGE[0] <= float(a.min()) and float(a.max()) <= A_RANGE[1]
    assert DT_RANGE[0] * (1 - 1e-5) <= float(dt.min()) and float(dt.max()) <= DT_RANGE[1] * 1.00001
    assert float(views["blocks.0.mixer.d_skip"].min()) == 1.0


def _checks(seed=7, trace=False):
    from amt_bench import run

    return run.run_cell(CELL, seed, 0.5, trace, device="cpu", overrides=TRAFFIC,
                        conf_overrides=SMALL)


def test_a_sound_traced_run_is_correct_and_reports_its_host_metrics():
    result, checks = _checks(2**31 + 41, trace=True)
    assert result["correct"] is True, checks
    metrics = result["metrics"]
    assert 0 < metrics["train_mfu.hybrid"]["value"] < 100
    assert 0 <= metrics["moe_drop_share"]["value"] <= 100
    # no device trace on the CPU: the device readers read nothing
    assert "ssd_roofline" not in metrics and "mamba2_fwd_share" not in metrics


@pytest.mark.parametrize("fault", ["no_carry", "no_shared", "held_renorm"])
def test_each_planted_fault_fails_a_limit(fault, monkeypatch):
    from repro_torch.models import mamba2, mlp

    for mod, name in ((mamba2, "carry_states"), (mlp, "_shared_ffn"), (mlp, "_combine_rows")):
        monkeypatch.setattr(mod, name, getattr(mod, name))  # restored after the test
    _runner().FAULTS[fault]()
    result, checks = _checks()
    assert result["correct"] is False
    assert any(v > lim for _, v, lim, _ in checks), checks


# -------------------------------------------------------------- the readers
def read(name, rec):
    return harness.load_module("metrics", name).read(rec)


def span(name, t0, t1):
    return {"name": name, "t0": t0, "t1": t1, "dur": t1 - t0}


def forward(spans, ops=None, counters=None, to_mono=0.0, tokens=4096):
    trace = None
    if ops is not None:
        trace = DeviceTrace(ops, window_s=1.0)
        trace.to_mono = to_mono
    return {"spans": spans, "counters": counters or {}, "trace": trace, "tokens": tokens}


def test_ssd_roofline_is_least_time_over_the_time_started_inside_the_scans():
    conf = _conf()
    mod = harness.load_module("metrics", "ssd_roofline")
    # two layers' scans at [10, 10.002] and [20, 20.003] on the spans' clock;
    # the profiler's clock is 4 s behind
    spans = [span("mamba2.mixer", 9.99, 10.01), span("mamba2.ssd", 10.0, 10.002),
             span("mamba2.mixer", 19.99, 20.01), span("mamba2.ssd", 20.0, 20.003)]
    ops = [("a", 6.0e6, 1000.0), ("b", 6.0015e6, 500.0),  # inside the first
           ("c", 16.003e6, 2000.0),                      # the second's edge
           ("d", 5.995e6, 7000.0), ("e", 16.0031e6, 9000.0),  # in the mixers only
           ("f", 30.0e6, 10000.0)]  # in neither
    rec = {"conf": conf, "device_name": "NVIDIA H100 80GB HBM3",
           "forward": forward(spans, ops, to_mono=4.0)}
    least = mod.least_s(conf, 4096, {"hbm": 3.35e12, "bf16": 989e12})
    assert read("ssd_roofline", rec) == pytest.approx(100 * 2 * least / 3.5e-3)
    # bytes bound it: x, B, C in bf16, Δ, y in float32
    nbytes = 4096 * (2 * 8192 + 4 * 128 + 4 * 128 + 4 * 8192) + 4 * 128
    assert least == pytest.approx(nbytes / 3.35e12)
    # the mixers' share of the whole forward's device time
    share = read("mamba2_fwd_share", rec)
    assert share == pytest.approx(100 * 19.5e-3 / 29.5e-3)


def test_device_readers_without_a_trace_or_the_spans_read_nothing():
    conf = _conf()
    base = {"conf": conf, "device_name": "NVIDIA H100 80GB HBM3"}
    for name in ("ssd_roofline", "mamba2_fwd_share"):
        assert read(name, {**base, "forward": None}) is None
        assert read(name, {**base}) is None
        assert read(name, {**base, "forward": forward([span("mamba2.ssd", 1, 2)])}) is None
        no_span = forward([span("moe.experts", 1, 2)], [("a", 1e6, 5.0)])
        assert read(name, {**base, "forward": no_span}) is None


def test_moe_drop_share_reads_the_counters():
    rec = {"forward": forward([], counters={"moe.pairs_held": 800, "moe.pairs_dropped": 60})}
    assert read("moe_drop_share", rec) == pytest.approx(7.5)
    assert read("moe_drop_share", {"forward": forward([])}) is None
    assert read("moe_drop_share", {}) is None


def test_train_mfu_hybrid_counts_what_its_docstring_says():
    mod = harness.load_module("metrics", "train_mfu.hybrid")
    conf = _conf()
    d, v, tokens = 4096, 100352, 4 * 4096
    mixer = d * (8192 + 8448 + 128) + 4 * 8448 + 8192 * d
    attn = 2 * d * 4096 + 2 * d * 1024
    ffn = d * 72 + 3 * d * 1536 + 10 * 8 / 72 * 3 * d * 768
    active = 9 * mixer + attn + 10 * (ffn + 2 * d) + d + d * v
    ssd = 256 * 128 + 256 * 8192 + 4 * 8192 * 128
    want = 6 * active * tokens + 3 * 4 * 4096 * 2048 * tokens + 9 * 3 * ssd * tokens
    assert mod.step_flops(conf, 4, 4096) == pytest.approx(want, rel=1e-12)
    rec = {"conf": conf, "workload": {"global_batch": 4, "seq_len": 4096},
           "device_name": "NVIDIA H100 80GB HBM3", "steps": 10, "window_s": 20.0,
           "unprofiled": {"steps": 5, "s": 10.0}}
    assert read("train_mfu.hybrid", rec) == pytest.approx(100 * want * 5 / (10.0 * 989e12))


def test_the_manifest_lists_the_cell_where_it_reports():
    bench = harness.manifest()
    e2e = {m["name"] for m in harness.metrics_of(bench, CELL, False)}
    layer = {m["name"] for m in harness.metrics_of(bench, CELL, True)}
    assert e2e == {"train_tokens_per_s", "setup_s"}
    assert layer == {"train_peak_mem_gb", "device_idle.train", "train_mfu.hybrid",
                     "ssd_roofline", "mamba2_fwd_share", "moe_drop_share"}
    assert json.loads(json.dumps(bench)) == bench
