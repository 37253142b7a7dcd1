"""granite-4.0-h-small in the port: the Mamba-2 (SSD) mixer, NoPE attention,
the μP multipliers and the MoE with a shared expert and an expert share,
held against the plain reference the benchmark checks its cell with
(``amt_bench/reference/granite_hybrid_train.py``) at ``tiny()`` sizes with
seeded weights, TF32 off. The JAX package has no such arch; this file
imports no JAX, so its card test runs on the card:
``python -m pytest -q --noconftest -m card tests/test_torch_granite_hybrid.py``.
"""

import dataclasses
import hashlib
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from amt_bench.reference.granite_hybrid_train import Reference  # noqa: E402
from repro_torch.configs import get_config, tiny  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.common import MAMBA2_A_RANGE, MAMBA2_DT_RANGE  # noqa: E402
from repro_torch.training import AdamWConfig, make_train_step  # noqa: E402
from repro_torch.training.train_step import train_state_of  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(1)

ARCH = "granite-4.0-h-small"
OPT = {"learning_rate": 1e-3, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "clip_norm": 1.0, "warmup_steps": 2, "total_steps": 100, "min_lr_ratio": 0.1,
       "schedule": "cosine", "moment_dtype": "float32", "grad_accum_dtype": "float32"}
#: the tiny arch as it is (all 4 experts held) and a share: 3 of 12 experts
#: (top-3) from the fourth on
SHARES = {"all": {}, "share": {"num_experts": 12, "top_k": 3, "num_held": 3, "first_held": 3}}


def _cfg(share="all", **kw):
    cfg = tiny(get_config(ARCH))
    moe = dataclasses.replace(cfg.moe, **SHARES[share])
    return dataclasses.replace(cfg, moe=moe, **kw)


def _settings(cfg):
    """The reference's settings of a port config."""
    m2, moe = cfg.mamba2, cfg.moe
    return {"eps": cfg.norm_eps, "heads": m2.num_heads, "head_dim": m2.head_dim,
            "d_state": m2.d_state, "groups": m2.n_groups, "d_conv": m2.d_conv,
            "hq": cfg.num_heads, "hkv": cfg.num_kv_heads, "dh": cfg.head_dim,
            "attn_scale": cfg.attn_scale, "experts": moe.num_experts, "top_k": moe.top_k,
            "held": moe.num_held or moe.num_experts, "first_held": moe.first_held,
            "capacity_factor": moe.capacity_factor, "aux_loss_weight": moe.aux_loss_weight,
            "kinds": ["mamba" if k == "mamba2" else "attention" for k in cfg.layer_kinds()],
            "res_mult": cfg.residual_multiplier, "embed_mult": cfg.embedding_multiplier,
            "logits_scaling": cfg.logits_scaling}


def _model(cfg, seed=0):
    model = build_model(cfg, impl="torch", device="cpu").init(seed)
    with torch.no_grad():  # gains and biases off zero, so that a wrong use shows
        gen = torch.Generator().manual_seed(seed + 1)
        for name, p in model.named_parameters():
            if name.endswith(("ln1", "ln2", "final_norm", "mixer.norm", "conv_b")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def _batch(cfg, rows=2, seq=20, seed=0):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (rows, seq + 1), generator=gen)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


# ----------------------------------------------------------------- the scan
def _recurrence(x, dt, a, b, c):
    """S_t = exp(Δ_t A)·S_{t−1} + Δ_t x_t ⊗ B_t, y_t = S_t·C_t, step by step
    in float64."""
    bsz, s, h, p = x.shape
    g = b.shape[2]
    state = torch.zeros(bsz, h, p, b.shape[3], dtype=torch.float64)
    ys = []
    for t in range(s):
        bh = b[:, t].double().repeat_interleave(h // g, dim=1)
        ch = c[:, t].double().repeat_interleave(h // g, dim=1)
        decay = torch.exp(dt[:, t].double() * a.double())
        state = decay[..., None, None] * state + \
            (dt[:, t].double()[..., None] * x[:, t].double())[..., None] * bh[:, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("seq,chunk,groups", [(32, 8, 1), (27, 8, 1), (5, 8, 2), (40, 16, 2),
                                              (33, 4, 1)])
def test_chunked_ssd_matches_the_recurrence(seq, chunk, groups):
    gen = torch.Generator().manual_seed(seq * 31 + chunk)
    h, p, n = 4, 6, 5
    x = torch.randn(2, seq, h, p, generator=gen)
    # Δ·A from about 1e-3 to 1: states that live across chunks and ones that do not
    dt = F.softplus(torch.randn(2, seq, h, generator=gen) - 2.0)
    a = -torch.exp(torch.linspace(math.log(0.01), math.log(2.0), h))
    b = torch.randn(2, seq, groups, n, generator=gen)
    c = torch.randn(2, seq, groups, n, generator=gen)
    want = _recurrence(x, dt, a, b, c)
    got = M2.ssd(x, dt, a, b, c, chunk)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got.double(), want, rtol=0, atol=2e-5 * float(want.abs().max()))


# ------------------------------------------------------------ the reference
@pytest.mark.parametrize("share", sorted(SHARES))
def test_loss_and_every_gradient_match_the_reference(share):
    cfg = _cfg(share)
    model = _model(cfg)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    batch = _batch(cfg)
    loss, met = model.loss_fn(batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))
    ref = Reference(_settings(cfg), OPT, {k: p.detach() for k, p in params.items()})
    r_loss, r_ce, r_aux = ref.loss(batch["inputs"], batch["labels"])
    r_loss.backward()
    assert float(met["aux"].detach()) > 0
    torch.testing.assert_close(loss.detach(), r_loss.detach(), rtol=2e-6, atol=0)
    torch.testing.assert_close(met["aux"], r_aux.detach(), rtol=2e-6, atol=0)
    for name, g in grads.items():
        want = ref.w[name].grad
        if want is None:  # no token reached it
            assert g is None or float(g.abs().max()) == 0.0, name
            continue
        scale = max(float(want.abs().max()), 1e-6)
        torch.testing.assert_close(g, want, rtol=0, atol=1e-4 * scale, msg=name)


def test_one_train_step_matches_the_reference_step():
    cfg = _cfg("share")
    model = _model(cfg)
    ref = Reference(_settings(cfg), OPT, {k: p.detach().clone() for k, p in
                                         model.named_parameters()})
    opt = AdamWConfig(**OPT)
    state = train_state_of(model, opt)
    batch = _batch(cfg, rows=4, seq=12, seed=5)
    step = make_train_step(model, opt, microbatches=2)
    _, met = step(state, batch)
    r_loss, _ = ref.step(batch["inputs"], batch["labels"], 2)
    assert float(met["loss"]) == pytest.approx(r_loss, rel=2e-6)
    # AdamW moves every element by about lr (5e-4 at the first warmup step)
    # whatever its gradient's size, so an element whose gradient is at
    # rounding may move either way: the twins' 5e-4 (test_torch_training)
    for name, p in state.params.items():
        torch.testing.assert_close(p.detach(), ref.w[name].detach(), rtol=0, atol=5e-4, msg=name)
    moved = sum(int(((p.detach() - ref.w[name].detach()).abs() > 1e-6).sum())
                for name, p in state.params.items())
    assert moved <= 1e-3 * sum(p.numel() for p in state.params.values())


def test_expert_shares_sum_to_the_uncut_layer():
    """Nine shares of 8 of 72 experts (top-10): their parts of the layer,
    the shared expert counted once, add up to the whole layer's output —
    the program's uncut layer and the reference's alike; every share's aux
    loss is the whole layer's."""
    whole = dataclasses.replace(_cfg(), d_model=32, moe=dataclasses.replace(
        _cfg().moe, num_experts=72, top_k=10, d_expert=16, d_shared=24))
    params = mlp.moe_params(whole).to_empty(device="cpu")
    gen = torch.Generator().manual_seed(11)
    for name, p in params.named_parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen) * p.shape[-2] ** -0.5)
    x = torch.randn(2, 40, whole.d_model, generator=gen)
    out, aux = mlp.moe_fwd(x, params, whole)
    shared = mlp._shared_ffn(x, params)
    total = shared.clone()
    for i in range(9):
        cut = dataclasses.replace(whole, moe=dataclasses.replace(whole.moe, num_held=8,
                                                                 first_held=8 * i))
        part = mlp.moe_params(cut).to_empty(device="cpu")
        for name, p in params.named_parameters():
            own = p.data[8 * i:8 * i + 8] if name in ("w1", "w2", "w3") else p.data
            getattr(part, name).data.copy_(own)
        out_i, aux_i = mlp.moe_fwd(x, part, cut)
        torch.testing.assert_close(aux_i, aux)
        total += out_i - shared
    torch.testing.assert_close(total, out, rtol=0, atol=1e-5)
    ref = Reference({**_settings(whole), "held": 72, "first_held": 0}, OPT,
                    {f"blocks.0.mlp.{k}": p.data for k, p in params.named_parameters()})
    r_out, r_aux = ref._moe(x.reshape(-1, whole.d_model), 0)
    torch.testing.assert_close(total.reshape(-1, whole.d_model), r_out.detach(), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(aux, r_aux.detach())


def test_init_follows_the_mamba2_rule():
    model = build_model(_cfg(), impl="torch", device="cpu").init(7)
    mixer = model.blocks[0].mixer
    a = torch.exp(mixer.a_log)
    dt = F.softplus(mixer.dt_bias)
    assert float(a.min()) >= MAMBA2_A_RANGE[0] and float(a.max()) <= MAMBA2_A_RANGE[1]
    assert float(dt.min()) >= MAMBA2_DT_RANGE[0] * (1 - 1e-5)
    assert float(dt.max()) <= MAMBA2_DT_RANGE[1] * (1 + 1e-5)
    assert torch.equal(mixer.d_skip, torch.ones_like(mixer.d_skip))


def test_published_widths_and_parameters():
    cfg = get_config(ARCH)
    assert cfg.layer_kinds().count("attn") == 4
    assert [i for i, k in enumerate(cfg.layer_kinds()) if k == "attn"] == [5, 15, 25, 35]
    assert cfg.mamba2.d_inner == 2 * cfg.d_model
    model = build_model(dataclasses.replace(cfg, num_layers=10, moe=dataclasses.replace(
        cfg.moe, num_held=8)), impl="torch", device="cpu")
    assert model.num_params() == 2_320_321_152
    assert tuple(model.blocks[0].mixer.in_proj.shape) == (4096, 8192 + 8448 + 128)


# ------------------------------------------------------------------ serving
def test_serving_refuses_mamba2_blocks():
    model = _model(_cfg())
    prompt = _batch(model.cfg)["inputs"]
    for call in (lambda: model.prefill(prompt, 32), lambda: model.init_cache(2, 32),
                 lambda: model.decode_step([], prompt[:, 0], 0)):
        with pytest.raises(NotImplementedError, match="mamba2 blocks"):
            call()


# ---------------------------------------------------------------- telemetry
NEW_SPANS = {"mamba2.mixer", "mamba2.ssd", "moe.experts", "moe.shared"}


def test_spans_and_counters_only_while_recording():
    cfg = _cfg("share")
    model = _model(cfg)
    batch = _batch(cfg)
    tel = telemetry.get()
    was = tel.enabled
    try:
        telemetry.set_enabled(False)
        tel.reset()
        with torch.no_grad():
            off, _ = model.loss_fn(batch)
        assert tel.trace_events() == [] and tel.metrics()["counters"] == {}
        telemetry.set_enabled(True)
        with torch.no_grad():
            on, _ = model.loss_fn(batch)
        spans = [e for e in tel.trace_events() if e["kind"] == "span"]
        counters = tel.metrics()["counters"]
    finally:
        telemetry.set_enabled(was)
        tel.reset()
    assert torch.equal(off, on)
    names = [s["name"] for s in spans]
    assert set(names) == NEW_SPANS
    mixers = cfg.layer_kinds().count("mamba2")
    assert names.count("mamba2.ssd") == names.count("mamba2.mixer") == mixers
    assert names.count("moe.experts") == names.count("moe.shared") == cfg.num_layers
    by_id = {s["span_id"]: s for s in spans}
    assert all(by_id[s["parent_id"]]["name"] == "mamba2.mixer"
               for s in spans if s["name"] == "mamba2.ssd")
    # the held experts' pairs: routed by the reference's rule, counted alike
    assert 0 < counters["moe.pairs_held"] <= cfg.num_layers * 2 * 20 * cfg.moe.top_k
    assert 0 <= counters["moe.pairs_dropped"] <= counters["moe.pairs_held"]


def test_spans_and_counters_do_nothing_while_a_graph_is_captured(monkeypatch):
    """During a capture (``is_current_stream_capturing``) a recording site
    neither waits for the card nor reads it: the shared no-op span."""
    tel = telemetry.Telemetry(enabled=True)
    cuda = torch.device("cuda")

    def refuse(*a, **k):
        raise AssertionError("synchronized while capturing")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert tel.recording(cuda) is False
    with tel.fenced_span("mamba2.ssd", cuda):
        pass
    assert tel.trace_events() == []
    monkeypatch.setattr(telemetry, "_GLOBAL", tel)
    mlp._count_pairs(torch.ones(1, 6, dtype=torch.bool), None)  # on the CPU: recorded
    assert tel.metrics()["counters"] == {"moe.pairs_held": 6, "moe.pairs_dropped": 0}
    tel.reset()

    class OnTheCard:  # a capture may not read it: any read raises
        device = cuda

        def sum(self):
            raise AssertionError("read while capturing")

    mlp._count_pairs(OnTheCard(), None)
    assert tel.metrics()["counters"] == {}


# ------------------------------------------ granite-moe-1b's ops unchanged
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_granite_moe_forward_issues_the_ops_it_did_before_the_new_options():
    """tiny(granite-moe-1b-a400m)'s forward at the new options' defaults:
    the aten op sequence recorded on the tree before they were added (685
    ops) — no multiply by 1, no extra norm, no rotary branch, no span."""
    cfg = tiny(get_config("granite-moe-1b-a400m"))
    model = build_model(cfg, impl="torch", device="cpu").init(0)
    gen = torch.Generator().manual_seed(0)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (2, 8), generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)}
    with _Ops() as rec:
        model.loss_fn(batch)
    assert len(rec.ops) == 685
    digest = hashlib.sha256("\n".join(rec.ops).encode()).hexdigest()
    assert digest == "264ef1e0827bf370006bf0f1c7a344ec67814100838241c97998e7304a97e0db"


# --------------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.card
def test_train_step_replays_as_it_runs_eagerly_with_telemetry_on(card):
    """The step captured with telemetry recording (the new spans and
    counters inside the capture) replays the eager step's numbers."""
    cfg = dataclasses.replace(_cfg("share"), compute_dtype="float32")
    opt = AdamWConfig(**OPT)
    batches = [_batch(cfg, rows=4, seq=16, seed=s) for s in range(4)]
    runs = []
    was = telemetry.get().enabled
    try:
        telemetry.set_enabled(True)
        for graphed in (False, True):
            model = build_model(cfg, impl="torch", device=card).init(0)
            state = train_state_of(model, opt)
            step = make_train_step(model, opt, microbatches=2)
            run = step if graphed else step.eager
            losses = []
            for b in batches:
                state, met = run(state, {k: v.to(card) for k, v in b.items()})
                losses.append(float(met["loss"]))
            runs.append((losses, {k: p.detach().clone() for k, p in state.params.items()}))
    finally:
        telemetry.set_enabled(was)
        telemetry.get().reset()
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-5)
    for k in runs[0][1]:
        torch.testing.assert_close(runs[1][1][k], runs[0][1][k], rtol=1e-4, atol=1e-5, msg=k)
