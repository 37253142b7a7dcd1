"""The Mamba-2 scan's kernel pair (``kernels/ssd``) and its route in
``models/mamba2.py``.

On the CPU: the kernels' plan written in PyTorch (``plain.py``) against the
composition ``mamba2.ssd`` and a per-step float64 recurrence, its backward
against autograd through the composition (float32, where nothing is
rounded); ``SSDTrain`` wired into tiny granite-4.0-h-small through a
monkeypatched route against the composition; the route itself (CPU,
float32 and fake tensors keep the composition), its counters only while
telemetry records, and the refusals of the kernels' wrapper.

On the card (``-m card``; skipped without one): the kernels' y against
the composition and the recurrence on float32 upcasts of the same bf16
inputs, at granite-4.0-h-small's shape, a ragged length, two groups and the
reduced config's shape; dx, dΔ, dA, dB and dC against autograd through the
composition in float32; two backward runs equal bit for bit, a CUDA-graph
replay equal to the eager call, the same gradients under
``torch.utils.checkpoint``; the route taking the pair in the tiny model;
and the pair's and the composition's times at the cell's shape (``-s``
prints them, with each comparison's gaps). This file imports no JAX, so the
card tests run where JAX is not installed, without the suite's conftest:
``python -m pytest -q --noconftest -m card -s tests/test_torch_ssd_kernel.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels as K
from repro_torch.configs import get_config, tiny
from repro_torch.core import telemetry
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.kernel import heads_a_block, ssd_bwd, ssd_fwd, ssd_pack
from repro_torch.kernels.ssd.plain import ssd_bwd_plain, ssd_fwd_plain
from repro_torch.kernels.ssd.train import SSDTrain
from repro_torch.models import build_model
from repro_torch.models import mamba2 as M2
from repro_torch.models.common import MAMBA2_A_RANGE, MAMBA2_DT_RANGE

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NO_LAUNCHES = {name: 0 for name in K.KERNEL_NAMES}
ARCH = "granite-4.0-h-small"


def _inputs(bsz, s, h, p, g, n, seed, device="cpu", dtype=torch.float32):
    """x, Δ, A, B, C, dy as the mixer makes them: SiLU'd x, B and C; Δ in
    the init's range; A over the init's range of −exp(A_log)."""
    rng = np.random.default_rng(seed)

    def t(*shape, dt=dtype):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(device, dt)

    x, b, c = (F.silu(t(*shape, dt=torch.float32)).to(device, dtype)
               for shape in ((bsz, s, h, p), (bsz, s, g, n), (bsz, s, g, n)))
    lo, hi = (math.log(v) for v in MAMBA2_DT_RANGE)
    dt = torch.exp(lo + (hi - lo) * torch.as_tensor(rng.random((bsz, s, h)), dtype=torch.float32))
    a = -torch.as_tensor(np.linspace(*MAMBA2_A_RANGE, h), dtype=torch.float32)
    dy = t(bsz, s, h, p, dt=torch.float32)
    return x, dt.to(device), a.to(device), b, c, dy


def _recurrence(x, dt, a, b, c):
    """S_t = exp(Δ_t A)·S_{t−1} + Δ_t x_t ⊗ B_t, y_t = S_t·C_t, step by step
    in float64."""
    bsz, s, h, p = x.shape
    g = b.shape[2]
    state = torch.zeros(bsz, h, p, b.shape[3], dtype=torch.float64, device=x.device)
    ys = []
    for t in range(s):
        bh = b[:, t].double().repeat_interleave(h // g, dim=1)
        ch = c[:, t].double().repeat_interleave(h // g, dim=1)
        decay = torch.exp(dt[:, t].double() * a.double())
        state = decay[..., None, None] * state + \
            (dt[:, t].double()[..., None] * x[:, t].double())[..., None] * bh[:, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch))
    return torch.stack(ys, 1)


def _gap(got, want):
    """||Δ|| / ||want||."""
    d = got.double() - want.double()
    return float(d.norm() / want.double().norm().clamp_min(1e-30))


@pytest.fixture
def counters():
    """Telemetry on and empty; the counters the test's calls made."""
    tel = telemetry.get()
    was = tel.enabled
    tel.reset()
    tel.set_enabled(True)
    yield lambda: tel.metrics()["counters"]
    tel.set_enabled(was)
    tel.reset()


# ------------------------------------------------------------------ CPU
SHAPES = {  # (Bt, S, H, P, G, N, L)
    "whole": (2, 32, 4, 8, 1, 8, 8),
    "ragged": (2, 27, 4, 8, 1, 8, 8),
    "groups": (1, 40, 4, 8, 2, 8, 16),
    "short": (2, 5, 2, 8, 2, 8, 8),
    "tiles": (1, 150, 2, 8, 1, 8, 128),  # two 64-row tiles a chunk, a ragged last chunk
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_plan_matches_the_composition_and_the_recurrence(shape):
    bsz, s, h, p, g, n, length = SHAPES[shape]
    x, dt, a, b, c, _ = _inputs(bsz, s, h, p, g, n, seed=len(shape) + s)
    y, cs, cb, states, _ = ssd_fwd_plain(x, dt, a, b, c, length)
    k = -(-s // length)
    assert y.shape == (bsz, s, h, p) and cs.shape == (bsz, h, k, length)
    assert states.shape == (bsz, h, k, p, n) and cb.shape[-1] == 64 * -(-length // 64)
    want = _recurrence(x, dt, a, b, c)
    scale = float(want.abs().max())
    torch.testing.assert_close(y.double(), want, rtol=0, atol=2e-5 * scale)
    torch.testing.assert_close(y, M2.ssd(x, dt, a, b, c, length), rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_backward_matches_autograd_through_the_composition(shape):
    """dx, dΔ, dA, dB and dC of the kernels' plan — the reverse carry, the
    passes by rows j and by rows i, dΔ and dA from what each row's running
    sum gains and loses and the chunks' ⟨Ĝ, E⟩ — against autograd, float32:
    1e-5 of each gradient's norm (the two sum in other orders)."""
    bsz, s, h, p, g, n, length = SHAPES[shape]
    x, dt, a, b, c, dy = _inputs(bsz, s, h, p, g, n, seed=3 * s)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    want = torch.autograd.grad(M2.ssd(*leaves, length), leaves, dy)
    fwd = ssd_fwd_plain(x, dt, a, b, c, length)
    got = ssd_bwd_plain(x, dt, a, b, c, *fwd[1:], dy, length)
    for name, g_, w in zip(("dx", "dΔ", "dA", "dB", "dC"), got, want):
        assert g_.shape == w.shape and g_.dtype == w.dtype, name
        assert _gap(g_, w) <= 1e-5, (name, _gap(g_, w))


def test_plain_plan_rounds_its_operands_like_the_kernels():
    """With bf16 inputs the plan rounds each product's operands once and
    keeps the rest in float32: nearer the float32 composition than the bf16
    composition is (which rounds C·Bᵀ, the decays and their product apart,
    and the products' outputs)."""
    x, dt, a, b, c, _ = _inputs(1, 64, 4, 16, 1, 16, seed=9)
    lo = [t.to(torch.bfloat16) for t in (x, b, c)]
    want = M2.ssd(*(t.float() for t in (lo[0],)), dt, a, *(t.float() for t in lo[1:]), 16)
    plan = ssd_fwd_plain(lo[0], dt, a, lo[1], lo[2], 16)[0]
    comp = M2.ssd(lo[0], dt, a, lo[1], lo[2], 16)
    assert plan.dtype == comp.dtype == torch.float32
    assert 0 < _gap(plan, want) < _gap(comp, want)


def test_train_function_on_the_cpu_runs_the_plain_plan():
    x, dt, a, b, c, dy = _inputs(2, 27, 4, 8, 2, 8, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    out = SSDTrain.apply(*leaves, 8)
    got = torch.autograd.grad(out, leaves, dy)
    fwd = ssd_fwd_plain(x, dt, a, b, c, 8)
    assert torch.equal(out, fwd[0])
    for g_, w in zip(got, ssd_bwd_plain(x, dt, a, b, c, *fwd[1:], dy, 8)):
        assert torch.equal(g_, w)
    assert K.LAUNCHES == NO_LAUNCHES


def _tiny(groups=1, **kw):
    cfg = tiny(get_config(ARCH))
    return dataclasses.replace(cfg, mamba2=dataclasses.replace(cfg.mamba2, n_groups=groups), **kw)


def _batch(cfg, rows=2, seq=20, seed=0):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (rows, seq + 1), generator=gen)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def _scans_a_step(cfg):
    """Scans in a training step: every mixer's forward, and again in the
    backward for each one remat checkpoints (the layers of whole periods)."""
    kinds = cfg.layer_kinds()
    return kinds.count("mamba2") + kinds[:cfg.num_periods * cfg.pattern_period].count("mamba2")


def _all_experts(cfg):
    """``cfg`` with every token routed to every expert: top-k is a discrete
    choice, and one flip moves a token's whole share of an expert's
    gradient, which no rounding tolerance bounds."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.num_experts))


def _scan_slices(cfg):
    """The parts of the mixers' leaves that the scan's five gradients feed,
    by name: in_proj's x, B, C and Δ columns, the conv's (weight and bias)
    x, B and C channels, and dt_bias, a_log and d_skip whole."""
    m = cfg.mamba2
    di, gn = m.num_heads * m.head_dim, m.n_groups * m.d_state
    cols = {"x": (di, 2 * di), "B": (2 * di, 2 * di + gn), "C": (2 * di + gn, 2 * di + 2 * gn),
            "dt": (2 * di + 2 * gn, 2 * di + 2 * gn + m.num_heads)}
    out = {f"in_proj.{k}": (("in_proj",), slice(*v)) for k, v in cols.items()}
    out.update({f"conv.{k}": (("conv_w", "conv_b"), slice(lo - di, hi - di))
                for k, (lo, hi) in cols.items() if k != "dt"})
    out.update({k: ((k,), slice(None)) for k in ("dt_bias", "a_log", "d_skip")})
    return out


def _scan_leaf_gaps(cfg, run, ref):
    """Gap of norms of ``run``'s gradient to ``ref``'s on each part of
    ``_scan_slices``, every mixer's part concatenated."""
    gaps = {}
    for part, (leaves, cols) in _scan_slices(cfg).items():
        names = [n for n in ref[1] if ".mixer." in n and n.rsplit(".", 1)[1] in leaves]
        assert names, part
        gaps[part] = _gap(*(torch.cat([r[1][n][..., cols].flatten() for n in names])
                            for r in (run, ref)))
    return gaps


# A bf16 model against the same model in float32, on the parts of the
# leaves the scan feeds: bf16's own rounding through the tiny model's 11
# layers moves each part's gradient by 1.4e-2 … 2.9e-2 of its norm through
# the composition (seeds 0–3, all experts, CPU), and a single small leaf (a
# dt_bias, an a_log, a d_skip: sums over every token) by up to 0.5, so each
# part is taken over every mixer at once. Limits: 5e-2 of each part's norm,
# and no more than twice the bf16 composition's own gap there (the kernels'
# plan read 0.75–1.42 times it on those seeds). A 10% error in dB or dC
# moves its parts ~5 times the composition's gap; the scan's dx is a small
# part of x's gradient beside the D skip here, so dropping it moves the x
# parts ~3 times (the card tests hold each gradient to 1e-2 on its own).
SCAN_LEAF_LIMITS = {"gap": 5e-2, "of_composition": 2.0}


def _assert_as_near_as_the_composition(cfg, pair, comp, f32):
    comp_gaps = _scan_leaf_gaps(cfg, comp, f32)
    gaps = {k: (v, comp_gaps[k]) for k, v in _scan_leaf_gaps(cfg, pair, f32).items()}
    print("\nscan-fed parts' gaps to float32, pair (bf16 composition): " + ", ".join(
        f"{k} {g:.3e} ({c:.3e})" for k, (g, c) in gaps.items())
        + f"; loss {pair[0]:.6f} ({comp[0]:.6f}), float32 {f32[0]:.6f}")
    assert abs(pair[0] - f32[0]) <= 1e-3 * abs(f32[0])
    for part, (got, comp_gap) in gaps.items():
        assert got <= SCAN_LEAF_LIMITS["gap"], part
        assert got <= SCAN_LEAF_LIMITS["of_composition"] * comp_gap, part


def _loss_and_grads(cfg, batch, device="cpu"):
    model = build_model(cfg, impl="torch", device=device).init(0)
    for p in model.parameters():
        p.requires_grad_(True)
    loss, _ = model.loss_fn({k: v.to(device) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().float().cpu().clone()
                                  for n, p in model.named_parameters()}


@pytest.mark.parametrize("groups", [1, 2])
def test_pair_through_a_monkeypatched_route_trains_the_tiny_model_alike(groups, monkeypatch,
                                                                        counters):
    """tiny granite-4.0-h-small (P 16, N 8, L 8, remat a layer) on the CPU
    with the route forced to ``SSDTrain``: the plan's forward and backward
    in the model give the composition's loss and gradients (float32: to
    1e-5 of each leaf's norm), through remat's recompute."""
    cfg = _tiny(groups, compute_dtype="float32")
    batch = _batch(cfg)
    want = _loss_and_grads(cfg, batch)
    assert counters()["mamba2.ssd.plain"] > 0
    calls = []
    monkeypatch.setattr(M2, "_kernel_route", lambda x: calls.append(x.shape) or True)
    got = _loss_and_grads(cfg, batch)
    assert len(calls) == _scans_a_step(cfg)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    for name, g_ in want[1].items():
        assert _gap(got[1][name], g_) <= 1e-5, name


def test_plan_in_bf16_trains_the_tiny_model_as_near_float32_as_the_composition(monkeypatch):
    """tiny granite-4.0-h-small in bf16 on the CPU, all experts, with the
    route forced to ``SSDTrain`` (the kernels' plan, rounded as the kernels
    round): against the same model in float32, the loss to 1e-3 of itself
    and each part of the leaves the scan feeds within SCAN_LEAF_LIMITS, beside the bf16
    composition (route forced off)."""
    cfg = _all_experts(_tiny(2, compute_dtype="bfloat16"))
    batch = _batch(cfg, rows=2, seq=64)
    f32 = _loss_and_grads(dataclasses.replace(cfg, compute_dtype="float32"), batch)
    monkeypatch.setattr(M2, "_kernel_route", lambda x: False)
    comp = _loss_and_grads(cfg, batch)
    monkeypatch.setattr(M2, "_kernel_route", lambda x: True)
    pair = _loss_and_grads(cfg, batch)
    _assert_as_near_as_the_composition(cfg, pair, comp, f32)
    assert K.LAUNCHES == NO_LAUNCHES


def test_route_keeps_the_composition_off_the_card(counters):
    """CPU tensors — bf16 or float32, with or without a gradient — run the
    composition; each scan is counted as ``mamba2.ssd.plain`` while
    telemetry records; nothing launches."""
    cfg = _tiny()
    model = build_model(cfg, impl="torch", device="cpu").init(0)
    with torch.no_grad():
        model.loss_fn(_batch(cfg))
    mixers = cfg.layer_kinds().count("mamba2")
    assert {k: v for k, v in counters().items() if k.startswith("mamba2.")} == \
        {"mamba2.ssd.plain": mixers}
    x = torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16)
    assert not M2._kernel_route(x) and not M2._kernel_route(x.float())
    assert K.LAUNCHES == NO_LAUNCHES


def test_route_counts_nothing_while_telemetry_is_off():
    tel = telemetry.get()
    was = tel.enabled
    try:
        tel.set_enabled(False)
        tel.reset()
        cfg = _tiny()
        with torch.no_grad():
            build_model(cfg, impl="torch", device="cpu").init(0).loss_fn(_batch(cfg))
        M2._kernel_route(torch.zeros(1, 8, 4, 16))
        assert tel.metrics()["counters"] == {}
    finally:
        tel.set_enabled(was)
        tel.reset()


def test_route_leaves_fake_tensors_to_the_composition():
    """The dry-run traces the step on fake CUDA tensors: the route keeps
    the composition there and never hands a tensor without storage to a
    kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 64, 4, 16, device="cuda", dtype=torch.bfloat16)
        assert x.is_cuda
        assert not M2._kernel_route(x)
    assert K.LAUNCHES == NO_LAUNCHES


def test_wrapper_refuses_what_the_kernels_do_not_take():
    """The checks a CUDA call meets before any launch — dtypes, widths,
    chunk, layout — raise; with no card visible the launch path raises
    rather than falling back."""
    x, dt, a, b, c, _ = _inputs(1, 16, 4, 16, 1, 8, seed=1, dtype=torch.bfloat16)
    sizes, strides = ssd_kernel._check(x, dt, a, b, c, 8)
    assert sizes == (1, 16, 4, 16, 1, 8) and strides == (64, 8, 8)
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        ssd_kernel._check(x.float(), dt, a, b, c, 8)
    with pytest.raises(TypeError, match="must be torch.float32"):
        ssd_kernel._check(x, dt.double(), a, b, c, 8)
    wide = torch.zeros(1, 16, 4, 72, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 64 and 128"):
        ssd_kernel._check(wide, dt, a, b, c, 8)
    odd = torch.zeros(1, 16, 1, 12, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ssd_kernel._check(x, dt, a, odd, odd, 8)
    with pytest.raises(ValueError, match="chunk 300"):
        ssd_kernel._check(x, dt, a, b, c, 300)
    with pytest.raises(ValueError, match="contiguous rows"):
        ssd_kernel._check(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, b, c, 8)
    # the mixer's views: a token stride over the conv's channels
    conv = torch.zeros(1, 16, 64 + 16, dtype=torch.bfloat16)
    xs, bm, cm = torch.split(conv, [64, 8, 8], dim=-1)
    _, strides = ssd_kernel._check(xs.reshape(1, 16, 4, 16), dt, a, bm.reshape(1, 16, 1, 8),
                                   cm.reshape(1, 16, 1, 8), 8)
    assert strides == (80, 80, 80)
    if not torch.cuda.is_available():
        from repro_torch.kernels import _build

        with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
            _build.library("ssd")
    assert K.LAUNCHES == NO_LAUNCHES


def _conv_views(bsz, s, h, p, g, n, device="cpu", seed=0):
    """x (Bt, S, H, P), B and C (Bt, S, G, N) as the mixer makes them: views
    of the depthwise conv's (Bt, C, S) output, SiLU'd, a token apart along S."""
    gen = torch.Generator().manual_seed(seed)
    conv_dim = h * p + 2 * g * n
    xbc = torch.randn(bsz, conv_dim, s + 3, generator=gen).to(device, torch.bfloat16)[..., :s]
    xs, bm, cm = torch.split(F.silu(xbc.transpose(1, 2)), [h * p, g * n, g * n], dim=-1)
    return xs.reshape(bsz, s, h, p), bm.reshape(bsz, s, g, n), cm.reshape(bsz, s, g, n)


def test_pack_puts_the_mixers_views_in_rows():
    """On the CPU ``ssd_pack`` is ``contiguous``; a tensor already in rows
    comes back as it is."""
    for t in _conv_views(2, 20, 4, 16, 2, 8):
        assert t.stride(1) == 1 and not t.is_contiguous()
        packed = ssd_pack(t)
        assert packed.is_contiguous() and torch.equal(packed, t)
    rows = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    assert ssd_pack(rows) is rows
    assert K.LAUNCHES == NO_LAUNCHES


def test_heads_a_block_divides_the_group():
    assert [heads_a_block(n) for n in (128, 4, 2, 6, 7, 9, 1)] == [8, 4, 2, 6, 7, 3, 1]


# ----------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    K.reset_launch_counts()
    yield torch.device("cuda")
    K.reset_launch_counts()


CARD_SHAPES = {  # (Bt, S, H, P, G, N, L)
    "cell": (1, 4096, 128, 64, 1, 128, 256),
    "ragged": (2, 1000, 8, 64, 1, 128, 256),
    "groups": (1, 777, 16, 64, 2, 64, 128),
    "reduced": (2, 20, 4, 16, 1, 8, 8),
    "reduced_g2": (2, 37, 4, 16, 2, 8, 8),
}

# The limits, each with its reason:
# * y: every product takes bf16 operands (2^-9 relative each) with float32
#   accumulation; against float32 math on the same inputs the gap is a few
#   2^-9 over √(terms): 5e-3 of y's norm;
# * dx, dΔ, dA, dB, dC: the backward's products take bf16 operands too (the
#   upstream gradient, Ĝ and the weights of the causal part among them), and
#   dx, dB and dC are bf16: 1e-2 of each gradient's norm.
LIMITS = {"y": 5e-3, "grad": 1e-2}


def _card_inputs(shape, seed, card):
    bsz, s, h, p, g, n, length = CARD_SHAPES[shape]
    x, dt, a, b, c, dy = _inputs(bsz, s, h, p, g, n, seed, card, torch.bfloat16)
    return (x, dt, a, b, c), dy, length


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_forward_matches_the_composition_and_the_recurrence(card, shape):
    """y against the composition in float32 and the per-step recurrence in
    float64, both on float32 upcasts of the same bf16 inputs, and nearer the
    former than the bf16 composition is."""
    ins, _, length = _card_inputs(shape, 11, card)
    y = ssd_fwd(*ins, length)[0]
    up = [t.float() for t in ins]
    want = M2.ssd(*up, length)
    gaps = (_gap(y, want), _gap(M2.ssd(*ins, length), want), _gap(y, _recurrence(*up)))
    print(f"\n{shape}: y {gaps[0]:.3e} of the float32 composition (bf16 composition "
          f"{gaps[1]:.3e}), {gaps[2]:.3e} of the recurrence")
    assert gaps[0] <= LIMITS["y"] and gaps[2] <= LIMITS["y"] and gaps[0] <= gaps[1]
    assert K.LAUNCHES["ssd_fwd"] == 1


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_gradients_match_autograd_through_the_composition(card, shape):
    """dx, dΔ, dA, dB and dC against autograd through the composition in
    float32 on the same inputs, each within LIMITS and, but for dA, nearer
    than the bf16 composition's own gradients."""
    ins, dy, length = _card_inputs(shape, 12, card)
    fwd = ssd_fwd(*ins, length)
    got = ssd_bwd(*ins, *fwd[1:], dy, length)
    leaves = [t.float().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(M2.ssd(*leaves, length), leaves, dy)
    comp_leaves = [t.clone().requires_grad_(t.is_floating_point()) for t in ins]
    comp = torch.autograd.grad(M2.ssd(*comp_leaves, length), comp_leaves, dy)
    gaps = {n: (_gap(g_, w), _gap(c_, w)) for n, g_, w, c_ in
            zip(("dx", "dΔ", "dA", "dB", "dC"), got, want, comp)}
    print(f"\n{shape}: " + ", ".join(f"{n} {k:.3e} (bf16 composition {c:.3e})"
                                      for n, (k, c) in gaps.items()))
    for n, (k, comp_gap) in gaps.items():
        assert k <= LIMITS["grad"], n
        # not less precise than the composition, but for dA: one sum a head
        # of dΔ-weighted running sums over every token, whose cancellation
        # leaves either side's gap at the other's order (0.5–4.3×, PERF.md §6)
        assert n == "dA" or k <= comp_gap, n
    assert got[0].dtype == got[3].dtype == torch.bfloat16 and got[2].shape == ins[2].shape
    assert K.LAUNCHES["ssd_bwd"] == 1


@pytest.mark.card
@pytest.mark.parametrize("shape", ["cell", "groups", "reduced_g2"])
def test_backward_is_deterministic_and_replays_from_a_graph(card, shape):
    ins, dy, length = _card_inputs(shape, 13, card)

    def run():
        y, cs, cb, *states = ssd_fwd(*ins, length)
        # cb's tiles above the diagonal are never written, nor read
        return (y, cs, *states, *ssd_bwd(*ins, cs, cb, *states, dy, length))

    first, second = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for t in captured:
        t.fill_(0) if not t.is_floating_point() or t.dtype == torch.bfloat16 \
            else t.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, captured))


@pytest.mark.card
def test_checkpointed_pair_gives_the_same_gradients(card):
    """Under ``torch.utils.checkpoint`` (remat) the forward runs twice and
    the backward once: the same gradients, bit for bit."""
    ins, dy, length = _card_inputs("ragged", 14, card)

    def grads(remat):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        fn = lambda *a: SSDTrain.apply(*a, length) * 1.0  # noqa: E731
        out = checkpoint(fn, *leaves, use_reentrant=False) if remat else fn(*leaves)
        return torch.autograd.grad(out, leaves, dy)

    plain, remat = grads(False), grads(True)
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))
    assert K.LAUNCHES["ssd_fwd"] == 3 and K.LAUNCHES["ssd_bwd"] == 2


@pytest.mark.card
def test_route_takes_the_pair_on_the_card(card, counters, monkeypatch):
    """tiny granite-4.0-h-small in bf16 on the card, all experts: every scan
    of a no-grad forward and of a training step runs the pair (remat: a
    checkpointed layer's forward runs twice), counted as
    ``mamba2.ssd.kernel``. Against the same model in float32 (the
    composition), the loss to 1e-3 of itself and each part of the leaves
    the scan feeds within SCAN_LEAF_LIMITS, beside the bf16 composition (route
    monkeypatched off). A float32 model keeps the composition."""
    cfg = _all_experts(_tiny(2, compute_dtype="bfloat16"))
    mixers = cfg.layer_kinds().count("mamba2")
    model = build_model(cfg, impl="torch", device=card).init(0)
    with torch.no_grad():
        model.loss_fn({k: v.to(card) for k, v in _batch(cfg).items()})
    assert counters().get("mamba2.ssd.kernel") == mixers and "mamba2.ssd.plain" not in counters()
    assert K.LAUNCHES["ssd_fwd"] == mixers and K.LAUNCHES["ssd_pack"] == 3 * mixers
    K.reset_launch_counts()
    batch = _batch(cfg, rows=2, seq=64)
    pair = _loss_and_grads(cfg, batch, card)
    assert K.LAUNCHES["ssd_fwd"] == _scans_a_step(cfg) and K.LAUNCHES["ssd_bwd"] == mixers
    K.reset_launch_counts()
    f32 = _loss_and_grads(dataclasses.replace(cfg, compute_dtype="float32"), batch, card)
    assert K.LAUNCHES["ssd_fwd"] == K.LAUNCHES["ssd_bwd"] == 0
    monkeypatch.setattr(M2, "_kernel_route", lambda x: False)
    comp = _loss_and_grads(cfg, batch, card)
    _assert_as_near_as_the_composition(cfg, pair, comp, f32)


@pytest.mark.card
def test_route_keeps_a_float32_model_on_the_composition_on_the_card(card, counters):
    """float32 CUDA tensors are no call for the bf16 kernels: a float32
    model on the card runs the composition by design, with or without a
    gradient, each scan counted as ``mamba2.ssd.plain``, nothing
    launched."""
    cfg = _tiny(2, compute_dtype="float32")
    mixers = cfg.layer_kinds().count("mamba2")
    model = build_model(cfg, impl="torch", device=card).init(0)
    with torch.no_grad():
        model.loss_fn({k: v.to(card) for k, v in _batch(cfg).items()})
    assert counters().get("mamba2.ssd.plain") == mixers and "mamba2.ssd.kernel" not in counters()
    _loss_and_grads(cfg, _batch(cfg, rows=2, seq=64), card)
    assert counters().get("mamba2.ssd.plain") == mixers + _scans_a_step(cfg)
    assert "mamba2.ssd.kernel" not in counters()
    assert K.LAUNCHES == NO_LAUNCHES


@pytest.mark.card
@pytest.mark.parametrize("s", [4096, 1001])  # 16-byte pieces, and single elements
def test_pack_copies_the_mixers_views_bit_for_bit(card, s):
    views = _conv_views(1, s, 128, 64, 1, 128, device=card, seed=s)
    for t in views:
        packed = ssd_pack(t)
        assert packed.is_contiguous() and torch.equal(packed, t)
    assert K.LAUNCHES["ssd_pack"] == 3


@pytest.mark.card
def test_pair_refuses_an_unsupported_call_on_the_card(card):
    x, dt, a, b, c, _ = _inputs(1, 32, 2, 72, 1, 8, seed=2, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 64"):
        SSDTrain.apply(x, dt, a, b, c, 8)
    assert K.LAUNCHES == NO_LAUNCHES


def _ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.card
def test_times_at_the_cells_shape(card):
    """Prints the pair's and the bf16 composition's times at
    granite-4.0-h-small's shape (one layer, a 1 × 4,096 microbatch), beside
    the forward's least time (the bytes of x, Δ, B, C and y at 3.35 TB/s);
    the forward must beat the composition's."""
    ins, dy, length = _card_inputs("cell", 15, card)
    fwd = ssd_fwd(*ins, length)
    t_fwd = _ms(lambda: ssd_fwd(*ins, length))
    view = _conv_views(1, 4096, 128, 64, 1, 128, device=card)[0]
    t_pack = _ms(lambda: ssd_pack(view))
    t_copy = _ms(lambda: view.contiguous())
    t_bwd = _ms(lambda: ssd_bwd(*ins, *fwd[1:], dy, length))
    leaves = [t.clone().requires_grad_(t.is_floating_point()) for t in ins]
    t_comp = _ms(lambda: M2.ssd(*ins, length), reps=3)
    t_comp_fb = _ms(lambda: torch.autograd.grad(M2.ssd(*leaves, length), leaves, dy), reps=3)
    bsz, s, h, p, g, n, _ = CARD_SHAPES["cell"]
    least = bsz * s * (2 * h * p + 4 * h + 2 * 2 * g * n + 4 * h * p) / 3.35e12 * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ssd_bwd(*ins, *ssd_fwd(*ins, length)[1:], dy, length)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "ssd_" in ev.key:
            print(f"  {ev.key[:90]}: {ev.device_time_total / ev.count:.1f} us a call")
    print(f"\n{torch.cuda.get_device_name(0)}: pair forward {t_fwd:.3f} ms, backward "
          f"{t_bwd:.3f} ms (least forward {least * 1e3:.1f} us: {100 * least / t_fwd:.2f}%); "
          f"composition forward {t_comp:.3f} ms, forward + backward {t_comp_fb:.3f} ms; x "
          f"into rows {t_pack * 1e3:.1f} us (torch's contiguous {t_copy * 1e3:.1f} us)")
    assert t_fwd < t_comp
