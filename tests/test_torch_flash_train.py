"""Training's flash-attention pair (``kernels/flash_attention/train.py``)
and its route in ``models/attention.py::_attend``.

On the CPU: the plain backward's explicit formulas against autograd through
the plain forward (float32, 1e-5), ``FlashAttentionTrain`` on CPU tensors
against the gradients of the composition it replaces, and the route — a CPU
call, a no-grad call and a float32 call all keep the composition, which the
counters ``attn.train.kernel``/``attn.train.plain`` and the launch counts
show.

On the card (``-m card``; skipped without one): the kernels' O, LSE, dQ,
dK and dV against the plain version at the training cells' shapes and at
ragged, windowed and soft-capped ones, Dh 192 and 256 among them; two runs equal bit for bit, and a
CUDA-graph replay equal to the eager run; the route taking the pair for a
grad-recording bf16 call; a small granite-moe training step through the
pair against the composition. This file imports no JAX, so the card tests
run where JAX is not installed, without the suite's conftest (``-s``
prints each comparison's worst error):
``python -m pytest -q --noconftest -m card tests/test_torch_flash_train.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import telemetry
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd_lse
from repro_torch.kernels.flash_attention.plain import (
    flash_attention_bwd_plain, flash_attention_plain,
)
from repro_torch.kernels.flash_attention.train import FlashAttentionTrain
from repro_torch.models import attention
from repro_torch.models.common import NO_MESH

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NO_LAUNCHES = {name: 0 for name in K.KERNEL_NAMES}


def _qkvd(b, s, hq, hkv, dh, seed, device="cpu", dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                 device=device).to(dtype)
                 for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh), (b, s, hq, dh)))


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


def _cfg(scale=None, softcap=0.0):
    return types.SimpleNamespace(attn_scale=scale, attn_softcap=softcap)


def _attend(q, k, v, cfg, window, q_chunk=1024):
    b, s = q.shape[:2]
    pos = torch.arange(s, device=q.device)[None].expand(b, s)
    return attention._attend(q, k, v, pos, cfg, window, "torch", q_chunk, NO_MESH)


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("scale", [None, 1 / 128], ids=["dh^-1/2", "1/128"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dh", [64, 128])
def test_bwd_plain_matches_autograd(dh, g, window, softcap, scale):
    """The explicit formulas — P from the LSE, D = rowsum(dO ∘ O), dS =
    P ∘ (dP − D) · (1 − tanh²) — are autograd's gradient of the plain
    forward, in float32 to 1e-5."""
    q, k, v, do = _qkvd(2, 70, 2 * g, 2, dh, seed=dh + 7 * g + window)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out, lse = flash_attention_plain(q, k, v, window, softcap, scale, lse=True)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(),
                                    lse.detach(), do, window, softcap, scale)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # the LSE is that of the scaled, soft-capped, masked scores
    s = q.shape[1]
    x = torch.einsum("bqhd,bkhd->bhqk", q.detach(), k.detach().repeat_interleave(g, dim=2))
    x = x * (dh**-0.5 if scale is None else scale)
    if softcap:
        x = softcap * torch.tanh(x / softcap)
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    if window:
        mask &= ~torch.ones(s, s, dtype=torch.bool).tril(-window)
    x = x.masked_fill(~mask, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(x, -1), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("b,s,hq,hkv,dh,window,softcap,scale,q_chunk", [
    (2, 96, 4, 2, 64, 0, 0.0, None, 1024),
    (1, 130, 8, 2, 128, 0, 0.0, 1 / 128, 48),
    (2, 80, 4, 4, 64, 24, 30.0, None, 32),
    (1, 64, 8, 1, 32, 0, 20.0, 0.2, 16),
])
def test_train_function_matches_the_composition(b, s, hq, hkv, dh, window, softcap, scale,
                                                q_chunk):
    """FlashAttentionTrain on CPU tensors (the plain pair) gives the output
    and the q, k, v gradients of the composition ``_attend`` runs there."""
    q, k, v, do = _qkvd(b, s, hq, hkv, dh, seed=s + dh)
    cfg = _cfg(scale, softcap)
    leaves = [tuple(t.clone().requires_grad_(True) for t in (q, k, v)) for _ in range(2)]
    want_out = _attend(*leaves[0], cfg, window, q_chunk)
    want = torch.autograd.grad(want_out, leaves[0], do)
    got_out = FlashAttentionTrain.apply(*leaves[1], window, softcap,
                                        scale if scale else dh**-0.5)
    got = torch.autograd.grad(got_out, leaves[1], do)
    torch.testing.assert_close(got_out, want_out, rtol=1e-5, atol=1e-5)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
    assert K.LAUNCHES == NO_LAUNCHES


def test_route_keeps_the_composition_off_the_card(counters):
    """A CPU call (bf16 or float32) that records a gradient is counted as
    left to the composition; a no-grad call, or one whose q needs no
    gradient, is not counted. Every one gives the composition's output and
    launches nothing."""
    q, k, v, _ = _qkvd(2, 40, 4, 2, 64, seed=3)
    cfg = _cfg()
    with torch.no_grad():
        plain = {dt: _attend(q.to(dt), k.to(dt), v.to(dt), cfg, 0)
                 for dt in (torch.float32, torch.bfloat16)}
    assert counters() == {}
    for n, dt in enumerate((torch.bfloat16, torch.float32), start=1):
        qg = q.to(dt).clone().requires_grad_(True)
        out = _attend(qg, k.to(dt), v.to(dt), cfg, 0)
        assert out.requires_grad and torch.equal(out, plain[dt])
        assert counters() == {"attn.train.plain": n}
    out = _attend(q, k.clone().requires_grad_(True), v, cfg, 0)  # q needs no gradient
    assert torch.equal(out, plain[torch.float32])
    assert counters() == {"attn.train.plain": 2}
    assert K.LAUNCHES == NO_LAUNCHES


def test_pair_counts_nothing_while_telemetry_is_off():
    q, k, v, _ = _qkvd(1, 32, 2, 1, 64, seed=4)
    tel = telemetry.get()
    tel.reset()
    _attend(q.requires_grad_(True), k, v, _cfg(), 0)
    assert tel.metrics()["counters"] == {}


def test_pair_refuses_what_the_backward_does_not_take(monkeypatch):
    """On a CUDA tensor the pair is bf16 only, and the backward takes the
    head dims the forward takes (multiples of 8 up to 256) and raises on
    any other; with no card visible the launch path raises rather than
    falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the launch path runs instead")
    from repro_torch.kernels.flash_attention import kernel as mod

    q, k, v, do = _qkvd(1, 40, 2, 1, 264, seed=5, dtype=torch.bfloat16)
    o = torch.zeros_like(q)
    lse = torch.zeros((1, 2, 40))
    monkeypatch.setattr(mod, "check_inputs", lambda *args: "cuda")
    with pytest.raises(ValueError, match="at most 256"):
        flash_attention_bwd(q, k, v, o, lse, do, 0, 0.0, 0.0625)
    with pytest.raises(ValueError, match="a multiple of 8"):
        flash_attention_bwd(*(t[..., :100].contiguous() for t in (q, k, v, o)), lse,
                            do[..., :100].contiguous(), 0, 0.0, 0.1)
    q, k, v, do = (t[..., :256].contiguous() for t in (q, k, v, do))
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        flash_attention_bwd(q, k, v, o[..., :256].contiguous(), lse, do, 0, 0.0, 0.0625)
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        flash_attention_fwd_lse(q, k, v, 0, 0.0, 0.0625)
    assert K.LAUNCHES == NO_LAUNCHES
    assert not attention._train_route(q)  # a CPU tensor never takes the pair


def test_route_leaves_fake_tensors_to_the_composition():
    """The dry-run traces the step on fake CUDA tensors: the route keeps
    the composition there, whose operations the trace counts, and never
    hands a tensor without storage to a kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(2, 64, 4, 64, device="cuda", dtype=torch.bfloat16,
                        requires_grad=True)
        assert q.is_cuda
        assert not attention._train_route(q)
    assert K.LAUNCHES == NO_LAUNCHES


# ----------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    K.reset_launch_counts()
    yield torch.device("cuda")
    K.reset_launch_counts()


def _elem_share(got, want, rel=2.0**-7, floor=2.0**-9):
    """Worst |Δ| over its bound rel·|want| + floor (≤ 1 passes)."""
    return float(((got.float() - want.float()).abs() / (rel * want.float().abs() + floor)).max())


def _norm_gap(got, want):
    """||Δ|| / ||want|| and max |Δ| / max |want|."""
    d = got.float() - want.float()
    return (float(d.norm() / want.float().norm()),
            float(d.abs().max() / want.float().abs().max()))


def _compare(b, s, hq, hkv, dh, window, softcap, scale, seed, device):
    """The pair's O, LSE, dQ, dK, dV (bf16 inputs) against the plain
    version in f32 on the same inputs."""
    q, k, v, do = _qkvd(b, s, hq, hkv, dh, seed, device, torch.bfloat16)
    scale = dh**-0.5 if scale is None else scale
    o, lse = flash_attention_fwd_lse(q, k, v, window, softcap, scale)
    grads = flash_attention_bwd(q, k, v, o, lse, do, window, softcap, scale)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    want_o, want_lse = flash_attention_plain(*f[:3], window, softcap, scale, lse=True)
    # the backward's plain version from the kernel's own O (D reads it)
    want = flash_attention_bwd_plain(*f[:3], o.float(), want_lse, f[3], window, softcap, scale)
    return o, lse, grads, want_o, want_lse, want


# The limits, each with its reason:
# * O: the bf16 forward's per-element bound (|Δ| ≤ 2^-7·|ref| + 2^-9): one
#   bf16 rounding of the output, P split in two bf16 parts;
# * LSE: f32 sums in another order and the SFU's ex2.approx (2 ulp a term):
#   5e-5 absolute on values of a few units;
# * dQ, dK, dV: P and dS enter their MMAs as bf16 (2^-9 relative each, as
#   the composition's probabilities do) and the outputs are bf16: 1e-2 of
#   the reference's norm, and 2e-2 of its largest element for the worst one.
LIMITS = {"lse": 5e-5, "grad_norm": 1e-2, "grad_max": 2e-2}


def _assert_within(o, lse, grads, want_o, want_lse, want, label):
    e_o = _elem_share(o, want_o)
    e_lse = float((lse - want_lse).abs().max())
    gaps = [_norm_gap(a, b) for a, b in zip(grads, want)]
    print(f"\n{label}: O {e_o:.3f} of its bound; LSE max |Δ| {e_lse:.3e}; "
          + ", ".join(f"{n} {g[0]:.3e} / {g[1]:.3e}" for n, g in zip(("dQ", "dK", "dV"), gaps)))
    assert e_o <= 1.0
    assert e_lse <= LIMITS["lse"]
    for g in gaps:
        assert g[0] <= LIMITS["grad_norm"] and g[1] <= LIMITS["grad_max"]


@pytest.mark.card
@pytest.mark.parametrize("b,s,hq,hkv,dh,scale", [
    (8, 1024, 16, 8, 64, None),
    (16, 1024, 16, 8, 64, None),
    (1, 4096, 32, 8, 128, 1 / 128),
], ids=["train16k", "train32k", "hybrid4k"])
def test_pair_matches_plain_at_the_cells_shapes(card, b, s, hq, hkv, dh, scale):
    _assert_within(*_compare(b, s, hq, hkv, dh, 0, 0.0, scale, 11, card),
                   f"{b}x{s} {hq}/{hkv}x{dh}")


@pytest.mark.card
@pytest.mark.parametrize("b,s,hq,hkv,dh,window,softcap,scale", [
    (2, 200, 4, 2, 64, 0, 0.0, None),
    (1, 130, 4, 4, 96, 64, 20.0, None),
    (2, 384, 6, 2, 80, 100, 0.0, None),
    (1, 256, 8, 1, 128, 0, 0.0, 1 / 128),
    (2, 256, 4, 2, 64, 0, 30.0, None),
    (1, 300, 4, 2, 32, 40, 0.0, 0.3),
    (1, 1024, 16, 1, 256, 512, 0.0, None),
    (2, 200, 4, 2, 192, 0, 30.0, None),
])
def test_pair_matches_plain_at_ragged_windowed_and_capped_shapes(
        card, b, s, hq, hkv, dh, window, softcap, scale):
    _assert_within(*_compare(b, s, hq, hkv, dh, window, softcap, scale, 12, card),
                   f"{b}x{s} {hq}/{hkv}x{dh} w{window} cap{softcap}")


@pytest.mark.card
@pytest.mark.parametrize("b,s,hq,hkv,dh,scale", [
    (8, 1024, 16, 8, 64, None), (1, 4096, 32, 8, 128, 1 / 128), (1, 1024, 16, 1, 256, None)],
    ids=["train16k", "hybrid4k", "dh256"])
def test_pair_is_deterministic_and_replays_from_a_graph(card, b, s, hq, hkv, dh, scale):
    """No atomics: two runs give the same bits; a CUDA graph captured
    around forward and backward replays them bit for bit."""
    q, k, v, do = _qkvd(b, s, hq, hkv, dh, 13, card, torch.bfloat16)
    scale = dh**-0.5 if scale is None else scale

    def run():
        o, lse = flash_attention_fwd_lse(q, k, v, 0, 0.0, scale)
        return (o, lse, *flash_attention_bwd(q, k, v, o, lse, do, 0, 0.0, scale))

    first, second = run(), run()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()  # warm the side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for t in captured:
        t.fill_(0) if t.dtype != torch.float32 else t.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, captured))


@pytest.mark.card
@pytest.mark.parametrize("dh", [64, 256])
def test_route_takes_the_pair_on_the_card(card, counters, dh):
    """A grad-recording bf16 call on the card runs the pair — its four
    kernels launch, ``attn.train.kernel`` counts it — and gives the
    gradients of the kernels called directly, at granite's head dim and at
    recurrentgemma-9b's 256; a float32 call and a no-grad call keep the
    composition; a call under graph capture counts nothing."""
    q, k, v, do = _qkvd(2, 256, 4, 2, dh, 14, card, torch.bfloat16)
    cfg = _cfg(0.1)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = _attend(qg, kg, vg, cfg, 0)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    assert counters() == {"attn.train.kernel": 1}
    assert {n: c for n, c in K.LAUNCHES.items() if c} == {
        "flash_attention": 1, "flash_attention_bwd_dot": 1, "flash_attention_bwd_dkdv": 1,
        "flash_attention_bwd_dq": 1}
    o, lse = flash_attention_fwd_lse(q, k, v, 0, 0.0, 0.1)
    assert torch.equal(out, o)
    assert all(torch.equal(a, b) for a, b in
               zip(grads, flash_attention_bwd(q, k, v, o, lse, do, 0, 0.0, 0.1)))
    K.reset_launch_counts()
    _attend(*(t.float().requires_grad_(True) for t in (q, k, v)), cfg, 0)
    with torch.no_grad():
        _attend(q, k, v, cfg, 0)
    assert counters() == {"attn.train.kernel": 1, "attn.train.plain": 1}
    assert K.LAUNCHES == NO_LAUNCHES
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _attend(qg, kg, vg, cfg, 0)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        _attend(qg, kg, vg, cfg, 0)
    assert counters() == {"attn.train.kernel": 2, "attn.train.plain": 1}


@pytest.mark.card
def test_granite_moe_step_through_the_pair_against_the_composition(card, counters, monkeypatch):
    """Two layers of granite-moe-1b-a400m at its widths (16/8 heads of 64),
    bf16 compute, remat, every token routed to all 32 experts (top-k a
    discrete choice: one flip moves a token's whole share of an expert's
    gradient, which no rounding tolerance bounds): the loss and every
    parameter's gradient through the pair against the composition's. The
    composition rounds its scores to bf16 before the softmax and the pair
    does not; both give P·V bf16 probabilities. Limits: the loss to 1e-3 of
    itself, each leaf's gradient to 2e-2 of its norm."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model

    cfg = get_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, num_layers=2,
                              moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.num_experts))
    batch = SyntheticLMDataset(cfg.vocab_size, seq_len=512, global_batch=4, seed=0).batch(0)
    results = {}
    for mode in ("pair", "composition"):
        if mode == "composition":
            monkeypatch.setattr(attention, "_train_route", lambda q: False)
        model = build_model(cfg, impl="torch").init(0)
        for p in model.parameters():
            p.requires_grad_(True)
        K.reset_launch_counts()
        loss, _ = model.loss_fn(batch)
        loss.backward()
        torch.cuda.synchronize()
        results[mode] = (float(loss.detach()), {n: p.grad.float().clone()
                                                for n, p in model.named_parameters()},
                         dict(K.LAUNCHES))
        del model
    (l_pair, g_pair, n_pair), (l_comp, g_comp, n_comp) = results["pair"], results["composition"]
    # remat runs each layer's forward twice; each backward once
    assert n_pair["flash_attention"] == 4 and n_pair["flash_attention_bwd_dkdv"] == 2
    assert n_comp == NO_LAUNCHES
    assert {n: c for n, c in counters().items() if n.startswith("attn.")} == {
        "attn.train.kernel": 4}
    gaps = sorted(((float((g_pair[n] - g_comp[n]).norm() / g_comp[n].norm().clamp_min(1e-30)), n)
                   for n in g_comp), reverse=True)
    print(f"\nloss {l_pair:.6f} (pair) vs {l_comp:.6f}; worst leaves' gradient gaps "
          + ", ".join(f"{n} {g:.3e}" for g, n in gaps[:4]))
    assert abs(l_pair - l_comp) <= 1e-3 * abs(l_comp)
    assert gaps[0][0] <= 2e-2
