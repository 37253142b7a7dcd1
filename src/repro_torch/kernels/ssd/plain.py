"""The SSD kernels' plan (``csrc/ssd.cu``) written directly in PyTorch: the
same decomposition — chunk sums, C·Bᵀ once a group, the carry across
chunks, the causal part; backward, the reverse carry of the state's
gradient, the two passes by rows j and by rows i, and dΔ, dA from the
running sums — in float32, with each product's operands rounded to the
inputs' dtype where the kernels round them (so in float32 nothing is
rounded). The CPU tests hold these against autograd through the
composition ``models/mamba2.py::ssd``; the card tests hold the kernels
against them and against the composition.

Shapes: x (Bt, S, H, P), dt = Δ (Bt, S, H), a = A (H,), b and c (Bt, S, G,
N); chunk L. What the forward returns beside y, as the kernels keep it:
the running sums cs (Bt, H, K, L), C·Bᵀ (Bt, G, K, Lp, Lp) with Lp = L
rounded up to 64 (the rows and columns past L zero) and the state
entering each chunk (Bt, H, K, P, N), all float32, and the entering states
again in the inputs' dtype, the products' operand.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_fwd_plain", "ssd_bwd_plain", "chunks", "cb_width"]

TILE = 64  # the kernels' row tile: C·Bᵀ is kept in whole tiles


def chunks(s: int, chunk: int) -> int:
    return -(-s // chunk)


def cb_width(chunk: int) -> int:
    """Lp: the chunk length rounded up to whole row tiles."""
    return TILE * -(-chunk // TILE)


def _by_chunk(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(Bt, S, X, Y?) float32, padded with zeros to whole chunks, as (Bt,
    X, K, L, Y?)."""
    k = chunks(t.shape[1], chunk)
    t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, k * chunk - t.shape[1]))
    t = t.reshape(t.shape[0], k, chunk, *t.shape[2:])
    return t.permute(0, 3, 1, 2, 4) if t.dim() == 5 else t.permute(0, 3, 1, 2)


def _from_chunks(t: torch.Tensor, s: int) -> torch.Tensor:
    """(Bt, X, K, L, Y) → (Bt, S, X, Y)."""
    bsz, x, k, length, y = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(bsz, k * length, x, y)[:, :s]


def _decay(cs: torch.Tensor) -> torch.Tensor:
    """exp(cs_i − cs_j) for j ≤ i, 0 elsewhere (masked before the
    exponential): (..., L) → (..., L, L)."""
    length = cs.shape[-1]
    keep = torch.ones(length, length, dtype=torch.bool, device=cs.device).tril()
    return torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(~keep, float("-inf")))


def _inputs(x, dt, a, b, c, chunk):
    h, g = x.shape[2], b.shape[2]
    xk, dtk, bk, ck = (_by_chunk(t, chunk) for t in (x, dt, b, c))
    cs = torch.cumsum(dtk * a.float()[:, None, None], dim=-1)  # (Bt, H, K, L)
    bh, ch = (t.repeat_interleave(h // g, dim=1) for t in (bk, ck))
    return xk, dtk, bk, ck, bh, ch, cs


def ssd_fwd_plain(x, dt, a, b, c, chunk: int):
    """(y (Bt, S, H, P), cs, cb, states, states16): float32 but the last."""
    h, g, s = x.shape[2], b.shape[2], x.shape[1]
    op = lambda t: t.to(x.dtype).float()  # noqa: E731 - a product's operand
    xk, dtk, bk, ck, bh, ch, cs = _inputs(x, dt, a, b, c, chunk)
    cb = ck @ bk.transpose(-1, -2)  # (Bt, G, K, L, L)
    to_end = torch.exp(cs[..., -1:] - cs)
    own = op(xk * (dtk * to_end)[..., None]).transpose(-1, -2) @ bh  # (Bt, H, K, P, N)
    entering = [torch.zeros_like(own[:, :, 0])]
    for k in range(own.shape[2] - 1):
        entering.append(torch.exp(cs[:, :, k, -1])[..., None, None] * entering[-1] + own[:, :, k])
    states = torch.stack(entering, dim=2)
    y = (ch @ op(states).transpose(-1, -2)) * torch.exp(cs)[..., None]
    cbh = cb.repeat_interleave(h // g, dim=1)
    y = y + op(cbh * _decay(cs) * dtk[..., None, :]) @ xk
    lp = cb_width(chunk)
    return (_from_chunks(y, s), cs, F.pad(cb, (0, lp - chunk, 0, lp - chunk)), states,
            states.to(x.dtype))


def ssd_bwd_plain(x, dt, a, b, c, cs, cb, states, states16, dy, chunk: int):
    """(dx, dΔ, dA, dB, dC) of ``ssd_fwd_plain`` at upstream gradient dy
    (Bt, S, H, P), from its inputs and the running sums, C·Bᵀ and entering
    states it returned; dx, dB and dC in their inputs' dtype, dΔ and dA
    float32."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    op = lambda t: t.to(x.dtype).float()  # noqa: E731
    xk, dtk, bk, ck, bh, ch, _ = _inputs(x, dt, a, b, c, chunk)
    dyk = _by_chunk(dy, chunk)
    cbh = cb[..., :chunk, :chunk].repeat_interleave(h // g, dim=1)
    decay, to_end, ecs = _decay(cs), torch.exp(cs[..., -1:] - cs), torch.exp(cs)

    # the reverse carry: Ĝ_k, the gradient of the state leaving chunk k
    own = op(dyk * ecs[..., None]).transpose(-1, -2) @ ch  # (Bt, H, K, P, N)
    leaving = [torch.zeros_like(own[:, :, 0])]
    for k in range(own.shape[2] - 1, 0, -1):
        leaving.insert(0, torch.exp(cs[:, :, k, -1])[..., None, None] * leaving[0] + own[:, :, k])
    ghat = torch.stack(leaving, dim=2)
    dots = (ghat[:, :, :-1] * states[:, :, 1:]).sum((-1, -2))  # ⟨Ĝ_k, E_{k+1}⟩
    gb = op(ghat)

    # by rows j: dxd, r = x·dxd, dB
    dxd_state = to_end[..., None] * (bh @ gb.transpose(-1, -2))
    dxd = op(cbh * decay).transpose(-1, -2) @ op(dyk) + dxd_state
    r = (xk * dxd).sum(-1)
    w = op((xk @ op(dyk).transpose(-1, -2)) * dtk[..., :, None] * decay.transpose(-1, -2))
    db = w @ ch + op(xk * (dtk * to_end)[..., None]) @ gb
    # by rows i: dC
    w = op((op(dyk) @ xk.transpose(-1, -2)) * dtk[..., None, :] * decay)
    dc = w @ bh + op(dyk * ecs[..., None]) @ states16.float()

    # dΔ and dA through the running sums: row i gains Σ_{j<i} W_ij and
    # dy_i·y_off_i, row j loses Σ_{i>j} W_ij and Δ_j·x_j·dxd_state_j, with
    # W_ij = Δ_j(dy_i·x_j)·CB_ij·e^{cs_i − cs_j} (the diagonal cancels)
    length = cs.shape[-1]
    strict = torch.ones(length, length, dtype=torch.bool, device=cs.device).tril(-1)
    weight = ((op(dyk) @ xk.transpose(-1, -2)) * dtk[..., None, :] * decay * cbh) * strict
    y_off = (ch @ states16.float().transpose(-1, -2)) * ecs[..., None]
    gain = weight.sum(-1) + (op(dyk) * y_off).sum(-1)
    lose = weight.sum(-2) + dtk * (xk * dxd_state).sum(-1)
    dcs = gain - lose
    dcs[:, :, :-1, -1] += dots
    dacc = dcs.flip(-1).cumsum(-1).flip(-1)
    ddt = r + a.float()[:, None, None] * dacc
    da = (dtk * dacc).sum((0, 2, 3))

    def per_group(t):  # (Bt, H, K, L, N) summed over each group's heads → (Bt, S, G, N)
        k = t.shape[2]
        return _from_chunks(t.view(bsz, g, h // g, k, chunk, n).sum(2), s).to(b.dtype)

    dx = _from_chunks(dxd * dtk[..., None], s).to(x.dtype)
    ddt = _from_chunks(ddt[..., None], s)[..., 0]
    return dx, ddt, da, per_group(db), per_group(dc)
