"""Mamba-2 (SSD) mixer of the port — granite-4.0-h-small's token mixer.

Forward, as the Mamba-2 paper (Dao & Gu, 2024) and the HF
``granitemoehybrid`` mixer define it, with H heads of P channels
(d_inner = H·P), a state of N per head and G groups:

    [z, xBC, dt] = x · W_in                    widths H·P, H·P + 2·G·N, H (no bias)
    xBC → causal depthwise conv (width d_conv, with bias) → SiLU → [x (H×P), B (G×N), C (G×N)]
    Δ = softplus(dt + dt_bias),  A_h = −exp(A_log_h)
    S_t = exp(Δ_t·A_h)·S_{t−1} + Δ_t·x_t ⊗ B_t,  y_t = S_t·C_t + D_h·x_t   (head h reads group h·G // H)
    g = RMSNorm(y ⊙ SiLU(z)) over the H·P channels, gain (1 + γ)
    out = g · W_out

``ssd`` runs the recurrence as SSD's chunked form, differentiable under
autograd. Within a chunk of ``chunk_size`` steps it is the dual quadratic
form: y_i = Σ_{j≤i} exp(cs_i − cs_j)·(C_i·B_j)·Δ_j x_j, cs the running sum
of Δ·A inside the chunk; each chunk's own end state is Σ_j exp(cs_last −
cs_j)·Δ_j x_j ⊗ B_j; the states are carried across chunks
(``carry_states``: the state entering chunk k is Σ_{j<k} exp(decay of
chunks j+1 … k−1)·that of chunk j) and read out as exp(cs_i)·C_i·S_in. A
sequence is padded with Δ = 0 steps to whole chunks (they decay nothing and
add nothing) and cut back.

Precision: the projections, the conv and SiLU run in the compute dtype
(bf16), as the port's other mixers do. In the scan the running sums of Δ·A,
their differences and every exponential of them are float32, and so is the
carry across chunks (a float32 product of the chunks' decays and states).
The four products of the chunked form take operands in the compute dtype
(accumulating in float32 on the tensor cores): C·Bᵀ, (C·Bᵀ ⊙ decay)·(Δx),
the chunk states (decay·Δx)ᵀ·B and the read-out C·S_inᵀ. The chunk states
and the outputs are turned to float32 at once; y, the D skip and the gated
norm are float32, and the normed result is cast back for ``out_proj``.

On the card, in bf16, the scan is the hand-written pair of ``kernels/ssd``
(``SSDTrain``: a chunked forward and a deterministic backward) with and
without a gradient; CPU tensors, float32 ones (on the card too, by design:
the kernels are bf16) and the fake tensors of the dry-run's trace run
``ssd``. The kernels keep this precision or better:
the decays are applied to C·Bᵀ in float32 before a single cast, and the
chunk states and outputs are never rounded to bf16 (``csrc/ssd.cu``). A
CUDA call the kernels cannot take raises. While telemetry records, the
counters ``mamba2.ssd.kernel`` and ``mamba2.ssd.plain`` count the scans
each route ran.

Serving (prefill into a cache, decode) is not implemented for this mixer:
``Model.prefill`` and ``Model.decode_step`` refuse a model that has one.
The spans ``mamba2.mixer`` and ``mamba2.ssd`` inside it
(``telemetry.fenced_span``) let a device trace of an eager forward
attribute the mixer's and the scan's device time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core import telemetry
from repro_torch.kernels.ssd.train import SSDTrain
from repro_torch.models.common import ParamModule

__all__ = ["mamba2_params", "mamba2_fwd", "ssd", "carry_states"]


def mamba2_params(cfg) -> ParamModule:
    d = cfg.d_model
    m = cfg.mamba2
    h, n, g, dc = m.num_heads, m.d_state, m.n_groups, m.d_conv
    di = m.d_inner
    conv_dim = di + 2 * g * n
    p = ParamModule()
    p.declare("in_proj", (d, di + conv_dim + h), scale=d**-0.5, logical_axes=("fsdp", "inner"))
    p.declare("conv_w", (dc, conv_dim), scale=dc**-0.5, logical_axes=("conv", "inner"))
    p.declare("conv_b", (conv_dim,), init="zeros", logical_axes=("inner",))
    p.declare("dt_bias", (h,), init="mamba2_dt_bias", logical_axes=(None,))
    p.declare("a_log", (h,), init="mamba2_a_log", logical_axes=(None,))
    p.declare("d_skip", (h,), init="ones", logical_axes=(None,))
    p.declare("norm", (di,), init="zeros", logical_axes=("inner",))
    p.declare("out_proj", (di, d), scale=di**-0.5, logical_axes=("inner", "fsdp"))
    return p


def _decay_matrix(cs: torch.Tensor, strict: bool = False) -> torch.Tensor:
    """exp(cs_i − cs_j) for j ≤ i (j < i when ``strict``), 0 elsewhere:
    (..., L) float32 → (..., L, L). The entries above the diagonal are set
    to −∞ before the exponential, so neither they nor their gradients
    overflow."""
    length = cs.shape[-1]
    keep = torch.ones(length, length, dtype=torch.bool, device=cs.device)
    keep = keep.tril(-1 if strict else 0)
    seg = cs[..., :, None] - cs[..., None, :]
    return torch.exp(seg.masked_fill(~keep, float("-inf")))


def carry_states(states: torch.Tensor, chunk_decay: torch.Tensor) -> torch.Tensor:
    """The state entering each chunk, float32: ``states`` (B, H, K, P·N)
    each chunk's own end state, ``chunk_decay`` (B, H, K) the sum of Δ·A
    over each chunk. Entering chunk k: Σ_{j<k} exp(Σ_{j<m<k} decay_m)·S_j,
    the exponent being (decay summed before k) − (decay summed through j)."""
    through = torch.cumsum(chunk_decay, dim=-1)
    before = through - chunk_decay
    keep = torch.ones(chunk_decay.shape[-1], chunk_decay.shape[-1], dtype=torch.bool,
                      device=states.device).tril(-1)
    seg = before[..., :, None] - through[..., None, :]
    weights = torch.exp(seg.masked_fill(~keep, float("-inf")))  # (B, H, K, K)
    return weights @ states


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int) -> torch.Tensor:
    """The Mamba-2 recurrence without its D skip, as SSD's chunked form.
    x (Bt, S, H, P) in the compute dtype, dt = Δ (Bt, S, H) float32, a = A
    (H,) float32, b and c (Bt, S, G, N) in the compute dtype; returns y
    (Bt, S, H, P) float32 (see the module docstring for the precision)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    cdt = x.dtype
    pad = (-s) % chunk
    if pad:
        x, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
        dt = F.pad(dt, (0, 0, 0, pad))
    k = (s + pad) // chunk
    # (Bt, H, K, L): the running sums of Δ·A inside each chunk
    cs = torch.cumsum((dt * a).view(bsz, k, chunk, h).permute(0, 3, 1, 2), dim=-1)
    # Δ·x as (Bt, G, H/G, K, L, P); B and C as (Bt, G, 1, K, L, N)
    xd = (x.float() * dt[..., None]).to(cdt).view(bsz, k, chunk, g, hg, p)
    xd = xd.permute(0, 3, 4, 1, 2, 5)
    bg = b.view(bsz, k, chunk, g, n).permute(0, 3, 1, 2, 4)[:, :, None]
    cg = c.view(bsz, k, chunk, g, n).permute(0, 3, 1, 2, 4)[:, :, None]

    # within each chunk: the dual quadratic form
    decay = _decay_matrix(cs).to(cdt).view(bsz, g, hg, k, chunk, chunk)
    y = ((cg @ bg.transpose(-1, -2)) * decay) @ xd  # (Bt, G, H/G, K, L, P)

    # each chunk's own end state (Bt, H, K, P·N), carried across chunks
    to_end = torch.exp(cs[..., -1:] - cs).view(bsz, g, hg, k, chunk, 1)
    states = ((xd * to_end).to(cdt).transpose(-1, -2) @ bg).float()  # (Bt, G, H/G, K, P, N)
    entering = carry_states(states.view(bsz, h, k, p * n), cs[..., -1])
    entering = entering.view(bsz, g, hg, k, p, n).to(cdt)
    y_off = (cg @ entering.transpose(-1, -2)).float()  # (Bt, G, H/G, K, L, P)
    y = y.float() + y_off * torch.exp(cs).view(bsz, g, hg, k, chunk, 1)
    y = y.permute(0, 3, 4, 1, 2, 5).reshape(bsz, k * chunk, h, p)
    return y[:, :s] if pad else y


def _kernel_route(x: torch.Tensor) -> bool:
    """Whether the scan runs the kernel pair: bf16 on the card, and not a
    fake tensor. A float32 scan on the card runs the composition by design
    (the kernels are bf16). Counted while telemetry records and no graph is
    being captured."""
    take = x.is_cuda and x.dtype == torch.bfloat16 and not is_fake(x)
    if telemetry.recording(x.device):
        telemetry.count("mamba2.ssd.kernel" if take else "mamba2.ssd.plain")
    return take


def mamba2_fwd(x: torch.Tensor, p: ParamModule, cfg) -> torch.Tensor:
    """The mixer on x (Bt, S, D) in the compute dtype → (Bt, S, D)."""
    m = cfg.mamba2
    h, hp, n, g = m.num_heads, m.head_dim, m.d_state, m.n_groups
    di = m.d_inner
    conv_dim = di + 2 * g * n
    bsz, s, _ = x.shape
    cdt = x.dtype
    with telemetry.fenced_span("mamba2.mixer", x.device):
        z, xbc, dt = torch.split(x @ p.in_proj.to(cdt), [di, conv_dim, h], dim=-1)
        w = p.conv_w.t()[:, None, :].to(cdt)  # (conv_dim, 1, d_conv): depthwise
        xbc = F.conv1d(xbc.transpose(1, 2), w, p.conv_b.to(cdt), padding=m.d_conv - 1,
                       groups=conv_dim)[..., :s]
        xs, bm, cm = torch.split(F.silu(xbc.transpose(1, 2)), [di, g * n, g * n], dim=-1)
        xs = xs.reshape(bsz, s, h, hp)
        delta = F.softplus(dt.float() + p.dt_bias.float())
        a = -torch.exp(p.a_log.float())
        with telemetry.fenced_span("mamba2.ssd", x.device, tokens=bsz * s):
            scan = SSDTrain.apply if _kernel_route(xs) else ssd
            y = scan(xs, delta, a, bm.reshape(bsz, s, g, n), cm.reshape(bsz, s, g, n),
                     m.chunk_size)
        y = (y + p.d_skip.float()[:, None] * xs.float()).reshape(bsz, s, di)
        y = y * F.silu(z.float())
        y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + cfg.norm_eps)
        out = (y * (1.0 + p.norm.float())).to(cdt) @ p.out_proj.to(cdt)
    return out
