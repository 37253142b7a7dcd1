"""Shared model machinery of the port: parameter declaration and seeded
initialisation, norms, soft-capping and RoPE.

Parameters live in ``ParamModule``s (``torch.nn.Module``s that declare each
parameter with its initialisation rule, as the JAX package's
``Builder.param`` does). A model is built on the ``meta`` device — shapes
only, nothing allocated — and materialised on its device by
``Model.init(seed)`` or by ``convert.load_lm_params``. Each parameter is declared with its logical
axes, as ``Builder.param`` declares them, so ``Model.param_specs`` reads
the JAX package's ``spec`` mode off the ``meta`` model; ``ShardCtx``
carries (rules, mesh) through the forward and constrains activations, as
the JAX package's does, by redistributing DTensors.

Dtype policy, as in the JAX package: parameters are stored in
``param_dtype`` (float32) and cast to ``compute_dtype`` (bf16) at every use.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    PartitionSpec,
    ShardingRules,
    logical_to_spec,
    spec_to_placements,
)

__all__ = [
    "INITS",
    "ParamModule",
    "ShardCtx",
    "NO_MESH",
    "fill_param",
    "mamba2_init",
    "rms_norm",
    "softcap",
    "rope_freqs",
    "apply_rope",
]

# the JAX Builder's rules (src/repro/models/common.py ``Builder.param``), and
# the Mamba-2 rules of the port's own mixer (``models/mamba2.py``)
INITS = ("normal", "zeros", "ones", "uniform", "constant", "mamba2_a_log", "mamba2_dt_bias")
#: Mamba-2's published initialisation (mamba_ssm ``Mamba2``): A uniform in
#: [1, 16], stored as log A; Δ log-uniform in [1e-3, 1e-1] (floored at 1e-4),
#: stored as softplus⁻¹(Δ), the bias of the Δ projection
MAMBA2_A_RANGE = (1.0, 16.0)
MAMBA2_DT_RANGE = (1e-3, 1e-1)
MAMBA2_DT_FLOOR = 1e-4
_SQRT2 = math.sqrt(2.0)
# uniform bounds of a standard normal truncated to [-2, 2]: erf(±2/√2)
_TN_LO = math.erf(-2.0 / _SQRT2)
_TN_HI = math.erf(2.0 / _SQRT2)


class ParamModule(nn.Module):
    """A module whose parameters are declared with the JAX ``Builder``'s
    initialisation rules (``normal`` — a standard normal truncated to
    [−2, 2], times ``scale`` — ``uniform`` on [−scale, scale], ``zeros``,
    ``ones`` and ``constant``) or Mamba-2's (``mamba2_a_log``,
    ``mamba2_dt_bias``; see ``mamba2_init``). Parameters are created on the ``meta``
    device without gradients; ``training.train_step.train_state_of`` turns
    them on for training. ``logical_axes`` names each dim for the sharding
    rules (``distributed.sharding``), as ``Builder.param``'s do."""

    def __init__(self) -> None:
        super().__init__()
        self.inits: Dict[str, Tuple[str, float]] = {}
        self.axes: Dict[str, Tuple[Optional[str], ...]] = {}

    def declare(self, name: str, shape: Tuple[int, ...], init: str = "normal",
                scale: float = 1.0, dtype: torch.dtype = torch.float32,
                logical_axes: Optional[Sequence[Optional[str]]] = None) -> None:
        if init not in INITS:
            raise ValueError(f"unknown init {init!r}")
        axes = tuple(logical_axes) if logical_axes is not None else (None,) * len(shape)
        if len(axes) != len(shape):
            raise ValueError(f"{name}: {len(axes)} logical axes for shape {shape}")
        t = torch.empty(shape, dtype=dtype, device="meta")
        self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.inits[name] = (init, float(scale))
        self.axes[name] = axes


class ShardCtx:
    """Carries (rules, mesh) so model code can constrain activations.

    With ``mesh=None``, or a plain ``{axis: size}`` mapping (shape math
    only), ``constrain`` is the identity. On a ``DeviceMesh`` it
    redistributes a DTensor to the placements of its logical axes (a
    collective where they differ, nothing where they agree), and
    distributes a plain tensor, which under a mesh holds the same global
    value on every rank, by taking this rank's shard of it."""

    def __init__(self, rules: ShardingRules = DEFAULT_RULES, mesh=None):
        self.rules = rules
        self.mesh = mesh

    @property
    def active(self) -> bool:
        return self.mesh is not None and not isinstance(self.mesh, Mapping)

    def spec(self, logical_axes: Sequence[Optional[str]], shape) -> PartitionSpec:
        return logical_to_spec(logical_axes, tuple(shape), self.rules, self.mesh)

    def placements(self, logical_axes: Sequence[Optional[str]], shape):
        """Placements of a ``shape`` tensor named by ``logical_axes`` — or
        by a ``PartitionSpec`` already resolved."""
        if isinstance(logical_axes, PartitionSpec):
            return spec_to_placements(logical_axes, self.mesh)
        return spec_to_placements(self.spec(logical_axes, shape), self.mesh)

    def constrain(self, x: torch.Tensor, logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
        if not self.active:
            return x
        from torch.distributed.tensor import DTensor, distribute_tensor

        placements = self.placements(logical_axes, x.shape)
        if not isinstance(x, DTensor):
            return distribute_tensor(x, self.mesh, placements, src_data_rank=None)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)

    def mesh_axes(self, entry) -> Tuple[str, ...]:
        """The mesh axes of a spec entry (None, a name or a tuple)."""
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def shard_index(self, entry) -> int:
        """This rank's shard index along a spec entry (an axis or a tuple of
        axes, major to minor; 0 for None)."""
        names = list(self.mesh.mesh_dim_names)
        idx = 0
        for a in self.mesh_axes(entry):
            i = names.index(a)
            idx = idx * self.mesh.shape[i] + self.mesh.get_local_rank(i)
        return idx

    def local_call(self, fn, inputs, outputs):
        """``fn`` on this rank's shards: ``inputs`` is a list of (tensor,
        logical axes), each redistributed to its axes' placements before the
        call; ``outputs`` a list of (logical axes, global shape) or (logical
        axes, global shape, mesh axes the output is a partial sum over), one
        for each tensor ``fn`` returns; a ``PartitionSpec`` may stand for the
        logical axes. Without a mesh, ``fn`` on the tensors.
        The kernels take plain tensors, so this is how a kernel reaches a
        sharded model: its input placements are declared, never inferred."""
        tensors = [t for t, _ in inputs]
        if not self.active:
            return fn(*tensors)
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        # a plain tensor (the same global value on every rank) is sharded
        # here: local_map would pass it through whole
        tensors = [t if isinstance(t, DTensor) else self.constrain(t, axes)
                   for t, (_, axes) in zip(tensors, inputs)]
        in_pl = tuple(self.placements(axes, t.shape) for t, axes in inputs)
        # local_map reads a tuple as one entry an output, a list as the
        # placements of a single output
        names = list(self.mesh.mesh_dim_names)
        out_pl = []
        for axes, shape, *partial in outputs:
            pl = list(self.placements(axes, shape))
            for a in (partial[0] if partial else ()):
                if self.mesh.shape[names.index(a)] > 1:
                    pl[names.index(a)] = Partial()
            out_pl.append(pl)
        out_pl = tuple(out_pl)
        # an input whole along a mesh dim that an output is split or summed
        # along got, on each rank, the gradient of that rank's part of the
        # output only: its gradient is the sum over the dim (Partial)
        split = [any(isinstance(o[d], (Shard, Partial)) for o in out_pl)
                 for d in range(self.mesh.ndim)]
        grad_pl = tuple(tuple(Partial() if split[d] and pl == Replicate() else pl
                              for d, pl in enumerate(p)) for p in in_pl)
        mapped = local_map(fn, out_placements=out_pl if len(out_pl) > 1 else out_pl[0],
                           in_placements=in_pl, in_grad_placements=grad_pl,
                           device_mesh=self.mesh, redistribute_inputs=True)
        return mapped(*tensors)


#: the context of a model with no mesh: every constraint is the identity
NO_MESH = ShardCtx()


def _path_seed(seed: int, path: str) -> int:
    digest = hashlib.blake2b(f"{seed}/{path}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") & ((1 << 63) - 1)


@torch.no_grad()
def fill_param(p: torch.Tensor, init: str, scale: float, seed: int, path: str) -> None:
    """Fill ``p`` in place by its rule, from a ``torch.Generator`` on ``p``'s
    device seeded by (``seed``, the parameter's path): the same seed gives
    the same weights on the same device, whatever the order of filling.
    The truncated normal is the inverse-CDF construction ``jax.random``
    uses (uniform on [erf(−2/√2), erf(2/√2)] → √2·erf⁻¹), computed in
    float32 and cast to the parameter's dtype; the bits differ from JAX's.
    The Mamba-2 rules map a uniform draw through ``mamba2_init``. Any other
    rule raises."""
    if init == "zeros":
        p.zero_()
        return
    if init == "ones":
        p.fill_(1.0)
        return
    if init == "constant":
        p.fill_(scale)
        return
    if init not in ("normal", "uniform", "mamba2_a_log", "mamba2_dt_bias"):
        raise ValueError(f"unknown init {init!r}")
    gen = torch.Generator(device=p.device)
    gen.manual_seed(_path_seed(seed, path))
    out = p if p.dtype == torch.float32 else torch.empty_like(p, dtype=torch.float32)
    if init.startswith("mamba2_"):
        out.copy_(mamba2_init(init, out.uniform_(0.0, 1.0, generator=gen)))
    elif init == "uniform":
        out.uniform_(-1.0, 1.0, generator=gen).mul_(scale)
    else:
        out.uniform_(_TN_LO, _TN_HI, generator=gen)
        out.erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0).mul_(scale)
    if out is not p:
        p.copy_(out)


def mamba2_init(init: str, u: torch.Tensor) -> torch.Tensor:
    """Mamba-2's rule on uniform draws ``u`` in [0, 1): ``mamba2_a_log`` →
    log A, A = lo + (hi − lo)·u over ``MAMBA2_A_RANGE``; ``mamba2_dt_bias``
    → softplus⁻¹(Δ), Δ = exp(log lo + u·(log hi − log lo)) over
    ``MAMBA2_DT_RANGE``, floored at ``MAMBA2_DT_FLOOR``."""
    if init == "mamba2_a_log":
        lo, hi = MAMBA2_A_RANGE
        return torch.log(lo + (hi - lo) * u)
    if init == "mamba2_dt_bias":
        lo, hi = MAMBA2_DT_RANGE
        dt = torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo))).clamp(min=MAMBA2_DT_FLOOR)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown Mamba-2 init {init!r}")


# ---------------------------------------------------------------------------
# Normalization / elementwise
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, output in x.dtype. Gemma-style (1+γ)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style soft capping: cap·tanh(x/cap)."""
    return (cap * torch.tanh(x / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary dims (first ``fraction`` of the
    head); shape (rot_dim/2,), float32."""
    rot = int(head_dim * fraction) // 2 * 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over the leading ``rot_dim`` of the head (half-split
    rotation); supports partial rotary (e.g. Minitron's 50%).
    x (..., seq, heads, head_dim), positions (..., seq)."""
    rot = 2 * inv_freq.shape[0]
    angles = positions[..., None].float() * inv_freq  # (..., seq, rot/2)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, rot/2)
    sin = torch.sin(angles)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xf1, xf2 = x_rot[..., : rot // 2].float(), x_rot[..., rot // 2:].float()
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    rotated = torch.cat([out1, out2], dim=-1).to(x.dtype)
    return torch.cat([rotated, x_pass], dim=-1) if x_pass.shape[-1] else rotated
