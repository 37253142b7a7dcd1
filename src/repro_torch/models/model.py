"""Model assembly of the port: embeddings → decoder blocks → LM head.

The JAX package stacks the parameters of each slot of the block pattern
over the periods and runs them with ``lax.scan`` (``stack/slot{i}_{kind}``
with a leading ``num_periods`` axis, then ``leftover/layer{i}_{kind}``).
The port keeps one ``ParamModule`` per block in a ``ModuleList`` in layer
order — layer ``p·P + i`` is period ``p``'s slot ``i``, the leftover layers
follow — and runs them in a Python loop; ``convert.lm_params_from_numpy``
maps one layout onto the other. Caches are a list with one entry per layer.

Public API (class ``Model``): ``init(seed)``, ``param_specs`` /
``abstract_params`` / ``cache_specs`` (shapes only, nothing allocated),
``loss_fn`` (training forward with CE + MoE aux loss, under autograd),
``prefill`` (builds decode caches), ``decode_step`` (one token),
``init_cache``. Prefill and decode run under ``torch.inference_mode()``;
a model with ``mamba2`` blocks trains only, and refuses both.

On a ``DeviceMesh`` (``mesh=``) the parameters are DTensors placed by the
sharding rules, the activations are constrained where the JAX package
constrains them (``ShardCtx``), plain tensors made inside the forward
(positions, masks, counters) count as replicated, and each kernel runs on
its local shards through ``ShardCtx.local_call``. ``cfg.remat`` checkpoints each period of
blocks while gradients are recorded (``torch.utils.checkpoint``), as the
JAX package checkpoints each scanned period, or each block with
``cfg.remat_unit == "layer"``; the numbers stay the same.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    PartitionSpec,
    ShardingRules,
    logical_to_spec,
    shard_shape,
)
from repro_torch.models import blocks as B
from repro_torch.models.common import ParamModule, ShardCtx, fill_param, rms_norm, softcap

__all__ = ["Model", "build_model"]

IMPLS = ("kernel", "torch")

#: logical axes of a decode cache by its number of dims, the JAX package's
#: ``Model.cache_specs`` rule less its stack axis: a KV cache (B, C, Hkv,
#: Dh), a mamba conv window / ssm state (B, ·, ·), an rglru state (B, di)
CACHE_AXES = {
    4: ("batch", "cache_seq", "kv_heads", None),
    3: ("batch", None, "inner"),
    2: ("batch", "inner"),
}


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model(ParamModule):
    """The LM on one device or over a mesh. Built with shapes only
    (``meta``); ``init`` or ``convert.load_lm_params`` allocates the
    parameters on ``device``. ``impl`` picks the prefill's attention and
    scan: ``"kernel"`` (the CUDA kernels) or ``"torch"`` (the plain
    composition); it may be changed between calls. ``mesh`` is a
    ``DeviceMesh`` (the model runs sharded over it by ``rules``), a plain
    ``{axis: size}`` mapping (``param_specs`` and ``cache_specs`` only) or
    None; with a ``DeviceMesh`` and no ``device`` the mesh's device type is
    the device."""

    def __init__(self, cfg: ModelConfig, impl: str = "kernel", device=None,
                 rules: ShardingRules = DEFAULT_RULES, mesh=None):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
        self.cfg = cfg
        self.impl = impl
        self.rules = rules
        self.mesh = mesh
        self.ctx = ShardCtx(rules, mesh)
        if device is None and self.ctx.active:
            device = self.mesh.device_type
        self.device = resolve_device(device)
        self.compute_dtype = _dtype(cfg.compute_dtype)
        # √d rounded to the compute dtype, as the JAX package multiplies by
        # it; a Python number, so applying it copies nothing to the device
        self.embed_mult = float(torch.tensor(math.sqrt(cfg.d_model), dtype=self.compute_dtype))
        param_dtype = _dtype(cfg.param_dtype)
        # d^-0.5 embedding init: the first block op is an RMSNorm (input scale
        # is immaterial) while *tied* logits come out unit-scale.
        self.declare("embed", (cfg.vocab_size, cfg.d_model), scale=cfg.d_model**-0.5,
                     dtype=_dtype(cfg.embed_dtype) if cfg.embed_dtype else param_dtype,
                     logical_axes=("vocab", "fsdp"))
        if not cfg.tie_embeddings:
            self.declare("head", (cfg.d_model, cfg.vocab_size), scale=cfg.d_model**-0.5,
                         dtype=param_dtype, logical_axes=("fsdp", "vocab"))
        self.declare("final_norm", (cfg.d_model,), init="zeros", dtype=param_dtype,
                     logical_axes=("embed",))
        self.kinds = cfg.layer_kinds()
        self.blocks = nn.ModuleList([B.block_params(cfg, kind) for kind in self.kinds])
        if param_dtype != torch.float32:
            for p in self.blocks.parameters():
                p.data = p.data.to(param_dtype)

    # ------------------------------------------------------------ building
    def materialize(self) -> "Model":
        """Allocate the parameters on the model's device (uninitialised) if
        they are still shapes only."""
        if self.embed.is_meta:
            self.to_empty(device=self.device)
        return self

    def init(self, seed: int) -> "Model":
        """Seeded initialisation on the model's device, by each parameter's
        rule (``ParamModule.declare``); returns the model. On a mesh each
        parameter is filled whole and then sharded (``shard_params``), so
        the same seed gives the same weights on any mesh."""
        self.materialize()
        for path, mod, pname in self._declared():
            init, scale = mod.inits[pname]
            fill_param(getattr(mod, pname), init, scale, seed, path)
        return self.shard_params()

    def _declared(self):
        """(path, module, name) of every declared parameter."""
        for mod_name, mod in self.named_modules():
            if isinstance(mod, ParamModule):
                for pname in mod.inits:
                    yield (f"{mod_name}.{pname}" if mod_name else pname), mod, pname

    def shard_params(self) -> "Model":
        """Replace each whole parameter by its DTensor on the mesh, placed by
        its logical axes (each rank keeps its own shard of the same whole
        tensor); a no-op without a ``DeviceMesh`` or once sharded. A
        parameter still on ``meta`` is allocated empty first — under
        ``FakeTensorMode`` that allocates nothing, which is how the dry-run
        places a model that no card could hold."""
        if not self.ctx.active:
            return self
        from torch.distributed.tensor import DTensor, distribute_tensor

        for _, mod, pname in self._declared():
            p = getattr(mod, pname)
            if isinstance(p, DTensor):
                continue
            if p.is_meta:
                data = torch.empty(p.shape, dtype=p.dtype, device=self.device)
            else:
                data = p.data
            placements = self.ctx.placements(mod.axes[pname], p.shape)
            dt = distribute_tensor(data, self.mesh, placements, src_data_rank=None)
            setattr(mod, pname, nn.Parameter(dt, requires_grad=p.requires_grad))
        return self

    def param_specs(self) -> Dict[str, PartitionSpec]:
        """{parameter name: PartitionSpec} from the declared logical axes
        (the JAX package's ``spec`` mode, per layer); reads shapes only.
        With no mesh every spec is empty, as in the JAX package."""
        if self.mesh is None:
            return {n: PartitionSpec() for n, _ in self.named_parameters()}
        return {path: logical_to_spec(mod.axes[pname], getattr(mod, pname).shape,
                                      self.rules, self.mesh)
                for path, mod, pname in self._declared()}

    def abstract_params(self) -> Dict[str, torch.Tensor]:
        """{parameter name: a ``meta`` tensor of its shape and dtype} (no
        allocation)."""
        return {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                for n, p in self.named_parameters()}

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------ embedding
    def _vocab_pick(self, src, idx, src_axes, idx_axes, vocab_dim: int, pick):
        """``pick(src, idx)`` — a gather along the vocab dim ``vocab_dim`` of
        ``src`` — on a mesh. Where the vocab is split over the mesh, each
        rank picks from the rows it holds (the others 0), its result goes
        in its own slot of a leading shard dim, and the slots are summed:
        the JAX package's gather over a sharded vocab. The sum's gradient
        hands each rank the whole upstream gradient, as it should."""
        ctx = self.ctx
        if not ctx.active:
            return pick(src, idx)
        spec = ctx.spec(src_axes, src.shape)
        entry = spec[vocab_dim] if len(spec) > vocab_dim else None
        names = list(self.mesh.mesh_dim_names)
        n = math.prod(self.mesh.shape[names.index(a)] for a in ctx.mesh_axes(entry))
        probe = pick(torch.empty(src.shape, dtype=src.dtype, device="meta"),
                     torch.empty(idx.shape, dtype=idx.dtype, device="meta"))
        out_axes = tuple(idx_axes) + (None,) * (probe.ndim - len(idx_axes))
        inputs = [(src, src_axes), (idx, idx_axes)]
        if n == 1:
            return ctx.local_call(pick, inputs, [(out_axes, probe.shape)])

        def local(s_, i_):
            rows = s_.shape[vocab_dim]
            v0 = ctx.shard_index(entry) * rows
            mine = (i_ >= v0) & (i_ < v0 + rows)
            got = pick(s_, torch.clamp(i_ - v0, 0, rows - 1))
            mine = mine.reshape(mine.shape + (1,) * (got.ndim - mine.ndim))
            return (got * mine.to(got.dtype))[None]

        out = ctx.local_call(local, inputs, [(("vocab",) + out_axes, (n,) + probe.shape)])
        return out.sum(0)

    def _rows(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """table[ids], the table constrained to ("vocab", None)."""
        return self._vocab_pick(table, ids, ("vocab", None), ("batch",) + (None,) * (ids.ndim - 1),
                                0, lambda t, i: t[i])

    def _embed(self, inputs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        cdt = self.compute_dtype
        if cfg.embed_inputs:
            x = inputs.to(cdt)  # stub frontend: (B,S,D)
        else:
            # cast-before-gather: the FSDP gather of the table and the token
            # gather itself then move bf16, as in the JAX package
            x = self._rows(self.ctx.constrain(self.embed.to(cdt), ("vocab", None)), inputs)
        if cfg.embed_scale:
            x = x * self.embed_mult
        if cfg.embedding_multiplier != 1.0:
            x = x * cfg.embedding_multiplier
        return self.ctx.constrain(x, ("batch", "seq", "embed"))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ctx = self.ctx
        if cfg.tie_embeddings:
            # (V, D) — gather the FSDP dim in bf16
            logits = x @ ctx.constrain(self.embed.to(self.compute_dtype), ("vocab", None)).T
        else:
            logits = x @ ctx.constrain(self.head.to(self.compute_dtype), (None, "vocab"))
        if cfg.logits_scaling != 1.0:
            logits = logits / cfg.logits_scaling
        if cfg.logit_softcap > 0:
            logits = softcap(logits, cfg.logit_softcap)
        return ctx.constrain(logits, ("batch", "seq", "vocab"))

    def _positions(self, bsz: int, seq: int) -> torch.Tensor:
        return torch.arange(seq, device=self.device).expand(bsz, seq)

    def _inputs(self, inputs) -> torch.Tensor:
        """A batch input on the model's device; on a mesh, sharded over the
        batch axes as the JAX dry-run's in_shardings place it."""
        from torch.distributed.tensor import DTensor

        if isinstance(inputs, DTensor):
            return inputs
        x = torch.as_tensor(inputs, device=self.device)
        return self.ctx.constrain(x, ("batch",) + (None,) * (x.ndim - 1))

    def _no_grad(self):
        """Inference mode; ``no_grad`` on a mesh, where DTensor views of a
        parameter cannot be taken in inference mode."""
        return torch.no_grad() if self.ctx.active else torch.inference_mode()

    def mesh_scope(self):
        """Plain tensors made inside a forward on a mesh (positions, masks,
        counters: the same on every rank) take part as replicated DTensors."""
        if not self.ctx.active:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()

    # -------------------------------------------------------------- forward
    def _layers(self, first: int, last: int, x: torch.Tensor, aux: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Blocks ``first``…``last − 1`` on x, their aux losses added to aux
        one after another (the JAX package's order). The mesh scope is
        entered here too: remat runs this again in the backward pass."""
        with self.mesh_scope():
            for i in range(first, last):
                x, _, a = B.block_fwd(x, self.blocks[i], self.cfg, self.kinds[i], positions,
                                      impl=self.impl, ctx=self.ctx)
                if a is not None:
                    aux = aux + a
        return x, aux

    def _backbone(self, x: torch.Tensor, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B,S,D) → (x after every block, total aux loss float32). Each
        full period of ``cfg.block_pattern`` — or each of its layers, with
        ``cfg.remat_unit == "layer"`` — is checkpointed under ``cfg.remat``
        while gradients are recorded; the leftover layers are not (as in the
        JAX package, where they sit outside the scan)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        period = cfg.pattern_period
        unit = 1 if cfg.remat_unit == "layer" else period
        remat = cfg.remat and torch.is_grad_enabled()
        for first in range(0, cfg.num_periods * period, unit):
            if remat:
                x, aux = checkpoint(self._layers, first, first + unit, x, aux, positions,
                                    use_reentrant=False)
            else:
                x, aux = self._layers(first, first + unit, x, aux, positions)
        return self._layers(cfg.num_periods * period, cfg.num_layers, x, aux, positions)

    def _label_logits(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """logits[b, s, labels[b, s]], the logits constrained to ("batch",
        "seq", "vocab")."""
        return self._vocab_pick(logits, labels, ("batch", "seq", "vocab"), ("batch", "seq"), 2,
                                lambda lg, lab: torch.gather(lg, -1, lab[..., None])[..., 0])

    def loss_fn(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"inputs": (B,S) int | (B,S,D), "labels": (B,S) int}
        (numpy arrays or tensors). Mean token cross-entropy plus the MoE aux
        loss; returns (loss, {"ce", "aux"}), float32 scalars on the model's
        device (replicated DTensors on a mesh), with the autograd graph when
        gradients are recorded."""
        cfg = self.cfg
        with self.mesh_scope():
            inputs = self._inputs(batch["inputs"])
            labels = self._inputs(batch["labels"]).long()
            bsz, seq = labels.shape
            x = self._embed(inputs)
            x, aux = self._backbone(x, self._positions(bsz, seq))
            x = rms_norm(x, self.final_norm, cfg.norm_eps)
            logits = self._head(x).float()
            logz = torch.logsumexp(logits, dim=-1)  # (B,S)
            ce = torch.mean(logz - self._label_logits(logits, labels))
            return ce + aux, {"ce": ce, "aux": aux}

    # --------------------------------------------------------------- decode
    def _check_servable(self) -> None:
        if "mamba2" in self.kinds:
            raise NotImplementedError(
                f"{self.cfg.name}: serving a model with mamba2 blocks (prefill, decode, "
                "caches) is not implemented; the Mamba-2 mixer trains only (loss_fn)")

    def init_cache(self, batch: int, cache_len: int) -> List[Any]:
        """Zeroed decode caches, one entry a layer. On a mesh each rank
        allocates only its shard of each (placed by ``CACHE_AXES``)."""
        self._check_servable()
        if not self.ctx.active:
            return [B.init_block_cache(self.cfg, kind, batch, cache_len, self.compute_dtype,
                                       self.device) for kind in self.kinds]
        from torch.distributed.tensor import DTensor

        def zeros(t):
            spec = self.ctx.spec(CACHE_AXES[t.ndim], t.shape)
            local = torch.zeros(shard_shape(t.shape, spec, self.mesh), dtype=t.dtype,
                                device=self.device)
            return DTensor.from_local(local, self.mesh, self.ctx.placements(spec, t.shape),
                                      run_check=False)

        return self._cache_map(self._cache_shapes(batch, cache_len), zeros)

    def _cache_shapes(self, batch: int, cache_len: int) -> List[Any]:
        return [B.init_block_cache(self.cfg, kind, batch, cache_len, self.compute_dtype, "meta")
                for kind in self.kinds]

    def _cache_map(self, caches, fn):
        """``fn(tensor)`` over every tensor of a per-layer cache list."""
        out = []
        for c in caches:
            if isinstance(c, dict):
                out.append({k: fn(t) for k, t in c.items()})
            else:
                out.append(tuple(fn(t) for t in c))
        return out

    def _shard_caches(self, caches):
        """Decode caches constrained to ``CACHE_AXES`` (on a mesh)."""
        if not self.ctx.active:
            return caches
        return self._cache_map(caches, lambda t: self.ctx.constrain(t, CACHE_AXES[t.ndim]))

    def cache_specs(self, batch: int, cache_len: int) -> List[Any]:
        """PartitionSpecs matching ``init_cache``'s structure (shapes only):
        the JAX package's rules, one entry a layer."""
        shapes = self._cache_shapes(batch, cache_len)
        if self.mesh is None:
            return self._cache_map(shapes, lambda t: PartitionSpec())
        return self._cache_map(
            shapes, lambda t: logical_to_spec(CACHE_AXES[t.ndim], t.shape, self.rules, self.mesh))

    def prefill(self, inputs, cache_len: int) -> Tuple[torch.Tensor, List[Any]]:
        """Run the full-sequence forward, building decode caches.

        Returns (last-position logits (B,V) float32, caches)."""
        self._check_servable()
        cfg = self.cfg
        with self._no_grad(), self.mesh_scope():
            inputs = self._inputs(inputs)
            bsz, seq = inputs.shape[0], inputs.shape[1]
            positions = self._positions(bsz, seq)
            x = self._embed(inputs)
            caches = []
            for p, kind in zip(self.blocks, self.kinds):
                x, state, _ = B.block_fwd(x, p, cfg, kind, positions, impl=self.impl,
                                          ctx=self.ctx)
                if kind in ("attn", "swa"):
                    window = cfg.window if kind == "swa" else 0
                    state = self._assemble_kv_cache(*state, seq, cache_len, window)
                else:  # mamba {"conv", "ssm"} or rglru {"conv", "h"}: states in f32
                    state = {key: t.to(self.compute_dtype) if key == "conv" else t
                             for key, t in state.items()}
                caches.append(state)
            x = rms_norm(x, self.final_norm, cfg.norm_eps)
            logits = self._head(x[:, -1:, :]).float()[:, 0, :]
            caches = self._shard_caches(caches)
        return logits, caches

    def _assemble_kv_cache(self, k, v, seq, cache_len, window):
        """Map prefill (k, v) (B,S,Hkv,Dh) into the decode cache layout: a
        ring of min(cache_len, window) slots (slot = position mod size) for
        windowed layers, else padded to cache_len. On a mesh the layout is
        built on each rank's batch and head shards."""
        axes = ("batch", None, "kv_heads", None)

        def local(k, v):
            if window and window > 0:
                w = min(cache_len, window)
                take = min(seq, w)
                slots = torch.arange(seq - take, seq, device=k.device) % w
                kc = torch.zeros((k.shape[0], w) + tuple(k.shape[2:]), dtype=k.dtype,
                                 device=k.device)
                vc = torch.zeros_like(kc)
                kc[:, slots] = k[:, -take:]
                vc[:, slots] = v[:, -take:]
                return kc, vc
            if seq < cache_len:
                pad = (0, 0, 0, 0, 0, cache_len - seq)
                return (torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad))
            return k, v

        size = min(cache_len, window) if window and window > 0 else max(seq, cache_len)
        shape = (k.shape[0], size) + tuple(k.shape[2:])
        return self.ctx.local_call(local, [(k, axes), (v, axes)], [(axes, shape), (axes, shape)])

    def decode_step(self, cache: List[Any], inputs, t: int) -> Tuple[torch.Tensor, List[Any]]:
        """One decode step. inputs: (B,) token ids or (B,1,D) embeddings;
        t: absolute position. Returns (logits (B,V) float32, cache); the
        caches are updated in place and the same list is returned."""
        self._check_servable()
        cfg = self.cfg
        t = int(t)
        with self._no_grad(), self.mesh_scope():
            inputs = self._inputs(inputs)
            if cfg.embed_inputs:
                x = inputs.to(self.compute_dtype)
                if x.ndim == 2:
                    x = x[:, None, :]
            else:
                x = self._rows(self.embed.to(self.compute_dtype), inputs[:, None])
            if cfg.embed_scale:
                x = x * self.embed_mult
            if cfg.embedding_multiplier != 1.0:
                x = x * cfg.embedding_multiplier
            x = self.ctx.constrain(x, ("batch", None, "embed"))
            for i, (p, kind) in enumerate(zip(self.blocks, self.kinds)):
                x, cache[i] = B.block_decode(x, p, cfg, kind, cache[i], t, ctx=self.ctx)
            x = rms_norm(x, self.final_norm, cfg.norm_eps)
            logits = self._head(x).float()[:, 0, :]
        return logits, cache


def build_model(cfg: ModelConfig, impl: str = "kernel", device=None,
                rules: ShardingRules = DEFAULT_RULES, mesh=None) -> Model:
    """The port's counterpart of the JAX ``build_model``. ``device=None``
    means the CUDA card (raises with none visible) or, with a
    ``DeviceMesh``, the mesh's device; tests pass ``device="cpu"``. Nothing
    is allocated until ``init``/``load_lm_params``."""
    return Model(cfg, impl, device, rules, mesh)
