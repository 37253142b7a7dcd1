"""Model assembly of the port: embeddings → decoder blocks → LM head.

The JAX package stacks the parameters of each slot of the block pattern
over the periods and runs them with ``lax.scan`` (``stack/slot{i}_{kind}``
with a leading ``num_periods`` axis, then ``leftover/layer{i}_{kind}``).
The port keeps one ``ParamModule`` per block in a ``ModuleList`` in layer
order — layer ``p·P + i`` is period ``p``'s slot ``i``, the leftover layers
follow — and runs them in a Python loop; ``convert.lm_params_from_numpy``
maps one layout onto the other. Caches are a list with one entry per layer.

Public API (class ``Model``): ``init(seed)``, ``loss_fn`` (training
forward with CE + MoE aux loss, under autograd), ``prefill`` (builds decode
caches), ``decode_step`` (one token), ``init_cache``. Prefill and decode run
under ``torch.inference_mode()``. ``cfg.remat`` checkpoints each period of
blocks while gradients are recorded (``torch.utils.checkpoint``), as the
JAX package checkpoints each scanned period; the numbers stay the same.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.common import ParamModule, fill_param, rms_norm, softcap

__all__ = ["Model", "build_model"]

IMPLS = ("kernel", "torch")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model(ParamModule):
    """The LM on one device. Built with shapes only (``meta``); ``init`` or
    ``convert.load_lm_params`` allocates the parameters on ``device``.
    ``impl`` picks the prefill's attention and scan: ``"kernel"`` (the CUDA
    kernels) or ``"torch"`` (the plain composition); it may be changed
    between calls."""

    def __init__(self, cfg: ModelConfig, impl: str = "kernel", device=None):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)
        self.compute_dtype = _dtype(cfg.compute_dtype)
        # √d rounded to the compute dtype, as the JAX package multiplies by
        # it; a Python number, so applying it copies nothing to the device
        self.embed_mult = float(torch.tensor(math.sqrt(cfg.d_model), dtype=self.compute_dtype))
        param_dtype = _dtype(cfg.param_dtype)
        # d^-0.5 embedding init: the first block op is an RMSNorm (input scale
        # is immaterial) while *tied* logits come out unit-scale.
        self.declare("embed", (cfg.vocab_size, cfg.d_model), scale=cfg.d_model**-0.5,
                     dtype=_dtype(cfg.embed_dtype) if cfg.embed_dtype else param_dtype)
        if not cfg.tie_embeddings:
            self.declare("head", (cfg.d_model, cfg.vocab_size), scale=cfg.d_model**-0.5,
                         dtype=param_dtype)
        self.declare("final_norm", (cfg.d_model,), init="zeros", dtype=param_dtype)
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
        rule (``ParamModule.declare``); returns the model."""
        self.materialize()
        for mod_name, mod in self.named_modules():
            if isinstance(mod, ParamModule):
                for pname, (init, scale) in mod.inits.items():
                    path = f"{mod_name}.{pname}" if mod_name else pname
                    fill_param(getattr(mod, pname), init, scale, seed, path)
        return self

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------ embedding
    def _embed(self, inputs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        cdt = self.compute_dtype
        if cfg.embed_inputs:
            x = inputs.to(cdt)  # stub frontend: (B,S,D)
        else:
            # cast-before-gather, as the JAX package does
            x = self.embed.to(cdt)[inputs]
        if cfg.embed_scale:
            x = x * self.embed_mult
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = x @ self.embed.to(self.compute_dtype).T  # (V, D)ᵀ
        else:
            logits = x @ self.head.to(self.compute_dtype)  # (D, V)
        if cfg.logit_softcap > 0:
            logits = softcap(logits, cfg.logit_softcap)
        return logits

    def _positions(self, bsz: int, seq: int) -> torch.Tensor:
        return torch.arange(seq, device=self.device).expand(bsz, seq)

    def _inputs(self, inputs) -> torch.Tensor:
        return torch.as_tensor(inputs, device=self.device)

    # -------------------------------------------------------------- forward
    def _layers(self, first: int, last: int, x: torch.Tensor, aux: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Blocks ``first``…``last − 1`` on x, their aux losses added to aux
        one after another (the JAX package's order)."""
        for i in range(first, last):
            x, _, a = B.block_fwd(x, self.blocks[i], self.cfg, self.kinds[i], positions,
                                  impl=self.impl)
            if a is not None:
                aux = aux + a
        return x, aux

    def _backbone(self, x: torch.Tensor, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B,S,D) → (x after every block, total aux loss float32). Each
        full period of ``cfg.block_pattern`` is checkpointed under
        ``cfg.remat`` while gradients are recorded; the leftover layers are
        not (as in the JAX package, where they sit outside the scan)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        period = cfg.pattern_period
        remat = cfg.remat and torch.is_grad_enabled()
        for first in range(0, cfg.num_periods * period, period):
            if remat:
                x, aux = checkpoint(self._layers, first, first + period, x, aux, positions,
                                    use_reentrant=False)
            else:
                x, aux = self._layers(first, first + period, x, aux, positions)
        return self._layers(cfg.num_periods * period, cfg.num_layers, x, aux, positions)

    def loss_fn(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"inputs": (B,S) int | (B,S,D), "labels": (B,S) int}
        (numpy arrays or tensors). Mean token cross-entropy plus the MoE aux
        loss; returns (loss, {"ce", "aux"}), float32 scalars on the model's
        device, with the autograd graph when gradients are recorded."""
        cfg = self.cfg
        inputs = self._inputs(batch["inputs"])
        labels = self._inputs(batch["labels"]).long()
        bsz, seq = labels.shape
        x = self._embed(inputs)
        x, aux = self._backbone(x, self._positions(bsz, seq))
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = self._head(x).float()
        logz = torch.logsumexp(logits, dim=-1)  # (B,S)
        true_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
        ce = torch.mean(logz - true_logit)
        return ce + aux, {"ce": ce, "aux": aux}

    # --------------------------------------------------------------- decode
    def init_cache(self, batch: int, cache_len: int) -> List[Any]:
        return [
            B.init_block_cache(self.cfg, kind, batch, cache_len, self.compute_dtype, self.device)
            for kind in self.kinds
        ]

    def prefill(self, inputs, cache_len: int) -> Tuple[torch.Tensor, List[Any]]:
        """Run the full-sequence forward, building decode caches.

        Returns (last-position logits (B,V) float32, caches)."""
        cfg = self.cfg
        with torch.inference_mode():
            inputs = self._inputs(inputs)
            bsz, seq = inputs.shape[0], inputs.shape[1]
            positions = self._positions(bsz, seq)
            x = self._embed(inputs)
            caches = []
            for p, kind in zip(self.blocks, self.kinds):
                x, state, _ = B.block_fwd(x, p, cfg, kind, positions, impl=self.impl)
                if kind in ("attn", "swa"):
                    window = cfg.window if kind == "swa" else 0
                    state = self._assemble_kv_cache(*state, seq, cache_len, window)
                else:  # mamba {"conv", "ssm"} or rglru {"conv", "h"}: states in f32
                    state = {key: t.to(self.compute_dtype) if key == "conv" else t
                             for key, t in state.items()}
                caches.append(state)
            x = rms_norm(x, self.final_norm, cfg.norm_eps)
            logits = self._head(x[:, -1:, :]).float()[:, 0, :]
        return logits, caches

    def _assemble_kv_cache(self, k, v, seq, cache_len, window):
        """Map prefill (k, v) (B,S,Hkv,Dh) into the decode cache layout: a
        ring of min(cache_len, window) slots (slot = position mod size) for
        windowed layers, else padded to cache_len."""
        if window and window > 0:
            w = min(cache_len, window)
            take = min(seq, w)
            slots = torch.arange(seq - take, seq, device=k.device) % w
            kc = torch.zeros((k.shape[0], w) + tuple(k.shape[2:]), dtype=k.dtype, device=k.device)
            vc = torch.zeros_like(kc)
            kc[:, slots] = k[:, -take:]
            vc[:, slots] = v[:, -take:]
            return (kc, vc)
        if seq < cache_len:
            pad = (0, 0, 0, 0, 0, cache_len - seq)
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
        return (k, v)

    def decode_step(self, cache: List[Any], inputs, t: int) -> Tuple[torch.Tensor, List[Any]]:
        """One decode step. inputs: (B,) token ids or (B,1,D) embeddings;
        t: absolute position. Returns (logits (B,V) float32, cache); the
        caches are updated in place and the same list is returned."""
        cfg = self.cfg
        t = int(t)
        with torch.inference_mode():
            inputs = self._inputs(inputs)
            if cfg.embed_inputs:
                x = inputs.to(self.compute_dtype)
                if x.ndim == 2:
                    x = x[:, None, :]
            else:
                x = self.embed.to(self.compute_dtype)[inputs[:, None]]
            if cfg.embed_scale:
                x = x * self.embed_mult
            for i, (p, kind) in enumerate(zip(self.blocks, self.kinds)):
                x, cache[i] = B.block_decode(x, p, cfg, kind, cache[i], t)
            x = rms_norm(x, self.final_norm, cfg.norm_eps)
            logits = self._head(x).float()[:, 0, :]
        return logits, cache


def build_model(cfg: ModelConfig, impl: str = "kernel", device=None) -> Model:
    """The port's counterpart of the JAX ``build_model``. ``device=None``
    means the CUDA card (raises with none visible); tests pass
    ``device="cpu"``. Nothing is allocated until ``init``/``load_lm_params``."""
    return Model(cfg, impl, device)
