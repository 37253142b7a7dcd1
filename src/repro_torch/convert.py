"""Carry GP state across from the JAX package (or any numpy source).

The JAX package's arrays convert with ``np.asarray``; these functions turn
the resulting numpy arrays into the port's tensors on a device:

* ``params_from_numpy`` — packed GPHP draws (S, 3d+2) or (3d+2,) →
  ``GPHyperParams``;
* ``posterior_from_numpy`` — a dict of ``x_train``, ``mask``, ``chol``,
  ``alpha``, packed ``params`` and optionally ``chol_inv`` →
  ``GPPosterior``;
* ``posterior_to_numpy`` — the inverse, for comparing the two packages;
* ``lm_params_from_numpy`` / ``load_lm_params`` — the JAX ``Model.init``
  tree of an LM (stacked ``stack/slot{i}_{kind}`` periods and
  ``leftover/layer{i}_{kind}`` layers) → the port's per-layer parameters;
  ``lm_params_to_numpy`` the inverse, and ``lm_param_paths`` where each of
  the port's parameters sits in the JAX tree;
* ``opt_state_to_numpy`` / ``opt_state_from_numpy`` — the port's AdamW
  state (``m``, ``v``, ``step``) ↔ the JAX package's ``adamw_init`` tree;
* ``lm_cache_to_numpy`` / ``lm_cache_from_numpy`` — the port's per-layer
  decode caches ↔ the JAX package's cache tree.

Like every entry point of the port, they run on the CUDA card unless the
caller passes ``device="cpu"`` (for the LM, the model's own device); with no
card visible the default raises.

A JAX ``BOSuggester.state_dict()`` needs no conversion: the port's
``BOSuggester.load_state_dict`` takes it unchanged (the threefry key stays a
uint32 pair, the GPHP draws packed float64 lists).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.gp.gp import GPPosterior
from repro_torch.core.gp.params import GPHyperParams

__all__ = [
    "params_from_numpy",
    "posterior_from_numpy",
    "posterior_to_numpy",
    "lm_params_from_numpy",
    "lm_params_to_numpy",
    "lm_param_paths",
    "load_lm_params",
    "opt_state_to_numpy",
    "opt_state_from_numpy",
    "lm_cache_to_numpy",
    "lm_cache_from_numpy",
]


def params_from_numpy(
    packed, d: Optional[int] = None, device=None
) -> GPHyperParams:
    """Packed log-space GPHPs → ``GPHyperParams`` of float64 tensors on
    ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    vec = torch.as_tensor(np.array(packed, dtype=np.float64)).to(device)
    if d is None:
        d = (vec.shape[-1] - 2) // 3
    if vec.shape[-1] != GPHyperParams.packed_size(d):
        raise ValueError(f"packed width {vec.shape[-1]} does not fit d={d}")
    return GPHyperParams.unpack(vec, d)


def posterior_from_numpy(blob: Mapping[str, Any], device=None) -> GPPosterior:
    """A factorized posterior from numpy arrays (see the module docstring),
    on ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)

    def f64(key):
        return torch.as_tensor(np.array(blob[key], dtype=np.float64)).to(device)

    x_train = f64("x_train")
    linv = blob.get("chol_inv")
    return GPPosterior(
        x_train=x_train,
        mask=torch.as_tensor(np.array(blob["mask"], dtype=bool)).to(device),
        chol=f64("chol"),
        alpha=f64("alpha"),
        params=params_from_numpy(blob["params"], x_train.shape[-1], device),
        chol_inv=None if linv is None else f64("chol_inv"),
    )


def posterior_to_numpy(post) -> Dict[str, Any]:
    """``x_train``, ``mask``, ``chol``, ``alpha``, packed ``params`` and
    ``chol_inv`` (or None) as numpy arrays — works on either package's
    posterior."""

    def host(t):
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return t.detach().cpu().numpy()
        return np.asarray(t)

    return {
        "x_train": host(post.x_train),
        "mask": host(post.mask),
        "chol": host(post.chol),
        "alpha": host(post.alpha),
        "params": host(post.params.pack()),
        "chol_inv": host(post.chol_inv),
    }


# ---------------------------------------------------------------------------
# LM parameters and caches
# ---------------------------------------------------------------------------
def _layer_slots(cfg):
    """(layer index, JAX group, JAX name, period or None) for every layer:
    layer ``p·P + i`` is ``stack/slot{i}_{kind}`` at period ``p``; the
    leftover layers follow as ``leftover/layer{i}_{kind}``."""
    period = cfg.block_pattern
    out = []
    for p in range(cfg.num_periods):
        for si, kind in enumerate(period):
            out.append((p * len(period) + si, "stack", f"slot{si}_{kind}", p))
    base = cfg.num_periods * len(period)
    for li in range(cfg.num_leftover):
        out.append((base + li, "leftover", f"layer{li}_{period[li]}", None))
    return out


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, Mapping):
            _flatten(val, name, out)
        else:
            out[name] = np.asarray(val)


def lm_params_from_numpy(cfg, tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's ``Model.init`` tree (leaves convert with
    ``np.asarray``) → ``{port parameter name: array}``: ``embed``, ``head``,
    ``final_norm`` and ``blocks.{layer}.{ln1, attn.wq, mixer.w_x, mlp.w1,
    …}``, each stacked slot unstacked into its layers."""
    out: Dict[str, np.ndarray] = {}
    _flatten({k: v for k, v in tree.items() if k not in ("stack", "leftover")}, "", out)
    for layer, group, name, period in _layer_slots(cfg):
        block: Dict[str, np.ndarray] = {}
        _flatten(tree[group][name], "", block)
        for key, val in block.items():
            out[f"blocks.{layer}.{key}"] = val if period is None else val[period]
    return out


def lm_param_paths(cfg, names) -> Dict[str, tuple]:
    """{port parameter name: (path of keys in the JAX tree, period or
    None)}: ``blocks.{layer}.{a}.{b}`` of a stacked slot is
    (``stack``, ``slot{i}_{kind}``, a, b) at index ``period`` of the leading
    axis; a leftover layer's and the top-level names have no period."""
    layers = {layer: (group, name, period) for layer, group, name, period in _layer_slots(cfg)}
    out = {}
    for n in names:
        if n.startswith("blocks."):
            _, layer, rest = n.split(".", 2)
            group, slot, period = layers[int(layer)]
            out[n] = ((group, slot) + tuple(rest.split(".")), period)
        else:
            out[n] = (tuple(n.split(".")), None)
    return out


def _put(tree: Dict[str, Any], path: tuple, val) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


def lm_params_to_numpy(cfg, named: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``lm_params_from_numpy``: ``{port parameter name:
    tensor}`` (or any same-named dict: gradients, AdamW moments) → the JAX
    package's nested tree of numpy arrays, each stacked slot's layers
    stacked over the periods (bf16 widened to float32)."""
    tree: Dict[str, Any] = {}
    stacked: Dict[tuple, Dict[int, np.ndarray]] = {}
    for name, (path, period) in lm_param_paths(cfg, named).items():
        val = named[name]
        arr = _host(val) if isinstance(val, torch.Tensor) else np.asarray(val)
        if period is None:
            _put(tree, path, arr)
        else:
            stacked.setdefault(path, {})[period] = arr
    for path, per in stacked.items():
        _put(tree, path, np.stack([per[i] for i in range(cfg.num_periods)]))
    return tree


def opt_state_to_numpy(cfg, opt: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's AdamW state → the JAX package's ``adamw_init`` tree:
    {"m": tree, "v": tree, "step": int32}, numpy (bf16 moments widened to
    float32)."""
    return {"m": lm_params_to_numpy(cfg, opt["m"]),
            "v": lm_params_to_numpy(cfg, opt["v"]),
            "step": np.asarray(_host(torch.as_tensor(opt["step"])), dtype=np.int32)}


def opt_state_from_numpy(cfg, tree: Mapping[str, Any], device,
                         moment_dtype: str = "float32") -> Dict[str, Any]:
    """The JAX package's AdamW state tree (leaves convert with
    ``np.asarray``) → the port's: ``m`` in ``moment_dtype``, ``v`` float32,
    ``step`` an int32 scalar, on ``device``."""
    device = resolve_device(device)

    def tensors(sub, dtype):
        return {k: torch.as_tensor(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)
                for k, a in lm_params_from_numpy(cfg, sub).items()}

    return {"m": tensors(tree["m"], getattr(torch, moment_dtype)),
            "v": tensors(tree["v"], torch.float32),
            "step": torch.as_tensor(np.asarray(tree["step"], dtype=np.int32)).to(device)}


def load_lm_params(model, tree: Mapping[str, Any]):
    """Allocate ``model``'s parameters on its device and copy the JAX
    package's parameter tree into them (names, shapes and dtypes must
    match). Returns the model."""
    state = lm_params_from_numpy(model.cfg, tree)
    model.materialize()
    params = dict(model.named_parameters())
    if set(params) != set(state):
        raise ValueError(
            f"parameter names differ: port only {sorted(set(params) - set(state))}, "
            f"JAX only {sorted(set(state) - set(params))}"
        )
    with torch.no_grad():
        for name, p in params.items():
            src = torch.from_numpy(np.array(state[name]))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} vs {tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


def _host(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _cache_leaf_map(cache, fn):
    if isinstance(cache, tuple):
        return tuple(fn(c) for c in cache)
    return {k: fn(v) for k, v in cache.items()}


def lm_cache_to_numpy(cfg, caches: List[Any]) -> Dict[str, Any]:
    """The port's per-layer caches → the JAX package's cache tree, as numpy
    (bf16 widened to float32): ``stack/slot{i}_{kind}`` leaves stacked over
    the periods, ``leftover/layer{i}_{kind}`` as they are. A KV cache is a
    (k, v) tuple, a mamba cache a {"conv", "ssm"} dict, an rglru cache a
    {"conv", "h"} dict."""
    out: Dict[str, Any] = {}
    per_slot: Dict[str, List[Any]] = {}
    for layer, group, name, _ in _layer_slots(cfg):
        host = _cache_leaf_map(caches[layer], _host)
        if group == "stack":
            per_slot.setdefault(name, []).append(host)
        else:
            out.setdefault("leftover", {})[name] = host
    if per_slot:
        stack = {}
        for name, items in per_slot.items():
            if isinstance(items[0], tuple):
                stack[name] = tuple(np.stack([c[i] for c in items]) for i in range(len(items[0])))
            else:
                stack[name] = {k: np.stack([c[k] for c in items]) for k in items[0]}
        out["stack"] = stack
    return out


_F32_STATES = ("h", "ssm")  # recurrent states kept in float32


def lm_cache_from_numpy(cfg, tree: Mapping[str, Any], dtype, device) -> List[Any]:
    """The JAX package's cache tree (leaves convert with ``np.asarray``) →
    the port's per-layer caches on ``device``: KV caches and the ``conv``
    windows in ``dtype`` (the compute dtype), the recurrent states — mamba
    ``ssm``, rglru ``h`` — in float32, as the blocks' ``init_*_cache`` make
    them."""
    caches: List[Any] = [None] * cfg.num_layers

    def leaf(x, period, key=None):
        a = np.asarray(x)
        a = a if period is None else a[period]
        dt = torch.float32 if key in _F32_STATES else dtype
        return torch.as_tensor(np.array(a, dtype=np.float32)).to(device=device, dtype=dt)

    for layer, group, name, period in _layer_slots(cfg):
        c = tree[group][name]
        if isinstance(c, Mapping):
            caches[layer] = {k: leaf(v, period, k) for k, v in c.items()}
        else:
            caches[layer] = tuple(leaf(v, period) for v in c)
    return caches
