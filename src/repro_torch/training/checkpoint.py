"""Trial-level checkpointing of the port: params + optimizer + step → .npz
(+ JSON meta), the JAX package's file.

The arrays sit under the JAX package's keys — its ``TrainState`` tree
paths: ``.params/embed``, ``.params/stack/slot{i}_{kind}/…`` with a leading
period axis, ``.params/leftover/layer{i}_{kind}/…``, ``.opt/m/…``,
``.opt/v/…``, ``.opt/step`` — so either package loads the other's
checkpoint (``convert.lm_param_paths`` maps the port's per-layer names onto
them). bf16 moments are written widened to float32 (exact) and cast back to
the template's dtype on load; the JAX package writes its bf16 arrays as raw
2-byte records (numpy has no bf16 type of its own), which the port reads as
bf16 bits. The write is atomic (write-temp-then-rename);
restores are bit-exact because the data pipeline is stateless-seeded (see
``repro_torch.data.synthetic``).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.training.train_step import TrainState

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, val in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(val, dict):
            _flatten(val, name, out)
        else:
            out[name] = val


def _as_f32(arr: np.ndarray) -> np.ndarray:
    """float32 values of a checkpoint array; a 2-byte raw record is a bf16
    bit pattern, widened exactly."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(arr, dtype=np.float32)


def save_checkpoint(directory: str, step: int, state: TrainState,
                    extra: Optional[Dict] = None, *, cfg) -> str:
    """Write ``state`` (the port's TrainState of a model of config ``cfg``)
    as ``ckpt_{step:08d}.npz`` + ``.json`` under ``directory``; returns the
    .npz path."""
    os.makedirs(directory, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    _flatten({".params": convert.lm_params_to_numpy(cfg, state.params),
              ".opt": convert.opt_state_to_numpy(cfg, state.opt)}, "", flat)
    flat = {k[1:]: v for k, v in flat.items()}  # drop the leading "/"
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        # through the open file: np.savez would append ".npz" to a name
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        path = os.path.join(directory, f"ckpt_{step:08d}.npz")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    meta = {"step": step, "extra": extra or {}}
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(meta, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(f[5:13])
        for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".npz")
    ]
    return max(steps) if steps else None


@torch.no_grad()
def load_checkpoint(directory: str, step: int, state_template: TrainState,
                    *, cfg) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore into the tensors of ``state_template`` in place (the model's
    own parameters when it is ``train_state_of(model, …)``) and return
    (it, meta). Reads the JAX package's checkpoints too."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        paths = convert.lm_param_paths(cfg, state_template.params)

        def fill(prefix: str, tensors: Dict[str, torch.Tensor]) -> None:
            for name, t in tensors.items():
                keys, period = paths[name]
                arr = data["/".join((prefix,) + keys)]
                arr = arr if period is None else arr[period]
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"{name}: checkpoint shape {arr.shape} vs {tuple(t.shape)}")
                t.copy_(torch.as_tensor(_as_f32(arr)).to(t.dtype))

        fill(".params", state_template.params)
        fill(".opt/m", state_template.opt["m"])
        fill(".opt/v", state_template.opt["v"])
        state_template.opt["step"].fill_(int(data[".opt/step"]))
    with open(os.path.join(directory, f"ckpt_{step:08d}.json")) as f:
        meta = json.load(f)
    return state_template, meta
