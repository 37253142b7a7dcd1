"""Wrapper of the slice-chain CUDA kernel.

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel from ``csrc/slice_chain.cu`` on the current stream — one launch
for the whole chain, on a cluster of as many blocks as the card can place
together (at most 16), each evaluating one of a round's points — or
raises. Buckets of up to ``SMEM_ROWS`` rows keep each block's factor in
shared memory; larger ones keep it in a workspace in device memory, one a
block, allocated here with ``torch.empty`` as the outputs are.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.gp.params import GPHyperParams
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error, suffix
from repro_torch.kernels.slice_chain.plain import (
    GRAM_BACKEND,
    max_evaluations,
    slice_chain_plain,
    table_size,
)

__all__ = ["slice_chain_kernel", "SMEM_ROWS", "NUM_COUNTS"]

SMEM_ROWS = 128  # largest bucket whose factor stays in shared memory
NUM_COUNTS = 4  # evaluations, NaN log densities, exhausted shrinks, in the box
NUM_SCHEDULE = 2  # evaluations made, rounds


def slice_chain_kernel(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    table: torch.Tensor,
    cfg: SliceSamplerConfig,
    gram: torch.dtype,
    trace: bool = False,
    schedule: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Run one chain: (n, d) inputs, (n,) targets and mask, the packed
    table → (kept samples (num_kept, 3d+2), counts (4,), trace or None),
    float64 on the inputs' device. ``gram`` is the gram's type: float32
    (``fit_backend="kernel"``) or float64 (``"torch"``). The counts and the
    trace are the sequential chain's. With ``schedule``, a fourth tensor
    [evaluations made, rounds, cluster width] says how the chain was run:
    the kernel evaluates up to ``width`` points a round, some of which the
    chain throws away; the plain version one point a round."""
    n, d = x.shape
    dim = GPHyperParams.packed_size(d)
    if gram not in GRAM_BACKEND:
        raise TypeError(f"slice_chain: gram type must be float32 or float64, got {gram}")
    if cfg.num_samples < 1:
        raise ValueError("slice_chain: the chain needs at least one update")
    args = (x, y, table)
    shapes = ((n, d), (n,), (table_size(dim, cfg),))
    device = check_inputs("slice_chain", args, shapes, (torch.float64,))
    if mask.dtype != torch.bool or tuple(mask.shape) != (n,) or mask.device != x.device:
        raise ValueError(f"slice_chain: mask must be a bool ({n},) tensor on {x.device}")
    if device == "cpu":
        kept, counts, rows = slice_chain_plain(x, y, mask, table, cfg, gram, trace)
        if not schedule:
            return kept, counts, rows
        one = torch.ones((), dtype=torch.float64)
        return kept, counts, rows, torch.stack([counts[0], counts[0], one])

    K = cfg.num_kept
    out = torch.empty(K * dim + NUM_COUNTS + NUM_SCHEDULE, dtype=torch.float64,
                      device=x.device)
    rows = (torch.empty((max_evaluations(cfg), 2), dtype=torch.float64, device=x.device)
            if trace else None)
    lib = _build.library("slice_chain")
    with torch.cuda.device(x.device):
        dev = torch.cuda.current_device()
        tsize = 4 if gram == torch.float32 else 8
        limit = lib.slice_chain_smem_limit(dev)
        sizes = (n, d, cfg.max_stepout, cfg.max_shrink, tsize)
        in_smem = n <= SMEM_ROWS and lib.slice_chain_smem_bytes(*sizes, 1) <= limit
        need = lib.slice_chain_smem_bytes(*sizes, 1 if in_smem else 0)
        if need > limit:
            raise ValueError(
                f"slice_chain needs {need} bytes of shared memory per block for "
                f"{n} rows and d={d}; the card allows {limit}"
            )
        width = lib.slice_chain_width(*sizes, 1 if in_smem else 0)
        if width < 1:
            raise RuntimeError(f"slice_chain: the card places no cluster for {n} rows "
                               f"and d={d} (width {width})")
        ws = (None if in_smem else
              torch.empty(width * lib.slice_chain_ws_bytes(n, d, tsize) // 8,
                          dtype=torch.float64, device=x.device))
        fn = getattr(lib, f"slice_chain_{suffix(gram)}")
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), mask.contiguous().data_ptr(),
                 table.data_ptr(), out.data_ptr(),
                 None if rows is None else rows.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 n, d, cfg.num_samples, cfg.burn_in, cfg.thin, K,
                 cfg.max_stepout, cfg.max_shrink, float(cfg.step_size), width, stream)
    raise_on_error("slice_chain", err)
    LAUNCHES["slice_chain"] += 1
    kept, counts = out[: K * dim].view(K, dim), out[K * dim: K * dim + NUM_COUNTS]
    if not schedule:
        return kept, counts, rows
    made_rounds = out[K * dim + NUM_COUNTS:]
    return kept, counts, rows, torch.cat([made_rounds, made_rounds.new_tensor([width])])
