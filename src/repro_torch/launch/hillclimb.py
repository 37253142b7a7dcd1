"""§Perf hill-climb driver of the port: the JAX package's
``repro.launch.hillclimb`` over the port's dry-run.

    python -m repro_torch.launch.hillclimb --cell qwen3-moe [--device cpu]

Each target cell has the reference's ordered list of VARIANTS (hypothesis →
change), in the same order and with the same configs and rules. The driver
traces each variant with ``dryrun.lower_cell`` and writes
results/perf_torch/<arch>__<shape>__<variant>.json. A ``time_unroll``
variant is recorded as SKIP with its reason (``UNROLL_SKIP``), not traced
as though it were a different program.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.dryrun import lower_cell, print_record

__all__ = ["CELLS", "SP_RULES", "UNROLL_SKIP", "run_cell", "main"]

Variant = Tuple[str, Callable[[ModelConfig], ModelConfig], Optional[ShardingRules]]


def _mamba_unroll(k: int):
    def f(cfg: ModelConfig) -> ModelConfig:
        return dataclasses.replace(
            cfg, mamba=dataclasses.replace(cfg.mamba, time_unroll=k)
        )
    return f


def _rglru_unroll(k: int):
    def f(cfg):
        return dataclasses.replace(
            cfg, rglru=dataclasses.replace(cfg.rglru, time_unroll=k)
        )
    return f


def _mb(n: int):
    return lambda cfg: dataclasses.replace(cfg, microbatches=n)


def _bf16_params(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16")


def _capacity(cf: float):
    return lambda cfg: dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf)
    )


def _chain(*fns):
    def f(cfg):
        for g in fns:
            cfg = g(cfg)
        return cfg
    return f


SP_RULES = ShardingRules(seq="model")

#: the port's scans (the CUDA kernels and their plain loops) read no
#: ``time_unroll``: an unroll variant would trace the same program again
UNROLL_SKIP = ("the port's scans read no time_unroll (the kernel and its plain loop "
               "step one position at a time); the variant is the baseline program")

CELLS: Dict[str, Tuple[str, str, List[Variant]]] = {
    # the reference's worst roofline fraction (its scan carry)
    "falcon-mamba": ("falcon-mamba-7b", "train_4k", [
        ("unroll8", _mamba_unroll(8), None),
        ("unroll32", _mamba_unroll(32), None),
        ("unroll128", _mamba_unroll(128), None),
        ("unroll32_sp", _mamba_unroll(32), SP_RULES),
    ]),
    # the reference's most collective-bound cell (FSDP regathers of fp32
    # expert weights inside the microbatch loop + MoE dispatch)
    "qwen3-moe": ("qwen3-moe-235b-a22b", "train_4k", [
        ("bf16_params", _bf16_params, None),
        ("mb8", _mb(8), None),
        ("bf16_mb8", _chain(_bf16_params, _mb(8)), None),
        ("bf16_mb8_cap1", _chain(_bf16_params, _mb(8), _capacity(1.0)), None),
        ("bf16_mb8_sp", _chain(_bf16_params, _mb(8)), SP_RULES),
    ]),
    # most representative of the paper's end-to-end use (dense LM training)
    "qwen2.5": ("qwen2.5-3b", "train_4k", [
        ("sp", None, SP_RULES),
        ("mb2", _mb(2), None),
        ("sp_mb2", _mb(2), SP_RULES),
        ("sp_mb1", _mb(1), SP_RULES),
    ]),
    # side target: recurrentgemma (the reference's scan carry)
    "recurrentgemma": ("recurrentgemma-9b", "train_4k", [
        ("unroll32", _rglru_unroll(32), None),
    ]),
}


# --- the reference's iteration-2+ variants ("bf16b" = its cast-before-gather /
#     bf16-SP-boundary code change, which the port's model carries) ----------
CELLS["qwen2.5"][2].extend([
    ("sp_mb1_bf16b", _mb(1), SP_RULES),
    ("base_bf16b", None, None),
    # iteration 3 (pre-norm boundary) refuted — reverted; iteration 4:
    # bf16 embed-table storage only, on top of the iteration-2 state
    ("sp_mb1_v4_bf16embed", _chain(_mb(1), lambda c: dataclasses.replace(c, embed_dtype="bfloat16")), SP_RULES),
    # iteration 5: optimization_barrier pins boundary reshards to bf16
    ("sp_mb1_v5_barrier", _mb(1), SP_RULES),
])
CELLS["qwen3-moe"][2].extend([
    ("bf16p_mb8_bf16b", _chain(_bf16_params, _mb(8)), None),
    # iteration 3: locally-slotted dispatch — scatter stays shard-local, the
    # (E,C,D) all-reduce becomes an all-to-all of routed tokens
    ("localdispatch", lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, dispatch="local")), None),
    ("localdispatch_bf16p", _chain(
        lambda c: dataclasses.replace(c, moe=dataclasses.replace(c.moe, dispatch="local")),
        _bf16_params), None),
    # iteration 4: 4-D reshard (no reshape) so GSPMD emits all-to-all
    ("localdispatch_v4", lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, dispatch="local")), None),
])


def run_cell(key: str, out_dir: str = "results/perf_torch", device: Optional[str] = None) -> None:
    arch, shape, variants = CELLS[key]
    os.makedirs(out_dir, exist_ok=True)
    for name, cfg_fn, rules in variants:
        path = os.path.join(out_dir, f"{arch}__{shape}__{name}.json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            print_record(rec)
            continue
        if name.startswith("unroll"):
            rec = {"arch": arch, "shape": shape, "mesh": "16x16", "status": "SKIP",
                   "reason": UNROLL_SKIP}
        else:
            cfg = get_config(arch)
            if cfg_fn is not None:
                cfg = cfg_fn(cfg)
            rec = lower_cell(arch, shape, multi_pod=False, rules=rules,
                             cfg_override=cfg, device=device)
        rec["variant"] = name
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print_record(rec)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS) + ["all"], default="all")
    ap.add_argument("--out", default="results/perf_torch")
    ap.add_argument("--device", default=None,
                    help="device type of the traced tensors (default: the card)")
    args = ap.parse_args()
    keys = list(CELLS) if args.cell == "all" else [args.cell]
    for k in keys:
        print(f"=== hillclimb: {k} ===")
        run_cell(k, args.out, args.device)


if __name__ == "__main__":
    main()
