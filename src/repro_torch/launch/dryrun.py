"""Production-mesh dry-run of the port: trace every (arch × shape × mesh)
cell's step on a mesh no machine here has, and write one JSON record each.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b \\
        --shape train_4k [--multi-pod] [--out results/dryrun_torch]
    python -m repro_torch.launch.dryrun --all
    python -m repro_torch.launch.dryrun --device cpu ...   # no card

The JAX package's ``repro.launch.dryrun`` lowers and compiles each cell on
512 forced host devices and reads XLA's cost and memory analyses. The port
starts a ``fake`` process group of the production world size (256 ranks,
or 512 with ``--multi-pod``), builds the model on ``FakeTensorMode`` over
the production ``DeviceMesh`` — the parameters are DTensors placed by the
sharding rules, and nothing is allocated — and traces the train, prefill
or decode step once under ``op_analysis.OpAnalysis``, which counts one
rank's FLOPs, bytes, collectives and ops and tracks its live storage (the
peak is ``device_bytes_estimate``). The step is the eager composition
(``impl="torch"``), as the JAX dry-run lowers ``impl="xla"``. A train cell
traces one microbatch and counts it as all of them
(``OpAnalysis.repeat``), as ``hlo_static`` multiplies a loop body by its
trip count.

A process has one default group, so a cell runs in the process that owns
it: the CLI, or a subprocess. ``lower_cell`` starts the fake group and
tears it down; with a group already running it refuses.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.launch.roofline import H100_SXM, count_params, roofline_terms

__all__ = ["SKIP_LONG500K", "eligible", "lower_cell", "print_record", "main"]

SKIP_LONG500K = {
    # pure full-attention archs: O(seq·layers) decode caches, no windowing —
    # the JAX package's table, reason for reason
    "musicgen-large": "pure full attention (48L MHA): no sub-quadratic decode path",
    "internvl2-1b": "pure full attention: no sub-quadratic decode path",
    "granite-moe-1b-a400m": "pure full attention: no sub-quadratic decode path",
    "qwen3-moe-235b-a22b": "pure full attention: no sub-quadratic decode path",
    "qwen2.5-3b": "pure full attention: no sub-quadratic decode path",
    "minitron-4b": "pure full attention: no sub-quadratic decode path",
    "gemma3-27b": "5:1 local:global — 10 global layers still need a full "
                  "500k cache; arch specified for 128k (DESIGN.md §4)",
}


def eligible(arch: str, shape_name: str) -> Optional[str]:
    """Returns a skip reason or None."""
    if shape_name == "long_500k" and arch in SKIP_LONG500K:
        return SKIP_LONG500K[arch]
    return None


def _cell_rules(cfg, shape: ShapeConfig, rules: ShardingRules, model_ways: int) -> ShardingRules:
    """The JAX dry-run's two overrides. Decode caches: shard the kv heads
    over the model axis when they divide it, else the cache's sequence
    (replicating a 32k cache over 16 model shards does not fit). Attention
    interior: when the query heads do not divide the model axis, shard the
    interior by sequence instead."""
    if shape.kind == "decode" and cfg.num_kv_heads and cfg.num_kv_heads % 16 != 0:
        rules = dataclasses.replace(rules, cache_seq="model")
    if (shape.kind in ("train", "prefill") and cfg.num_heads
            and cfg.num_heads % model_ways != 0 and rules.attn_seq is None):
        rules = dataclasses.replace(rules, attn_seq="model")
    return rules


def _card() -> Dict[str, Any]:
    """The card's name, power limit and memory, as ``nvidia-smi`` and torch
    report them."""
    import torch

    props = torch.cuda.get_device_properties(0)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=30,
    )
    return {"card": out.stdout.strip().splitlines()[0] if out.stdout.strip() else props.name,
            "hbm_bytes": int(props.total_memory)}


def _start_group(world: int) -> None:
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers "fake")

    if dist.is_initialized():
        raise RuntimeError(
            "lower_cell starts its own 'fake' process group and this process already "
            "has one: run the dry-run in a process of its own (the CLI or a subprocess)"
        )
    dist.init_process_group("fake", rank=0, world_size=world)


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    rules: Optional[ShardingRules] = None,
    cfg_override=None,
    opt_override=None,
    shape: Optional[ShapeConfig] = None,
    mesh_shape: Optional[Tuple[int, ...]] = None,
    device: Optional[str] = None,
    micro_repeat: bool = True,
) -> Dict[str, Any]:
    """Trace one cell; return the result record. ``shape`` replaces
    ``SHAPES[shape_name]`` and ``mesh_shape`` the production mesh (axes
    ("data", "model"), or ("pod", "data", "model") with three dims), so a
    cell one card holds can be estimated on a (1, 1) mesh. ``device`` is the
    fake tensors' device type (None: the card, as every entry point);
    ``micro_repeat=False`` traces every microbatch instead of one."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.device import resolve_device
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models.mlp import _batch_ways
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (
        make_train_step,
        microbatch_count,
        train_state_of,
    )

    t_start = time.perf_counter()  # invariant: wall-clock -- presentation-only trace timing of the dry-run report; never feeds a decision or a compared number
    dev = resolve_device(device)
    shape = shape or SHAPES[shape_name]
    cfg = cfg_override or get_config(arch)
    rules = rules or ShardingRules()
    dims, axes = PRODUCTION_SHAPES[multi_pod]
    if mesh_shape is not None:
        dims = tuple(mesh_shape)
        axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    chips = math.prod(dims)
    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape.name,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "kind": shape.kind,
        "mesh": "x".join(str(s) for s in dims),
        "chips": chips,
        "multi_pod": multi_pod,
        "device": dev.type,
        "status": "UNKNOWN",
    }
    reason = eligible(arch, shape.name)
    if reason is not None:
        record["status"] = "SKIP"
        record["reason"] = reason
        return record

    hw = H100_SXM
    record["target"] = hw.name
    capacity = hw.hbm_bytes
    if dev.type == "cuda":
        card = _card()
        record["card"] = card["card"]
        capacity = card["hbm_bytes"]

    _start_group(chips)
    try:
        mesh = init_device_mesh(dev.type, dims, mesh_dim_names=axes)
        rules = _cell_rules(cfg, shape, rules, dict(zip(axes, dims)).get("model", 1))
        record["rules"] = {k: v for k, v in dataclasses.asdict(rules).items()
                           if v != getattr(ShardingRules(), k)}
        model = build_model(cfg, impl="torch", device=dev.type, rules=rules, mesh=mesh)
        b, s = shape.global_batch, shape.seq_len
        analysis = OpAnalysis()
        with FakeTensorMode(), analysis:
            with analysis.setup():
                model.shard_params()
                params = list(model.parameters())
                record["param_bytes"] = int(sum(p.to_local().numel() * p.element_size()
                                                for p in params))
            if cfg.embed_inputs:
                tokens = lambda *sz: torch.zeros(sz + (cfg.d_model,),  # noqa: E731
                                                 dtype=model.compute_dtype, device=dev)
            else:
                tokens = lambda *sz: torch.zeros(sz, dtype=torch.long, device=dev)  # noqa: E731
            if shape.kind == "train":
                opt_cfg = opt_override or AdamWConfig()
                n_micro = microbatch_count(cfg.microbatches, b, _batch_ways(model.ctx))
                record["microbatches"] = n_micro
                with analysis.setup():
                    state = train_state_of(model, opt_cfg)
                    batch = {"inputs": tokens(b, s),
                             "labels": torch.zeros((b, s), dtype=torch.long, device=dev)}
                step = make_train_step(model, opt_cfg).eager
                loop = analysis.repeat if micro_repeat else range
                t_trace = time.perf_counter()  # invariant: wall-clock -- presentation-only trace timing
                step(state, batch, micro_loop=loop)
            elif shape.kind == "prefill":
                with analysis.setup():
                    inputs = tokens(b, s)
                t_trace = time.perf_counter()  # invariant: wall-clock -- presentation-only trace timing
                model.prefill(inputs, s)
            else:  # decode
                with analysis.setup():
                    caches = model.init_cache(b, s)
                    inputs = tokens(b, 1) if cfg.embed_inputs else tokens(b)
                t_trace = time.perf_counter()  # invariant: wall-clock -- presentation-only trace timing
                model.decode_step(caches, inputs, s - 1)
        t_end = time.perf_counter()  # invariant: wall-clock -- presentation-only trace timing
    finally:
        dist.destroy_process_group()

    stats = analysis.stats.to_json()
    coll = stats["collective_bytes"]
    terms = roofline_terms(stats["flops"], stats["bytes"], float(coll.get("total", 0)),
                           chips, cfg, shape, hw=hw)
    peak = int(stats["peak_bytes"])
    record.update(
        status="OK",
        build_s=round(t_trace - t_start, 2),
        trace_s=round(t_end - t_trace, 2),
        flops=stats["flops"],
        bytes=stats["bytes"],
        collective_bytes=coll,
        op_census=stats["op_census"],
        op_flops=stats["op_flops"],
        op_bytes=stats["op_bytes"],
        roofline=terms,
        params=count_params(cfg),
        device_bytes_estimate=peak,
        hbm_capacity=int(capacity),
        fits_hbm=bool(peak < capacity),
    )
    return record


def print_record(r: Dict[str, Any]) -> None:
    if r["status"] == "SKIP":
        print(f"[SKIP] {r['arch']} × {r['shape']} ({r['mesh']}): {r['reason']}")
        return
    t = r["roofline"]
    print(
        f"[OK] {r['arch']} × {r['shape']} ({r['mesh']}, {r['target']}): "
        f"trace {r['trace_s']}s | "
        f"compute {t['compute_s']:.4f}s memory {t['memory_s']:.4f}s "
        f"collective {t['collective_s']:.4f}s → {t['bottleneck']}-bound | "
        f"useful {t.get('useful_ratio', 0):.2f} roofline {t.get('roofline_fraction', 0):.3f} | "
        f"mem/dev {r.get('device_bytes_estimate', 0)/1e9:.2f} GB "
        f"of {r['hbm_capacity']/1e9:.1f} fits={r.get('fits_hbm')}"
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default=None,
                    help="device type of the traced tensors (default: the card)")
    args = ap.parse_args()

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    print_record(rec)
                    continue
                try:
                    rec = lower_cell(arch, shape, multi_pod=mp, device=args.device)
                except Exception as e:  # noqa: BLE001
                    rec = {
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": "FAIL", "error": traceback.format_exc(limit=6),
                    }
                    failures += 1
                    print(f"[FAIL] {arch} × {shape}: {e}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] != "FAIL":
                    print_record(rec)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
