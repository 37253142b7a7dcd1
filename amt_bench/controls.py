"""Readings that set a cell's limits: the program's compared numbers and its
lower-precision control's, on many seeds, in one process.

    python3 amt_bench/controls.py --workload <cell> --seeds 11,12,13 --seconds 30

For each seed the cell is set up and measured as ``run.py`` does (no trace),
then checked; the control is the plain reference put in the program's place
in the nearest precision below the configuration's (float32 for float64),
judged by the same numbers. One JSON line a seed goes to standard output.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))
sys.path.insert(0, str(_ROOT / "src"))

from amt_bench import harness  # noqa: E402


def readings(name: str, seed: int, seconds: float, device: str = "cuda", overrides=None,
             conf_overrides=None, fault: str = None):
    """(program's checks, control's checks, details) of one seed: lists of
    (number, value, limit, count), and what the runner adds about each.
    ``fault`` plants one of the runner's ``FAULTS`` in the program first;
    its readings are then the program's, and no control runs."""
    import torch

    _, workload, conf = harness.cell_files(name)
    workload, conf = harness.merged(workload, overrides), harness.merged(conf, conf_overrides)
    runner = harness.load_module("runners", workload["runner"])
    if fault:
        runner.FAULTS[fault]()
    cell = runner.Cell(conf, workload, seed, torch.device(device))
    cell.setup()
    cell.window(seconds)
    program = cell.check()
    detail = dict(getattr(cell, "detail", {}))
    control = [] if fault else cell.control()
    return program, control, {"program": detail, "control": dict(getattr(cell, "detail", {}))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None, help="a fault of the runner's FAULTS")
    args = ap.parse_args()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        program, control, detail = readings(args.workload, seed, args.seconds,
                                            fault=args.fault)
        print(json.dumps({
            "seed": seed, "fault": args.fault,
            "program": {c[0]: [c[1], c[2]] for c in program},
            "control": {c[0]: [c[1], c[2]] for c in control},
            "program_passes": all(v <= lim for _, v, lim, _ in program),
            "control_fails": any(v > lim for _, v, lim, _ in control),
            "detail": detail,
        }), flush=True)


if __name__ == "__main__":
    main()
