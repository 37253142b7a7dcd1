"""The port's HPO launcher: one AMT tuning job over real training jobs.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --trials 8 --parallel 2 --steps 60 [--full-config] [--random] \
        [--device cpu]

Every trial trains the selected architecture with the sampled optimizer
hyperparameters — its reduced ``tiny()`` config, or the full published
config with ``--full-config`` — on the synthetic LM dataset, streaming its
validation loss to the tuner every ``--eval-every`` steps; the median rule
stops unpromising trials and the BO engine proposes the next configuration.
Trials run on the CUDA card unless ``--device cpu`` is passed. Training runs
the plain PyTorch composition (``impl="torch"``), as the JAX package's
launcher trains on its XLA route; the GP decisions run the engine's CUDA
kernels. Each trial builds its own model, so trials in flight side by side
hold one training state each.

Tuner state checkpoints after every transition; rerunning the same command
with the same --checkpoint and --resume resumes the job (at-least-once trial
semantics).
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch

from repro_torch.configs import get_config, tiny
from repro_torch.core import (
    BOConfig,
    BOSuggester,
    Continuous,
    MedianRule,
    RandomSuggester,
    SearchSpace,
    Tuner,
    TuningJobConfig,
)
from repro_torch.core.device import resolve_device
from repro_torch.core.scheduler import ThreadBackend
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, make_train_step
from repro_torch.training.train_step import init_train_state

__all__ = ["default_search_space", "build_objective", "run_tuning_job", "main"]


def default_search_space() -> SearchSpace:
    return SearchSpace([
        Continuous("learning_rate", 1e-4, 3e-2, scaling="log"),
        Continuous("weight_decay", 1e-4, 0.3, scaling="log"),
        Continuous("warmup_frac", 0.02, 0.4),
        Continuous("beta2", 0.9, 0.999, scaling="reverse_log"),
        Continuous("clip_norm", 0.1, 10.0, scaling="log"),
    ])


def build_objective(arch: str, steps: int, eval_every: int, full_config: bool,
                    seq_len: int = 64, global_batch: int = 8, device=None):
    """``objective(hp, report) -> eval loss``: train ``arch`` for ``steps``
    steps with the AdamW hyperparameters ``hp``, reporting the loss on a
    held-out batch every ``eval_every`` steps (a False reply stops the
    trial). Every trial builds its own model and starts from the same
    weights, ``init_train_state(model, 0, …)``. ``device=None`` means the
    card."""
    cfg = get_config(arch) if full_config else tiny(get_config(arch))
    device = resolve_device(device)
    ds = SyntheticLMDataset(
        cfg.vocab_size, seq_len=seq_len, global_batch=global_batch, seed=0,
        embed_dim=cfg.d_model if cfg.embed_inputs else None,
    )

    def on_device(batch):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    eval_batch = on_device(ds.batch(10_000))

    def objective(hp, report):
        opt_cfg = AdamWConfig(
            learning_rate=hp["learning_rate"],
            weight_decay=hp["weight_decay"],
            warmup_steps=max(1, int(hp["warmup_frac"] * steps)),
            total_steps=steps,
            beta2=hp["beta2"],
            clip_norm=hp["clip_norm"],
        )
        model = build_model(cfg, impl="torch", device=device)
        state = init_train_state(model, 0, opt_cfg)
        step = make_train_step(model, opt_cfg)
        eval_loss = math.inf
        for i in range(steps):
            state, metrics = step(state, on_device(ds.batch(i)))
            if not math.isfinite(float(metrics["loss"])):
                raise FloatingPointError(f"diverged at step {i}")
            if (i + 1) % eval_every == 0:
                with torch.no_grad():
                    eval_loss = float(model.loss_fn(eval_batch)[0])
                if not report(eval_loss):
                    return eval_loss
        return eval_loss

    return objective


def run_tuning_job(args) -> None:
    space = default_search_space()
    objective = build_objective(args.arch, args.steps, args.eval_every,
                                args.full_config, device=args.device)
    suggester = (
        RandomSuggester(space, seed=args.seed)
        if args.random
        else BOSuggester(space, BOConfig(num_init=3).fast(), seed=args.seed,
                         device=args.device)
    )
    backend = ThreadBackend(max_workers=args.parallel)
    tuner = Tuner(
        space, objective, suggester, backend,
        TuningJobConfig(
            max_trials=args.trials, max_parallel=args.parallel,
            max_retries=args.max_retries, trial_timeout=args.trial_timeout,
            checkpoint_path=args.checkpoint, job_name=f"tune-{args.arch}",
        ),
        stopping_rule=None if args.no_early_stopping else MedianRule(),
    )
    if args.checkpoint and os.path.exists(args.checkpoint) and args.resume:
        tuner.restore()
        print(f"resumed from {args.checkpoint}: {len(tuner.trials)} trials")
    result = tuner.run()
    backend.shutdown()
    print(f"best objective : {result.best_objective:.4f}")
    print(f"best config    : {result.best_config}")
    print(f"trials         : {len(result.trials)} "
          f"(stopped {result.num_early_stopped}, "
          f"failed attempts {result.num_failed_attempts})")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--parallel", type=int, default=2)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-retries", type=int, default=1)
    ap.add_argument("--trial-timeout", type=float, default=None)
    ap.add_argument("--checkpoint",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_tuner.json"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--random", action="store_true")
    ap.add_argument("--no-early-stopping", action="store_true")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the trials and the engine (default: the CUDA card)")
    run_tuning_job(ap.parse_args())


if __name__ == "__main__":
    main()
