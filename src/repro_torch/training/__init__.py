"""Training and serving entry points of the port (``repro.training``'s
counterparts): AdamW, the microbatched train/eval steps, checkpoints, and
prefill/decode."""

from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update, lr_schedule
from repro_torch.training.train_step import TrainState, make_train_step, make_eval_step
from repro_torch.training.serve_step import greedy_generate, make_decode_step, make_prefill

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "lr_schedule",
    "TrainState",
    "make_train_step",
    "make_eval_step",
    "make_decode_step",
    "make_prefill",
    "greedy_generate",
]
