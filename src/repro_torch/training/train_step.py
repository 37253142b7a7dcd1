"""Train/eval steps of the port with microbatched gradient accumulation.

``make_train_step(model, opt_cfg)`` returns ``(state, batch) -> (state,
metrics)`` as the JAX package's does, run eagerly:

  * the global batch is split into ``cfg.microbatches`` contiguous
    microbatches run one after another (gradient accumulation) — the
    activation-memory lever;
  * gradients accumulate in ``opt_cfg.grad_accum_dtype`` (float32);
  * loss/metrics averaged over microbatches;
  * the AdamW update runs once per step, in place.

The state's parameters are the model's own tensors (``TrainState.params``
is ``dict(model.named_parameters())``, with gradients on), so a step
updates the model. Training runs ``impl="torch"``, as the JAX package
trains on its XLA route, which fuses attention: on the card the port's
counterpart of that fusion, the flash-attention pair (a forward and a
backward kernel), takes the grad-recording bf16 attention calls
(``models/attention.py`` says which). The other CUDA kernels
(``mamba_scan``, ``rglru_scan``, decode attention), like the JAX package's
Pallas kernels, have no backward, and a model with ``impl="kernel"`` is
refused.

The JAX package compiles the step once (``jax.jit``); eager PyTorch pays
the host a launch for each of the step's ~3·10⁴ operations. So on the card
the step is captured as one CUDA graph — forward, backward, accumulation
and the AdamW update — after ``WARMUP_STEPS`` eager steps, and replayed
with the batch copied into the captured input buffers: the same kernels on
the same tensors. A new state or batch shape captures again. On the CPU
every step runs eagerly; ``train_step.eager`` is the step without the
graph, which the dry-run traces.

On a mesh (``Model(mesh=...)``) parameters, gradients and moments are
DTensors. The global batch arrives whole on every rank; each microbatch is
cut from it and then sharded over the batch axes, and the microbatch count
is clamped (``microbatch_count``) so that each microbatch stays divisible
by the batch-sharding ways, as the JAX dry-run clamps it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple

import torch

from repro_torch.core.device import CAPTURE_LOCK
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "make_train_step", "make_eval_step", "init_train_state",
           "train_state_of", "microbatch_count"]

#: eager steps before a step is captured as a CUDA graph (cuBLAS handles,
#: autograd's device threads and the allocator warm up on them)
WARMUP_STEPS = 2


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt: Dict[str, Any]


def train_state_of(model, opt_cfg: AdamWConfig) -> TrainState:
    """The TrainState of the weights ``model`` holds (after ``init`` or
    ``convert.load_lm_params``): its parameters, now recording gradients,
    and fresh AdamW moments."""
    params = {name: p.requires_grad_(True) for name, p in model.named_parameters()}
    return TrainState(params=params, opt=adamw_init(params, opt_cfg))


def init_train_state(model, seed: int, opt_cfg: AdamWConfig) -> TrainState:
    """Seeded initialisation of ``model`` (``Model.init``) and its
    TrainState."""
    model.init(seed)
    return train_state_of(model, opt_cfg)


def _check_trainable(model) -> None:
    if model.impl != "torch":
        raise ValueError(
            f"training needs impl='torch' (the model has impl={model.impl!r}): the "
            "CUDA kernels have no backward, as the JAX package's Pallas kernels "
            "have none, so training runs the plain PyTorch composition, as the "
            "JAX package trains on impl='xla'"
        )


def _grads(model, leaves, batch):
    """(loss, metrics, gradients of the loss for ``leaves``); a parameter
    the loss does not reach gets zeros, as ``jax.grad`` gives it."""
    loss, metrics = model.loss_fn(batch)
    with model.mesh_scope():
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def microbatch_count(n_micro: int, global_batch: int, batch_ways: int) -> int:
    """The microbatch count clamped so that every microbatch divides the
    global batch and stays divisible by the batch-sharding ways (the JAX
    dry-run's clamp); ``n_micro`` itself when there is one way."""
    if batch_ways <= 1:
        return n_micro
    n = max(1, min(n_micro, global_batch // batch_ways))
    while n > 1 and (global_batch % n or (global_batch // n) % batch_ways):
        n -= 1
    return n


def make_train_step(model, opt_cfg: AdamWConfig, microbatches: int | None = None):
    """``microbatches`` overrides cfg.microbatches. Raises ``ValueError`` for
    a model with ``impl="kernel"`` (here, and at each step). On the card the
    step is replayed from a CUDA graph after ``WARMUP_STEPS`` eager steps.
    The returned function carries the eager step as ``.eager(state, batch,
    micro_loop=range)``: ``micro_loop`` yields the microbatch indices, which
    lets a tracer run one microbatch and count it as all of them."""
    _check_trainable(model)
    cfg = model.cfg
    n_cfg = max(1, microbatches if microbatches is not None else cfg.microbatches)
    acc_dt = getattr(torch, opt_cfg.grad_accum_dtype)
    from repro_torch.models.mlp import _batch_ways

    ways = _batch_ways(model.ctx) if model.ctx.active else 1

    def step(state: TrainState, batch: Dict[str, torch.Tensor], micro_loop=range):
        """One step on tensors already on the model's device."""
        names = list(state.params)
        leaves = [state.params[k] for k in names]
        size = batch["labels"].shape[0]
        n_micro = microbatch_count(n_cfg, size, ways)

        with model.mesh_scope():
            if n_micro == 1:
                loss, metrics, grads = _grads(model, leaves, batch)
            else:
                if size % n_micro:
                    raise ValueError(f"global batch {size} not divisible by microbatches {n_micro}")
                size //= n_micro
                g_acc = [torch.zeros_like(p, dtype=acc_dt) for p in leaves]
                loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
                aux_sum = torch.zeros((), dtype=torch.float32, device=model.device)
                for i in micro_loop(n_micro):
                    mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                    loss, m, g = _grads(model, leaves, mb)
                    for a, gi in zip(g_acc, g):
                        a.add_(gi.to(acc_dt))
                    del g
                    loss_sum = loss_sum + loss
                    aux_sum = aux_sum + m["aux"]
                grads = [a.div_(n_micro) for a in g_acc]
                loss = loss_sum / n_micro
                metrics = {"ce": loss - aux_sum / n_micro, "aux": aux_sum / n_micro}

            _, opt, opt_metrics = adamw_update(
                state.params, dict(zip(names, grads)), state.opt, opt_cfg
            )
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(state.params, opt), metrics

    graph = _GraphedStep(step) if model.device.type == "cuda" else None

    def train_step(state: TrainState, batch: Mapping[str, Any]):
        _check_trainable(model)
        own = dict(model.named_parameters())
        if own.keys() != state.params.keys() or any(
                own[k] is not p for k, p in state.params.items()):
            raise ValueError("state.params must be the model's own parameters "
                             "(train_state_of / init_train_state)")
        # whole on every rank: each microbatch is sharded as it is cut
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        if graph is None:
            return step(state, batch)
        return graph(state, batch)

    train_step.eager = step
    return train_step


class _GraphedStep:
    """A train step replayed from a CUDA graph: ``WARMUP_STEPS`` eager calls,
    then one capture (the step recorded, not run) and a replay, then
    replays with the batch copied into the captured inputs. The graph is
    bound to the state's tensors and the batch's shapes; either changing
    starts over."""

    def __init__(self, step) -> None:
        self.step = step
        self.key = None
        self.eager_calls = 0
        self.graph = self.inputs = self.metrics = None

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        tensors = [*state.params.values(), *state.opt["m"].values(),
                   *state.opt["v"].values(), state.opt["step"]]
        key = (tuple(id(t) for t in tensors),
               tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items())))
        if key != self.key:
            self.key, self.eager_calls, self.graph = key, 0, None
        if self.graph is None:
            if self.eager_calls < WARMUP_STEPS:
                self.eager_calls += 1
                return self.step(state, batch)
            self.inputs = {k: v.clone() for k, v in batch.items()}
            graph = torch.cuda.CUDAGraph()
            with CAPTURE_LOCK:
                # thread-local: the other trials' threads and the tuner keep
                # launching and synchronizing while this thread captures
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    _, self.metrics = self.step(state, self.inputs)
            self.graph = graph
        else:
            for k, v in batch.items():
                self.inputs[k].copy_(v)
        self.graph.replay()
        return TrainState(state.params, state.opt), {k: v.clone() for k, v in self.metrics.items()}


def make_eval_step(model):
    """``eval_step(batch) -> {"loss", "ce", "aux"}`` without gradients. The
    model holds its parameters, so the step takes none."""

    def eval_step(batch):
        with torch.no_grad():
            loss, metrics = model.loss_fn(batch)
        return {"loss": loss, **metrics}

    return eval_step
