"""Runner of the LM training cells: the program's training step
(``repro_torch.training.make_train_step``) at the configuration's widths
and depth, fed seeded batches.

Set-up builds the model (``impl="torch"``: training runs the plain
composition), loads the benchmark's seeded weights into it (made on the
card, ``inputs/lm.py``), builds the step and drives it through its first
three steps — two eager, the third captured as a CUDA graph and replayed —
on batches 0, 1, 2. It keeps the losses, the first gradient's norm per
leaf (from the first moment after step 1: m = (1 − β1)·g) and the norm of
each leaf's change after step 3. The window then replays the same step
object on batches 3, 4, … (every row new) until ``--seconds`` have passed.

Checked once the window has closed and the program's state is freed: the
plain reference (``reference/lm_train.py``) takes the same weights and the
same three batches through three steps; the numbers compared are the
widest relative gap of the three losses, and, by the worst leaf, of the
first gradient's norm and of the change's norm after step 3.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List

from amt_bench.harness import derive_seed
from amt_bench.inputs.lm import SyntheticLMDataset, make_weights
from amt_bench.reference.lm_train import Reference, leaf_gap

SET_UP_STEPS = 3


def model_config(model: dict):
    from repro_torch.configs.base import ModelConfig, MoESettings

    fields = dict(model)
    fields["moe"] = MoESettings(**model["moe"])
    return ModelConfig(**fields)


class Cell:
    def __init__(self, conf, workload, seed: int, device):
        self.conf, self.wl, self.seed, self.device = conf, workload, seed, device
        self.batch, self.seq = workload["global_batch"], workload["seq_len"]
        self.micro = workload["microbatches"]
        self.weight_seed = derive_seed(seed, 1)
        self.data = SyntheticLMDataset(conf["model"]["vocab_size"], self.seq, self.batch,
                                       seed=derive_seed(seed, 2))
        self.setup_parts: Dict[str, float] = {}
        self.program: Dict[str, Any] = {}
        self.ref = None

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        import torch
        from repro_torch.models import build_model
        from repro_torch.training import AdamWConfig, make_train_step
        from repro_torch.training.train_step import train_state_of

        cfg = model_config(self.conf["model"])
        t = time.perf_counter()
        model = build_model(cfg, impl="torch", device=self.device).materialize()
        flat, views = make_weights(self.conf["model"], self.weight_seed, self.device)
        params = dict(model.named_parameters())
        if params.keys() != views.keys():
            raise SystemExit("the model's parameters are not the configuration's layout")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(views[name])
        del flat, views
        self.setup_parts["weights_s"] = time.perf_counter() - t

        t = time.perf_counter()
        opt = AdamWConfig(**self.conf["optimizer"])
        self.state = train_state_of(model, opt)
        self.step = make_train_step(model, opt, microbatches=self.micro)
        self.model = model
        losses = []
        for i in range(SET_UP_STEPS):
            self.state, metrics = self.step(self.state, self.data.batch(i))
            losses.append(float(metrics["loss"]))
            if i == 0:
                beta1 = opt.beta1
                grad = {k: float(torch.linalg.vector_norm(m.float())) / (1 - beta1)
                        for k, m in self.state.opt["m"].items()}
        # the first weights again, from the seed, for each leaf's change
        flat, views = make_weights(self.conf["model"], self.weight_seed, self.device)
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(p - views[k])) for k, p in params.items()}
        del flat, views
        if self.device.type == "cuda":
            # hand the copy's blocks back, so that the window's reserved
            # memory is the program's own
            torch.cuda.empty_cache()
        self.program = {"loss": losses, "grad": grad, "change": change}
        self.setup_parts["steps_s"] = time.perf_counter() - t
        self.next_batch = SET_UP_STEPS

    # ------------------------------------------------------------- window
    def window(self, seconds: float, tracer=None) -> Dict[str, Any]:
        import torch

        if tracer is not None:
            tracer.start()
        losses: List[Any] = []
        t0 = time.perf_counter()
        unprofiled = None  # (steps, time) when the profiler stopped
        while time.perf_counter() - t0 < seconds:
            batch = self.data.batch(self.next_batch)
            self.next_batch += 1
            self.state, metrics = self.step(self.state, batch)
            losses.append(metrics["loss"])
            if tracer is not None:
                tracer.after_call()
                if unprofiled is None and tracer.device_trace is not None:
                    unprofiled = (len(losses), time.perf_counter())
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.stop()
        failed = sum(1 for v in losses if not math.isfinite(float(v)))
        rec = {"window_s": t1 - t0, "steps": len(losses),
               "tokens": len(losses) * self.batch * self.seq,
               "attempted": len(losses), "failed": failed}
        if unprofiled is not None:
            # the steps after the profiled part, on their own clock: the
            # profiler slows the device while it records
            rec["unprofiled"] = {"steps": len(losses) - unprofiled[0], "s": t1 - unprofiled[1]}
        return rec

    # -------------------------------------------------------------- check
    def _free_program(self) -> None:
        import torch

        for name in ("step", "state", "model"):
            if hasattr(self, name):
                delattr(self, name)
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, quant: bool) -> Dict[str, Any]:
        """The reference's three steps from the same weights and batches."""
        import torch

        flat, views = make_weights(self.conf["model"], self.weight_seed, self.device)
        ref = Reference(self.conf["model"], self.conf["optimizer"], views, quant=quant)
        del flat, views
        theta0 = {k: v.detach().clone() for k, v in ref.w.items()}
        losses, grad = [], None
        for i in range(SET_UP_STEPS):
            b = self.data.batch(i)
            inputs = torch.as_tensor(b["inputs"], device=self.device).long()
            labels = torch.as_tensor(b["labels"], device=self.device).long()
            loss, norms = ref.step(inputs, labels, self.micro)
            losses.append(loss)
            if i == 0:
                grad = norms
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(ref.w[k] - theta0[k])) for k in ref.w}
        del ref, theta0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"loss": losses, "grad": grad, "change": change}

    def _numbers(self, got: Dict[str, Any], want: Dict[str, Any]) -> List[tuple]:
        limits = self.wl["limits"]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
        leaves = list(want["grad"])
        grad_gap, _ = leaf_gap(got["grad"], want["grad"], leaves)
        # leaves the reference's gradient leaves at rounding (under 1e-3 of
        # the median leaf's) move under AdamW by round-off alone
        med = sorted(want["grad"].values())[len(leaves) // 2]
        moved = [k for k in leaves if want["grad"][k] >= 1e-3 * med]
        change_gap, _ = leaf_gap(got["change"], want["change"], moved)
        return [("loss_gap", loss_gap, limits["loss_gap"], SET_UP_STEPS),
                ("grad_gap", grad_gap, limits["grad_gap"], len(leaves)),
                ("change_gap", change_gap, limits["change_gap"], len(moved))]

    def check(self) -> List[tuple]:
        """(number, value, limit, count) of every number compared."""
        self._free_program()
        if not self.program:
            return [("loss_gap", math.inf, self.wl["limits"]["loss_gap"], 0)]
        self.ref = self._reference(quant=False)
        return self._numbers(self.program, self.ref)

    def control(self) -> List[tuple]:
        """The reference with float8 products put in the program's place."""
        if self.ref is None:
            self.ref = self._reference(quant=False)
        return self._numbers(self._reference(quant=True), self.ref)


def plant_half_batch():
    """A fault for the limits' readings: the loss over the first half of
    each microbatch's rows, the mean taken over the rest."""
    from repro_torch.models import model as M

    original = M.Model.loss_fn

    def loss_fn(self, batch):
        half = {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}
        return original(self, half)

    M.Model.loss_fn = loss_fn


FAULTS = {"half_batch": plant_half_batch}
