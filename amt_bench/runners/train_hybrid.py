"""Runner of the hybrid Granite training cells (granite 4.0-H: Mamba-2
mixers, NoPE attention, an MoE with a shared expert, one card's expert
share): the program's training step (``repro_torch.training.make_train_step``)
at the configuration's widths and cut depth, fed seeded batches.

It is ``runners/train.py``'s cell with this family's model, weights and
reference: set-up builds the model from the configuration file's published
keys (``model_config``), loads the seeded weights
(``inputs/granite_hybrid.py``), drives the step through its first three
steps (two eager, the third captured as a CUDA graph and replayed) and
keeps the losses, the first gradient's norm per leaf (from m after step 1)
and the norm of each leaf's change after step 3; the window replays the
step on new batches. The check runs the plain reference
(``reference/granite_hybrid_train.py``) through the same three steps and
compares ``grad_gap`` and ``change_gap`` as ``train.py`` does; the float8
control moves the losses no further than bf16 does here (``PERF.md`` §4),
so ``loss_gap`` is reported in ``detail`` and not compared.

A traced run first makes one eager, no-grad forward of a microbatch under
its own short ``torch.profiler`` session with the program's telemetry on
(the spans ``mamba2.mixer``, ``mamba2.ssd``, ``moe.experts``,
``moe.shared`` and the counters ``moe.pairs_held``, ``moe.pairs_dropped``),
hands its blocks back and resets the memory peak, and only then starts the
window's tracer: the record's ``forward`` holds what the per-layer metrics
``ssd_roofline``, ``mamba2_fwd_share`` and ``moe_drop_share`` read.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List

from amt_bench import harness
from amt_bench.harness import DeviceTrace, derive_seed
from amt_bench.inputs.granite_hybrid import make_weights, settings
from amt_bench.inputs.lm import SyntheticLMDataset
from amt_bench.reference.granite_hybrid_train import Reference
from amt_bench.reference.lm_train import leaf_gap

_train = harness.load_module("runners", "train")
SET_UP_STEPS = _train.SET_UP_STEPS
#: the configuration file's layer types → the program's block kinds
KINDS = {"mamba": "mamba2", "attention": "attn"}


def model_config(conf: dict):
    """The program's ``ModelConfig`` of the configuration file: its cut
    depth as one period of the block pattern, its expert share."""
    from repro_torch.configs.base import Mamba2Settings, ModelConfig, MoESettings

    m = settings(conf)
    port = conf["port"]
    kinds = tuple(KINDS[k] for k in m["kinds"])
    return ModelConfig(
        name=conf["name"], vocab_size=m["vocab"], d_model=m["d"], num_layers=len(kinds),
        num_heads=m["hq"], num_kv_heads=m["hkv"], head_dim=m["dh"], d_ff=0,
        block_pattern=kinds, mlp="swiglu",
        moe=MoESettings(num_experts=m["experts"], top_k=m["top_k"], d_expert=m["d_expert"],
                        capacity_factor=m["capacity_factor"],
                        aux_loss_weight=m["aux_loss_weight"], d_shared=m["d_shared"],
                        num_held=m["held"], first_held=m["first_held"]),
        mamba2=Mamba2Settings(num_heads=m["heads"], head_dim=m["head_dim"],
                              d_state=m["d_state"], n_groups=m["groups"], d_conv=m["d_conv"],
                              chunk_size=m["chunk"]),
        tie_embeddings=conf["tie_word_embeddings"], norm_eps=m["eps"],
        rope=conf["position_embedding_type"] != "nope", attn_scale=m["attn_scale"],
        embedding_multiplier=m["embed_mult"], residual_multiplier=m["res_mult"],
        logits_scaling=m["logits_scaling"], param_dtype=port["param_dtype"],
        compute_dtype=port["compute_dtype"], remat=port["remat"],
        remat_unit=port["remat_unit"])


class Cell(_train.Cell):
    def __init__(self, conf, workload, seed: int, device):
        self.conf, self.wl, self.seed, self.device = conf, workload, seed, device
        self.batch, self.seq = workload["global_batch"], workload["seq_len"]
        self.micro = workload["microbatches"]
        self.weight_seed = derive_seed(seed, 1)
        self.data = SyntheticLMDataset(conf["vocab_size"], self.seq, self.batch,
                                       seed=derive_seed(seed, 2))
        self.setup_parts: Dict[str, float] = {}
        self.program: Dict[str, Any] = {}
        self.ref = None
        self.forward = None

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        import torch
        from repro_torch.models import build_model
        from repro_torch.training import AdamWConfig, make_train_step
        from repro_torch.training.train_step import train_state_of

        cfg = model_config(self.conf)
        t = time.perf_counter()
        model = build_model(cfg, impl="torch", device=self.device).materialize()
        flat, views = make_weights(self.conf, self.weight_seed, self.device)
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
                grad = {k: float(torch.linalg.vector_norm(m.float())) / (1 - opt.beta1)
                        for k, m in self.state.opt["m"].items()}
        # the first weights again, from the seed, for each leaf's change
        flat, views = make_weights(self.conf, self.weight_seed, self.device)
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(p - views[k])) for k, p in params.items()}
        del flat, views
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.program = {"loss": losses, "grad": grad, "change": change}
        self.setup_parts["steps_s"] = time.perf_counter() - t
        self.next_batch = SET_UP_STEPS

    # ------------------------------------------------------------- window
    def _profile_forward(self) -> Dict[str, Any]:
        """One eager, no-grad forward of the window's first microbatch with
        telemetry on, under ``torch.profiler`` on the card: its spans,
        counters and device trace."""
        import torch
        from repro_torch.core import telemetry

        rows = self.batch // self.micro
        mb = {k: torch.as_tensor(v[:rows], device=self.device)
              for k, v in self.data.batch(self.next_batch).items()}
        cuda = self.device.type == "cuda"
        tel = telemetry.get()
        tel.reset()
        telemetry.set_enabled(True)
        prof = None
        if cuda:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                self.model.loss_fn(mb)
            if cuda:
                torch.cuda.synchronize()
        finally:
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
            spans = [e for e in tel.trace_events() if e.get("kind") == "span"]
            counters = dict(tel.metrics()["counters"])
            telemetry.set_enabled(False)
            tel.reset()
        trace = DeviceTrace.from_profile(prof, wall) if prof is not None else None
        return {"spans": spans, "counters": counters, "trace": trace,
                "tokens": rows * self.seq, "rows": rows}

    def window(self, seconds: float, tracer=None) -> Dict[str, Any]:
        import torch

        if tracer is not None:
            self.forward = self._profile_forward()
            if self.device.type == "cuda":
                # the eager forward's blocks go back: the window's peak is
                # the replayed step's, as in an untraced run
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
        rec = super().window(seconds, tracer)
        rec["forward"] = self.forward
        return rec

    # -------------------------------------------------------------- check
    def _reference(self, quant: bool) -> Dict[str, Any]:
        """The reference's three steps from the same weights and batches."""
        import torch

        flat, views = make_weights(self.conf, self.weight_seed, self.device)
        ref = Reference(settings(self.conf), self.conf["optimizer"], views, quant=quant)
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
            change = {k: float(torch.linalg.vector_norm(ref.w[k] - views[k])) for k in ref.w}
        del ref, flat, views
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"loss": losses, "grad": grad, "change": change}


    def _numbers(self, got: Dict[str, Any], want: Dict[str, Any]) -> List[tuple]:
        """``train.py``'s ``grad_gap`` and ``change_gap``; not its
        ``loss_gap``, which the lower precision hardly moves here
        (``PERF.md`` §4): it goes to ``detail``, with the worst leaves."""
        limits = self.wl["limits"]
        leaves = list(want["grad"])
        grad_gap, grad_leaf = leaf_gap(got["grad"], want["grad"], leaves)
        # leaves the reference's gradient leaves at rounding (under 1e-3 of
        # the median leaf's) move under AdamW by round-off alone
        med = sorted(want["grad"].values())[len(leaves) // 2]
        moved = [k for k in leaves if want["grad"][k] >= 1e-3 * med]
        change_gap, change_leaf = leaf_gap(got["change"], want["change"], moved)
        self.detail = {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
            "grad_leaf": grad_leaf, "change_leaf": change_leaf}
        return [("grad_gap", grad_gap, limits["grad_gap"], len(leaves)),
                ("change_gap", change_gap, limits["change_gap"], len(moved))]

    def check(self) -> List[tuple]:
        """(number, value, limit, count) of every number compared."""
        self._free_program()
        if not self.program:
            return [("grad_gap", math.inf, self.wl["limits"]["grad_gap"], 0)]
        self.ref = self._reference(quant=False)
        return self._numbers(self.program, self.ref)


# ------------------------------------------------------------------ faults
def plant_no_carry():
    """The SSD's state is not carried across chunks: each chunk starts from
    zero."""
    import torch
    from repro_torch.models import mamba2

    mamba2.carry_states = lambda states, chunk_decay: torch.zeros_like(states)


def plant_no_shared():
    """The shared expert is left out."""
    import torch
    from repro_torch.models import mlp

    mlp._shared_ffn = lambda x, p: torch.zeros_like(x)


def plant_held_renorm():
    """The routing weights renormalized over the experts held here (the
    pairs that took a slot) in place of all the router's top-k."""
    import torch
    from repro_torch.models import mlp

    original = mlp._combine_rows

    def combine(eo, src, top_p):
        w, t, k = top_p.shape
        took = torch.zeros(w, t * k + src.shape[1], dtype=top_p.dtype, device=top_p.device)
        took = took.scatter(1, src, 1.0)[:, : t * k].view(w, t, k)
        held = top_p * took
        return original(eo, src, held / held.sum(-1, keepdim=True).clamp(min=1e-9))

    mlp._combine_rows = combine


FAULTS = {"no_carry": plant_no_carry, "no_shared": plant_no_shared,
          "held_renorm": plant_held_renorm}
