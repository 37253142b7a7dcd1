"""Per-device operation analysis of one traced step: the port's counterpart
of the JAX package's ``launch/hlo_analysis.py`` and ``launch/hlo_static.py``.

The JAX dry-run compiles a step and parses the partitioned HLO text. The
port has no HLO: it runs the step once — on ``FakeTensorMode`` for a
production mesh, so nothing is allocated — under ``OpAnalysis``, a
``TorchDispatchMode`` that sees every aten op a rank runs on its local
shards (DTensor ops are passed down to DTensor, whose local ops come back
to the mode). It gives the same fields:

* ``flops`` — per-device FLOPs from ``torch.utils.flop_counter``'s formulas
  (matrix products, convolutions, attention) on the local shapes; what
  ``hlo_static.analyze_hlo`` sums over ``dot`` ops;
* ``bytes`` — per-device bytes: the inputs plus outputs of every aten op
  that moves data (views and allocations move none). The eager port fuses
  nothing, so this is its real traffic, where the HLO count stops at fusion
  boundaries;
* ``op_flops`` / ``op_bytes`` — the same by op;
* ``collective_bytes`` — result bytes of the functional collectives by kind
  (all-gather, all-reduce, reduce-scatter, all-to-all, collective-permute)
  and their total: ``hlo_analysis.collective_bytes``;
* ``op_census`` — how many times each op ran: ``hlo_analysis.op_census``;
* ``peak_bytes`` — the most bytes of storage alive at once during the
  trace, the per-device peak memory estimate (``memory_analysis`` in the
  JAX dry-run): every storage an op creates counts from its creation until
  the last tensor over it dies.

``repeat(n)`` multiplies what runs inside it by ``n``, as ``hlo_static``
multiplies a ``while`` body by its trip count: the dry-run traces one
microbatch and counts it as all of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpAnalysis", "OpStats", "COLLECTIVE_KINDS"]

#: functional-collective op name → the JAX analyzer's kind
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "wait_tensor", "device", "lift_fresh", "detach", "alias"}


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    bytes: float = 0.0
    op_flops: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    op_bytes: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    op_census: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    peak_bytes: int = 0

    def to_json(self) -> Dict:
        coll = {k: v for k, v in self.collective_bytes.items() if v}
        coll["total"] = sum(coll.values())
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": coll,
            "op_flops": dict(sorted(self.op_flops.items(), key=lambda kv: -kv[1])),
            "op_bytes": dict(sorted(self.op_bytes.items(), key=lambda kv: -kv[1])),
            "op_census": dict(self.op_census),
            "peak_bytes": self.peak_bytes,
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpAnalysis(TorchDispatchMode):
    """Counts the local aten ops run under it (see the module docstring).
    ``counting=False`` (``setup()``) tracks memory only, for the state a
    step starts from."""

    def __init__(self) -> None:
        super().__init__()
        self.stats = OpStats()
        self._mult = 1.0
        self._counting = True
        self._live: Dict[int, int] = {}  # storage key → live tensors over it
        self._size: Dict[int, int] = {}  # storage key → bytes
        self._seen: Dict[int, int] = {}  # id(tensor) → storage key
        self.live_bytes = 0
        self._in_meta = 0
        self._restore = None

    # ---------------------------------------------------------------- scopes
    @contextlib.contextmanager
    def setup(self) -> Iterator[None]:
        """Memory is tracked, nothing counted (building the step's state)."""
        prev, self._counting = self._counting, False
        try:
            yield
        finally:
            self._counting = prev

    @contextlib.contextmanager
    def scaled(self, n: float) -> Iterator[None]:
        prev, self._mult = self._mult, self._mult * n
        try:
            yield
        finally:
            self._mult = prev

    def repeat(self, n: int):
        """A ``micro_loop`` for ``make_train_step(...).eager``: runs the
        body once, counted ``n`` times."""
        with self.scaled(n):
            yield 0

    def __enter__(self):
        # DTensor propagates each new op's sharding by running it once on
        # fake global tensors; that is bookkeeping, not the rank's work
        from torch.distributed.tensor import DTensor

        prop = DTensor._op_dispatcher.sharding_propagator
        orig = prop._propagate_tensor_meta_non_cached

        def propagate(op_schema):
            self._in_meta += 1
            try:
                return orig(op_schema)
            finally:
                self._in_meta -= 1

        prop._propagate_tensor_meta_non_cached = propagate
        self._restore = lambda: delattr(prop, "_propagate_tensor_meta_non_cached")
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._restore is not None:
                self._restore()
                self._restore = None

    # ---------------------------------------------------------------- memory
    def _register(self, t: torch.Tensor) -> None:
        if id(t) in self._seen or t.device.type == "meta":  # shapes only
            return
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        self._seen[id(t)] = key
        if key not in self._live:
            self._live[key] = 0
            self._size[key] = st.nbytes()
            self.live_bytes += self._size[key]
            self.stats.peak_bytes = max(self.stats.peak_bytes, self.live_bytes)
        self._live[key] += 1
        weakref.finalize(t, self._release, id(t), key)

    def _release(self, tid: int, key: int) -> None:
        self._seen.pop(tid, None)
        self._live[key] -= 1
        if self._live[key] == 0:
            del self._live[key]
            self.live_bytes -= self._size.pop(key)

    # -------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it and sends its local ops back
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._in_meta:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._register(t)
        if not self._counting:
            return out
        packet = func._overloadpacket
        name = packet._qualified_op_name.replace("::", ".")
        short = name.split(".", 1)[1]
        m = self._mult
        st = self.stats
        st.op_census[name] += m
        kind = COLLECTIVE_KINDS.get(short)
        if kind is not None:
            st.collective_bytes[kind] += m * sum(_nbytes(t) for t in outs)
            return out
        if func.is_view or short in _NO_TRAFFIC:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        nbytes = m * (sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        st.bytes += nbytes
        st.op_bytes[name] += nbytes
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(packet)
        if formula is not None:
            flops = m * formula(*args, **kwargs, out_val=out)
            st.flops += flops
            st.op_flops[name] += flops
        return out
