"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) on DTensor.

Model code names every parameter and activation axis with a *logical*
name ("vocab", "embed", "ffn", "heads", "experts", "batch", "seq", ...).
This module maps logical names onto the axes of a ``DeviceMesh``, as the
JAX package's ``repro.distributed.sharding`` maps them onto a JAX mesh:

    batch   → ("pod", "data")   data parallelism (pod = an extra DP axis)
    vocab/heads/ffn/experts → "model"   tensor / expert parallelism
    embed   → "data" when fsdp  ZeRO-3-style parameter sharding: a matrix
                                product gathers the weight's shards first
    seq     → "model" when sequence_parallel (a hill-climb lever)

The mapping is *capacity-aware*: a logical dim is sharded only if its size
is divisible by the product of the mapped mesh axes (kv_heads=4 on a
16-way model axis stays replicated rather than failing).

Torch has no ``PartitionSpec``; the port keeps one of its own, a tuple of
entries (None, an axis name, or a tuple of axis names) that compares entry
by entry with JAX's. ``spec_to_placements`` turns it into DTensor
placements, one a mesh dim. A ``mesh`` is a ``DeviceMesh`` (sizes from its
``mesh_dim_names``) or a plain ``{axis: size}`` mapping, so shape math needs
no process group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "PartitionSpec",
    "mesh_shape",
    "logical_to_spec",
    "spec_to_placements",
    "shard_shape",
    "tree_specs_to_shardings",
]

MeshAxes = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis name → mesh axis (or tuple of axes)."""

    batch: MeshAxes = ("pod", "data")
    seq: MeshAxes = None  # residual-stream seq axis; "model" = sequence parallel
    attn_seq: MeshAxes = None  # attention/MLP-interior seq axis (stays TP)
    embed: MeshAxes = None  # activations' d_model axis stays unsharded
    fsdp: MeshAxes = "data"  # weight sharding axis (ZeRO-3); None disables
    vocab: MeshAxes = "model"
    heads: MeshAxes = "model"
    kv_heads: MeshAxes = "model"
    ffn: MeshAxes = "model"
    experts: MeshAxes = "model"
    expert_ffn: MeshAxes = None  # per-expert hidden dim (usually small)
    head_dim: MeshAxes = None
    conv: MeshAxes = None
    state: MeshAxes = None
    inner: MeshAxes = "model"  # mamba/rglru expanded inner dim
    stack: MeshAxes = None  # the JAX package's scanned layer-stack axis
    cache_seq: MeshAxes = None  # KV-cache sequence axis

    def resolve(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        if not hasattr(self, logical):
            raise KeyError(f"unknown logical axis {logical!r}")
        return getattr(self, logical)


DEFAULT_RULES = ShardingRules()


class PartitionSpec(tuple):
    """Per-tensor-dim mesh axes: None, an axis name, or a tuple of names
    (major to minor). Trailing Nones are dropped by ``logical_to_spec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a plain mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names to map logical axes")
    return dict(zip(names, mesh.shape))


def _axes_size(mesh_axes: MeshAxes, shape: Mapping[str, int]) -> int:
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    size = 1
    for a in mesh_axes:
        size *= shape.get(a, 1)
    return size


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    rules: ShardingRules,
    mesh,
) -> PartitionSpec:
    """Translate per-dim logical names into a PartitionSpec, dropping any
    mapping whose mesh-axis product does not divide the dim size, any mesh
    axis not present in ``mesh`` and any mesh axis already used by an
    earlier dim."""
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    sizes = mesh_shape(mesh)
    entries: List[Any] = []
    used: set = set()
    for name, dim in zip(logical_axes, shape):
        mapped = rules.resolve(name)
        if isinstance(mapped, str):
            mapped = (mapped,)
        if mapped is not None:
            mapped = tuple(a for a in mapped if a in sizes and a not in used)
            if not mapped:
                mapped = None
        if mapped is None or dim % _axes_size(mapped, sizes) != 0:
            entries.append(None)
        else:
            entries.append(mapped if len(mapped) > 1 else mapped[0])
            used.update(mapped)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def spec_to_placements(spec: Sequence[Any], mesh) -> Tuple[Any, ...]:
    """DTensor placements, one a mesh dim, for ``spec``: ``Shard(i)`` on the
    mesh dims that tensor dim ``i`` is sharded over, ``Replicate()`` on the
    rest — and on a mesh dim of size 1, where the two hold the same data and
    a replica spares DTensor's view rules a shard to carry. A tuple entry
    shards its tensor dim over several mesh axes, major to minor; DTensor
    orders such shards by the mesh's own dim order, so a tuple out of that
    order is refused rather than sharded another way."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    names = list(sizes)
    placements: List[Any] = [Replicate()] * len(names)
    used: set = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} of {spec!r} is not in the mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"{spec!r} shards dim {dim} over {axes}, out of the mesh's order "
                f"{tuple(names)}: DTensor would shard it minor to major"
            )
        for i in idx:
            if i in used:
                raise ValueError(f"mesh axis {names[i]!r} used twice in {spec!r}")
            used.add(i)
            if sizes[names[i]] > 1:
                placements[i] = Shard(dim)
    return tuple(placements)


def shard_shape(shape: Sequence[int], spec: Sequence[Any], mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor placed by
    ``spec`` (``NamedSharding(mesh, spec).shard_shape`` in JAX)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = _axes_size(entry, sizes)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide over {entry!r}")
        out[dim] //= n
    return tuple(out)


def tree_specs_to_shardings(spec_tree: Any, mesh) -> Any:
    """Map a (nested dict / list) tree of PartitionSpecs to DTensor
    placements on ``mesh``."""
    if isinstance(spec_tree, PartitionSpec):
        return spec_to_placements(spec_tree, mesh)
    if isinstance(spec_tree, Mapping):
        return {k: tree_specs_to_shardings(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(tree_specs_to_shardings(v, mesh) for v in spec_tree)
    raise TypeError(f"not a spec tree: {type(spec_tree).__name__}")
