"""Production mesh construction on the current process group.

A FUNCTION, not a module-level constant, so importing this module touches
no process group. Both meshes go through ``init_device_mesh`` over the
default group, which must already hold exactly the mesh's ranks.

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model") — the
"pod" axis is an extra data-parallel dimension inside one trial; across
trials it is the AMT slot pool (each pod evaluates a different HP config).

No mesh is ever made smaller quietly: with no group, or one of another
size, these raise and say how to get one (the dry-run starts a ``fake``
group of the production size; ``chip_smoke.py`` a one-rank NCCL group).
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_local_mesh", "PRODUCTION_SHAPES"]

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def _world(expected) -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        need = f"world size {expected}" if expected else "a process group"
        raise RuntimeError(
            f"no process group: start one of {need} first with "
            "torch.distributed.init_process_group (the dry-run uses the 'fake' "
            "backend after importing torch.testing._internal.distributed.fake_pg; "
            "one card uses 'nccl' with world_size=1)"
        )
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    n = shape[0] * shape[1] * (shape[2] if len(shape) > 2 else 1)
    world = _world(n)
    if world != n:
        raise RuntimeError(
            f"the production mesh {shape} needs a process group of {n} ranks, and "
            f"this one has {world}: start a group of world size {n} (the dry-run's "
            "'fake' backend does so without devices)"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(device_type: str = "cuda"):
    """(world size, 1) mesh, axes ("data", "model"), over the current group:
    a one-rank group gives the (1, 1) mesh on which every constraint and
    kernel call of a sharded model runs live on one card."""
    world = _world(None)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (world, 1), mesh_dim_names=("data", "model"))
