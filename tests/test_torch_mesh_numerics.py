"""The port on a real multi-rank mesh against the unsharded port, on the CPU.

Four ``gloo`` ranks are spawned once (a ``FileStore`` under ``tmp_path``, so
no fixed port under xdist), and each builds the meshes (2, 2) and (1, 4)
over ("data", "model"). For ``tiny()`` granite-moe-1b, qwen2.5-3b and
falcon-mamba-7b, under the default rules and under ``attn_seq="model"``
(the attention interior sharded by sequence), the same seeded weights
(``Model.init`` fills each parameter whole, then shards it) give, against
the unsharded port on the same inputs, within 1e-5:

* prefill logits, with the plain composition and with the kernel path
  (its plain version here: the ``local_map`` call, declared placements and
  KV-head slicing are the same as on the card);
* ``loss_fn``;
* every parameter's gradient (the AdamW clip norm included) and the
  parameters after one ``make_train_step`` (the default AdamW).

On (1, 4) the tiny models' 2 KV heads stay replicated while their 4 query
heads are sharded: the kernel path reads this rank's KV slice. A decode
case runs granite's prefill and three decode steps with the KV cache
sharded over its sequence (``cache_seq="model"``). The unsharded port is
itself held to the JAX package by the other ``test_torch_*`` files.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.distributed import PartitionSpec, spec_to_placements

torch.set_num_threads(1)

ARCHS = ["granite-moe-1b-a400m", "qwen2.5-3b", "falcon-mamba-7b"]
MESHES = [(2, 2), (1, 4)]
TOL = 1e-5


def _dmax(sharded, whole) -> float:
    from torch.distributed.tensor import DTensor

    if isinstance(sharded, DTensor):
        sharded = sharded.full_tensor()
    return float((sharded.detach() - whole.detach()).abs().max())


def _worker(rank: int, world: int, store_path: str, out_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, tiny
    from repro_torch.distributed import ShardingRules
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.train_step import _grads, train_state_of

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    res = {}
    try:
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            for arch in ARCHS:
                cfg = tiny(get_config(arch))
                rng = np.random.default_rng(0)
                ids = rng.integers(0, cfg.vocab_size, (4, 16))
                batch = {"inputs": ids, "labels": rng.integers(0, cfg.vocab_size, (4, 16))}
                for rules in (ShardingRules(), ShardingRules(attn_seq="model")):
                    key = f"{shape[0]}x{shape[1]}/{arch}/{rules.attn_seq or 'default'}"
                    ref = build_model(cfg, impl="torch", device="cpu").init(3)
                    shd = build_model(cfg, impl="torch", device="cpu", rules=rules,
                                      mesh=mesh).init(3)
                    d = {}
                    for impl in ("torch", "kernel"):
                        ref.impl = shd.impl = impl
                        d[f"prefill_{impl}"] = _dmax(shd.prefill(ids, 20)[0], ref.prefill(ids, 20)[0])
                    ref.impl = shd.impl = "torch"
                    with torch.no_grad():
                        d["loss"] = _dmax(shd.loss_fn(batch)[0], ref.loss_fn(batch)[0])
                    opt = AdamWConfig()
                    s0, s1 = train_state_of(ref, opt), train_state_of(shd, opt)
                    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
                    g0 = _grads(ref, list(s0.params.values()), tb)[2]
                    g1 = _grads(shd, list(s1.params.values()), tb)[2]
                    d["grads"] = max(_dmax(b, a) for a, b in zip(g0, g1))
                    _, m0 = make_train_step(ref, opt)(s0, batch)
                    _, m1 = make_train_step(shd, opt)(s1, batch)
                    d["grad_norm"] = _dmax(m1["grad_norm"], m0["grad_norm"])
                    d["params"] = max(_dmax(s1.params[k], s0.params[k]) for k in s0.params)
                    res[key] = d
            if shape == (1, 4):
                cfg = tiny(get_config("granite-moe-1b-a400m"))
                ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
                ref = build_model(cfg, impl="torch", device="cpu").init(5)
                shd = build_model(cfg, impl="torch", device="cpu",
                                  rules=ShardingRules(cache_seq="model"), mesh=mesh).init(5)
                l0, c0 = ref.prefill(ids, 24)
                l1, c1 = shd.prefill(ids, 24)
                d = {"prefill": _dmax(l1, l0)}
                tok = l0.argmax(-1)
                for t in range(16, 19):
                    l0, c0 = ref.decode_step(c0, tok, t)
                    l1, c1 = shd.decode_step(c1, tok, t)
                    d[f"decode_{t}"] = _dmax(l1, l0)
                    tok = l0.argmax(-1)
                d["cache_placements"] = str(c1[0][0].placements)
                res["1x4/decode/cache_seq"] = d
    finally:
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh")
    out = tmp / "out.json"
    mp.start_processes(_worker, args=(4, str(tmp / "store"), str(out)), nprocs=4,
                       start_method="spawn")
    return json.loads(out.read_text())


CASES = [f"{m[0]}x{m[1]}/{a}/{r}" for m in MESHES for a in ARCHS for r in ("default", "model")]


@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_unsharded(results, case):
    d = results[case]
    assert set(d) == {"prefill_torch", "prefill_kernel", "loss", "grads", "grad_norm", "params"}
    for key, val in d.items():
        assert val <= TOL, (case, key, val)


def test_decode_over_a_sequence_sharded_cache(results):
    d = results["1x4/decode/cache_seq"]
    assert "Shard(dim=1)" in d.pop("cache_placements")
    assert len(d) == 4
    for key, val in d.items():
        assert val <= TOL, (key, val)


def test_out_of_order_tuple_is_refused():
    """("data", "pod") on one dim is data-major in JAX; DTensor would shard
    it pod-major, so the port refuses it rather than shard it another way."""
    with pytest.raises(ValueError, match="out of the mesh's order"):
        spec_to_placements(PartitionSpec(("data", "pod"), "model"),
                           {"pod": 2, "data": 2, "model": 2})
    from torch.distributed.tensor import Shard

    assert spec_to_placements(PartitionSpec(("pod", "data"), "model"),
                              {"pod": 2, "data": 2, "model": 2}) == (Shard(0), Shard(0), Shard(1))
