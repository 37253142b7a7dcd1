"""The port's sharding rules and specs against the JAX package's, on the CPU.

* ``logical_to_spec``: the four cases of ``tests/test_sharding.py::
  TestLogicalToSpec`` and a seeded sweep over logical axes, dims and mesh
  shapes, entry by entry against JAX's on an ``AbstractMesh`` (no devices).
* ``spec_to_placements``: shards major to minor in the mesh's order,
  replicas on size-1 mesh dims, a tuple out of the mesh's order refused.
* Parameter specs of every arch in the registry at full width, on the
  production meshes (16, 16) and (2, 16, 16), under ``DEFAULT_RULES`` and
  ``ShardingRules(seq="model")``: each port parameter's spec equals the JAX
  ``param_specs()`` leaf less its stack axis (``convert.lm_param_paths``),
  and the per-device parameter bytes equal the sum of JAX's
  ``NamedSharding(...).shard_shape``.
* Cache specs at the ``decode_32k`` and ``long_500k`` shapes, under the
  default rules and the dry-run's ``cache_seq="model"`` override.
* Roofline: ``count_params``, ``model_flops`` and ``roofline_terms`` (on the
  reference's v5e target) equal to JAX's for every arch × shape; the cases
  of ``TestRoofline`` on the port.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JSpec

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.distributed.sharding import ShardingRules as JRules
from repro.distributed.sharding import logical_to_spec as j_logical_to_spec
from repro.launch import roofline as j_roofline
from repro.models import build_model as j_build_model
from repro_torch import convert
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import (
    DEFAULT_RULES,
    PartitionSpec,
    ShardingRules,
    logical_to_spec,
    spec_to_placements,
)
from repro_torch.distributed.sharding import shard_shape
from repro_torch.launch import roofline
from repro_torch.models import build_model

torch.set_num_threads(1)

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"default": {}, "seq_model": {"seq": "model"}}
LOGICAL = [None, "batch", "seq", "attn_seq", "embed", "fsdp", "vocab", "heads", "kv_heads",
           "ffn", "experts", "expert_ffn", "head_dim", "inner", "cache_seq", "state"]


def _abstract(mesh):
    return AbstractMesh(tuple(mesh.values()), tuple(mesh))


def _jax_spec(spec) -> tuple:
    return tuple(spec)


# ---------------------------------------------------------------- the rules
class TestLogicalToSpec:
    """``tests/test_sharding.py::TestLogicalToSpec`` on the port (its mesh is
    (1, 1) over ("data", "model"))."""

    MESH = {"data": 1, "model": 1}

    def test_basic_mapping(self):
        spec = logical_to_spec(("fsdp", "ffn"), (128, 256), ShardingRules(), self.MESH)
        assert spec == PartitionSpec("data", "model")

    def test_divisibility_guard(self):
        spec = logical_to_spec(("batch", None), (4, 8), ShardingRules(batch=("pod", "data")),
                               self.MESH)
        assert spec == PartitionSpec("data")  # "pod" is not in the mesh

    def test_duplicate_axis_suppressed(self):
        spec = logical_to_spec(("heads", "ffn"), (16, 64),
                               ShardingRules(heads="model", ffn="model"), self.MESH)
        assert spec == PartitionSpec("model")

    def test_unknown_axis_raises(self):
        with pytest.raises(KeyError):
            logical_to_spec(("nope",), (4,), ShardingRules(), self.MESH)


@pytest.mark.parametrize("seed", range(12))
def test_logical_to_spec_sweep_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mesh = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
            {"data": 4, "model": 2}, {"data": 1, "model": 8}][seed % 4]
    pool = [None, "model", "data", ("pod", "data"), ("data", "model")]
    fields = {f.name: pool[rng.integers(len(pool))] for f in dataclasses.fields(JRules)
              if rng.random() < 0.3}
    j_rules, rules = JRules(**fields), ShardingRules(**fields)
    for _ in range(40):
        nd = int(rng.integers(1, 5))
        axes = tuple(LOGICAL[i] for i in rng.integers(len(LOGICAL), size=nd))
        dims = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 64, 128])) for _ in range(nd))
        want = j_logical_to_spec(axes, dims, j_rules, _abstract(mesh))
        got = logical_to_spec(axes, dims, rules, mesh)
        assert tuple(got) == _jax_spec(want), (axes, dims, fields, mesh)


class TestSpecToPlacements:
    def test_shards_major_to_minor_and_replicates(self):
        from torch.distributed.tensor import Replicate, Shard

        mesh = {"pod": 2, "data": 16, "model": 16}
        pl = spec_to_placements(PartitionSpec(("pod", "data"), None, "model"), mesh)
        assert pl == (Shard(0), Shard(0), Shard(2))
        assert spec_to_placements(PartitionSpec(), mesh) == (Replicate(),) * 3

    def test_size_one_axes_replicate(self):
        from torch.distributed.tensor import Replicate

        pl = spec_to_placements(PartitionSpec("data", "model"), {"data": 1, "model": 1})
        assert pl == (Replicate(), Replicate())

    def test_out_of_mesh_order_refused(self):
        with pytest.raises(ValueError, match="out of the mesh's order"):
            spec_to_placements(PartitionSpec(("data", "pod")), {"pod": 2, "data": 16, "model": 16})

    def test_absent_axis_refused(self):
        with pytest.raises(ValueError, match="not in the mesh"):
            spec_to_placements(PartitionSpec("pod"), {"data": 16, "model": 16})


# ------------------------------------------------------------ parameter specs
def _jax_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("rules_name", list(RULES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", j_list_archs())
def test_param_specs_match_jax(arch, mesh_name, rules_name):
    mesh = MESHES[mesh_name]
    j_model = j_build_model(j_get_config(arch), JRules(**RULES[rules_name]), _abstract(mesh))
    j_specs = j_model.param_specs()
    j_shapes = jax.eval_shape(lambda: j_model.init(jax.random.PRNGKey(0)))
    model = build_model(get_config(arch), impl="torch", device="cpu",
                        rules=ShardingRules(**RULES[rules_name]), mesh=mesh)
    specs = model.param_specs()
    params = dict(model.named_parameters())
    paths = convert.lm_param_paths(model.cfg, specs)
    assert len(specs) == len(params)
    port_bytes = 0
    jax_bytes = 0
    for name, (path, period) in paths.items():
        want = _jax_spec(_jax_leaf(j_specs, path))
        if period is not None:  # the stack axis leads and is never sharded
            assert want[:1] in ((), (None,)), (name, want)
            want = want[1:]
        assert tuple(specs[name]) == want, name
        p = params[name]
        port_bytes += int(np.prod(shard_shape(p.shape, specs[name], mesh))) * p.element_size()
    abstract = _abstract(mesh)
    for leaf, spec in zip(jax.tree.leaves(j_shapes),
                          jax.tree.leaves(j_specs, is_leaf=lambda x: isinstance(x, JSpec))):
        sh = NamedSharding(abstract, spec).shard_shape(leaf.shape)
        jax_bytes += int(np.prod(sh)) * leaf.dtype.itemsize
    assert port_bytes == jax_bytes


def test_qwen3_moe_bytes_per_device_on_the_pod():
    """The dry-run's sizing figure: f32 qwen3-moe-235b-a22b on 16×16."""
    model = build_model(get_config("qwen3-moe-235b-a22b"), impl="torch", device="cpu",
                        mesh=MESHES["16x16"])
    params = dict(model.named_parameters())
    total = sum(int(np.prod(shard_shape(params[n].shape, s, MESHES["16x16"]))) * 4
                for n, s in model.param_specs().items())
    assert total == 3_780_474_880


def test_param_specs_without_mesh_are_empty():
    model = build_model(get_config("granite-moe-1b-a400m"), impl="torch", device="cpu")
    assert set(model.param_specs().values()) == {PartitionSpec()}
    shapes = model.abstract_params()
    assert all(t.is_meta for t in shapes.values())
    assert shapes["embed"].shape == (49_155, 1024)


# ---------------------------------------------------------------- cache specs
@pytest.mark.parametrize("cache_seq", [None, "model"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", j_list_archs())
def test_cache_specs_match_jax(arch, shape_name, cache_seq):
    mesh = MESHES["16x16"]
    shape = SHAPES[shape_name]
    j_model = j_build_model(j_get_config(arch), JRules(cache_seq=cache_seq), _abstract(mesh))
    j_specs = j_model.cache_specs(shape.global_batch, shape.seq_len)
    model = build_model(get_config(arch), impl="torch", device="cpu",
                        rules=ShardingRules(cache_seq=cache_seq), mesh=mesh)
    specs = model.cache_specs(shape.global_batch, shape.seq_len)
    for layer, group, name, period in convert._layer_slots(model.cfg):
        want = j_specs[group][name]
        got = specs[layer]
        keys = range(len(got)) if isinstance(got, tuple) else sorted(got)
        for k in keys:
            w = _jax_spec(want[k])
            if period is not None:
                w = w[1:]
            assert tuple(got[k]) == w, (layer, k)


# ------------------------------------------------------------------ roofline
@pytest.mark.parametrize("arch", j_list_archs())
def test_roofline_matches_jax(arch):
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    assert roofline.count_params(cfg) == j_roofline.count_params(j_cfg)
    for name in SHAPES:
        mf = roofline.model_flops(cfg, SHAPES[name])
        assert mf == j_roofline.model_flops(j_cfg, J_SHAPES[name])
        args = (mf / 7.0, mf / 3.0, mf / 11.0, 256)
        got = roofline.roofline_terms(*args, cfg, SHAPES[name], hw=roofline.V5E)
        want = j_roofline.roofline_terms(*args, j_cfg, J_SHAPES[name], hw=j_roofline.V5E)
        assert got == want


class TestRoofline:
    def test_terms_and_bottleneck(self):
        out = roofline.roofline_terms(197e12, 819e9 * 2, 0.0, chips=1, hw=roofline.V5E)
        assert out["compute_s"] == pytest.approx(1.0)
        assert out["memory_s"] == pytest.approx(2.0)
        assert out["bottleneck"] == "memory"

    def test_h100_is_the_default_target(self):
        out = roofline.roofline_terms(989e12, 3.35e12 * 3, 450e9, chips=1)
        assert out["compute_s"] == pytest.approx(1.0)
        assert out["memory_s"] == pytest.approx(3.0)
        assert out["collective_s"] == pytest.approx(1.0)
        assert roofline.H100_SXM.hbm_bytes == 80e9

    def test_model_flops_train_scale(self):
        mf = roofline.model_flops(get_config("qwen2.5-3b"), SHAPES["train_4k"])
        assert 1.5e16 < mf < 6e16

    def test_decode_flops_dominated_by_weights_and_cache(self):
        mf = roofline.model_flops(get_config("qwen2.5-3b"), SHAPES["decode_32k"])
        assert 5e11 < mf < 5e12

    def test_moe_active_params(self):
        c = roofline.count_params(get_config("qwen3-moe-235b-a22b"))
        assert c["total"] > 2.0e11
        assert c["active"] < 0.15 * c["total"]

    def test_granite_train_shape_flops(self):
        """The phase-11 (q) sizing figure: granite at 16 × 1024 tokens."""
        from repro_torch.configs.base import ShapeConfig

        mf = roofline.model_flops(get_config("granite-moe-1b-a400m"),
                                  ShapeConfig("train_1k", 1024, 16, "train"))
        assert mf == pytest.approx(4.4613e13, rel=1e-4)


def test_default_rules_are_the_reference_defaults():
    assert dataclasses.asdict(DEFAULT_RULES) == dataclasses.asdict(JRules())
