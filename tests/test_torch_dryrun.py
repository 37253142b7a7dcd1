"""The port's dry-run, hill-climb tables and op analysis against the JAX
package's, on the CPU.

* ``eligible`` / ``SKIP_LONG500K`` and ``hillclimb.CELLS`` (names, cells,
  variants in order, the configs they make and their rules) equal to the
  reference's. Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
  host devices; ``monkeypatch`` restores the environment afterwards, so no
  later subprocess of the worker inherits it.
* ``op_analysis.OpAnalysis`` on the three programs of
  ``tests/test_sharding.py::TestHLOStatic`` (a 64×128×32 matmul, a 17-step
  loop, a 5×3 nested loop): FLOPs equal to the exact analytic count, and to
  JAX's ``analyze_hlo`` within that test's own rel tolerance; and a DTensor
  matmul on a fake 16×16 mesh, counted by hand: per-device FLOPs global/256,
  one all-reduce and one all-gather of known bytes.
* ``lower_cell`` on ``tiny()`` granite-moe on a fake (2, 2) mesh for train,
  prefill and decode in a subprocess (a process has one default group):
  status OK, and the train cell traced one microbatch and multiplied gives
  the full trace's counts exactly. The CLI runs with ``--device cpu``.
* The meshes refuse to be made without a process group of their size.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_static import analyze_hlo
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.op_analysis import OpAnalysis
from _twin_config import reference_fields

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}


@pytest.fixture
def jax_launch(monkeypatch):
    """The reference's dry-run and hill-climb modules, their XLA_FLAGS
    setting undone after the test."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    if "XLA_FLAGS" not in os.environ or not os.environ["XLA_FLAGS"]:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    import repro.launch.dryrun as j_dryrun
    import repro.launch.hillclimb as j_hillclimb

    return j_dryrun, j_hillclimb


# -------------------------------------------------------------------- tables
def test_eligible_matches_jax(jax_launch):
    j_dryrun, _ = jax_launch
    assert dryrun.SKIP_LONG500K == j_dryrun.SKIP_LONG500K
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import list_archs as j_list_archs

    for arch in j_list_archs():
        for shape in J_SHAPES:
            assert dryrun.eligible(arch, shape) == j_dryrun.eligible(arch, shape)


def test_hillclimb_cells_match_jax(jax_launch):
    _, j_hill = jax_launch
    from repro.configs import get_config as j_get_config

    assert list(hillclimb.CELLS) == list(j_hill.CELLS)
    for key, (arch, shape, variants) in hillclimb.CELLS.items():
        j_arch, j_shape, j_variants = j_hill.CELLS[key]
        assert (arch, shape) == (j_arch, j_shape)
        assert [v[0] for v in variants] == [v[0] for v in j_variants]
        for (name, fn, rules), (_, j_fn, j_rules) in zip(variants, j_variants):
            cfg = fn(get_config(arch)) if fn else get_config(arch)
            j_cfg = j_fn(j_get_config(arch)) if j_fn else j_get_config(arch)
            assert reference_fields(cfg) == dataclasses.asdict(j_cfg), (key, name)
            assert (rules is None) == (j_rules is None)
            if rules is not None:
                assert dataclasses.asdict(rules) == dataclasses.asdict(j_rules)


def test_unroll_variants_are_skipped(tmp_path):
    hillclimb.run_cell("recurrentgemma", str(tmp_path), device="cpu")
    rec = json.loads((tmp_path / "recurrentgemma-9b__train_4k__unroll32.json").read_text())
    assert rec["status"] == "SKIP" and rec["reason"] == hillclimb.UNROLL_SKIP


# --------------------------------------------------------------- op analysis
def _hlo(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


def test_matmul_flops():
    want = 2 * 64 * 128 * 32
    x, y = torch.zeros(64, 128), torch.zeros(128, 32)
    with OpAnalysis() as a:
        x @ y
    assert a.stats.flops == want
    j = _hlo(lambda x, y: x @ y, jnp.zeros((64, 128)), jnp.zeros((128, 32)))
    assert a.stats.flops == pytest.approx(j.flops, rel=0.2)
    assert a.stats.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert a.stats.op_census == {"aten.mm": 1}
    assert a.stats.peak_bytes == 64 * 32 * 4


def test_loop_trip_count_multiplies():
    want = 17 * 2 * 64**3
    a_ = torch.zeros(64, 64)
    with OpAnalysis() as full:
        c = a_
        for _ in range(17):
            c = c @ a_
    with OpAnalysis() as once:
        c = a_
        for _ in once.repeat(17):
            c = c @ a_
    assert full.stats.flops == once.stats.flops == want

    def f(a):
        def body(c, _):
            return c @ a, None

        return jax.lax.scan(body, a, None, length=17)[0]

    assert full.stats.flops == pytest.approx(_hlo(f, jnp.zeros((64, 64))).flops, rel=0.25)


def test_nested_loops_multiply():
    want = 15 * 2 * 32**3
    a_ = torch.zeros(32, 32)
    with OpAnalysis() as an:
        c = a_
        for _ in an.repeat(3):
            for _ in an.repeat(5):
                c = c @ a_
    assert an.stats.flops == want

    def f(a):
        def outer(c, _):
            def inner(ci, _):
                return ci @ a, None

            return jax.lax.scan(inner, c, None, length=5)[0], None

        return jax.lax.scan(outer, a, None, length=3)[0]

    assert an.stats.flops == pytest.approx(_hlo(f, jnp.zeros((32, 32))).flops, rel=0.3)


def test_dtensor_matmul_counted_per_device():
    """(256, 2048) sharded [Shard(0), Shard(1)] times (2048, 4096) sharded
    [Replicate(), Shard(0)] on a fake 16×16 mesh: each rank multiplies
    (16, 128)·(128, 4096) — the global FLOPs over 256 — into a partial sum,
    which one all-reduce over "model" and one all-gather over "data" make
    whole: result bytes (16, 4096) and (256, 4096) in float32."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dist.init_process_group("fake", rank=0, world_size=256)
    try:
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(16, 128), mesh, [Shard(0), Shard(1)])
            w = DTensor.from_local(torch.empty(128, 4096), mesh, [Replicate(), Shard(0)])
            with OpAnalysis() as a:
                y = (x @ w).redistribute(mesh, [Replicate(), Replicate()])
            assert tuple(y.to_local().shape) == (256, 4096)
    finally:
        dist.destroy_process_group()
    assert a.stats.flops == 2 * 256 * 2048 * 4096 / 256
    coll = a.stats.to_json()["collective_bytes"]
    assert coll == {"all-reduce": 16 * 4096 * 4, "all-gather": 256 * 4096 * 4,
                    "total": 16 * 4096 * 4 + 256 * 4096 * 4}


# ------------------------------------------------------------------ dry-run
_CELLS = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config, tiny
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import lower_cell
cfg = tiny(get_config("granite-moe-1b-a400m"))
out = {}
for kind in ("train", "prefill", "decode"):
    r = lower_cell("granite-moe-1b-a400m", "tiny", cfg_override=cfg, mesh_shape=(2, 2),
                   shape=ShapeConfig("tiny", 16, 8, kind), device="cpu")
    out[kind] = {k: r[k] for k in ("status", "chips", "mesh", "param_bytes", "flops", "bytes",
                                   "collective_bytes", "device_bytes_estimate", "fits_hbm")}
cfg2 = dataclasses.replace(cfg, microbatches=2)
for name, rep in (("once", True), ("full", False)):
    r = lower_cell("granite-moe-1b-a400m", "tiny", cfg_override=cfg2, mesh_shape=(2, 2),
                   shape=ShapeConfig("tiny", 16, 8, "train"), device="cpu", micro_repeat=rep)
    out[name] = {k: r[k] for k in ("microbatches", "flops", "bytes", "collective_bytes",
                                   "op_census", "op_bytes", "op_flops")}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def tiny_cells():
    proc = subprocess.run([sys.executable, "-c", _CELLS], capture_output=True, text=True,
                          env=ENV, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_tiny_cell_traces(tiny_cells, kind):
    r = tiny_cells[kind]
    assert r["status"] == "OK" and r["chips"] == 4 and r["mesh"] == "2x2"
    assert r["flops"] > 0 and r["bytes"] > 0 and r["collective_bytes"]["total"] > 0
    assert 0 < r["param_bytes"] < r["device_bytes_estimate"] and r["fits_hbm"]


def test_one_microbatch_multiplied_is_the_full_trace(tiny_cells):
    once, full = tiny_cells["once"], tiny_cells["full"]
    assert once["microbatches"] == full["microbatches"] == 2
    for key in ("flops", "bytes", "collective_bytes", "op_census", "op_bytes", "op_flops"):
        assert once[key] == full[key], key


def test_cli_runs_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu", "--arch",
         "granite-moe-1b-a400m", "--shape", "long_500k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[SKIP] granite-moe-1b-a400m × long_500k (16x16)" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu", "--arch",
         "granite-moe-1b-a400m", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((tmp_path / "granite-moe-1b-a400m__decode_32k__pod1.json").read_text())
    assert rec["status"] == "OK" and rec["chips"] == 256 and rec["rules"] == {"cache_seq": "model"}
    assert rec["device"] == "cpu" and rec["target"] == "h100-sxm"


def test_meshes_need_a_group_of_their_size():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        make_local_mesh("cpu")
