"""Whole runs on the CPU at small sizes (the harness's look for a card
skipped), and what a run refuses."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from amt_bench import harness
from bench_sizes import ENGINE, ENGINE_CONF, ONE_JOB

ROOT = harness.ROOT
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, trace, seconds=3.0):
    from amt_bench import run

    return run.run_cell(name, 2**31 + 123, seconds, trace, device="cpu", overrides=ENGINE,
                        conf_overrides=ENGINE_CONF)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    result, checks = _run("amt-xgb6.shared8", trace)
    keys = list(result)
    assert keys[:5] == REQUIRED
    assert keys[-1] == "checks"
    assert set(keys) <= set(REQUIRED) | {"breakdown", "setup_parts", "check_s", "checks"}
    assert result["correct"] is True and result["attempted"] > 0
    group = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.manifest()[group]}
    assert set(result["metrics"]) <= names
    if not trace:
        assert {"decision_p50_ms", "decision_p95_ms", "setup_s"} == set(result["metrics"])
    for c in checks:
        assert result["checks"][c[0]] == {"value": c[1], "limit": c[2]}


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "amt_bench/run.py", "--workload", "amt-xgb6.shared8",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_bare_checkout_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "amt_bench", tmp_path / "amt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "amt_bench/run.py", "--workload", "amt-xgb6.shared8",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(ROOT / 'amt_bench/tests')!r}]\n"
        "from bench_sizes import ENGINE, ENGINE_CONF\n"
        "from amt_bench import run, harness\n"
        "run.run_cell('amt-xgb6.shared8', 7, 2.0, False, device='cpu', overrides=ENGINE,"
        " conf_overrides=ENGINE_CONF)\n"
        "print(json.dumps(harness.loaded_forbidden()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_reference_and_inputs_import_nothing_of_the_program():
    for folder in ("reference", "inputs"):
        for path in (ROOT / "amt_bench" / folder).glob("*.py"):
            tree = ast.parse(path.read_text())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                for n in names:
                    assert n.split(".")[0] not in ("repro_torch", "repro", "jax", "jaxlib",
                                                   "flax"), f"{path.name} imports {n}"


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A throwaway cell (another traffic file) and a throwaway per-layer
    metric (another reader) run with no edit to an existing file."""
    shutil.copytree(ROOT / "amt_bench", tmp_path / "amt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    before = {p: p.read_bytes() for p in (tmp_path / "amt_bench").rglob("*") if p.is_file()}
    bench = harness.manifest()
    bench["workloads"].append({"name": "amt-xgb6.job2", "config": "amt-xgb6",
                               "traffic": "job2", "chips": 1, "why": "two in flight"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "amt-xgb6.shared8" in m["workloads"]:
            m["workloads"].append("amt-xgb6.job2")
    bench["per_layer"].append({"name": "decision_max_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "device",
                               "moves": "decision_p95_ms", "workloads": ["amt-xgb6.job2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    job2 = json.loads((ROOT / "amt_bench/workloads/amt-xgb6.shared8.json").read_text())
    job2.update(ONE_JOB, in_flight=2)
    (tmp_path / "amt_bench/workloads/amt-xgb6.job2.json").write_text(json.dumps(job2))
    (tmp_path / "amt_bench/metrics/decision_max_ms.py").write_text(
        "def read(rec):\n    return max(s['dur'] for s in rec['tracer'].spans"
        " if s['name'] == 'suggest.decide') * 1e3\n")
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(tmp_path / 'src')!r},"
        f" {str(ROOT / 'amt_bench/tests')!r}]\n"
        "from bench_sizes import ENGINE, ENGINE_CONF\n"
        "from amt_bench import run\n"
        "res, _ = run.run_cell('amt-xgb6.job2', 3, 3.0, True, device='cpu', overrides=ENGINE,"
        " conf_overrides=ENGINE_CONF)\n"
        "print(json.dumps(res))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["decision_max_ms"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_a_reader_that_loads_the_jax_package_fails_the_run(tmp_path):
    """The look for JAX comes last, after the metric readers and the
    reference: a throwaway per-layer metric whose reader imports the JAX
    package leaves the run without a result."""
    shutil.copytree(ROOT / "amt_bench", tmp_path / "amt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    bench = harness.manifest()
    bench["per_layer"].append({"name": "loads_jax", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "device",
                               "moves": "decision_p50_ms", "workloads": ["amt-xgb6.shared8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "amt_bench/metrics/loads_jax.py").write_text(
        "def read(rec):\n    import repro  # noqa: F401\n    return 1.0\n")
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(tmp_path / 'src')!r},"
        f" {str(ROOT / 'amt_bench/tests')!r}]\n"
        "from bench_sizes import ENGINE, ENGINE_CONF\n"
        "from amt_bench import run\n"
        "res, _ = run.run_cell('amt-xgb6.shared8', 3, 2.0, True, device='cpu', overrides=ENGINE,"
        " conf_overrides=ENGINE_CONF)\n"
        "print(json.dumps(res))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path)
    assert proc.returncode == 4, proc.stderr[-2000:]
    assert proc.stdout.strip() == "" and "repro" in proc.stderr
