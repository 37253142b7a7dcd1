"""The manifest and every file it names load, and keep to the contract's
shapes."""

import json
import re

import pytest

from amt_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.manifest()


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    entry, workload, conf = harness.cell_files(cell, BENCH)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert (harness.BENCH / "runners" / f"{workload['runner']}.py").is_file()
    assert conf["name"] == entry["config"]
    assert (harness.ROOT / conf["reference"]).is_file()
    e2e = {m["name"] for m in harness.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.metrics_of(BENCH, cell, True)
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert m["moves"] in e2e, f"{cell} reports {m['name']} but not {m['moves']}"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_module("metrics", metric).read)


def test_config_files_are_the_manifests():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        conf = harness.load_json(harness.ROOT / c["file"])
        assert conf["reduced"] == c["reduced"]
