"""The port's engine-replica CLI (``python -m
repro_torch.distributed.engine_server``), a twin of
``tests/test_engine_server_cli.py``: the flags reach the hosted service's
config, the replica serves on the CUDA card unless ``--device cpu`` asks for
the CPU (with no card visible the default refuses at startup), it prints its
address on its first line as the reference's replica does, SIGINT shuts it
down cleanly, and the read-only ``metrics`` verb answers from a live
subprocess.
"""

import os
import signal
import subprocess
import sys

import pytest
import torch

from repro.distributed import engine_server as j_engine_server
import repro_torch.core as T
from repro_torch.core import telemetry
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig
from repro_torch.distributed import engine_server
from repro_torch.distributed.engine_client import RemoteService

torch.set_num_threads(1)

_CFG = T.BOConfig(
    num_init=2,
    slice_config=SliceSamplerConfig(num_samples=4, burn_in=2, thin=1),
    refit_every=3,
    incremental=True,
    backend="torch",
)


def _space():
    return T.SearchSpace([T.Continuous("x", 0.0, 1.0)])


# ------------------------------------------------------------ flag parsing


def _server_from(monkeypatch, module, argv):
    """Run ``module.main(argv)`` far enough to build the server, capturing
    it instead of serving forever."""
    built = {}

    class _Stop(Exception):
        pass

    real_init = module.EngineServer.__init__

    def spy_init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        built["server"] = self
        raise _Stop

    monkeypatch.setattr(module.EngineServer, "__init__", spy_init)
    with pytest.raises(_Stop):
        module.main(argv)
    server = built["server"]
    server._tcp.server_close()  # release the bound port
    return server


def test_defaults_match_the_reference(monkeypatch):
    server = _server_from(monkeypatch, engine_server, ["--device", "cpu"])
    ref = _server_from(monkeypatch, j_engine_server, [])
    assert engine_server.DEFAULT_LEASE_TTL == j_engine_server.DEFAULT_LEASE_TTL
    assert server.lease_ttl == ref.lease_ttl
    assert server.service.config.share_gphp is ref.service.config.share_gphp is True
    assert server.service.config.sibling_warm_start is True
    assert server.service.config.arena_budget_mb == ref.service.config.arena_budget_mb
    assert server.device == torch.device("cpu")
    assert server.service.device == torch.device("cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card refusal")
def test_default_device_is_the_card(monkeypatch):
    """Without ``--device`` the replica serves on the card; with none
    visible it refuses at startup instead of serving from the CPU."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_server.main(["--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        engine_server.EngineServer()


def test_flags_reach_the_service_config(monkeypatch):
    argv = ["--lease-ttl", "7.5", "--arena-budget-mb", "32", "--no-share-gphp",
            "--no-sibling-warm-start"]
    server = _server_from(monkeypatch, engine_server, argv + ["--device", "cpu"])
    ref = _server_from(monkeypatch, j_engine_server, argv)
    assert server.lease_ttl == ref.lease_ttl == 7.5
    assert server.service.config.arena_budget_mb == 32.0
    assert server.service.config.share_gphp is False
    assert server.service.config.sibling_warm_start is False
    assert server.service.config == T.ServiceConfig(
        arena_budget_mb=32.0, share_gphp=False, sibling_warm_start=False)


def test_telemetry_flag_enables_registry(monkeypatch):
    monkeypatch.setattr(telemetry.get(), "_enabled", False)
    _server_from(monkeypatch, engine_server, ["--telemetry", "--device", "cpu"])
    assert telemetry.enabled() is True
    telemetry.set_enabled(False)


def test_unknown_flag_is_rejected(capsys):
    with pytest.raises(SystemExit) as exc:
        engine_server.main(["--definitely-not-a-flag"])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


# --------------------------------------------------------- OS-process CLI


def _spawn_replica(extra_args=()):
    """Start a real replica subprocess on the CPU on a free port; returns
    (proc, addr), the port parsed from the first line it prints."""
    env = dict(os.environ)
    env.pop("REPRO_TELEMETRY", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (
            os.path.join(os.path.dirname(__file__), os.pardir, "src"),
            env.get("PYTHONPATH", ""),
        ) if p
    )
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.distributed.engine_server",
         "--port", "0", "--device", "cpu", *extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    )
    banner = proc.stdout.readline()
    assert "listening on" in banner, banner
    assert "device cpu" in banner
    host, port = banner.split("listening on", 1)[1].split()[0].rsplit(":", 1)
    return proc, (host, int(port))


def test_clean_startup_and_sigint_shutdown():
    proc, _addr = _spawn_replica()
    try:
        assert proc.poll() is None  # serving
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=20)
    assert rc in (0, -signal.SIGINT)


def test_metrics_verb_from_live_subprocess_replica():
    """Register and drive a job on a ``--telemetry`` replica process, then
    read its live counters back through the metrics verb."""
    proc, addr = _spawn_replica(["--telemetry"])
    try:
        rsvc = RemoteService([addr])
        rh = rsvc.register_job("job", _space(), bo_config=_CFG, seed=1)
        for i in range(3):
            cfg = rh.suggest_batch(1)[0]
            rh.store.mark_pending(i, cfg)
            rh.store.clear_pending(i)
            rh.store.push(cfg, float(cfg["x"]))
        rsvc.fetch_metrics(addr)  # counted after its reply goes out,
        dump = rsvc.fetch_metrics(addr)  # so fetch twice to see it
        rh.close()
        counters = dump["metrics"]["counters"]
        assert dump["metrics"]["enabled"] is True
        assert counters["server.rpc.register"] == 1
        assert counters["server.rpc.suggest_batch"] == 3
        assert counters["server.rpc.metrics"] >= 1
        assert dump["metrics"]["histograms"]["span.rpc.suggest_batch"]["count"] == 3
        assert dump["service_stats"]["groups"][0]["jobs"] == ["job"]
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=20)


def test_metrics_verb_off_replica_reports_disabled():
    proc, addr = _spawn_replica()
    try:
        dump = RemoteService([addr]).fetch_metrics(addr)
        assert dump["metrics"]["enabled"] is False
        assert dump["metrics"]["counters"] == {}
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=20)
