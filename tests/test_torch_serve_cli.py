"""quorum-serve of the port (`python -m quorum_tpu_torch.cli.serve`) on the
CPU: JAX's option surface plus `--device`, the refusals (`--ingest`
names ROADMAP Queue 1 item 8), a real in-process server over the golden
database answering the offline CLI's bytes with `engine_compiles` flat
after the warmup, the resilience flags' meta and counters, a SIGTERM
drain in a subprocess whose final document tools/metrics_check.py
accepts as a serve document, and the `quorum-serve-bench` metric lines
valid under the bench-line schema of both packages."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import contextlib
import importlib.util
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from quorum_tpu.cli import serve as jserve_cli
from quorum_tpu.telemetry import schema as jschema
import quorum_tpu_torch.serve as tserve
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import serve as tserve_cli
from quorum_tpu_torch.serve.client import ServeClient, bench_main
from quorum_tpu_torch.telemetry import contract, export
from quorum_tpu_torch.telemetry import registry_for, schema

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = os.path.join(ROOT, "tests", "golden", "reads.fastq")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _quiet_run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return main(argv)


def _wait_up(port, timeout=60.0):
    client = ServeClient(port=port)
    deadline = time.perf_counter() + timeout
    while True:
        try:
            return client.healthz()
        except OSError:
            assert time.perf_counter() < deadline, "server never came up"
            time.sleep(0.05)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The port's golden database and its offline -p 4 bytes."""
    d = tmp_path_factory.mktemp("serve_cli")
    db = str(d / "db.jf")
    assert _quiet_run(tcdb_cli.main, [
        "-s", "64k", "-m", "13", "-b", "7", "-q", "38", "--device", "cpu",
        "-o", db, READS]) == 0
    out = str(d / "off")
    assert _quiet_run(tec_cli.main, [
        "-p", "4", "--device", "cpu", "--batch-size", "256", db, READS,
        "-o", out]) == 0
    with open(out + ".fa") as f, open(out + ".log") as g:
        return {"db": db, "fa": f.read(), "log": g.read(), "dir": str(d)}


def _surface(parser):
    return {tuple(a.option_strings) or (a.dest,): (a.dest, a.default,
                                                   a.nargs)
            for a in parser._actions}


def test_option_surface_is_jax_plus_device():
    j = _surface(jserve_cli.build_parser())
    t = _surface(tserve_cli.build_parser())
    assert t.pop(("--device",)) == ("device", "cuda", None)
    assert t == j


@pytest.mark.parametrize("argv,needle", [
    (["--ingest", "--live-dir", "x", "--ingest-qual-thresh", "38"],
     "ROADMAP Queue 1 item 8"),
    (["--metrics-push-url", "http://localhost:9", "db"],
     "ROADMAP Queue 1 item 10"),
    (["--alert-rules", "r.json", "db"], "ROADMAP Queue 1 item 10"),
    ([], "A mer database is required"),
    (["-q", "30", "-Q", "I", "db"], "-q and -Q are conflicting"),
])
def test_refusals(capsys, argv, needle):
    assert tserve_cli.main(["--device", "cpu"] + argv) == 1
    assert needle in capsys.readouterr().err


def test_serves_the_offline_bytes_warm(golden, tmp_path):
    """A real server through cli/serve.main: byte parity with the
    offline CLI twice, `engine_compiles` unchanged by the traffic (the
    warmup saw the bucket), /metrics lint-clean, /quiesce drains and
    the final document names every serve metric."""
    port = _free_port()
    m = str(tmp_path / "serve.json")
    box = {}

    def run():
        box["rc"] = _quiet_run(tserve_cli.main, [
            "--device", "cpu", "--port", str(port), "--max-batch", "64",
            "-p", "4", "--warmup-lengths", "60", "--metrics", m,
            golden["db"]])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    h0 = _wait_up(port)
    assert h0["engine_compiles"] == 1
    client = ServeClient(port=port)
    body = open(READS).read()
    for _ in range(2):
        r = client.correct(body, want_log=True)
        assert r.status == 200
        assert (r.fa, r.log) == (golden["fa"], golden["log"])
    assert client.healthz()["engine_compiles"] == 1
    assert export.lint_prometheus_text(client.metrics_text()) == []
    assert client.quiesce()["status"] == "draining"
    t.join(timeout=60)
    assert box["rc"] == 0
    doc = json.load(open(m))
    assert doc["meta"]["stage"] == "serve" and doc["meta"]["drained"]
    assert contract.missing_names(doc) == []
    assert _tool("metrics_check").main([m]) == 0
    assert doc["counters"]["reads_in"] == 2 * 242


class FakeEngine:
    """Engine-shaped stub (echo), for the CLI's wiring alone."""

    def __init__(self, rows=1024):
        self.rows = rows
        self.compiles = 0

    def warmup(self, lengths=(None,)):
        return 0

    def step(self, records):
        return [(f">{h}\n{s.decode()}\n", "") for h, s, _q in records]


def test_resilience_flags_land_in_meta(tmp_path, monkeypatch):
    monkeypatch.setattr(tserve, "CorrectionEngine",
                        lambda db, **kw: FakeEngine(kw.get("rows", 1024)))
    port = _free_port()
    m = str(tmp_path / "serve.json")
    box = {}

    def run():
        box["rc"] = _quiet_run(tserve_cli.main, [
            "--device", "cpu", "--port", str(port), "--max-wait-ms", "0",
            "--max-batch", "8", "--step-timeout-ms", "5000",
            "--quota-rps", "100", "--metrics", m, "ignored.jf"])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _wait_up(port)
    client = ServeClient(port=port)
    r = client.correct("@a\nAC\n+\nII\n", priority="bulk", client_id="c1")
    assert r.status == 200 and r.reads == 1
    assert client.correct("@a\nAC\n+\nII\n",
                          priority="urgent").status == 400
    client.quiesce()
    t.join(timeout=15)
    assert box["rc"] == 0
    doc = json.load(open(m))
    assert schema.validate_metrics(doc) == []
    assert doc["meta"]["step_timeout_ms"] == 5000
    assert doc["meta"]["max_hedges"] == 8
    assert doc["meta"]["quota_rps"] == 100
    assert doc["meta"]["reload"] is True
    for c in ("engine_restarts_total", "hedges_total", "reload_total",
              "quota_rejections_total"):
        assert doc["counters"].get(c) == 0, c


def test_sigterm_drains_and_writes_a_serve_document(golden, tmp_path):
    """The real CLI in its own process: SIGTERM drains, rc 0, and the
    final document passes tools/metrics_check.py as a serve document."""
    port = _free_port()
    m = str(tmp_path / "serve.json")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "quorum_tpu_torch.cli.serve", "--device",
         "cpu", "--port", str(port), "--max-batch", "64", "-p", "4",
         "--metrics", m, golden["db"]],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        _wait_up(port, timeout=120)
        r = ServeClient(port=port).correct(open(READS).read())
        assert r.status == 200 and r.fa == golden["fa"]
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err.decode()[-2000:]
    doc = json.load(open(m))
    assert doc["meta"]["stage"] == "serve"
    assert doc["meta"]["status"] == "ok" and doc["meta"]["drained"]
    assert _tool("metrics_check").main([m]) == 0


def test_bench_prints_valid_metric_lines(capsys):
    reg = registry_for(None, force=True)
    bat = tserve.DynamicBatcher(FakeEngine(), max_batch=32, max_wait_ms=1,
                                queue_requests=16, registry=reg)
    srv = tserve.CorrectionServer(bat, port=0, registry=reg)
    try:
        rc = bench_main(["--port", str(srv.port), "-c", "2", "-n", "6",
                         "-r", "3", "--retry", "--priority", "bulk",
                         "--client-id", "bench", READS])
    finally:
        srv.close()
    assert rc == 0
    captured = capsys.readouterr()
    lines = [json.loads(ln) for ln in captured.out.strip().splitlines()]
    by_metric = {o["metric"]: o for o in lines}
    assert by_metric["serve_bench"]["ok"] == 6
    assert by_metric["serve_bench"]["reads"] == 18
    assert "serve_bench_phases" in by_metric
    for o in lines:
        assert schema.validate_bench_line(o) == []
        assert jschema.validate_bench_line(o) == []
