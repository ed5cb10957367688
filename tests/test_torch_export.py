"""The port's live exposition (quorum_tpu_torch/telemetry/export.py) held
to the JAX package's on the CPU: `prometheus_text` of the same registry
document renders the same text in both; the linters agree; the port's
renderings lint clean; `--metrics-textfile` on a port stage CLI writes
the text JAX's `prometheus_text` renders from the port's own final
document; `--metrics-port` answers a scrape during a run and frees the
port after; the quorum driver's one textfile carries all three stages.
"""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import contextlib
import gc
import io
import json
import os
import urllib.request

import pytest
import torch

from quorum_tpu.telemetry import export as jexport
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.cli.observability import observability
from quorum_tpu_torch.telemetry import export as texport
from quorum_tpu_torch.telemetry import labeled, registry_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = os.path.join(ROOT, "tests", "golden", "reads.fastq")
PORT = ["--device", "cpu", "--batch-size", "256"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet_run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return main(argv)


def _doc(kind):
    """A registry document of each shape the exposition meets."""
    reg = registry_for(None, force=True)
    if kind == "serve":
        reg.set_meta(stage="serve")
        reg.counter("requests_accepted").inc(7)
        reg.gauge(labeled("queue_depth", lane="bulk")).set(3)
        for v in (4, 4, 64, 1024):
            reg.histogram("batch_reads").observe(v)
        reg.histogram(labeled("lane_wait_us", lane="interactive")).observe(9)
    elif kind == "stage":
        reg.set_meta(stage="error_correct")
        reg.counter("reads_in").inc(242)
        reg.gauge("cutoff").set(4)
        reg.gauge("hash_fill").set(0.4375)
        reg.histogram("substitutions_per_read").observe(0, 200)
        reg.histogram("substitutions_per_read").observe(2, 42)
    else:
        reg.set_meta(stage="quorum")
    return reg.as_dict()


@pytest.mark.parametrize("kind", ["serve", "stage", "empty"])
def test_prometheus_text_equals_jax(kind):
    doc = _doc(kind)
    docs = {doc["meta"]["stage"]: doc, "other": _doc("stage")}
    elapsed = {"other": 1.2345}
    assert texport.prometheus_text(docs, elapsed) == \
        jexport.prometheus_text(docs, elapsed)
    assert texport.lint_prometheus_text(
        texport.prometheus_text(docs, elapsed)) == []


@pytest.mark.parametrize("text", [
    "quorum_tpu_x 1\n",
    "# TYPE quorum_tpu_x counter\nquorum_tpu_x 1\n",
    'quorum_tpu_h_bucket{le="2"} 3\nquorum_tpu_h_bucket{le="1"} 5\n',
    "bad line here\n",
    'quorum_tpu_x{stage=unquoted} 1\n',
    "",
])
def test_linters_agree(text):
    assert texport.lint_prometheus_text(text) == \
        jexport.lint_prometheus_text(text)


def test_split_labeled_name_equals_jax():
    for name in ("plain", labeled("q", lane="bulk"), "a{b"):
        assert texport.split_labeled_name(name) == \
            jexport.split_labeled_name(name)


def _samples(text, stage):
    """The sample lines of one stage label, elapsed time aside."""
    return sorted(ln for ln in text.splitlines()
                  if f'stage="{stage}"' in ln
                  and not ln.startswith("quorum_tpu_elapsed_seconds"))


def test_textfile_is_jax_rendering_of_the_final_document(tmp_path):
    gc.collect()  # earlier tests' registries leave the live set
    prom = str(tmp_path / "live.prom")
    m = str(tmp_path / "m.json")
    assert _quiet_run(tec_cli.main, PORT + [
        "-p", "4", "--metrics", m, "--metrics-textfile", prom,
        _golden_db(tmp_path), READS, "-o", str(tmp_path / "out")]) == 0
    text = open(prom).read()
    doc = json.load(open(m))
    assert texport.lint_prometheus_text(text) == []
    want = jexport.prometheus_text({"error_correct": doc})
    assert _samples(text, "error_correct") == \
        _samples(want, "error_correct")
    assert doc["meta"]["metrics_textfile"] == prom


def _golden_db(tmp_path):
    from quorum_tpu_torch.cli import create_database as tcdb_cli
    db = str(tmp_path / "db.jf")
    if not os.path.exists(db):
        assert _quiet_run(tcdb_cli.main, [
            "-s", "64k", "-m", "13", "-b", "7", "-q", "38", "--device",
            "cpu", "-o", db, READS]) == 0
    return db


def test_metrics_port_answers_a_scrape_and_frees_the_port():
    with observability(port=0, stage="scrape_probe") as obs:
        obs.registry.counter("probe_total_reads").inc(5)
        srv = texport.current_server()
        assert srv is not None and obs.server is srv
        port = srv.port
        assert obs.registry.meta["metrics_port"] == port
        url = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(url + "/metrics", timeout=30) \
            .read().decode()
        health = json.loads(urllib.request.urlopen(
            url + "/healthz", timeout=30).read())
    assert 'quorum_tpu_probe_total_reads_total{stage="scrape_probe"} 5' \
        in text
    assert texport.lint_prometheus_text(text) == []
    assert health["status"] == "ok"
    assert texport.current_server() is None
    with pytest.raises(OSError):
        urllib.request.urlopen(url + "/metrics", timeout=5)


def test_driver_textfile_carries_every_stage(tmp_path):
    """The quorum driver with --metrics-port and --metrics-textfile: one
    endpoint and one textfile for the driver and both stages."""
    prom = str(tmp_path / "live.prom")
    assert _quiet_run(tquorum.main, PORT + [
        "-s", "64k", "-k", "13", "-p", str(tmp_path / "out"),
        "--metrics-port", "0", "--metrics-textfile", prom, READS]) == 0
    text = open(prom).read()
    assert texport.lint_prometheus_text(text) == []
    for stage in ("quorum", "create_database", "error_correct"):
        assert f'stage="{stage}"' in text, stage
    assert 'quorum_tpu_reads_in_total{stage="error_correct"} 242' in text
