"""The port's resource guards (quorum_tpu_torch/utils/resources.py) on
the CPU: the writer catalogue, rcs and estimates are the JAX package's;
the guard ladders every writer (required ones fail fast with rc 4,
optional ones degrade); the three --preflight modes; the monitor's
gauges and the frames' nesting; the stall watchdog soft-aborts a
stalled thread, and a `hang` fault at stage2.correct under
--stall-timeout-s ends the run with rc 75; end to end, a full disk at
an optional writer (checkpoints, the quarantine, the span trace) leaves
the output as it was, and at a required one (the database, the output
streams, the journal) fails fast with rc 4."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import errno
import importlib.util
import json
import os
import shutil
import threading
import time

import pytest
import torch

from quorum_tpu.utils import resources as jres
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.io import checkpoint as tck
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.telemetry import registry_for
from quorum_tpu_torch.telemetry.registry import labeled
from quorum_tpu_torch.utils import faults, resources

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
CDB = ["-s", "64k", "-m", "13", "-b", "7", "-q", "38", "--batch-size", "64",
       "--device", "cpu"]
EC = ["-p", "4", "--batch-size", "64", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_state():
    faults.reset()
    yield
    faults.reset()
    resources._FRAME = resources._Frame(None, None)


def _enospc():
    return OSError(errno.ENOSPC, "no space left on device")


def _metrics_check():
    spec = importlib.util.spec_from_file_location(
        "_metrics_check", os.path.join(ROOT, "tools", "metrics_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------ the catalogue


def test_writer_catalog_and_rcs_are_jax():
    assert resources.WRITERS == jres.WRITERS
    required = {w for w, c in resources.WRITERS.items()
                if c == resources.REQUIRED}
    assert required == {"db.payload", "output.stream", "stage2.journal"}
    assert (resources.DISK_FULL_RC, resources.STALL_RC) == (4, 75)
    assert (jres.DISK_FULL_RC, jres.STALL_RC) == (4, 75)
    assert tck.NON_RETRYABLE_RC == 3
    assert resources.PREFLIGHT_MODES == jres.PREFLIGHT_MODES


def test_is_enospc_family():
    assert resources.is_enospc(_enospc())
    assert resources.is_enospc(OSError(errno.EDQUOT, "quota"))
    assert resources.is_enospc(resources.ResourceExhausted("x", "d"))
    assert not resources.is_enospc(OSError(errno.ENOENT, "missing"))
    assert not resources.is_enospc(ValueError("nope"))


@pytest.mark.parametrize("writer", sorted(resources.WRITERS))
def test_guard_ladders_every_writer(writer):
    reg = registry_for(None, force=True)
    tok = resources.install(reg)
    try:
        if resources.WRITERS[writer] == resources.REQUIRED:
            with pytest.raises(resources.ResourceExhausted) as ei:
                with resources.guard(writer, path="/x/y"):
                    raise _enospc()
            assert ei.value.writer == writer
            assert not resources.degraded(writer)
            assert reg.counter("writer_degraded_total").value == 0
        else:
            with resources.guard(writer, path="/x/y"):
                raise _enospc()  # swallowed: the writer degrades
            assert resources.degraded(writer)
            assert reg.counter(labeled("writer_degraded_total",
                                       writer=writer)).value == 1
            with resources.guard(writer, path="/x/z"):
                raise OSError(errno.EDQUOT, "quota exceeded")
            assert reg.counter("writer_degraded_total").value == 2
            assert "/x/y" in resources.degraded_writers()[writer]
    finally:
        resources.uninstall(tok)


def test_guard_passthrough_and_validation():
    tok = resources.install(registry_for(None, force=True))
    try:
        with pytest.raises(OSError, match="missing"):
            with resources.guard("trace.spans"):
                raise OSError(errno.ENOENT, "missing")
        with pytest.raises(resources.ResourceExhausted) as ei:
            with resources.guard("stage1.checkpoint"):
                raise resources.ResourceExhausted("db.payload", "inner")
        assert ei.value.writer == "db.payload"
        assert not resources.degraded("stage1.checkpoint")
        with pytest.raises(ValueError, match="undeclared writer"):
            with resources.guard("not.a.writer"):
                pass
    finally:
        resources.uninstall(tok)


def test_frames_nest_and_isolate():
    reg = registry_for(None, force=True)
    outer = resources.install(reg)
    resources.degrade("trace.spans", _enospc())
    inner = resources.install(reg)
    assert not resources.degraded("trace.spans")
    resources.uninstall(inner)
    assert resources.degraded("trace.spans")
    resources.uninstall(outer)
    assert not resources.degraded("trace.spans")


# ------------------------------------------------ preflight


@pytest.mark.parametrize("mode", ["strict", "warn", "off"])
def test_preflight_modes(tmp_path, capsys, mode):
    reg = registry_for(None, force=True)
    tok = resources.install(reg)
    target = str(tmp_path / "out.db")
    huge = shutil.disk_usage(str(tmp_path)).free + (1 << 30)
    try:
        resources.preflight(mode, {target: 1024})  # fits: nothing
        assert capsys.readouterr().err == ""
        if mode == "strict":
            with pytest.raises(resources.ResourceExhausted,
                               match="preflight refused"):
                resources.preflight(mode, {target: huge})
        else:
            resources.preflight(mode, {target: huge})
        err = capsys.readouterr().err
        assert ("preflight warning" in err) == (mode == "warn")
        assert reg.counter("preflight_refusals_total").value == \
            (mode == "strict")
    finally:
        resources.uninstall(tok)
    with pytest.raises(ValueError, match="--preflight"):
        resources.preflight("loud", {target: 1})


def test_preflight_estimates_equal_jax(tmp_path):
    fq = tmp_path / "r.fastq"
    fq.write_bytes(b"x" * 1000)
    gz = tmp_path / "r2.fastq.gz"
    gz.write_bytes(b"x" * 1000)
    out = str(tmp_path / "db.jf")
    for entries, k, bits in ((1 << 10, 13, 7), (200_000_000, 24, 7)):
        assert resources.estimate_table_bytes(entries, k, bits) == \
            jres.estimate_table_bytes(entries, k, bits)
    assert resources.estimate_stage1_needs(
        out, 1 << 16, 13, 7, checkpoint_dir=str(tmp_path / "ck")) == \
        jres.estimate_stage1_needs(out, 1 << 16, 13, 7,
                                   checkpoint_dir=str(tmp_path / "ck"))
    outs = (str(tmp_path / "o.fa"), [str(fq), str(gz)])
    assert resources.estimate_stage2_needs(*outs) == \
        jres.estimate_stage2_needs(*outs) == {outs[0]: 6000}


def test_strict_preflight_refuses_the_cli_with_rc4(tmp_path, monkeypatch):
    """A build whose estimate cannot fit refuses before any work."""
    monkeypatch.setattr(resources, "estimate_table_bytes",
                        lambda *a: shutil.disk_usage(str(tmp_path)).free * 2)
    m = str(tmp_path / "m.json")
    assert tcdb_cli.main(CDB + ["--preflight", "strict", "--metrics", m,
                                "-o", str(tmp_path / "db.jf"),
                                READS]) == resources.DISK_FULL_RC
    assert json.load(open(m))["counters"]["preflight_refusals_total"] == 1
    assert not os.path.exists(tmp_path / "db.jf")


# ------------------------------------------------ monitor and watchdog


def test_install_arms_monitor_and_meta(tmp_path):
    reg = registry_for(None, force=True)
    tok = resources.install(reg, watch_paths=(str(tmp_path / "o.db"),
                                              str(tmp_path / "o.db"), "",
                                              None))
    try:
        assert reg.meta.get("resource_guard") is True
        assert reg.gauge("disk_free_bytes_min").value > 0
        assert reg.gauge(labeled("disk_free_bytes",
                                 path=str(tmp_path))).value > 0
        assert reg.gauge("host_rss_bytes").value > 0
        for name in ("writer_degraded_total", "preflight_refusals_total",
                     "stall_aborts_total"):
            assert reg.counter(name).value == 0
    finally:
        resources.uninstall(tok)
    tok = resources.install(reg)
    assert tok.monitor is None and tok.watchdog is None
    resources.uninstall(tok)


def test_watchdog_soft_aborts_a_stalled_thread():
    resources.watchdog_beat("anywhere", 0)  # no frame: a no-op
    reg = registry_for(None, force=True)
    tok = resources.install(reg, stall_timeout_s=0.3)
    caught = threading.Event()

    def worker():
        resources.watchdog_beat("stage2.correct", 0)
        try:
            for _ in range(600):
                time.sleep(0.01)
        except resources.StallError:
            resources.watchdog_beat("stage2.correct", 1)  # disarm
            caught.set()

    try:
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10.0)
        assert caught.is_set()
        assert reg.counter("stall_aborts_total").value >= 1
    finally:
        resources.uninstall(tok)


@pytest.fixture(scope="module")
def golden_db(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("res_db") / "db.jf")
    assert tcdb_cli.main(CDB + ["-o", db, READS]) == 0
    return db


def test_hang_fault_is_a_stall_rc75(golden_db, tmp_path):
    """A `hang` at stage2.correct stalls Python code (not the card); the
    watchdog soft-aborts it into the stage's error path: rc 75."""
    m = str(tmp_path / "m.json")
    plan = json.dumps([{"site": "stage2.correct", "batch": 1,
                        "action": "hang"}])
    t0 = time.monotonic()
    rc = tec_cli.main(EC + ["--stall-timeout-s", "2", "--fault-plan", plan,
                            "--metrics", m, "-o", str(tmp_path / "out"),
                            golden_db, READS])
    assert rc == resources.STALL_RC
    assert time.monotonic() - t0 < 60
    doc = json.load(open(m))
    assert doc["counters"]["stall_aborts_total"] == 1
    assert doc["meta"]["status"] == "error"


# ------------------------------------------------ the ladder end to end


def test_checkpoint_enospc_degrades_and_the_build_completes(tmp_path):
    ref = str(tmp_path / "ref.jf")
    assert tcdb_cli.main(CDB + ["-o", ref, READS]) == 0
    out = str(tmp_path / "db.jf")
    m = str(tmp_path / "m.json")
    plan = json.dumps([{"site": "checkpoint.commit", "action": "diskfull",
                        "count": -1}])
    assert tcdb_cli.main(CDB + ["-o", out, "--checkpoint-dir",
                                str(tmp_path / "ck"), "--checkpoint-every",
                                "1", "--fault-plan", plan, "--metrics", m,
                                READS]) == 0
    assert tdb.db_payload_bytes(out) == tdb.db_payload_bytes(ref)
    doc = json.load(open(m))
    assert doc["counters"]["writer_degraded_total"] >= 1
    assert doc["meta"]["resource_guard"] is True
    assert _metrics_check().main([m, "-q"]) == 0


def test_kill_resume_after_degraded_checkpoints(tmp_path):
    ref = str(tmp_path / "ref.jf")
    assert tcdb_cli.main(CDB + ["-o", ref, READS]) == 0
    out = str(tmp_path / "db.jf")
    ck = str(tmp_path / "ck")
    argv = CDB + ["-o", out, "--checkpoint-dir", ck, "--checkpoint-every",
                  "1"]
    plan = json.dumps([
        {"site": "checkpoint.commit", "action": "diskfull", "at": 2,
         "count": -1},
        {"site": "stage1.insert", "batch": 3, "action": "error"}])
    assert tcdb_cli.main(argv + ["--fault-plan", plan, READS]) == 1
    # the site fires after the rename: the second snapshot landed
    assert tck.Stage1Checkpoint(ck).cursor() == 2
    assert tcdb_cli.main(argv + ["--resume", "--fault-plan", "",
                                 READS]) == 0
    assert tdb.db_payload_bytes(out) == tdb.db_payload_bytes(ref)


@pytest.mark.parametrize("site,writer", [
    ("db.write", "db.payload"),
])
def test_database_enospc_fails_fast(tmp_path, capsys, site, writer):
    m = str(tmp_path / "m.json")
    plan = json.dumps([{"site": site, "action": "diskfull", "count": -1}])
    assert tcdb_cli.main(CDB + ["-o", str(tmp_path / "db.jf"),
                                "--fault-plan", plan, "--metrics", m,
                                "--metrics-interval", "60",
                                READS]) == resources.DISK_FULL_RC
    assert f"required writer {writer} out of space" in \
        capsys.readouterr().err
    events = [json.loads(ln) for ln in open(m[:-5] + ".events.jsonl")]
    assert any(e["event"] == "disk_full" and e["writer"] == writer
               for e in events)


@pytest.mark.parametrize("plan,writer", [
    ({"site": "writer.stream", "action": "io_error", "errno": 28},
     "output.stream"),
    ({"site": "journal.append", "action": "diskfull", "count": -1},
     "stage2.journal"),
])
def test_stage2_required_writers_fail_fast(golden_db, tmp_path, capsys, plan,
                                           writer):
    rc = tec_cli.main(EC + ["--checkpoint-every", "1", "--fault-plan",
                            json.dumps([plan]), "-o", str(tmp_path / "out"),
                            golden_db, READS])
    assert rc == resources.DISK_FULL_RC
    assert f"required writer {writer} out of space" in \
        capsys.readouterr().err


def test_quarantine_and_trace_enospc_degrade(golden_db, tmp_path):
    """Optional writers: a full disk at the quarantine stream and the
    span trace leaves the corrected output as it was."""
    bad = tmp_path / "bad.fastq"
    lines = open(READS).read().splitlines(keepends=True)
    bad.write_text("".join(lines[:80]) + "@broken\nACGT\n+\nIIIIIII\n"
                   + "".join(lines[80:]))
    out = str(tmp_path / "out")
    m = str(tmp_path / "m.json")
    plan = json.dumps([
        {"site": "quarantine.write", "action": "io_error", "errno": 28},
        {"site": "writer.stream", "action": "sleep", "seconds": 0.0}])
    spans = str(tmp_path / "s.jsonl")
    real_open = open

    def full_for_spans(path, *a, **kw):
        if str(path) == spans:
            raise _enospc()
        return real_open(path, *a, **kw)

    import builtins
    builtins.open = full_for_spans
    try:
        rc = tec_cli.main(EC + ["--on-bad-read", "quarantine",
                                "--fault-plan", plan, "--metrics", m,
                                "--trace-spans", spans, "-o", out,
                                golden_db, str(bad)])
    finally:
        builtins.open = real_open
    assert rc == 0
    assert open(out + ".fa").read() == \
        open(os.path.join(GOLDEN, "expected.fa")).read()
    doc = json.load(open(m))
    assert doc["counters"]["bad_reads_total"] == 1
    assert doc["counters"][labeled("writer_degraded_total",
                                   writer="quarantine.stream")] == 1
    assert doc["counters"][labeled("writer_degraded_total",
                                   writer="trace.spans")] >= 1
    assert not os.path.exists(spans)


def _doc(meta, counters=None, gauges=None):
    return {"schema": "quorum-tpu-metrics/1", "meta": meta,
            "counters": counters or {}, "gauges": gauges or {},
            "histograms": {}, "timers": {}}


GUARD_COUNTERS = {"writer_degraded_total": 0, "preflight_refusals_total": 0,
                  "stall_aborts_total": 0}
GUARD_GAUGES = {"disk_free_bytes_min": 1e9, "host_rss_bytes": 1e8,
                'disk_free_bytes{path="/data"}': 1e9}


@pytest.mark.parametrize("doc,missing", [
    (_doc({"resource_guard": True}, GUARD_COUNTERS, GUARD_GAUGES), 0),
    (_doc({}), 0),
    (_doc({"resource_guard": True}), 6),
    (_doc({"resource_guard": True}, GUARD_COUNTERS,
          {"disk_free_bytes_min": 1e9, "host_rss_bytes": 1e8}), 1),
    (_doc({"checkpoint_every": 4, "resumed": True},
          {"checkpoint_writes_total": 0, "resume_skipped_reads": 128}), 0),
    (_doc({"checkpoint_every": 4, "resumed": True}), 2),
])
def test_missing_names_holds_the_guard_surface(tmp_path, doc, missing):
    """The port's name rules (telemetry/contract.missing_names) require
    the resource-guard and checkpoint names exactly where
    tools/metrics_check.py does."""
    from quorum_tpu_torch.telemetry import contract
    assert len(contract.missing_names(doc)) == missing
    p = str(tmp_path / "d.json")
    json.dump(doc, open(p, "w"))
    assert _metrics_check().main([p, "-q"]) == (1 if missing else 0)
