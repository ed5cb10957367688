"""The port's fault plans (quorum_tpu_torch/utils/faults.py) and the
quorum driver's retries, on the CPU. Each fault-plan case runs against
both packages' modules, so the port keeps the JAX package's parse,
matching and actions; the site catalogue is JAX's, and every site the
port fires is declared in it; the driver's retry helper keeps JAX's
backoff sequence and cap under a mocked clock and fails fast on rc 3
and rc 4; the driver with stubbed stages retries with --resume and
reuses a finished stage 1 under --resume."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import ast
import errno
import json
import os
import re
import subprocess
import sys
import threading

import pytest

from quorum_tpu.utils import faults as jfaults
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.io import checkpoint as tck
from quorum_tpu_torch.telemetry import registry_for
from quorum_tpu_torch.utils import faults as tfaults
from quorum_tpu_torch.utils import resources as tres
from quorum_tpu_torch.utils.pipeline import AsyncWriter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "quorum_tpu_torch")
READS = os.path.join(ROOT, "tests", "golden", "reads.fastq")
MODS = pytest.mark.parametrize("faults", [jfaults, tfaults],
                               ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _no_plan():
    for mod in (tfaults, jfaults):
        mod.reset()
    yield
    for mod in (tfaults, jfaults):
        mod.reset()


# ------------------------------------------------ the plan


@MODS
def test_fault_plan_parse_forms(faults):
    p = faults.FaultPlan.parse(
        [{"site": "a", "action": "error"},
         {"site": "b@batch=3", "action": "sleep", "seconds": 0.01}])
    assert p.specs[0].site == "a" and p.specs[0].batch is None
    assert p.specs[1].site == "b" and p.specs[1].batch == 3
    assert len(faults.FaultPlan.parse({"site": "x"}).specs) == 1
    assert len(faults.FaultPlan.parse(
        {"faults": [{"site": "x"}, {"site": "y"}]}).specs) == 2
    with pytest.raises(ValueError, match="site"):
        faults.FaultPlan.parse([{"action": "error"}])
    with pytest.raises(ValueError, match="unknown action"):
        faults.FaultPlan.parse([{"site": "x", "action": "explode"}])
    with pytest.raises(ValueError, match="shorthand"):
        faults.FaultPlan.parse([{"site": "x@reads=3"}])


@MODS
def test_fault_plan_at_count_batch_matching(faults):
    faults.install(faults.FaultPlan.parse([
        {"site": "s", "at": 2, "count": 2, "action": "error"},
        {"site": "t", "batch": 5, "action": "error"},
    ]))
    fired = []
    for site, batch in (("s", None),) * 4 + (("t", 4), ("t", None),
                                             ("t", 5), ("t", 5),
                                             ("nowhere", 123)):
        try:
            faults.inject(site, batch=batch)
            fired.append(False)
        except faults.FaultError:
            fired.append(True)
    assert fired == [False, True, True, False, False, False, True, False,
                     False]
    faults.reset()
    faults.inject("s")


@MODS
def test_fault_actions_and_load_plan(faults, tmp_path, monkeypatch):
    faults.install(faults.FaultPlan.parse([
        {"site": "io", "action": "io_error", "message": "disk gone"},
        {"site": "zzz", "action": "sleep", "seconds": 0.0},
    ]))
    with pytest.raises(OSError, match="disk gone"):
        faults.inject("io")
    faults.inject("zzz")
    pf = tmp_path / "plan.json"
    pf.write_text('[{"site": "p", "action": "error"}]')
    assert faults.load_plan(f"@{pf}").specs[0].site == "p"
    assert faults.load_plan(str(pf)).specs[0].site == "p"
    with pytest.raises(ValueError, match="bad fault plan"):
        faults.load_plan("not json {")
    monkeypatch.setenv(faults.ENV_VAR, '[{"site": "e", "action": "error"}]')
    assert faults.setup(None).specs[0].site == "e"
    monkeypatch.setenv(faults.ENV_VAR, "")
    assert faults.setup(None) is None
    assert not faults.active()


@MODS
def test_fault_env_reinstall_keeps_counters(faults, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, '[{"site": "s", "action": "error"}]')
    faults.setup(None)
    with pytest.raises(faults.FaultError):
        faults.inject("s")
    faults.setup(None)  # the same text: the plan and its counters kept
    faults.inject("s")
    monkeypatch.setenv(faults.ENV_VAR, '[{"site": "t", "action": "error"}]')
    faults.setup(None)
    with pytest.raises(faults.FaultError):
        faults.inject("t")


@MODS
def test_fault_io_error_errno(faults):
    faults.install(faults.FaultPlan.parse(
        [{"site": "w", "action": "io_error", "errno": 28,
          "message": "device full"}]))
    with pytest.raises(OSError, match="device full") as ei:
        faults.inject("w")
    assert ei.value.errno == errno.ENOSPC
    with pytest.raises(ValueError, match="errno"):
        faults.FaultPlan.parse([{"site": "w", "action": "io_error",
                                 "errno": 0}])


@MODS
def test_fault_diskfull_budget_and_persistence(faults, tmp_path):
    f = tmp_path / "a.bin"
    f.write_bytes(b"x" * 100)
    faults.install(faults.FaultPlan.parse(
        [{"site": "w", "action": "diskfull", "bytes": 150, "count": -1}]))
    faults.inject("w", path=str(f))
    for _ in range(2):  # past the budget, and it stays full
        with pytest.raises(OSError) as ei:
            faults.inject("w", path=str(f))
        assert ei.value.errno == errno.ENOSPC
    faults.install(faults.FaultPlan.parse(
        [{"site": "w", "action": "diskfull", "count": -1}]))
    with pytest.raises(OSError):
        faults.inject("w", path=str(f))


@MODS
def test_fault_path_prefix_scoping(faults, tmp_path):
    target = tmp_path / "ck"
    target.mkdir()
    (target / "s.ckpt").write_bytes(b"x" * 10)
    faults.install(faults.FaultPlan.parse(
        [{"site": "w", "action": "diskfull", "count": -1,
          "path_prefix": str(target)}]))
    faults.inject("w")
    faults.inject("w", path=str(tmp_path / "other"))
    with pytest.raises(OSError):
        faults.inject("w", path=str(target / "s.ckpt"))
    with pytest.raises(ValueError, match="path_prefix"):
        faults.FaultPlan.parse([{"site": "w", "path_prefix": ""}])


@MODS
@pytest.mark.parametrize("mode", ["flip", "zero"])
def test_fault_corrupt_is_deterministic(faults, tmp_path, mode):
    """The same plan damages the same bytes in both packages."""
    f = tmp_path / "a.bin"
    f.write_bytes(bytes(range(256)) * 4)
    faults.install(faults.FaultPlan.parse(
        [{"site": "c", "action": "corrupt", "bytes": 3, "mode": mode,
          "seed": 7}]))
    faults.inject("c", path=str(f))
    data = f.read_bytes()
    diff = [i for i, (a, b) in enumerate(zip(data, bytes(range(256)) * 4))
            if a != b]
    assert 1 <= len(diff) <= 3
    assert data == _corrupted_by_jax(tmp_path, mode)


def _corrupted_by_jax(tmp_path, mode):
    g = tmp_path / "ref.bin"
    g.write_bytes(bytes(range(256)) * 4)
    jfaults.FaultPlan.parse(
        [{"site": "c", "action": "corrupt", "bytes": 3, "mode": mode,
          "seed": 7}]).fire("c", path=str(g))
    return g.read_bytes()


@MODS
def test_hang_blocks_until_released(faults):
    faults.install(faults.FaultPlan.parse({"site": "h", "action": "hang"}),
                   "hang-plan")
    entered, done = threading.Event(), threading.Event()

    def victim():
        entered.set()
        faults.inject("h")
        done.set()

    t = threading.Thread(target=victim, daemon=True)
    t.start()
    assert entered.wait(5)
    assert not done.wait(0.2), "hang did not block"
    # installing the next plan releases the last plan's hung threads
    faults.install(faults.FaultPlan.parse({"site": "y"}), "next-plan")
    assert done.wait(5)
    t.join(timeout=5)


# ------------------------------------------------ the site catalogue


def test_sites_are_jax_catalogue():
    assert set(tfaults.SITES) == set(jfaults.SITES)
    for name, where in tfaults.SITES.items():
        # the JAX wording, less its tags of the JAX package's history
        assert where == re.sub(r" \([A-Z]+ \d+\)$", "",
                               jfaults.SITES[name]), name
    assert tfaults.ENV_VAR == jfaults.ENV_VAR == "QUORUM_FAULT_PLAN"
    assert tfaults.DEFAULT_EXIT_CODE == jfaults.DEFAULT_EXIT_CODE


def _fired_sites():
    """Every literal site the port's `faults.inject(...)` calls name."""
    out = {}
    for d, _dirs, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            for node in ast.walk(ast.parse(open(path).read(), path)):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "inject"
                        and getattr(node.func.value, "id", "") == "faults"):
                    out.setdefault(node.args[0].value, []).append(path)
    return out


def test_every_fired_site_is_declared():
    fired = _fired_sites()
    assert set(fired) <= set(tfaults.SITES)
    # the offline and the correction server's sites all fire in the
    # port; the rest wait for the ingest, fleet and flight-recorder items
    assert set(fired) == {
        "stage1.insert", "stage2.correct", "fastq.read", "db.write",
        "checkpoint.commit", "journal.append", "partition.commit",
        "quarantine.write", "writer.stream", "serve.engine.step",
        "serve.admit", "serve.reload"}


def test_hard_exit_kills_the_process():
    code = ("from quorum_tpu_torch.utils import faults\n"
            "faults.setup('[{\"site\": \"x\", \"action\": \"exit\", "
            "\"code\": 43}]')\n"
            "faults.inject('x')\n"
            "print('unreachable')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 43
    assert "unreachable" not in res.stdout
    assert "hard exit (43) at x" in res.stderr


@pytest.mark.parametrize("site", ["fastq.read"])
@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_fastq_read_site_in_both_parsers(tmp_path, monkeypatch, site,
                                         native):
    from quorum_tpu_torch.io import fastq
    from quorum_tpu_torch.native import binding
    if native and not binding.available():
        pytest.skip("no g++ for the native parser")
    monkeypatch.setattr(binding, "available", lambda: native)
    tfaults.install(tfaults.FaultPlan.parse(
        [{"site": site, "at": 100, "action": "io_error",
          "message": "read failed"}]))
    with pytest.raises(OSError, match="read failed"):
        list(fastq.read_batches([READS], batch_size=64))


def test_writer_stream_site_and_flush_barrier(tmp_path):
    p = tmp_path / "w.txt"
    f = open(p, "w")
    w = AsyncWriter([f])
    for i in range(50):
        w.write(0, f"line{i}\n")
    w.flush()
    assert open(p).read().count("\n") == 50
    tfaults.install(tfaults.FaultPlan.parse(
        [{"site": "writer.stream", "batch": 0, "action": "io_error",
          "errno": 28}]))
    w.write(0, "tail\n")
    with pytest.raises(OSError) as ei:
        w.flush()
    assert ei.value.errno == errno.ENOSPC
    w.close()
    f.close()


# ------------------------------------------------ the driver's retries


def test_retry_helper_backoff_sequence_and_cap(monkeypatch):
    sleeps = []
    monkeypatch.setattr(tquorum, "_sleep", sleeps.append)
    reg = registry_for(None, force=True)
    attempts = []

    def fn(attempt):
        attempts.append(attempt)
        return 1

    assert tquorum._run_stage_with_retries(
        reg, "s", fn, retries=4, backoff_ms=10_000.0,
        cursor_fn=lambda: 7) == 1
    assert attempts == [0, 1, 2, 3, 4]
    assert sleeps == [10.0, 20.0, 30.0, 30.0]  # capped at 30 s
    assert reg.counter("stage_retries_total").value == 4
    assert reg.meta["s_attempts"] == 5


@pytest.mark.parametrize("raised,rc", [
    (OSError("transient disk error"), 0),
    (tres.StallError("stalled"), 0),
])
def test_retry_helper_retries_transient_failures(monkeypatch, raised, rc):
    monkeypatch.setattr(tquorum, "_sleep", lambda s: None)
    reg = registry_for(None, force=True)
    calls = []

    def fn(attempt):
        calls.append(attempt)
        if attempt == 0:
            raise raised
        return 0

    assert tquorum._run_stage_with_retries(reg, "s", fn, retries=1,
                                           backoff_ms=1.0) == rc
    assert calls == [0, 1]


@pytest.mark.parametrize("failure,rc", [
    (tck.CheckpointError("config mismatch"), tck.NON_RETRYABLE_RC),
    (tres.ResourceExhausted("db.payload", "full"), tres.DISK_FULL_RC),
    (tck.NON_RETRYABLE_RC, tck.NON_RETRYABLE_RC),
    (tres.DISK_FULL_RC, tres.DISK_FULL_RC),
])
def test_retry_helper_fails_fast_on_rc3_and_rc4(monkeypatch, failure, rc):
    sleeps = []
    monkeypatch.setattr(tquorum, "_sleep", sleeps.append)
    reg = registry_for(None, force=True)
    calls = []

    def fn(attempt):
        calls.append(attempt)
        if isinstance(failure, int):
            return failure
        raise failure

    assert tquorum._run_stage_with_retries(reg, "s", fn, retries=5,
                                           backoff_ms=100.0) == rc
    assert calls == [0] and sleeps == []


def _stub_stages(monkeypatch, cdb_rc=0, ec_rcs=(0,)):
    cdb, ec = [], []

    def fake_cdb(argv, handoff=None, batches_factory=None):
        cdb.append(list(argv))
        return cdb_rc

    def fake_ec(argv, db=None, prepacked=None, records=None, report=None):
        ec.append(list(argv))
        return ec_rcs[min(len(ec), len(ec_rcs)) - 1]

    monkeypatch.setattr(tquorum.cdb_cli, "main", fake_cdb)
    monkeypatch.setattr(tquorum.ec_cli, "main", fake_ec)
    return cdb, ec


def test_driver_retries_stage2_with_mocked_clock(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sleeps = []
    monkeypatch.setattr(tquorum, "_sleep", sleeps.append)
    _cdb, ec = _stub_stages(monkeypatch, ec_rcs=(1, 1, 0))
    m = str(tmp_path / "run.json")
    assert tquorum.main(["-s", "64k", "-k", "13", "-p", str(tmp_path / "qc"),
                         "--device", "cpu", "--stage-retries", "2",
                         "--retry-backoff-ms", "100", "--checkpoint-dir",
                         str(tmp_path / "ck"), "--metrics", m,
                         "--metrics-interval", "60", READS]) == 0
    assert len(ec) == 3 and sleeps == [0.1, 0.2]
    assert "--resume" not in ec[0]
    assert "--resume" in ec[1] and "--resume" in ec[2]
    assert "--checkpoint-every" in ec[0]
    doc = json.load(open(m))
    assert doc["counters"]["stage_retries_total"] == 2
    assert doc["meta"]["error_correct_attempts"] == 3
    assert doc["meta"]["create_database_attempts"] == 1
    events = [json.loads(ln) for ln in open(m[:-5] + ".events.jsonl")]
    retries = [e for e in events if e["event"] == "stage_retry"]
    assert [e["attempt"] for e in retries] == [1, 2]
    assert [e["backoff_ms"] for e in retries] == [100, 200]


@pytest.mark.parametrize("cdb_rc,want", [(1, 1), (3, 1), (4, 4), (75, 75)])
def test_driver_gives_up_after_retries(tmp_path, monkeypatch, cdb_rc, want):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tquorum, "_sleep", lambda s: None)
    cdb, _ec = _stub_stages(monkeypatch, cdb_rc=cdb_rc)
    assert tquorum.main(["-s", "64k", "-k", "13", "-p", str(tmp_path / "qc"),
                         "--device", "cpu", "--stage-retries", "1",
                         READS]) == want
    # rc 3 and rc 4 are not retried
    assert len(cdb) == (1 if cdb_rc in (3, 4) else 2)


def test_driver_resume_skips_finished_stage1(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    prefix = str(tmp_path / "qc")
    db_file = prefix + "_mer_database.jf"
    open(db_file, "w").write(
        json.dumps({"format": "binary/quorum_tpu_db", "version": 2,
                    "key_len": 26, "bits": 7, "rb_log2": 4,
                    "rows": 16}) + "\n")
    cdb, ec = _stub_stages(monkeypatch)
    m = str(tmp_path / "run.json")
    assert tquorum.main(["-s", "64k", "-k", "13", "-p", prefix, "--device",
                         "cpu", "--resume", "--metrics", m, READS]) == 0
    assert cdb == [] and len(ec) == 1
    assert json.load(open(m))["meta"]["stage1_resumed_db"] == db_file
    # a foreign file at the database's path is built again
    open(db_file, "w").write("torn garbage, not a database")
    assert tquorum.main(["-s", "64k", "-k", "13", "-p", prefix, "--device",
                         "cpu", "--resume", READS]) == 0
    assert len(cdb) == 1
