"""The port's correction service (quorum_tpu_torch/serve) held to the JAX
package's on the CPU, at golden size (tests/golden/reads.fastq, 242
reads, k = 13), with exact bytes throughout.

* The engine: the port's CorrectionEngine(device="cpu") and JAX's give
  the same (fa, log) for every record in one-record, many-record and
  mixed-bucket steps, both equal to the port's offline
  `error_correct_reads --device cpu` bytes; `representative_read`
  returns the same string for the same database; `engine_compiles` is
  equal after the same warmup and traffic.
* HTTP: a JAX server and a port server side by side on the same file
  and requests answer the same status codes and bodies (`/correct`,
  `?log=1`, gzip in and out, 400/411/413/415, 429 with Retry-After);
  `/healthz` carries the same keys.
* Behaviour: the engine-agnostic scenarios of tests/test_serve.py with
  stub engines, each run on both packages' DynamicBatcher /
  CorrectionServer.
* The kernel loader under threads: one build and one loaded library
  for 8 concurrent first users, exact launch counts from N threads.
"""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import contextlib
import gzip
import http.client
import io
import json
import os
import sys
import threading
import time
import types

import pytest
import torch

import quorum_tpu.serve as jserve
from quorum_tpu.serve import server as jserver_mod
from quorum_tpu.serve.engine import representative_read as j_rep
from quorum_tpu.telemetry import registry_for as jregistry_for
from quorum_tpu.utils import faults as jfaults
import quorum_tpu_torch.serve as tserve
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.io import fastq as tfastq
from quorum_tpu_torch.kernels import loader
from quorum_tpu_torch.serve import server as tserver_mod
from quorum_tpu_torch.serve.client import ServeClient
from quorum_tpu_torch.serve.engine import representative_read as t_rep
from quorum_tpu_torch.telemetry import export as texport
from quorum_tpu_torch.telemetry import labeled
from quorum_tpu_torch.telemetry import registry_for as tregistry_for
from quorum_tpu_torch.telemetry import validate_events_line
from quorum_tpu_torch.utils import faults as tfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = os.path.join(ROOT, "tests", "golden", "reads.fastq")
ROWS = 64

PKGS = {
    "jax": types.SimpleNamespace(
        serve=jserve, server_mod=jserver_mod, registry_for=jregistry_for,
        faults=jfaults),
    "port": types.SimpleNamespace(
        serve=tserve, server_mod=tserver_mod, registry_for=tregistry_for,
        faults=tfaults),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


def _quiet_run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return main(argv)


# ---------------------------------------------------------------------------
# real engines over the golden database
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_db(tmp_path_factory):
    """The port's golden database (JAX reads the same file)."""
    db = str(tmp_path_factory.mktemp("serve_db") / "db.jf")
    assert _quiet_run(tcdb_cli.main, [
        "-s", "64k", "-m", "13", "-b", "7", "-q", "38", "--device", "cpu",
        "-o", db, READS]) == 0
    return db


def _offline(db, fastq_path, out):
    """The port's offline stage 2 at -p 4 on the CPU: (fa, log)."""
    assert _quiet_run(tec_cli.main, [
        "-p", "4", "--device", "cpu", "--batch-size", "256", db,
        fastq_path, "-o", out]) == 0
    with open(out + ".fa") as f, open(out + ".log") as g:
        return f.read(), g.read()


def _mixed_records():
    """Golden reads (60 bp, bucket 64) interleaved with reads of two and
    three golden reads joined (120 and 180 bp: buckets 128 and 192), so
    that one step crosses three buckets."""
    recs = list(tfastq.iter_records([READS]))
    out = []
    for i in range(0, 96, 3):
        a, b, c = recs[i], recs[i + 1], recs[i + 2]
        out.append(a)
        out.append((b[0] + "_x2", b[1] + c[1], b[2] + c[2]))
        out.append((c[0] + "_x3", a[1] + b[1] + c[1], a[2] + b[2] + c[2]))
    return out


def _write_fastq(path, recs):
    with open(path, "w") as f:
        for h, s, q in recs:
            f.write(f"@{h}\n{s.decode()}\n+\n{q.decode()}\n")


@pytest.fixture(scope="module")
def engines(golden_db):
    """One engine of each package at -p 4, 64 rows (JAX's compiled once
    a bucket for the module)."""
    jreg = jregistry_for(None, force=True)
    treg = tregistry_for(None, force=True)
    return {"jax": jserve.CorrectionEngine(golden_db, cutoff=4, rows=ROWS,
                                           registry=jreg),
            "port": tserve.CorrectionEngine(golden_db, cutoff=4, rows=ROWS,
                                            device="cpu", registry=treg)}


@pytest.fixture(scope="module")
def expected(golden_db, tmp_path_factory):
    """The port's offline bytes for the golden reads and for the mixed
    set, one (fa, log) pair a record (split from the files)."""
    d = tmp_path_factory.mktemp("serve_off")
    mixed = str(d / "mixed.fastq")
    _write_fastq(mixed, _mixed_records())
    return {"golden": _offline(golden_db, READS, str(d / "golden")),
            "mixed": _offline(golden_db, mixed, str(d / "mixed"))}


def _steps(eng, recs, width):
    out = []
    for i in range(0, len(recs), width):
        out += eng.step(recs[i:i + width])
    return out


@pytest.mark.parametrize("case", ["one", "many", "mixed"])
def test_engine_steps_match_jax_and_the_offline_cli(engines, expected,
                                                    case):
    """Exact bytes: every record's (fa, log) equal across the packages,
    and their concatenation equal to the offline CLI's files."""
    if case == "mixed":
        recs, width, off = _mixed_records(), ROWS, expected["mixed"]
    else:
        recs = list(tfastq.iter_records([READS]))
        off = expected["golden"]
        # one record a step costs a padded 64-row step each: a prefix
        recs, width = (recs[:12], 1) if case == "one" else (recs, ROWS)
    got = {name: _steps(eng, recs, width) for name, eng in engines.items()}
    assert got["port"] == got["jax"]
    assert len(got["port"]) == len(recs)
    fa = "".join(r[0] for r in got["port"])
    log = "".join(r[1] for r in got["port"])
    # the offline files' first records (every file ends in a newline)
    assert off[0].startswith(fa) and off[1].startswith(log)
    if case != "one":
        assert (fa, log) == off
    else:
        assert fa.count(">") + log.count("Skipped") == len(recs)
    if case == "mixed":
        assert {len(s) for _h, s, _q in recs} == {60, 120, 180}


@pytest.mark.parametrize("length", [13, 60, 150])
def test_representative_read_matches_jax(engines, length):
    j, t = engines["jax"], engines["port"]
    assert t_rep(t.state, t.meta, length) == j_rep(j.state, j.meta, length)


def test_engine_compiles_equal_after_the_same_warmup_and_traffic(
        golden_db):
    """`engine_compiles` is the count of distinct (rows, bucket) shapes
    first seen, in both packages: the warmup's, then no new one for
    traffic inside its buckets, then one for a new bucket."""
    recs = list(tfastq.iter_records([READS]))
    counts = {}
    for name, mod, kw in (("jax", jserve, {}),
                          ("port", tserve, {"device": "cpu"})):
        reg = PKGS[name].registry_for(None, force=True)
        eng = mod.CorrectionEngine(golden_db, cutoff=4, rows=ROWS,
                                   registry=reg, **kw)
        seen = [eng.warmup([60, 100])]
        seen.append(reg.counter("engine_compiles").value)
        eng.step(recs[:5])
        seen.append(reg.counter("engine_compiles").value)
        eng.step([("long", recs[0][1] * 3, recs[0][2] * 3)])
        seen += [reg.counter("engine_compiles").value, eng.compiles,
                 eng.warm_lengths]
        counts[name] = seen
    assert counts["port"] == counts["jax"] == [2, 2, 2, 3, 3,
                                               (64, 128, 192)]


def test_warmup_keeps_its_representative_read(golden_db):
    """The port's engine records the read its warmup stepped (the walk
    at the longest length) and no fallback."""
    eng = tserve.CorrectionEngine(golden_db, cutoff=4, rows=ROWS,
                                  device="cpu",
                                  registry=tregistry_for(None, force=True))
    assert eng.warmup_read is None and eng.warmup_fallbacks == 0
    assert eng.warmup([60, 100]) == 2
    assert eng.warmup_read == t_rep(eng.state, eng.meta, 100)
    assert eng.warmup_fallbacks == 0


def test_warmup_fallback_is_counted(golden_db, monkeypatch):
    """A walk that raises (a failed lookup launch on a card) leaves the
    warmup on all-A reads, and the engine counts the fallback."""
    import quorum_tpu_torch.serve.engine as tengine

    def broken(*_a, **_k):
        raise RuntimeError("lookup launch failed")

    monkeypatch.setattr(tengine, "representative_read", broken)
    eng = tserve.CorrectionEngine(golden_db, cutoff=4, rows=ROWS,
                                  device="cpu",
                                  registry=tregistry_for(None, force=True))
    assert eng.warmup([60]) == 1
    assert eng.warmup_read is None and eng.warmup_fallbacks == 1


# ---------------------------------------------------------------------------
# HTTP parity: a JAX server and a port server side by side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers(engines):
    """Each package's server over its real engine; quotas on a frozen
    clock so 429's Retry-After is deterministic."""
    out = {}
    for name, p in PKGS.items():
        reg = p.registry_for(None, force=True)
        bat = p.serve.DynamicBatcher(engines[name], max_batch=ROWS,
                                     max_wait_ms=1, queue_requests=8,
                                     registry=reg)
        quota = p.serve.TokenBucketQuota(0.5, burst=1, clock=lambda: 0.0)
        out[name] = p.serve.CorrectionServer(bat, port=0, registry=reg,
                                             quota=quota)
    yield out
    for srv in out.values():
        srv.close()


def _raw(port, method, path, body=b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, dict(resp.headers), resp.read()
    finally:
        conn.close()


GOLDEN_BODY = open(READS, "rb").read()
HTTP_CASES = {
    "plain": ("/correct", GOLDEN_BODY, {}),
    "log": ("/correct?log=1", GOLDEN_BODY, {}),
    "gzip_in": ("/correct", gzip.compress(GOLDEN_BODY),
                {"Content-Encoding": "gzip"}),
    "gzip_out": ("/correct", GOLDEN_BODY, {"Accept-Encoding": "gzip"}),
    "bad_fastq_400": ("/correct", b"@r\nACGT\n+\nII\n", {}),
    "bad_gzip_400": ("/correct", b"not gzip", {"Content-Encoding": "gzip"}),
    "chunked_411": ("/correct", b"", {"Transfer-Encoding": "chunked"}),
    "huge_413": ("/correct", b"", {"Content-Length": str(1 << 40)}),
    "coding_415": ("/correct", b"x", {"Content-Encoding": "br"}),
    "ingest_501": ("/ingest", b"", {}),
    "epoch_501": ("/epoch", b"", {}),
    "no_route_404": ("/nope", b"", {}),
}
# what differs between two servers by design: the request id (random
# when the client sends none), the phase timings and the length of the
# gzip framing (the same compressor and level in both)
_VOLATILE = {"X-Quorum-Request-Id", "X-Quorum-Phases", "Date", "Server"}


@pytest.mark.parametrize("case", list(HTTP_CASES))
def test_http_answers_equal_jax(servers, case):
    path, body, headers = HTTP_CASES[case]
    got = {}
    for name, srv in servers.items():
        if case in ("huge_413", "chunked_411"):
            # the server answers from the headers alone, before reading
            # a body: send none (a body sent after the answer closed the
            # connection would break the pipe)
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=60)
            conn.putrequest("POST", path)
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.endheaders()
            resp = conn.getresponse()
            got[name] = (resp.status, dict(resp.headers), resp.read())
            conn.close()
            continue
        got[name] = _raw(srv.port, "POST", path, body, headers)
    (js, jh, jb), (ts, th, tb) = got["jax"], got["port"]
    assert ts == js
    if th.get("Content-Encoding") == "gzip":
        assert jh.get("Content-Encoding") == "gzip"
        jb, tb = gzip.decompress(jb), gzip.decompress(tb)
        jh.pop("Content-Length")
        th.pop("Content-Length")
    assert tb == jb
    assert {k: v for k, v in th.items() if k not in _VOLATILE} == \
        {k: v for k, v in jh.items() if k not in _VOLATILE}
    if ts == 200 and case != "log":
        assert tb.startswith(b">")


def test_quota_429_and_retry_after_equal_jax(servers):
    """A client with a one-token bucket: 200, then 429 with the same
    Retry-After and body in both packages."""
    out = {}
    for name, srv in servers.items():
        hdr = {"X-Quorum-Client": "greedy"}
        first = _raw(srv.port, "POST", "/correct", b"@a\nACGT\n+\nIIII\n",
                     hdr)
        second = _raw(srv.port, "POST", "/correct", b"@a\nACGT\n+\nIIII\n",
                      hdr)
        out[name] = (first[0], first[2], second[0],
                     second[1]["Retry-After"], second[2])
    assert out["port"] == out["jax"]
    assert out["port"][2] == 429 and int(out["port"][3]) >= 1


def test_healthz_keys_equal_jax(servers):
    keys = {}
    for name, srv in servers.items():
        status, _h, body = _raw(srv.port, "GET", "/healthz")
        assert status == 200
        keys[name] = set(json.loads(body))
    assert keys["port"] == keys["jax"]
    status, _h, body = _raw(servers["port"].port, "GET", "/debug/flight")
    assert status == 404 and json.loads(body) == {
        "error": "no flight recorder"}


def test_metrics_route_lints_clean(servers):
    status, _h, body = _raw(servers["port"].port, "GET", "/metrics")
    assert status == 200
    text = body.decode()
    assert texport.lint_prometheus_text(text) == []
    assert "quorum_tpu_engine_compiles_total" in text


# ---------------------------------------------------------------------------
# behaviour on stub engines, each scenario on both packages
# ---------------------------------------------------------------------------

class FakeEngine:
    """Engine-shaped stub: echoes each read as a one-line .fa record,
    optionally blocking on an Event so tests control dispatch."""

    def __init__(self, gate=None, rows=1024, **_kw):
        self.gate = gate
        self.rows = rows
        self.stepped = 0
        self.entered = threading.Event()  # a step actually began

    @property
    def compiles(self):
        return 0

    def step(self, records):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(timeout=30), "test gate never opened"
        self.stepped += 1
        return [(f">{h}\n{s.decode()}\n", "") for h, s, _q in records]


class PoisonEngine(FakeEngine):
    """Raises whenever a batch holds a record named 'poison'."""

    def step(self, records):
        self.stepped += 1
        if any(h == "poison" for h, _s, _q in records):
            raise RuntimeError("poisoned batch")
        return [(f">{h}\n{s.decode()}\n", "") for h, s, _q in records]


class HangEngine(FakeEngine):
    """A step wedges (until `release`) when a record is named 'hang'."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.release = threading.Event()

    def step(self, records):
        self.entered.set()
        if any(h == "hang" for h, _s, _q in records):
            self.release.wait(timeout=60)
            raise RuntimeError("hung step released by test teardown")
        self.stepped += 1
        return [(f">{h}\n{s.decode()}\n", "") for h, s, _q in records]


class OrderEngine(FakeEngine):
    """Records the header order of stepped reads."""

    def __init__(self, gate=None, **kw):
        super().__init__(gate=gate, **kw)
        self.order: list[str] = []

    def step(self, records):
        res = super().step(records)
        self.order.extend(h for h, _s, _q in records)
        return res


def _drain_to_depth(batcher, depth=0, timeout=5.0):
    t0 = time.perf_counter()
    while batcher.depth > depth:
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"queue stuck at {batcher.depth}")
        time.sleep(0.005)


def test_batcher_429_on_full_queue(pkg):
    gate = threading.Event()
    reg = pkg.registry_for(None, force=True)
    bat = pkg.serve.DynamicBatcher(FakeEngine(gate), max_batch=4,
                                   max_wait_ms=0, queue_requests=1,
                                   registry=reg)
    recs = [("r", b"ACGT", b"IIII")]
    fa = bat.submit(recs)
    _drain_to_depth(bat, 0)
    fb = bat.submit(recs)
    with pytest.raises(pkg.serve.QueueFull) as ei:
        bat.submit(recs)
    assert ei.value.retry_after > 0
    assert reg.counter("requests_rejected_queue_full").value == 1
    gate.set()
    assert fa.result(timeout=10)[0][0].startswith(">r")
    assert fb.result(timeout=10)[0][0].startswith(">r")
    assert bat.drain(timeout=5)


def test_batcher_deadline_exceeded(pkg):
    gate = threading.Event()
    reg = pkg.registry_for(None, force=True)
    bat = pkg.serve.DynamicBatcher(FakeEngine(gate), max_batch=4,
                                   max_wait_ms=0, queue_requests=8,
                                   registry=reg)
    recs = [("r", b"ACGT", b"IIII")]
    fa = bat.submit(recs)
    _drain_to_depth(bat, 0)
    fb = bat.submit(recs, deadline_s=0.01)
    time.sleep(0.05)
    gate.set()
    assert fa.result(timeout=10)
    with pytest.raises(pkg.serve.DeadlineExceeded):
        fb.result(timeout=10)
    assert reg.counter("requests_deadline_exceeded").value == 1
    assert bat.drain(timeout=5)


def test_server_http_504_429_and_drain_503(pkg):
    """504 past the deadline, 429 + Retry-After on a full queue, 503
    while draining."""
    gate = threading.Event()
    reg = pkg.registry_for(None, force=True)
    eng = FakeEngine(gate)
    bat = pkg.serve.DynamicBatcher(eng, max_batch=4, max_wait_ms=0,
                                   queue_requests=1, registry=reg)
    srv = pkg.serve.CorrectionServer(bat, port=0, registry=reg,
                                     drain_grace_s=5.0)
    body = "@r\nACGT\n+\nIIII\n"
    try:
        t1 = threading.Thread(
            target=lambda: ServeClient(port=srv.port).correct(body),
            daemon=True)
        t1.start()
        assert eng.entered.wait(5)
        _drain_to_depth(bat, 0)
        assert ServeClient(port=srv.port).correct(
            body, deadline_ms=10).status == 504
        r = ServeClient(port=srv.port).correct(body)
        assert r.status == 429 and r.retry_after_s >= 1
        gate.set()
        t1.join(timeout=10)
        _drain_to_depth(bat, 0)
        assert ServeClient(port=srv.port).quiesce()["status"] == "draining"
        deadline = time.perf_counter() + 5
        while True:
            r = ServeClient(port=srv.port).correct(body)
            if r.status == 503:
                break
            assert time.perf_counter() < deadline, r.status
            time.sleep(0.02)
        srv.serve_until_drained()
        assert reg.meta["drained"] is True
    finally:
        gate.set()
        srv.close()


def test_bisection_isolates_a_poisoned_request(pkg):
    reg = pkg.registry_for(None, force=True)
    bat = pkg.serve.DynamicBatcher(PoisonEngine(), max_batch=8,
                                   max_wait_ms=100, queue_requests=8,
                                   max_consecutive_failures=3, registry=reg)
    try:
        good = bat.submit([("good", b"ACGT", b"IIII")])
        poison = bat.submit([("poison", b"ACGT", b"IIII")])
        assert good.result(timeout=10) == [(">good\nACGT\n", "")]
        with pytest.raises(RuntimeError, match="poisoned"):
            poison.result(timeout=10)
        assert reg.counter("batch_bisections").value == 1
        assert reg.counter("requests_failed").value == 1
        later = bat.submit([("later", b"GG", b"II")])
        assert later.result(timeout=10) == [(">later\nGG\n", "")]
        assert bat.healthy
    finally:
        bat.drain(timeout=5)


def test_hedging_isolates_innocent_batchmates(pkg):
    reg = pkg.registry_for(None, force=True)
    bat = pkg.serve.DynamicBatcher(PoisonEngine(), max_batch=8,
                                   max_wait_ms=200, queue_requests=8,
                                   max_hedges=8, registry=reg)
    try:
        a = bat.submit([("a", b"AC", b"II")])
        b = bat.submit([("b", b"AC", b"II")])
        c = bat.submit([("poison", b"AC", b"II")])
        d = bat.submit([("d", b"AC", b"II")])
        assert a.result(timeout=10) == [(">a\nAC\n", "")]
        assert b.result(timeout=10) == [(">b\nAC\n", "")]
        with pytest.raises(RuntimeError, match="poisoned"):
            c.result(timeout=10)
        assert d.result(timeout=10) == [(">d\nAC\n", "")]
        assert reg.counter("batch_bisections").value == 1
        assert reg.counter("hedges_total").value == 2
        assert reg.counter("requests_failed").value == 1
    finally:
        bat.drain(timeout=5)


def test_watchdog_contains_a_hung_step_and_restarts(pkg):
    reg = pkg.registry_for(None, force=True)
    hung, fresh = HangEngine(), FakeEngine()
    bat = pkg.serve.DynamicBatcher(hung, max_batch=8, max_wait_ms=0,
                                   queue_requests=8, step_timeout_ms=150,
                                   engine_factory=lambda old: fresh,
                                   registry=reg)
    try:
        f = bat.submit([("hang", b"ACGT", b"IIII")])
        with pytest.raises(pkg.serve.EngineStepTimeout):
            f.result(timeout=10)
        assert reg.counter("engine_step_timeouts").value == 1
        assert reg.counter("engine_restarts_total").value == 1
        assert bat.current_engine() is fresh and bat.generation == 1
        ok = bat.submit([("ok", b"AC", b"II")])
        assert ok.result(timeout=10) == [(">ok\nAC\n", "")]
    finally:
        hung.release.set()
        bat.drain(timeout=5)


def test_watchdog_survives_a_wedged_rebuild(pkg):
    reg = pkg.registry_for(None, force=True)
    hung = HangEngine()
    release_build = threading.Event()

    def wedged_factory(_old):
        release_build.wait(timeout=60)
        return FakeEngine()

    bat = pkg.serve.DynamicBatcher(hung, max_batch=8, max_wait_ms=0,
                                   queue_requests=8, step_timeout_ms=100,
                                   max_consecutive_failures=2,
                                   engine_factory=wedged_factory,
                                   registry=reg)
    bat.rebuild_timeout_s = 0.2
    try:
        for _ in range(2):
            f = bat.submit([("hang", b"ACGT", b"IIII")])
            with pytest.raises(pkg.serve.EngineStepTimeout):
                f.result(timeout=10)
        assert reg.counter("engine_rebuild_failures").value == 2
        assert reg.counter("engine_restarts_total").value == 0
        assert bat.current_engine() is hung
        assert not bat.healthy
    finally:
        release_build.set()
        hung.release.set()
        bat.drain(timeout=5)


def test_failure_streak_flips_healthz_and_heals(pkg):
    reg = pkg.registry_for(None, force=True)
    bat = pkg.serve.DynamicBatcher(PoisonEngine(), max_batch=8,
                                   max_wait_ms=0, queue_requests=8,
                                   max_consecutive_failures=2, registry=reg)
    srv = pkg.serve.CorrectionServer(bat, port=0, registry=reg)
    try:
        client = ServeClient(port=srv.port)
        for _ in range(2):
            f = bat.submit([("poison", b"ACGT", b"IIII")])
            with pytest.raises(RuntimeError):
                f.result(timeout=10)
        code, h = client.healthz_full()
        assert code == 503 and h["status"] == "unhealthy"
        assert h["consecutive_failures"] == 2
        r = client.correct("@ok\nACGT\n+\nIIII\n")
        assert r.status == 200 and r.fa == ">ok\nACGT\n"
        code, h = client.healthz_full()
        assert code == 200 and h["status"] == "ok"
        r = client.correct("@poison\nACGT\n+\nIIII\n")
        assert r.status == 500 and "poisoned" in r.error
    finally:
        srv.close()


def test_weighted_lanes_pop_order(pkg):
    reg = pkg.registry_for(None, force=True)
    gate = threading.Event()
    eng = OrderEngine(gate)
    bat = pkg.serve.DynamicBatcher(eng, max_batch=1, max_wait_ms=0,
                                   queue_requests=32, interactive_weight=2,
                                   registry=reg)
    try:
        r0 = bat.submit([("r0", b"A", b"I")])
        assert eng.entered.wait(5)
        _drain_to_depth(bat, 0)
        bulk = [bat.submit([(f"b{i}", b"A", b"I")], priority="bulk")
                for i in range(4)]
        inter = [bat.submit([(f"i{i}", b"A", b"I")]) for i in range(4)]
        gate.set()
        for f in [r0] + bulk + inter:
            assert f.result(timeout=10)
        assert eng.order == ["r0", "i0", "b0", "i1", "i2", "b1", "i3",
                             "b2", "b3"]
        doc = reg.as_dict()
        assert doc["gauges"][labeled("queue_depth", lane="bulk")] >= 1
        assert doc["histograms"][labeled("lane_wait_us",
                                         lane="bulk")]["count"] == 4
        with pytest.raises(ValueError, match="unknown priority"):
            bat.submit([("x", b"A", b"I")], priority="urgent")
    finally:
        bat.drain(timeout=5)


def test_swap_engine_conditional_on_generation(pkg):
    reg = pkg.registry_for(None, force=True)
    bat = pkg.serve.DynamicBatcher(FakeEngine(), max_batch=8,
                                   max_wait_ms=0, queue_requests=8,
                                   registry=reg)
    try:
        e1, e2 = FakeEngine(), FakeEngine()
        gen0 = bat.generation
        assert bat.swap_engine(e1) == gen0 + 1
        assert bat.swap_engine(e2, expected_generation=gen0) == -1
        assert bat.current_engine() is e1
        assert reg.gauge("engine_generation").value == gen0 + 1
    finally:
        bat.drain(timeout=5)


def test_reload_swaps_and_rolls_back(pkg):
    reg = pkg.registry_for(None, force=True)
    bat = pkg.serve.DynamicBatcher(FakeEngine(), max_batch=8,
                                   max_wait_ms=0, queue_requests=8,
                                   registry=reg)

    class Tagged(FakeEngine):
        def __init__(self, tag):
            super().__init__()
            self.tag = tag

        def step(self, records):
            return [(f">{self.tag}:{h}\n", "") for h, _s, _q in records]

    def make_engine(params):
        if params.get("boom"):
            raise ValueError("bad db header")
        if params.get("crash"):
            raise RuntimeError("build exploded")
        return Tagged(params.get("tag", "new"))

    srv = pkg.serve.CorrectionServer(bat, port=0, registry=reg,
                                     engine_builder=make_engine)
    body = "@r\nACGT\n+\nIIII\n"
    try:
        client = ServeClient(port=srv.port)
        assert client.correct(body).fa == ">r\nACGT\n"
        code, doc = client.reload({"tag": "g1"})
        assert code == 200 and doc["generation"] == 1
        assert client.correct(body).fa == ">g1:r\n"
        code, doc = client.reload({"boom": 1})
        assert code == 400 and doc["rolled_back"] is True
        code, doc = client.reload({"crash": 1})
        assert code == 500 and doc["rolled_back"] is True
        pkg.faults.install(pkg.faults.FaultPlan.parse(
            {"site": "serve.reload", "action": "error"}), "t-reload")
        try:
            code, doc = client.reload({"tag": "g2"})
        finally:
            pkg.faults.reset()
        assert code == 500 and doc["rolled_back"] is True
        assert client.correct(body).fa == ">g1:r\n"
        assert reg.counter("reload_total").value == 1
        assert reg.counter("reload_failures_total").value == 3
    finally:
        pkg.faults.reset()
        srv.close()


def test_quota_semantics_and_lru_eviction(pkg):
    clock = [0.0]
    q = pkg.serve.TokenBucketQuota(2.0, burst=2, clock=lambda: clock[0])
    assert q.admit("a") == (True, 0.0)
    assert q.admit("a") == (True, 0.0)
    ok, retry = q.admit("a")
    assert not ok and retry == pytest.approx(0.5)
    assert q.admit("b")[0]
    clock[0] += 0.6
    assert q.admit("a")[0]
    lru = pkg.serve.TokenBucketQuota(1.0, burst=2, max_clients=3,
                                     clock=lambda: 0.0)
    for name in ("a", "b", "c"):
        assert lru.admit(name)[0]
    assert lru.admit("a")[0]
    assert lru.admit("d")[0]
    assert lru.clients == 3
    assert not lru.admit("a")[0]
    assert lru.admit("b")[0]
    with pytest.raises(ValueError):
        pkg.serve.TokenBucketQuota(0)


def test_request_id_echo_and_phase_sums(pkg, tmp_path):
    evts = str(tmp_path / "events.jsonl")
    reg = pkg.registry_for(None, events_path=evts)
    bat = pkg.serve.DynamicBatcher(FakeEngine(), max_batch=8,
                                   max_wait_ms=1, queue_requests=8,
                                   registry=reg)
    srv = pkg.serve.CorrectionServer(bat, port=0, registry=reg)
    try:
        client = ServeClient(port=srv.port)
        r1 = client.correct("@a\nACGT\n+\nIIII\n")
        r2 = client.correct("@b\nAC\n+\nII\n")
        r3 = client.correct("@c\nAC\n+\nII\n", request_id="my-trace-7")
        assert r1.status == r2.status == r3.status == 200
        assert r1.request_id != r2.request_id
        assert r3.request_id == "my-trace-7"
        ph = r1.phases
        parts = (ph["admission_us"] + ph["queue_us"] + ph["device_us"]
                 + ph["hedge_us"] + ph["render_us"])
        assert 0 <= parts <= ph["total_us"]
    finally:
        srv.close()
    with open(evts) as f:
        reqs = [o for o in (json.loads(ln) for ln in f if ln.strip())
                if o.get("event") == "request"]
    assert len(reqs) == 3
    for o in reqs:
        assert validate_events_line(o) == []
    assert ({o["request_id"] for o in reqs}
            == {r1.request_id, r2.request_id, "my-trace-7"})


def test_admit_fault_is_a_retryable_503(pkg):
    reg = pkg.registry_for(None, force=True)
    bat = pkg.serve.DynamicBatcher(FakeEngine(), max_batch=8,
                                   max_wait_ms=0, queue_requests=8,
                                   registry=reg)
    srv = pkg.serve.CorrectionServer(bat, port=0, registry=reg)
    try:
        pkg.faults.install(pkg.faults.FaultPlan.parse(
            {"site": "serve.admit", "action": "error"}), "t-admit")
        r = ServeClient(port=srv.port).correct("@r\nAC\n+\nII\n")
        assert r.status == 503 and r.retry_after_s >= 1
        assert reg.counter("requests_rejected_admission").value == 1
        pkg.faults.reset()
        assert ServeClient(port=srv.port).correct(
            "@r\nAC\n+\nII\n").status == 200
    finally:
        pkg.faults.reset()
        srv.close()


def test_dispatcher_death_fails_queued_futures(pkg, monkeypatch):
    reg = pkg.registry_for(None, force=True)
    gate = threading.Event()
    eng = FakeEngine(gate)
    bat = pkg.serve.DynamicBatcher(eng, max_batch=4, max_wait_ms=0,
                                   queue_requests=8, registry=reg)
    recs = [("r", b"ACGT", b"IIII")]
    f1 = bat.submit(recs)
    assert eng.entered.wait(5)
    _drain_to_depth(bat, 0)
    f2 = bat.submit(recs)

    def boom():
        raise AssertionError("dispatch loop bug")

    monkeypatch.setattr(bat, "_take_locked", boom)
    gate.set()
    assert f1.result(timeout=10)
    with pytest.raises(RuntimeError, match="dispatcher exited"):
        f2.result(timeout=10)
    bat._thread.join(timeout=5)
    assert not bat.healthy
    assert reg.counter("dispatcher_crashes").value == 1
    with pytest.raises(pkg.serve.Draining):
        bat.submit(recs)


# ---------------------------------------------------------------------------
# the kernel loader under threads
# ---------------------------------------------------------------------------

def test_library_builds_once_for_concurrent_first_users(monkeypatch,
                                                        tmp_path):
    """8 threads ask for one library at once: one build, one load, and
    every thread gets the same object."""
    calls = {"build": 0, "load": 0}
    name = "tile_lookup"

    def fake_build():
        calls["build"] += 1
        time.sleep(0.05)  # a slow build widens the race window
        open(os.path.join(str(tmp_path), f"lib{name}.so"), "w").close()
        return {}

    class FakeLib:
        def __getattr__(self, fn):
            f = types.SimpleNamespace()
            setattr(self, fn, f)
            return f

    def fake_cdll(path):
        calls["load"] += 1
        return FakeLib()

    monkeypatch.setattr(loader, "_LIBS", {})
    monkeypatch.setattr(loader, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(loader, "build_all", fake_build)
    monkeypatch.setattr(loader.ctypes, "CDLL", fake_cdll)
    start = threading.Barrier(8)
    got = []

    def user():
        start.wait()
        got.append(loader.library(name))

    threads = [threading.Thread(target=user) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "load": 1}
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_launch_counts_are_exact_across_threads(monkeypatch):
    """N threads (more than the cores) x M launches count exactly N x M,
    with the interpreter switching threads as often as it can."""
    n_threads, m = (os.cpu_count() or 1) + 4, 2000
    monkeypatch.setattr(loader.STATS, "launches",
                        dict.fromkeys(loader.COUNTERS, 0))
    start = threading.Barrier(n_threads)
    seen = []

    def user(i):
        start.wait()
        for _ in range(m):
            with loader.launching("tile_lookup"):
                pass
        with loader.launching("event_scan"):
            seen.append((i, loader.STATS.current))

    threads = [threading.Thread(target=user, args=(i,))
               for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert loader.STATS.launches["tile_lookup"] == n_threads * m
    assert loader.STATS.launches["event_scan"] == n_threads
    assert all(cur == "event_scan" for _i, cur in seen)
    assert loader.STATS.current is None
