"""The port's telemetry core against the JAX package's, on the CPU: the
same registry calls give the same documents and event streams; both
schema validators accept and reject the same corpus; the port's span
JSONL and Chrome twin pass the JAX validators; the lever catalog is a
subset of JAX's with equal rows, and no module of the port reads a
QUORUM_* variable outside utils/levers.py; StageTimer tables, quality
sections and scorecard windows agree; a v5 load and a refused one land
the same integrity counters in both packages."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import ast
import json
import os
import re
import threading

import numpy as np
import pytest
import torch

from quorum_tpu.io import db_format as jdb
from quorum_tpu.io import integrity as jint
from quorum_tpu.telemetry import quality as jquality
from quorum_tpu.telemetry import registry as jreg
from quorum_tpu.telemetry import schema as jschema
from quorum_tpu.utils import levers as jlevers
from quorum_tpu.utils import profiling as jprof
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import integrity as tint
from quorum_tpu_torch.telemetry import quality as tquality
from quorum_tpu_torch.telemetry import registry as treg
from quorum_tpu_torch.telemetry import schema as tschema
from quorum_tpu_torch.telemetry import spans as tspans
from quorum_tpu_torch.utils import levers as tlevers
from quorum_tpu_torch.utils import profiling as tprof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "quorum_tpu_torch")
READS = os.path.join(ROOT, "tests", "golden", "reads.fastq")
TIME_KEYS = ("t", "elapsed_s", "gb_per_h")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- registry


def _drive(mod, path):
    """One fixed sequence of registry calls, threads included."""
    reg = mod.registry_for(path, heartbeat_s=0.0,
                           events_path=path + ".events.jsonl")
    reg.set_meta(stage="create_database", k=13, bits=7)
    reg.counter("reads").inc(242)
    reg.counter("hash_grows")
    reg.gauge("hash_fill").set(0.013447)
    reg.gauge("queue_depth_max").set_max(3)
    reg.gauge("queue_depth_max").set_max(2)
    reg.gauge("stall_seconds").add(0.5)
    reg.gauge(mod.labeled("partition_distinct", partition=3)).set(7)
    h = reg.histogram("substitutions_per_read")
    for v, n in ((0, 10), (1, 4), (2, 1), (-3, 2)):
        h.observe(v, n)

    def worker(i):
        for _ in range(100):
            reg.counter("bases").inc(i)
            reg.histogram("render_ms").observe(i)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert not any(t.is_alive() for t in ts)
    reg.set_timer("stage1", {"total_seconds": 1.0, "stages": {}})
    reg.event("hash_grow", rows_before=4096, rows_after=8192)
    reg.heartbeat(stage="create_database", reads=242, bases=14520)
    mod.observe_dispatch_wait(reg, "insert", 0.0, 0.25, 0.5)
    reg.write()
    return reg


def test_registry_documents_and_events_equal(tmp_path):
    jr = _drive(jreg, str(tmp_path / "j.json"))
    tr = _drive(treg, str(tmp_path / "t.json"))
    with open(tmp_path / "j.json") as f:
        jdoc = json.load(f)
    with open(tmp_path / "t.json") as f:
        tdoc = json.load(f)
    assert tdoc == jdoc
    assert tr.as_dict() == jr.as_dict()

    def events(p):
        with open(p) as f:
            return [{k: v for k, v in json.loads(ln).items()
                     if k not in TIME_KEYS} for ln in f]
    assert events(tmp_path / "t.json.events.jsonl") == \
        events(tmp_path / "j.json.events.jsonl")
    assert not tschema.validate_metrics(tdoc)


def test_null_registry_and_tracer_are_noops(tmp_path):
    assert treg.registry_for(None) is treg.NULL
    assert tspans.tracer_for(None) is tspans.NULL_TRACER
    reg = treg.NULL
    reg.counter("x").inc()
    reg.histogram("y").observe(3)
    assert reg.as_dict() == jreg.NULL.as_dict()
    assert reg.write() is None and not os.listdir(tmp_path)


# --------------------------------------------------------------- schema

_GOOD_DOC = {"schema": "quorum-tpu-metrics/1", "meta": {"k": 13},
             "counters": {"reads": 1}, "gauges": {"g": 0.5},
             "histograms": {"h": {"count": 2, "sum": 3,
                                  "counts": {"1": 1, "2": 1}}},
             "timers": {"stage1": {"total_seconds": 1.0, "stages": {
                 "seal": {"seconds": 0.1, "calls": 1, "units": 0}}}}}


def _with(doc, path, value):
    doc = json.loads(json.dumps(doc))
    cur = doc
    for key in path[:-1]:
        cur = cur[key]
    if value is KeyError:
        del cur[path[-1]]
    else:
        cur[path[-1]] = value
    return doc


CORPUS = [
    ("metrics", _GOOD_DOC),
    ("metrics", _with(_GOOD_DOC, ["schema"], "other/1")),
    ("metrics", _with(_GOOD_DOC, ["counters", "reads"], -1)),
    ("metrics", _with(_GOOD_DOC, ["counters", "reads"], 1.5)),
    ("metrics", _with(_GOOD_DOC, ["gauges", "g"], "x")),
    ("metrics", _with(_GOOD_DOC, ["meta", "k"], {"a": [1]})),
    ("metrics", _with(_GOOD_DOC, ["histograms", "h", "count"], 5)),
    ("metrics", _with(_GOOD_DOC, ["timers"], KeyError)),
    ("metrics", _with(_GOOD_DOC, ["timers", "stage1", "stages", "seal",
                                  "calls"], "one")),
    ("events", {"event": "heartbeat", "t": 0.5, "reads": 3}),
    ("events", {"event": "heartbeat", "t": "soon"}),
    ("events", {"t": 0.5}),
    ("events", {"event": "hash_grow", "t": 1, "rows": [1, 2]}),
    ("span", {"span": "seal", "id": 3, "parent": None, "tid": 0,
              "ts": 0.1, "dur": 0.2}),
    ("span", {"span": "seal", "id": "3", "parent": None, "ts": 0.1,
              "dur": 0.2}),
    ("span", {"span": "seal", "id": 3, "parent": 1.5, "ts": 0.1,
              "dur": 0.2}),
    ("span", {"id": 3, "ts": 0.1, "dur": 0.2}),
    ("chrome", {"traceEvents": [{"name": "seal", "ph": "X", "pid": 1,
                                 "tid": 0, "ts": 1.0, "dur": 2.0}]}),
    ("chrome", {"traceEvents": [{"name": "seal", "ph": "X"}]}),
    ("chrome", {"events": []}),
    ("quality", tquality.section_from_doc(
        {"counters": {"reads_in": 10, "reads_corrected": 9,
                      "reads_skipped": 1, "substitutions": 4,
                      "skipped_no_anchor": 1},
         "histograms": {"sub_pos_bucket": {"counts": {"3": 4}}}})),
    ("quality", {"schema": "quorum-tpu-quality/1", "reads": -1}),
]
_VALIDATORS = {"metrics": "validate_metrics", "events":
               "validate_events_line", "span": "validate_span_line",
               "chrome": "validate_chrome_trace",
               "quality": "validate_quality"}


@pytest.mark.parametrize("kind,doc", CORPUS)
def test_schema_validators_agree(kind, doc):
    name = _VALIDATORS[kind]
    assert getattr(tschema, name)(doc) == getattr(jschema, name)(doc)


def _code(path):
    """A module's statements without docstrings (comments are not in
    the tree), dumped one a top-level statement."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return [ast.dump(stmt) for stmt in tree.body]


@pytest.mark.parametrize("name", ["schema.py", "contract.py", "quality.py"])
def test_copied_modules_hold_jax_code(name):
    """The port's schema, contract and quality modules are the JAX
    package's code (docstrings and comments aside; the contract adds
    missing_names, the quality module imports the port's levers)."""
    jcode = _code(os.path.join(ROOT, "quorum_tpu", "telemetry", name))
    tcode = _code(os.path.join(PKG, "telemetry", name))
    extra = [c for c in tcode if c not in jcode]
    assert [c for c in jcode if c not in tcode] == []
    assert len(extra) == (1 if name == "contract.py" else 0)


# ---------------------------------------------------------------- spans


def test_port_spans_pass_jax_validators(tmp_path):
    path = str(tmp_path / "s.jsonl")
    tr = tspans.tracer_for(path)
    with tr.span("stage2_batch", step=0, reads=3):
        with tr.step("stage2_device", 0, reads=3):
            pass
        with tr.span("fetch"):
            pass

    def render():
        with tr.span("render", reads=np.int64(3)):
            pass
    t = threading.Thread(target=render)
    t.start()
    t.join(10)
    assert not t.is_alive()
    tr.close()
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert sorted(s["span"] for s in lines) == [
        "fetch", "render", "stage2_batch", "stage2_device"]
    for obj in lines:
        assert jschema.validate_span_line(obj) == []
    by = {s["span"]: s for s in lines}
    assert by["stage2_device"]["parent"] == by["stage2_batch"]["id"]
    assert by["stage2_device"]["step"] == 0
    assert by["render"]["tid"] != by["stage2_batch"]["tid"]
    with open(tspans.chrome_trace_path(path)) as f:
        chrome = json.load(f)
    assert jschema.validate_chrome_trace(chrome) == []
    assert len(chrome["traceEvents"]) == 4


def test_step_annotation_reaches_the_profiler():
    """A step's profiler range is `name#step` (devtrace's window)."""
    from torch.profiler import ProfilerActivity, profile

    tr = tspans.tracer_for(None, annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.step("stage1_insert", 7):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "stage1_insert#7" in names
    assert tr.path is None and tr.chrome_path is None


# --------------------------------------------------------------- levers


def test_lever_catalog_is_a_subset_of_jax():
    assert set(tlevers.names()) <= set(jlevers.names())
    for name in tlevers.names():
        t, j = tlevers.CATALOG[name], jlevers.CATALOG[name]
        # the same row, the JAX doc's trailing "(TAG N)" aside
        assert (t.type, t.default, t.doc) == (
            j.type, j.default, re.sub(r" \([A-Z]+ \d+\)", "", j.doc))
    with pytest.raises(KeyError):
        tlevers.raw("QUORUM_NOT_A_LEVER")


@pytest.mark.parametrize("val", [None, "", " ", "0", "false", "No", "1",
                                 "yes", "anything"])
def test_get_bool_matches_jax(monkeypatch, val):
    if val is None:
        monkeypatch.delenv("QUORUM_TPU_VERBOSE", raising=False)
    else:
        monkeypatch.setenv("QUORUM_TPU_VERBOSE", val)
    for default in (False, True):
        assert tlevers.get_bool("QUORUM_TPU_VERBOSE", default) == \
            jlevers.get_bool("QUORUM_TPU_VERBOSE", default)


def _env_reads(path):
    """(line, name) of every os.environ / os.getenv read of a literal
    QUORUM_* name in one file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        lit = None
        if isinstance(node, ast.Subscript) and \
                ast.unparse(node.value) == "os.environ":
            lit = node.slice
        elif isinstance(node, ast.Call) and ast.unparse(node.func) in (
                "os.environ.get", "os.getenv", "os.environ.setdefault"):
            lit = node.args[0] if node.args else None
        if isinstance(lit, ast.Constant) and isinstance(lit.value, str) \
                and lit.value.startswith("QUORUM_"):
            yield node.lineno, lit.value


def test_no_quorum_env_read_outside_levers():
    bad, named = [], set()
    for d, _dirs, files in os.walk(PKG):
        for f in files:
            path = os.path.join(d, f)
            if not f.endswith(".py") or os.path.relpath(path, PKG) == \
                    os.path.join("utils", "levers.py"):
                continue
            bad += [(path, ln, n) for ln, n in _env_reads(path)]
            tree = ast.parse(open(path).read(), path)
            named |= {node.value for node in ast.walk(tree)
                      if isinstance(node, ast.Constant)
                      and isinstance(node.value, str)
                      and re.fullmatch(r"QUORUM_[A-Z0-9_]+", node.value)}
    assert not bad
    # every catalogued lever is named (read) somewhere, and only those
    assert named == set(tlevers.names())


# ---------------------------------------------------------- stage timer


def test_stage_timer_tables_equal(monkeypatch):
    tables = []
    for mod in (jprof, tprof):
        clock = iter(float(x) for x in range(100))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        t = mod.StageTimer()
        with t.stage("seal"):
            pass
        with t.stage("seal"):
            pass
        t.add_units("insert_wait", 14520)
        t.add_time("insert_dispatch", 0.25)
        t.add_time("insert_wait", 0.5, calls=2)
        tables.append(t.as_dict(14520))
        monkeypatch.undo()
    assert tables[0] == tables[1]
    assert tables[1]["stages"]["seal"]["calls"] == 2


# -------------------------------------------------------------- quality


def _random_doc(rng):
    c = {k: int(rng.integers(0, 50)) for k in (
        "reads_in", "reads_corrected", "reads_skipped", "substitutions",
        "truncations_3p", "truncations_5p", "skipped_no_anchor",
        "skipped_contaminant", "skipped_homopolymer", "skipped_other")}
    h = {name: {"count": 3, "sum": 5, "counts": {
        str(int(v)): int(n) for v, n in zip(rng.integers(0, 64, 4),
                                             rng.integers(1, 9, 4))}}
        for name in ("sub_pos_bucket", "substitutions_per_read",
                     "trunc_cycle_3p", "trunc_cycle_5p")}
    return {"counters": c, "histograms": h,
            "meta": {"coverage_mean": float(rng.uniform(0, 40))}}


@pytest.mark.parametrize("seed", range(3))
def test_quality_sections_equal(seed):
    rng = np.random.default_rng(seed)
    doc = _random_doc(rng)
    assert json.dumps(tquality.section_from_doc(doc), sort_keys=True) == \
        json.dumps(jquality.section_from_doc(doc), sort_keys=True)
    bins = [[int(i), int(a), int(b)] for i, a, b in
            zip(range(1, 40), rng.integers(0, 99, 39),
                rng.integers(0, 99, 39))]
    assert tquality.coverage_from_histo(bins) == \
        jquality.coverage_from_histo(bins)
    results = [(">r 1:sub:A-C 3:3_trunc\nACGT\n", ""),
               ("", "Skipped r: No high quality mer\n")] * (seed + 1)
    assert tquality.summarize_results(results) == \
        jquality.summarize_results(results)


def test_scorecard_windows_match_jax():
    gauges = []
    for rmod, qmod in ((jreg, jquality), (treg, tquality)):
        reg = rmod.MetricsRegistry()
        reg.set_meta(coverage_mean=12.5)
        card = qmod.QualityScorecard(reg, alpha=0.5, window_reads=10)
        for step in range(4):
            reg.counter("reads_in").inc(6)
            reg.counter("reads_corrected").inc(5)
            reg.counter("reads_skipped").inc(1)
            reg.counter("substitutions").inc(step * 3)
            reg.counter("skipped_no_anchor").inc(step % 2)
            reg.heartbeat()
        card.tick(final=True)
        doc = reg.as_dict()
        gauges.append((card.windows, doc["gauges"], doc["quality"]))
    assert gauges[0] == gauges[1]


# ------------------------------------------------------------ integrity


@pytest.fixture(scope="module")
def v5_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("v5")
    db = str(d / "db.jf")
    assert tcdb_cli.main(["-s", "64k", "-m", "13", "-b", "7", "-q", "38",
                          "-o", db, "--device", "cpu", READS]) == 0
    return db


def _load_counted(loader, imod, rmod, path):
    reg = rmod.MetricsRegistry()
    prev = imod.install_registry(reg)
    try:
        loader(path)
        err = None
    except imod.IntegrityError as e:
        err = e
    finally:
        imod.install_registry(prev)
    doc = reg.as_dict()
    return doc["counters"], {k: doc["meta"].get(k) for k in
                             ("db_version", "verify_db")}, err


def test_integrity_counters_match_jax(v5_db, tmp_path):
    def jload(p):
        jdb.read_db(p, to_device=False)

    def tload(p):
        tdb.load_db(p, "cpu")
    bad = str(tmp_path / "bad.jf")
    with open(v5_db, "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0xFF
    with open(bad, "wb") as f:
        f.write(data)
    for path in (v5_db, bad):
        j = _load_counted(jload, jint, jreg, path)
        t = _load_counted(tload, tint, treg, path)
        assert t[:2] == j[:2]
        assert (t[2] is None) == (j[2] is None)
    assert t[0]["integrity_errors_total"] == 1
