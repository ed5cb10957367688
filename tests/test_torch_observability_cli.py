"""The telemetry flags end to end on the golden reads, on the CPU: the
port's quorum driver and JAX's, each run once with --metrics
--metrics-interval --trace-spans --profile. Every driver, stage-1 and
stage-2 document, event stream and span file of the port passes the
unchanged tools/metrics_check.py; the stage-2 document passes
tools/quality_diff.py against QUALITY_BASELINE.json; the counter, gauge
and histogram names equal JAX's but for the listed JAX-only ones, the
deterministic values and the quality section are equal, and so are the
span names; the .fa/.log bytes do not change with the flags; a failing
run lands status=error; the flags whose machinery is not ported are
refused with their ROADMAP item; tools/trace_summary.py --device renders
the profile; the inspection CLIs' documents match JAX's names."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import contextlib
import filecmp
import importlib.util
import io
import json
import os

import pytest
import torch

from quorum_tpu.cli import histo_mer_database as jhisto
from quorum_tpu.cli import query_mer_database as jquery
from quorum_tpu.cli import quorum as jquorum
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import histo_mer_database as thisto
from quorum_tpu_torch.cli import query_mer_database as tquery
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.telemetry import contract

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
PORT = ["--device", "cpu", "--batch-size", "256"]
DOCS = ("m.json", "m.stage1.json", "m.stage2.json")
SPANS = ("s.driver.jsonl", "s.stage1.jsonl", "s.stage2.jsonl")

# names only JAX's documents carry, each with the ROADMAP Queue 1 item
# that brings its machinery to the port (None: XLA's compile cache, no
# counterpart in the port); the resource guards' names (item 5) land in
# both
JAX_ONLY = (
    ("alert_rule_errors_total", 10), ("alerts_fired_total", 10),
    ("alert_rules_active", 10), ("alerts_firing{", 10),
    ("flight_dumps_total", 10), ("flight_events_dropped_total", 10),
    ("jax_cache_hits", None), ("jax_cache_requests", None),
    ("jax_cache_misses", None),
)
# values that depend on neither time nor machine
DETERMINISTIC = {
    "counters": ("reads", "bases", "batches", "distinct_mers", "hash_grows",
                 "reads_in", "reads_corrected", "reads_skipped", "bases_in",
                 "bases_out", "substitutions", "truncations_3p",
                 "truncations_5p", "skipped_contaminant",
                 "skipped_no_anchor", "skipped_homopolymer",
                 "skipped_other", "stage_retries_total"),
    "gauges": ("hash_buckets", "hash_slots", "hash_fill", "cutoff"),
    "histograms": ("substitutions_per_read", "sub_pos_bucket",
                   "trunc_cycle_3p", "trunc_cycle_5p"),
}


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(d):
    return ["--metrics", os.path.join(d, "m.json"), "--metrics-interval",
            "1", "--trace-spans", os.path.join(d, "s.jsonl"), "--profile",
            os.path.join(d, "prof")]


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jd = str(tmp_path_factory.mktemp("jax"))
        td = str(tmp_path_factory.mktemp("port"))
        plain = str(tmp_path_factory.mktemp("plain"))
        # JAX's profiler over its first run in a process (while the
        # executables load from the cache) is slow: a plain run first
        assert jquorum.main(["-s", "64k", "-k", "13", "-p",
                             os.path.join(plain, "jax")] + [READS]) == 0
        assert jquorum.main(["-s", "64k", "-k", "13", "-p",
                             os.path.join(jd, "out")] + _flags(jd)
                            + [READS]) == 0
        assert tquorum.main(["-s", "64k", "-k", "13", "-p",
                             os.path.join(td, "out")] + PORT + _flags(td)
                            + [READS]) == 0
        assert tquorum.main(["-s", "64k", "-k", "13", "-p",
                             os.path.join(plain, "out")] + PORT
                            + [READS]) == 0
    finally:
        torch.set_num_threads(n)
    return {"jax": jd, "port": td, "plain": plain}


def _port_artifacts():
    return (list(DOCS) + [d.replace(".json", ".events.jsonl")
                          for d in DOCS]
            + list(SPANS) + [s.replace(".jsonl", ".trace.json")
                             for s in SPANS]
            + [os.path.join("prof", "spans.trace.json"),
               os.path.join("prof", "stage1", "spans.trace.json"),
               os.path.join("prof", "stage2", "spans.trace.json")])


def test_port_artifacts_pass_metrics_check(runs):
    paths = [os.path.join(runs["port"], a) for a in _port_artifacts()]
    assert all(os.path.exists(p) for p in paths)
    assert _tool("metrics_check").main(paths) == 0


def test_stage2_quality_passes_the_baseline(runs):
    m2 = os.path.join(runs["port"], "m.stage2.json")
    assert _tool("quality_diff").main([
        "--baseline", os.path.join(ROOT, "QUALITY_BASELINE.json"),
        f"golden={m2}"]) == 0


def _jax_only(name):
    return any(name == p or (p.endswith("{") and name.startswith(p))
               for p, _item in JAX_ONLY)


# families whose labels name the run's own paths (the resource monitor's
# watched directories): each document carries the family or not, as
# JAX's does, whatever the labels
RUN_LABELED = ("disk_free_bytes{",)


def _names(names):
    names = list(names)
    return ({n for n in names if not n.startswith(RUN_LABELED)}
            | {p for p in RUN_LABELED for n in names if n.startswith(p)})


@pytest.mark.parametrize("doc", DOCS)
def test_names_equal_jax_but_the_listed(runs, doc):
    j = _load(os.path.join(runs["jax"], doc))
    t = _load(os.path.join(runs["port"], doc))
    for sec in ("counters", "gauges", "histograms"):
        want = _names(n for n in j[sec] if not _jax_only(n))
        assert _names(t[sec]) == want, sec
    assert set(t["timers"]) == set(j["timers"])
    for name in j["timers"]:
        assert set(t["timers"][name]["stages"]) == \
            set(j["timers"][name]["stages"])


@pytest.mark.parametrize("doc", DOCS)
def test_deterministic_values_equal_jax(runs, doc):
    j = _load(os.path.join(runs["jax"], doc))
    t = _load(os.path.join(runs["port"], doc))
    for sec, names in DETERMINISTIC.items():
        for name in names:
            assert t[sec].get(name) == j[sec].get(name), (sec, name)
    assert json.dumps(t["quality"], sort_keys=True) == \
        json.dumps(j["quality"], sort_keys=True)
    assert t["meta"]["status"] == "ok"


@pytest.mark.parametrize("spans", SPANS)
def test_span_names_equal_jax(runs, spans):
    def names(d):
        with open(os.path.join(d, spans)) as f:
            return {json.loads(ln)["span"] for ln in f}
    assert names(runs["port"]) == names(runs["jax"])


def test_output_bytes_unchanged_by_the_flags(runs):
    for ext in (".fa", ".log"):
        flagged = os.path.join(runs["port"], "out" + ext)
        assert filecmp.cmp(flagged, os.path.join(runs["plain"], "out" + ext),
                           shallow=False)
        assert filecmp.cmp(flagged, os.path.join(GOLDEN,
                                                 "expected_auto" + ext),
                           shallow=False)
    assert sorted(f for f in os.listdir(runs["plain"])
                  if f.startswith("out")) == [
        "out.fa", "out.log", "out_mer_database.jf"]


def test_driver_document_names_the_stages(runs):
    meta = _load(os.path.join(runs["port"], "m.json"))["meta"]
    assert meta["driver"] == "quorum"
    assert meta["metrics_stage1"].endswith("m.stage1.json")
    assert meta["metrics_stage2"].endswith("m.stage2.json")
    assert meta["torch_version"] == torch.__version__
    assert meta["devtrace_files"] == 2


def test_trace_summary_renders_the_profile(runs):
    d = runs["port"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _tool("trace_summary").main([
            os.path.join(d, "s.stage2.jsonl"),
            os.path.join(d, "m.stage2.json"), "--device",
            os.path.join(d, "prof")])
    assert rc == 0 and "device attribution" in out.getvalue()


@pytest.mark.parametrize("doc", DOCS)
def test_missing_names_agrees_with_metrics_check(runs, tmp_path, doc):
    """The port's name rules (chip_smoke.py's check) fail a document
    exactly where tools/metrics_check.py does."""
    check = _tool("metrics_check")
    d = _load(os.path.join(runs["port"], doc))
    assert contract.missing_names(d) == []
    for sec, name in (("counters", "device_kernel_us_total"),
                      ("gauges", "quality_skip_rate"),
                      ("counters", "stage_retries_total"),
                      ("histograms", "sub_pos_bucket")):
        if name not in d[sec]:
            continue
        bad = json.loads(json.dumps(d))
        del bad[sec][name]
        p = str(tmp_path / f"{name}.json")
        with open(p, "w") as f:
            json.dump(bad, f)
        assert contract.missing_names(bad)
        assert check.main([p]) == 1


@pytest.mark.parametrize("entry,argv", [
    (tcdb_cli.main, ["-s", "64k", "-m", "13", "-b", "7", "-q", "38", "-o",
                     "{d}/db.jf", "{d}/missing.fastq"]),
    (tec_cli.main, ["{d}/missing.jf", READS, "-o", "{d}/out"]),
    (tquorum.main, ["-s", "64k", "-k", "13", "-p", "{d}/out",
                    "-q", "33", "{d}/missing.fastq"]),
])
def test_failing_run_lands_status_error(tmp_path, entry, argv):
    d = str(tmp_path)
    m = os.path.join(d, "m.json")
    argv = [a.format(d=d) for a in argv]
    assert entry(argv + ["--device", "cpu", "--metrics", m]) == 1
    doc = _load(m)
    assert doc["meta"]["status"] == "error"
    assert _tool("metrics_check").main([m]) == 0


@pytest.mark.parametrize("argv,item", [
    (["--metrics-port", "0"], 10), (["--metrics-textfile", "x.prom"], 10),
    (["--metrics-push-url", "http://localhost:9"], 10),
    (["--metrics-push-interval", "5"], 10), (["--alert-rules", "r.json"], 10),
    (["--coordinator", "localhost:1"], 9), (["--num-processes", "2"], 9),
])
def test_unported_flags_refused_with_their_item(tmp_path, capsys, argv,
                                                item):
    assert tquorum.main(["-p", str(tmp_path / "out"), "--device", "cpu"]
                        + argv + [READS]) == 1
    err = capsys.readouterr().err
    assert argv[0] in err and f"ROADMAP Queue 1 item {item})" in err
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def inspected(runs, tmp_path_factory):
    """query/histo_mer_database on the golden database with --metrics,
    in both packages (the port's with --trace-spans and --profile)."""
    d = str(tmp_path_factory.mktemp("inspect"))
    db = os.path.join(runs["port"], "out_mer_database.jf")
    mers = ["ACGTACGTACGTA", "ACG"]
    out = {}
    for tag, main, extra in (
            ("jquery", jquery.main, mers), ("jhisto", jhisto.main, []),
            ("tquery", tquery.main, mers), ("thisto", thisto.main, [])):
        m = os.path.join(d, tag + ".json")
        argv = ["--metrics", m]
        if tag.startswith("t"):
            argv += ["--device", "cpu", "--trace-spans",
                     os.path.join(d, tag + ".jsonl"), "--profile",
                     os.path.join(d, tag)]
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            assert main(argv + [db] + extra) == 0
        out[tag] = m
    return out


@pytest.mark.parametrize("tool", ["query", "histo"])
def test_inspection_documents_match_jax(inspected, tool):
    j = _load(inspected["j" + tool])
    t = _load(inspected["t" + tool])
    assert _tool("metrics_check").main([inspected["t" + tool]]) == 0
    for sec in ("counters", "gauges", "histograms"):
        assert {n for n in t[sec] if not n.startswith("device")
                and n != "devtrace_steps"} == \
            {n for n in j[sec] if not _jax_only(n)}
        for name in j[sec]:
            if name in t[sec] and sec == "counters":
                assert t[sec][name] == j[sec][name], name
    assert t["meta"]["stage"] == j["meta"]["stage"]
