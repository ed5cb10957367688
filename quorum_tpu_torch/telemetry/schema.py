"""A copy of quorum_tpu/telemetry/schema.py: the port's documents are
held to the same schema, and chip_smoke.py validates with this copy.

The metrics document schema (version `quorum-tpu-metrics/1`) and
its validator — shared by `tools/metrics_check.py`, the tests, and
bench.py's line emitter, so every machine-readable artifact the
pipeline produces stays mutually comparable.

Final metrics JSON (MetricsRegistry.as_dict):

    {
      "schema":     "quorum-tpu-metrics/1",
      "meta":       {str: scalar | [scalar] | {str: scalar}},
      "counters":   {str: int >= 0},
      "gauges":     {str: number},
      "histograms": {str: {"count": int, "sum": number,
                           "counts": {str: int}}},
      "timers":     {str: {"total_seconds": number,
                           "stages": {str: {"seconds": number,
                                            "calls": int,
                                            "units": int}}}}
    }

Events JSONL (one JSON object per line): `event` (str) and `t`
(seconds since registry creation, number) are required; all other
values must be scalars. `heartbeat` events carry progress fields
(reads/bases so far, a monotonic `elapsed_s`, derived `gb_per_h`).

A multi-host aggregated document (parallel/multihost.
aggregate_metrics) additionally carries a `hosts` section: one
complete per-host metrics document per process index, with the
top-level counters equal to the per-host sums.

Span JSONL (telemetry/spans.py, one object per line): `span` (str),
`id` (int), `ts`/`dur` (seconds, numbers) required; `parent` is an
int or null, `tid` an int; all other values scalars. The Chrome-trace
twin (`{"traceEvents": [...]}`, "X" complete events) is validated by
`validate_chrome_trace`.

No dependency on jsonschema: the checks are hand-rolled and return a
list of human-readable problem strings (empty = valid).
"""

from __future__ import annotations

import json

SCHEMA_VERSION = "quorum-tpu-metrics/1"

_SCALAR = (str, int, float, bool, type(None))


def _is_scalar(v) -> bool:
    return isinstance(v, _SCALAR)


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _validate_fleet_shape(doc: dict) -> list[str]:
    """Structural fleet consistency: a document whose meta
    declares `host_process_count > 1` was aggregated from a multi-host
    fleet run — its `hosts` section must carry exactly one shard per
    process, and every shard's own meta.host_process_index must be a
    distinct in-range process id (two shards claiming one index means
    a host's document was overwritten; a missing index means one was
    never collected). Name-level requirements (resource gauges,
    compile ledgers) live in tools/metrics_check.py."""
    errs: list[str] = []
    meta = doc.get("meta", {})
    pc = meta.get("host_process_count")
    if pc is None:
        return errs
    if not isinstance(pc, int) or isinstance(pc, bool) or pc < 1:
        return [f"meta.host_process_count must be a positive "
                f"integer, got {pc!r}"]
    if pc <= 1:
        return errs
    hosts = doc.get("hosts", {})
    if len(hosts) != pc:
        errs.append(f"meta.host_process_count={pc} but {len(hosts)} "
                    "host shard(s) present")
    indices = []
    for hk in sorted(hosts):
        hmeta = hosts[hk].get("meta", {}) if isinstance(
            hosts[hk], dict) else {}
        idx = hmeta.get("host_process_index")
        if not isinstance(idx, int) or isinstance(idx, bool) \
                or not 0 <= idx < pc:
            errs.append(f"hosts[{hk!r}]: meta.host_process_index "
                        f"{idx!r} is not a process id in [0, {pc})")
        else:
            indices.append(idx)
    if len(set(indices)) != len(indices):
        errs.append("duplicate meta.host_process_index across host "
                    "shards (one host's document overwrote another's)")
    return errs


def validate_metrics(doc, _nested: bool = False) -> list[str]:
    """Validate a final metrics document (optionally carrying a
    multi-host `hosts` section of per-host shard documents). Returns
    problems (empty = valid)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    if doc.get("schema") != SCHEMA_VERSION:
        errs.append(f"schema is {doc.get('schema')!r}, "
                    f"expected {SCHEMA_VERSION!r}")
    for key in ("meta", "counters", "gauges", "histograms", "timers"):
        if not isinstance(doc.get(key), dict):
            errs.append(f"missing or non-object section {key!r}")
    allowed = {"schema", "meta", "counters", "gauges",
               "histograms", "timers"}
    # the correction-quality section: derived by
    # MetricsRegistry.as_dict from the document's own counters when a
    # QualityScorecard is installed — per-host shard documents carry
    # their own, so it is allowed nested too
    allowed.add("quality")
    if not _nested:
        allowed.add("hosts")
        # fleet documents (tools/push_receiver.py) may carry receiver-
        # side lifecycle events — staleness alerts a silent host
        # cannot write into its own (absent) document
        allowed.add("events")
    unknown = set(doc) - allowed
    if unknown:
        errs.append(f"unknown top-level keys {sorted(unknown)}")
    if errs:
        return errs
    if not _nested and "hosts" in doc:
        if not isinstance(doc["hosts"], dict):
            errs.append("hosts is not an object")
        else:
            for hk, hdoc in doc["hosts"].items():
                errs.extend(f"hosts[{hk!r}]: {e}" for e in
                            validate_metrics(hdoc, _nested=True))
            errs.extend(_validate_fleet_shape(doc))
    if not _nested and "events" in doc:
        if not isinstance(doc["events"], list):
            errs.append("events is not a list")
        else:
            for i, ev in enumerate(doc["events"]):
                errs.extend(f"events[{i}]: {e}" for e in
                            validate_events_line(ev))
    if "quality" in doc:
        errs.extend(f"quality: {e}" for e in
                    validate_quality(doc["quality"]))

    for k, v in doc["meta"].items():
        ok = (_is_scalar(v)
              or (isinstance(v, list) and all(_is_scalar(x) for x in v))
              or (isinstance(v, dict)
                  and all(_is_scalar(x) for x in v.values())))
        if not ok:
            errs.append(f"meta[{k!r}] is not scalar/list/flat-object")
    for k, v in doc["counters"].items():
        if not (isinstance(v, int) and not isinstance(v, bool) and v >= 0):
            errs.append(f"counters[{k!r}] = {v!r} is not a non-negative int")
    for k, v in doc["gauges"].items():
        if not _is_number(v):
            errs.append(f"gauges[{k!r}] = {v!r} is not a number")
    for k, h in doc["histograms"].items():
        if not isinstance(h, dict):
            errs.append(f"histograms[{k!r}] is not an object")
            continue
        if not (isinstance(h.get("count"), int)
                and _is_number(h.get("sum"))
                and isinstance(h.get("counts"), dict)):
            errs.append(f"histograms[{k!r}] needs count/sum/counts")
            continue
        total = 0
        for bk, bn in h["counts"].items():
            if not isinstance(bk, str) or not isinstance(bn, int):
                errs.append(f"histograms[{k!r}].counts[{bk!r}] malformed")
            else:
                total += bn
        if total != h["count"]:
            errs.append(f"histograms[{k!r}]: counts sum {total} != "
                        f"count {h['count']}")
    for k, t in doc["timers"].items():
        if not isinstance(t, dict) or not _is_number(
                t.get("total_seconds")):
            errs.append(f"timers[{k!r}] needs numeric total_seconds")
            continue
        stages = t.get("stages", {})
        if not isinstance(stages, dict):
            errs.append(f"timers[{k!r}].stages is not an object")
            continue
        for sk, sv in stages.items():
            if not (isinstance(sv, dict) and _is_number(sv.get("seconds"))
                    and isinstance(sv.get("calls"), int)):
                errs.append(f"timers[{k!r}].stages[{sk!r}] malformed")
    return errs


# the correction-quality section (telemetry/quality.py):
# what MetricsRegistry.as_dict derives from the document's own
# counters/histograms when a QualityScorecard is installed
QUALITY_SCHEMA = "quorum-tpu-quality/1"

# the quality-section count maps (histogram `counts` re-keyed
# deterministically by quality._sorted_counts)
_QUALITY_COUNT_MAPS = ("sub_pos_spectrum", "substitutions_per_read",
                       "trunc_cycle_3p", "trunc_cycle_5p",
                       "skip_reasons")
_QUALITY_COUNTS = ("reads", "corrected", "skipped", "substitutions",
                   "truncations_3p", "truncations_5p")
_QUALITY_RATES = ("anchor_rate", "contam_rate",
                  "corrections_per_read", "skip_rate",
                  "trunc_rate_3p", "trunc_rate_5p")


def validate_quality(q) -> list[str]:
    """Validate a `quality` section (quality.section_from_doc):
    schema stamp, non-negative counts, the full rate set as numbers
    in sane ranges, count maps of non-negative ints, and — when the
    producing run knew its DB coverage — a coherent `coverage`
    sub-object."""
    errs: list[str] = []
    if not isinstance(q, dict):
        return ["quality section is not a JSON object"]
    if q.get("schema") != QUALITY_SCHEMA:
        errs.append(f"schema is {q.get('schema')!r}, "
                    f"expected {QUALITY_SCHEMA!r}")
    for k in _QUALITY_COUNTS:
        v = q.get(k)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errs.append(f"{k!r} must be a non-negative int, got {v!r}")
    rates = q.get("rates")
    if not isinstance(rates, dict):
        errs.append("missing/non-object 'rates'")
    else:
        for k in _QUALITY_RATES:
            v = rates.get(k)
            if not _is_number(v) or v < 0:
                errs.append(f"rates[{k!r}] must be a non-negative "
                            f"number, got {v!r}")
    if not (isinstance(q.get("spectrum_cycles_per_bucket"), int)
            and q.get("spectrum_cycles_per_bucket", 0) > 0):
        errs.append("'spectrum_cycles_per_bucket' must be a positive "
                    "int")
    for mk in _QUALITY_COUNT_MAPS:
        m = q.get(mk)
        if not isinstance(m, dict):
            errs.append(f"missing/non-object {mk!r}")
            continue
        for bk, bn in m.items():
            if not isinstance(bk, str) or not isinstance(bn, int) \
                    or isinstance(bn, bool) or bn < 0:
                errs.append(f"{mk}[{bk!r}] malformed")
    cov = q.get("coverage")
    if cov is not None:
        if not isinstance(cov, dict):
            errs.append("'coverage' is not an object")
        else:
            for k in ("predicted_mean", "predicted_anchor_rate"):
                if not _is_number(cov.get(k)) or cov.get(k, -1) < 0:
                    errs.append(f"coverage[{k!r}] must be a "
                                "non-negative number")
    return errs


# the serve request lifecycle event: one per terminal
# status, with disjoint phase durations in microseconds
REQUEST_EVENT_PHASES = ("admission_us", "queue_us", "device_us",
                        "hedge_us", "render_us", "total_us")

# per-request quality tallies: optional on a request event
# (the 200 path stamps them; error paths have no render output), but
# when present they must be non-negative ints — the ledger's quality
# phases reconcile against the final document's outcome counters
REQUEST_EVENT_QUALITY = ("q_corrected", "q_skipped", "q_subs",
                         "q_t3", "q_t5")

# the alert lifecycle event (telemetry/alerts.py): one per
# firing->healed transition of a rule
ALERT_EVENT_STATES = ("firing", "healed")


def _validate_alert_event(obj) -> list[str]:
    """The `alert` event's contract on top of the generic event
    shape: a named rule and a firing/healed state (value/detail/
    severity ride along as ordinary scalars)."""
    errs: list[str] = []
    if not isinstance(obj.get("rule"), str) or not obj.get("rule"):
        errs.append("alert event missing/empty 'rule'")
    if obj.get("state") not in ALERT_EVENT_STATES:
        errs.append(f"alert event 'state' must be one of "
                    f"{ALERT_EVENT_STATES}, got {obj.get('state')!r}")
    return errs


def _validate_request_event(obj) -> list[str]:
    """The `request` lifecycle event's extra contract on top of the
    generic event shape: a non-empty trace id, an HTTP status, a
    lane, and every phase duration present and non-negative."""
    errs: list[str] = []
    if not isinstance(obj.get("request_id"), str) \
            or not obj.get("request_id"):
        errs.append("request event missing/empty 'request_id'")
    if not isinstance(obj.get("status"), int) \
            or isinstance(obj.get("status"), bool):
        errs.append("request event missing/non-int 'status'")
    if not isinstance(obj.get("lane"), str) or not obj.get("lane"):
        errs.append("request event missing/empty 'lane'")
    for k in REQUEST_EVENT_PHASES:
        v = obj.get(k)
        if not _is_number(v):
            errs.append(f"request event missing/non-numeric {k!r}")
        elif v < 0:
            errs.append(f"request event {k!r} is negative")
    for k in REQUEST_EVENT_QUALITY:
        if k in obj:
            v = obj[k]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"request event {k!r} must be a "
                            "non-negative int when present")
    return errs


def validate_events_line(obj) -> list[str]:
    """Validate one parsed events-JSONL object. `request` lifecycle
    events (serve request tracing) are additionally held to
    their richer contract."""
    errs: list[str] = []
    if not isinstance(obj, dict):
        return ["event line is not a JSON object"]
    if not isinstance(obj.get("event"), str) or not obj.get("event"):
        errs.append("missing/empty 'event' field")
    if not _is_number(obj.get("t")):
        errs.append("missing/non-numeric 't' field")
    for k, v in obj.items():
        if not _is_scalar(v):
            errs.append(f"event field {k!r} is not scalar")
    if obj.get("event") == "request":
        errs.extend(_validate_request_event(obj))
    if obj.get("event") == "alert":
        errs.extend(_validate_alert_event(obj))
    return errs


def validate_span_line(obj) -> list[str]:
    """Validate one parsed span-JSONL object (telemetry/spans.py)."""
    errs: list[str] = []
    if not isinstance(obj, dict):
        return ["span line is not a JSON object"]
    if not isinstance(obj.get("span"), str) or not obj.get("span"):
        errs.append("missing/empty 'span' field")
    if not isinstance(obj.get("id"), int) or isinstance(obj.get("id"), bool):
        errs.append("missing/non-int 'id' field")
    if not (obj.get("parent") is None or isinstance(obj.get("parent"), int)):
        errs.append("'parent' must be an int or null")
    if not isinstance(obj.get("tid"), int):
        errs.append("missing/non-int 'tid' field")
    for k in ("ts", "dur"):
        if not _is_number(obj.get(k)):
            errs.append(f"missing/non-numeric {k!r} field")
        elif obj[k] < 0:
            errs.append(f"{k!r} is negative")
    for k, v in obj.items():
        if not _is_scalar(v):
            errs.append(f"span field {k!r} is not scalar")
    return errs


def validate_chrome_trace(doc) -> list[str]:
    """Validate a Chrome trace_event document (the loadable-in-
    Perfetto twin of the span JSONL): {"traceEvents": [...]} of "X"
    complete events with numeric µs ts/dur and pid/tid."""
    errs: list[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["not a Chrome trace object (no traceEvents list)"]
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"traceEvents[{i}] is not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errs.append(f"traceEvents[{i}]: missing name")
        if ev.get("ph") not in ("X", "B", "E", "i", "M"):
            errs.append(f"traceEvents[{i}]: unsupported ph "
                        f"{ev.get('ph')!r}")
        if not _is_number(ev.get("ts")):
            errs.append(f"traceEvents[{i}]: missing/non-numeric ts")
        if ev.get("ph") == "X" and not _is_number(ev.get("dur")):
            errs.append(f"traceEvents[{i}]: X event without dur")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errs.append(f"traceEvents[{i}]: missing/non-int {k}")
    return errs


# the perf-regression verdict document (tools/perf_diff.py)
PERF_DIFF_SCHEMA = "quorum-tpu-perf-diff/1"
# the accuracy-regression verdict document (tools/quality_diff.py)
# — same diff-verdict shape, its own schema stamp
QUALITY_DIFF_SCHEMA = "quorum-tpu-quality-diff/1"


def validate_perf_diff(doc, schema: str = PERF_DIFF_SCHEMA) -> list[str]:
    """Validate a diff verdict document (perf_diff and, via the
    `schema` arg, quality_diff — both tools share the shape):
    verdict/checked/regressions coherent, per-metric entries carrying
    ok flags. The verdict must AGREE with the regression list — a
    'pass' document listing regressions (or vice versa) means the
    gate's output was hand-altered or the tool broke."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["diff-verdict document is not a JSON object"]
    if doc.get("schema") != schema:
        errs.append(f"schema is {doc.get('schema')!r}, expected "
                    f"{schema!r}")
    if doc.get("verdict") not in ("pass", "regression"):
        errs.append(f"verdict must be pass|regression, got "
                    f"{doc.get('verdict')!r}")
    regs = doc.get("regressions")
    if not isinstance(regs, list) or not all(
            isinstance(r, str) for r in regs):
        errs.append("regressions must be a list of strings")
        regs = []
    if not isinstance(doc.get("checked"), int) \
            or isinstance(doc.get("checked"), bool) \
            or doc.get("checked", -1) < 0:
        errs.append("checked must be a non-negative int")
    if doc.get("verdict") == "pass" and regs:
        errs.append("verdict 'pass' but regressions listed")
    if doc.get("verdict") == "regression" and not regs:
        errs.append("verdict 'regression' with no regressions listed")
    docs = doc.get("docs")
    if not isinstance(docs, dict):
        errs.append("missing/non-object 'docs' section")
        return errs
    n_bad = 0
    for dk, dv in docs.items():
        if not isinstance(dv, dict):
            errs.append(f"docs[{dk!r}] is not an object")
            continue
        for mk, mv in dv.get("metrics", {}).items():
            if not isinstance(mv, dict) or not isinstance(
                    mv.get("ok"), bool):
                errs.append(f"docs[{dk!r}].metrics[{mk!r}] needs a "
                            "boolean 'ok'")
            elif not mv["ok"]:
                n_bad += 1
    if doc.get("verdict") == "pass" and n_bad:
        errs.append(f"verdict 'pass' but {n_bad} metric entr"
                    f"{'y' if n_bad == 1 else 'ies'} report ok=false")
    return errs


# the mer-count histogram sidecar (cli/histo_mer_database
# --json): the machine-readable twin of the textual spectrum, so
# the scorecard's coverage-model fit and operators consume it without
# parsing stdout
HISTO_SCHEMA = "quorum-tpu-histo/1"


def validate_histo(doc) -> list[str]:
    """Validate a mer-histogram sidecar document: schema stamp, a
    `bins` list of `[count, n_lowqual, n_highqual]` int rows in
    strictly increasing count order, and summary stats consistent
    with the rows."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["histo document is not a JSON object"]
    if doc.get("schema") != HISTO_SCHEMA:
        errs.append(f"schema is {doc.get('schema')!r}, "
                    f"expected {HISTO_SCHEMA!r}")
    bins = doc.get("bins")
    if not isinstance(bins, list):
        errs.append("missing/non-list 'bins' section")
        return errs
    prev = -1
    for i, row in enumerate(bins):
        if not (isinstance(row, list) and len(row) == 3 and all(
                isinstance(v, int) and not isinstance(v, bool)
                and v >= 0 for v in row)):
            errs.append(f"bins[{i}] must be [count, n_lowqual, "
                        f"n_highqual] non-negative ints, got {row!r}")
            continue
        if row[0] <= prev:
            errs.append(f"bins[{i}]: count {row[0]} not strictly "
                        "increasing")
        prev = row[0]
    stats = doc.get("stats")
    if not isinstance(stats, dict):
        errs.append("missing/non-object 'stats' section")
    else:
        for k in ("distinct_total", "distinct_nonempty", "max_count"):
            v = stats.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"stats[{k!r}] must be a non-negative int")
        if not _is_number(stats.get("coverage_mode")) \
                or stats.get("coverage_mode", -1) < 0:
            errs.append("stats['coverage_mode'] must be a "
                        "non-negative number")
    return errs


# the flight-recorder dump document (telemetry/flight.py)
# and the quorum-debug-bundle manifest that packages one
FLIGHT_SCHEMA = "quorum-tpu-flight/1"
DEBUG_BUNDLE_SCHEMA = "quorum-tpu-debug-bundle/1"

# what a bundle entry can be; "other" keeps the manifest open to
# operator-supplied extras without a schema bump
BUNDLE_FILE_KINDS = ("flight", "metrics", "events", "spans", "trace",
                     "fsck", "config", "other")


def _flight_seal_errors(doc) -> list[str]:
    """A flight dump MUST be sealed (unlike pre-v5 metrics artifacts,
    where the seal is optional): the dump is the black box an operator
    reads AFTER the process died, so an unsealed or altered one is
    exactly the artifact that cannot be trusted."""
    from ..io.integrity import SEAL_FIELD, crc32c
    want = doc.get(SEAL_FIELD)
    if not isinstance(want, int) or isinstance(want, bool):
        return [f"missing/non-int seal field {SEAL_FIELD!r} "
                "(flight dumps are always sealed)"]
    body = json.dumps({k: v for k, v in doc.items()
                       if k != SEAL_FIELD}, sort_keys=True).encode()
    got = crc32c(body)
    if got != want:
        return [f"seal mismatch: computed crc32c {got:#010x} != "
                f"recorded {want:#010x} — the dump was altered after "
                "it was written"]
    return []


def validate_flight_dump(doc) -> list[str]:
    """Validate a flight-recorder crash dump (FlightRecorder.dump):
    trigger identity (kind/thread/tid), ring entries as scalar-valued
    timeline records, all-thread stacks, the embedded registry
    snapshot as a well-formed metrics document, and the mandatory
    integrity seal (recomputed, not just present)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["flight dump is not a JSON object"]
    if doc.get("schema") != FLIGHT_SCHEMA:
        errs.append(f"schema is {doc.get('schema')!r}, "
                    f"expected {FLIGHT_SCHEMA!r}")
    meta = doc.get("meta")
    if not isinstance(meta, dict):
        errs.append("missing/non-object 'meta' section")
    else:
        if not isinstance(meta.get("pid"), int):
            errs.append("meta.pid missing/non-int")
        if not (isinstance(meta.get("argv"), list) and all(
                isinstance(a, str) for a in meta["argv"])):
            errs.append("meta.argv must be a list of strings")
        if not isinstance(meta.get("capacity"), int) \
                or meta.get("capacity", 0) < 1:
            errs.append("meta.capacity missing/non-positive")
    trig = doc.get("trigger")
    if not isinstance(trig, dict):
        errs.append("missing/non-object 'trigger' section")
    else:
        if not isinstance(trig.get("kind"), str) or not trig.get("kind"):
            errs.append("trigger.kind missing/empty")
        if not isinstance(trig.get("thread"), str) \
                or not trig.get("thread"):
            errs.append("trigger.thread missing/empty (the dump must "
                        "name the triggering thread)")
        if not isinstance(trig.get("tid"), int):
            errs.append("trigger.tid missing/non-int")
        if not _is_number(trig.get("t")):
            errs.append("trigger.t missing/non-numeric")
        for k in ("site", "detail", "exception"):
            if k in trig and not isinstance(trig[k], str):
                errs.append(f"trigger.{k} is not a string")
    ring = doc.get("ring")
    if not isinstance(ring, list):
        errs.append("missing/non-list 'ring' section")
    else:
        for i, e in enumerate(ring):
            if not isinstance(e, dict):
                errs.append(f"ring[{i}] is not an object")
                continue
            if not _is_number(e.get("t")):
                errs.append(f"ring[{i}].t missing/non-numeric")
            for k in ("kind", "name"):
                if not isinstance(e.get(k), str) or not e.get(k):
                    errs.append(f"ring[{i}].{k} missing/empty")
            if not isinstance(e.get("tid"), int):
                errs.append(f"ring[{i}].tid missing/non-int")
            for k, v in e.items():
                if not _is_scalar(v):
                    errs.append(f"ring[{i}].{k} is not scalar")
    if not (isinstance(doc.get("dropped"), int)
            and not isinstance(doc.get("dropped"), bool)
            and doc.get("dropped", -1) >= 0):
        errs.append("'dropped' must be a non-negative int")
    threads = doc.get("threads")
    if not isinstance(threads, list):
        errs.append("missing/non-list 'threads' section")
    else:
        for i, t in enumerate(threads):
            if not isinstance(t, dict):
                errs.append(f"threads[{i}] is not an object")
                continue
            if not isinstance(t.get("name"), str):
                errs.append(f"threads[{i}].name missing")
            if not isinstance(t.get("tid"), int):
                errs.append(f"threads[{i}].tid missing/non-int")
            if not (isinstance(t.get("stack"), list) and all(
                    isinstance(s, str) for s in t["stack"])):
                errs.append(f"threads[{i}].stack must be a list of "
                            "strings")
    if not isinstance(doc.get("levers"), dict):
        errs.append("missing/non-object 'levers' section")
    if not isinstance(doc.get("autotune"), dict):
        errs.append("missing/non-object 'autotune' section")
    reg = doc.get("registry")
    if not isinstance(reg, dict):
        errs.append("missing/non-object 'registry' section")
    else:
        errs.extend(f"registry: {e}" for e in validate_metrics(reg))
    errs.extend(_flight_seal_errors(doc))
    return errs


def validate_debug_bundle_manifest(doc) -> list[str]:
    """Validate a quorum-debug-bundle manifest: what the tarball
    holds, each entry typed, sized, and digest-stamped, so a bundle
    shipped across machines self-describes what made it into the
    postmortem (and what was missing at collection time)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["bundle manifest is not a JSON object"]
    if doc.get("schema") != DEBUG_BUNDLE_SCHEMA:
        errs.append(f"schema is {doc.get('schema')!r}, "
                    f"expected {DEBUG_BUNDLE_SCHEMA!r}")
    meta = doc.get("meta")
    if not isinstance(meta, dict):
        errs.append("missing/non-object 'meta' section")
    else:
        for k, v in meta.items():
            ok = (_is_scalar(v)
                  or (isinstance(v, list)
                      and all(_is_scalar(x) for x in v)))
            if not ok:
                errs.append(f"meta[{k!r}] is not scalar/list")
    files = doc.get("files")
    if not isinstance(files, list):
        errs.append("missing/non-list 'files' section")
        return errs
    if not files:
        errs.append("'files' is empty — a bundle must hold at least "
                    "the artifact that motivated it")
    for i, f in enumerate(files):
        if not isinstance(f, dict):
            errs.append(f"files[{i}] is not an object")
            continue
        if not isinstance(f.get("name"), str) or not f.get("name"):
            errs.append(f"files[{i}].name missing/empty")
        if f.get("kind") not in BUNDLE_FILE_KINDS:
            errs.append(f"files[{i}].kind must be one of "
                        f"{BUNDLE_FILE_KINDS}, got {f.get('kind')!r}")
        if not (isinstance(f.get("bytes"), int)
                and not isinstance(f.get("bytes"), bool)
                and f.get("bytes", -1) >= 0):
            errs.append(f"files[{i}].bytes must be a non-negative int")
        if not isinstance(f.get("crc32c"), int) \
                or isinstance(f.get("crc32c"), bool):
            errs.append(f"files[{i}].crc32c missing/non-int")
        if "problems" in f and not (
                isinstance(f["problems"], int)
                and not isinstance(f["problems"], bool)
                and f["problems"] >= 0):
            errs.append(f"files[{i}].problems must be a non-negative "
                        "int")
    return errs


def validate_bench_line(obj) -> list[str]:
    """Validate one parsed bench-style metric line (the `metric_line`
    output format: `metric` (str) plus scalar fields)."""
    errs: list[str] = []
    if not isinstance(obj, dict):
        return ["bench line is not a JSON object"]
    if not isinstance(obj.get("metric"), str) or not obj.get("metric"):
        errs.append("missing/empty 'metric' field")
    for k, v in obj.items():
        if not _is_scalar(v):
            errs.append(f"bench field {k!r} is not scalar")
    return errs


def check_file(path: str) -> list[str]:
    """Validate any metrics artifact by path, dispatching on content:
    a whole-document metrics JSON (MetricsRegistry.write), a Chrome
    trace (SpanTracer.write_chrome_trace), an events or span .jsonl
    stream, or a bench-style metric-line file (one `{"metric": ...}`
    object per line, as bench.py emits)."""
    errs: list[str] = []
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return [str(e)]
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and doc.get("schema") == PERF_DIFF_SCHEMA:
        return validate_perf_diff(doc)
    if isinstance(doc, dict) and doc.get("schema") == QUALITY_DIFF_SCHEMA:
        return validate_perf_diff(doc, schema=QUALITY_DIFF_SCHEMA)
    if isinstance(doc, dict) and doc.get("schema") == HISTO_SCHEMA:
        return validate_histo(doc)
    if isinstance(doc, dict) and doc.get("schema") == FLIGHT_SCHEMA:
        return validate_flight_dump(doc)
    if isinstance(doc, dict) and doc.get("schema") == DEBUG_BUNDLE_SCHEMA:
        return validate_debug_bundle_manifest(doc)
    if (isinstance(doc, dict)
            and ("schema" in doc or "counters" in doc)
            and "metric" not in doc and "event" not in doc):
        return validate_metrics(doc)
    if isinstance(doc, dict) and "traceEvents" in doc:
        return validate_chrome_trace(doc)
    # line-oriented: events JSONL, span JSONL, and/or bench metric
    # lines (a bench run interleaves kinds through one stdout)
    any_line = False
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        any_line = True
        try:
            obj = json.loads(line)
        except ValueError as e:
            errs.append(f"line {i}: invalid JSON ({e})")
            continue
        if isinstance(obj, dict) and "metric" in obj:
            check = validate_bench_line
        elif isinstance(obj, dict) and "span" in obj:
            check = validate_span_line
        else:
            check = validate_events_line
        errs.extend(f"line {i}: {e}" for e in check(obj))
    if not any_line:
        errs.append("no metrics content found")
    return errs


def metric_line(metric: str, **fields) -> str:
    """One bench-style JSON line (`{"metric": ..., ...}`) with the
    field types checked — bench.py emits through this so BENCH_*.json
    stays schema-consistent across rounds. Values must be scalars."""
    if not metric or not isinstance(metric, str):
        raise ValueError("metric name must be a non-empty string")
    obj = {"metric": metric}
    for k, v in fields.items():
        if not _is_scalar(v):
            raise ValueError(
                f"metric_line field {k!r} is not a scalar: {type(v)}")
        obj[k] = v
    return json.dumps(obj)
