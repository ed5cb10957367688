"""Live metrics exposition (counterpart of quorum_tpu/telemetry/export.py,
the whole module): Prometheus text rendering, an atomic textfile writer,
and a stdlib HTTP endpoint serving `/metrics` + `/healthz` DURING a run.

Two transports, both driven from the same registries:

* **Textfile** (`--metrics-textfile PATH`): the Prometheus
  node-exporter textfile-collector pattern. Every registry heartbeat
  re-renders ALL live registries and atomically replaces PATH
  (tmp + os.replace), so a scraper never observes a torn file.
* **HTTP** (`--metrics-port PORT`): a daemon-thread `http.server`
  serving the same rendering at `/metrics` (Prometheus text exposition
  format 0.0.4) and a liveness JSON at `/healthz`. PORT 0 binds an
  ephemeral port (reported via vlog and `meta.metrics_port`).

Every enabled registry created through `registry_for` registers into
the module-level LIVE set (weak: finished runs drop out), labelled by
its `meta.stage`/`meta.driver`; the in-process `quorum` driver and
both stage registries therefore appear in ONE exposition with
`stage=...` labels. The correction server (serve/server.py) mounts
`render_live()` at its own `/metrics`.

`lint_prometheus_text` is the linter behind `tools/metrics_check.py
--prom`, standard library only.
"""

from __future__ import annotations

import json
import re
import threading
import time
import weakref

from ..utils import resources
from .registry import atomic_write

PREFIX = "quorum_tpu_"

# enabled registries in this process, weakly held: label -> doc comes
# from each registry's own meta at render time. The lock serializes
# adds (main thread, mid-run) against snapshots (HTTP handler
# threads) — WeakSet iteration concurrent with add raises
# RuntimeError, which would fail a scrape. A finished registry's
# FINAL rendering is retained strongly by label (_FINAL): without it,
# stage 1's series would vanish from the shared driver endpoint and
# textfile the moment the stage returns and its registry is freed —
# the exposition must keep carrying every stage the process ran.
_LIVE: weakref.WeakSet = weakref.WeakSet()
_FINAL: dict[str, tuple[dict, float]] = {}  # label -> (doc, elapsed)
_TEXTFILE_PATHS: set[str] = set()  # textfile targets seen this job
_LIVE_LOCK = threading.Lock()
_SERVER_REF: weakref.ref | None = None


def _retain_final(reg, final: bool = False) -> None:
    """write()-time exporter: snapshot the registry's last document
    so the exposition outlives the registry object."""
    if final:
        with _LIVE_LOCK:
            _FINAL[_reg_label(reg)] = (reg.as_dict(), reg.elapsed())


def register_live(reg) -> None:
    """Expose `reg` through the live endpoints (weak while running;
    its final document is retained by stage label after write())."""
    if not getattr(reg, "enabled", False):
        return
    with _LIVE_LOCK:
        if reg in _LIVE:
            return
        _LIVE.add(reg)
    reg.add_exporter(_retain_final)


def live_registries() -> list:
    with _LIVE_LOCK:
        return list(_LIVE)


def reset_exposition() -> None:
    """Forget the retained final documents of earlier runs in this
    process (still-live registries are unaffected). serve() calls
    this so a NEW endpoint never reports a previous job's counters;
    long-lived embedders sharing one process across jobs can call it
    between runs."""
    with _LIVE_LOCK:
        _FINAL.clear()
        _TEXTFILE_PATHS.clear()


def _metric_name(name: str) -> str:
    """Prometheus-legal metric name component."""
    name = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def split_labeled_name(name: str) -> tuple[str, str | None]:
    """Registry metric names may carry an embedded label set —
    `lane_wait_us{lane="interactive"}` (telemetry.labeled) — so flat
    name->value registries can express labelled series without a
    label-aware metric model. Returns (base_name, label_text or
    None); the label text is rendered verbatim inside the sample's
    braces (the producer writes valid `k="v"` pairs; the exposition
    linter still checks the rendered output)."""
    if name.endswith("}") and "{" in name:
        base, _, rest = name.partition("{")
        return base, rest[:-1]
    return name, None


def _label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _reg_label(reg) -> str:
    meta = getattr(reg, "meta", {}) or {}
    return str(meta.get("stage") or meta.get("driver") or "run")


def prometheus_text(docs: dict[str, dict],
                    elapsed: dict[str, float] | None = None) -> str:
    """Render {stage_label: metrics_doc} (MetricsRegistry.as_dict
    shapes) as Prometheus text exposition format. Counters become
    `<prefix><name>_total` (TYPE counter), gauges `<prefix><name>`
    (TYPE gauge), exact-count histograms cumulative `_bucket{le=...}`
    series plus `_sum`/`_count` (TYPE histogram). Every sample carries
    a `stage` label so the driver and both stages coexist in one
    exposition."""
    # name -> (type, [lines]) keeps each # TYPE header emitted once
    # even when several stages share a metric name
    out: dict[str, tuple[str, list[str]]] = {}

    def add(name: str, mtype: str, line: str) -> None:
        if name not in out:
            out[name] = (mtype, [])
        out[name][1].append(line)

    for label, doc in sorted(docs.items()):
        stage_lab = f'stage="{_label_value(label)}"'

        def labs(k: str) -> tuple[str, str]:
            """(prometheus base name, full label text) for a registry
            key that may carry an embedded label set."""
            base, extra = split_labeled_name(k)
            name = PREFIX + _metric_name(base)
            return name, (stage_lab if extra is None
                          else f"{stage_lab},{extra}")

        for k, v in doc.get("counters", {}).items():
            name, lab = labs(k)
            name += "_total"
            add(name, "counter", f"{name}{{{lab}}} {v}")
        for k, v in doc.get("gauges", {}).items():
            name, lab = labs(k)
            add(name, "gauge", f"{name}{{{lab}}} {v}")
        if elapsed and label in elapsed:
            name = PREFIX + "elapsed_seconds"
            add(name, "gauge",
                f"{name}{{{stage_lab}}} {round(elapsed[label], 3)}")
        for k, h in doc.get("histograms", {}).items():
            name, lab = labs(k)
            # exact per-value counts -> cumulative le buckets; the
            # cardinality-guard "overflow" key lands in +Inf only
            numeric = sorted(int(b) for b in h.get("counts", {})
                             if str(b).lstrip("-").isdigit())
            cum = 0
            for b in numeric:
                cum += h["counts"][str(b)]
                add(name, "histogram",
                    f'{name}_bucket{{{lab},le="{b}"}} {cum}')
            add(name, "histogram",
                f'{name}_bucket{{{lab},le="+Inf"}} {h.get("count", 0)}')
            add(name, "histogram", f"{name}_sum{{{lab}}} {h.get('sum', 0)}")
            add(name, "histogram",
                f"{name}_count{{{lab}}} {h.get('count', 0)}")

    lines: list[str] = []
    for name in sorted(out):
        mtype, samples = out[name]
        lines.append(f"# TYPE {name} {mtype}")
        lines.extend(samples)
    return "\n".join(lines) + ("\n" if lines else "")


def render_live() -> str:
    """Prometheus text for every live registry in this process, plus
    the retained final documents of registries that already finished
    (so one scrape/textfile carries every stage the run touched)."""
    with _LIVE_LOCK:
        finals = dict(_FINAL)
        regs = list(_LIVE)
    docs: dict[str, dict] = {}
    elapsed: dict[str, float] = {}
    for label, (doc, el) in finals.items():
        docs[label] = doc
        elapsed[label] = el
    from_final = set(docs)
    for reg in regs:
        label = _reg_label(reg)
        if label in from_final:
            from_final.discard(label)  # live registry supersedes its
            # own (or a predecessor's) retained snapshot
        elif label in docs:  # two LIVE regs sharing a label: the
            label = f"{label}_{len(docs)}"  # later wins its own slot
        docs[label] = reg.as_dict()
        elapsed[label] = reg.elapsed()
    return prometheus_text(docs, elapsed)


def write_textfile(path: str, text: str | None = None) -> str:
    """Atomically replace `path` with the current live rendering: a
    reader at the rename target can never observe a half-written
    file. An optional writer on the degradation ladder:
    ENOSPC disables the textfile for the rest of the run — scraping
    goes stale, the run keeps going."""
    if resources.degraded("metrics.textfile"):
        return path
    with resources.guard("metrics.textfile", path=path):
        if text is None:
            text = render_live()
        atomic_write(path, text)
    return path


def attach_textfile(reg, path: str, period: float = 1.0) -> None:
    """Refresh the Prometheus textfile from `reg`'s heartbeats (each
    write renders ALL live registries, so one file serves a whole
    driver run), rate-limited to `period`, plus one final write when
    the registry writes its JSON.

    Attaching a path this process has not written before marks a NEW
    job: retained finals from earlier runs are dropped so the new
    textfile never reports a previous job's counters. Re-attaching a
    known path (the driver's stages sharing one file) retains them —
    that sharing is the point. Back-to-back jobs reusing one path in
    one process should call `reset_exposition()` between runs."""
    with _LIVE_LOCK:
        if path not in _TEXTFILE_PATHS:
            _TEXTFILE_PATHS.add(path)
            _FINAL.clear()
    register_live(reg)
    last = [-1e18]

    def export(reg_, final: bool = False) -> None:
        now = time.perf_counter()
        if not final and now - last[0] < period:
            return
        last[0] = now
        try:
            write_textfile(path)
        except OSError:  # pragma: no cover - exposition must not kill runs
            pass

    reg.add_exporter(export)


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

class MetricsHTTPServer:
    """`/metrics` + `/healthz` on a daemon thread (stdlib
    http.server). `close()` (idempotent) shuts the socket down; the
    CLIs call it from their finally blocks so the port frees even on
    error exits. Binds loopback by default: the exposition is
    unauthenticated and carries run metadata (input paths, cmdline) —
    pass host="0.0.0.0" explicitly to scrape from off-machine."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        import http.server

        t0 = time.perf_counter()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split("?")[0] == "/metrics":
                    body = render_live().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] == "/healthz":
                    body = (json.dumps(
                        {"status": "ok",
                         "uptime_s": round(time.perf_counter() - t0, 3),
                         "registries": len(live_registries())})
                        + "\n").encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet: scrapes are periodic
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        daemon=True)
        self._thread.start()
        self._open = True

    def close(self) -> None:
        global _SERVER_REF
        if not self._open:
            return
        self._open = False
        if _SERVER_REF is not None and _SERVER_REF() is self:
            _SERVER_REF = None  # current_server() -> None immediately,
            # not only after this object is garbage-collected
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def serve(port: int, host: str = "127.0.0.1") -> MetricsHTTPServer:
    """Start the live endpoint; port 0 binds an ephemeral port (read
    it back from `.port`)."""
    global _SERVER_REF
    reset_exposition()  # a fresh endpoint = a fresh job
    srv = MetricsHTTPServer(port, host=host)
    _SERVER_REF = weakref.ref(srv)
    return srv


def start_exposition(reg, port: int | None, textfile: str | None,
                     period: float = 0.0):
    """The one start sequence every CLI shares: serve `/metrics` when
    a port is given (recording `meta.metrics_port`), attach the
    textfile writer when a path is given (refreshed at `period`
    seconds when > 0, else 1 Hz). Returns the server (or None) for
    the caller's teardown path — call this INSIDE the same umbrella
    that stamps status=error, so a busy port still lands the error
    document."""
    server = None
    if port is not None:
        server = serve(port)
        reg.set_meta(metrics_port=server.port)
        from ..utils.vlog import vlog
        vlog("Serving live /metrics on port ", server.port)
    if textfile:
        attach_textfile(reg, textfile,
                        period=period if period and period > 0 else 1.0)
        reg.set_meta(metrics_textfile=textfile)
    return server


def current_server() -> MetricsHTTPServer | None:
    """The most recently started (still-alive) server in this process
    — lets tests and in-process tooling discover the ephemeral port."""
    return _SERVER_REF() if _SERVER_REF is not None else None


# ---------------------------------------------------------------------------
# Prometheus text linter (tools/metrics_check.py --prom)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r" (?P<value>[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))"
    r"(?: [0-9]+)?$")
_LABEL_RE = re.compile(
    r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')
_TYPE_RE = re.compile(
    r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
    r"(counter|gauge|histogram|summary|untyped)$")


def lint_prometheus_text(text: str) -> list[str]:
    """Validate Prometheus text exposition format (the shape the
    textfile collector and scrapers parse). Returns problems (empty =
    valid): malformed sample/TYPE lines, bad label syntax, counters
    not ending in _total, and non-monotonic histogram buckets."""
    errs: list[str] = []
    types: dict[str, str] = {}
    buckets: dict[tuple, list[tuple[float, float]]] = {}
    any_sample = False
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if line.startswith("# TYPE") and not _TYPE_RE.match(line):
                errs.append(f"line {i}: malformed TYPE line")
            elif _TYPE_RE.match(line):
                _, _, name, mtype = line.split(" ")
                types[name] = mtype
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errs.append(f"line {i}: not a valid sample line")
            continue
        any_sample = True
        name = m.group("name")
        labels = m.group("labels")
        lab_map: dict[str, str] = {}
        if labels:
            for part in _split_labels(labels[1:-1]):
                if not _LABEL_RE.match(part):
                    errs.append(f"line {i}: bad label {part!r}")
                else:
                    k, v = part.split("=", 1)
                    lab_map[k] = v[1:-1]
        base = name
        for suf in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(suf):
                base = name[: -len(suf)]
                break
        mtype = types.get(name) or types.get(base)
        if mtype == "counter" and not name.endswith("_total"):
            errs.append(f"line {i}: counter {name!r} missing _total")
        if name.endswith("_bucket"):
            le = lab_map.get("le")
            if le is None:
                errs.append(f"line {i}: histogram bucket without le=")
            else:
                try:
                    le_f = float("inf") if le == "+Inf" else float(le)
                except ValueError:
                    errs.append(f"line {i}: non-numeric le={le!r}")
                    continue
                key = (base, tuple(sorted(
                    (k, v) for k, v in lab_map.items() if k != "le")))
                buckets.setdefault(key, []).append(
                    (le_f, float(m.group("value"))))
    for (base, _lab), bs in buckets.items():
        bs.sort()
        vals = [v for _le, v in bs]
        if vals != sorted(vals):
            errs.append(f"histogram {base!r}: buckets not cumulative")
    if not any_sample:
        errs.append("no samples found")
    return errs


def _split_labels(s: str) -> list[str]:
    """Split `a="x",b="y"` on commas outside quotes."""
    parts, cur, in_q, esc = [], [], False, False
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
            continue
        if ch == "\\":
            cur.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
        if ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts
