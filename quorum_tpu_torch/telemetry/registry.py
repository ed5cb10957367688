"""Metrics registry: counters, gauges, histograms and a JSONL event sink
(counterpart of quorum_tpu/telemetry/registry.py).

Every layer of a run records what it did into ONE registry, which
writes a final schema-versioned JSON document (schema.py) and, with a
heartbeat interval, a JSONL event stream (heartbeats with Gbases/h so
far, hash grows, stage timings).

Zero cost when disabled: `registry_for(None)` returns the NULL
singleton, whose methods are no-ops and whose `enabled` flag lets
per-read hot paths skip deriving metrics at all.

Threads: counters, gauges and histograms each take a lock (the prefetch
producer, the render workers and the writer update them); the
registry's name maps and the event sink share one registry lock. Every
cost is per batch or per event, never per base.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .schema import SCHEMA_VERSION


def atomic_write(path: str, data) -> None:
    """Write a sibling tmp, fsync it, os.replace it onto `path`, then
    fsync the parent directory: a reader never sees a torn file, and the
    committed file survives power loss. Accepts str or bytes."""
    tmp = path + ".tmp"
    mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
    with open(tmp, mode) as f:
        f.write(data)
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:  # pragma: no cover - exotic filesystems
            pass
    os.replace(tmp, path)
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:  # pragma: no cover - unreadable parent
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _scalar(v):
    """A JSON-safe scalar (numpy and torch numbers pass through their
    __int__/__float__)."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, float, str)):
        return v
    for cast in (int, float):
        try:
            return cast(v)
        except (TypeError, ValueError):
            continue
    return str(v)


class Counter:
    """Monotone integer count."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += int(n)


class Gauge:
    """Last-set (or max/accumulated) numeric value."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self.value = _scalar(v)

    def set_max(self, v) -> None:
        v = _scalar(v)
        with self._lock:
            if v > self.value:
                self.value = v

    def add(self, v) -> None:
        with self._lock:
            self.value += v


class Histogram:
    """Integer-valued histogram: exact per-value counts plus count/sum."""

    __slots__ = ("counts", "count", "sum", "_lock")

    MAX_KEYS = 512

    def __init__(self):
        self.counts: dict = {}
        self.count = 0
        self.sum = 0
        self._lock = threading.Lock()

    def observe(self, value, n: int = 1) -> None:
        value, n = int(value), int(n)
        with self._lock:
            self.count += n
            self.sum += value * n
            if value in self.counts or len(self.counts) < self.MAX_KEYS:
                self.counts[value] = self.counts.get(value, 0) + n
            else:  # pragma: no cover - cardinality guard
                self.counts["overflow"] = (
                    self.counts.get("overflow", 0) + n)


class MetricsRegistry:
    """One per instrumented run. `path` receives the final JSON via
    `write()`; `heartbeat_s > 0` also opens `events_path` (default: <path
    minus .json>.events.jsonl) and rate-limits `heartbeat()` to that
    period. An explicit `events_path` streams events even when `path`
    is None; with `heartbeat_s <= 0` it heartbeats on every call."""

    enabled = True

    def __init__(self, path: str | None = None,
                 heartbeat_s: float = 0.0,
                 events_path: str | None = None):
        self.path = path
        self.heartbeat_s = float(heartbeat_s)
        if events_path is None and path and self.heartbeat_s > 0:
            base = path[:-5] if path.endswith(".json") else path
            events_path = base + ".events.jsonl"
        self.events_path = events_path
        self.meta: dict = {}
        self.timers: dict = {}
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self._events_f = None
        self._events_closed = False
        self._t0 = time.perf_counter()
        self._last_beat = -1e18
        self._exporters: list = []
        # the quality scorecard (quality.QualityScorecard) sets this;
        # as_dict() then derives the `quality` section from the
        # document's own counters and histograms
        self.quality = None

    # -- metric accessors (get-or-create) --------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter()
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge()
            return m

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            m = self._hists.get(name)
            if m is None:
                m = self._hists[name] = Histogram()
            return m

    def set_meta(self, **fields) -> None:
        self.meta.update(fields)

    def set_timer(self, name: str, timer_dict: dict) -> None:
        """Attach a StageTimer.as_dict() under `timers`."""
        self.timers[name] = timer_dict

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    # -- JSONL event sink -------------------------------------------------
    def event(self, kind: str, **fields) -> None:
        """Append one event line; a no-op without an events path."""
        if not self.events_path:
            return
        obj = {"event": kind, "t": round(self.elapsed(), 3)}
        for k, v in fields.items():
            obj[k] = _scalar(v)
        line = json.dumps(obj) + "\n"
        with self._lock:
            if self._events_closed:
                # a straggler after write() must not reopen (and so
                # truncate) the stream
                return
            if self._events_f is None:
                # unbuffered, one os-level write per whole line, fsync'd:
                # a kill lands between lines, never inside one
                self._events_f = open(self.events_path, "wb", buffering=0)
            self._events_f.write(line.encode())
            try:
                os.fsync(self._events_f.fileno())
            except OSError:  # pragma: no cover - exotic filesystems
                pass

    def add_exporter(self, fn) -> None:
        """Register `fn(reg, final=False)`, called on every
        `heartbeat()` and once with `final=True` from `write()`."""
        with self._lock:
            self._exporters.append(fn)

    def _notify_exporters(self, final: bool = False) -> None:
        for fn in list(self._exporters):
            try:
                fn(self, final=final)
            except Exception:  # noqa: BLE001 - an exporter never kills a run
                pass

    def heartbeat(self, **fields) -> None:
        """Rate-limited progress event. A `bases` field gets a derived
        `gb_per_h` (so far, since the registry was made); every record
        carries a monotonic `elapsed_s`. Exporters are notified on every
        call."""
        self._notify_exporters()
        if not self.events_path:
            return
        now = time.perf_counter()
        if self.heartbeat_s > 0 and now - self._last_beat < self.heartbeat_s:
            return
        self._last_beat = now
        el = self.elapsed()
        if "bases" in fields and el > 0:
            fields["gb_per_h"] = round(
                _scalar(fields["bases"]) / el * 3600.0 / 1e9, 4)
        self.event("heartbeat", elapsed_s=round(el, 3), **fields)

    # -- output -----------------------------------------------------------
    def as_dict(self) -> dict:
        with self._lock:
            out = {
                "schema": SCHEMA_VERSION,
                "meta": dict(self.meta),
                "counters": {k: c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {
                    k: {"count": h.count, "sum": h.sum,
                        "counts": {str(v): n
                                   for v, n in sorted(
                                       h.counts.items(),
                                       key=lambda kv: str(kv[0]))}}
                    for k, h in sorted(self._hists.items())},
                "timers": dict(self.timers),
            }
            if self.quality is not None:
                # a pure function of the sections built above: it never
                # re-enters the registry lock
                out["quality"] = self.quality.snapshot_from(out)
            return out

    def write(self, path: str | None = None) -> str | None:
        """Write the final metrics JSON (atomic replace), give exporters
        their final call and close the event sink. Returns the path
        written (None without one)."""
        self._notify_exporters(final=True)
        path = path or self.path
        doc = None
        if path:
            doc = self.as_dict()
            atomic_write(path, json.dumps(doc, indent=1) + "\n")
        with self._lock:
            if self._events_f is not None:
                self._events_f.close()
                self._events_f = None
            self._events_closed = True
        return path if doc is not None else None


class NullRegistry:
    """The disabled registry: every method is a no-op, and `enabled` is
    False so hot paths can skip deriving metrics."""

    enabled = False
    path = None
    events_path = None
    quality = None

    def counter(self, name):
        return _NULL_METRIC

    def gauge(self, name):
        return _NULL_METRIC

    def histogram(self, name):
        return _NULL_METRIC

    def set_meta(self, **fields):
        pass

    def set_timer(self, name, timer_dict):
        pass

    def add_exporter(self, fn):
        pass

    def event(self, kind, **fields):
        pass

    def heartbeat(self, **fields):
        pass

    def elapsed(self):
        return 0.0

    def as_dict(self):
        return {"schema": SCHEMA_VERSION, "meta": {}, "counters": {},
                "gauges": {}, "histograms": {}, "timers": {}}

    def write(self, path=None):
        return None


class _NullMetric:
    __slots__ = ()

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def set_max(self, v):
        pass

    def add(self, v):
        pass

    def observe(self, value, n=1):
        pass


_NULL_METRIC = _NullMetric()

NULL = NullRegistry()


def registry_for(path: str | None,
                 heartbeat_s: float = 0.0,
                 events_path: str | None = None,
                 force: bool = False) -> MetricsRegistry | NullRegistry:
    """A real registry when a `--metrics PATH` (or an explicit
    `events_path`) was given, or with `force` (`--metrics-live`: counters
    accumulate though no document lands); the NULL singleton when not."""
    if not path and not events_path and not force:
        return NULL
    return MetricsRegistry(path, heartbeat_s=heartbeat_s,
                           events_path=events_path)


def labeled(name: str, **labels) -> str:
    """A metric name carrying an embedded Prometheus label set:
    `labeled("partition_distinct", partition=3)` ->
    `partition_distinct{partition="3"}`."""
    lab = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{lab}}}"


def observe_dispatch_wait(reg, prefix: str, t0: float, t1: float,
                          t2: float, timer=None) -> None:
    """The per-batch device-time split every device loop records:
    dispatch (t0 -> t1, the host enqueueing the batch's launches) as
    `<prefix>_dispatch_us`, the wait for the card (t1 -> t2, the
    synchronize) as `<prefix>_wait_us`, in microseconds. `timer` (a
    StageTimer, or None) also gets `<prefix>_dispatch` /
    `<prefix>_wait` stages. Call sites: stage-1 insert (`insert`), the
    sketch pass (`sketch`), stage-2 correction (`device`), the sharded
    build (`shard_step`)."""
    if timer is not None:
        timer.add_time(f"{prefix}_dispatch", t1 - t0)
        timer.add_time(f"{prefix}_wait", t2 - t1)
    if getattr(reg, "enabled", False):
        reg.histogram(f"{prefix}_dispatch_us").observe(
            int((t1 - t0) * 1e6))
        reg.histogram(f"{prefix}_wait_us").observe(int((t2 - t1) * 1e6))
