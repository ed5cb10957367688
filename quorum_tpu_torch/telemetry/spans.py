"""Hierarchical span tracing (counterpart of quorum_tpu/telemetry/spans.py).

`with tracer.span("stage2_batch", reads=n):` records start, duration,
parent (a per-thread stack) and scalar attributes of one region of host
work. Each span is mirrored into `torch.profiler.record_function`, so
that under `--profile` the host spans line up with the card's timeline
in the Kineto trace. `tracer.step(name, i)` marks a device step; its
annotation is named `name#i` (record_function carries no arguments),
which is how telemetry/devtrace.py finds the step windows.

Two artifacts from one `--trace-spans PATH`:

* `PATH`, span JSONL, one object per line, streamed as spans close
  (schema: `validate_span_line` in schema.py);
* the Chrome `trace_event` twin (`PATH` with `.jsonl` swapped for
  `.trace.json`), written at `close()`.

A tracer without a path (`tracer_for(None, annotate=True)`, what
`--profile` alone makes) keeps its spans in memory and writes only the
twin that observability() places in the profile directory.

Zero cost when disabled: `tracer_for(None)` returns the NULL singleton
whose `span`/`step` are no-op context managers.

Both are optional writers (utils/resources): ENOSPC drops the trace for
the rest of the run, never the run.

Threads: the parent stack is thread-local (the prefetch producer and
the render workers each get their own lineage); the JSONL sink and the
retained-span list share one lock.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

from ..utils import resources
from .registry import _scalar, atomic_write


def chrome_trace_path(path: str) -> str:
    """The Chrome trace twin of a span-JSONL path: `.jsonl` (or `.json`)
    swapped for `.trace.json`, else appended."""
    for ext in (".jsonl", ".json"):
        if path.endswith(ext):
            return path[: -len(ext)] + ".trace.json"
    return path + ".trace.json"


def step_annotation(name: str, step: int) -> str:
    """The profiler annotation of device step `step` of loop `name`."""
    return f"{name}#{int(step)}"


class SpanTracer:
    """One per instrumented run (`--trace-spans PATH`, or `--profile`)."""

    enabled = True

    # retained-span cap for the Chrome export; past it the twin is
    # truncated (and says so in its metadata) while the JSONL keeps
    # every span
    MAX_RETAINED = 100_000

    def __init__(self, path: str | None, chrome_path: str | None = None):
        self.path = path
        self.chrome_path = chrome_path or (
            chrome_trace_path(path) if path else None)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._f = None
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._spans: list[dict] = []
        self._dropped = 0
        self._tids: dict[int, int] = {}
        self._closed = False

    # -- internals --------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        """Small stable per-thread id (Chrome tid / JSONL `tid`)."""
        ident = threading.get_ident()
        with self._lock:
            t = self._tids.get(ident)
            if t is None:
                t = self._tids[ident] = len(self._tids)
            return t

    def _record(self, name: str, sid: int, parent: int | None,
                ts: float, dur: float, attrs: dict) -> None:
        obj = {"span": name, "id": sid, "parent": parent,
               "tid": self._tid(),
               "ts": round(ts, 6), "dur": round(dur, 6)}
        for k, v in attrs.items():
            obj[k] = _scalar(v)
        line = json.dumps(obj) + "\n"
        enospc = None
        with self._lock:
            if self._closed:
                # a straggler thread outliving close(): reopening the
                # JSONL would truncate it
                self._dropped += 1
                return
            if len(self._spans) < self.MAX_RETAINED:
                self._spans.append(obj)
            else:
                self._dropped += 1
            if self.path and not resources.degraded("trace.spans"):
                try:
                    if self._f is None:
                        self._f = open(self.path, "w")
                    self._f.write(line)
                    self._f.flush()
                except OSError as e:
                    # traces are an optional writer: a full disk drops
                    # the trace, never the run (the ladder call runs
                    # outside the lock)
                    if not resources.is_enospc(e):
                        raise
                    enospc = e
                    if self._f is not None:
                        try:
                            self._f.close()
                        except OSError:
                            pass
                        self._f = None
        if enospc is not None:
            resources.degrade("trace.spans", enospc, path=self.path)

    @contextlib.contextmanager
    def _span(self, name: str, step, attrs: dict):
        from torch.profiler import record_function

        stack = self._stack()
        sid = next(self._ids)
        parent = stack[-1] if stack else None
        stack.append(sid)
        label = name
        if step is not None:
            attrs = dict(attrs, step=step)
            label = step_annotation(name, step)
        t0 = time.perf_counter()
        try:
            with record_function(label):
                yield
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            self._record(name, sid, parent, t0 - self._t0, dur, attrs)

    # -- public surface ---------------------------------------------------
    def span(self, name: str, **attrs):
        """Record a host region; nests through the per-thread stack."""
        return self._span(name, None, attrs)

    def step(self, name: str, step: int, **attrs):
        """Record a device step tagged with its number; its profiler
        annotation is `name#step`, the window devtrace joins the card's
        kernels to."""
        return self._span(name, int(step), attrs)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def as_chrome_trace(self) -> dict:
        """The retained spans as a Chrome trace_event document ("X"
        complete events, microseconds)."""
        pid = os.getpid()
        with self._lock:
            events = [
                {"name": s["span"], "ph": "X", "pid": pid,
                 "tid": s["tid"],
                 "ts": round(s["ts"] * 1e6, 3),
                 "dur": round(s["dur"] * 1e6, 3),
                 "args": {k: v for k, v in s.items()
                          if k not in ("span", "ts", "dur", "tid")}}
                for s in self._spans
            ]
            dropped = self._dropped
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if dropped:
            doc["metadata"] = {"dropped_spans": dropped}
        return doc

    def write_chrome_trace(self, path: str | None = None) -> str | None:
        """Write the Chrome trace JSON (atomic replace). Returns the path
        written."""
        path = path or self.chrome_path
        if not path or resources.degraded("trace.spans"):
            return None
        with resources.guard("trace.spans", path=path):
            atomic_write(path, json.dumps(self.as_chrome_trace()) + "\n")
            return path
        return None  # the guard swallowed an ENOSPC: the trace degraded

    def close(self) -> None:
        """Close the JSONL sink and write the Chrome twin. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._f is not None:
                self._f.close()
                self._f = None
        self.write_chrome_trace()


class NullTracer:
    """The disabled tracer: every surface is a no-op."""

    enabled = False
    path = None
    chrome_path = None

    @contextlib.contextmanager
    def _noop(self):
        yield

    def span(self, name, **attrs):
        return self._noop()

    def step(self, name, step, **attrs):
        return self._noop()

    def elapsed(self):
        return 0.0

    def as_chrome_trace(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path=None):
        return None

    def close(self):
        pass


NULL_TRACER = NullTracer()


def tracer_for(path: str | None,
               annotate: bool = False) -> SpanTracer | NullTracer:
    """A real tracer when a `--trace-spans PATH` was given, or a
    path-less one with `annotate` (a `--profile` run: its step windows
    must reach the profiler); the no-op singleton otherwise."""
    if not path and not annotate:
        return NULL_TRACER
    return SpanTracer(path or None)
