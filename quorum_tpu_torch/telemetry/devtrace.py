"""Device-truth telemetry from the `--profile` directory's Kineto trace
(the port's counterpart of quorum_tpu/telemetry/devtrace.py, which reads
XLA's trace).

`utils/profiling.trace` writes torch.profiler's Chrome trace into the
profile directory. The card's own timeline is in it: CUPTI stamps each
kernel, copy and set on its stream lane. This module joins those to the
run's steps:

* **Kernel events** are `X` events of category `kernel`. Copies
  (`gpu_memcpy`) and sets (`gpu_memset`) are counted apart: they keep
  the card busy (they are not idle) but are not kernels.
* **Steps** are the host ranges `tracer.step(name, i)` makes, named
  `name#i` (telemetry/spans.py); **launches** the ranges the kernel
  wrappers make while a profile runs (`launch:<kernel>`,
  kernels/loader.launching).
* **The join.** Each device activity carries the correlation id of the
  runtime call that launched it (`cuda_runtime` events, on the host
  thread's timeline), so it joins the step and the wrapper whose host
  range holds that call: a kernel launched in step i counts in step i
  even when it runs after step i's host range closed, and a kernel
  launched inside a wrapper's range nested in the step counts in both.
  A step's device window spans its activities, first to last.
  `meta.devtrace_source` is `kineto:launch_correlation`. Kineto's
  `gpu_user_annotation` projections are not read: a projection covers
  only the activities launched directly in its range, not those of the
  wrappers' ranges nested inside. A trace whose device activity no
  runtime call claims lands zeros, its source named
  `kineto:no_launch_correlation`.

That gives per-step `device_kernel_us` (one histogram observation a
step), per-stage totals (one entry per step name), per-step idle (the
window less the union of its activities: the card waiting on the host),
the top kernels by device time, and per wrapper its calls, host time,
device-side extent and kernel time.

A trace with no device activity (a CPU run) lands zeros, its source
named `kineto:no_device_activity`: host time is never written under a
device metric's name.
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import gzip
import json
import os
import re

TOP_K = 10

SPANS_TWIN = "spans.trace.json"  # the host span twin, not device truth

_STEP = re.compile(r"^(.+)#(\d+)$")
LAUNCH_PREFIX = "launch:"

SOURCE_LAUNCH = "kineto:launch_correlation"
SOURCE_NO_LAUNCH = "kineto:no_launch_correlation"
SOURCE_NO_DEVICE = "kineto:no_device_activity"
SOURCE_NONE = "none"


@dataclasses.dataclass
class StepWindow:
    """One step annotation on the timeline."""

    name: str
    step: int
    ts_us: float
    dur_us: float
    kernel_us: float = 0.0
    idle_us: float = 0.0
    n_kernels: int = 0
    _busy: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def end_us(self) -> float:
        return self.ts_us + self.dur_us


@dataclasses.dataclass
class DevtraceSummary:
    """What a profile directory says about device time."""

    source: str = SOURCE_NONE
    files: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)  # StepWindow
    kernels: dict = dataclasses.field(default_factory=dict)  # name -> us
    total_kernel_us: float = 0.0
    total_step_us: float = 0.0
    total_idle_us: float = 0.0
    unattributed_kernel_us: float = 0.0
    memcpy_us: float = 0.0
    memset_us: float = 0.0
    # per wrapper (kernels/loader counter name): calls, host us, device
    # extent us, kernel us
    launches: dict = dataclasses.field(default_factory=dict)

    def _by_stage(self, field: str) -> dict:
        out: dict[str, float] = {}
        for w in self.steps:
            out[w.name] = out.get(w.name, 0.0) + getattr(w, field)
        return out

    def stage_kernel_us(self) -> dict:
        """Kernel totals per step name (stage attribution)."""
        return self._by_stage("kernel_us")

    def stage_idle_us(self) -> dict:
        return self._by_stage("idle_us")

    def stage_step_us(self) -> dict:
        return self._by_stage("dur_us")

    def stage_steps(self) -> dict:
        out: dict[str, int] = {}
        for w in self.steps:
            out[w.name] = out.get(w.name, 0) + 1
        return out

    def top_kernels(self, k: int = TOP_K) -> list:
        """[(name, total_us)] by device time, largest first."""
        return sorted(self.kernels.items(), key=lambda kv: -kv[1])[:k]


def kernel_label(name: str) -> str:
    """A Kineto kernel name without its return type and parameter list:
    `void head_kernel<24>(Wire, ...)` -> `head_kernel<24>`."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("(", 1)[0].strip()
    if head.startswith("void "):
        head = head[5:]
    return head or name


def find_trace_files(profile_dir: str) -> list[str]:
    """Kineto traces under `profile_dir`, recursively (the quorum driver
    nests stage1/ and stage2/ under one root); never the span twin."""
    out: list[str] = []
    for pat in ("**/*.trace.json", "**/*.trace.json.gz"):
        out.extend(glob.glob(os.path.join(profile_dir, pat),
                             recursive=True))
    return sorted(p for p in set(out) if os.path.basename(p) != SPANS_TWIN)


def _load(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        doc = json.loads(f.read().decode())
    return doc.get("traceEvents", []) if isinstance(doc, dict) else []


def _ranges(events: list) -> tuple[list, list]:
    """The host annotations: (step ranges, launch ranges), each entry
    (pid, tid, ts, end, key); a step's key is (name, step), a launch's
    its kernel name."""
    steps, launches = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        name = str(e.get("name", ""))
        ts = float(e.get("ts", 0.0))
        rng = (e.get("pid"), e.get("tid"), ts,
               ts + float(e.get("dur", 0.0) or 0.0))
        if name.startswith(LAUNCH_PREFIX):
            launches.append(rng + (name[len(LAUNCH_PREFIX):],))
            continue
        m = _STEP.match(name)
        if m is not None:
            steps.append(rng + ((m.group(1), int(m.group(2))),))
    return steps, launches


class _Lookup:
    """Which host range of a thread covers a time: its index in the list
    it was built from, or -1."""

    def __init__(self, ranges: list):
        self.index: dict = {}
        for i, (pid, tid, ts, end, _key) in enumerate(ranges):
            self.index.setdefault((pid, tid), []).append((ts, end, i))
        for lane in self.index:
            self.index[lane].sort()
        self.starts = {lane: [r[0] for r in v]
                       for lane, v in self.index.items()}

    def find(self, host) -> int:
        """`host` is a launch call's (pid, tid, ts), or None."""
        rs = self.index.get(host[:2]) if host else None
        if not rs:
            return -1
        j = bisect.bisect_right(self.starts[host[:2]], host[2]) - 1
        return rs[j][2] if j >= 0 and host[2] <= rs[j][1] else -1


def _union_us(intervals: list) -> float:
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur_a, cur_b = intervals[0]
    for a, b in intervals[1:]:
        if a > cur_b:
            total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return total + (cur_b - cur_a)


def summarize_events(events: list) -> DevtraceSummary:
    """Join one trace's device activity to its steps and launches."""
    s = DevtraceSummary()
    device = []  # (cat, name, ts, dur, correlation)
    runtime = {}  # correlation -> (pid, tid, host ts) of the launch call
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        args = e.get("args") or {}
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dur = float(e.get("dur", 0.0) or 0.0)
            if dur > 0:
                device.append((cat, str(e.get("name", "")),
                               float(e.get("ts", 0.0)), dur,
                               args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver") and \
                "correlation" in args:
            runtime[args["correlation"]] = (e.get("pid"), e.get("tid"),
                                            float(e.get("ts", 0.0)))
    if not device:
        s.source = SOURCE_NO_DEVICE
        return s
    if not any(d[4] in runtime for d in device):
        s.source = SOURCE_NO_LAUNCH
        return s
    s.source = SOURCE_LAUNCH
    steps, launches = _ranges(events)
    find_step, find_launch = _Lookup(steps), _Lookup(launches)
    acts: dict = {}  # step key -> its activities
    calls: dict[int, list] = {}  # launch index -> its activities
    for cat, name, ts, dur, corr in device:
        host = runtime.get(corr)
        i, j = find_step.find(host), find_launch.find(host)
        if i >= 0:
            acts.setdefault(steps[i][4], []).append((cat, ts, dur))
        if j >= 0:
            calls.setdefault(j, []).append((cat, ts, dur))
        if cat == "gpu_memcpy":
            s.memcpy_us += dur
        elif cat == "gpu_memset":
            s.memset_us += dur
        else:
            label = kernel_label(name)
            s.kernels[label] = s.kernels.get(label, 0.0) + dur
            s.total_kernel_us += dur
            if i < 0:
                s.unattributed_kernel_us += dur
    for (name, step) in dict.fromkeys(key for *_r, key in steps):
        mine = acts.get((name, step), [])
        # the device-side window: the step's activities, first to last
        a = min((t for _c, t, _d in mine), default=0.0)
        b = max((t + d for _c, t, d in mine), default=a)
        w = StepWindow(name, step, a, b - a)
        for cat, ts, dur in mine:
            if cat == "kernel":
                w.kernel_us += dur
                w.n_kernels += 1
            w._busy.append((ts, ts + dur))
        w.idle_us = max(0.0, w.dur_us - _union_us(w._busy))
        s.total_step_us += w.dur_us
        s.total_idle_us += w.idle_us
        s.steps.append(w)
    s.steps.sort(key=lambda w: w.ts_us)
    for _pid, _tid, ts, end, name in launches:
        rec = s.launches.setdefault(name, dict.fromkeys(
            ("calls", "host_us", "device_us", "kernel_us"), 0))
        rec["calls"] += 1
        rec["host_us"] += end - ts
    for j, mine in calls.items():
        name = launches[j][4]
        rec = s.launches.setdefault(name, dict.fromkeys(
            ("calls", "host_us", "device_us", "kernel_us"), 0))
        rec["device_us"] += (max(t + d for _c, t, d in mine)
                             - min(t for _c, t, _d in mine))
        rec["kernel_us"] += sum(d for c, _t, d in mine if c == "kernel")
    return s


def summarize_profile(profile_dir: str) -> DevtraceSummary:
    """Parse every trace under `profile_dir`, each joined on its own (a
    session per file), then merged. `source` is the first readable
    trace's device-bearing source, SOURCE_NO_DEVICE when none carries
    device activity, SOURCE_NONE when the directory holds no readable
    trace."""
    s = DevtraceSummary()
    sources = []
    for path in find_trace_files(profile_dir):
        try:
            part = summarize_events(_load(path))
        except (OSError, ValueError):
            continue
        s.files.append(path)
        sources.append(part.source)
        s.steps.extend(part.steps)
        for name, us in part.kernels.items():
            s.kernels[name] = s.kernels.get(name, 0.0) + us
        for name, rec in part.launches.items():
            mine = s.launches.setdefault(name, dict.fromkeys(rec, 0))
            for key, v in rec.items():
                mine[key] += v
        for key in ("total_kernel_us", "total_step_us", "total_idle_us",
                    "unattributed_kernel_us", "memcpy_us", "memset_us"):
            setattr(s, key, getattr(s, key) + getattr(part, key))
    device = [x for x in sources if x != SOURCE_NO_DEVICE]
    s.source = (device[0] if device else
                SOURCE_NO_DEVICE if sources else SOURCE_NONE)
    if device and len(set(device)) > 1:
        s.source = "+".join(sorted(set(device)))
    return s


def record_profile_metrics(reg, profile_dir: str,
                           top_k: int = TOP_K) -> bool:
    """Land the summary in the run's registry. The names exist even when
    the directory holds no trace (zeros: tools/metrics_check.py requires
    them whenever meta declares `profile`). Returns True when the
    registry is enabled (the caller re-writes a document written
    before)."""
    if not getattr(reg, "enabled", False):
        return False
    try:
        s = summarize_profile(profile_dir)
    except Exception as e:  # noqa: BLE001 - telemetry never kills a run
        s = DevtraceSummary()
        reg.set_meta(devtrace_error=str(e))
    reg.counter("device_kernel_us_total").inc(int(s.total_kernel_us))
    reg.counter("device_step_us_total").inc(int(s.total_step_us))
    reg.counter("device_idle_us_total").inc(int(s.total_idle_us))
    reg.counter("device_kernel_unattributed_us_total").inc(
        int(s.unattributed_kernel_us))
    reg.gauge("devtrace_steps").set(len(s.steps))
    hist = reg.histogram("device_kernel_us")
    for w in s.steps:
        hist.observe(int(w.kernel_us))

    def rounded(d: dict) -> dict:
        return {k: round(v, 1) for k, v in sorted(d.items())}

    meta = dict(
        devtrace_source=s.source,
        devtrace_files=len(s.files),
        devtrace_stage_steps=dict(sorted(s.stage_steps().items())),
        devtrace_stage_kernel_us=rounded(s.stage_kernel_us()),
        devtrace_stage_step_us=rounded(s.stage_step_us()),
        devtrace_stage_idle_us=rounded(s.stage_idle_us()),
        devtrace_memcpy_us=round(s.memcpy_us, 1),
        devtrace_memset_us=round(s.memset_us, 1),
        devtrace_top_kernels=[f"{name}={round(us, 1)}"
                              for name, us in s.top_kernels(top_k)],
    )
    if s.launches:
        for key in ("calls", "host_us", "device_us", "kernel_us"):
            meta[f"devtrace_launch_{key}"] = {
                name: (rec[key] if key == "calls" else round(rec[key], 1))
                for name, rec in sorted(s.launches.items())}
    reg.set_meta(**meta)
    return True
