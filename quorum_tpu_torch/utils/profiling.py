"""Profiling and per-stage timing (counterpart of
quorum_tpu/utils/profiling.py).

* `trace(dir, device)` wraps `torch.profiler.profile` where the JAX
  package wraps `jax.profiler.trace`: the device CLIs take
  `--profile DIR`, and the Kineto Chrome trace lands in DIR as
  TRACE_NAME. A CUDA run records CPU and CUDA activity (CUPTI: the
  card's own kernel timeline), a CPU run CPU activity alone; shapes and
  stacks stay off. While it runs, each kernel wrapper call is a
  profiler range too (kernels/loader STATS.annotate).
  telemetry/devtrace.py reads the trace after the run.
* `StageTimer`: wall-clock accumulators for the coarse pipeline stages,
  with units (bases) for a rate; `as_dict` is the metrics document's
  `timers` table, `report` prints it through vlog.
"""

from __future__ import annotations

import contextlib
import os
import time

from .vlog import vlog

# the Kineto trace's name in a --profile directory (devtrace reads every
# *.trace.json under the directory but the span twin)
TRACE_NAME = "torch_profiler.trace.json"


def trace_activities(device):
    """The profiler activities of a run on `device`: CPU, plus CUDA on
    a CUDA run. A CUDA run where the profiler cannot record CUDA
    activity raises: a profile of the host alone would pass for one
    of the card."""
    import torch
    from torch.profiler import ProfilerActivity, supported_activities

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "--profile on a CUDA run needs the profiler's CUDA "
                "activity (CUPTI), which this torch build does not offer")
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(profile_dir: str | None, device="cpu"):
    """`torch.profiler.profile` around the body when a directory is
    given, no-op when not. The trace is written when the body ends,
    also when it raised; the vlog pointer is printed then, but never
    when the profiler itself failed to start or to write."""
    if not profile_dir:
        yield
        return
    from torch.profiler import profile

    from ..kernels.loader import STATS

    path = os.path.join(profile_dir, TRACE_NAME)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=trace_activities(device),
                   record_shapes=False, with_stack=False)
    body_exc = None
    annotate, STATS.annotate = STATS.annotate, True
    try:
        with prof:
            try:
                yield
            except BaseException as e:
                body_exc = e
                raise
    except BaseException as e:
        if e is body_exc:
            try:
                prof.export_chrome_trace(path)
            except (OSError, RuntimeError):
                raise e from None
            vlog("Wrote profiler trace to ", profile_dir)
        raise
    finally:
        STATS.annotate = annotate
    prof.export_chrome_trace(path)
    vlog("Wrote profiler trace to ", profile_dir)


class StageTimer:
    """Named wall-clock accumulators: ``with t.stage("seal"): ...``.
    Also counts units (bases) per stage (``add_units``), so the report
    prints a rate, not just a duration."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.units: dict[str, int] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def add_units(self, name: str, n: int) -> None:
        self.units[name] = self.units.get(name, 0) + n

    def add_time(self, name: str, dt: float, calls: int = 1) -> None:
        """Accumulate a duration measured elsewhere (the per-batch
        dispatch/wait split)."""
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.calls[name] = self.calls.get(name, 0) + calls

    def as_dict(self, total_units: int = 0, unit: str = "bases") -> dict:
        """The metrics document's `timers` table (schema.py)."""
        total = time.perf_counter() - self._t0
        d: dict = {
            "total_seconds": round(total, 6),
            "stages": {
                name: {"seconds": round(self.seconds[name], 6),
                       "calls": self.calls[name],
                       "units": self.units.get(name, 0)}
                for name in self.seconds
            },
        }
        if total_units and total > 0:
            d["total_units"] = total_units
            d["unit"] = unit
            d["units_per_hour"] = round(total_units / total * 3600, 3)
        return d

    def report(self, total_units: int = 0, unit: str = "bases") -> None:
        """Print the stage table through vlog (visible with -v)."""
        d = self.as_dict(total_units, unit)
        total = d["total_seconds"]

        def pct(s: float) -> float:
            return 100.0 * s / total if total > 0 else 0.0

        for name, st in d["stages"].items():
            s = st["seconds"]
            line = (f"stage {name:<12} {s:8.3f}s "
                    f"({pct(s):5.1f}%) x{st['calls']}")
            if st["units"] and s > 0:
                line += f"  {st['units'] / s / 1e6:.2f} M{unit}/s"
            vlog(line)
        accounted = sum(st["seconds"] for st in d["stages"].values())
        vlog(f"stage {'(other)':<12} {total - accounted:8.3f}s "
             f"({pct(total - accounted):5.1f}%)")
        if total_units and total > 0:
            vlog(f"total {total:.3f}s, "
                 f"{total_units / total * 3600 / 1e9:.3f} G{unit}/hour "
                 "end-to-end")
