"""The observability flags every CLI shares, and the one lifecycle they
run through (counterpart of quorum_tpu/cli/observability.py, limited to
the ported surface).

`add_observability_args` registers `--metrics`, `--metrics-interval`,
the live exposition's `--metrics-port` and `--metrics-textfile`,
`--trace-spans`, `--profile`, the resource guards' `--preflight` and
`--stall-timeout-s` and, on the stage and inspection CLIs,
`--metrics-live`; the flags whose machinery is not ported yet are
registered too, so that `refuse_unported` (cli/create_database.py)
refuses them with the reason and the ROADMAP item that brings them.

`observability()` builds the run's registry and span tracer, starts the
live exposition (telemetry/export.py: the `/metrics` endpoint and the
textfile) inside the error umbrella, installs the quality scorecard
whenever metrics are on, the ambient integrity registry and the
resource-guard frame (utils/resources: the degradation ladder, the disk
and RSS monitor over the run's artifact paths, the stall watchdog), and
on every exit path: parses the `--profile` trace into device-kernel
attribution (telemetry/devtrace.py), runs the `at_exit` hooks, stamps
the final document `ok` or `error` and writes it, closes the span file,
copies the span twin into the profile directory and frees the port.
"""

from __future__ import annotations

import argparse
import contextlib
import os

# dest -> the flag and the machinery it waits for, with its ROADMAP
# item; refuse_unported (cli/create_database.py) prints it
UNPORTED_OBSERVABILITY = {
    "metrics_push_url": "--metrics-push-url (the metrics pusher, ROADMAP "
                        "Queue 1 item 10)",
    "metrics_push_interval": "--metrics-push-interval (the metrics "
                             "pusher, ROADMAP Queue 1 item 10)",
    "alert_rules": "--alert-rules (the alert engine, ROADMAP Queue 1 "
                   "item 10)",
}


def add_observability_args(p: argparse.ArgumentParser,
                           driver: bool = False,
                           profile: bool = True) -> None:
    """The telemetry flag block. `driver=True` takes the quorum driver's
    wording (per-stage suffixes) and drops `--metrics-live`;
    `profile=False` drops `--profile` (quorum-serve's surface, as the
    JAX package's)."""
    p.add_argument("--metrics", metavar="path", default=None,
                   help="Write a final metrics JSON (schema "
                        "quorum-tpu-metrics/1) to this path"
                        + ("; each stage writes its own beside it, "
                           "suffixed .stage1/.stage2" if driver else ""))
    p.add_argument("--metrics-interval", metavar="seconds", type=float,
                   default=0.0,
                   help="With --metrics: also write JSONL heartbeat "
                        "events at this period (0 = off)")
    p.add_argument("--metrics-port", metavar="port", type=int,
                   default=None,
                   help="Serve live Prometheus /metrics (+ /healthz) "
                        "on this port during the run; 0 = ephemeral"
                        + (". One endpoint carries the driver and "
                           "both stages under stage=... labels"
                           if driver else ""))
    p.add_argument("--metrics-textfile", metavar="path", default=None,
                   help="Atomically refresh a Prometheus textfile "
                        "here on each heartbeat"
                        + (" (shared by the driver and both stages)"
                           if driver else ""))
    p.add_argument("--trace-spans", metavar="path", default=None,
                   help="Write hierarchical span JSONL here (plus a "
                        "Chrome trace_event twin, .trace.json)"
                        + (", suffixed .driver/.stage1/.stage2"
                           if driver else ""))
    if profile:
        p.add_argument("--profile", metavar="dir", default=None,
                       help="Write a torch.profiler (Kineto) trace to "
                            "this directory and attribute the card's "
                            "kernel time to each step in the metrics "
                            "document"
                            + (" (stage1/ and stage2/ under it)"
                               if driver else ""))
    p.add_argument("--preflight", choices=("strict", "warn", "off"),
                   default="warn",
                   help="Disk preflight before work starts: compare "
                        "estimated output/checkpoint bytes against "
                        "free space on the target filesystems. "
                        "strict refuses (rc 4, not retried), warn "
                        "(default) prints one line per short "
                        "filesystem, off skips the check"
                        + ("; forwarded to both stages" if driver
                           else ""))
    p.add_argument("--stall-timeout-s", metavar="seconds", type=float,
                   default=0.0,
                   help="Offline stall watchdog: abort a stage whose "
                        "batch cursor stops advancing for this long "
                        "(retryable rc 75, so a driver retry resumes "
                        "from checkpoint); 0 = off"
                        + ("; forwarded to both stages" if driver
                           else ""))
    if not driver:
        p.add_argument("--metrics-live", action="store_true",
                       help="Keep a live metrics registry even with no "
                            "output path, so a parent process's "
                            "exposition endpoint sees this stage (the "
                            "quorum driver forwards this with "
                            "--metrics-port)")
    for dest in UNPORTED_OBSERVABILITY:
        # the JAX package's defaults (a 0.0 interval is unused, as None)
        p.add_argument("--" + dest.replace("_", "-"), dest=dest,
                       default=0.0 if dest == "metrics_push_interval"
                       else None, help=argparse.SUPPRESS)


class ObservabilitySession:
    """What `observability()` yields: the registry and tracer, and what
    steers the final document.

    * `status`: the stamp of a clean exit ("ok" by default); an entry
      point that reports failure through its return code sets "error".
      An exception always stamps "error".
    * `at_exit(fn)`: `fn(registry)` runs before the final write on every
      exit path.
    """

    def __init__(self, registry, tracer):
        self.registry = registry
        self.tracer = tracer
        self.server = None  # the --metrics-port endpoint, if any
        self.quality = None  # QualityScorecard (telemetry/quality.py)
        self.status: str | None = None
        self._at_exit: list = []
        self._profile: str | None = None

    def at_exit(self, fn) -> None:
        self._at_exit.append(fn)

    def _record_devtrace(self) -> bool:
        """Parse the `--profile` directory the run wrote and land the
        device-kernel attribution; True when metrics were recorded."""
        if not self._profile or not self.registry.enabled:
            return False
        from ..telemetry import devtrace
        return devtrace.record_profile_metrics(self.registry,
                                               self._profile)

    def _finalize(self, ok: bool) -> None:
        reg = self.registry
        if not reg.enabled:
            return
        hooks = list(self._at_exit)
        if self.quality is not None:
            # close the last (possibly short) rate window
            hooks.insert(0, lambda _reg: self.quality.tick(final=True))
        for fn in hooks:
            try:
                fn(reg)
            except Exception:  # noqa: BLE001 - a hook never masks the exit
                pass
        recorded = self._record_devtrace()
        if not ok:
            reg.set_meta(status="error")
            reg.write()
        elif reg.meta.get("status") is None:
            reg.set_meta(status=self.status or "ok")
            reg.write()
        elif recorded:
            # the body wrote its document before the trace was parsed
            reg.write()


@contextlib.contextmanager
def observability(metrics: str | None = None, interval: float = 0.0,
                  port: int | None = None, textfile: str | None = None,
                  live: bool = False, trace_spans: str | None = None,
                  profile: str | None = None, watch_paths=(),
                  stall_timeout_s: float = 0.0, **meta):
    """The observability lifecycle: registry and tracer up front, and a
    teardown on every exit: the status-stamped final write (skipped when
    the body wrote it), the span file's close and the span twin copied
    into the profile directory. `meta` seeds the registry's meta
    (stage=..., and so on).

    `port` / `textfile` (`--metrics-port`, `--metrics-textfile`): the
    live exposition (telemetry/export.start_exposition), started inside
    the umbrella so that a busy port still lands the error document, and
    closed on every exit. Either, or `live`, makes the registry real
    without a `--metrics` path; `live=True` is the server's meaning
    (quorum-serve is its own `/metrics` endpoint).

    `watch_paths` / `stall_timeout_s`: the resource-guard frame
    (utils/resources.install). Watch paths (the run's output, checkpoint
    and metrics targets) arm the disk and RSS monitor (`disk_free_bytes*`,
    `host_rss_bytes`); a positive stall timeout arms the watchdog the
    stage loops beat. The frame pre-creates `writer_degraded_total`,
    `preflight_refusals_total` and `stall_aborts_total` in every live
    document.

    `profile` (the run's `--profile` directory) declares the devtrace
    surface in meta, so metrics_check requires the device names; the
    tracer then annotates each step for the profiler even without
    `--trace-spans`, and on exit the trace is parsed for device-kernel
    attribution.

    Typical shape::

        with observability(args.metrics, args.metrics_interval,
                           trace_spans=args.trace_spans,
                           profile=args.profile, stage="...") as obs:
            rc = run(obs.registry, obs.tracer)
            if rc != 0:
                obs.status = "error"
    """
    from ..io import integrity
    from ..telemetry import quality as quality_mod
    from ..telemetry import export as export_mod
    from ..telemetry import registry_for, tracer_for
    from ..utils import resources

    reg = registry_for(metrics, interval,
                       force=(port is not None or bool(textfile) or live))
    if meta:
        reg.set_meta(**meta)
    if profile and reg.enabled:
        reg.set_meta(profile=profile)
    tracer = tracer_for(trace_spans, annotate=bool(profile))
    obs = ObservabilitySession(reg, tracer)
    obs._profile = profile
    if reg.enabled:
        obs.quality = quality_mod.QualityScorecard(reg)
    # the loaders run far below the entry points: the registry is
    # installed ambiently for their verification counters; nested
    # blocks (the driver's stages) stack and restore it
    prev_integrity = integrity.install_registry(
        reg if reg.enabled else None)
    # the resource guards stack and restore the same way
    resources_token = resources.install(
        reg, watch_paths=watch_paths, stall_timeout_s=stall_timeout_s,
        interval_s=interval if interval and interval > 0 else 5.0)
    try:
        try:
            obs.server = export_mod.start_exposition(
                reg, port, textfile, period=interval)
            yield obs
        except BaseException:
            obs._finalize(ok=False)
            raise
        obs._finalize(ok=True)
    finally:
        resources.uninstall(resources_token)
        integrity.install_registry(prev_integrity)
        tracer.close()
        if profile and tracer.enabled:
            try:
                os.makedirs(profile, exist_ok=True)
                tracer.write_chrome_trace(
                    os.path.join(profile, "spans.trace.json"))
            except OSError:  # pragma: no cover - unwritable profile dir
                pass
        if obs.server is not None:
            obs.server.close()
