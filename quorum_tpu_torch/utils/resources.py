"""Resource-exhaustion robustness (counterpart of
quorum_tpu/utils/resources.py): disk and memory guards, the writer
degradation ladder, and the offline stall watchdog.

1. **Preflight and watermarks.** :func:`preflight` compares estimated
   output and checkpoint bytes (the ``estimate_*`` helpers; the port's
   table is the same bytes as the JAX package's, so the formulas carry
   over) against the target filesystems before work starts: refuse
   under ``--preflight=strict`` (``preflight_refusals_total``, rc
   ``DISK_FULL_RC``), warn under the default ``warn``. A
   :class:`ResourceMonitor` ticker publishes ``disk_free_bytes{path=}``
   per watched filesystem, the scalar ``disk_free_bytes_min`` and
   ``host_rss_bytes``.

2. **The degradation ladder.** :data:`WRITERS` classifies every durable
   writer once. ENOSPC at a *required* writer (the database payload,
   the ``.fa``/``.log`` streams, the stage-2 journal) fails fast with
   :class:`ResourceExhausted` (rc ``DISK_FULL_RC``, which the driver
   does not retry); an *optional* writer (checkpoints, the replay
   cache, traces, the quarantine stream) is disabled for the rest of
   the run, ``writer_degraded_total{writer=}`` counts it, and the run
   completes with the same primary output. Wrap writer bodies in
   :func:`guard`; poll :func:`degraded` to skip a disabled writer.

3. **The offline stall watchdog.** The stage loops call
   :func:`watchdog_beat` once a batch; with ``--stall-timeout-s`` set,
   a cursor that stops advancing gets ``stall_aborts_total`` and a
   two-stage abort: a :class:`StallError` raised asynchronously into
   the stalled thread (it unwinds into the stage's error path, which
   returns the retryable ``STALL_RC``), then, if the thread never
   unwinds, ``os._exit(STALL_RC)`` after one more timeout. The soft
   abort lands only when the thread runs Python bytecode: a thread
   blocked in ``torch.cuda.synchronize`` or in a kernel launch sees it
   when the call returns, so only the hard abort ends a real device
   stall.

The JAX package also seals a flight-recorder dump at a required
writer's ENOSPC and at a stall; the port has no flight recorder yet
(ROADMAP Queue 1 item 10), so those steps print and count only.

Install discipline: :func:`install` / :func:`uninstall` stack like
``io/integrity.install_registry``; ``cli/observability.observability()``
installs a frame for each run and restores the previous one, so the
driver's frame survives its in-process stages. With no frame installed
every hook is a cheap no-op.
"""

from __future__ import annotations

import contextlib
import errno as errno_mod
import os
import shutil
import sys
import threading
import time

# Exit codes (the driver's retry loop dispatches on these;
# io/checkpoint.NON_RETRYABLE_RC = 3 is the existing non-retryable
# family). DISK_FULL_RC is distinct AND non-retryable: retrying a
# full disk burns the backoff budget to fail identically. STALL_RC is
# EX_TEMPFAIL: a stalled step is exactly the transient the retry loop
# exists for — the next attempt resumes from checkpoint.
DISK_FULL_RC = 4
STALL_RC = 75

# The errno family the ladder treats as "out of space": quota
# exhaustion is operationally identical to a full disk.
_ENOSPC_ERRNOS = (errno_mod.ENOSPC, errno_mod.EDQUOT)

REQUIRED = "required"
OPTIONAL = "optional"

# The writer catalog: every durable writer the pipeline owns,
# classified ONCE (the degradation ladder's single source of truth —
# tests/test_resources.py sweeps it, the README section renders from
# it). A writer is *required* when the run's primary output is
# incomplete without it, *optional* when the run can finish
# byte-identically with it disabled.
WRITERS: dict[str, str] = {
    # required: the run's reason to exist
    "db.payload": REQUIRED,        # stage-1 DB export / shard files
                                   # (io/db_format._atomic_db_write)
    "output.stream": REQUIRED,     # stage-2 .fa/.log output streams
                                   # (utils/pipeline.AsyncWriter)
    "stage2.journal": REQUIRED,    # stage-2 resume journal — silently
                                   # dropping it would turn a later
                                   # crash into silent data loss
                                   # (io/checkpoint.Stage2Journal)
    # optional: the run completes byte-identically without them
    "stage1.checkpoint": OPTIONAL,  # stage-1 snapshots + sharded
                                    # manifests (io/checkpoint.py)
    "partition.cursor": OPTIONAL,   # --partitions pass cursor
    "sketch.checkpoint": OPTIONAL,  # prefilter sketch snapshot
    "replay.cache": OPTIONAL,       # driver replay capture (already
                                    # self-aborting; counted here)
    "quarantine.stream": OPTIONAL,  # --on-bad-read=quarantine stream
                                    # (io/fastq.BadReadPolicy)
    "trace.spans": OPTIONAL,        # span JSONL / Chrome trace
    "metrics.textfile": OPTIONAL,   # Prometheus textfile exports
    "epoch.snapshot": OPTIONAL,     # live-ingest epoch snapshot (the
                                    # JAX package's serve/ingest.py)
}


class ResourceExhausted(OSError):
    """A required writer hit ENOSPC (or a strict preflight refused):
    an OSError subclass so existing ``except OSError`` error paths
    still see it, carrying the writer name for the rc mapping. Maps to
    ``DISK_FULL_RC`` at every entry point."""

    def __init__(self, writer: str, detail: str):
        super().__init__(errno_mod.ENOSPC, detail)
        self.writer = writer


class StallError(RuntimeError):
    """Raised asynchronously into a stalled stage loop by the
    watchdog's soft abort: a RuntimeError so the stages' existing
    error contracts catch it; the entry points map it to the
    retryable ``STALL_RC``."""


def is_enospc(err: BaseException) -> bool:
    """Is this exception the out-of-space family the ladder acts on
    (ENOSPC/EDQUOT, at any wrap depth the writers produce)?"""
    return (isinstance(err, OSError)
            and getattr(err, "errno", None) in _ENOSPC_ERRNOS)


# -- the ambient frame ----------------------------------------------------
# One frame per observability() lifecycle: the registry the counters
# land in, the per-run degraded set, and the monitor/watchdog
# threads. Stacked (prev saved, restored at uninstall) exactly like
# integrity.install_registry, so the driver's frame survives its
# in-process stage children. _lock guards the degraded set and the
# watchdog beat cursor; every registry call happens outside it.
_lock = threading.Lock()


class _Frame:
    __slots__ = ("reg", "degraded", "monitor", "watchdog", "prev")

    def __init__(self, reg, prev):
        self.reg = reg
        self.degraded: dict[str, str] = {}  # writer -> first detail
        self.monitor = None
        self.watchdog = None
        self.prev = prev


_FRAME = _Frame(None, None)


def _registry():
    reg = _FRAME.reg
    return reg if reg is not None and getattr(reg, "enabled", False) \
        else None


def install(reg, watch_paths=(), stall_timeout_s: float = 0.0,
            interval_s: float = 5.0):
    """Install a resource-guard frame for one run: pre-create the
    contract counters (so a clean run still proves the guard was
    armed), start the disk/RSS monitor
    over `watch_paths`, and arm the stall watchdog when
    `stall_timeout_s` > 0. Returns a token for :func:`uninstall`;
    nest/restore discipline like integrity.install_registry."""
    global _FRAME
    frame = _Frame(reg, _FRAME)
    _FRAME = frame
    live = _registry()
    if live is not None:
        live.counter("writer_degraded_total")
        live.counter("preflight_refusals_total")
        live.counter("stall_aborts_total")
    paths = _dedupe_paths(watch_paths)
    if live is not None and paths:
        # meta.resource_guard is the metrics_check dispatch key: only
        # declare it when the gauges it requires will actually exist
        live.set_meta(resource_guard=True)
        frame.monitor = ResourceMonitor(live, paths,
                                        interval_s=interval_s)
        frame.monitor.start()
    if stall_timeout_s and stall_timeout_s > 0:
        frame.watchdog = StallWatchdog(float(stall_timeout_s))
        frame.watchdog.start()
    return frame


def uninstall(token) -> None:
    """Tear down `token`'s frame (monitor/watchdog stopped, previous
    frame restored). Out-of-order uninstalls restore the token's prev
    anyway — the same best-effort the observability teardown uses."""
    global _FRAME
    if token is None:
        return
    if token.monitor is not None:
        token.monitor.stop()
    if token.watchdog is not None:
        token.watchdog.stop()
    _FRAME = token.prev if token.prev is not None else _Frame(None, None)


def _dedupe_paths(paths) -> list[str]:
    """Watchable directories from a mixed path list: parents of
    files, existing dirs kept, deduped, order-preserving."""
    out: list[str] = []
    for p in paths or ():
        if not p:
            continue
        d = p if os.path.isdir(p) else (os.path.dirname(p) or ".")
        if d not in out:
            out.append(d)
    return out


# -- the degradation ladder -----------------------------------------------

def degraded(writer: str) -> bool:
    """Has `writer` been disabled by an earlier ENOSPC this run?
    Writers poll this before doing work so a degraded writer costs
    nothing (and cannot re-fail on every batch)."""
    return writer in _FRAME.degraded


def degraded_writers() -> dict[str, str]:
    """The current frame's degraded set (writer -> first failure
    detail) — for final-document meta and tests."""
    with _lock:
        return dict(_FRAME.degraded)


def degrade(writer: str, err: BaseException, path=None) -> None:
    """Disable an *optional* writer after an out-of-space failure:
    mark it degraded for the rest of the run, count
    ``writer_degraded_total`` (plain + ``{writer=}`` labeled — the
    warn alert rule reads the plain one), and log once. The caller
    swallows the error and keeps going; primary output is unaffected
    by construction (that is what *optional* means)."""
    detail = f"{err}" + (f" ({path})" if path else "")
    with _lock:
        first = writer not in _FRAME.degraded
        if first:
            _FRAME.degraded[writer] = detail
    reg = _registry()
    if reg is not None:
        from ..telemetry.registry import labeled
        reg.counter("writer_degraded_total").inc()
        reg.counter(labeled("writer_degraded_total",
                            writer=writer)).inc()
        if first:
            reg.event("writer_degraded", writer=writer, detail=detail)
    if first:
        print(f"quorum-tpu: out of space at optional writer "
              f"{writer}; disabled for the rest of the run "
              f"({detail})", file=sys.stderr)


def fail_required(writer: str, err: BaseException,
                  path=None) -> ResourceExhausted:
    """A *required* writer hit ENOSPC: record a ``disk_full`` event
    naming the writer (the driver will NOT retry this) and RETURN the
    ResourceExhausted for the caller to raise: ``raise
    fail_required(...) from err`` keeps the telemetry and the refusal
    in one place, the record_error idiom."""
    detail = (f"required writer {writer} out of space: {err}"
              + (f" ({path})" if path else ""))
    reg = _registry()
    if reg is not None:
        reg.event("disk_full", writer=writer, detail=detail)
    print(f"quorum-tpu: {detail}", file=sys.stderr)
    return ResourceExhausted(writer, detail)


@contextlib.contextmanager
def guard(writer: str, path=None):
    """THE ladder entry point: run a writer's body under its declared
    classification. ENOSPC/EDQUOT inside the body either degrades the
    writer (optional: swallowed — callers must tolerate the body not
    completing) or raises :class:`ResourceExhausted` (required). Every other exception passes through
    untouched — the ladder only ladders out-of-space."""
    if writer not in WRITERS:
        raise ValueError(f"undeclared writer {writer!r}: classify it "
                         "in utils/resources.WRITERS")
    try:
        yield
    except ResourceExhausted:
        raise  # already laddered by a nested guard
    except OSError as e:
        if not is_enospc(e):
            raise
        if WRITERS[writer] == REQUIRED:
            raise fail_required(writer, e, path=path) from e
        degrade(writer, e, path=path)


# -- preflight ------------------------------------------------------------

PREFLIGHT_MODES = ("strict", "warn", "off")

# Refuse only when the estimate plus this floor exceeds free space:
# estimates are deliberately rough, and a filesystem run to its last
# byte is an operational emergency regardless of what we write.
_PREFLIGHT_FLOOR_BYTES = 64 << 20


def preflight(mode: str, needs: dict[str, int]) -> None:
    """Check estimated artifact bytes against their target
    filesystems BEFORE work starts. `needs` maps a path (file or
    directory) to estimated bytes; needs on the same filesystem
    (st_dev) are summed. strict -> count ``preflight_refusals_total``
    and raise ResourceExhausted (rc DISK_FULL_RC: hours of compute
    cannot fit, fail in seconds); warn (the default) -> one stderr
    line per short filesystem; off -> nothing."""
    if mode not in PREFLIGHT_MODES:
        raise ValueError(f"--preflight must be one of "
                         f"{PREFLIGHT_MODES}, got {mode!r}")
    if mode == "off" or not needs:
        return
    by_dev: dict[int, tuple[str, int]] = {}
    for path, nbytes in needs.items():
        d = path if os.path.isdir(path) else (os.path.dirname(path)
                                              or ".")
        try:
            dev = os.stat(d).st_dev
        except OSError:
            continue  # the writer itself will fail loudly later
        name, total = by_dev.get(dev, (d, 0))
        by_dev[dev] = (name, total + int(nbytes))
    shortfalls: list[str] = []
    for _dev, (d, need) in sorted(by_dev.items()):
        try:
            free = shutil.disk_usage(d).free
        except OSError:
            continue
        if need + _PREFLIGHT_FLOOR_BYTES > free:
            shortfalls.append(
                f"{d}: ~{need >> 20} MiB needed, "
                f"{free >> 20} MiB free")
    if not shortfalls:
        return
    detail = ("estimated output exceeds free space: "
              + "; ".join(shortfalls))
    if mode == "warn":
        print(f"quorum-tpu: preflight warning: {detail} "
              "(--preflight=strict refuses; off silences)",
              file=sys.stderr)
        return
    reg = _registry()
    if reg is not None:
        reg.counter("preflight_refusals_total").inc()
        reg.event("preflight_refused", detail=detail)
    print(f"quorum-tpu: preflight refused: {detail}", file=sys.stderr)
    raise ResourceExhausted("preflight", f"preflight refused: {detail}")


def estimate_table_bytes(entries: int, mer_len: int, bits: int) -> int:
    """Rough on-disk bytes for an exported counting table of
    `entries` capacity: key plane (2 bits/base, 64-bit padded) +
    count plane (`bits` rounded up to bytes), plus header slack. The
    compact v5 payload is smaller; preflight errs high on purpose."""
    key_bytes = max(8, (2 * int(mer_len) + 63) // 64 * 8)
    val_bytes = max(1, (int(bits) + 7) // 8)
    return int(entries) * (key_bytes + val_bytes) + (1 << 20)


def estimate_stage1_needs(output: str, entries: int, mer_len: int,
                          bits: int, checkpoint_dir=None,
                          partitions: int = 1) -> dict[str, int]:
    """Stage-1 preflight estimate: the exported DB at the output
    path (partitioned builds stream shard files of the same total),
    plus ~2 retained table snapshots in the checkpoint dir."""
    table = estimate_table_bytes(entries, mer_len, bits)
    needs = {output: table}
    if checkpoint_dir:
        needs[checkpoint_dir] = needs.get(checkpoint_dir, 0) + 2 * table
    return needs


def estimate_stage2_needs(output: str, inputs) -> dict[str, int]:
    """Stage-2 preflight estimate: corrected FASTA + log run about
    1.2x the input FASTQ bytes (records shrink to FASTA but every
    read adds a log line); gzip inputs expand ~4x first."""
    total = 0
    for path in inputs or ():
        try:
            size = os.path.getsize(path)
        except OSError:
            continue
        total += size * 4 if str(path).endswith(".gz") else size
    return {output: int(total * 1.2)} if total else {}


# -- the monitor ticker ---------------------------------------------------

class ResourceMonitor:
    """The watermark ticker: publishes ``disk_free_bytes{path=}`` per
    watched filesystem, the scalar ``disk_free_bytes_min`` the
    standing alert rules read (threshold rules address exact metric
    names, not label families), and ``host_rss_bytes``. Ticks
    synchronously once at start so even a run shorter than one period
    carries the gauges, then on a daemon thread."""

    def __init__(self, reg, paths: list[str],
                 interval_s: float = 5.0):
        self.reg = reg
        self.paths = list(paths)
        self.interval_s = max(0.5, float(interval_s))
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> None:
        self.tick()
        self._thread = threading.Thread(
            target=self._loop, name="resource-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self.tick()  # final sample so the document reflects run end

    def tick(self) -> None:
        from ..telemetry.registry import labeled
        reg = self.reg
        low = None
        for p in self.paths:
            try:
                free = shutil.disk_usage(p).free
            except OSError:
                continue  # an unlinked watch dir: nothing to report
            reg.gauge(labeled("disk_free_bytes", path=p)).set(free)
            low = free if low is None else min(low, free)
        if low is not None:
            reg.gauge("disk_free_bytes_min").set(low)
        rss = host_rss_bytes()
        if rss:
            reg.gauge("host_rss_bytes").set(rss)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - never kill the ticker
                # a broken sampler must be visible, not silent
                try:
                    self.reg.counter(
                        "resource_monitor_errors_total").inc()
                except Exception:  # noqa: BLE001
                    pass


def host_rss_bytes() -> int:
    """Current resident set in bytes: /proc/self/status VmRSS where
    available (Linux), else getrusage peak — 0 when neither works
    (the gauge is simply absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001 - platform without rusage
        return 0


# -- the offline stall watchdog -------------------------------------------

def watchdog_beat(site: str, cursor) -> None:
    """The stage loops' per-batch liveness signal: records (site,
    cursor, now, thread) on the active watchdog. A no-op (one global
    load, one None check) without ``--stall-timeout-s`` — same
    disabled-cost discipline as faults.inject."""
    w = _FRAME.watchdog
    if w is not None:
        w.beat(site, cursor)


class StallWatchdog:
    """Monitors the batch cursor the stage loops beat. A cursor that
    stops advancing for `timeout_s` gets a ``stall`` event,
    ``stall_aborts_total``, and the two-stage abort: a
    StallError asynchronously raised into the beating thread (the
    stage error path maps it to the retryable STALL_RC), then — if
    the thread never unwinds (wedged in native code, where async
    exceptions cannot be delivered) — ``os._exit(STALL_RC)`` after
    one more timeout period, still retryable from outside."""

    def __init__(self, timeout_s: float, check_s: float | None = None):
        self.timeout_s = float(timeout_s)
        self.check_s = check_s if check_s is not None else max(
            0.05, min(1.0, self.timeout_s / 4.0))
        self._stop = threading.Event()
        self._thread = None
        with _lock:
            self._site = None
            self._cursor = None
            self._last = time.monotonic()
            self._tid = None
            self._soft_aborted_at = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="stall-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    def beat(self, site: str, cursor) -> None:
        with _lock:
            self._site = site
            self._cursor = cursor
            self._last = time.monotonic()
            self._tid = threading.get_ident()
            self._soft_aborted_at = None

    def _loop(self) -> None:
        while not self._stop.wait(self.check_s):
            try:
                self._check()
            except Exception:  # noqa: BLE001 - never kill the watchdog
                try:
                    reg = _registry()
                    if reg is not None:
                        reg.counter(
                            "resource_monitor_errors_total").inc()
                except Exception:  # noqa: BLE001
                    pass

    def _check(self) -> None:
        now = time.monotonic()
        with _lock:
            site, cursor, tid = self._site, self._cursor, self._tid
            elapsed = now - self._last
            soft_at = self._soft_aborted_at
            if site is None or tid is None:
                return  # never armed: no loop has beaten yet
            if elapsed <= self.timeout_s:
                return
            if soft_at is None:
                self._soft_aborted_at = now
        if soft_at is None:
            self._soft_abort(site, cursor, tid, elapsed)
        elif now - soft_at > self.timeout_s:
            self._hard_abort(site, cursor, elapsed)

    def _soft_abort(self, site, cursor, tid, elapsed) -> None:
        detail = (f"no progress at {site} for {elapsed:.1f}s "
                  f"(cursor {cursor}, --stall-timeout-s "
                  f"{self.timeout_s:g})")
        reg = _registry()
        if reg is not None:
            reg.counter("stall_aborts_total").inc()
            reg.event("stall", site=site, detail=detail)
        print(f"quorum-tpu: stall watchdog: {detail}; aborting the "
              f"stalled step (retryable rc {STALL_RC})",
              file=sys.stderr)
        _async_raise(tid, StallError)

    def _hard_abort(self, site, cursor, elapsed) -> None:
        # the stalled thread never unwound: it is wedged below the
        # interpreter where async exceptions cannot land. Exit hard —
        # the rc is still retryable, resume picks up from checkpoint.
        print(f"quorum-tpu: stall watchdog: {site} still wedged "
              f"{elapsed:.1f}s after soft abort (cursor {cursor}); "
              f"hard exit {STALL_RC}", file=sys.stderr)
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:  # noqa: BLE001 - nothing may stop the exit
            pass
        os._exit(STALL_RC)


def _async_raise(tid: int, exc_type) -> bool:
    """Raise `exc_type` in the thread with ident `tid` at its next
    bytecode boundary (CPython PyThreadState_SetAsyncExc). Returns
    False where unavailable — the hard abort still covers it."""
    try:
        import ctypes
        n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(tid), ctypes.py_object(exc_type))
        if n > 1:  # "we just broke the interpreter" escape hatch
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid), None)
            return False
        return n == 1
    except Exception:  # noqa: BLE001 - non-CPython fallback
        return False
