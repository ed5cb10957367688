"""Deterministic fault injection (counterpart of quorum_tpu/utils/faults.py,
the whole module): the chaos harness behind crash safety.

A *fault plan* (JSON from ``--fault-plan`` or the ``QUORUM_FAULT_PLAN``
environment variable) names injection sites the hot paths carry and
the action to take when execution reaches them, at an exact batch,
every time. The plan format and the site names are the JAX package's,
so one plan drives either package.

Plan format (a JSON list; a single object or ``{"faults": [...]}``
also accepted)::

    [
      {"site": "stage2.correct", "batch": 2, "action": "exit",
       "code": 41},
      {"site": "fastq.read", "at": 100, "action": "io_error"},
      {"site": "stage1.insert@batch=1", "action": "sleep",
       "seconds": 0.2}
    ]

Fields per spec:

* ``site`` (required): the injection-point name. The shorthand
  ``site@batch=N`` folds the ``batch`` field in.
* ``batch``: match only calls tagged with this batch index (the
  per-batch device loops pass ``batch=``).
* ``at``: fire on the Nth *matching* call (1-based, default 1).
* ``count``: how many consecutive matching calls fire (default 1;
  ``-1`` = every one from ``at`` on).
* ``action``: one of
  - ``io_error``: raise OSError; with ``errno`` set,
    ``OSError(errno, message)``, so the resource ladder's ENOSPC
    handling sees the failure a real filesystem would give,
  - ``diskfull``: every matching call charges the just-committed
    file's size (1 byte at path-less sites) against a ``bytes``
    budget; past it the call raises ``OSError(ENOSPC)`` and keeps
    raising. Scope it with ``path_prefix``; combine with
    ``count: -1``,
  - ``error``: raise FaultError (a RuntimeError),
  - ``exit``: ``os._exit(code)`` (default 41), a hard kill,
  - ``sleep``: ``time.sleep(seconds)`` (default 0.05), then go on,
  - ``hang``: block until released (``release_hangs()``, or another
    plan installed or the plan reset), so no test leaks a stuck
    thread; the blocked thread still runs Python code every 50 ms,
    so the stall watchdog's soft abort reaches it,
  - ``corrupt``: flip (XOR 0xFF) or zero ``bytes`` bytes of the file
    the site just committed, at ``offset`` or a seeded offset.
* ``message`` / ``code`` / ``seconds`` / ``errno``: action parameters.
* ``bytes`` / ``mode`` (``flip``/``zero``) / ``offset`` / ``seed``:
  ``corrupt`` parameters (``bytes`` is also the ``diskfull`` budget).
* ``path_prefix``: match only calls whose ``path=`` starts with it.

Sites (SITES below, one ``faults.inject(...)`` call each; the disabled
cost is one module-global None check). The serve, ingest, epoch,
flight and fleet sites keep the JAX package's entries but fire only
once their machinery is ported (ROADMAP Queue 1 items 7-10): the
correction server (serve.engine.step, serve.admit, serve.reload),
live ingest (serve.ingest, serve.epoch), the multi-host fleet
(fleet.exchange) and the flight recorder (flight.dump).

Determinism: per-spec hit counters under one lock; the same plan over
the same input fires at exactly the same points, which is what lets a
test kill stage 2 at batch 2 and hold the resumed output to an
uninterrupted run's bytes.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from . import levers


class FaultError(RuntimeError):
    """An injected non-IO failure (action "error"): a RuntimeError so
    the stages' existing error contracts catch it like a real
    device-step failure."""


# The declared site catalog, the JAX package's entries: where each site
# fires, and which optional kwargs (batch=/path=) its calls carry
# (module paths name the JAX package's modules; the port's are the
# same files under quorum_tpu_torch/). tests/test_torch_faults.py holds
# it to the JAX catalog and checks that every site the port fires is
# declared here.
SITES: dict[str, str] = {
    "stage1.insert": "before each stage-1 device insert "
                     "(models/create_database.py); carries batch=",
    "stage2.correct": "before each stage-2 device step "
                      "(models/error_correct.py); carries batch=",
    "serve.engine.step": "top of CorrectionEngine.step "
                         "(serve/engine.py); hang is contained by "
                         "the --step-timeout-ms watchdog",
    "serve.admit": "HTTP admission, before quota/queue checks "
                   "(serve/server.py); errors map to retryable 503",
    "serve.reload": "inside POST /reload between validation and the "
                    "engine swap (serve/server.py); must roll back",
    "serve.ingest": "per accepted ingest chunk, before its device "
                    "insert (serve/ingest.py); carries batch= (the "
                    "chunk seq — an exit here is the live "
                    "kill→resume test)",
    "serve.epoch": "between an epoch snapshot's export and the "
                   "engine swap (serve/ingest.py); must roll back "
                   "to the serving epoch",
    "fastq.read": "per parsed record in both FASTQ parsers "
                  "(io/fastq.py, native/binding.py)",
    "db.write": "after a database export commits "
                "(io/db_format._atomic_db_write); carries path=",
    "checkpoint.commit": "after each stage-1 snapshot / shard "
                         "payload / manifest / live-table snapshot "
                         "commits (io/checkpoint.py, "
                         "serve/live_table.py); carries path=",
    "journal.append": "after each stage-2 resume-journal commit "
                      "(io/checkpoint.Stage2Journal); carries path=",
    "partition.commit": "after each partition-pass cursor commit of a "
                        "--partitions build "
                        "(io/checkpoint.Stage1PartitionCursor); "
                        "carries path=",
    "flight.dump": "after a flight-recorder crash dump commits "
                   "(telemetry/flight.FlightRecorder.dump); carries "
                   "path=",
    "quarantine.write": "before each quarantine-stream append "
                        "(io/fastq.BadReadPolicy); carries path= — "
                        "an ENOSPC here must degrade the optional "
                        "quarantine writer, never kill the run",
    "writer.stream": "before each AsyncWriter write to an output "
                     "stream (utils/pipeline.AsyncWriter); carries "
                     "batch= (the stream index) and path= — an "
                     "errno=28 io_error here is the required-output "
                     "ENOSPC fail-fast case",
    "fleet.exchange": "before each multi-host fleet KV exchange "
                      "(parallel/fleet.exchange_bytes); carries "
                      "batch= (the per-tag epoch) — an exit here is "
                      "the kill-one-host fleet resume test",
}

_ACTIONS = ("io_error", "error", "exit", "sleep", "hang", "corrupt",
            "diskfull")

_CORRUPT_MODES = ("flip", "zero")

ENV_VAR = "QUORUM_FAULT_PLAN"

DEFAULT_EXIT_CODE = 41


class FaultSpec:
    """One parsed fault: where, when, and what."""

    __slots__ = ("site", "batch", "at", "count", "action", "message",
                 "code", "seconds", "nbytes", "mode", "offset", "seed",
                 "errno", "path_prefix", "hits", "fired", "charged")

    def __init__(self, raw: dict):
        if not isinstance(raw, dict):
            raise ValueError(f"fault spec must be an object, got {raw!r}")
        site = raw.get("site")
        if not site or not isinstance(site, str):
            raise ValueError(f"fault spec needs a 'site': {raw!r}")
        batch = raw.get("batch")
        if "@" in site:
            # "stage1.insert@batch=3" shorthand
            site, _, tail = site.partition("@")
            key, _, val = tail.partition("=")
            if key != "batch" or not val.lstrip("-").isdigit():
                raise ValueError(
                    f"bad site shorthand {raw.get('site')!r} "
                    "(want site@batch=N)")
            batch = int(val)
        self.site = site
        self.batch = None if batch is None else int(batch)
        self.at = int(raw.get("at", 1))
        if self.at < 1:
            raise ValueError(f"'at' must be >= 1: {raw!r}")
        self.count = int(raw.get("count", 1))
        self.action = raw.get("action", "error")
        if self.action not in _ACTIONS:
            raise ValueError(
                f"unknown action {self.action!r} (one of {_ACTIONS})")
        self.message = raw.get("message")
        self.code = int(raw.get("code", DEFAULT_EXIT_CODE))
        self.seconds = float(raw.get("seconds", 0.05))
        err = raw.get("errno")
        self.errno = None if err is None else int(err)
        if self.errno is not None and self.errno < 1:
            raise ValueError(f"'errno' must be >= 1: {raw!r}")
        prefix = raw.get("path_prefix")
        if prefix is not None and (not prefix
                                   or not isinstance(prefix, str)):
            raise ValueError(
                f"'path_prefix' must be a non-empty string: {raw!r}")
        self.path_prefix = prefix
        # corrupt-action parameters; `bytes` doubles as the diskfull
        # budget, where 0 = "already full"
        self.nbytes = int(raw.get("bytes",
                                  0 if self.action == "diskfull" else 1))
        if self.nbytes < (0 if self.action == "diskfull" else 1):
            raise ValueError(f"'bytes' must be >= 1: {raw!r}")
        self.mode = raw.get("mode", "flip")
        if self.mode not in _CORRUPT_MODES:
            raise ValueError(
                f"unknown corrupt mode {self.mode!r} "
                f"(one of {_CORRUPT_MODES})")
        off = raw.get("offset")
        self.offset = None if off is None else int(off)
        self.seed = int(raw.get("seed", 0))
        self.hits = 0     # matching calls seen
        self.fired = 0    # actions taken
        self.charged = 0  # diskfull bytes charged so far

    def matches(self, site: str, batch, path=None) -> bool:
        if site != self.site:
            return False
        if self.path_prefix is not None and (
                path is None
                or not str(path).startswith(self.path_prefix)):
            return False
        return self.batch is None or (batch is not None
                                      and int(batch) == self.batch)

    def should_fire(self) -> bool:
        """Call after incrementing hits: fire on hits in
        [at, at + count), unbounded when count < 0."""
        if self.hits < self.at:
            return False
        return self.count < 0 or self.fired < self.count

    def describe(self) -> str:
        where = (f"{self.site}@batch={self.batch}"
                 if self.batch is not None else self.site)
        return f"{self.action} at {where} (at={self.at}, count={self.count})"


class FaultPlan:
    """A parsed, thread-safe fault plan."""

    def __init__(self, specs: list[FaultSpec]):
        self.specs = specs
        self._lock = threading.Lock()
        # "hang" actions block on this event: set it (release_hangs,
        # or installing/resetting the plan) and every hung thread
        # resumes — interruptible sleep-forever, not a thread leak
        self._hang_release = threading.Event()

    @classmethod
    def parse(cls, obj) -> "FaultPlan":
        """From the JSON-decoded plan value: a list of specs, one
        spec, or {"faults": [...]}."""
        if isinstance(obj, dict) and "faults" in obj:
            obj = obj["faults"]
        if isinstance(obj, dict):
            obj = [obj]
        if not isinstance(obj, list):
            raise ValueError(
                f"fault plan must be a list of specs, got {type(obj)}")
        return cls([FaultSpec(raw) for raw in obj])

    def fire(self, site: str, batch=None, path=None) -> None:
        """Record one arrival at `site`; execute any due action.
        Raising actions raise from here; `sleep` returns after the
        delay; `corrupt` damages `path` (the file the site just
        committed) and returns."""
        due: list[FaultSpec] = []
        with self._lock:
            for spec in self.specs:
                if not spec.matches(site, batch, path):
                    continue
                spec.hits += 1
                if spec.should_fire():
                    spec.fired += 1
                    if spec.action == "diskfull":
                        # charge under the lock: the cumulative byte
                        # ledger is shared state, and the charge
                        # sequence IS the determinism contract
                        spec.charged += _charge_bytes(path)
                    due.append(spec)
        for spec in due:
            self._act(spec, site, batch, path)

    def release_hangs(self) -> None:
        """Wake every thread blocked in a `hang` action. After this,
        further `hang` actions on THIS plan return immediately — a
        released plan stays released."""
        self._hang_release.set()

    def _act(self, spec: FaultSpec, site: str, batch, path=None) -> None:
        where = site if batch is None else f"{site}@batch={batch}"
        msg = spec.message or f"injected fault at {where}"
        if spec.action == "sleep":
            time.sleep(spec.seconds)
            return
        if spec.action == "corrupt":
            _corrupt_file(spec, site, path)
            return
        if spec.action == "hang":
            # a wedged step: block until released (new plan install,
            # reset(), or release_hangs()), then continue. The wait
            # wakes every 50 ms so that the thread runs bytecode and
            # the stall watchdog's soft abort (an exception raised
            # into it) lands: a stall of Python code, not of the card
            while not self._hang_release.wait(0.05):
                pass
            return
        if spec.action == "io_error":
            if spec.errno is not None:
                raise OSError(spec.errno, msg)
            raise OSError(msg)
        if spec.action == "diskfull":
            # the budget holds the first `bytes` bytes; past it, every
            # matching write fails ENOSPC — full disks stay full
            if spec.charged > spec.nbytes:
                import errno as _errno
                raise OSError(
                    _errno.ENOSPC,
                    f"{msg} (diskfull: {spec.charged} bytes charged "
                    f"> {spec.nbytes} budget)")
            return
        if spec.action == "error":
            raise FaultError(msg)
        # exit: a hard kill — no cleanup, no atexit, no finally blocks;
        # exactly what checkpoint/resume must survive. Flush the std
        # streams so the operator sees where the kill landed.
        print(f"quorum-tpu: fault plan: hard exit ({spec.code}) at "
              f"{where}", file=sys.stderr)
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:  # noqa: BLE001 - nothing may stop the exit
            pass
        os._exit(spec.code)

    def summary(self) -> str:
        return "; ".join(s.describe() for s in self.specs) or "(empty)"


def _charge_bytes(path) -> int:
    """What one firing `diskfull` call costs: the size of the file the
    site just committed, or 1 byte at path-less sites (stream writes)
    — so a budget of 0 is "already full" and N bytes of real artifact
    traffic exhaust an N-byte budget deterministically."""
    if path is None:
        return 1
    try:
        return max(1, os.path.getsize(path))
    except OSError:
        return 1


def _corrupt_file(spec: FaultSpec, site: str, path) -> None:
    """The `corrupt` action: flip/zero `spec.nbytes` bytes of `path`
    in place (fsync'd, so the damage is really on disk — exactly what
    bit rot or a torn sector leaves). The offset is explicit or
    seeded-deterministic per (seed, site, firing index); an explicit
    offset past EOF is clamped to the last byte."""
    if path is None:
        raise FaultError(
            f"corrupt action fired at site {site!r}, which passes no "
            "file path — corrupt is only meaningful at artifact-"
            "commit sites (db.write, checkpoint.commit, "
            "journal.append)")
    size = os.path.getsize(path)
    if size == 0:
        return
    if spec.offset is not None:
        off = min(spec.offset, size - 1)
    else:
        import random
        off = random.Random(
            f"{spec.seed}:{site}:{spec.fired}").randrange(size)
    n = max(1, min(spec.nbytes, size - off))
    with open(path, "r+b") as f:
        f.seek(off)
        cur = f.read(n)
        f.seek(off)
        if spec.mode == "zero":
            f.write(b"\0" * len(cur))
        else:
            f.write(bytes(b ^ 0xFF for b in cur))
        f.flush()
        os.fsync(f.fileno())
    print(f"quorum-tpu: fault plan: corrupted {n} byte(s) of {path} "
          f"at offset {off} ({spec.mode}, site {site})",
          file=sys.stderr)


# -- module-global install point ------------------------------------------
# The hot paths guard on `_PLAN is None`, so the disabled cost of an
# injection point is one function call and one global load. _SPEC
# remembers the exact string that produced the installed plan: a
# stage entry point re-reading the SAME env var / arg must keep the
# running plan (and its spent hit counters), not reset it.
_PLAN: FaultPlan | None = None
_SPEC: str | None = None


def install(plan: FaultPlan | None, spec: str | None = None) -> None:
    global _PLAN, _SPEC
    if _PLAN is not None and _PLAN is not plan:
        # threads hung by the outgoing plan must not outlive it
        _PLAN.release_hangs()
    _PLAN = plan
    _SPEC = spec


def reset() -> None:
    install(None)


def release_hangs() -> None:
    """Wake any threads blocked in the active plan's `hang` actions
    (teardown hook for tests and the chaos soak)."""
    if _PLAN is not None:
        _PLAN.release_hangs()


def active() -> bool:
    return _PLAN is not None


def inject(site: str, batch=None, path=None) -> None:
    """THE injection point. No-op (one global check) without a plan.
    Artifact-commit sites pass `path` (the file just committed) so
    `corrupt` actions can damage it in place."""
    if _PLAN is None:
        return
    _PLAN.fire(site, batch, path)


def load_plan(spec: str) -> FaultPlan:
    """Parse a plan argument: inline JSON text, `@/path/to/plan.json`,
    or a bare path to an existing file."""
    text = spec
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            text = f.read()
    elif not spec.lstrip().startswith(("[", "{")) and os.path.exists(spec):
        with open(spec) as f:
            text = f.read()
    try:
        obj = json.loads(text)
    except ValueError as e:
        raise ValueError(f"bad fault plan {spec!r}: {e}") from None
    return FaultPlan.parse(obj)


def setup(arg: str | None = None) -> FaultPlan | None:
    """Install the plan from `--fault-plan` (or, when absent, the
    QUORUM_FAULT_PLAN env var — how a subprocess under test gets its
    plan). Called by every CLI entry point.

    With neither source set this is a NO-OP, not a reset: the quorum
    driver installs ONE plan for the whole run and its in-process
    stage children must inherit it — including the per-spec hit/fired
    counters, which is what makes a driver retry deterministic (a
    count=1 fault fires on attempt 1 and stays spent on attempt 2).
    An EXPLICIT empty value (``--fault-plan ''`` or an empty env var)
    clears any installed plan; tests use `faults.reset()`."""
    spec = arg if arg is not None else levers.raw(ENV_VAR)
    if spec is None:
        return _PLAN
    if not spec:
        reset()
        return None
    if spec == _SPEC and _PLAN is not None:
        # same plan text as the one already running (the driver's env
        # var seen again by an in-process stage entry): keep the live
        # plan — reinstalling would resurrect spent count=1 faults on
        # every retry attempt
        return _PLAN
    plan = load_plan(spec)
    install(plan, spec)
    from .vlog import vlog
    vlog("Fault plan installed: ", plan.summary())
    return plan


def add_fault_args(p) -> None:
    """The shared `--fault-plan` CLI flag (every entry point carries
    it; the QUORUM_FAULT_PLAN env var is the fallback so plans reach
    subprocesses too)."""
    p.add_argument("--fault-plan", metavar="json|@file", default=None,
                   help="Deterministic fault-injection plan (JSON, "
                        "@file, or path): inject IO errors, device-"
                        "step failures, slowness, or a hard process "
                        "exit at named sites (utils/faults.py). Env "
                        f"fallback: {ENV_VAR}.")
