"""Dynamic batching (counterpart of quorum_tpu/serve/batcher.py): a
bounded request queue feeding one dispatcher thread that coalesces small
requests into full device batches.

The device is efficient at `--max-batch` reads per step and terrible
at one; the batcher closes that gap the way inference servers do.
`submit()` enqueues a request (a list of FASTQ records + a Future)
under admission control — a full queue raises `QueueFull`, which the
HTTP front end maps to 429 + Retry-After, so overload sheds at the
door instead of growing an unbounded backlog (the bounded
jflib::pool discipline of the reference, applied to requests). The
dispatcher pops the queue, waits up to `max_wait_ms` for more work to
coalesce (first-request arrival starts the clock), drops requests
whose deadline already passed, packs up to `max_batch` reads into one
engine step, and demuxes each request's slice of the results back
through its Future.

Priority lanes: requests are admitted into one of two FIFO
lanes — `interactive` or `bulk` (the `X-Quorum-Priority` header at
the HTTP layer). The dispatcher pops them with a weighted scheme:
when both lanes hold work, `interactive_weight` interactive pops are
taken for every bulk pop, so a bulk backlog cannot starve interactive
traffic while bulk still drains at a guaranteed floor. One capacity
bound (`queue_requests`) covers both lanes.

Telemetry mirrors the host pipeline's vocabulary: a `queue_depth`
high-water gauge (set_max), a `queue_wait_us` histogram
(admission -> dispatch), `batch_reads` + the dispatch/wait split from
the engine, and request outcome counters
(`requests_accepted/_rejected_queue_full/_deadline_exceeded/_failed`
/`_completed`).

Fault containment:

* A device-step exception fails ONLY that batch's futures (the HTTP
  layer maps them to 500) while the dispatcher keeps running.
* A failed multi-request batch is bisect-retried once
  (`batch_bisections`); a half that fails AGAIN with more than one
  request aboard is *hedged* — its requests re-run solo, bounded by
  `max_hedges` per failed batch (`hedges_total`), so an innocent
  batchmate never eats a 500 for a poisoned neighbor and its answer
  stays byte-identical to the offline CLI.
* The engine-step **watchdog** (`step_timeout_ms`): each device step
  runs under a monitor thread; a step that exceeds the budget — a
  wedged compile or hung device — is abandoned (`EngineStepTimeout`
  fails only that batch), and the dispatcher rebuilds a warm engine
  through `engine_factory` (DB reload + per-bucket recompile,
  `engine_restarts_total`) instead of wedging the process forever.
* After `max_consecutive_failures` engine-step failures in a row the
  batcher reports unhealthy and `/healthz` answers 503, so a load
  balancer ejects the replica (`engine_step_failures`,
  `consecutive_failures`); any success heals the streak.
* ANY dispatcher exit path — clean drain or a bug in the dispatch
  loop itself — fails every queued future immediately instead of
  stranding clients until their deadline.

Engine swaps (`swap_engine`) are how both the watchdog restart and
the server's hot `POST /reload` take effect: the dispatcher captures
the engine once per step attempt, so a batch already on the device
finishes on the OLD engine while every later step uses the new one;
the `engine_generation` gauge stamps which generation is serving.

Threads and the card: the dispatcher thread runs each engine step, or
with a watchdog the step runs on a `quorum-serve-step` thread and a
rebuild on a `quorum-serve-rebuild` thread, so kernels launch off the
main thread (kernels/loader.py serializes the library load and the
launch counts; the engine enters its own device in each step).

The JAX package seals a flight-recorder dump where the dispatcher dies
and where the watchdog abandons a step; the port has no flight recorder
yet (ROADMAP Queue 1 item 10), so those two places print a vlog line and
count (`dispatcher_crashes`, `engine_step_timeouts`) without a dump.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future

from ..telemetry import NULL, labeled
from ..utils.vlog import vlog

PRIORITIES = ("interactive", "bulk")


class QueueFull(Exception):
    """Admission refused: the request queue is at capacity. The HTTP
    layer maps this to 429 with `retry_after` seconds."""

    def __init__(self, retry_after: float = 1.0):
        super().__init__("request queue full")
        self.retry_after = retry_after


class Draining(Exception):
    """Admission refused: the server is quiescing (503)."""


class DeadlineExceeded(Exception):
    """The request's deadline passed before its batch dispatched
    (504)."""


class EngineStepTimeout(RuntimeError):
    """The watchdog abandoned a device step that exceeded
    `step_timeout_ms` (the HTTP layer maps it to 500; the engine is
    rebuilt underneath)."""


def _deliver_exception(fut: Future, err: BaseException) -> bool:
    """Fail a future that may or may not already be running/resolved
    (the watchdog paths can race a normal resolution): True if this
    call delivered the exception."""
    try:
        if not fut.set_running_or_notify_cancel():
            return False  # cancelled by an abandoned waiter
    except RuntimeError:
        pass  # already marked running
    try:
        fut.set_exception(err)
        return True
    except Exception:
        return False  # already resolved


class _Request:
    """One admitted request plus its phase ledger: the
    dispatcher thread stamps lane wait at pop and accumulates device /
    hedge step time per attempt; the HTTP layer reads the ledger off
    the Future (`fut.request`) to build the response's
    `X-Quorum-Phases` header and the request lifecycle event. Only
    the dispatcher thread writes the phase fields after admission."""

    __slots__ = ("records", "future", "t_enq", "deadline", "rid",
                 "lane", "lane_wait_us", "device_us", "hedge_us",
                 "bisected", "hedged")

    def __init__(self, records, future, deadline, rid=None,
                 lane="interactive"):
        self.records = records
        self.future = future
        self.t_enq = time.perf_counter()
        self.deadline = deadline  # absolute perf_counter, or None
        self.rid = rid            # X-Quorum-Request-Id (or None)
        self.lane = lane
        self.lane_wait_us = 0     # admission -> dispatch pop
        self.device_us = 0        # engine step time (incl. bisect)
        self.hedge_us = 0         # solo re-run time after a bisect
        self.bisected = False
        self.hedged = False


class DynamicBatcher:
    """One dispatcher thread over two bounded priority lanes.

    `max_batch` is also the engine's fixed row capacity; requests
    larger than `max_batch` reads are corrected across several device
    steps within one dispatch (their Future still resolves once, with
    the full result). `queue_requests` bounds ADMITTED requests not
    yet dispatched, across both lanes — in-flight device work doesn't
    count against it.
    """

    def __init__(self, engine, max_batch: int | None = None,
                 max_wait_ms: float = 5.0, queue_requests: int = 64,
                 max_consecutive_failures: int = 0,
                 step_timeout_ms: float | None = None,
                 engine_factory=None, max_hedges: int = 8,
                 interactive_weight: int = 4,
                 registry=NULL):
        self.engine = engine
        self.max_batch = int(max_batch or engine.rows)
        if self.max_batch > engine.rows:
            raise ValueError(
                f"max_batch {self.max_batch} exceeds engine rows "
                f"{engine.rows}")
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self.queue_requests = int(queue_requests)
        # 0 = never flip unhealthy (the CLI default is 5)
        self.max_consecutive_failures = int(max_consecutive_failures)
        self.step_timeout_s = (float(step_timeout_ms) / 1000.0
                               if step_timeout_ms else None)
        # the watchdog's rebuild gets its own (larger) budget: DB
        # reload + per-bucket recompile is legitimately slower than
        # one step, but a wedged rebuild must not re-wedge the
        # dispatcher (tests shrink this)
        self.rebuild_timeout_s = (max(4 * self.step_timeout_s, 60.0)
                                  if self.step_timeout_s else None)
        # called as engine_factory(hung_engine) after a watchdog fire;
        # must return a fresh warm engine (the CLI rebuilds from the
        # same flags and re-pays the hung engine's length buckets)
        self.engine_factory = engine_factory
        self.max_hedges = max(0, int(max_hedges))
        self.interactive_weight = max(1, int(interactive_weight))
        self.registry = registry
        self._lanes: dict[str, collections.deque[_Request]] = {
            p: collections.deque() for p in PRIORITIES}
        self._pop_seq = 0
        self._generation = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._draining = False
        self._closed = False
        self._dead = False  # dispatcher exited (drain or death)
        # the batch the dispatcher is running RIGHT NOW (empty between
        # steps): drain forensics read it for meta.drained_ids
        self._inflight: list[_Request] = []
        self._consecutive_failures = 0
        # feature counters exist from setup (value 0 counts): a serve
        # metrics document must show the watchdog/hedging surface even
        # before the first fault (tools/metrics_check.py requires the
        # names when meta declares the feature)
        if self.max_hedges > 0:
            registry.counter("hedges_total")
        if self.step_timeout_s is not None:
            registry.counter("engine_restarts_total")
            registry.counter("engine_step_timeouts")
        # per-lane depth/wait series: the summed
        # `queue_depth` gauge stays for dashboard compatibility, but
        # one number over two lanes hides interactive starvation —
        # these exist from setup so a zero-traffic lane still shows
        for p in PRIORITIES:
            registry.gauge(labeled("queue_depth", lane=p))
            registry.histogram(labeled("lane_wait_us", lane=p))
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="quorum-serve-dispatch",
                                        daemon=True)
        self._thread.start()

    # -- admission --------------------------------------------------------
    def submit(self, records, deadline_s: float | None = None,
               priority: str = "interactive",
               request_id: str | None = None) -> Future:
        """Enqueue one request (list of (header, seq, qual) records)
        into the `priority` lane. Returns a Future resolving to the
        per-read (fa, log) list, with the request's phase ledger
        attached as `fut.request` (the HTTP layer reads it for the
        response's phase header + lifecycle event). Raises QueueFull
        (429) or Draining (503) at admission; an expired deadline
        resolves the Future with DeadlineExceeded. `request_id` is
        the X-Quorum-Request-Id threaded through hedge/bisect
        telemetry."""
        if priority not in self._lanes:
            raise ValueError(f"unknown priority {priority!r} "
                             f"(one of {PRIORITIES})")
        fut: Future = Future()
        deadline = (time.perf_counter() + deadline_s
                    if deadline_s is not None else None)
        req = _Request(list(records), fut, deadline, rid=request_id,
                       lane=priority)
        fut.request = req
        reg = self.registry
        with self._lock:
            if self._draining or self._dead:
                reg.counter("requests_rejected_draining").inc()
                raise Draining()
            if self._qlen_locked() >= self.queue_requests:
                reg.counter("requests_rejected_queue_full").inc()
                raise QueueFull(retry_after=self._retry_after_locked())
            reg.counter("requests_accepted").inc()
            if req.records:
                self._lanes[priority].append(req)
                reg.gauge("queue_depth").set_max(self._qlen_locked())
                reg.gauge(labeled("queue_depth", lane=priority)) \
                    .set_max(len(self._lanes[priority]))
                self._work.notify()
        if not req.records:
            # nothing to correct: resolve immediately (never
            # enqueued), but AFTER admission control so an empty
            # probe still honors drain and backpressure; completed
            # here so accepted == completed + failed + deadline holds
            reg.counter("requests_completed").inc()
            fut.set_result([])
        return fut

    def _retry_after_locked(self) -> float:
        """Suggested Retry-After: one full queue's worth of batches at
        the coalescing wait, floored at 1 s. Deliberately coarse — the
        point is a hint that backs clients off, not a promise."""
        batches = max(1, self.queue_requests)
        return max(1.0, round(batches * self.max_wait_s, 1))

    def _qlen_locked(self) -> int:
        return sum(len(q) for q in self._lanes.values())

    def _reads_locked(self) -> int:
        return sum(len(r.records) for q in self._lanes.values()
                   for r in q)

    def _first_enq_locked(self) -> float:
        return min(q[0].t_enq for q in self._lanes.values() if q)

    @property
    def depth(self) -> int:
        with self._lock:
            return self._qlen_locked()

    # -- engine swap ------------------------------------------------------
    def current_engine(self):
        with self._lock:
            return self.engine

    @property
    def generation(self) -> int:
        """How many engine swaps (watchdog restarts + hot reloads)
        this batcher has served across; 0 = the boot engine."""
        with self._lock:
            return self._generation

    def swap_engine(self, new_engine,
                    expected_generation: int | None = None) -> int:
        """Atomically install `new_engine` for every step dispatched
        from now on; a step already in flight finishes on the old
        engine (the dispatcher captured its reference). Returns the
        new generation number (also the `engine_generation` gauge).

        `expected_generation` makes the swap conditional: if another
        swap landed since the caller captured that generation, this
        one is dropped and -1 returned — the watchdog's rebuild uses
        it so a concurrent /reload's fresher engine is never
        clobbered by a stale-config replacement."""
        rows = int(getattr(new_engine, "rows", self.max_batch))
        if rows < self.max_batch:
            raise ValueError(
                f"replacement engine rows {rows} below max_batch "
                f"{self.max_batch}")
        with self._lock:
            if (expected_generation is not None
                    and self._generation != expected_generation):
                return -1
            self.engine = new_engine
            self._generation += 1
            gen = self._generation
        self.registry.gauge("engine_generation").set(gen)
        return gen

    # -- health -----------------------------------------------------------
    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive_failures

    @property
    def healthy(self) -> bool:
        """False once the dispatcher is gone or
        `max_consecutive_failures` engine steps failed in a row —
        the `/healthz` 503 signal load balancers eject on."""
        with self._lock:
            if self._dead:
                return False
            return (self.max_consecutive_failures <= 0
                    or self._consecutive_failures
                    < self.max_consecutive_failures)

    def pending_rids(self) -> list[str]:
        """Request ids admitted but not yet resolved — the batch on
        the device right now plus both lane backlogs, in dispatch
        order. The server's drain path stamps this as
        `meta.drained_ids` so a postmortem can name exactly which
        requests a SIGTERM caught in flight."""
        with self._lock:
            reqs = list(self._inflight)
            reqs += [r for q in self._lanes.values() for r in q]
        return [r.rid for r in reqs if r.rid]

    # -- drain / shutdown -------------------------------------------------
    def drain(self, timeout: float | None = None) -> bool:
        """Stop admitting, flush everything already admitted, stop the
        dispatcher. Idempotent. Returns True if the dispatcher thread
        exited within `timeout`."""
        with self._lock:
            self._draining = True
            self._work.notify_all()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- dispatch ---------------------------------------------------------
    def _next_lane_locked(self) -> str | None:
        """The weighted pop: interactive unless it is empty, or the
        pop sequence owes bulk its guaranteed slot (one of every
        `interactive_weight + 1` pops while both lanes hold work)."""
        inter = self._lanes["interactive"]
        bulk = self._lanes["bulk"]
        if not inter and not bulk:
            return None
        if not inter:
            return "bulk"
        if not bulk:
            return "interactive"
        w = self.interactive_weight
        return "bulk" if self._pop_seq % (w + 1) == w else "interactive"

    def _take_locked(self) -> list[_Request]:
        """Pop admitted requests up to max_batch reads, in weighted
        lane order. Always pops at least one request (an oversize
        request dispatches alone and is chunked across device
        steps)."""
        taken: list[_Request] = []
        reads = 0
        while True:
            lane = self._next_lane_locked()
            if lane is None:
                break
            nxt = len(self._lanes[lane][0].records)
            if taken and reads + nxt > self.max_batch:
                break
            req = self._lanes[lane].popleft()
            self._pop_seq += 1
            taken.append(req)
            reads += nxt
        return taken

    def _dispatch_loop(self) -> None:
        try:
            self._dispatch_loop_inner()
        except BaseException as e:  # noqa: BLE001 - loop bug
            # a bug in the dispatch loop itself (not an engine step —
            # those are contained below): count it and fall through to
            # the shutdown; re-raising from a daemon thread would only
            # print a traceback nobody handles while clients hang
            self.registry.counter("dispatcher_crashes").inc()
            vlog("quorum-serve dispatcher died: ", repr(e))
        finally:
            # EVERY dispatcher exit path — clean drain or a bug in the
            # loop itself — must fail the queued futures immediately:
            # a stranded future means a client hung until its deadline
            # for work that can never run
            self._shutdown_pending()

    def _dispatch_loop_inner(self) -> None:
        reg = self.registry
        while True:
            with self._work:
                while not self._qlen_locked() and not self._draining:
                    self._work.wait(timeout=0.1)
                if not self._qlen_locked():
                    if self._draining:
                        self._closed = True
                        return
                    continue
                # coalescing window: the FIRST waiter's arrival starts
                # the clock; stop early once a full batch is waiting
                if self.max_wait_s > 0:
                    give_up = self._first_enq_locked() + self.max_wait_s
                    while (not self._draining
                           and self._reads_locked() < self.max_batch):
                        left = give_up - time.perf_counter()
                        if left <= 0:
                            break
                        self._work.wait(timeout=left)
                        if not self._qlen_locked():
                            break
                    if not self._qlen_locked():
                        continue
                taken = self._take_locked()
                self._inflight = taken
            try:
                self._run_batch(taken, reg)
            except BaseException as e:  # noqa: BLE001 - watchdog
                # _run_batch contains engine failures itself; anything
                # escaping is a bug in the dispatch path — fail THIS
                # batch's futures and keep the dispatcher alive
                self._record_step(reg, ok=False)
                n = 0
                for req in taken:
                    if _deliver_exception(req.future, e):
                        n += 1
                if n:
                    reg.counter("requests_failed").inc(n)
            finally:
                with self._lock:
                    self._inflight = []

    def _shutdown_pending(self) -> None:
        err = RuntimeError("quorum-serve dispatcher exited")
        with self._lock:
            self._dead = True
            stranded = [r for q in self._lanes.values() for r in q]
            for q in self._lanes.values():
                q.clear()
        n = 0
        for req in stranded:
            if _deliver_exception(req.future, err):
                n += 1
        if n:
            self.registry.counter("requests_failed").inc(n)

    def _record_step(self, reg, ok: bool) -> None:
        """Track engine-step health: consecutive failures drive the
        unhealthy flip; any success resets the streak."""
        with self._lock:
            if ok:
                self._consecutive_failures = 0
            else:
                self._consecutive_failures += 1
            n = self._consecutive_failures
        if not ok:
            reg.counter("engine_step_failures").inc()
        reg.gauge("consecutive_failures").set(n)

    # -- the watchdog -----------------------------------------------------
    def _timed_step(self, eng, records) -> list:
        """One engine step under the watchdog. Without a timeout this
        is a direct call; with one, the step runs on a monitor thread
        and a budget overrun abandons it (the hung thread is daemon
        and holds only the OLD engine's lock), rebuilds the engine,
        and raises EngineStepTimeout for this batch."""
        if self.step_timeout_s is None:
            return eng.step(records)
        box: dict = {}
        done = threading.Event()

        def run():
            try:
                box["res"] = eng.step(records)
            except BaseException as e:  # noqa: BLE001 - relayed below
                box["err"] = e
            finally:
                done.set()

        t = threading.Thread(target=run, name="quorum-serve-step",
                             daemon=True)
        t.start()
        if not done.wait(self.step_timeout_s):
            self._handle_step_timeout(eng)
            raise EngineStepTimeout(
                f"engine step exceeded {self.step_timeout_s * 1e3:.0f}"
                " ms (watchdog)")
        err = box.get("err")
        if err is not None:
            raise err
        return box["res"]

    def _handle_step_timeout(self, hung_engine) -> None:
        """A step blew its budget: count it and rebuild a warm engine
        so the NEXT step runs on a live one. The rebuild ITSELF runs
        under a (larger) budget — if the device/compiler is wedged
        enough that even a fresh engine's warmup hangs, the dispatcher
        must not re-wedge on the cure: the rebuild thread is abandoned
        too, the old engine stays, every later step times out, the
        failure streak grows, and /healthz flips — the correct signal
        when a rebuild cannot save the replica."""
        reg = self.registry
        reg.counter("engine_step_timeouts").inc()
        # the JAX package dumps its flight recorder here (all-thread
        # stacks of the abandoned step); the port prints and counts
        vlog("quorum-serve watchdog: abandoning engine step after ",
             self.step_timeout_s, " s (thread quorum-serve-step)")
        if self.engine_factory is None:
            return
        gen_at_timeout = self.generation
        box: dict = {}
        done = threading.Event()

        def build():
            try:
                box["eng"] = self.engine_factory(hung_engine)
            except BaseException as e:  # noqa: BLE001 - relayed below
                box["err"] = e
            finally:
                done.set()

        t = threading.Thread(target=build, name="quorum-serve-rebuild",
                             daemon=True)
        t.start()
        if not done.wait(self.rebuild_timeout_s):
            reg.counter("engine_rebuild_failures").inc()
            vlog("quorum-serve watchdog: engine rebuild itself wedged;"
                 " keeping the old engine")
            return
        try:
            if "err" in box:
                raise box["err"]
            # conditional on the generation seen at timeout: a
            # /reload that landed while this rebuild ran installed a
            # FRESHER engine (possibly a new config) — never clobber
            # it with this stale-config replacement
            gen = self.swap_engine(box["eng"],
                                   expected_generation=gen_at_timeout)
        except BaseException as e:  # noqa: BLE001 - best-effort
            reg.counter("engine_rebuild_failures").inc()
            vlog("quorum-serve watchdog: engine rebuild failed: ", e)
            return
        if gen < 0:
            vlog("quorum-serve watchdog: rebuild superseded by a "
                 "concurrent engine swap; dropping it")
            return
        reg.counter("engine_restarts_total").inc()
        reg.event("engine_restart", generation=gen)
        vlog("quorum-serve watchdog: warm engine rebuilt "
             "(generation ", gen, ")")

    def _step_requests(self, reqs: list[_Request],
                       ledger: str = "device_us") -> list[list]:
        """One coalesced engine pass over `reqs`: flatten, step in
        max_batch chunks, return each request's slice of results.
        Captures the CURRENT engine once per attempt — a bisect or
        hedge retry after a watchdog restart runs on the rebuilt
        engine, while a batch already stepping finishes on the old
        one. The attempt's wall time lands on every rider's phase
        ledger (`device_us`, or `hedge_us` for a solo hedge re-run) —
        attempts are disjoint wall intervals, so a bisected request's
        ledger sums its failed and retried passes. Accumulated even
        when the step raises: the failed attempt's time is exactly
        what the 500's lifecycle event should attribute."""
        eng = self.current_engine()
        flat: list = []
        slices: list[tuple[int, int]] = []
        for req in reqs:
            slices.append((len(flat), len(flat) + len(req.records)))
            flat.extend(req.records)
        t0 = time.perf_counter()
        try:
            results: list = []
            for off in range(0, len(flat), self.max_batch):
                results.extend(
                    self._timed_step(eng,
                                     flat[off:off + self.max_batch]))
        finally:
            spent = int((time.perf_counter() - t0) * 1e6)
            for req in reqs:
                setattr(req, ledger, getattr(req, ledger) + spent)
        return [results[s:e] for s, e in slices]

    def _resolve(self, reqs: list[_Request], per_req: list[list],
                 reg) -> None:
        reg.counter("requests_completed").inc(len(reqs))
        for req, res in zip(reqs, per_req):
            try:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_result(res)
            except Exception:  # pragma: no cover - abandoned future
                pass

    def _run_batch(self, taken: list[_Request], reg) -> None:
        now = time.perf_counter()
        live: list[_Request] = []
        for req in taken:
            # the pop stamps the request's lane-wait phase (admission
            # -> dispatch, or -> expiry for a 504): the per-lane
            # histogram is the starvation signal one summed
            # queue_wait_us hides, and the worst waits are exactly the
            # expired ones — omitting them would bias it low when
            # starvation actually happens
            req.lane_wait_us = int((now - req.t_enq) * 1e6)
            if reg.enabled:
                reg.histogram(labeled("lane_wait_us",
                                      lane=req.lane)).observe(
                    req.lane_wait_us)
            if req.deadline is not None and now > req.deadline:
                reg.counter("requests_deadline_exceeded").inc()
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(DeadlineExceeded())
            else:
                # the summed series keeps its seed semantics: waits of
                # DISPATCHED requests only
                if reg.enabled:
                    reg.histogram("queue_wait_us").observe(
                        req.lane_wait_us)
                live.append(req)
        if not live:
            return
        try:
            per_req = self._step_requests(live)
        except BaseException as e:  # noqa: BLE001 - isolated per batch
            self._record_step(reg, ok=False)
            if len(live) > 1:
                self._bisect_retry(live, reg)
            else:
                reg.counter("requests_failed").inc(1)
                _deliver_exception(live[0].future, e)
            return
        self._record_step(reg, ok=True)
        self._resolve(live, per_req, reg)

    def _bisect_retry(self, live: list[_Request], reg) -> None:
        """A failed multi-request batch is bisect-retried ONCE: each
        half runs its own engine pass, so a poisoned request drags
        down at most its half. A half that fails AGAIN with several
        requests aboard is ambiguous — those requests are *hedged*:
        re-run solo (bounded by `max_hedges` per failed batch,
        `hedges_total`), so an innocent batchmate never eats a 500 and
        its response stays byte-identical to the offline CLI. A half
        or hedge succeeding also proves the device is alive, resetting
        the consecutive-failure streak."""
        reg.counter("batch_bisections").inc()
        # the victims' request ids ride the event, so a
        # fleet operator can answer "whose batch bisected?" from the
        # JSONL stream alone
        reg.event("batch_bisect", requests=len(live),
                  request_ids=",".join(r.rid or "-" for r in live))
        for req in live:
            req.bisected = True
        budget = self.max_hedges
        mid = (len(live) + 1) // 2
        for half in (live[:mid], live[mid:]):
            if not half:
                continue
            try:
                per_req = self._step_requests(half)
            except BaseException as e:  # noqa: BLE001 - per half
                self._record_step(reg, ok=False)
                # no solo hedging after a watchdog timeout: each hedge
                # of a deterministically-hanging request would cost a
                # FULL step-timeout + engine rebuild with the
                # dispatcher blocked — fail the ambiguous half fast
                # and let the health flip handle a truly wedged device
                if (len(half) > 1 and budget > 0
                        and not isinstance(e, EngineStepTimeout)):
                    budget = self._hedge_solo(half, e, reg, budget)
                else:
                    reg.counter("requests_failed").inc(len(half))
                    for req in half:
                        _deliver_exception(req.future, e)
                continue
            self._record_step(reg, ok=True)
            self._resolve(half, per_req, reg)

    def _hedge_solo(self, half: list[_Request], err: BaseException,
                    reg, budget: int) -> int:
        """Re-run each request of an ambiguously-failed half alone,
        spending one hedge per solo step; requests past the budget
        fail with the half's original error. Returns the remaining
        budget."""
        for i, req in enumerate(half):
            if budget <= 0:
                rest = half[i:]
                reg.counter("requests_failed").inc(len(rest))
                for r in rest:
                    _deliver_exception(r.future, err)
                return 0
            budget -= 1
            reg.counter("hedges_total").inc()
            reg.event("hedge", request_id=req.rid or "-",
                      reads=len(req.records))
            req.hedged = True
            try:
                per_req = self._step_requests([req], ledger="hedge_us")
            except BaseException as e:  # noqa: BLE001 - per request
                self._record_step(reg, ok=False)
                reg.counter("requests_failed").inc(1)
                _deliver_exception(req.future, e)
                continue
            self._record_step(reg, ok=True)
            self._resolve([req], per_req, reg)
        return budget
