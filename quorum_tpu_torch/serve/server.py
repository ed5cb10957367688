"""The stdlib-HTTP front end of the correction service (counterpart of
quorum_tpu/serve/server.py: every route, status code, header, body cap,
gzip rule and event field of the JAX package's).

Same transport pattern as telemetry/export.py (ThreadingHTTPServer on
daemon threads, no dependencies), with the service semantics on top:

* ``POST /correct`` — body is FASTQ (or FASTA) text; the response is
  the corrected FASTA text, byte-identical to what
  ``quorum_error_correct_reads`` writes for the same reads, with the
  per-read counts in ``X-Quorum-Reads`` / ``X-Quorum-Corrected`` /
  ``X-Quorum-Skipped`` headers. ``?log=1`` switches to a JSON body
  ``{"fa":..., "log":..., "reads":..., "corrected":..., "skipped":...}``
  carrying the ``.log`` channel too. A per-request deadline comes
  from ``?deadline_ms=`` or the ``X-Quorum-Deadline-Ms`` header
  (default: the server's ``deadline_ms``).
* 429 + ``Retry-After`` when the batcher's bounded queue is full
  (admission control), 503 while draining, 504 past the deadline,
  400 on malformed FASTQ.
* ``GET /healthz`` — liveness JSON (status ok/draining, queue depth,
  uptime, totals).
* ``GET /metrics`` — the live Prometheus exposition, mounted on the
  same registry set as every other quorum endpoint
  (telemetry/export.render_live), so the serve counters and any
  in-process stage registries share one scrape.
* ``POST /quiesce`` — graceful drain: stop admitting, flush in-flight
  batches, then release ``serve_until_drained()`` so the CLI writes
  the final metrics document and exits. SIGTERM takes the same path.
* ``POST /ingest`` / ``POST /epoch`` — the live ingestion tier, which
  the port does not have yet (ROADMAP Queue 1 item 8): both answer 501,
  as a JAX replica started without ``--ingest`` does.
* ``GET /debug/flight`` — the flight recorder's live snapshot in the
  JAX package; the port has no recorder yet (item 10), so it answers
  what a JAX replica without one answers: 404 ``no flight recorder``
  (403 off loopback).
* gzip transport both ways (stdlib): a request body with
  ``Content-Encoding: gzip`` is inflated with the size cap applied to
  the DECOMPRESSED payload; a response to a client advertising
  ``Accept-Encoding: gzip`` is compressed when big enough to win.

Resilience surface:

* **Priority lanes** — the ``X-Quorum-Priority`` header routes a
  request into the batcher's ``interactive`` (default) or ``bulk``
  lane; the dispatcher's weighted pop keeps interactive traffic
  flowing under a bulk backlog.
* **Per-client quotas** — with a `TokenBucketQuota` attached, each
  ``X-Quorum-Client`` identity is charged one token per request;
  an empty bucket answers 429 + Retry-After and
  ``quota_rejections_total`` before the request touches the shared
  queue. Requests without the header are not quota-limited (see
  serve/admission.py).
* ``POST /reload`` — hot swap of DB/contaminant/config on a running
  server: the JSON body (``{"db": ..., "contaminant": ...,
  "cutoff": ...}``, all optional) goes to the CLI-provided
  ``engine_builder``, which validates the new DB's header/k/bits
  BEFORE building (the resume path's reuse check) and returns a warm engine;
  only then is the batcher's engine swapped (``reload_total``, new
  ``engine_generation``). ANY failure — unreadable header, k/bits
  mismatch, build error, injected ``serve.reload`` fault — rolls
  back: the old engine keeps answering, byte-identical
  (``reload_failures_total``). In-flight batches finish on the old
  engine either way.
* The ``serve.admit`` fault site fires at admission (chaos harness);
  an injected fault maps to a retryable 503.

Request tracing: every response echoes
``X-Quorum-Request-Id`` (client-stamped or generated), the id is
threaded through admission → lane → batch → engine step →
hedge/bisect telemetry, and each terminal status emits ONE
structured ``request`` lifecycle event with disjoint per-phase
durations (admission, per-lane queue wait, device step, hedge,
render — their sum is <= the end-to-end time). Successful responses
additionally carry the phase breakdown in ``X-Quorum-Phases`` (JSON),
so clients see queue wait vs device time without server access.
"""

from __future__ import annotations

import gzip as gzip_mod
import json
import threading
import time
import uuid
import zlib
from concurrent.futures import TimeoutError as FutureTimeout

from ..io import fastq
from ..telemetry import NULL
from ..telemetry import export as export_mod
from ..telemetry import quality as quality_mod
from ..utils import faults
from ..utils.vlog import vlog
from .batcher import PRIORITIES, DeadlineExceeded, Draining, QueueFull

# a request body bigger than this is refused with 413 before parsing
# (an unbounded read would let one client exhaust host memory)
MAX_BODY_BYTES = 256 * 1024 * 1024

# responses below this size are sent uncompressed even to a client
# that accepts gzip: the header overhead beats the savings
GZIP_MIN_BYTES = 512


def latency_bucket_us(us) -> int:
    """Quarter-octave log quantization for latency histograms (a copy of
    quorum_tpu/telemetry/alerts.latency_bucket_us, the one function of
    the alert engine the server needs): four buckets per power of two,
    <= ~160 distinct keys from 1 µs to 60 s, inside Histogram's key
    budget. Rounds DOWN to the bucket floor."""
    us = int(us)
    if us <= 4:
        return max(us, 0)
    base = 1 << (us.bit_length() - 1)
    step = base >> 2
    return base + (us - base) // step * step


def request_id_for(headers) -> str:
    """The request's trace identity: an `X-Quorum-Request-
    Id` the client stamped, sanitized to printable ASCII and bounded —
    header echo must never become an injection surface — or a fresh
    16-hex id when absent/unusable. Commas are stripped too: batch
    events comma-join the victims' ids, so an id containing one would
    make that field unparseable. Every response carries it back, and
    the batcher threads it through lane/batch/hedge telemetry."""
    raw = (headers.get("X-Quorum-Request-Id") or "").strip()
    rid = "".join(c for c in raw
                  if 33 <= ord(c) <= 126 and c != ",")[:128]
    return rid or uuid.uuid4().hex[:16]


def parse_fastq_text(body: bytes) -> list[tuple[str, bytes, bytes]]:
    """Parse a request body as FASTQ/FASTA records via the same
    reader the offline pipeline uses (io/fastq._iter_one), so the
    service accepts exactly the inputs the CLI accepts."""
    import io as _io
    return list(fastq._iter_one(_io.BytesIO(body), "<request>"))


class CorrectionServer:
    """HTTP front end over a DynamicBatcher.

    `serve_until_drained()` blocks the calling thread until a drain
    completes (via `/quiesce`, SIGTERM -> `initiate_drain()`, or
    `close()`), which is when the caller should write final artifacts
    and exit — the CLI runs it under the observability() context
    manager so the final metrics document lands on every exit path.
    """

    def __init__(self, batcher, host: str = "127.0.0.1", port: int = 0,
                 deadline_ms: float | None = None, registry=NULL,
                 drain_grace_s: float = 30.0, quota=None,
                 engine_builder=None):
        import http.server

        self.batcher = batcher
        self.registry = registry
        self.deadline_ms = deadline_ms
        self.drain_grace_s = drain_grace_s
        # admission quota (serve/admission.TokenBucketQuota or None)
        self.quota = quota
        # engine_builder(params: dict) -> warm engine; validates the
        # new DB before building. None = /reload answers 501.
        self.engine_builder = engine_builder
        self._reload_lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._drained = threading.Event()
        self._drain_started = threading.Event()
        self._requests = 0
        self._req_lock = threading.Lock()
        # feature counters exist from setup so the final metrics
        # document carries the surface at value 0 (metrics_check
        # requires the names when meta declares the feature)
        if quota is not None:
            registry.counter("quota_rejections_total")
        if engine_builder is not None:
            registry.counter("reload_total")
            registry.counter("reload_failures_total")
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):  # noqa: N802 - http.server API
                self.request_id = request_id_for(self.headers)
                route = self.path.split("?")[0]
                if route == "/metrics":
                    body = export_mod.render_live().encode()
                    self._reply(200, body,
                                "text/plain; version=0.0.4; charset=utf-8")
                elif route == "/healthz":
                    h = outer.health()
                    # 503 once the batcher flips unhealthy (dispatcher
                    # gone, or --max-consecutive-failures device-step
                    # failures in a row): load balancers eject the
                    # replica instead of the process dying silently
                    self._reply_json(200 if h.get("healthy", True)
                                     else 503, h)
                elif route == "/debug/flight":
                    outer._handle_debug_flight(self)
                else:
                    self._reply_json(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802 - http.server API
                self.request_id = request_id_for(self.headers)
                route, _, query = self.path.partition("?")
                if route == "/correct":
                    outer._handle_correct(self, query)
                elif route == "/ingest":
                    outer._handle_ingest(self)
                elif route == "/epoch":
                    outer._handle_epoch(self)
                elif route == "/reload":
                    outer._handle_reload(self)
                elif route == "/quiesce":
                    vlog("Quiesce requested over HTTP")
                    outer.initiate_drain()
                    self._reply_json(200, {"status": "draining"})
                else:
                    self._reply_json(404, {"error": "not found"})

            # -- plumbing --------------------------------------------
            def _reply(self, code: int, body: bytes, ctype: str,
                       extra: dict | None = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                # response compression: corrected
                # FASTA compresses ~4x, and the client opted in via
                # Accept-Encoding — tiny bodies skip it (header
                # overhead beats the savings)
                accept = (self.headers.get("Accept-Encoding")
                          or "").lower()
                if "gzip" in accept and len(body) >= GZIP_MIN_BYTES:
                    body = gzip_mod.compress(body, compresslevel=1)
                    self.send_header("Content-Encoding", "gzip")
                self.send_header("Content-Length", str(len(body)))
                # EVERY response echoes the request's trace identity
                # (generated when the client sent none), so a fleet's
                # logs and the server's lifecycle events join on it
                self.send_header("X-Quorum-Request-Id",
                                 getattr(self, "request_id", "-"))
                if self.close_connection:
                    # replies sent WITHOUT reading the request body
                    # (413, bad Content-Length) must kill the
                    # keep-alive connection — the unread bytes would
                    # be parsed as the next request line otherwise
                    self.send_header("Connection", "close")
                for k, v in (extra or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away; nothing to salvage

            def _reply_json(self, code: int, obj: dict,
                            extra: dict | None = None):
                self._reply(code, (json.dumps(obj) + "\n").encode(),
                            "application/json", extra)

            def log_message(self, *a):  # requests are per-batch noise
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="quorum-serve-http", daemon=True)
        self._thread.start()
        registry.set_meta(serve_port=self.port)
        vlog("quorum-serve listening on ", host, ":", self.port)

    # -- request handling -------------------------------------------------
    @staticmethod
    def _read_body(handler, limit: int) -> bytes | int:
        """Validate Content-Length and read the request body. A bad
        or negative length (negative means read-to-EOF — it would
        block the handler thread forever on keep-alive) answers 400,
        an oversized one 413; both kill the keep-alive connection
        (body left unread) and return the status already sent, so the
        caller's lifecycle event carries the real code."""
        try:
            length = int(handler.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if length < 0:
            handler.close_connection = True  # body left unread
            handler._reply_json(400, {"error": "bad Content-Length"})
            return 400
        if length > limit:
            handler.close_connection = True  # body left unread
            handler._reply_json(413, {"error": "request body too large"})
            return 413
        return handler.rfile.read(length)

    @staticmethod
    def _decode_body(handler, body: bytes, limit: int) -> bytes | int:
        """Apply the request's Content-Encoding (gzip,
        stdlib only). The size cap applies to the DECOMPRESSED
        payload — a 1 MiB bomb expanding past `limit` answers 413
        without ever materializing the expansion; truncated or garbage
        gzip answers 400, an unknown coding 415. Like _read_body,
        returns the bytes or the status already sent."""
        enc = (handler.headers.get("Content-Encoding")
               or "").strip().lower()
        if enc in ("", "identity"):
            return body
        if enc != "gzip":
            handler._reply_json(
                415, {"error": f"unsupported Content-Encoding "
                               f"{enc!r} (gzip or identity)"})
            return 415
        d = zlib.decompressobj(16 + zlib.MAX_WBITS)
        try:
            data = d.decompress(body, limit + 1)
        except zlib.error as e:
            handler._reply_json(400, {"error": f"bad gzip body: {e}"})
            return 400
        if len(data) > limit or d.unconsumed_tail:
            handler._reply_json(
                413, {"error": "decompressed body too large"})
            return 413
        if not d.eof:
            handler._reply_json(
                400, {"error": "bad gzip body: truncated stream"})
            return 400
        return data

    def _lifecycle(self, rid: str, lane: str, status: int, t_req0: float,
                   reads: int = 0, req=None, admission_us: int | None = None,
                   render_us: int = 0, quality: dict | None = None) -> dict:
        """Emit the request's ONE lifecycle event: every
        terminal status, with the phase ledger when the request got
        far enough to have one. Phases are disjoint sub-intervals of
        the request's wall time, so their sum is <= total_us. Returns
        the phase dict (the 200 path reuses it for the
        `X-Quorum-Phases` response header). `quality` (the 200 path's
        per-request tally, quality.summarize_results) rides along as
        q_* fields, so the request ledger attributes corrections per
        request the way it already attributes time."""
        total_us = int((time.perf_counter() - t_req0) * 1e6)
        ph = {"admission_us": (admission_us if admission_us is not None
                               else total_us),
              "queue_us": 0, "device_us": 0, "hedge_us": 0,
              "render_us": render_us, "total_us": total_us,
              "lane": lane, "bisected": False, "hedged": False}
        if req is not None:
            ph.update(queue_us=int(req.lane_wait_us),
                      device_us=int(req.device_us),
                      hedge_us=int(req.hedge_us),
                      lane=req.lane, bisected=bool(req.bisected),
                      hedged=bool(req.hedged))
        qf = {}
        if quality is not None:
            qf = {"q_corrected": quality["corrected"],
                  "q_skipped": quality["skipped"],
                  "q_subs": quality["subs"],
                  "q_t3": quality["t3"], "q_t5": quality["t5"]}
        self.registry.event("request", request_id=rid, status=status,
                            reads=reads, **ph, **qf)
        if status == 200 and self.registry.enabled:
            # the latency-SLO feed (the JAX package's alert engine
            # reads it; ROADMAP Queue 1 item 10): end-to-end time of
            # SERVED requests, log-quantized so the exact-
            # count histogram never trips its cardinality guard the
            # way raw request_us does (failures/rejects are the
            # availability rule's business, so only 200s count here)
            self.registry.histogram("request_e2e_bucket_us").observe(
                latency_bucket_us(total_us))
        return ph

    def _handle_correct(self, handler, query: str) -> None:
        reg = self.registry
        rid = handler.request_id
        t_req0 = time.perf_counter()
        lane = "interactive"
        params = _parse_query(query)
        if handler.headers.get("Transfer-Encoding"):
            # we only read Content-Length bodies; silently treating a
            # chunked body as empty would answer 200-empty and leave
            # the chunk bytes to desync the keep-alive connection
            handler.close_connection = True  # body left unread
            handler._reply_json(411, {"error": "Content-Length required"})
            self._lifecycle(rid, lane, 411, t_req0)
            return
        body = self._read_body(handler, MAX_BODY_BYTES)
        if isinstance(body, int):
            # _read_body already answered (400 or 413)
            self._lifecycle(rid, lane, body, t_req0)
            return
        body = self._decode_body(handler, body, MAX_BODY_BYTES)
        if isinstance(body, int):
            self._lifecycle(rid, lane, body, t_req0)
            return
        priority = (handler.headers.get("X-Quorum-Priority")
                    or "interactive").strip().lower()
        if priority not in PRIORITIES:
            handler._reply_json(
                400, {"error": f"bad X-Quorum-Priority {priority!r} "
                               f"(one of {PRIORITIES})"})
            self._lifecycle(rid, lane, 400, t_req0)
            return
        lane = priority
        try:
            # chaos-harness site: a plan can fail the Nth admission to
            # prove overload/fault handling at the door (utils/faults)
            faults.inject("serve.admit")
        except Exception as e:  # noqa: BLE001 - injected faults only
            reg.counter("requests_rejected_admission").inc()
            handler._reply_json(503, {"error": str(e)},
                                extra={"Retry-After": 1})
            self._lifecycle(rid, lane, 503, t_req0)
            return
        client_id = handler.headers.get("X-Quorum-Client")
        if self.quota is not None and client_id:
            ok, retry_in = self.quota.admit(client_id)
            if not ok:
                reg.counter("quota_rejections_total").inc()
                handler._reply_json(
                    429, {"error": "client quota exceeded",
                          "retry_after_s": round(retry_in, 3)},
                    extra={"Retry-After": max(1, int(retry_in + 0.999))})
                self._lifecycle(rid, lane, 429, t_req0)
                return
        deadline_ms = self.deadline_ms
        hdr_deadline = (params.get("deadline_ms")
                        or handler.headers.get("X-Quorum-Deadline-Ms"))
        if hdr_deadline is not None:
            try:
                deadline_ms = float(hdr_deadline)
            except ValueError:
                handler._reply_json(400, {"error": "bad deadline_ms"})
                self._lifecycle(rid, lane, 400, t_req0)
                return
        try:
            records = parse_fastq_text(body)
        except (ValueError, UnicodeDecodeError) as e:
            reg.counter("requests_bad_input").inc()
            handler._reply_json(400, {"error": str(e)})
            self._lifecycle(rid, lane, 400, t_req0)
            return
        t0 = time.perf_counter()
        try:
            fut = self.batcher.submit(
                records,
                deadline_s=(deadline_ms / 1000.0
                            if deadline_ms is not None else None),
                priority=priority, request_id=rid)
        except QueueFull as e:
            handler._reply_json(
                429, {"error": "queue full",
                      "retry_after_s": e.retry_after},
                extra={"Retry-After": max(1, int(round(e.retry_after)))})
            self._lifecycle(rid, lane, 429, t_req0, reads=len(records))
            return
        except Draining:
            handler._reply_json(503, {"error": "draining"},
                                extra={"Retry-After": 1})
            self._lifecycle(rid, lane, 503, t_req0, reads=len(records))
            return
        # admission phase ends where the queue phase begins: the
        # ledger's own enqueue stamp, so the phases stay disjoint
        req = getattr(fut, "request", None)
        admission_us = int(((req.t_enq if req is not None else t0)
                            - t_req0) * 1e6)
        # the wall timeout backstops the batcher's deadline handling:
        # a request admitted but stuck behind a wedged device step
        # still gets its 504 (and its late result is discarded)
        wall = (deadline_ms / 1000.0 + 1.0
                if deadline_ms is not None else None)
        try:
            results = fut.result(timeout=wall)
        except DeadlineExceeded:
            handler._reply_json(504, {"error": "deadline exceeded"})
            self._lifecycle(rid, lane, 504, t_req0, reads=len(records),
                            req=req, admission_us=admission_us)
            return
        except FutureTimeout:
            fut.cancel()
            reg.counter("requests_late").inc()
            handler._reply_json(504, {"error": "deadline exceeded"})
            # unlike every other terminal path, the future is NOT
            # resolved here — the request may be mid-step, so the
            # ledger read below is best-effort (single int fields,
            # safe under the GIL, but device/hedge time still
            # accruing on the dispatcher thread can lag)
            self._lifecycle(rid, lane, 504, t_req0, reads=len(records),
                            req=req, admission_us=admission_us)
            return
        except BaseException as e:  # noqa: BLE001 - surfaced as 500
            handler._reply_json(500, {"error": str(e)})
            self._lifecycle(rid, lane, 500, t_req0, reads=len(records),
                            req=req, admission_us=admission_us)
            return
        with self._req_lock:
            self._requests += 1
        if reg.enabled:
            reg.histogram("request_us").observe(
                int((time.perf_counter() - t0) * 1e6))
            reg.histogram("request_reads").observe(len(records))
        t_render = time.perf_counter()
        fa = "".join(r[0] for r in results)
        log = "".join(r[1] for r in results)
        corrected = sum(1 for r in results if r[0] and not r[1])
        skipped = sum(1 for r in results if r[1])
        # the per-request quality tally: decoded from the
        # same rendered text the client receives, so the header sums
        # reconcile exactly against the serve document's outcome
        # counters (the parity telemetry_smoke asserts)
        q = quality_mod.summarize_results(results)
        render_us = int((time.perf_counter() - t_render) * 1e6)
        ph = self._lifecycle(rid, lane, 200, t_req0, reads=len(records),
                             req=req, admission_us=admission_us,
                             render_us=render_us, quality=q)
        counts = {"X-Quorum-Reads": len(records),
                  "X-Quorum-Corrected": corrected,
                  "X-Quorum-Skipped": skipped,
                  # the server-side phase breakdown, client-readable:
                  # quorum-serve-bench reports queue wait vs device
                  # time per request from this header alone
                  "X-Quorum-Phases": json.dumps(
                      ph, separators=(",", ":")),
                  # the per-request quality summary, client-readable
                  "X-Quorum-Quality": json.dumps(
                      q, separators=(",", ":"), sort_keys=True)}
        if _flag(params, "log"):
            handler._reply_json(200, {
                "fa": fa, "log": log, "reads": len(records),
                "corrected": corrected, "skipped": skipped}, extra=counts)
        else:
            handler._reply(200, fa.encode(), "text/plain; charset=utf-8",
                           extra=counts)

    # -- live ingestion (ROADMAP Queue 1 item 8) ----------------------------
    def _handle_ingest(self, handler) -> None:
        """POST /ingest: the live ingestion tier is not ported yet; 501,
        as a JAX replica started without --ingest answers."""
        handler._reply_json(
            501, {"error": "live ingestion not configured "
                           "(start quorum-serve with --ingest)"})

    def _handle_epoch(self, handler) -> None:
        """POST /epoch: 501, as POST /ingest."""
        handler._reply_json(
            501, {"error": "live ingestion not configured"})

    # -- hot reload --------------------------------------------------------
    def _handle_reload(self, handler) -> None:
        """POST /reload: build a replacement engine from the JSON body
        (via the CLI's engine_builder, which validates the new DB's
        header/k/bits first), then atomically swap it in. The swap is
        all-or-nothing: any failure before it leaves the OLD engine
        serving byte-identical answers (rollback is the absence of the
        swap), and in-flight batches finish on the old engine even
        when it succeeds (the dispatcher captures the engine per step
        attempt)."""
        reg = self.registry
        # a reload body is a small JSON object — 1 MiB is generous
        body = self._read_body(handler, 1 << 20)
        if isinstance(body, int):
            return
        try:
            params = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError) as e:
            handler._reply_json(400, {"error": f"bad JSON body: {e}"})
            return
        if not isinstance(params, dict):
            handler._reply_json(400, {"error": "reload body must be "
                                               "a JSON object"})
            return
        if self.engine_builder is None:
            handler._reply_json(501, {"error": "reload not configured"})
            return
        if self._drain_started.is_set():
            handler._reply_json(503, {"error": "draining"},
                                extra={"Retry-After": 1})
            return
        with self._reload_lock:
            old_gen = self.batcher.generation
            try:
                # chaos-harness site: an injected fault between
                # validation and swap must roll back (utils/faults.py)
                faults.inject("serve.reload")
                new_engine = self.engine_builder(params)
                gen = self.batcher.swap_engine(new_engine)
            except Exception as e:  # noqa: BLE001 - rollback umbrella
                reg.counter("reload_failures_total").inc()
                reg.event("reload_failed", error=str(e),
                          generation=old_gen)
                vlog("Reload failed (old engine keeps serving): ", e)
                code = 400 if isinstance(e, ValueError) else 500
                handler._reply_json(code, {"error": str(e),
                                           "rolled_back": True,
                                           "generation": old_gen})
                return
        reg.counter("reload_total").inc()
        reg.set_meta(engine_generation=gen)
        reg.event("reload", old_generation=old_gen, new_generation=gen)
        vlog("Reloaded engine: generation ", old_gen, " -> ", gen)
        handler._reply_json(200, {"status": "reloaded",
                                  "generation": gen})

    # -- forensics ---------------------------------------------------------
    def _handle_debug_flight(self, handler) -> None:
        """GET /debug/flight: the JAX package's live flight-recorder
        snapshot. The port has no recorder yet (ROADMAP Queue 1 item
        10): loopback callers get what a JAX replica without one
        answers, 404; others 403, as there."""
        ip = handler.client_address[0]
        if ip not in ("127.0.0.1", "::1") and not ip.startswith("127."):
            handler._reply_json(403, {"error": "loopback only"})
            return
        handler._reply_json(404, {"error": "no flight recorder"})

    # -- health / lifecycle -----------------------------------------------
    def health(self) -> dict:
        with self._req_lock:
            served = self._requests
        healthy = bool(getattr(self.batcher, "healthy", True))
        draining = self._drain_started.is_set()
        h = {
            # a draining replica is still healthy (it answers what it
            # admitted); an unhealthy one is NOT draining — it needs
            # ejection, not patience
            "status": ("draining" if draining
                       else "ok" if healthy else "unhealthy"),
            "healthy": healthy or draining,
            "consecutive_failures": int(getattr(
                self.batcher, "consecutive_failures", 0)),
            "uptime_s": round(time.perf_counter() - self._t0, 3),
            "queue_depth": self.batcher.depth,
            "requests_served": served,
            "engine_compiles": self.batcher.engine.compiles,
            "engine_generation": int(getattr(
                self.batcher, "generation", 0)),
            "port": self.port,
        }
        return h

    def initiate_drain(self) -> None:
        """Begin graceful drain (idempotent, safe from signal
        handlers and HTTP threads): stop admitting, then flush the
        admitted backlog on a helper thread so the caller — possibly
        an HTTP handler replying to /quiesce — never blocks on it."""
        if self._drain_started.is_set():
            return
        self._drain_started.set()

        def _drain():
            # name what the drain caught in flight BEFORE flushing it:
            # the final document's meta.drained_ids tells an operator
            # which requests a SIGTERM interrupted (empty on an idle
            # drain), matched by X-Quorum-Request-Id on the client side
            try:
                self.registry.set_meta(
                    drained_ids=self.batcher.pending_rids())
            except Exception:  # noqa: BLE001 - forensics never block drain  # qlint: disable=thread-swallowed-exception - best-effort forensics meta; the drain outcome itself is reported below either way
                pass
            # the meta stamp records what ACTUALLY happened: False
            # means the grace period expired with work unflushed — a
            # lossy shutdown must not read as a clean one downstream
            ok = self.batcher.drain(timeout=self.drain_grace_s)
            self.registry.set_meta(drained=bool(ok))
            self._drained.set()

        threading.Thread(target=_drain, name="quorum-serve-drain",
                         daemon=True).start()

    def serve_until_drained(self) -> None:
        """Block until a drain completes, then stop the HTTP listener.
        KeyboardInterrupt also initiates a drain (first ^C graceful)."""
        try:
            while not self._drained.wait(timeout=0.2):
                pass
        except KeyboardInterrupt:
            vlog("Interrupt: draining")
            self.initiate_drain()
            self._drained.wait(timeout=self.drain_grace_s + 5)
        self.close()

    def close(self) -> None:
        """Tear the listener down (idempotent). Does NOT write
        metrics — that's the observability() teardown's job."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        self.initiate_drain()
        self._drained.wait(timeout=self.drain_grace_s + 5)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def _parse_query(query: str) -> dict:
    """`a=x&b` -> {"a": "x", "b": ""} — a bare key keeps an EMPTY
    value (falsy), so `?deadline_ms` without a number falls through
    to the header/default instead of becoming a 1 ms deadline.
    parse_qsl also percent-decodes, so `log=%31` means `log=1`."""
    import urllib.parse
    return dict(urllib.parse.parse_qsl(query, keep_blank_values=True))


def _flag(params: dict, key: str) -> bool:
    """Boolean query flag: present and not an explicit off-value
    (`?log=1` and bare `?log` are on; `?log=0` is off)."""
    v = params.get(key)
    if v is None:
        return False
    return v.lower() not in ("0", "false", "no")
