"""Minimal stdlib client for the correction service, plus the
`quorum-serve-bench` closed-loop load generator (counterpart of
quorum_tpu/serve/client.py).

    python -m quorum_tpu_torch.serve.client --port 8100 -c 8 -r 256 \
        -n 512 reads.fastq

`ServeClient` speaks the tiny HTTP surface of serve/server.py with
http.client only — no dependencies — so tests, tooling, and the bench
share one implementation of the protocol (headers, deadline
forwarding, 429/503 Retry-After handling).

The bench is closed-loop: `--concurrency` workers each post
`--reads-per-request` reads and wait for the answer before posting
again, the standard shape for measuring a service's latency/throughput
trade-off under admission control. Results print as the repo's
bench-style metric lines (telemetry/schema.metric_line), so
`tools/metrics_check.py` can gate a bench run's output like any other
artifact. The bench's `--ingest` mode, and the client's `ingest` and
`epoch` calls, come with the live ingestion tier (ROADMAP Queue 1 item
8).
"""

from __future__ import annotations

import dataclasses
import gzip as gzip_mod
import http.client
import json
import threading
import time


@dataclasses.dataclass
class ServeResult:
    """One /correct exchange. `status` is the HTTP code; `fa`/`log`
    are the corrected-FASTA and skip-log texts (empty unless 200).
    `request_id` echoes the server's `X-Quorum-Request-Id` (every
    response carries one); `phases` is the server-side phase
    breakdown from `X-Quorum-Phases` (admission/queue/device/hedge/
    render/total µs, lane, bisected/hedged — 200 responses only);
    `quality` is the per-request correction-quality summary from
    `X-Quorum-Quality` (reads/corrected/skipped/subs/truncations,
    200 responses only; sums across requests reconcile
    with the server's final metrics document)."""

    status: int
    fa: str = ""
    log: str = ""
    reads: int = 0
    corrected: int = 0
    skipped: int = 0
    retry_after_s: float = 0.0
    error: str = ""
    request_id: str = ""
    phases: dict | None = None
    quality: dict | None = None


def _parse_json_header(resp, name: str) -> dict | None:
    raw = resp.headers.get(name)
    if not raw:
        return None
    try:
        doc = json.loads(raw)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


def _parse_phases(resp) -> dict | None:
    return _parse_json_header(resp, "X-Quorum-Phases")


class ServeClient:
    """One server, many sequential requests (per instance; use one
    instance per thread — http.client connections are not
    thread-safe)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8100,
                 timeout: float = 600.0):
        self.host = host
        self.port = port
        self.timeout = timeout

    def _request(self, method: str, path: str, body: bytes = b"",
                 headers: dict | None = None,
                 gzip_body: bool = False):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        hdrs = dict(headers or {})
        hdrs.setdefault("Accept-Encoding", "gzip")
        if gzip_body and body:
            body = gzip_mod.compress(body, compresslevel=1)
            hdrs["Content-Encoding"] = "gzip"
        try:
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            if (resp.headers.get("Content-Encoding", "")
                    .lower() == "gzip"):
                data = gzip_mod.decompress(data)
            return resp, data
        finally:
            conn.close()

    def correct(self, fastq_text: str | bytes,
                deadline_ms: float | None = None,
                want_log: bool = False,
                priority: str | None = None,
                client_id: str | None = None,
                request_id: str | None = None,
                gzip_body: bool = False) -> ServeResult:
        """POST /correct. Returns a ServeResult whatever the status —
        callers branch on `.status` (200/429/503/504/...).
        `priority` stamps X-Quorum-Priority (interactive|bulk),
        `client_id` stamps X-Quorum-Client (the quota identity), and
        `request_id` stamps X-Quorum-Request-Id (the trace identity;
        the server generates one when absent — either way the
        response's id lands in `ServeResult.request_id`).
        `gzip_body=True` gzips the request body (Content-Encoding:
        gzip); responses are transparently un-gzipped either way."""
        body = (fastq_text.encode()
                if isinstance(fastq_text, str) else fastq_text)
        path = "/correct" + ("?log=1" if want_log else "")
        headers = {"Content-Type": "text/plain"}
        if deadline_ms is not None:
            headers["X-Quorum-Deadline-Ms"] = str(deadline_ms)
        if priority is not None:
            headers["X-Quorum-Priority"] = priority
        if client_id is not None:
            headers["X-Quorum-Client"] = client_id
        if request_id is not None:
            headers["X-Quorum-Request-Id"] = request_id
        resp, data = self._request("POST", path, body, headers,
                                   gzip_body=gzip_body)
        rid = resp.headers.get("X-Quorum-Request-Id", "")
        if resp.status != 200:
            retry = float(resp.headers.get("Retry-After", 0) or 0)
            err = ""
            try:
                err = json.loads(data.decode() or "{}").get("error", "")
            except ValueError:
                pass
            return ServeResult(status=resp.status, retry_after_s=retry,
                               error=err, request_id=rid)
        phases = _parse_phases(resp)
        qual = _parse_json_header(resp, "X-Quorum-Quality")
        if want_log:
            doc = json.loads(data.decode())
            return ServeResult(status=200, fa=doc["fa"], log=doc["log"],
                               reads=doc["reads"],
                               corrected=doc["corrected"],
                               skipped=doc["skipped"],
                               request_id=rid, phases=phases,
                               quality=qual)
        return ServeResult(
            status=200, fa=data.decode(),
            reads=int(resp.headers.get("X-Quorum-Reads", 0)),
            corrected=int(resp.headers.get("X-Quorum-Corrected", 0)),
            skipped=int(resp.headers.get("X-Quorum-Skipped", 0)),
            request_id=rid, phases=phases, quality=qual)

    def correct_with_retry(self, fastq_text: str | bytes,
                           deadline_ms: float | None = None,
                           want_log: bool = False,
                           max_attempts: int = 6,
                           base_backoff_s: float = 0.1,
                           max_backoff_s: float = 5.0,
                           retry_statuses=(429, 503),
                           priority: str | None = None,
                           client_id: str | None = None,
                           gzip_body: bool = False,
                           sleep=time.sleep) -> ServeResult:
        """`correct()` with polite retries on 429/503: the server's
        already-parsed Retry-After is honored when present, combined
        with capped-exponential backoff (the sleep is the larger of
        the two, capped at `max_backoff_s`) so a missing or tiny hint
        still backs off, and a huge one cannot stall the client past
        the cap. Any other status (200, 400, 500, 504, ...) returns
        immediately; after `max_attempts` the last rejection is
        returned as-is. `sleep` is injectable for tests."""
        backoff = base_backoff_s
        res = self.correct(fastq_text, deadline_ms=deadline_ms,
                           want_log=want_log, priority=priority,
                           client_id=client_id, gzip_body=gzip_body)
        for _ in range(max_attempts - 1):
            if res.status not in retry_statuses:
                return res
            sleep(min(max(res.retry_after_s, backoff), max_backoff_s))
            backoff = min(backoff * 2, max_backoff_s)
            res = self.correct(fastq_text, deadline_ms=deadline_ms,
                               want_log=want_log, priority=priority,
                               client_id=client_id,
                               gzip_body=gzip_body)
        return res

    def reload(self, params: dict | None = None) -> tuple[int, dict]:
        """POST /reload — (status_code, body). 200 carries the new
        engine generation; any failure left the old engine serving."""
        body = json.dumps(params or {}).encode()
        resp, data = self._request(
            "POST", "/reload", body,
            {"Content-Type": "application/json"})
        try:
            doc = json.loads(data.decode() or "{}")
        except ValueError:
            doc = {}
        return resp.status, doc

    def healthz(self) -> dict:
        resp, data = self._request("GET", "/healthz")
        if resp.status != 200:
            raise RuntimeError(f"/healthz -> {resp.status}")
        return json.loads(data.decode())

    def healthz_full(self) -> tuple[int, dict]:
        """GET /healthz without raising on 503 — (status_code, body).
        The unhealthy flip (max consecutive engine failures) answers
        503 with the same JSON body."""
        resp, data = self._request("GET", "/healthz")
        return resp.status, json.loads(data.decode())

    def metrics_text(self) -> str:
        resp, data = self._request("GET", "/metrics")
        if resp.status != 200:
            raise RuntimeError(f"/metrics -> {resp.status}")
        return data.decode()

    def quiesce(self) -> dict:
        resp, data = self._request("POST", "/quiesce")
        if resp.status != 200:
            raise RuntimeError(f"/quiesce -> {resp.status}")
        return json.loads(data.decode())


# ---------------------------------------------------------------------------
# quorum-serve-bench
# ---------------------------------------------------------------------------

def _percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def bench_main(argv=None) -> int:
    """Closed-loop load generation against a running quorum-serve."""
    import argparse
    import sys

    from ..io import fastq as fastq_mod
    from ..telemetry.schema import metric_line

    p = argparse.ArgumentParser(
        prog="quorum-serve-bench",
        description="Closed-loop load generator for quorum-serve: N "
                    "workers post FASTQ slices and wait for each "
                    "answer; prints latency/throughput metric lines.")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("-c", "--concurrency", type=int, default=4,
                   help="Closed-loop workers (default 4)")
    p.add_argument("-n", "--requests", type=int, default=64,
                   help="Total requests to send (default 64)")
    p.add_argument("-r", "--reads-per-request", type=int, default=16,
                   help="Reads per request body (default 16)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="Per-request deadline forwarded to the server")
    p.add_argument("--retry-429", action="store_true",
                   help="Honor Retry-After and retry rejected "
                        "requests instead of counting and moving on")
    p.add_argument("--retry", action="store_true",
                   help="Use ServeClient.correct_with_retry: retry "
                        "429 AND 503 with Retry-After honored under "
                        "capped-exponential backoff (supersedes "
                        "--retry-429)")
    p.add_argument("--priority", choices=("interactive", "bulk"),
                   default=None,
                   help="Stamp X-Quorum-Priority on every request")
    p.add_argument("--client-id", default=None,
                   help="Stamp X-Quorum-Client on every request "
                        "(the quota identity)")
    p.add_argument("--gzip", action="store_true",
                   help="gzip request bodies (Content-Encoding: "
                        "gzip); responses are un-gzipped either way")
    p.add_argument("sequence", help="FASTQ/FASTA file to draw reads from")
    args = p.parse_args(argv)

    # pre-render request bodies: round-robin the file's records into
    # --reads-per-request payloads (wrapping if the file is short)
    records = list(fastq_mod.iter_records([args.sequence]))
    if not records:
        print("no reads in input", file=sys.stderr)
        return 1
    bodies: list[bytes] = []
    rr = 0
    for _ in range(args.requests):
        parts = []
        for _ in range(args.reads_per_request):
            hdr, seq, qual = records[rr % len(records)]
            rr += 1
            if qual:
                parts.append(f"@{hdr}\n{seq.decode()}\n+\n"
                             f"{qual.decode()}\n")
            else:
                parts.append(f">{hdr}\n{seq.decode()}\n")
        bodies.append("".join(parts).encode())

    next_i = [0]
    lock = threading.Lock()
    lat: list[float] = []
    phases: list[dict] = []  # server-side breakdown per 200
    outcomes = {200: 0, 429: 0, 503: 0, 504: 0}
    reads_done = [0]
    errors = [0]

    def worker():
        client = ServeClient(args.host, args.port)
        while True:
            with lock:
                i = next_i[0]
                if i >= len(bodies):
                    return
                next_i[0] += 1
            body = bodies[i]
            while True:
                t0 = time.perf_counter()
                try:
                    if args.retry:
                        res = client.correct_with_retry(
                            body, deadline_ms=args.deadline_ms,
                            priority=args.priority,
                            client_id=args.client_id,
                            gzip_body=args.gzip)
                    else:
                        res = client.correct(
                            body, deadline_ms=args.deadline_ms,
                            priority=args.priority,
                            client_id=args.client_id,
                            gzip_body=args.gzip)
                except OSError:
                    with lock:
                        errors[0] += 1
                    break
                dt = time.perf_counter() - t0
                with lock:
                    outcomes[res.status] = outcomes.get(res.status, 0) + 1
                    if res.status == 200:
                        lat.append(dt)
                        reads_done[0] += res.reads
                        if res.phases:
                            phases.append(res.phases)
                if (res.status == 429 and args.retry_429
                        and not args.retry):
                    time.sleep(max(0.05, res.retry_after_s))
                    continue
                break

    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, args.concurrency))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start

    lat.sort()
    print(metric_line(
        "serve_bench", requests=args.requests,
        concurrency=args.concurrency,
        reads_per_request=args.reads_per_request,
        wall_s=round(wall, 4),
        ok=outcomes.get(200, 0), rejected=outcomes.get(429, 0),
        draining=outcomes.get(503, 0), deadline=outcomes.get(504, 0),
        transport_errors=errors[0],
        reads=reads_done[0],
        reads_per_s=round(reads_done[0] / wall, 2) if wall > 0 else 0,
        requests_per_s=(round(len(lat) / wall, 2) if wall > 0 else 0),
        latency_p50_ms=round(_percentile(lat, 50) * 1e3, 3),
        latency_p90_ms=round(_percentile(lat, 90) * 1e3, 3),
        latency_p99_ms=round(_percentile(lat, 99) * 1e3, 3)))
    if phases:
        # the server-side attribution: where each request's
        # time went INSIDE the server, from the X-Quorum-Phases header
        # alone — queue wait vs device time is visible client-side,
        # no server access needed
        fields = {}
        for key in ("admission_us", "queue_us", "device_us",
                    "hedge_us", "render_us", "total_us"):
            vals = sorted(float(p.get(key, 0)) for p in phases)
            fields[f"{key.removesuffix('_us')}_mean_ms"] = round(
                sum(vals) / len(vals) / 1e3, 3)
            fields[f"{key.removesuffix('_us')}_p90_ms"] = round(
                _percentile(vals, 90) / 1e3, 3)
        tot = sum(float(p.get("total_us", 0)) for p in phases)
        if tot > 0:
            for key in ("queue_us", "device_us"):
                share = sum(float(p.get(key, 0)) for p in phases) / tot
                fields[f"{key.removesuffix('_us')}_share"] = round(
                    share, 4)
        fields["bisected"] = sum(1 for p in phases if p.get("bisected"))
        fields["hedged"] = sum(1 for p in phases if p.get("hedged"))
        print(metric_line("serve_bench_phases", requests=len(phases),
                          **fields))
    return 0 if outcomes.get(200, 0) > 0 else 1


if __name__ == "__main__":
    import sys
    sys.exit(bench_main())
