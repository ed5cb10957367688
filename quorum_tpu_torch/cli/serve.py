"""quorum-serve, the persistent correction service (counterpart of
quorum_tpu/cli/serve.py).

    python -m quorum_tpu_torch.cli.serve --port 8100 --max-batch 1024 \
        --warmup-lengths 150 -p 4 db.jf              # on the card
    python -m quorum_tpu_torch.cli.serve --device cpu db.jf   # plain

Loads a stage-1 mer database once (HK7 on the card), sees each
`--warmup-lengths` bucket once, and serves `POST /correct` with dynamic
batching until drained (SIGTERM or `POST /quiesce`). The correction
flags mirror `quorum_error_correct_reads`, so a serve deployment and an
offline run of the same flags write the same bytes; the final metrics
document lands through the same observability() lifecycle as every
other CLI, and the registry is live (its `/metrics`) even without
`--metrics`. The live ingestion tier (`--ingest`) is refused: ROADMAP
Queue 1 item 8.
"""

from __future__ import annotations

import argparse
import signal
import sys

from .. import resolve_device
from ..utils import faults, resources
from ..utils import vlog as vlog_mod
from ..utils.vlog import vlog
from .create_database import refuse_unported
from .observability import add_observability_args, observability


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="quorum-serve",
        description="Serve quorum error correction over HTTP: POST "
                    "FASTQ text to /correct, scrape /metrics, drain "
                    "with SIGTERM or POST /quiesce.",
    )
    # correction surface (quorum_error_correct_reads parity)
    p.add_argument("-m", "--min-count", type=int, default=1,
                   help='Minimum count for a k-mer to be considered "good"')
    p.add_argument("-s", "--skip", type=int, default=1,
                   help="Number of bases to skip for start k-mer")
    p.add_argument("-g", "--good", type=int, default=2,
                   help="Number of good k-mer in a row for anchor")
    p.add_argument("-a", "--anchor-count", type=int, default=3,
                   help="Minimum count for an anchor k-mer")
    p.add_argument("-w", "--window", type=int, default=10,
                   help="Size of window")
    p.add_argument("-e", "--error", type=int, default=3,
                   help="Maximum number of error in a window")
    p.add_argument("--contaminant", metavar="path",
                   help="Contaminant sequences (fasta/fastq) or k-mer "
                        "database")
    p.add_argument("--trim-contaminant", action="store_true",
                   help="Trim reads containing contaminated k-mers "
                        "instead of discarding")
    p.add_argument("--homo-trim", type=int, default=None,
                   help="Trim homo-polymer run at the 3' end")
    p.add_argument("-M", "--no-mmap", action="store_true",
                   help="Do not memory map the input mer database")
    p.add_argument("--verify-db", choices=("full", "sample", "off"),
                   default="full",
                   help="Checksum verification when loading v5 "
                        "databases (boot, POST /reload, watchdog "
                        "rebuilds): full (default) checks every "
                        "section, sample scrubs a random subset of "
                        "entry chunks (latency-bounded reloads), off "
                        "skips. A bad digest fails the build — a "
                        "reload rolls back to the old engine")
    p.add_argument("--apriori-error-rate", type=float, default=0.01,
                   help="Probability of a base being an error")
    p.add_argument("--poisson-threshold", type=float, default=1e-6,
                   help="Error probability threshold in Poisson test")
    p.add_argument("-p", "--cutoff", type=int, default=None,
                   help="Poisson cutoff when there are multiple choices")
    p.add_argument("-q", "--qual-cutoff-value", type=int, default=None,
                   help="Any base above with quality equal or greater is "
                        "untouched when there are multiple choices")
    p.add_argument("-Q", "--qual-cutoff-char", default=None,
                   help="Any base above with quality equal or greater is "
                        "untouched when there are multiple choices")
    p.add_argument("-d", "--no-discard", action="store_true",
                   help="Do not discard reads, output a single N")
    p.add_argument("-v", "--verbose", action="store_true", help="Be verbose")
    # serving surface
    p.add_argument("--host", default="127.0.0.1",
                   help="Bind address (default loopback; 0.0.0.0 to "
                        "serve off-machine)")
    p.add_argument("--port", type=int, default=8100,
                   help="Listen port (default 8100; 0 = ephemeral)")
    p.add_argument("--max-batch", type=int, default=1024,
                   help="Reads per device batch; also the padded row "
                        "capacity every batch compiles at (default 1024)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="How long the dispatcher waits to coalesce "
                        "more requests into a batch (default 5)")
    p.add_argument("--queue-requests", type=int, default=64,
                   help="Bounded request-queue capacity; a full queue "
                        "answers 429 + Retry-After (default 64)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="Default per-request deadline (overridable "
                        "per request); expired requests answer 504")
    p.add_argument("--drain-grace-s", type=float, default=30.0,
                   help="Max seconds a drain waits for in-flight "
                        "batches (default 30)")
    p.add_argument("--max-consecutive-failures", metavar="n", type=int,
                   default=5,
                   help="After n device-step failures in a row, "
                        "/healthz answers 503 (unhealthy) so load "
                        "balancers eject the replica; any success "
                        "resets the streak (default 5; 0 = never)")
    p.add_argument("--warmup-lengths", metavar="L1,L2,...", default=None,
                   help="Comma-separated read lengths to pre-compile "
                        "before listening (one device step per "
                        "length bucket)")
    # resilience surface
    p.add_argument("--step-timeout-ms", metavar="ms", type=float,
                   default=0,
                   help="Engine-step watchdog: a device step "
                        "exceeding this budget fails only its batch "
                        "and the warm engine is rebuilt (DB reload + "
                        "per-bucket recompile, engine_restarts_total)"
                        " instead of wedging the process. Must "
                        "comfortably exceed the worst warm step AND "
                        "any cold compile not pre-paid by "
                        "--warmup-lengths (default 0 = off)")
    p.add_argument("--max-hedges", metavar="n", type=int, default=8,
                   help="When a failed batch bisects ambiguously, "
                        "re-run up to n surviving requests solo per "
                        "failed batch (hedges_total) so an innocent "
                        "batchmate never eats a 500 (default 8; "
                        "0 = off)")
    p.add_argument("--quota-rps", metavar="r", type=float, default=0,
                   help="Per-client token-bucket quota: r requests/s "
                        "per X-Quorum-Client identity, 429 + "
                        "Retry-After past it (quota_rejections_total)"
                        ". Requests without the header are not "
                        "quota-limited (default 0 = off)")
    p.add_argument("--quota-burst", metavar="n", type=float, default=0,
                   help="Token-bucket capacity per client (default "
                        "0 = max(1, --quota-rps))")
    p.add_argument("--interactive-weight", metavar="w", type=int,
                   default=4,
                   help="Priority lanes: pop w interactive requests "
                        "(X-Quorum-Priority: interactive, the "
                        "default lane) for every bulk one while both "
                        "lanes hold work (default 4)")
    p.add_argument("--no-reload", action="store_true",
                   help="Disable POST /reload (hot DB/contaminant/"
                        "config swap); it answers 501")
    # the live ingestion tier's flags, as the JAX package spells them:
    # they parse, and --ingest is refused (not ported yet, ROADMAP
    # Queue 1 item 8). Long-only: -m/-s/-q already mean
    # min-count/skip/qual-cutoff-value on this CLI.
    p.add_argument("--ingest", action="store_true",
                   help="The live ingestion tier (not ported yet: "
                        "ROADMAP Queue 1 item 8; refused)")
    p.add_argument("--live-dir", metavar="dir", default=None,
                   help="Directory for epoch snapshots and the "
                        "live-table checkpoint (required with "
                        "--ingest)")
    p.add_argument("--ingest-mer-len", metavar="k", type=int,
                   default=24,
                   help="Live table mer length (default 24)")
    p.add_argument("--ingest-bits", metavar="b", type=int, default=7,
                   help="Live table counter bits (default 7)")
    p.add_argument("--ingest-size", metavar="size", default="16M",
                   help="Initial live table capacity in entries "
                        "(k/M/G suffixes; grows by doubling like the "
                        "offline build; default 16M)")
    p.add_argument("--ingest-qual-thresh", metavar="q", type=int,
                   default=None,
                   help="Quality threshold for a high-quality mer "
                        "(stage-1 --min-qual-value; required with "
                        "--ingest)")
    p.add_argument("--epoch-reads", metavar="n", type=int, default=0,
                   help="Seal + swap a new epoch snapshot after every "
                        "n ingested reads (0 = only --epoch-interval-s"
                        " and POST /epoch trigger epochs)")
    p.add_argument("--epoch-interval-s", metavar="s", type=float,
                   default=0.0,
                   help="Seal + swap a new epoch at most every s "
                        "seconds when new reads arrived (0 = off)")
    p.add_argument("--live-checkpoint-every", metavar="n", type=int,
                   default=0,
                   help="Commit a crash-safe live-table checkpoint "
                        "(table planes + ingest cursor) every n "
                        "chunks; a killed service resumes without "
                        "re-ingesting (default 0 = only at drain)")
    p.add_argument("--live-floor-initial", metavar="f", type=int,
                   default=1,
                   help="Presence floor applied to EARLY epoch "
                        "snapshots, when coverage is too thin to "
                        "trust once-seen mers (default 1 = off)")
    p.add_argument("--live-floor-final", metavar="f", type=int,
                   default=1,
                   help="Presence floor once coverage reaches "
                        "--live-floor-ramp (default 1)")
    p.add_argument("--live-floor-ramp", metavar="cov", type=float,
                   default=0.0,
                   help="Mean HQ coverage at which the epoch floor "
                        "finishes ramping from initial to final "
                        "(0 = floor pinned at final)")
    p.add_argument("--ingest-queue-chunks", metavar="n", type=int,
                   default=16,
                   help="Bounded ingest chunk queue; a full queue "
                        "answers 429 + Retry-After (default 16)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card) or cpu (the kernels' "
                        "plain versions)")
    # observability (same surface as the other CLIs; --metrics
    # writes the final document on drain)
    add_observability_args(p, profile=False)
    faults.add_fault_args(p)
    p.add_argument("db", nargs="?", default=None,
                   help="Mer database (omitted with --ingest: the "
                        "service boots on the live table)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # OR, not assign: QUORUM_TPU_VERBOSE may have enabled it already
    vlog_mod.verbose = args.verbose or vlog_mod.verbose
    if args.ingest:
        print("quorum-serve: --ingest (the live ingestion tier) is not "
              "ported to quorum_tpu_torch yet (ROADMAP Queue 1 item 8)",
              file=sys.stderr)
        return 1
    if refuse_unported(args, "quorum-serve"):
        return 1
    faults.setup(args.fault_plan)
    if args.db is None:
        print("A mer database is required (or --ingest).",
              file=sys.stderr)
        return 1
    if args.qual_cutoff_char is not None and args.qual_cutoff_value is not None:
        print("Switches -q and -Q are conflicting.", file=sys.stderr)
        return 1
    if args.qual_cutoff_char is not None and (
            len(args.qual_cutoff_char) != 1
            or ord(args.qual_cutoff_char) > 127):
        print("The qual-cutoff-char must be one ASCII character.",
              file=sys.stderr)
        return 1
    if args.qual_cutoff_value is not None and not (
            0 <= args.qual_cutoff_value <= 127):
        print("The qual-cutoff-value must be in the range 0-127.",
              file=sys.stderr)
        return 1
    qual_cutoff = (
        ord(args.qual_cutoff_char) if args.qual_cutoff_char is not None
        else args.qual_cutoff_value if args.qual_cutoff_value is not None
        else 127  # numeric_limits<char>::max()
    )
    warmup_lengths: list[int] = []
    if args.warmup_lengths:
        try:
            warmup_lengths = [int(x) for x in
                              args.warmup_lengths.split(",") if x]
        except ValueError:
            print(f"Bad --warmup-lengths {args.warmup_lengths!r}",
                  file=sys.stderr)
            return 1
    resolve_device(args.device)  # no card for --device cuda: raise here

    # the service is its own /metrics endpoint, so the registry is live
    # even without --metrics (live=True); --metrics-port also starts the
    # standalone exposition endpoint the other CLIs use, for scrapers
    # that must not share the serving port's queue. The resource-guard
    # frame watches the metrics document's filesystem.
    watch = [p for p in (args.metrics,) if p]
    with observability(args.metrics, args.metrics_interval,
                       port=args.metrics_port,
                       textfile=args.metrics_textfile,
                       live=True, trace_spans=args.trace_spans,
                       watch_paths=watch, stage="serve") as obs:
        try:
            rc = _serve(args, qual_cutoff, warmup_lengths, obs)
        except (RuntimeError, ValueError, OSError) as e:
            print(str(e), file=sys.stderr)
            obs.status = "error"
            if isinstance(e, resources.ResourceExhausted):
                return resources.DISK_FULL_RC
            return 1
        if rc != 0:
            obs.status = "error"
        return rc


def _make_engine(args, qual_cutoff: int, reg, tracer,
                 db: str | None = None, verify: str | None = None,
                 **over):
    """Construct a CorrectionEngine from the CLI flags, with optional
    reload-time overrides (`db`, `contaminant`, `cutoff`) and an
    explicit `verify` mode (swap paths pin it; see _swap_verify).
    Looked up through the package attribute so tests can stub the
    engine."""
    from .. import serve as serve_pkg
    return serve_pkg.CorrectionEngine(
        db or args.db,
        cutoff=over.get("cutoff", args.cutoff),
        qual_cutoff=qual_cutoff,
        skip=args.skip, good=args.good, anchor_count=args.anchor_count,
        min_count=args.min_count, window=args.window, error=args.error,
        homo_trim=args.homo_trim, trim_contaminant=args.trim_contaminant,
        no_discard=args.no_discard,
        contaminant=over.get("contaminant", args.contaminant),
        apriori_error_rate=args.apriori_error_rate,
        poisson_threshold=args.poisson_threshold, no_mmap=args.no_mmap,
        rows=args.max_batch, verify_db=verify or args.verify_db,
        device=args.device, registry=reg, tracer=tracer)


def _swap_verify(args) -> str:
    """The verification mode for candidate tables about to SWAP into a
    running server (POST /reload): a corrupted table must not replace a
    healthy serving one, so even --verify-db=off is raised to sampled
    scrubbing here; boot keeps the user's choice."""
    return "sample" if args.verify_db == "off" else args.verify_db


def _serve(args, qual_cutoff: int, warmup_lengths: list[int], obs) -> int:
    from ..io import db_format
    from ..serve import (CorrectionServer, DynamicBatcher,
                         TokenBucketQuota)
    from ..telemetry.contract import precreate_serve_metrics

    reg = obs.registry
    # a serve run that drains before its first request must still
    # write a gateable document
    precreate_serve_metrics(reg)

    # the config actually serving: starts at the boot flags, advanced
    # by every successful /reload — the watchdog's rebuild must
    # reproduce the SERVING config, not silently revert to boot
    effective = {"db": args.db, "over": {}}

    engine = _make_engine(args, qual_cutoff, reg, obs.tracer)
    if warmup_lengths:
        vlog("Warming ", len(warmup_lengths), " length buckets")
        engine.warmup(warmup_lengths)

    def _engine_factory(old):
        """Watchdog rebuild: the EFFECTIVE db/config (boot flags plus
        any /reload overrides), warmed to the hung engine's length
        buckets. `warm_lengths` is a lock-free snapshot: the hung step
        may hold the old engine's lock forever."""
        eng = _make_engine(args, qual_cutoff, reg, obs.tracer,
                           db=effective["db"], **effective["over"])
        eng.warmup(getattr(old, "warm_lengths", ()) or warmup_lengths)
        return eng

    batcher = DynamicBatcher(
        engine, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_requests=args.queue_requests,
        max_consecutive_failures=args.max_consecutive_failures,
        step_timeout_ms=args.step_timeout_ms or None,
        engine_factory=_engine_factory,
        max_hedges=args.max_hedges,
        interactive_weight=args.interactive_weight,
        registry=reg)

    def _engine_builder(params: dict):
        """POST /reload: validate the new database's header, k and bits
        BEFORE building, then return a warm engine for the batcher to
        swap in. Any raise here rolls the reload back (the server never
        swaps)."""
        cur = batcher.current_engine()
        db = params.get("db") or getattr(cur, "db_path", args.db)
        header = db_format.read_header(db)  # raises on corrupt/foreign
        cfg = getattr(cur, "cfg", None)
        meta = getattr(cur, "meta", None)
        if cfg is not None and meta is not None:
            if (header.get("key_len") != 2 * cfg.k
                    or header.get("bits") != meta.bits):
                raise ValueError(
                    f"reload refused: {db} is k="
                    f"{header.get('key_len', 0) // 2}/bits="
                    f"{header.get('bits')} but the serving engine is "
                    f"k={cfg.k}/bits={meta.bits}")
        over = dict(effective["over"])
        over.update({k: params[k] for k in ("contaminant", "cutoff")
                     if k in params})
        # candidate tables are verified BEFORE they can swap in, even
        # under --verify-db=off
        eng = _make_engine(args, qual_cutoff, reg, obs.tracer,
                           db=db, verify=_swap_verify(args), **over)
        eng.warmup(getattr(cur, "warm_lengths", ()) or warmup_lengths)
        # the build succeeded, so the server WILL swap it in: a later
        # watchdog rebuild must reproduce this config
        effective["db"] = db
        effective["over"] = over
        return eng

    quota = None
    if args.quota_rps and args.quota_rps > 0:
        quota = TokenBucketQuota(args.quota_rps,
                                 burst=args.quota_burst or None)
    # meta declares the enabled resilience features so metrics_check
    # can require their counters in the final document
    reg.set_meta(max_hedges=args.max_hedges)
    if args.step_timeout_ms:
        reg.set_meta(step_timeout_ms=args.step_timeout_ms)
    if quota is not None:
        reg.set_meta(quota_rps=args.quota_rps)
    if not args.no_reload:
        reg.set_meta(reload=True)
    server = CorrectionServer(
        batcher, host=args.host, port=args.port,
        deadline_ms=args.deadline_ms, registry=reg,
        drain_grace_s=args.drain_grace_s, quota=quota,
        engine_builder=None if args.no_reload else _engine_builder)

    def _sigterm(_signum, _frame):
        vlog("SIGTERM: draining")
        server.initiate_drain()

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread (in-process embedding/tests)
    print(f"quorum-serve: listening on {args.host}:{server.port} "
          f"(max-batch {args.max_batch}, queue {args.queue_requests})",
          file=sys.stderr)
    reg.heartbeat(stage="serve", port=server.port)
    try:
        server.serve_until_drained()
    except BaseException:
        # an unexpected failure must still free the port; the
        # observability teardown stamps the error document
        server.close()
        raise
    vlog("Drained; writing final metrics")
    return 0


if __name__ == "__main__":
    sys.exit(main())
