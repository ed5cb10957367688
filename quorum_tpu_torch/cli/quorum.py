"""quorum (port): the single-GPU driver. Parses and packs the reads
ONCE, builds the mer table (stage 1), hands it to stage 2 in-process
(the table stays on the card) and corrects every read against it
(counterpart of quorum_tpu/cli/quorum.py:711-752, 931).

    python -m quorum_tpu_torch.cli.quorum -s 64k -k 13 -p out reads.fastq
    python -m quorum_tpu_torch.cli.quorum --device cpu ...   # plain torch
    python -m quorum_tpu_torch.cli.quorum --prefilter two-pass ...
    python -m quorum_tpu_torch.cli.quorum --partitions 4 ...
    python -m quorum_tpu_torch.cli.quorum --devices 2 ...   # two cards
    python -m quorum_tpu_torch.cli.quorum --contaminant \
        $(python -m quorum_tpu_torch.data) --trim-contaminant ...
    python -m quorum_tpu_torch.cli.quorum -P -p out r_1.fastq r_2.fastq

With --partitions P > 1 stage 1 writes a sharded manifest pass by pass
and keeps no table on the card, so stage 2 loads the manifest from disk
(HK7); the batches the first pass parsed still replay into stage 2.
With --devices N the driver resolves the count once and hands it to
both stages (parallel/tile_sharded; with --partitions P every pass is a
sharded build); stage 2 replicates the table or, past
QUORUM_REPLICATE_TABLE_BYTES or 2^24 rows, keeps it row-sharded (the
routed layout). The output is --devices 1's.

The reads are parsed (-t workers; the native parser where it serves)
and packed on a producer thread ahead of stage 1's main thread, which
makes every CUDA call; stage 2 renders on --render-workers threads. The
output bytes do not depend on -t or --render-workers.

With -P/--paired-files (an even number of files, taken pairwise) stage
1 counts the files as they are and stage 2 runs the reference's merge |
correct | split pipe in process (quorum.in:172-231): the mates,
interleaved by merge_mate_pairs.merge_records, are corrected with
--no-discard forced, so that every read gives one record, and
<prefix>.fa is split into <prefix>_1.fa and <prefix>_2.fa and removed.
Paired mode keeps no replay cache: the cache holds the files' order,
not the merged one.

Crash safety (quorum_tpu's driver): --checkpoint-dir DIR passes the
checkpoints to both stages (stage 1's snapshots in DIR, stage 2's
journal beside its output, every --checkpoint-every batches) and
streams the replay cache to DIR/replay (io/checkpoint.ReplayCache; not
in paired mode). --stage-retries N retries a failed stage with capped
exponential backoff (--retry-backoff-ms), each retry resuming from the
stage's checkpoint; rc 3 (an artifact that cannot be used) and rc 4
(out of disk) are not retried. --resume reuses a finished database that
validates under --verify-db (and replays the capture instead of parsing
the FASTQ again), or else resumes each stage from its checkpoint.

Telemetry: --metrics m.json writes the driver's own document there and
forwards m.stage1.json / m.stage2.json to the stages; --trace-spans
s.jsonl writes s.driver.jsonl (the shared producer's spans) and forwards
s.stage1.jsonl / s.stage2.jsonl; --profile prof/ forwards prof/stage1
and prof/stage2, and the driver's document attributes the device time
of both.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys
import time

import numpy as np
import torch

from .. import __version__, resolve_device
from ..io import checkpoint as ckpt_mod
from ..io import db_format, fastq, packing
from ..models.ec_config import DEFAULT_QUAL_CUTOFF
from ..ops.sketch import PREFILTER_MODES
from ..parallel import tile_sharded as ts
from ..utils import faults, resources
from ..utils import vlog as vlog_mod
from ..utils.pipeline import prefetch
from ..utils.sizes import parse_size
from ..utils.vlog import vlog
from . import create_database as cdb_cli
from . import error_correct_reads as ec_cli
from .merge_mate_pairs import merge_records
from .observability import add_observability_args, observability
from .split_mate_pairs import split_stream

# The reference quorum is 1.x and wrappers gate on `quorum --version`:
# a 1.x version with the package's own as its local segment (PEP 440).
VERSION = f"1.1.1+torch.{__version__}"

# Host bytes the driver may hold of parsed batches for stage 2 to
# replay (the JAX driver's default cap). Past it the cache is dropped
# and stage 2 parses the input again from disk.
REPLAY_CACHE_BYTES = 6 * 1024 ** 3

# Retry backoff ceiling: exponential growth stops doubling here.
_RETRY_BACKOFF_CAP_MS = 30_000.0

# module-level so tests mock the clock without touching time.sleep
_sleep = time.sleep


def _run_stage_with_retries(reg, stage: str, attempt_fn, retries: int,
                            backoff_ms: float, cursor_fn=None) -> int:
    """Run one stage under the driver's retry policy (quorum_tpu's
    _run_stage_with_retries): on a failure (a nonzero rc, or an
    exception of the stages' failure shapes) wait with capped
    exponential backoff and try again, up to `retries` extra attempts.
    The document carries `<stage>_attempts`, `stage_retries_total`
    counts the retries and each emits a `stage_retry` event (cause,
    attempt, the cursor `cursor_fn` peeks). `attempt_fn(attempt)`
    returns the stage's rc; a retried attempt passes --resume. rc 3
    (NON_RETRYABLE_RC) and rc 4 (DISK_FULL_RC) return at once."""
    attempt = 0
    while True:
        cause = None
        try:
            rc = attempt_fn(attempt)
            if rc != 0:
                cause = f"exit status {rc}"
        except (RuntimeError, ValueError, OSError) as e:
            # the stages' failure shapes, mapped as their CLIs map them
            rc = cdb_cli.failure_rc(e)
            cause = f"{type(e).__name__}: {e}"
        if reg.enabled:
            reg.set_meta(**{f"{stage}_attempts": attempt + 1})
        if rc == 0:
            return 0
        # a deterministic refusal re-raises on every retry, and a full
        # disk does not empty itself between attempts
        if (rc in (ckpt_mod.NON_RETRYABLE_RC, resources.DISK_FULL_RC)
                or attempt >= retries):
            if cause:
                print(f"quorum: {stage} failed: {cause}", file=sys.stderr)
            return rc
        delay_ms = min(backoff_ms * (2 ** attempt), _RETRY_BACKOFF_CAP_MS)
        cursor = cursor_fn() if cursor_fn is not None else None
        reg.counter("stage_retries_total").inc()
        reg.event("stage_retry", stage=stage, attempt=attempt + 1,
                  cause=cause, backoff_ms=delay_ms, resumed_from=cursor)
        print(f"quorum: {stage} failed ({cause}); retrying in "
              f"{delay_ms / 1000.0:.1f}s (attempt {attempt + 2} of "
              f"{retries + 1}"
              + (f", resuming from batch {cursor}" if cursor is not None
                 else "") + ")", file=sys.stderr)
        if delay_ms > 0:
            _sleep(delay_ms / 1000.0)
        attempt += 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="quorum",
        description="Run the quorum error corrector on the given fastq "
                    "files. With --paired-files, an even number of files "
                    "is expected and corrected pairs are written to "
                    "<prefix>_1.fa and <prefix>_2.fa.")
    p.add_argument("-s", "--size", default="200M",
                   help="Mer database size (default 200M)")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="Number of threads (default number of cpus)")
    p.add_argument("-p", "--prefix", default="quorum_corrected",
                   help="Output prefix (default quorum_corrected)")
    p.add_argument("-k", "--kmer-len", type=int, default=24,
                   help="Kmer length (default 24)")
    p.add_argument("-q", "--min-q-char", type=int, default=None,
                   help="Minimum quality char. Usually 33 or 64 "
                        "(autodetect)")
    p.add_argument("-m", "--min-quality", type=int, default=5,
                   help="Minimum above -q for high quality base (5)")
    p.add_argument("-w", "--window", type=int, default=None,
                   help="Window size for trimming")
    p.add_argument("-e", "--error", type=int, default=None,
                   help="Maximum number of errors in a window")
    p.add_argument("--min-count", type=int, default=None,
                   help="Minimum count for a k-mer to be good")
    p.add_argument("--skip", type=int, default=None,
                   help="Number of bases to skip to find anchor kmer")
    p.add_argument("--anchor", type=int, default=None,
                   help="Number of good kmer in a row for anchor")
    p.add_argument("--anchor-count", type=int, default=None,
                   help="Minimum count for an anchor kmer")
    p.add_argument("--contaminant", default=None,
                   help="Contaminant sequences")
    p.add_argument("--trim-contaminant", "--contaminant-trim",
                   action="store_true",
                   help="Trim sequences with contaminant mers")
    p.add_argument("-d", "--no-discard", action="store_true",
                   help="Do not discard reads, output a single N (false)")
    p.add_argument("-P", "--paired-files", action="store_true",
                   help="Preserve mate pairs in two files")
    p.add_argument("--homo-trim", type=int, default=None,
                   help="Trim homo-polymer on 3' end")
    p.add_argument("--batch-size", type=int, default=8192,
                   help="Reads per device batch")
    p.add_argument("--db-version", type=int, choices=(4, 5), default=5,
                   help="Mer-database export version (default 5)")
    p.add_argument("--verify-db", choices=("full", "sample", "off"),
                   default="full",
                   help="Checksum verification when stage 2 loads a v5 "
                        "database: full (default), sample (random chunk "
                        "scrub), or off. A bad digest refuses the run")
    p.add_argument("--prefilter", choices=("auto",) + PREFILTER_MODES,
                   default="auto",
                   help="Stage-1 singleton prefilter: drop mers seen once "
                        "before they claim a table slot (two-pass = exact "
                        "via a sketch pass; inline = online). The database "
                        "declares its presence floor and stage 2 applies "
                        "it. auto = QUORUM_PREFILTER env, else off")
    p.add_argument("--db-layout", choices=("single", "sharded"),
                   default="single",
                   help="Mer-database on-disk layout: single (default) "
                        "writes one file; sharded writes shard files under "
                        "a sealed manifest (same payload bytes)")
    p.add_argument("--partitions", type=int, default=1, metavar="P",
                   help="Build the mer database in P sequential passes "
                        "(power of two <= 256), each at 1/P the table "
                        "memory, exported straight into the sharded "
                        "manifest; byte-identical payload")
    p.add_argument("--on-bad-read",
                   choices=fastq.BadReadPolicy.MODES, default="abort",
                   help="Malformed-record policy: abort (default), "
                        "skip and count, or quarantine to "
                        "<prefix>.quarantine.fastq")
    p.add_argument("--render-workers", type=int, default=0, metavar="N",
                   help="Stage-2 host finish/render workers behind a "
                        "sequence-numbered reorder stage (0 = auto, "
                        "min(4, cores)); output is byte-identical for "
                        "any N")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of "
                        "the kernels)")
    cdb_cli.add_devices_arg(
        p, "Scale out (stage 1 builds the table sharded by leading row "
           "bits, stage 2 corrects data-parallel with the table "
           "replicated, or row-sharded past QUORUM_REPLICATE_TABLE_BYTES "
           "or 2^24 rows)")
    add_observability_args(p, driver=True)
    p.add_argument("--checkpoint-dir", metavar="dir", default=None,
                   help="Enable crash-safe checkpoints: stage-1 table "
                        "snapshots land here; stage 2 journals beside "
                        "its output. A killed run restarted with "
                        "--resume continues instead of recounting")
    p.add_argument("--checkpoint-every", metavar="batches", type=int,
                   default=64,
                   help="Batches between stage checkpoints "
                        "(default 64)")
    p.add_argument("--resume", action="store_true",
                   help="Continue an interrupted run: a finished "
                        "stage-1 database is reused, otherwise each "
                        "stage resumes from its last checkpoint")
    p.add_argument("--stage-retries", metavar="n", type=int, default=0,
                   help="Retry a failed stage up to n times with "
                        "capped exponential backoff, resuming from "
                        "its checkpoint (default 0 = fail fast)")
    p.add_argument("--retry-backoff-ms", metavar="ms", type=float,
                   default=500.0,
                   help="Base retry backoff; doubles per attempt, "
                        "capped at 30s (default 500)")
    faults.add_fault_args(p)
    cdb_cli.add_unported_args(p)
    p.add_argument("--debug", action="store_true",
                   help="Display debugging information")
    p.add_argument("--version", action="version", version=VERSION)
    p.add_argument("reads", nargs="*", help="Input fastq files")
    return p


def _stage_path(base: str, tag: str) -> str:
    """Per-stage artifact path: out.json -> out.stage1.json (the same for
    .jsonl); a path without a known extension gets the suffix
    appended."""
    for ext in (".jsonl", ".json"):
        if base.endswith(ext):
            return f"{base[:-len(ext)]}.{tag}{ext}"
    return f"{base}.{tag}"


def detect_min_q_char(path: str, max_reads: int = 1000) -> int:
    """Smallest quality char of the first `max_reads` records
    (quorum.in:129-152), with the Illumina 35/66 -> -2 adjustment and
    the 33/59/64 sanity check."""
    min_q = 256
    for i, (_hdr, _seq, qual) in enumerate(fastq.iter_records([path])):
        if i >= max_reads:
            break
        if not qual:
            raise RuntimeError("Invalid fastq format")
        min_q = min(min_q, min(qual))
    if min_q in (35, 66):
        min_q -= 2
    if min_q not in (33, 59, 64):
        raise RuntimeError(
            f"Found an unusual minimum quality char of {min_q} "
            f"({chr(min_q) if 0 <= min_q < 256 else '?'}). Stopping now. "
            "Use option -q to override")
    return min_q


def _live_argv(args) -> list[str]:
    """The live exposition's flags a stage gets from the quorum driver:
    the shared textfile, and `--metrics-live` under its `--metrics-port`
    (one endpoint for the whole run; the stage runs a real registry so
    that its counters appear on it)."""
    out = []
    if args.metrics_textfile:
        out.extend(["--metrics-textfile", args.metrics_textfile])
    if args.metrics_port is not None:
        out.append("--metrics-live")
    return out


def _drain(items: list):
    """Yield the items in order, letting go of each once it is taken."""
    items.reverse()
    while items:
        yield items.pop()


def main(argv=None, report: dict | None = None) -> int:
    """`report` (optional dict) receives per-stage seconds, the host
    share of each, and the two stages' statistics."""
    args = build_parser().parse_args(argv)
    # OR, not assign: QUORUM_TPU_VERBOSE may have enabled it already
    vlog_mod.verbose = args.debug or vlog_mod.verbose
    if cdb_cli.refuse_unported(args, "quorum"):
        return 1
    # one plan for the driver and both in-process stages (subprocesses
    # read QUORUM_FAULT_PLAN)
    faults.setup(args.fault_plan)
    # the driver's own resource guards watch its artifacts' filesystems;
    # the stall watchdog is the stages' (only their loops beat)
    watch = [p for p in (args.prefix + "_mer_database.jf",
                         args.checkpoint_dir, args.metrics) if p]
    with observability(args.metrics, args.metrics_interval,
                       port=args.metrics_port,
                       textfile=args.metrics_textfile,
                       trace_spans=(_stage_path(args.trace_spans, "driver")
                                    if args.trace_spans else None),
                       profile=args.profile, watch_paths=watch) as obs:
        rc = _main(args, obs.registry, obs.tracer, report)
        if rc != 0:
            obs.status = "error"
    return rc


def _main(args, reg, tracer, report: dict | None) -> int:
    if not re.match(r"^\d+[kMGT]?$", args.size):
        print(f"Invalid size '{args.size}'. It must be a number, maybe "
              "followed by a suffix (like k, M, G for thousand, million "
              "and billion).", file=sys.stderr)
        return 1
    if not args.reads:
        print("No sequence files. See quorum --help.", file=sys.stderr)
        return 1
    if args.paired_files and len(args.reads) % 2 != 0:
        print("With --paired-files an even number of input files is "
              "required.", file=sys.stderr)
        return 1
    # resolve once and forward the count to both stages
    if not cdb_cli.resolve_devices_arg(args, "quorum"):
        return 1
    resolve_device(args.device)  # no card for --device cuda: raise here
    vlog("Using ", args.devices, " device(s)")
    P = args.partitions
    if P < 1 or P > 256 or (P & (P - 1)):
        print(f"quorum: --partitions must be a power of two in "
              f"[1, 256], got {P}", file=sys.stderr)
        return 1
    # where the sharded path is not ported, auto/all go on with one
    # device and an explicit N is refused, before any stage runs
    if args.prefilter not in ("auto", "off") and args.devices > 1 and \
            not cdb_cli.one_device_for(args, "quorum",
                                       cdb_cli.PREFILTER_ON_ONE):
        print(f"quorum: {cdb_cli.PREFILTER_ON_ONE}", file=sys.stderr)
        return 1
    if args.devices > 1 and not cdb_cli.routed_devices_ok(
            args, "quorum", ts.initial_rb(parse_size(args.size),
                                          args.kmer_len, 7, args.devices)):
        return 1
    if args.prefilter == "inline" and (P > 1 or args.checkpoint_dir):
        print("quorum: --prefilter=inline supports neither "
              "--partitions nor --checkpoint-dir; use "
              "--prefilter=two-pass", file=sys.stderr)
        return 1
    # per-stage telemetry paths, suffixed as quorum_tpu's driver does
    m1 = _stage_path(args.metrics, "stage1") if args.metrics else None
    m2 = _stage_path(args.metrics, "stage2") if args.metrics else None
    p1 = os.path.join(args.profile, "stage1") if args.profile else None
    p2 = os.path.join(args.profile, "stage2") if args.profile else None
    ts1 = (_stage_path(args.trace_spans, "stage1")
           if args.trace_spans else None)
    ts2 = (_stage_path(args.trace_spans, "stage2")
           if args.trace_spans else None)
    if reg.enabled:
        cuda = torch.cuda.is_available()
        reg.set_meta(
            driver="quorum", version=VERSION,
            config={k: "" if v is None else str(v)
                    for k, v in vars(args).items()},
            torch_version=torch.__version__, device=args.device,
            cuda_device_count=torch.cuda.device_count() if cuda else 0,
            cuda_device_names=sorted({
                torch.cuda.get_device_name(i)
                for i in range(torch.cuda.device_count())} if cuda else ()),
            devices_resolved=args.devices,
            metrics_stage1=m1, metrics_stage2=m2)
        reg.counter("stage_retries_total")  # lands even at 0
    min_q = args.min_q_char
    if min_q is None:
        try:
            min_q = detect_min_q_char(args.reads[0])
        except (RuntimeError, ValueError, OSError) as e:
            print(str(e), file=sys.stderr)
            return 1
    vlog("Using min quality char ", min_q, " (+", args.min_quality, ")")
    t1 = min_q + args.min_quality
    # the cpu count, like the reference driver (quorum.in:110-120),
    # forwarded to both stages' host decode
    threads = args.threads if args.threads else (os.cpu_count() or 1)
    vlog("Using ", threads, " threads for host decode")
    db_file = args.prefix + "_mer_database.jf"
    cdb_argv = ["-s", args.size, "-m", str(args.kmer_len), "-q", str(t1),
                "-b", "7", "-t", str(threads), "-o", db_file, "--batch-size",
                str(args.batch_size), "--db-version", str(args.db_version),
                "--db-layout", args.db_layout, "--device", args.device,
                "--devices", str(args.devices), "--preflight",
                args.preflight]
    if args.stall_timeout_s and args.stall_timeout_s > 0:
        cdb_argv.extend(["--stall-timeout-s", str(args.stall_timeout_s)])
    if args.checkpoint_dir:
        cdb_argv.extend(["--checkpoint-dir", args.checkpoint_dir,
                         "--checkpoint-every", str(args.checkpoint_every)])
    if args.prefilter != "auto":
        cdb_argv.extend(["--prefilter", args.prefilter])
    if P != 1:
        cdb_argv.extend(["--partitions", str(P)])
    if args.on_bad_read != "abort":
        cdb_argv.extend(["--on-bad-read", args.on_bad_read])
    for flag, val in (("--metrics", m1), ("--profile", p1),
                      ("--trace-spans", ts1)):
        if val is not None:
            cdb_argv.extend([flag, val])
    if m1 is not None:
        cdb_argv.extend(["--metrics-interval", str(args.metrics_interval)])
    cdb_argv.extend(_live_argv(args))
    if args.debug:
        cdb_argv.append("-v")
        print("+ quorum_create_database " + " ".join(cdb_argv)
              + " " + " ".join(args.reads), file=sys.stderr)

    # one parse + pack for both stages, on a producer thread: stage 1's
    # first pass consumes the caching producer, stage 2 replays the
    # cached batches packed with ITS quality plane, unless they outgrow
    # REPLAY_CACHE_BYTES (then stage 2 re-parses); later stage-1 passes
    # (the two-pass prefilter's, the partitions', every pass after a
    # geometry restart) re-parse quietly. A first pass cut short by a
    # restart leaves the cache incomplete, and stage 2 re-parses. The
    # bad-read policy lives on the driver's reader (its quarantine
    # beside the corrected output); repeat passes skip silently. Paired
    # mode caches nothing: stage 2 reads the mates merged, not in the
    # files' order. With --checkpoint-dir the cache also streams to
    # disk (ReplayCache), committed once the first pass ends, so that a
    # resumed run replays it instead of parsing the FASTQ.
    cache: list = []
    host = {"cached": 0, "keep": not args.paired_files, "complete": False,
            "writer": None}
    times: dict = {}
    replay_identity = {"inputs": list(args.reads),
                       "batch_size": int(args.batch_size),
                       "qual_cutoff": int(DEFAULT_QUAL_CUTOFF),
                       "on_bad_read": args.on_bad_read}
    replay_store = (ckpt_mod.ReplayCache(args.checkpoint_dir)
                    if args.checkpoint_dir and not args.paired_files
                    else None)

    def policy(first: bool):
        if args.on_bad_read == "abort":
            return None
        if not first:
            return fastq.BadReadPolicy("skip")
        reg.counter("bad_reads_total")  # lands even at 0
        reg.set_meta(on_bad_read=args.on_bad_read)
        return fastq.BadReadPolicy(args.on_bad_read,
                                   args.prefix + ".quarantine.fastq",
                                   reg if reg.enabled else None)

    def packed(first: bool):
        """(batch without quals, packed stage-1 wire) pairs; the first
        pass also fills the replay cache."""
        writer = host["writer"] if first else None
        for b in fastq.read_batches(args.reads, args.batch_size,
                                    threads=threads, policy=policy(first)):
            pk1 = packing.pack_reads(b.codes, b.quals, b.lengths,
                                     thresholds=(t1,))
            pk1.to_wire()  # build the fused buffer off the main thread
            lean = dataclasses.replace(b, quals=None)
            if first and host["keep"]:
                pk2 = packing.PackedReads(
                    pcodes=pk1.pcodes, nmask=pk1.nmask,
                    hq={DEFAULT_QUAL_CUTOFF: np.packbits(
                        b.quals >= DEFAULT_QUAL_CUTOFF, axis=1,
                        bitorder="little")},
                    lengths=pk1.lengths, length=pk1.length)
                host["cached"] += (
                    b.codes.nbytes + pk2.pcodes.nbytes + pk2.nmask.nbytes
                    + pk2.hq[DEFAULT_QUAL_CUTOFF].nbytes
                    + sum(len(h) + 90 for h in b.headers))
                host["keep"] = host["cached"] <= REPLAY_CACHE_BYTES
                if host["keep"]:
                    cache.append((lean, pk2))
                    if writer is not None:
                        writer.add(lean, pk2)
                else:
                    cache.clear()
                    if writer is not None:
                        writer.abort()
            yield lean, pk1
        if first:
            host["complete"] = True
            # every batch landed: the on-disk capture commits
            if writer is not None and host["keep"]:
                writer.finish()

    def stage1_cursor():
        if not args.checkpoint_dir:
            return None
        if P > 1:
            return ckpt_mod.Stage1PartitionCursor(args.checkpoint_dir).cursor()
        cls = (ckpt_mod.Stage1ShardedCheckpoint if args.devices > 1
               else ckpt_mod.Stage1Checkpoint)
        return cls(args.checkpoint_dir).cursor()

    handoff: dict = {}

    def stage1_attempt(attempt: int) -> int:
        # every attempt gets a fresh producer and replay cache (a failed
        # attempt consumed part of the previous one)
        handoff.clear()
        cache.clear()
        host.update(cached=0, keep=not args.paired_files, complete=False,
                    writer=(replay_store.start(replay_identity,
                                               REPLAY_CACHE_BYTES)
                            if replay_store is not None else None))
        argv = list(cdb_argv)
        if args.checkpoint_dir and (args.resume or attempt > 0):
            argv.append("--resume")
        calls = {"n": 0}

        def factory():
            calls["n"] += 1
            first = calls["n"] == 1
            if not first:
                return prefetch(packed(False))
            return prefetch(packed(True), times=times,
                            metrics=reg if reg.enabled else None,
                            name="reads_producer", tracer=tracer)
        return cdb_cli.main(argv + list(args.reads), handoff=handoff,
                            batches_factory=factory)

    t_s1 = time.perf_counter()
    # --resume with stage 1 durable (its database exists and validates,
    # and no partial checkpoint is pending): reuse it instead of
    # counting again
    if args.resume and os.path.exists(db_file) and stage1_cursor() is None \
            and _db_reusable(db_file, args, reg):
        vlog("Resume: reusing existing mer database ", db_file)
        reg.event("stage_skipped", stage="create_database",
                  reason="resume: database exists")
        reg.set_meta(stage1_resumed_db=db_file)
    else:
        rc = _run_stage_with_retries(reg, "create_database", stage1_attempt,
                                     args.stage_retries,
                                     args.retry_backoff_ms,
                                     cursor_fn=stage1_cursor)
        if rc != 0:
            if rc in (resources.DISK_FULL_RC, resources.STALL_RC):
                # these rcs carry retry semantics for outer supervisors
                print("Creating the mer database failed (out of disk "
                      "space or stalled).", file=sys.stderr)
                return rc
            print("Creating the mer database failed. Most likely the size "
                  "passed to the -s switch is too small.", file=sys.stderr)
            return 1
    s1_s = time.perf_counter() - t_s1
    if reg.enabled:
        reg.gauge("stage1_seconds").set(round(s1_s, 3))
        reg.event("stage_done", stage="create_database",
                  seconds=round(s1_s, 3))
    # the table may have grown past the replicated stage-2 layout
    if args.devices > 1 and not cdb_cli.routed_devices_ok(
            args, "quorum", db_format.header_rb_log2(db_file)):
        return 1

    ec_argv = ["--batch-size", str(args.batch_size), "--device",
               args.device, "--devices", str(args.devices), "-t",
               str(threads), "--verify-db", args.verify_db,
               "--render-workers", str(args.render_workers),
               "--preflight", args.preflight]
    if args.stall_timeout_s and args.stall_timeout_s > 0:
        ec_argv.extend(["--stall-timeout-s", str(args.stall_timeout_s)])
    if args.checkpoint_dir:
        ec_argv.extend(["--checkpoint-every", str(args.checkpoint_every)])
    # a bad read skipped in one mate file would unpair the rest: paired
    # stage 2 reads the merged mates under the abort policy
    if args.on_bad_read != "abort" and not args.paired_files:
        ec_argv.extend(["--on-bad-read", args.on_bad_read])
    for flag, val in (("--min-count", args.min_count), ("--skip", args.skip),
                      ("--good", args.anchor),
                      ("--anchor-count", args.anchor_count),
                      ("--window", args.window), ("--error", args.error),
                      ("--homo-trim", args.homo_trim),
                      ("--contaminant", args.contaminant)):
        if val is not None:
            ec_argv.extend([flag, str(val)])
    if args.trim_contaminant:
        ec_argv.append("--trim-contaminant")
    if args.no_discard or args.paired_files:
        ec_argv.append("--no-discard")
    for flag, val in (("--metrics", m2), ("--profile", p2),
                      ("--trace-spans", ts2)):
        if val is not None:
            ec_argv.extend([flag, val])
    if m2 is not None:
        ec_argv.extend(["--metrics-interval", str(args.metrics_interval)])
    ec_argv.extend(_live_argv(args))
    if args.debug:
        ec_argv.append("-v")
        if args.paired_files:
            print(f"+ merge_mate_pairs {' '.join(args.reads)} | "
                  f"quorum_error_correct_reads {' '.join(ec_argv)} "
                  f"{db_file} /dev/fd/0 | split_mate_pairs {args.prefix}",
                  file=sys.stderr)
    ec_argv += ["-o", args.prefix, db_file] + list(args.reads)
    if args.debug and not args.paired_files:
        print("+ quorum_error_correct_reads " + " ".join(ec_argv),
              file=sys.stderr)
    # stage 2's batches: the RAM cache (drained as it goes, unless a
    # retry may need it again), else on a resume the on-disk capture,
    # else a parse of the FASTQ
    replay = None
    if host["keep"] and host["complete"] and cache:
        replay = ((lambda: iter(cache)) if args.stage_retries > 0
                  else (lambda: _drain(cache)))
    elif replay_store is not None:
        try:
            capture = replay_store.load(replay_identity)
        except ckpt_mod.CheckpointError as e:
            print(f"quorum: {e}", file=sys.stderr)
            return ckpt_mod.NON_RETRYABLE_RC
        if capture is not None:
            vlog("Resume: replaying ", capture.n_batches,
                 " cached batches from ", replay_store.dir,
                 " (no FASTQ re-parse)")
            reg.event("replay_cache_resume", n_batches=capture.n_batches)
            reg.set_meta(replay_cache_resumed=True)
            replay = capture.batches
    t_s2 = time.perf_counter()
    ec_stats: dict = {}

    def stage2_cursor():
        if not args.checkpoint_dir:
            return None
        return ckpt_mod.Stage2Journal(args.prefix).batches_done()

    def stage2_attempt(attempt: int) -> int:
        argv = list(ec_argv)
        if args.checkpoint_dir and (args.resume or attempt > 0):
            argv.append("--resume")
        # paired mode: merge | correct | split in process
        # (quorum.in:172-231), every read kept so that the split pairs
        # the mates again
        return ec_cli.main(argv, db=handoff.get("db"),
                           prepacked=replay() if replay else None,
                           records=(merge_records(args.reads)
                                    if args.paired_files else None),
                           report=ec_stats)

    rc = _run_stage_with_retries(reg, "error_correct", stage2_attempt,
                                 args.stage_retries, args.retry_backoff_ms,
                                 cursor_fn=stage2_cursor)
    if rc != 0:
        print("Error correction failed", file=sys.stderr)
        return rc if rc in (resources.DISK_FULL_RC,
                            resources.STALL_RC) else 1
    if replay_store is not None:
        # the corrected output is final: the capture is garbage now
        replay_store.clear()
    if args.paired_files:
        fa_path = args.prefix + ".fa"
        try:
            with open(fa_path, "r") as inp:
                split_stream(inp, args.prefix)
        except OSError as e:
            print(str(e), file=sys.stderr)
            return 1
        os.remove(fa_path)
    s2_s = time.perf_counter() - t_s2
    if reg.enabled:
        reg.gauge("stage2_seconds").set(round(s2_s, 3))
        reg.event("stage_done", stage="error_correct",
                  seconds=round(s2_s, 3))
    if report is not None:
        report.update(stage1_s=s1_s, stage2_s=s2_s,
                      stage1_host_s=times.get("produce_s", 0.0),
                      stage1_wait_s=times.get("wait_s", 0.0),
                      threads=threads, build=handoff.get("stats"),
                      ec=ec_stats.get("stats"))
    return 0


def _db_reusable(db_file: str, args, reg) -> bool:
    """The --resume reuse bar (quorum_tpu's): a readable database header
    whose geometry matches this run's flags and, for v5, digests that
    pass --verify-db. A foreign file, another k, or damage means a
    rebuild (the header does not record the input set: resuming over
    changed inputs is the operator's assertion, as with any --resume)."""
    try:
        h = db_format.read_header(db_file)
    except (OSError, ValueError):
        return False
    if h.get("key_len") != 2 * args.kmer_len or h.get("bits") != 7:
        print(f"quorum: --resume found {db_file} built with "
              f"k={h.get('key_len', 0) // 2}/bits={h.get('bits')} (this "
              f"run: k={args.kmer_len}/bits=7); rebuilding", file=sys.stderr)
        return False
    if h.get("version", 1) >= 5 and args.verify_db != "off":
        # the one place a damaged database is cured (rebuilt), not
        # refused
        try:
            db_format.verify_db_file(db_file, args.verify_db)
        except (OSError, ValueError) as e:
            print(f"quorum: --resume found {db_file} but it failed "
                  f"verification ({e}); rebuilding", file=sys.stderr)
            reg.event("integrity_error", file=db_file, detail=str(e))
            return False
    return True


if __name__ == "__main__":
    sys.exit(main())
