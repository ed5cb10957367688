"""quorum_create_database (port): flags -s -m -b -q/-Q -o -t -p
--ref-format --db-version --db-layout --batch-size --prefilter
--partitions --devices --on-bad-read --device -v, the telemetry flags
(--metrics, --metrics-interval, --trace-spans, --profile,
--metrics-live), and crash safety's (--checkpoint-dir,
--checkpoint-every, --resume, --fault-plan, --preflight,
--stall-timeout-s), as the reference CLI
(src/create_database_cmdline.yaggo) and quorum_tpu's stage-1 CLI.

    python -m quorum_tpu_torch.cli.create_database -s 64k -m 13 -b 7 \\
        -q 38 -o db.jf reads.fastq
    ... --ref-format ...           # the reference's binary/quorum_db
    ... --prefilter two-pass ...   # drop singletons; declares floor 2
    ... --partitions 4 ...         # 4 passes at 1/4 the table memory;
                                   # db.jf is a manifest over 4 shards
    ... --devices 2 ...            # the table sharded over 2 cards
    ... --partitions 4 --devices 2 # each pass sharded over 2 cards
    ... --checkpoint-dir ck        # snapshots every 64 batches; after
                                   # a kill, the same command with
                                   # --resume goes on from the last

Exit codes: 0 done; 1 failed; 3 (io/checkpoint.NON_RETRYABLE_RC) a
checkpoint or database that cannot be used (corrupt, or another run's);
4 (utils/resources.DISK_FULL_RC) out of disk at the database or a strict
preflight; 75 (utils/resources.STALL_RC) the stall watchdog aborted the
build (a retry resumes from the checkpoint).
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import resolve_device
from ..io.checkpoint import NON_RETRYABLE_RC, CheckpointError
from ..io.fastq import BadReadPolicy
from ..io.integrity import IntegrityError
from ..models.create_database import BuildConfig, create_database_main
from ..ops.sketch import PREFILTER_MODES, prefilter_default
from ..parallel import tile_sharded as ts
from ..utils import faults, resources
from ..utils import vlog as vlog_mod
from ..utils.sizes import parse_size
from .observability import (UNPORTED_OBSERVABILITY, add_observability_args,
                            observability)

# quorum_tpu's flags whose paths are not ported yet: accepted by the
# parser so that a run that asks for them is refused with a reason
UNPORTED = {
    "coordinator": "--coordinator (the multi-host fleet, ROADMAP Queue 1 "
                   "item 9)",
    "num_processes": "--num-processes (the multi-host fleet, ROADMAP "
                     "Queue 1 item 9)",
    "process_id": "--process-id (the multi-host fleet, ROADMAP Queue 1 "
                  "item 9)",
    **UNPORTED_OBSERVABILITY,
}


# why a path runs on one device only (quorum_tpu refuses it over a mesh
# too)
PREFILTER_ON_ONE = ("--prefilter composes with --devices 1 today; use "
                    "--partitions for multi-pass capacity over a mesh")


def add_devices_arg(p: argparse.ArgumentParser, what: str) -> None:
    """--devices as quorum_tpu spells it (default auto)."""
    p.add_argument("--devices", default="auto", metavar="N",
                   help=f"{what} over N local devices (power of two; 'all' "
                        "= every CUDA device, 'auto' = all CUDA devices, or "
                        "1 with --device cpu, where an explicit N runs N "
                        "shards on the CPU; auto and all go on with one "
                        "device, with a note, where the mesh cannot run: "
                        "--prefilter, or a table past the replicated "
                        "stage-2 layout on cards without peer access that "
                        "one card can hold). Output is byte-identical to "
                        "--devices 1")


def resolve_devices_arg(args, prog: str) -> bool:
    """Resolve args.devices (and round args.batch_size up to a multiple
    of it) with quorum_tpu's messages; False, after printing why, where
    the count is not usable. Sets args.devices_auto: the count came from
    auto/all, not from the user."""
    args.devices_auto = not ts.explicit_devices(args.devices)
    try:
        args.devices, args.batch_size = ts.resolve_devices_and_batch(
            args.devices, args.batch_size, prog, device=args.device)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return False
    return True


def one_device_for(args, prog: str, why: str) -> bool:
    """args.devices is N > 1 on a path that runs on one device only
    (`why`). With auto/all, note it and go on with args.devices = 1
    (True); an explicit N is the caller's to refuse (False)."""
    if not args.devices_auto:
        return False
    print(f"{prog}: {why}; --devices auto goes on with one device "
          f"instead of {args.devices}", file=sys.stderr)
    args.devices = 1
    return True


def routed_devices_ok(args, prog: str, rb_log2: int) -> bool:
    """Whether --devices N can correct a table of 2^rb_log2 rows. Where
    it takes the routed stage-2 layout (tile_sharded.routed_layout) on
    CUDA devices that lack peer access between them (peer_reason), an
    explicit N is refused and auto/all go on with one device (a note)
    if one card can hold the table (rb_log2 <= 24); False, after
    printing why, where the run cannot go on."""
    if args.devices <= 1 or not ts.routed_layout(rb_log2) \
            or torch.device(args.device).type != "cuda":
        return True
    why = ts.peer_reason(ts.make_mesh(args.devices))
    if why is None or (rb_log2 <= 24 and one_device_for(args, prog, why)):
        return True
    print(f"{prog}: {why}", file=sys.stderr)
    return False


def failure_rc(e: BaseException) -> int:
    """The exit code of a stage that failed with `e` (quorum_tpu's
    mapping, which the driver's retries read): 4 for a full disk or a
    strict preflight and 75 for a stall (both ResourceExhausted /
    StallError), 3 for an artifact that cannot be used (CheckpointError,
    IntegrityError); the driver retries neither 3 nor 4. Else 1."""
    if isinstance(e, resources.ResourceExhausted):
        return resources.DISK_FULL_RC
    if isinstance(e, resources.StallError):
        return resources.STALL_RC
    if isinstance(e, (CheckpointError, IntegrityError)):
        return NON_RETRYABLE_RC
    return 1


def add_unported_args(p: argparse.ArgumentParser) -> None:
    """The flags of UNPORTED, as quorum_tpu spells them;
    refuse_unported() turns any use into an error."""
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=None,
                   help=argparse.SUPPRESS)


def refuse_unported(args, prog: str) -> bool:
    """Print why and return True if `args` ask for a path the port does
    not have yet."""
    asked = [flag for dest, flag in UNPORTED.items()
             if getattr(args, dest, None) not in (None, False)]
    for flag in asked:
        print(f"{prog}: {flag} is not ported to quorum_tpu_torch yet",
              file=sys.stderr)
    return bool(asked)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="quorum_create_database",
        description="Create database of k-mers for quorum error corrector")
    p.add_argument("-s", "--size", required=True,
                   help="Initial hash size (suffix k/M/G/T ok)")
    p.add_argument("-m", "--mer", required=True, type=int, help="Mer length")
    p.add_argument("-b", "--bits", required=True, type=int,
                   help="Bits for value field")
    p.add_argument("-q", "--min-qual-value", type=int,
                   help="Min quality as an int")
    p.add_argument("-Q", "--min-qual-char",
                   help="Min quality as a ASCII character")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="Number of threads (host I/O; device is parallel)")
    p.add_argument("-o", "--output", default="combined_database",
                   help="Output file")
    p.add_argument("-p", "--reprobe", type=int, default=126,
                   help="Maximum number of reprobes (of a --ref-format "
                        "file's open addressing)")
    p.add_argument("--ref-format", action="store_true",
                   help="Write the reference's binary/quorum_db format "
                        "instead of the native format")
    p.add_argument("--db-version", type=int, choices=(4, 5), default=5,
                   help="Export version: 5 (default) carries CRC32C "
                        "digests, 4 is the bare layout (same payload)")
    p.add_argument("--db-layout", choices=("single", "sharded"),
                   default="single",
                   help="On-disk layout: single (default) writes one file; "
                        "sharded writes <output>.shard-K-of-S.qdb files "
                        "under a sealed manifest at <output> (same payload "
                        "bytes; implied by --partitions P > 1)")
    p.add_argument("--batch-size", type=int, default=8192,
                   help="Reads per device batch")
    p.add_argument("--partitions", type=int, default=1, metavar="P",
                   help="Build the table in P sequential passes over the "
                        "input (a power of two <= 256), each counting one "
                        "disjoint leading-bit row range at 1/P the table "
                        "memory and exporting it as one shard of the "
                        "sharded manifest; the reassembled payload is a "
                        "single-pass build's")
    p.add_argument("--prefilter", choices=("auto",) + PREFILTER_MODES,
                   default="auto",
                   help="Singleton prefilter: two-pass streams the input "
                        "once into a count-min sketch, then inserts only "
                        "mers seen >= 2 times (exact); inline gates inserts "
                        "behind the sketch as it goes (a count may be off "
                        "by one). The database declares a presence floor of "
                        "2, which stage 2 applies. auto = QUORUM_PREFILTER "
                        "env, else off")
    p.add_argument("--on-bad-read",
                   choices=BadReadPolicy.MODES, default="abort",
                   help="Malformed-record policy: abort the run "
                        "(default), skip and count, or quarantine to "
                        "<output>.quarantine.fastq")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of "
                        "the kernels)")
    add_devices_arg(p, "Build the table sharded by leading row bits")
    add_observability_args(p)
    p.add_argument("--checkpoint-dir", metavar="dir", default=None,
                   help="Write atomic snapshots of the counting table "
                        "(plus the input batch cursor) here; a killed "
                        "run restarted with --resume continues from "
                        "the last one")
    p.add_argument("--checkpoint-every", metavar="batches", type=int,
                   default=64,
                   help="Batches between snapshots (default 64; each "
                        "snapshot syncs the device)")
    p.add_argument("--resume", action="store_true",
                   help="Continue from the last valid checkpoint in "
                        "--checkpoint-dir (fresh start if none)")
    faults.add_fault_args(p)
    add_unported_args(p)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("reads", nargs="+", help="Read files")
    return p


def main(argv=None, handoff: dict | None = None,
         batches_factory=None) -> int:
    """`handoff`, `batches_factory`: the quorum driver's in-process table
    handoff and shared parse (models/create_database.build_database)."""
    args = build_parser().parse_args(argv)
    # OR, not assign: QUORUM_TPU_VERBOSE may have enabled it already
    vlog_mod.verbose = args.verbose or vlog_mod.verbose
    if args.min_qual_value is None and args.min_qual_char is None:
        print("Either a min-qual-value or min-qual-char must be provided.",
              file=sys.stderr)
        return 1
    if args.min_qual_char is not None and len(args.min_qual_char) != 1:
        print("The min-qual-char should be one ASCII character.",
              file=sys.stderr)
        return 1
    if not 1 <= args.bits <= 30:
        print("The number of bits should be between 1 and 30",
              file=sys.stderr)
        return 1
    if not 1 <= args.mer <= 31:
        print("Mer length must be between 1 and 31", file=sys.stderr)
        return 1
    if refuse_unported(args, "quorum_create_database"):
        return 1
    faults.setup(args.fault_plan)
    if not resolve_devices_arg(args, "quorum_create_database"):
        return 1
    resolve_device(args.device)  # no card for --device cuda: raise here
    P = args.partitions
    if P < 1 or P > 256 or (P & (P - 1)):
        print(f"--partitions must be a power of two in [1, 256], "
              f"got {P}", file=sys.stderr)
        return 1
    auto = args.prefilter == "auto"
    prefilter = prefilter_default() if auto else args.prefilter
    prog = "quorum_create_database"
    if not auto and prefilter != "off" and args.devices > 1 and \
            not one_device_for(args, prog, PREFILTER_ON_ONE):
        print(PREFILTER_ON_ONE, file=sys.stderr)
        return 1
    if prefilter != "off" and args.devices > 1:
        # a default from the environment degrades; only the flag refuses
        print(f"Prefilter default {prefilter} does not compose with "
              f"--devices {args.devices}; running unfiltered",
              file=sys.stderr)
        prefilter = "off"
    if prefilter == "inline" and (P > 1 or args.checkpoint_dir):
        if not auto:
            print("--prefilter=inline supports neither --partitions "
                  "nor --checkpoint-dir (the online sketch is "
                  "neither pass-stable nor snapshotted); use "
                  "--prefilter=two-pass", file=sys.stderr)
            return 1
        # a default from the environment degrades; only the flag refuses
        print("Prefilter default inline does not compose with "
              "--partitions/--checkpoint-dir; running unfiltered",
              file=sys.stderr)
        prefilter = "off"
    if args.ref_format and (P > 1 or prefilter != "off"):
        print("--ref-format supports neither --partitions nor "
              "--prefilter", file=sys.stderr)
        return 1
    cfg = BuildConfig(
        k=args.mer, bits=args.bits,
        qual_thresh=(ord(args.min_qual_char) if args.min_qual_char
                     is not None else args.min_qual_value),
        initial_size=parse_size(args.size), batch_size=args.batch_size,
        db_version=args.db_version, device=args.device, prefilter=prefilter,
        # the partitioned export IS the sharded manifest
        db_layout="sharded" if P > 1 else args.db_layout, partitions=P,
        devices=args.devices, threads=args.threads,
        on_bad_read=args.on_bad_read, max_reprobe=args.reprobe,
        quarantine_path=(args.output + ".quarantine.fastq"
                         if args.on_bad_read == "quarantine" else None),
        profile=args.profile, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume)
    # a failed run (a missing reads file, a full hash) still lands its
    # document, stamped status=error; the resource guards watch the
    # output, checkpoint and metrics filesystems
    watch = [p for p in (args.output, args.checkpoint_dir, args.metrics)
             if p]
    rc = 0
    with observability(args.metrics, args.metrics_interval,
                       port=args.metrics_port,
                       textfile=args.metrics_textfile,
                       live=args.metrics_live, trace_spans=args.trace_spans,
                       profile=args.profile, watch_paths=watch,
                       stall_timeout_s=args.stall_timeout_s) as obs:
        try:
            # the disk preflight, before any parse or device work: an
            # export that cannot fit refuses in seconds, not hours
            resources.preflight(
                args.preflight,
                resources.estimate_stage1_needs(
                    args.output, cfg.initial_size, cfg.k, cfg.bits,
                    checkpoint_dir=cfg.checkpoint_dir,
                    partitions=cfg.partitions))
            create_database_main(args.reads, args.output, cfg,
                                 cmdline=list(sys.argv), handoff=handoff,
                                 batches_factory=batches_factory,
                                 ref_format=args.ref_format,
                                 metrics=obs.registry, tracer=obs.tracer)
            obs.registry.set_meta(output=args.output)
        except (RuntimeError, OSError, ValueError) as e:
            rc = failure_rc(e)
            if rc == 1 and resources.is_enospc(e):
                # a bare ENOSPC out of stage 1 is the database export
                # (every optional writer degrades in place): required
                resources.fail_required("db.payload", e, path=args.output)
                rc = resources.DISK_FULL_RC
            print(str(e), file=sys.stderr)
            obs.status = "error"
    return rc


if __name__ == "__main__":
    sys.exit(main())
