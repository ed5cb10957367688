"""quorum_error_correct_reads (port): the reference-named correction
flags of quorum_tpu's stage-2 CLI (-t -m -s -g -a -w -e -p -q -Q -d -M
--contaminant --trim-contaminant --homo-trim --apriori-error-rate
--poisson-threshold --gzip -o -v, same defaults) plus --presence-floor,
--batch-size, --verify-db, --devices, --render-workers, --on-bad-read,
--device, the telemetry flags (--metrics, --metrics-interval,
--trace-spans, --profile, --metrics-live) and crash safety's
(--checkpoint-every, --resume, --fault-plan, --preflight,
--stall-timeout-s).

    python -m quorum_tpu_torch.cli.error_correct_reads -p 4 db.jf \\
        reads.fastq -o corrected
    ... -o corrected --checkpoint-every 16 ...   # journaled; after a
                                                 # kill, add --resume

Exit codes as quorum_create_database's (cli/create_database.failure_rc):
3 a journal or database that cannot be used, 4 out of disk at the
output or the journal, 75 a stall.
"""

from __future__ import annotations

import argparse
import sys

from .. import resolve_device
from ..io import db_format
from ..io.fastq import BadReadPolicy
from ..models.ec_config import DEFAULT_QUAL_CUTOFF
from ..models.error_correct import ECOptions, run_error_correct
from ..utils import faults
from ..utils import vlog as vlog_mod
from .create_database import (add_devices_arg, failure_rc, refuse_unported,
                              resolve_devices_arg, routed_devices_ok)
from .observability import add_observability_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="quorum_error_correct_reads",
        description="Error correct reads from a fastq file based on the "
                    "k-mer frequencies.")
    p.add_argument("-t", "--thread", type=int, default=1,
                   help="Number of threads (host I/O; device is parallel)")
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
    p.add_argument("-o", "--output", default=None, metavar="prefix",
                   help="Output file prefix (default: stdout/stderr)")
    p.add_argument("--gzip", action="store_true", help="Gzip output file")
    p.add_argument("-M", "--no-mmap", action="store_true",
                   help="Do not memory map the input mer database")
    p.add_argument("--contaminant", metavar="path",
                   help="Contaminant sequences (fasta/fastq) or k-mer "
                        "database")
    p.add_argument("--trim-contaminant", action="store_true",
                   help="Trim reads containing contaminated k-mers instead "
                        "of discarding")
    p.add_argument("--homo-trim", type=int, default=None,
                   help="Trim homo-polymer run at the 3' end")
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
    p.add_argument("--presence-floor", type=int, default=0, metavar="N",
                   help="Treat mers with count < N as absent (0 = auto: a "
                        "prefiltered database applies its declared floor, "
                        "others keep every mer)")
    p.add_argument("--verify-db", choices=("full", "sample", "off"),
                   default="full",
                   help="Checksum verification of v5 databases at load")
    p.add_argument("--batch-size", type=int, default=8192,
                   help="Reads per device batch")
    p.add_argument("--render-workers", type=int, default=0, metavar="N",
                   help="Host finish/render workers behind a sequence-"
                        "numbered reorder stage (0 = auto, min(4, "
                        "cores)). Output is byte-identical for any N; "
                        "N > 1 hides the per-batch host tail behind "
                        "the device")
    p.add_argument("--on-bad-read",
                   choices=BadReadPolicy.MODES, default="abort",
                   help="Malformed-record policy: abort the run "
                        "(default), skip and count, or quarantine to "
                        "<prefix>.quarantine.fastq")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of "
                        "the kernels)")
    add_devices_arg(p, "Correct data-parallel (the table replicated, or "
                       "row-sharded past QUORUM_REPLICATE_TABLE_BYTES or "
                       "2^24 rows)")
    add_observability_args(p)
    p.add_argument("--checkpoint-every", metavar="batches", type=int,
                   default=0,
                   help="Journal completed batches every N batches: "
                        "output streams to <prefix>.fa/.log.partial "
                        "and a kill -> --resume run is byte-identical "
                        "to an uninterrupted one (needs -o, no "
                        "--gzip; 0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="Skip reads already journaled by an "
                        "interrupted --checkpoint-every run, then "
                        "finalize atomically (fresh start if no "
                        "journal)")
    faults.add_fault_args(p)
    p.add_argument("-v", "--verbose", action="store_true", help="Be verbose")
    p.add_argument("db", help="Mer database")
    p.add_argument("sequence", nargs="+", help="Input sequence")
    return p


def main(argv=None, db=None, prepacked=None, records=None,
         report: dict | None = None) -> int:
    """`db`/`prepacked`/`records`: the quorum driver's in-process
    handoff, replayed batches and merged mate pairs ((header, seq, qual)
    tuples read in place of the sequence files); `report` (optional
    dict) receives the ECStats."""
    args = build_parser().parse_args(argv)
    # OR, not assign: QUORUM_TPU_VERBOSE may have enabled it already
    vlog_mod.verbose = args.verbose or vlog_mod.verbose
    if args.qual_cutoff_char is not None and \
            args.qual_cutoff_value is not None:
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
        else DEFAULT_QUAL_CUTOFF)
    prog = "quorum_error_correct_reads"
    if refuse_unported(args, prog):
        return 1
    faults.setup(args.fault_plan)
    if not resolve_devices_arg(args, prog):
        return 1
    resolve_device(args.device)  # no card for --device cuda: raise here
    if args.devices > 1:
        try:
            rb = db_format.header_rb_log2(args.db)
        except (OSError, ValueError):
            rb = None  # the load reports it
        if rb is not None and not routed_devices_ok(args, prog, rb):
            return 1
    opts = ECOptions(output=args.output, cutoff=args.cutoff,
                     apriori_error_rate=args.apriori_error_rate,
                     poisson_threshold=args.poisson_threshold,
                     batch_size=args.batch_size, verify_db=args.verify_db,
                     device=args.device, presence_floor=args.presence_floor,
                     contaminant=args.contaminant, devices=args.devices,
                     threads=args.thread, render_workers=args.render_workers,
                     gzip=args.gzip, on_bad_read=args.on_bad_read,
                     no_mmap=args.no_mmap, metrics=args.metrics,
                     metrics_interval=args.metrics_interval,
                     metrics_port=args.metrics_port,
                     metrics_textfile=args.metrics_textfile,
                     metrics_force=args.metrics_live,
                     trace_spans=args.trace_spans, profile=args.profile,
                     checkpoint_every=args.checkpoint_every,
                     resume=args.resume, preflight=args.preflight,
                     stall_timeout_s=args.stall_timeout_s)
    try:
        stats = run_error_correct(args.db, args.sequence, opts,
                                  qual_cutoff=qual_cutoff, skip=args.skip,
                                  good=args.good,
                                  anchor_count=args.anchor_count,
                                  min_count=args.min_count,
                                  window=args.window, error=args.error,
                                  no_discard=args.no_discard,
                                  homo_trim=args.homo_trim,
                                  trim_contaminant=args.trim_contaminant,
                                  db=db, prepacked=prepacked,
                                  records=records)
    except (RuntimeError, ValueError, OSError) as e:
        print(str(e), file=sys.stderr)
        return failure_rc(e)
    if report is not None:
        report["stats"] = stats
    return 0


if __name__ == "__main__":
    sys.exit(main())
