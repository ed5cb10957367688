"""quorum_create_database (port): flags -s -m -b -q/-Q -o -t
--db-version --batch-size --prefilter --device, as the reference CLI
(src/create_database_cmdline.yaggo) and quorum_tpu's stage-1 CLI.

    python -m quorum_tpu_torch.cli.create_database -s 64k -m 13 -b 7 \\
        -q 38 -o db.jf reads.fastq
    ... --prefilter two-pass ...   # drop singletons; declares floor 2
"""

from __future__ import annotations

import argparse
import sys

from .. import resolve_device
from ..models.create_database import BuildConfig, create_database_main
from ..ops.sketch import PREFILTER_MODES, prefilter_default

_SUFFIX = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}


def parse_size(s: str) -> int:
    """Size with an optional decimal k/M/G/T suffix."""
    s = s.strip()
    if s and s[-1] in _SUFFIX:
        return int(s[:-1]) * _SUFFIX[s[-1]]
    return int(s)


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
                   help="Number of threads (accepted; the parse runs on one)")
    p.add_argument("-o", "--output", default="combined_database",
                   help="Output file")
    p.add_argument("--db-version", type=int, choices=(4, 5), default=5,
                   help="Export version: 5 (default) carries CRC32C "
                        "digests, 4 is the bare layout (same payload)")
    p.add_argument("--batch-size", type=int, default=8192,
                   help="Reads per device batch")
    p.add_argument("--prefilter", choices=("auto",) + PREFILTER_MODES,
                   default="auto",
                   help="Singleton prefilter: two-pass streams the input "
                        "once into a count-min sketch, then inserts only "
                        "mers seen >= 2 times (exact); inline gates inserts "
                        "behind the sketch as it goes (a count may be off "
                        "by one). The database declares a presence floor of "
                        "2, which stage 2 applies. auto = QUORUM_PREFILTER "
                        "env, else off")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of "
                        "the kernels)")
    p.add_argument("reads", nargs="+", help="Read files")
    return p


def main(argv=None, handoff: dict | None = None,
         batches_factory=None) -> int:
    """`handoff`, `batches_factory`: the quorum driver's in-process table
    handoff and shared parse (models/create_database.build_database)."""
    args = build_parser().parse_args(argv)
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
    resolve_device(args.device)  # no card for --device cuda: raise here
    cfg = BuildConfig(
        k=args.mer, bits=args.bits,
        qual_thresh=(ord(args.min_qual_char) if args.min_qual_char
                     is not None else args.min_qual_value),
        initial_size=parse_size(args.size), batch_size=args.batch_size,
        db_version=args.db_version, device=args.device,
        prefilter=(prefilter_default() if args.prefilter == "auto"
                   else args.prefilter))
    try:
        create_database_main(args.reads, args.output, cfg,
                             cmdline=list(sys.argv), handoff=handoff,
                             batches_factory=batches_factory)
    except (RuntimeError, OSError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
