"""merge_mate_pairs (port): interleave paired read files into one FASTQ
stream (counterpart of quorum_tpu/cli/merge_mate_pairs.py; the
reference's src/merge_mate_pairs.cc).

    python -m quorum_tpu_torch.cli.merge_mate_pairs r_1.fq r_2.fq > m.fq

Files are taken pairwise (the 1st with the 2nd, the 3rd with the 4th,
...) and their records emitted alternately, so that a corrector run
with --no-discard keeps the pairing. FASTA input gets a quality string
of '*' (merge_mate_pairs.cc:51-59); an odd number of files, or a pair
of unequal lengths, fails with the reference's message
(merge_mate_pairs.cc:80-85) and rc 1.
"""

from __future__ import annotations

import argparse
import itertools
import sys
from typing import Iterator, Sequence

from ..io import fastq


def merge_records(files: Sequence[str]) -> Iterator[tuple[str, bytes, bytes]]:
    """Records of each pair of files, alternating between the two."""
    if len(files) % 2 != 0:
        raise ValueError("Must give a even number files")
    for f_even, f_odd in zip(files[0::2], files[1::2]):
        for r_even, r_odd in itertools.zip_longest(
                fastq.iter_records([f_even]), fastq.iter_records([f_odd])):
            if r_even is None or r_odd is None:
                raise RuntimeError("Input files are not paired reads.")
            yield r_even
            yield r_odd


def write_fastq_record(out, rec: tuple[str, bytes, bytes]) -> None:
    header, seq, qual = rec
    qual_s = qual.decode() if qual else "*" * len(seq)
    out.write(f"@{header}\n{seq.decode()}\n+\n{qual_s}\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="merge_mate_pairs",
        description="Merge paired read files into one interleaved FASTQ "
                    "stream on stdout.")
    p.add_argument("-o", "--output", default=None,
                   help="Output file (default stdout)")
    p.add_argument("file", nargs="+", help="Paired input files")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = sys.stdout if args.output is None else open(args.output, "w")
    try:
        for rec in merge_records(args.file):
            write_fastq_record(out, rec)
    except (ValueError, RuntimeError, OSError) as e:
        print(str(e), file=sys.stderr)
        return 1
    finally:
        out.flush()
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
