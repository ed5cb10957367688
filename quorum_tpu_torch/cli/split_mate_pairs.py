"""split_mate_pairs (port): de-interleave a corrected FASTA stream into
<prefix>_1.fa and <prefix>_2.fa (counterpart of
quorum_tpu/cli/split_mate_pairs.py; the reference's
src/split_mate_pairs.cc).

    python -m quorum_tpu_torch.cli.split_mate_pairs -i out.fa out

Records are two lines (header, sequence), written alternately to the
two files; the input is stdin unless -i names a file.
"""

from __future__ import annotations

import argparse
import sys


def split_stream(inp, prefix: str) -> None:
    with open(prefix + "_1.fa", "w") as out1, \
            open(prefix + "_2.fa", "w") as out2:
        outs = (out1, out2)
        first = True
        while True:
            header = inp.readline()
            if not header:
                break
            seq = inp.readline()
            outs[0 if first else 1].write(header.rstrip("\r\n") + "\n"
                                          + seq.rstrip("\r\n") + "\n")
            first = not first


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="split_mate_pairs",
        description="Split an interleaved corrected FASTA stream into "
                    "<prefix>_1.fa and <prefix>_2.fa.")
    p.add_argument("-i", "--input", default=None,
                   help="Input file (default stdin)")
    p.add_argument("prefix", help="Output prefix")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    inp = sys.stdin if args.input is None else open(args.input, "r")
    try:
        split_stream(inp, args.prefix)
    except OSError as e:
        print(str(e), file=sys.stderr)
        return 1
    finally:
        if inp is not sys.stdin:
            inp.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
