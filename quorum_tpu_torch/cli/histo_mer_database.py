"""histo_mer_database (port): the histogram of mer counts split by the
quality bit, counts capped at 1000 (counterpart of
quorum_tpu/cli/histo_mer_database.py; the reference's
src/histo_mer_database.cc:8-28, same output: ``<count> <n_lowqual>
<n_highqual>`` for each non-empty bin).

    python -m quorum_tpu_torch.cli.histo_mer_database db.jf
    python -m quorum_tpu_torch.cli.histo_mer_database --json h.json db.jf

The table is placed by HK7 on the card and binned there, and only the
bins come back (with --device cpu, the plain version places it and the
host bins it). `--json PATH` also writes
the bins as a schema-versioned document (quorum-tpu-histo/1) with
summary statistics, the fitted coverage mode among them, replaced
atomically. The observability flags of quorum_tpu's tool are refused
until the telemetry core is ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import resolve_device
from ..io import db_format, integrity
from ..ops import ctable
from .create_database import add_observability_args, refuse_unported

HLEN = 1001
# quorum_tpu/telemetry/schema.HISTO_SCHEMA
HISTO_SCHEMA = "quorum-tpu-histo/1"


def histo(vals) -> np.ndarray:
    """[HLEN, 2] bins of value words (count << 1 | qual; 0 = empty), the
    counts capped at HLEN - 1: one bincount where the words lie (a
    tensor on the card, or numpy), and only the bins come back."""
    if not isinstance(vals, torch.Tensor):
        vals = torch.from_numpy(np.asarray(vals, np.int64))
    v = vals.to(torch.int64)
    v = v[v != 0]
    bins = torch.bincount(torch.clamp(v >> 1, max=HLEN - 1) * 2 + (v & 1),
                          minlength=2 * HLEN)
    return bins.view(HLEN, 2).cpu().numpy()


def coverage_from_histo(bins) -> float:
    """The mean trusted-mer coverage fitted from histogram rows
    ``[count, n_lowqual, n_highqual]`` (quorum_tpu/telemetry/quality.py):
    the high-quality spectrum's mode past its first valley, where errors
    give way to real coverage. 0.0 where no valley exists."""
    hq: dict[int, int] = {}
    for row in bins or ():
        count, _low, high = int(row[0]), int(row[1]), int(row[2])
        if count > 0 and high > 0:
            hq[count] = hq.get(count, 0) + high
    if not hq:
        return 0.0
    xs = sorted(hq)
    valley = next((a for a, b in zip(xs, xs[1:]) if hq[b] > hq[a]), None)
    if valley is None:
        return 0.0
    past = [x for x in xs if x > valley]
    return float(max(past, key=lambda x: (hq[x], -x)))


def histo_doc(out: np.ndarray) -> dict:
    """The `--json` document of one histogram: the non-empty bins as
    rows, count ascending as on stdout, and the summary statistics."""
    bins = [[int(i), int(out[i, 0]), int(out[i, 1])]
            for i in range(out.shape[0]) if out[i, 0] or out[i, 1]]
    occupied = [row[0] for row in bins]
    return {
        "schema": HISTO_SCHEMA,
        "bins": bins,
        "stats": {
            "distinct_total": int(out.sum()),
            "distinct_nonempty": len(bins),
            "max_count": max(occupied) if occupied else 0,
            "coverage_mode": coverage_from_histo(bins),
        },
    }


def atomic_write(path: str, text: str) -> None:
    """Write `text` to a sibling file, fsync it and rename it over
    `path`: a reader never sees a torn document."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    integrity.fsync_dir(path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="histo_mer_database",
        description="Histogram of mer counts split by the quality bit.")
    add_observability_args(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the table is placed and binned on "
                        "the card) or cpu (on the host)")
    p.add_argument("--json", metavar="path", default=None,
                   help="Also write the histogram as a schema-versioned "
                        "JSON document (quorum-tpu-histo/1): bins as "
                        "[count, n_lowqual, n_highqual] rows plus summary "
                        "stats including the fitted coverage mode")
    p.add_argument("db", help="Mer database")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if refuse_unported(args, "histo_mer_database"):
        return 1
    try:
        state, meta, _header, _stats = db_format.load_db(
            args.db, device=resolve_device(args.device))
    except (RuntimeError, ValueError, OSError) as e:
        print(str(e), file=sys.stderr)
        return 1
    out = histo(ctable.slot_values(state.rows, meta))
    for i in range(HLEN):
        if out[i, 0] or out[i, 1]:
            print(f"{i} {out[i, 0]} {out[i, 1]}")
    if args.json:
        atomic_write(args.json, json.dumps(histo_doc(out), indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
