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
atomically. `--metrics` records `distinct_mers`, `nonempty_bins`,
`max_count` and, with --json, `coverage_mode`, as quorum_tpu's tool
does; `--profile` traces the load and the binning.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import resolve_device
from ..io import db_format
from ..ops import ctable
from ..telemetry import atomic_write
from ..telemetry.quality import coverage_from_histo
from ..utils.profiling import trace
from .create_database import refuse_unported
from .observability import add_observability_args, observability

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
    with observability(args.metrics, args.metrics_interval,
                       live=args.metrics_live, trace_spans=args.trace_spans,
                       profile=args.profile,
                       stage="histo_mer_database") as obs:
        reg, tracer = obs.registry, obs.tracer
        try:
            device = resolve_device(args.device)
            with trace(args.profile, device):
                with tracer.span("load_db"):
                    state, meta, _header, _stats = db_format.load_db(
                        args.db, device=device)
                reg.set_meta(db=args.db, k=meta.k)
                with tracer.span("histogram"):
                    out = histo(ctable.slot_values(state.rows, meta))
        except (RuntimeError, ValueError, OSError) as e:
            print(str(e), file=sys.stderr)
            obs.status = "error"
            return 1
        nonempty = 0
        for i in range(HLEN):
            if out[i, 0] or out[i, 1]:
                print(f"{i} {out[i, 0]} {out[i, 1]}")
                nonempty += 1
        if args.json:
            doc = histo_doc(out)
            atomic_write(args.json, json.dumps(doc, indent=1) + "\n")
            if reg.enabled:
                reg.set_meta(histo_json=args.json)
                reg.gauge("coverage_mode").set(
                    doc["stats"]["coverage_mode"])
        if reg.enabled:
            reg.counter("distinct_mers").inc(int(out.sum()))
            reg.gauge("nonempty_bins").set(nonempty)
            occupied = np.nonzero(out.sum(axis=1))[0]
            reg.gauge("max_count").set(
                int(occupied.max()) if occupied.size else 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
