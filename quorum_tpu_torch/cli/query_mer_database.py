"""query_mer_database (port): print the count and quality bit of each
given mer (counterpart of quorum_tpu/cli/query_mer_database.py; the
reference's src/query_mer_database.cc:7-24, same output).

    python -m quorum_tpu_torch.cli.query_mer_database db.jf ACGTACGTACGTA

The table is placed by HK7 on the card and every mer looked up there in
one HK3 launch; with --device cpu it is placed by the plain version and
each mer looked up in host memory, as quorum_tpu's tool does. The first
line is k, then one ``mer:canonical val:N qual:Q`` line a mer; a mer of
the wrong length is reported on stderr.
`--metrics` records `mers_queried`, `mers_found` and `mers_bad_length`,
as quorum_tpu's tool does; `--profile` traces the load and the lookups.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import kernels, resolve_device
from ..io import db_format
from ..ops import mer
from ..utils.profiling import trace
from .create_database import refuse_unported
from .observability import add_observability_args, observability


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="query_mer_database",
        description="Print count and quality flag for the given mers.")
    add_observability_args(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the table is placed and every mer "
                        "looked up on the card) or cpu (on the host)")
    p.add_argument("db", help="Mer database")
    p.add_argument("mers", nargs="+", metavar="mer",
                   help="Mers to look up")
    return p


def lookup_values(state, meta, keys: list[int]) -> list[int]:
    """The value word of each canonical mer (int): on a card one HK3
    launch for them all, on the host each looked up in the rows as
    quorum_tpu's tool does (db_lookup_np)."""
    if not state.rows.is_cuda:
        return [db_format.db_lookup_np(state, meta, key >> 32,
                                       key & 0xFFFFFFFF) for key in keys]
    if not keys:
        return []
    keys = torch.tensor(keys, dtype=torch.int64, device=state.rows.device)
    return kernels.tile_lookup(state.rows, meta, keys).tolist()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if refuse_unported(args, "query_mer_database"):
        return 1
    with observability(args.metrics, args.metrics_interval,
                       port=args.metrics_port,
                       textfile=args.metrics_textfile,
                       live=args.metrics_live, trace_spans=args.trace_spans,
                       profile=args.profile,
                       stage="query_mer_database") as obs:
        reg, tracer = obs.registry, obs.tracer
        try:
            device = resolve_device(args.device)
            with trace(args.profile, device):
                rc = _query(args, device, reg, tracer)
        except (RuntimeError, ValueError, OSError) as e:
            print(str(e), file=sys.stderr)
            obs.status = "error"
            return 1
    return rc


def _query(args, device, reg, tracer) -> int:
    with tracer.span("load_db"):
        state, meta, _header, _stats = db_format.load_db(args.db,
                                                         device=device)
    k = meta.k
    reg.set_meta(db=args.db, k=k)
    print(k)
    asked = []
    for s in args.mers:
        if len(s) != k:
            print(f"{s}: wrong length (k={k})", file=sys.stderr)
            reg.counter("mers_bad_length").inc()
            continue
        hi, lo = mer.pack_kmer(s)
        asked.append((s, *mer.canonical_py(hi, lo, k)))
    with tracer.span("query", mers=len(asked)):
        vals = lookup_values(state, meta,
                             [(chi << 32) | clo for _s, chi, clo in asked])
    for (s, chi, clo), v in zip(asked, vals):
        print(f"{s}:{mer.unpack_kmer(chi, clo, k)} val:{v >> 1} "
              f"qual:{v & 1}")
        reg.counter("mers_queried").inc()
        if v >> 1 > 0:
            reg.counter("mers_found").inc()
    return 0


if __name__ == "__main__":
    sys.exit(main())
