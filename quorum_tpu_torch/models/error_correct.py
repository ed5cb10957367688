"""Stage 2 as a program: FASTQ in, corrected FASTA + skip log out
(counterpart of quorum_tpu/models/error_correct.py, in-order loop).

Output contract (byte-compatible with the reference):
  * `.fa` record: ``>header fwd_log bwd_log\\nseq\\n``;
  * `.log` record per skipped read: ``Skipped <header>: <reason>\\n``;
  * `--no-discard`: skipped reads also emit ``>header\\nN\\n``;
  * `-o PREFIX` writes PREFIX.fa / PREFIX.log, else stdout / stderr.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Iterable, Sequence

from ..io import contaminant as contaminant_mod
from ..io import db_format, fastq, packing
from ..ops import ctable
from ..ops.poisson import compute_poisson_cutoff
from .corrector import correct_batch_packed, finish_batch, make_keep_table
from .ec_config import DEFAULT_QUAL_CUTOFF, ECConfig


def render_result(hdr: str, r, cfg: ECConfig) -> tuple[str, str]:
    """One read's `.fa` and `.log` text (error_correct_reads.cc
    :246-341)."""
    if r.ok:
        return f">{hdr} {r.fwd_log} {r.bwd_log}\n{r.seq}\n", ""
    fa = f">{hdr}\nN\n" if cfg.no_discard else ""
    return fa, f"Skipped {hdr}: {r.error}\n"


@dataclasses.dataclass
class ECStats:
    reads: int = 0
    corrected: int = 0
    skipped: int = 0
    bases_in: int = 0
    bases_out: int = 0
    cutoff: int = 0
    presence_floor: int = 1
    host_s: float = 0.0    # parse, pack, finish and render
    device_s: float = 0.0  # H2D + correction until the result is ready


@dataclasses.dataclass(frozen=True)
class ECOptions:
    output: str | None = None  # -o prefix; None = stdout/stderr
    cutoff: int | None = None  # -p; None = compute from the table
    apriori_error_rate: float = 0.01
    poisson_threshold: float = 1e-6
    batch_size: int = 8192
    verify_db: str = "full"
    device: str = "cuda"
    # --presence-floor: entries with count < N are absent (0 = the
    # database's declared prefilter floor, else none)
    presence_floor: int = 0
    # --contaminant: sequences or a mer database (io/contaminant)
    contaminant: str | None = None
    # --devices N: correct each batch's reads in N row ranges, one a
    # device, against the table replicated on each or, past the
    # replicated layout, row-sharded over them (parallel/tile_sharded)
    devices: int = 1


def resolve_cutoff(opts: ECOptions, stats: tuple[int, int],
                   header: dict | None = None) -> int:
    """-p, or compute_poisson_cutoff over (distinct_hq, total_hq) with
    the reference's parameterization (error_correct_reads.cc:710-717):
    the header's full-table `poisson_stats` where a prefiltered build
    declared them, else the table's own statistics (the build's or the
    load's). 0 = failed."""
    if opts.cutoff is not None:
        return opts.cutoff
    ps = (header or {}).get("poisson_stats")
    distinct, total = ((ps["distinct_hq"], ps["total_hq"]) if ps
                       else stats)
    return compute_poisson_cutoff(
        int(distinct), int(total), opts.apriori_error_rate / 3.0,
        opts.poisson_threshold / opts.apriori_error_rate)


def run_error_correct(db_path: str, sequences: Sequence[str],
                      opts: ECOptions, qual_cutoff: int = DEFAULT_QUAL_CUTOFF,
                      skip: int = 1, good: int = 2, anchor_count: int = 3,
                      min_count: int = 1, window: int = 10, error: int = 3,
                      no_discard: bool = False, homo_trim: int | None = None,
                      trim_contaminant: bool = False, db=None,
                      prepacked: Iterable | None = None,
                      mesh: list | None = None,
                      event_driven: bool = True) -> ECStats:
    """Run stage 2. `db` is an in-process handoff (state, meta, build
    stats) that skips reading the database file; `prepacked` replays
    (ReadBatch, PackedReads) pairs packed with the qual_cutoff plane
    instead of parsing `sequences` again. A handed-off table is floored
    in place. With opts.devices > 1 the batches are corrected over a
    mesh of that many devices (a --devices N build hands off its
    row-sharded table): `mesh`, or by default the first opts.devices
    devices of opts.device's type, in the layout
    tile_sharded.ShardedCorrector picks; a file whose table takes the
    routed layout loads row-sharded onto the mesh (one HK7 launch a
    shard), any other onto the lead device. A row-sharded table
    corrected on one device is gathered onto the lead shard's device
    first. `event_driven=False` is a measurement hook that the JAX
    package's run_error_correct lacks: the plain walk
    (corrector.correct_batch), for chip_smoke.py's plain-mode stage 2
    beside the event mode on the same entry point. The CLIs never pass
    it and run event mode, as the JAX package's do."""
    from .. import resolve_device
    from ..parallel import tile_sharded as ts

    device = resolve_device(opts.device)
    devices = opts.devices
    if devices > 1:
        if opts.batch_size % devices:
            raise RuntimeError(
                f"--batch-size {opts.batch_size} is not divisible by "
                f"--devices {devices}; round it up")
        if mesh is None:
            mesh = ts.make_mesh(devices, device=device)
    if db is not None:
        # the header fields the build wrote into the file
        state, meta, bstats = db
        table_stats = (bstats.distinct_hq, bstats.total_hq)
        header = bstats.db_extra_header() or {}
    else:
        rb = db_format.header_rb_log2(db_path)
        on_mesh = devices > 1 and rb is not None and ts.routed_layout(rb)
        state, meta, header, (_occ, distinct, total) = db_format.load_db(
            db_path, device=device, verify=opts.verify_db,
            mesh=mesh if on_mesh else None)
        table_stats = (distinct, total)
    if devices == 1 and isinstance(state, ctable.ShardedTileState):
        state, meta = ts.gather_table(state, meta)
    cutoff = resolve_cutoff(opts, table_stats, header)
    if cutoff == 0 and opts.cutoff is None:
        raise RuntimeError(
            "Cutoff computation failed. Pass it explicitly with -p switch.")
    # presence floor: the flag, else the database's prefilter
    # declaration, else none. After the cutoff (a full-table statistic
    # either way) and before the first probe, so a prefiltered table and
    # the floored full table are the same corrector input.
    floor = opts.presence_floor
    if floor <= 0:
        floor = int((header.get("prefilter") or {}).get("min_obs", 1))
    if isinstance(state, ctable.ShardedTileState):
        state = ts.floor(state, meta, floor)
    else:
        state = ctable.tile_floor(state, meta, floor)
    cfg = ECConfig(k=meta.k, skip=skip, good=good,
                   anchor_count=anchor_count, min_count=min_count,
                   cutoff=cutoff, qual_cutoff=qual_cutoff, window=window,
                   error=error, homo_trim=homo_trim,
                   trim_contaminant=trim_contaminant, no_discard=no_discard,
                   collision_prob=opts.apriori_error_rate / 3.0,
                   poisson_threshold=opts.poisson_threshold)
    contam = None
    if opts.contaminant is not None:
        contam = contaminant_mod.load_contaminant(opts.contaminant, cfg.k,
                                                  device)
    if devices > 1:
        correct = ts.ShardedCorrector(mesh, state, meta, cfg, contam,
                                      event_driven=event_driven)
    else:
        mesh = [device]
        keep = make_keep_table(meta, cfg, device)

        def correct(pk):
            return correct_batch_packed(state, meta, pk, cfg, keep, contam,
                                        event_driven)
    stats = ECStats(cutoff=cutoff, presence_floor=floor)
    if prepacked is None:
        prepacked = ((b, packing.pack_reads(b.codes, b.quals, b.lengths,
                                            thresholds=(qual_cutoff,)))
                     for b in fastq.read_batches(sequences, opts.batch_size))
    out = open(opts.output + ".fa", "w") if opts.output else sys.stdout
    log = open(opts.output + ".log", "w") if opts.output else sys.stderr
    try:
        it = iter(prepacked)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            if item is None:
                break
            batch, pk = item
            t1 = time.perf_counter()
            res = correct(pk)
            ts.synchronize(mesh)
            t2 = time.perf_counter()
            results = finish_batch(res, batch.n, batch.codes, cfg)
            fa_parts, log_parts = [], []
            for hdr, r in zip(batch.headers, results):
                fa, lg = render_result(hdr, r, cfg)
                if r.ok:
                    stats.corrected += 1
                    stats.bases_out += r.end - r.start
                else:
                    stats.skipped += 1
                fa_parts.append(fa)
                log_parts.append(lg)
            out.write("".join(fa_parts))
            log.write("".join(log_parts))
            stats.reads += batch.n
            stats.bases_in += int(batch.lengths[:batch.n].sum())
            stats.device_s += t2 - t1
            stats.host_s += (t1 - t0) + (time.perf_counter() - t2)
    finally:
        for f in (out, log):
            if f is sys.stdout or f is sys.stderr:
                f.flush()
            else:
                f.close()
    return stats
