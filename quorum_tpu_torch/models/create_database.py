"""Stage 1: build the quality-aware k-mer table from FASTQ reads
(counterpart of the single-device loop of
quorum_tpu/models/create_database.py:build_database and its two-pass
prefilter build, _build_two_pass).

Each batch crosses to the device as one packed wire buffer and HK1
counts every window straight into the tile build table. A batch that
meets a full 64-slot row reports its unplaced observations; the table
doubles (tile_grow_build) and exactly those observations re-insert, as
often as needed (the reference's "Hash is full" contract,
create_database.cc:87). HK2 seals the table at the end.

With a prefilter (ops/sketch) the inserts go through HK11 behind a
count-min sketch: `two-pass` streams the input once into the sketch
(HK9 + HK10) and once into the table; `inline` gates each batch on the
sketch as it goes. The grow loop is the same for every mode.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Iterable, Sequence

import torch

from .. import kernels
from ..io import db_format, fastq, packing
from ..ops import ctable
from ..ops import sketch as sketch_mod

MAX_GROWS = 16  # doublings one batch may ask for


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    k: int = 24
    bits: int = 7
    qual_thresh: int = 38  # ASCII code: base qual char >= this is "high"
    initial_size: int = 200_000_000
    batch_size: int = 8192
    db_version: int = 5
    device: str = "cuda"
    # the RESOLVED singleton-prefilter mode (ops/sketch.PREFILTER_MODES);
    # a non-off mode implies the stage-2 presence floor
    prefilter: str = "off"


@dataclasses.dataclass
class BuildStats:
    reads: int = 0
    bases: int = 0
    batches: int = 0
    grows: int = 0
    distinct: int = 0
    distinct_hq: int = 0
    total_hq: int = 0
    singletons: int = 0  # entries with exactly one observation
    seconds: float = 0.0
    # prefilter accounting (zero when the prefilter is off): dropped
    # observations, the false passes (single-observation entries that
    # passed the gate), and the FULL-table Poisson statistics (the
    # table's plus the dropped hq singletons' exact contribution), which
    # the header exports so stage 2 resolves the unfiltered cutoff
    prefilter_mode: str = "off"
    prefilter_dropped: int = 0
    prefilter_dropped_hq: int = 0
    prefilter_false_pass: int = 0
    sketch_cells_log2: int = 0
    sketch_seconds: float = 0.0
    poisson_distinct_hq: int = 0
    poisson_total_hq: int = 0

    def db_extra_header(self) -> dict | None:
        """The prefilter declaration and corrected Poisson statistics for
        the database header (quorum_tpu's BuildStats.db_extra_header);
        None for an unfiltered build."""
        if self.prefilter_mode == "off":
            return None
        return {
            "prefilter": {
                "mode": self.prefilter_mode,
                "min_obs": 2,
                "dropped": int(self.prefilter_dropped),
                "dropped_hq": int(self.prefilter_dropped_hq),
                "false_pass": int(self.prefilter_false_pass),
                "sketch_cells_log2": int(self.sketch_cells_log2),
            },
            "poisson_stats": {
                "distinct_hq": int(self.poisson_distinct_hq),
                "total_hq": int(self.poisson_total_hq),
            },
        }


def default_batches(paths: Sequence[str], cfg: BuildConfig):
    """(ReadBatch, PackedReads) pairs packed with the stage-1 plane."""
    for b in fastq.read_batches(paths, cfg.batch_size):
        yield b, packing.pack_reads(b.codes, b.quals, b.lengths,
                                    thresholds=(cfg.qual_thresh,))


def _wires(batches: Iterable, cfg: BuildConfig, device, stats=None):
    """(PackedReads, wire on `device`) per batch; counts reads, bases
    and batches into `stats` when given."""
    for batch, pk in batches:
        pk.require_plane(cfg.qual_thresh)
        if stats is not None:
            stats.batches += 1
            stats.reads += batch.n
            stats.bases += int(batch.lengths.sum())
        yield pk, torch.from_numpy(pk.to_wire()).to(device)


def _insert_pass(wires, meta, bstate, stats: BuildStats, insert: Callable):
    """Insert every batch with `insert(bstate, meta, pk, wire)` -> (full,
    (keys, qual) left over, dropped_hq, dropped_lq); on a full row the
    table doubles and the leftovers re-insert, as often as needed.
    Returns the final (bstate, meta)."""
    for pk, wire in wires:
        full, (keys, qual), d_hq, d_lq = insert(bstate, meta, pk, wire)
        stats.prefilter_dropped += d_hq + d_lq
        stats.prefilter_dropped_hq += d_hq
        for _ in range(MAX_GROWS + 1):
            if not full:
                break
            print(f"Hash table full at {meta.rows} buckets; doubling",
                  file=sys.stderr)
            bstate, meta = ctable.tile_grow_build(bstate, meta)
            stats.grows += 1
            keys, qual = ctable.tile_insert_pending(bstate, meta, keys, qual)
            full = keys.numel() > 0
        else:
            if full:
                raise RuntimeError("Hash is full")
    return bstate, meta


def build_database(paths: Sequence[str], cfg: BuildConfig,
                   device: torch.device,
                   batches_factory: Callable[[], Iterable] | None = None):
    """Run stage 1. Returns (TileState, TileMeta, BuildStats).
    `batches_factory` overrides the disk reader: each call returns a
    FRESH iterable of (ReadBatch, PackedReads) pairs whose planes include
    cfg.qual_thresh (the quorum driver shares one parse between both
    stages). One pass calls it once; the two-pass prefilter calls it
    twice, and the first call's pass counts reads and bases."""
    if cfg.prefilter not in sketch_mod.PREFILTER_MODES:
        raise ValueError(f"unknown prefilter mode {cfg.prefilter!r} "
                         f"(one of {sketch_mod.PREFILTER_MODES})")
    t0 = time.perf_counter()
    meta = ctable.TileMeta(k=cfg.k, bits=cfg.bits, rb_log2=ctable.tile_rb_for(
        cfg.initial_size, cfg.k, cfg.bits))
    bstate = ctable.make_tile_build(meta, device)
    stats = BuildStats(prefilter_mode=cfg.prefilter)
    if batches_factory is None:
        def batches_factory():
            return default_batches(paths, cfg)
    sk = smeta = None
    if cfg.prefilter != "off":
        smeta = sketch_mod.SketchMeta(
            sketch_mod.cells_log2_for(cfg.initial_size))
        sk = sketch_mod.make_sketch(smeta, device)
        stats.sketch_cells_log2 = smeta.cells_log2

    if cfg.prefilter == "off":
        def insert(bs, m, pk, wire):
            full, left = kernels.tile_insert_reads(
                bs, m, wire, pk.n_reads, pk.length, pk.thresholds,
                cfg.qual_thresh)
            return full, left, 0, 0
    else:
        def insert(bs, m, pk, wire):
            return sketch_mod.tile_insert_reads_packed_gated(
                bs, m, sk, smeta, pk, wire, cfg.qual_thresh, cfg.prefilter)

    if cfg.prefilter == "two-pass":
        # pass 1: every batch into the sketch only
        t_sk = time.perf_counter()
        for pk, wire in _wires(batches_factory(), cfg, device, stats):
            sketch_mod.sketch_update_packed(sk, smeta, cfg.k, pk, wire,
                                            cfg.qual_thresh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats.sketch_seconds = time.perf_counter() - t_sk
        wires = _wires(batches_factory(), cfg, device)
    else:
        wires = _wires(batches_factory(), cfg, device, stats)
    bstate, meta = _insert_pass(wires, meta, bstate, stats, insert)
    del sk
    state, dup, occ, distinct, total, singles = ctable.tile_seal(bstate, meta)
    del bstate
    if dup:
        raise RuntimeError("internal error: duplicate tag pair in a bucket")
    stats.distinct, stats.distinct_hq, stats.total_hq = occ, distinct, total
    stats.singletons = singles
    if cfg.prefilter != "off":
        # before the seal, single-observation entries are the sketch's
        # false passes; each dropped hq singleton would have been one
        # distinct hq mer of count 1 in the full table
        stats.prefilter_false_pass = singles
        stats.poisson_distinct_hq = distinct + stats.prefilter_dropped_hq
        stats.poisson_total_hq = total + stats.prefilter_dropped_hq
    stats.seconds = time.perf_counter() - t0
    return state, meta, stats


def create_database_main(paths: Sequence[str], output: str, cfg: BuildConfig,
                         cmdline: list[str] | None = None,
                         handoff: dict | None = None,
                         batches_factory: Callable[[], Iterable] | None = None
                         ) -> BuildStats:
    """Build, write the database file, and with `handoff` (a dict) keep
    the device-resident table as handoff["db"] = (state, meta, stats)
    for an in-process stage 2."""
    from .. import resolve_device

    device = resolve_device(cfg.device)
    state, meta, stats = build_database(paths, cfg, device, batches_factory)
    db_format.write_db(output, state, meta, cmdline, n_entries=stats.distinct,
                       db_version=cfg.db_version,
                       extra_header=stats.db_extra_header())
    if handoff is not None:
        handoff["db"] = (state, meta, stats)
    return stats
