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

With --partitions P (a power of two) the table is built in P sequential
passes over the input (quorum_tpu's _build_database_partitioned), each
into a table of 1/P the rows: pass p counts only the mers whose hash
remainder's low log2 P bits equal p (HK1's or HK11's partition filter),
then seals (HK2), rebases its rows onto the global geometry (HK13) and
exports them as shard p of a sharded database (HK6), and the sealed
manifest commits last. Peak table memory falls by about P and the
reassembled payload is the single-pass build's byte for byte. A pass
whose table fills restarts every pass at twice the rows: growing inside
a pass would move the partition bits.

With --devices N (a power of two) the table is sharded by leading row
bits over N devices (parallel/tile_sharded, quorum_tpu's
_build_database_sharded without its checkpoints): each shard routes
its row range of every batch to the owners of its mers (HK15), each
owner counts what it receives (HK1's shard entry), a full row doubles
every shard (HK8's shard entry), and HK2 seals each shard. The shards
concatenate to the one-card table, so the payload is the same. With
--partitions P as well, every pass is such a sharded build of 1/P the
rows through HK15's partition entry (quorum_tpu's
_run_partition_pass_sharded); its sealed plane is gathered on the lead
device, rebased (HK13) and exported as the pass's shard, as on one card.
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
from ..ops.ctable import MAX_GROWS

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
    # "single" (one file) or "sharded" (shard files under a sealed
    # manifest, io/db_format); partitions > 1 implies sharded
    db_layout: str = "single"
    # P sequential passes, each counting 1/P of the mers into a table of
    # 1/P the rows (a power of two in [1, 256])
    partitions: int = 1
    # shards by leading row bits over this many devices (a power of two)
    devices: int = 1


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
    # --devices N: entries per shard
    shard_occupancy: list = dataclasses.field(default_factory=list)

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


class _PartitionGrew(Exception):
    """A partition pass filled its table: every pass restarts at
    `rb_local` (growing inside a pass would change which remainder bits
    pick the partition)."""

    def __init__(self, rb_local: int):
        super().__init__(f"partition pass needs rb_local={rb_local}")
        self.rb_local = rb_local


def _check_config(cfg: BuildConfig) -> None:
    if cfg.prefilter not in sketch_mod.PREFILTER_MODES:
        raise ValueError(f"unknown prefilter mode {cfg.prefilter!r} "
                         f"(one of {sketch_mod.PREFILTER_MODES})")
    if cfg.db_layout not in db_format.DB_LAYOUTS:
        raise ValueError(f"unknown db layout {cfg.db_layout!r} "
                         f"(one of {db_format.DB_LAYOUTS})")
    P = cfg.partitions
    if P < 1 or P > 256 or P & (P - 1):
        raise ValueError(f"--partitions must be a power of two in "
                         f"[1, 256], got {P}")
    if P > 1 and cfg.prefilter == "inline":
        raise ValueError(
            "--prefilter=inline does not compose with --partitions "
            "(the online sketch is not pass-stable); use two-pass")
    D = cfg.devices
    if D < 1 or D & (D - 1):
        raise ValueError(f"--devices must be a power of two (leading-bit "
                         f"shard layout), got {D}")
    if D > 1 and cfg.prefilter != "off":
        raise ValueError(
            "--prefilter composes with --devices 1 today; use "
            "--partitions for multi-pass capacity over a mesh")


def _sketch_pass(factory, cfg: BuildConfig, device, stats: BuildStats):
    """Pass 1 of the two-pass prefilter: every batch into a fresh sketch
    (HK9 + HK10); counts reads, bases and batches. Returns (sketch,
    its meta)."""
    smeta = sketch_mod.SketchMeta(sketch_mod.cells_log2_for(cfg.initial_size))
    sk = sketch_mod.make_sketch(smeta, device)
    stats.sketch_cells_log2 = smeta.cells_log2
    t_sk = time.perf_counter()
    for pk, wire in _wires(factory(), cfg, device, stats):
        sketch_mod.sketch_update_packed(sk, smeta, cfg.k, pk, wire,
                                        cfg.qual_thresh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats.sketch_seconds = time.perf_counter() - t_sk
    return sk, smeta


def build_database(paths: Sequence[str], cfg: BuildConfig,
                   device: torch.device,
                   batches_factory: Callable[[], Iterable] | None = None,
                   mesh: list | None = None):
    """Run stage 1. Returns (TileState, TileMeta, BuildStats).
    `batches_factory` overrides the disk reader: each call returns a
    FRESH iterable of (ReadBatch, PackedReads) pairs whose planes include
    cfg.qual_thresh (the quorum driver shares one parse between both
    stages). One pass calls it once; the two-pass prefilter calls it
    twice, and the first call's pass counts reads and bases. `mesh`
    (cfg.devices > 1) names the shards' devices; by default the first
    cfg.devices devices of `device`'s type (tile_sharded.make_mesh)."""
    _check_config(cfg)
    if cfg.partitions > 1:
        raise ValueError(
            "partitioned builds stream their export per pass — run "
            "them through create_database_main, not build_database")
    t0 = time.perf_counter()
    if batches_factory is None:
        def batches_factory():
            return default_batches(paths, cfg)
    if cfg.devices > 1:
        return _build_sharded(cfg, device, batches_factory, t0, mesh)
    meta = ctable.TileMeta(k=cfg.k, bits=cfg.bits, rb_log2=ctable.tile_rb_for(
        cfg.initial_size, cfg.k, cfg.bits))
    bstate = ctable.make_tile_build(meta, device)
    stats = BuildStats(prefilter_mode=cfg.prefilter)
    sk = smeta = None
    if cfg.prefilter == "inline":
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
        sk, smeta = _sketch_pass(batches_factory, cfg, device, stats)
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


def _build_sharded(cfg: BuildConfig, device: torch.device,
                   batches_factory: Callable[[], Iterable], t0: float,
                   mesh: list | None):
    """Stage 1 over a mesh of cfg.devices devices (quorum_tpu's
    _build_database_sharded without checkpoints). Returns
    (ShardedTileState, TileShardedMeta, BuildStats)."""
    from ..parallel import tile_sharded as ts

    S = cfg.devices
    if mesh is None:
        mesh = ts.make_mesh(S, device=device)
    if len(mesh) != S:
        raise ValueError(f"a mesh of {len(mesh)} devices for --devices {S}")
    meta = ts.TileShardedMeta(
        k=cfg.k, bits=cfg.bits, n_shards=S,
        rb_log2=ts.initial_rb(cfg.initial_size, cfg.k, cfg.bits, S))
    bstate = ts.make_build_state(meta, mesh)
    stats = BuildStats()
    for batch, pk in batches_factory():
        stats.batches += 1
        stats.reads += batch.n
        stats.bases += int(batch.lengths.sum())
        bstate, meta, grows = ts.build_step_wire(bstate, meta, mesh, pk,
                                                 cfg.qual_thresh)
        stats.grows += grows
    state, seal = ts.finalize(bstate, meta, mesh)
    del bstate
    if int(seal[:, 0].sum()):
        raise RuntimeError("internal error: duplicate tag pair in a bucket")
    stats.distinct, stats.distinct_hq, stats.total_hq, stats.singletons = (
        int(x) for x in seal[:, 1:].sum(0))
    stats.shard_occupancy = ts.shard_occupancy(seal)
    stats.seconds = time.perf_counter() - t0
    return state, meta, stats


def _pass_table(factory, cfg: BuildConfig, device, stats: BuildStats,
                rb_local: int, p: int, sk, smeta):
    """Pass `p` of a partitioned build on one device: insert the mers it
    owns (HK1, or HK11 behind the finished sketch) into a table of
    2^rb_local rows and seal it (HK2). Returns (the sealed TileState,
    its TileMeta, (occupied, distinct_hq, total_hq, singletons)).
    Raises _PartitionGrew on a full row."""
    P = cfg.partitions
    lmeta = ctable.TileMeta(k=cfg.k, bits=cfg.bits, rb_log2=rb_local)
    bstate = ctable.make_tile_build(lmeta, device)
    count = stats if stats.batches == 0 else None
    for pk, wire in _wires(factory(), cfg, device, count):
        if sk is None:
            full, _left = kernels.tile_insert_reads(
                bstate, lmeta, wire, pk.n_reads, pk.length, pk.thresholds,
                cfg.qual_thresh, p, P)
        else:
            full, _left, d_hq, d_lq = sketch_mod.tile_insert_reads_packed_gated(
                bstate, lmeta, sk, smeta, pk, wire, cfg.qual_thresh,
                "two-pass", p, P)
            stats.prefilter_dropped += d_hq + d_lq
            stats.prefilter_dropped_hq += d_hq
        if full:
            if rb_local >= 24:
                raise RuntimeError("Hash is full")
            raise _PartitionGrew(rb_local + 1)
    state, dup, occ, distinct, total, singles = ctable.tile_seal(bstate, lmeta)
    del bstate
    if dup:
        raise RuntimeError("internal error: duplicate tag pair in a bucket")
    return state, lmeta, (occ, distinct, total, singles)


def _pass_table_sharded(factory, cfg: BuildConfig, mesh, stats: BuildStats,
                        rb_local: int, p: int):
    """Pass `p` of a partitioned build over the mesh (quorum_tpu's
    _run_partition_pass_sharded): the sharded build of 2^rb_local global
    rows with HK15's partition entry routing only the pass's mers, each
    shard sealed (HK2), then gathered on the lead device (no copy where
    the mesh names one device). Returns as _pass_table; a full row
    raises _PartitionGrew."""
    from ..parallel import tile_sharded as ts

    S, P = cfg.devices, cfg.partitions
    lmeta = ts.TileShardedMeta(k=cfg.k, bits=cfg.bits, rb_log2=rb_local,
                               n_shards=S)
    bstate = ts.make_build_state(lmeta, mesh)
    count = stats.batches == 0
    for batch, pk in factory():
        if count:
            stats.batches += 1
            stats.reads += batch.n
            stats.bases += int(batch.lengths.sum())
        try:
            bstate, lmeta, _g = ts.build_step_wire(
                bstate, lmeta, mesh, pk, cfg.qual_thresh, p, P)
        except ts.PassFull:
            if rb_local >= 24 + lmeta.owner_bits:
                raise RuntimeError("Hash is full") from None
            raise _PartitionGrew(rb_local + 1) from None
    state, seal = ts.finalize(bstate, lmeta, mesh)
    del bstate
    if int(seal[:, 0].sum()):
        raise RuntimeError("internal error: duplicate tag pair in a bucket")
    gstate, gmeta = ts.gather_table(state, lmeta)
    del state
    return gstate, gmeta, tuple(int(x) for x in seal[:, 1:].sum(0))


def _build_partitioned(paths: Sequence[str], cfg: BuildConfig, output: str,
                       device: torch.device,
                       batches_factory: Callable[[], Iterable] | None,
                       cmdline: list[str] | None,
                       mesh: list | None = None) -> BuildStats:
    """The partitioned multi-pass build (quorum_tpu's
    _build_database_partitioned, without its checkpoint cursor): P
    passes, each rebased onto the global geometry (HK13) and exported
    as shard p of it as it finishes, then the sealed manifest at
    `output`. Each pass runs on one device or, with cfg.devices > 1,
    over the mesh (`mesh`, by default the first cfg.devices devices of
    `device`'s type). With two-pass the sketch pass runs once and
    survives geometry restarts. Returns the BuildStats; no table stays
    on the card."""
    _check_config(cfg)
    t0 = time.perf_counter()
    P, S = cfg.partitions, cfg.devices
    g = P.bit_length() - 1
    owner_bits = S.bit_length() - 1
    rb_req = ctable.tile_rb_for(cfg.initial_size, cfg.k, cfg.bits)
    rb_local = min(24 + owner_bits,
                   max(rb_req - g, ctable.min_tile_rb_log2(cfg.k, cfg.bits),
                       4 + owner_bits))
    stats = BuildStats(prefilter_mode=cfg.prefilter)
    if batches_factory is None:
        def batches_factory():
            return default_batches(paths, cfg)
    if S > 1 and mesh is None:
        from ..parallel import tile_sharded as ts

        mesh = ts.make_mesh(S, device=device)
    sk = smeta = None
    if cfg.prefilter == "two-pass":
        sk, smeta = _sketch_pass(batches_factory, cfg, device, stats)
    for _ in range(MAX_GROWS + 1):
        gmeta = ctable.GlobalMeta(k=cfg.k, bits=cfg.bits, rb_log2=rb_local + g)
        recs = []
        try:
            for p in range(P):
                if S > 1:
                    state, lmeta, (occ, distinct, total, singles) = \
                        _pass_table_sharded(batches_factory, cfg, mesh,
                                            stats, rb_local, p)
                else:
                    state, lmeta, (occ, distinct, total, singles) = \
                        _pass_table(batches_factory, cfg, device, stats,
                                    rb_local, p, sk, smeta)
                with kernels.device_scope(state.rows.device):
                    state, bad = ctable.tile_departition_rows(state, lmeta,
                                                              g, p)
                    if bad:
                        raise RuntimeError("internal error: partition pass "
                                           "counted a mer outside its bin")
                    recs.append(db_format.write_db_shard_file(
                        output, state.rows, gmeta, p, P, cmdline,
                        cfg.db_version, n_entries=occ))
                del state
                stats.distinct += occ
                stats.poisson_distinct_hq += distinct
                stats.poisson_total_hq += total
                stats.singletons += singles
                if sk is not None:
                    stats.prefilter_false_pass += singles
            break
        except _PartitionGrew as e:
            print(f"Partition pass overflowed at local rb_log2={rb_local}; "
                  f"restarting all passes at {e.rb_local}", file=sys.stderr)
            stats.grows += 1
            for field in ("distinct", "poisson_distinct_hq", "poisson_total_hq",
                          "singletons", "prefilter_dropped",
                          "prefilter_dropped_hq", "prefilter_false_pass",
                          "reads", "bases", "batches"):
                setattr(stats, field, 0)
            rb_local = e.rb_local
    else:
        raise RuntimeError("Hash is full")
    del sk
    stats.distinct_hq = stats.poisson_distinct_hq
    stats.total_hq = stats.poisson_total_hq
    if smeta is not None:
        # each dropped hq singleton would have been one distinct hq mer
        # of count 1 in the full table
        stats.poisson_distinct_hq += stats.prefilter_dropped_hq
        stats.poisson_total_hq += stats.prefilter_dropped_hq
    db_format.write_db_manifest(output, recs, gmeta, P, cmdline,
                                cfg.db_version, stats.db_extra_header())
    stats.seconds = time.perf_counter() - t0
    return stats


def create_database_main(paths: Sequence[str], output: str, cfg: BuildConfig,
                         cmdline: list[str] | None = None,
                         handoff: dict | None = None,
                         batches_factory: Callable[[], Iterable] | None = None,
                         mesh: list | None = None) -> BuildStats:
    """Build and write the database (one file, or a sharded manifest
    with --db-layout sharded or --partitions P). With `handoff` (a
    dict) the BuildStats go to handoff["stats"], and a single-pass
    build keeps its device-resident table as handoff["db"] = (state,
    meta, stats) for an in-process stage 2; a partitioned build never
    holds the whole table, so its stage 2 loads the manifest. A
    --devices N build writes one shard file per shard (sharded layout)
    or its table gathered onto the lead device (single)."""
    from .. import resolve_device

    device = resolve_device(cfg.device)
    if cfg.partitions > 1:
        stats = _build_partitioned(paths, cfg, output, device,
                                   batches_factory, cmdline, mesh)
    else:
        state, meta, stats = build_database(paths, cfg, device,
                                            batches_factory, mesh)
        if cfg.devices > 1 and cfg.db_layout == "single":
            from ..parallel import tile_sharded as ts

            whole, wmeta = ts.gather_table(state, meta)
            db_format.write_db(output, whole, wmeta, cmdline,
                               n_entries=stats.distinct,
                               db_version=cfg.db_version)
            del whole
        elif cfg.db_layout == "sharded":
            db_format.write_db_sharded(
                output, state, meta, cmdline, db_version=cfg.db_version,
                extra_header=stats.db_extra_header(),
                n_entries=stats.shard_occupancy or [stats.distinct])
        else:
            db_format.write_db(output, state, meta, cmdline,
                               n_entries=stats.distinct,
                               db_version=cfg.db_version,
                               extra_header=stats.db_extra_header())
        if handoff is not None:
            handoff["db"] = (state, meta, stats)
    if handoff is not None:
        handoff["stats"] = stats
    return stats
