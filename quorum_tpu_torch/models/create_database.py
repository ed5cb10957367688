"""Stage 1: build the quality-aware k-mer table from FASTQ reads
(counterpart of the single-device loop of
quorum_tpu/models/create_database.py:build_database and its two-pass
prefilter build, _build_two_pass).

Each batch crosses to the device as one packed wire buffer and HK1
counts every window straight into the tile build table. A batch that
meets a full 64-slot row reports its unplaced observations; the table
doubles (tile_grow_build) and exactly those observations re-insert, as
often as needed (the reference's "Hash is full" contract,
create_database.cc:87). HK2 seals the table at the end. The reads are
parsed (cfg.threads workers, the native parser where it serves) and
packed on a producer thread ahead of the main thread, which makes every
CUDA call (default_batches).

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
_build_database_sharded): each shard routes
its row range of every batch to the owners of its mers (HK15), each
owner counts what it receives (HK1's shard entry), a full row doubles
every shard (HK8's shard entry), and HK2 seals each shard. The shards
concatenate to the one-card table, so the payload is the same. With
--partitions P as well, every pass is such a sharded build of 1/P the
rows through HK15's partition entry (quorum_tpu's
_run_partition_pass_sharded); its sealed plane is gathered on the lead
device, rebased (HK13) and exported as the pass's shard, as on one card.

Crash safety (quorum_tpu's checkpoints, io/checkpoint, the same
formats): with BuildConfig.checkpoint_dir a one-card build snapshots its
build table every checkpoint_every resolved batches (Stage1Checkpoint),
a --devices N build every shard under one manifest
(Stage1ShardedCheckpoint), a partitioned build commits a cursor after
each pass (Stage1PartitionCursor) and the two-pass prefilter its
finished sketch (SketchCheckpoint); with `resume` the build reloads the
last valid artifact and skips what it covers (the first `cursor`
batches go by on the consumer side, with no insert). Every insert
passes the `stage1.insert` fault site and the stall watchdog's beat
(utils/faults, utils/resources). A finished build clears its artifacts.
The inline prefilter does not checkpoint (its sketch is not
snapshotted).

Telemetry (`metrics`, `tracer`: cli/observability) follows quorum_tpu's
names: the reads, bases, batches and distinct-mer counters, the hash
geometry and fill gauges, grow events, the per-batch `insert_dispatch_us`
/ `insert_wait_us` histograms, the prefilter and partition counters, the
`stage1` timer table, and the spans `stage1_batch`, `stage1_insert` (a
device step), `hash_grow`, `seal`, `sketch_batch`, `stage1_sketch` and
`checkpoint`, the counters `checkpoint_writes_total` and
`resume_skipped_reads`, the `resume` and `checkpoint` events and
`meta.resumed` / `meta.resumed_from_batch`.
With BuildConfig.profile the whole stage (build, seal, export) runs
under utils/profiling.trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Iterable, Sequence

import torch

from .. import kernels
from ..io import checkpoint as ckpt_mod
from ..io import db_format, fastq, packing, quorum_db
from ..ops import ctable
from ..ops import sketch as sketch_mod
from ..ops.ctable import MAX_GROWS
from ..telemetry import NULL, NULL_TRACER, observe_dispatch_wait
from ..utils import faults, resources
from ..utils.pipeline import prefetch
from ..utils.profiling import StageTimer, trace
from ..utils.vlog import vlog

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
    threads: int = 1  # -t: parse workers (several files, or spans)
    on_bad_read: str = "abort"  # abort, skip or quarantine
    quarantine_path: str | None = None  # where quarantine mode writes
    # -p: the reprobe limit of a --ref-format file's open addressing
    max_reprobe: int = 126
    profile: str | None = None  # --profile DIR: a torch.profiler trace
    # crash safety: snapshots of the build in checkpoint_dir every
    # checkpoint_every batches; resume continues from the last valid one
    checkpoint_dir: str | None = None
    checkpoint_every: int = 64
    resume: bool = False


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
    # the first pass's producer thread: parse + pack seconds, and the
    # main thread's seconds blocked on its queue (default reader only)
    parse_pack_s: float = 0.0
    queue_wait_s: float = 0.0

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


def default_batches(paths: Sequence[str], cfg: BuildConfig,
                    quiet: bool = False, times: dict | None = None,
                    reg=NULL, tracer=NULL_TRACER):
    """(ReadBatch, PackedReads) pairs packed with the stage-1 plane, read
    with cfg.threads parse workers and packed on a producer thread
    (utils/pipeline.prefetch), ahead of the main thread's H2D. `quiet`
    marks a repeat pass of a multi-pass build: a skip or quarantine
    policy becomes a silent skip (the same batches, no second
    quarantine write) and nothing is recorded. `times` receives the
    producer's seconds (prefetch); `reg` and `tracer` the bad-read
    counter and the producer's gauges and spans."""
    policy = None
    if cfg.on_bad_read != "abort":
        if quiet:
            policy = fastq.BadReadPolicy("skip")
        else:
            policy = fastq.BadReadPolicy(cfg.on_bad_read,
                                         cfg.quarantine_path,
                                         reg if reg.enabled else None)
            reg.counter("bad_reads_total")  # lands even at 0
            reg.set_meta(on_bad_read=cfg.on_bad_read)

    def pack(src):
        for b in src:
            pk = packing.pack_reads(b.codes, b.quals, b.lengths,
                                    thresholds=(cfg.qual_thresh,))
            pk.to_wire()  # build the fused buffer off the main thread
            yield b, pk

    src = fastq.read_batches(paths, cfg.batch_size, threads=cfg.threads,
                             policy=policy)
    return prefetch(pack(src), times=times,
                    metrics=reg if reg.enabled and not quiet else None,
                    tracer=tracer if not quiet else None)


def default_factory(paths: Sequence[str], cfg: BuildConfig, times: dict,
                    reg=NULL, tracer=NULL_TRACER):
    """A batches factory over the input files: the first call reads with
    cfg's bad-read policy, times its producer into `times` and records
    into `reg` and `tracer`; every later call (a repeat pass) reads
    quietly."""
    calls = {"n": 0}

    def factory():
        first = calls["n"] == 0
        calls["n"] += 1
        return default_batches(paths, cfg, quiet=not first,
                               times=times if first else None,
                               reg=reg, tracer=tracer)
    return factory


def _stamp_times(stats: BuildStats, times: dict) -> None:
    stats.parse_pack_s = times.get("produce_s", 0.0)
    stats.queue_wait_s = times.get("wait_s", 0.0)


class _Tele:
    """One stage-1 run's telemetry: the registry, the span tracer, the
    stage timer and the running step number (unique across the passes
    of a multi-pass build, so each step window is one batch)."""

    def __init__(self, reg=None, tracer=None):
        self.reg = reg if reg is not None else NULL
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.timer = StageTimer()
        self.step = 0

    def batch(self, stats: "BuildStats", n_reads: int, bases: int,
              **extra):
        """Enter one batch: heartbeat, and its `stage1_batch` span.
        Returns (the span, the batch's step number)."""
        step = self.step
        self.step += 1
        self.timer.add_units("insert_wait", bases)
        self.reg.heartbeat(stage="create_database", reads=stats.reads,
                           bases=stats.bases, batches=stats.batches,
                           **extra)
        return self.tracer.span("stage1_batch", step=step, reads=n_reads,
                                **extra), step

    @contextlib.contextmanager
    def device_step(self, step: int, n_reads: int, name: str = "stage1_insert",
                    prefix: str = "insert"):
        """One batch's device step: its `name` step span and its
        `<prefix>_dispatch_us` / `_wait_us` split. The wrappers read
        their flags back (insert) or do not wait (sketch), so the
        dispatch holds all of it."""
        t0 = time.perf_counter()
        with self.tracer.step(name, step, reads=n_reads):
            yield
        t1 = time.perf_counter()
        observe_dispatch_wait(self.reg, prefix, t0, t1, t1, timer=self.timer)

    def finish(self, stats: "BuildStats", rows: int,
               distinct: bool = True) -> None:
        """The end-of-build counters, geometry gauges and timer table
        (`distinct`: count distinct_mers here; a sharded build's
        record_shard_metrics counts it)."""
        self.timer.report(stats.bases)
        reg = self.reg
        if not reg.enabled:
            return
        reg.counter("reads").inc(stats.reads)
        reg.counter("bases").inc(stats.bases)
        reg.counter("batches").inc(stats.batches)
        if distinct:
            reg.counter("distinct_mers").inc(stats.distinct)
        slots = rows * ctable.TSLOTS
        reg.gauge("hash_buckets").set(rows)
        reg.gauge("hash_slots").set(slots)
        reg.gauge("hash_fill").set(round(stats.distinct / slots, 6))
        reg.set_timer("stage1", self.timer.as_dict(stats.bases))


def _wires(batches: Iterable, cfg: BuildConfig, device, stats=None,
           skip: int = 0, reg=NULL):
    """(PackedReads, wire on `device`, bases) per batch; counts reads,
    bases and batches into `stats` when given. The first `skip` batches
    (a resumed build's, counted before the kill) go by on the consumer
    side with no copy to the device, their reads counted in `reg`'s
    `resume_skipped_reads`."""
    for batch, pk in batches:
        if skip > 0:
            skip -= 1
            reg.counter("resume_skipped_reads").inc(batch.n)
            continue
        pk.require_plane(cfg.qual_thresh)
        nb = int(batch.lengths.sum())
        if stats is not None:
            stats.batches += 1
            stats.reads += batch.n
            stats.bases += nb
        yield pk, torch.from_numpy(pk.to_wire()).to(device), nb


def _grow(tele: _Tele, bstate, meta, stats: BuildStats):
    """Double a full table (HK8), recorded."""
    rows_before = meta.rows
    vlog("Hash table full at ", rows_before, " buckets; doubling")
    with tele.timer.stage("grow"), tele.tracer.span(
            "hash_grow", rows_before=rows_before):
        bstate, meta = ctable.tile_grow_build(bstate, meta)
    stats.grows += 1
    tele.reg.counter("hash_grows").inc()
    tele.reg.event("hash_grow", rows_before=rows_before,
                   rows_after=meta.rows)
    return bstate, meta


def _dropped(tele: _Tele, stats: BuildStats, d_hq: int, d_lq: int):
    stats.prefilter_dropped += d_hq + d_lq
    stats.prefilter_dropped_hq += d_hq
    if d_hq or d_lq:
        tele.reg.counter("prefilter_dropped_total").inc(d_hq + d_lq)


def _insert_pass(wires, meta, bstate, stats: BuildStats, insert: Callable,
                 tele: _Tele, step0: int = 0, snapshot=None):
    """Insert every batch with `insert(bstate, meta, pk, wire)` -> (full,
    (keys, qual) left over, dropped_hq, dropped_lq); on a full row the
    table doubles and the leftovers re-insert, as often as needed. Batch
    i (numbered from `step0`, a resumed build's cursor) passes the
    `stage1.insert` fault site and the watchdog's beat first;
    `snapshot(bstate, meta)` runs after each batch is resolved. Returns
    the final (bstate, meta)."""
    for n, (pk, wire, nb) in enumerate(wires):
        faults.inject("stage1.insert", batch=step0 + n)
        resources.watchdog_beat("stage1.insert", step0 + n)
        span, step = tele.batch(stats, pk.n_reads, nb)
        with span:
            with tele.device_step(step, pk.n_reads):
                full, (keys, qual), d_hq, d_lq = insert(bstate, meta, pk,
                                                        wire)
            _dropped(tele, stats, d_hq, d_lq)
            for _ in range(MAX_GROWS + 1):
                if not full:
                    break
                bstate, meta = _grow(tele, bstate, meta, stats)
                keys, qual = ctable.tile_insert_pending(bstate, meta, keys,
                                                        qual)
                full = keys.numel() > 0
            else:
                if full:
                    raise RuntimeError("Hash is full")
        if snapshot is not None:
            snapshot(bstate, meta)
    return bstate, meta


def _snapshotter(ck, cfg: BuildConfig, paths, stats: BuildStats,
                 tele: _Tele):
    """The per-batch snapshot hook of a checkpointed build (None
    without one): every cfg.checkpoint_every resolved batches, `ck`
    saves the table and the batch cursor. The device-to-host copy is
    the sync point: a batch whose insert has not finished is never
    counted."""
    tele.reg.counter("checkpoint_writes_total")  # lands even at 0
    tele.reg.set_meta(checkpoint_every=cfg.checkpoint_every)
    if cfg.checkpoint_every <= 0:
        return None

    def snapshot(bstate, meta):
        if stats.batches % cfg.checkpoint_every:
            return
        with tele.timer.stage("checkpoint"), tele.tracer.span(
                "checkpoint", batch=stats.batches):
            ck.save(bstate, meta, cfg, stats.batches, stats, paths)
        tele.reg.counter("checkpoint_writes_total").inc()
        # a one-card snapshot's bytes and seconds (D2H, CRC32C, write
        # with its fsync) ride the event
        tele.reg.event("checkpoint", stage="create_database",
                       cursor=stats.batches,
                       **(getattr(ck, "last_save", None) or {}))
    return snapshot


def _resumed(reg, stats: BuildStats, header: dict, **extra) -> int:
    """Restore a snapshot's running stats and record the resume; returns
    its batch cursor (the batches to skip)."""
    stats.reads, stats.bases = int(header["reads"]), int(header["bases"])
    stats.batches, stats.grows = int(header["batches"]), int(header["grows"])
    cursor = int(header["cursor"])
    reg.counter("resume_skipped_reads")  # lands even at 0
    reg.set_meta(resumed=True, resumed_from_batch=cursor)
    reg.event("resume", stage="create_database", cursor=cursor, **extra)
    vlog("Resuming stage 1 from checkpoint: ", cursor, " batches (",
         stats.reads, " reads) already counted")
    return cursor


def _sketch_identity(cfg: BuildConfig, paths, cells_log2: int) -> dict:
    """What a sketch snapshot must match to be reused (quorum_tpu's)."""
    return {"k": cfg.k, "qual_thresh": cfg.qual_thresh,
            "batch_size": cfg.batch_size, "paths": list(paths),
            "cells_log2": cells_log2}


def _load_sketch(sk_ck, cfg: BuildConfig, paths, device, stats: BuildStats,
                 reg):
    """The two-pass prefilter's sketch from its snapshot on a resume,
    or None (none, or another run's). Returns (sketch, its meta)."""
    smeta = sketch_mod.SketchMeta(sketch_mod.cells_log2_for(cfg.initial_size))
    if sk_ck is None or not cfg.resume:
        return None, smeta
    cells = sk_ck.load(_sketch_identity(cfg, paths, smeta.cells_log2))
    if cells is None:
        return None, smeta
    stats.sketch_cells_log2 = smeta.cells_log2
    reg.set_meta(sketch_cells_log2=smeta.cells_log2)
    reg.event("resume", stage="create_database", sketch="loaded")
    vlog("Resuming two-pass prefilter: sketch restored from checkpoint "
         "(skipping pass 1)")
    return sketch_mod.SketchState(
        torch.from_numpy(cells.copy()).to(device)), smeta


def _save_sketch(sk_ck, sk, cfg: BuildConfig, paths, smeta) -> None:
    if sk_ck is not None:
        sk_ck.save(sk.cells.cpu().numpy(),
                   _sketch_identity(cfg, paths, smeta.cells_log2))


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


def _sketch_pass(factory, cfg: BuildConfig, device, stats: BuildStats,
                 tele: _Tele):
    """Pass 1 of the two-pass prefilter: every batch into a fresh sketch
    (HK9 + HK10); counts reads, bases and batches. Returns (sketch,
    its meta)."""
    smeta = sketch_mod.SketchMeta(sketch_mod.cells_log2_for(cfg.initial_size))
    sk = sketch_mod.make_sketch(smeta, device)
    stats.sketch_cells_log2 = smeta.cells_log2
    tele.reg.set_meta(sketch_cells_log2=smeta.cells_log2)
    t_sk = time.perf_counter()
    n_batches = 0
    with tele.timer.stage("sketch_pass"):
        for pk, wire, _nb in _wires(factory(), cfg, device, stats):
            tele.reg.heartbeat(stage="create_database", partition="sketch",
                               reads=stats.reads, batches=n_batches)
            with tele.tracer.span("sketch_batch", step=n_batches,
                                  reads=pk.n_reads), tele.device_step(
                    n_batches, pk.n_reads, "stage1_sketch", "sketch"):
                sketch_mod.sketch_update_packed(sk, smeta, cfg.k, pk, wire,
                                                cfg.qual_thresh)
            n_batches += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    stats.sketch_seconds = time.perf_counter() - t_sk
    tele.reg.counter("partition_passes_total").inc()
    tele.reg.event("partition_pass", partition="sketch",
                   n_partitions=cfg.partitions, batches=n_batches,
                   seconds=round(stats.sketch_seconds, 3))
    return sk, smeta


def build_database(paths: Sequence[str], cfg: BuildConfig,
                   device: torch.device,
                   batches_factory: Callable[[], Iterable] | None = None,
                   mesh: list | None = None, metrics=None, tracer=None):
    """Run stage 1. Returns (TileState, TileMeta, BuildStats).
    `batches_factory` overrides the disk reader: each call returns a
    FRESH iterable of (ReadBatch, PackedReads) pairs whose planes include
    cfg.qual_thresh (the quorum driver shares one parse between both
    stages). One pass calls it once; the two-pass prefilter calls it
    twice, and the first call's pass counts reads and bases. `mesh`
    (cfg.devices > 1) names the shards' devices; by default the first
    cfg.devices devices of `device`'s type (tile_sharded.make_mesh).
    `metrics` and `tracer` (cli/observability) record the build."""
    _check_config(cfg)
    if cfg.partitions > 1:
        raise ValueError(
            "partitioned builds stream their export per pass — run "
            "them through create_database_main, not build_database")
    tele = _Tele(metrics, tracer)
    reg = tele.reg
    t0 = time.perf_counter()
    times: dict = {}
    if batches_factory is None:
        batches_factory = default_factory(paths, cfg, times, reg,
                                          tele.tracer)
    reg.set_meta(stage="create_database", k=cfg.k, bits=cfg.bits,
                 qual_thresh=cfg.qual_thresh, batch_size=cfg.batch_size)
    if cfg.devices > 1:
        state, meta, stats = _build_sharded(cfg, device, batches_factory,
                                            t0, mesh, tele, paths)
        _stamp_times(stats, times)
        return state, meta, stats
    if cfg.prefilter == "inline" and cfg.checkpoint_dir:
        raise RuntimeError(
            "--prefilter=inline does not checkpoint (the online "
            "sketch is not snapshotted); use --prefilter=two-pass "
            "with --checkpoint-dir")
    meta = ctable.TileMeta(k=cfg.k, bits=cfg.bits, rb_log2=ctable.tile_rb_for(
        cfg.initial_size, cfg.k, cfg.bits))
    stats = BuildStats(prefilter_mode=cfg.prefilter)
    # crash safety: the two-pass prefilter snapshots its sketch, every
    # other one-card build its table and batch cursor
    ck = sk_ck = None
    if cfg.checkpoint_dir and cfg.prefilter == "two-pass":
        sk_ck = ckpt_mod.SketchCheckpoint(cfg.checkpoint_dir)
    elif cfg.checkpoint_dir:
        ck = ckpt_mod.Stage1Checkpoint(cfg.checkpoint_dir)
    t_load = time.perf_counter()
    snap = ck.load() if ck is not None and cfg.resume else None
    skip = 0
    if snap is not None:
        snap.check_config(cfg.k, cfg.bits, cfg.qual_thresh, cfg.batch_size,
                          paths)
        meta = ctable.TileMeta(k=cfg.k, bits=cfg.bits, rb_log2=snap.rb_log2)
        bstate = snap.build_state(device)
        # the load's seconds: read, digest check and the copy to the card
        skip = _resumed(reg, stats, snap.header,
                        load_s=time.perf_counter() - t_load)
        del snap
    else:
        bstate = ctable.make_tile_build(meta, device)
    snapshot = (_snapshotter(ck, cfg, paths, stats, tele)
                if ck is not None else None)
    if cfg.prefilter != "off":
        reg.set_meta(prefilter=cfg.prefilter)
        reg.counter("prefilter_dropped_total")
        reg.counter("prefilter_false_pass_total")
    if cfg.prefilter == "two-pass":
        reg.counter("partition_passes_total")
    sk = smeta = None
    if cfg.prefilter == "inline":
        smeta = sketch_mod.SketchMeta(
            sketch_mod.cells_log2_for(cfg.initial_size))
        sk = sketch_mod.make_sketch(smeta, device)
        stats.sketch_cells_log2 = smeta.cells_log2
        reg.set_meta(sketch_cells_log2=smeta.cells_log2)

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
        # pass 1: every batch into the sketch only (or its snapshot)
        sk, smeta = _load_sketch(sk_ck, cfg, paths, device, stats, reg)
        if sk is None:
            sk, smeta = _sketch_pass(batches_factory, cfg, device, stats,
                                     tele)
            _save_sketch(sk_ck, sk, cfg, paths, smeta)
        wires = _wires(batches_factory(), cfg, device,
                       stats if stats.batches == 0 else None)
    else:
        wires = _wires(batches_factory(), cfg, device, stats, skip, reg)
    t_pass = time.perf_counter()
    bstate, meta = _insert_pass(wires, meta, bstate, stats, insert, tele,
                                skip, snapshot)
    if cfg.prefilter == "two-pass":
        reg.counter("partition_passes_total").inc()
        reg.event("partition_pass", partition=0, n_partitions=1,
                  batches=stats.batches,
                  seconds=round(time.perf_counter() - t_pass, 3))
    del sk
    with tele.timer.stage("seal"), tele.tracer.span("seal"):
        state, dup, occ, distinct, total, singles = ctable.tile_seal(bstate,
                                                                     meta)
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
        reg.counter("prefilter_false_pass_total").inc(singles)
    if sk_ck is not None:
        sk_ck.clear()
    stats.seconds = time.perf_counter() - t0
    tele.finish(stats, meta.rows)
    _stamp_times(stats, times)
    if cfg.prefilter == "two-pass":
        vlog("Counted ", stats.reads, " reads, ", stats.bases, " bases, ",
             stats.distinct, " distinct mers (two-pass prefilter dropped ",
             stats.prefilter_dropped, " singleton observations)")
    else:
        vlog("Counted ", stats.reads, " reads, ", stats.bases, " bases, ",
             stats.distinct, " distinct mers")
    return state, meta, stats


def _build_sharded(cfg: BuildConfig, device: torch.device,
                   batches_factory: Callable[[], Iterable], t0: float,
                   mesh: list | None, tele: _Tele, paths: Sequence[str]):
    """Stage 1 over a mesh of cfg.devices devices (quorum_tpu's
    _build_database_sharded), with its per-shard snapshots under one
    manifest (Stage1ShardedCheckpoint) when cfg.checkpoint_dir is set.
    Returns (ShardedTileState, TileShardedMeta, BuildStats)."""
    import numpy as np

    from ..parallel import tile_sharded as ts

    S = cfg.devices
    if mesh is None:
        mesh = ts.make_mesh(S, device=device)
    if len(mesh) != S:
        raise ValueError(f"a mesh of {len(mesh)} devices for --devices {S}")
    meta = ts.TileShardedMeta(
        k=cfg.k, bits=cfg.bits, n_shards=S,
        rb_log2=ts.initial_rb(cfg.initial_size, cfg.k, cfg.bits, S))
    reg = tele.reg
    reg.set_meta(devices=S)
    stats = BuildStats()
    ck = (ckpt_mod.Stage1ShardedCheckpoint(cfg.checkpoint_dir)
          if cfg.checkpoint_dir else None)
    snap = ck.load() if ck is not None and cfg.resume else None
    skip = 0
    if snap is not None:
        snap.check_config(cfg.k, cfg.bits, cfg.qual_thresh, cfg.batch_size,
                          paths, S)
        meta = ts.TileShardedMeta(k=cfg.k, bits=cfg.bits, n_shards=S,
                                  rb_log2=snap.rb_log2)
        bstate = snap.build_state(mesh)
        skip = _resumed(reg, stats, snap.header, devices=S)
        del snap
    else:
        bstate = ts.make_build_state(meta, mesh)
    snapshot = (_snapshotter(ck, cfg, paths, stats, tele)
                if ck is not None else None)
    inserts = np.zeros(S, np.int64)
    for batch, pk in batches_factory():
        if skip > 0:
            skip -= 1
            reg.counter("resume_skipped_reads").inc(batch.n)
            continue
        faults.inject("stage1.insert", batch=stats.batches)
        resources.watchdog_beat("stage1.insert", stats.batches)
        stats.batches += 1
        stats.reads += batch.n
        nb = int(batch.lengths.sum())
        stats.bases += nb
        span, step = tele.batch(stats, batch.n, nb, devices=S)
        with span, tele.device_step(step, batch.n):
            bstate, meta, grows = ts.build_step_wire(
                bstate, meta, mesh, pk, cfg.qual_thresh,
                shard_inserts=inserts)
        stats.grows += grows
        reg.counter("hash_grows").inc(grows)
        reg.counter("shard_grows").inc(grows)
        reg.counter("shard_batches").inc()
        reg.counter("shard_reads").inc(batch.n)
        if snapshot is not None:
            snapshot(bstate, meta)
    with tele.timer.stage("seal"), tele.tracer.span("seal"):
        state, seal = ts.finalize(bstate, meta, mesh)
    del bstate
    if int(seal[:, 0].sum()):
        raise RuntimeError("internal error: duplicate tag pair in a bucket")
    stats.distinct, stats.distinct_hq, stats.total_hq, stats.singletons = (
        int(x) for x in seal[:, 1:].sum(0))
    stats.shard_occupancy = ts.shard_occupancy(seal)
    stats.seconds = time.perf_counter() - t0
    tele.finish(stats, meta.rows, distinct=False)
    if reg.enabled:
        ts.record_shard_metrics(reg, meta, inserts, stats.shard_occupancy)
    vlog("Counted ", stats.reads, " reads, ", stats.bases, " bases, ",
         stats.distinct, " distinct mers over ", S, " shards")
    return state, meta, stats


def _pass_table(factory, cfg: BuildConfig, device, stats: BuildStats,
                rb_local: int, p: int, sk, smeta, tele: _Tele,
                step0: int = 0):
    """Pass `p` of a partitioned build on one device: insert the mers it
    owns (HK1, or HK11 behind the finished sketch) into a table of
    2^rb_local rows and seal it (HK2). Returns (the sealed TileState,
    its TileMeta, (occupied, distinct_hq, total_hq, singletons)).
    Raises _PartitionGrew on a full row. Batch i passes the
    `stage1.insert` fault site and the watchdog's beat as batch step0 +
    i."""
    P = cfg.partitions
    lmeta = ctable.TileMeta(k=cfg.k, bits=cfg.bits, rb_log2=rb_local)
    bstate = ctable.make_tile_build(lmeta, device)
    count = stats if stats.batches == 0 else None
    for n, (pk, wire, nb) in enumerate(_wires(factory(), cfg, device, count)):
        faults.inject("stage1.insert", batch=step0 + n)
        resources.watchdog_beat("stage1.insert", step0 + n)
        span, step = tele.batch(stats, pk.n_reads, nb, partition=p)
        with span:
            with tele.device_step(step, pk.n_reads):
                if sk is None:
                    full, _left = kernels.tile_insert_reads(
                        bstate, lmeta, wire, pk.n_reads, pk.length,
                        pk.thresholds, cfg.qual_thresh, p, P)
                    d_hq = d_lq = 0
                else:
                    full, _left, d_hq, d_lq = \
                        sketch_mod.tile_insert_reads_packed_gated(
                            bstate, lmeta, sk, smeta, pk, wire,
                            cfg.qual_thresh, "two-pass", p, P)
            _dropped(tele, stats, d_hq, d_lq)
        if full:
            if rb_local >= 24:
                raise RuntimeError("Hash is full")
            raise _PartitionGrew(rb_local + 1)
    with tele.timer.stage("seal"), tele.tracer.span("seal", partition=p):
        state, dup, occ, distinct, total, singles = ctable.tile_seal(bstate,
                                                                     lmeta)
    del bstate
    if dup:
        raise RuntimeError("internal error: duplicate tag pair in a bucket")
    return state, lmeta, (occ, distinct, total, singles)


def _pass_table_sharded(factory, cfg: BuildConfig, mesh, stats: BuildStats,
                        rb_local: int, p: int, tele: _Tele, step0: int = 0):
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
    for n, (batch, pk) in enumerate(factory()):
        faults.inject("stage1.insert", batch=step0 + n)
        resources.watchdog_beat("stage1.insert", step0 + n)
        nb = int(batch.lengths.sum())
        if count:
            stats.batches += 1
            stats.reads += batch.n
            stats.bases += nb
        span, step = tele.batch(stats, batch.n, nb, partition=p)
        try:
            with span, tele.device_step(step, batch.n):
                bstate, lmeta, _g = ts.build_step_wire(
                    bstate, lmeta, mesh, pk, cfg.qual_thresh, p, P)
        except ts.PassFull:
            if rb_local >= 24 + lmeta.owner_bits:
                raise RuntimeError("Hash is full") from None
            raise _PartitionGrew(rb_local + 1) from None
    with tele.timer.stage("seal"), tele.tracer.span("seal", partition=p):
        state, seal = ts.finalize(bstate, lmeta, mesh)
    del bstate
    if int(seal[:, 0].sum()):
        raise RuntimeError("internal error: duplicate tag pair in a bucket")
    gstate, gmeta = ts.gather_table(state, lmeta)
    del state
    return gstate, gmeta, tuple(int(x) for x in seal[:, 1:].sum(0))


def _partition_identity(cfg: BuildConfig, paths, rb_local: int,
                        cells_log2: int) -> dict:
    """What a partition cursor must match to be resumed (quorum_tpu's):
    the run's shape including the local geometry (a geometry restart
    makes earlier shard files stale) and the sketch size."""
    return {"k": cfg.k, "bits": cfg.bits, "qual_thresh": cfg.qual_thresh,
            "batch_size": cfg.batch_size, "paths": list(paths),
            "partitions": cfg.partitions, "devices": cfg.devices,
            "db_version": cfg.db_version, "prefilter": cfg.prefilter,
            "rb_local": rb_local, "cells_log2": cells_log2}


# the fields of a cursor record that are the manifest's record; the rest
# (the pass's statistics) stay in the cursor
_MANIFEST_KEYS = ("path", "shard", "n_entries", "value_bytes", "file_crc32c")


def _restore_passes(completed: dict, stats: BuildStats, reg,
                    prefiltered: bool) -> None:
    """A resumed partitioned build: the finished passes' accounting from
    their cursor records."""
    reg.event("resume", stage="create_database",
              partitions_done=sorted(completed))
    vlog("Resuming partitioned build: partitions ", sorted(completed),
         " already exported")
    for p, r in completed.items():
        stats.distinct += int(r["n_entries"])
        stats.poisson_distinct_hq += int(r.get("distinct_hq", 0))
        stats.poisson_total_hq += int(r.get("total_hq", 0))
        fp, dr = int(r.get("false_pass", 0)), int(r.get("dropped", 0))
        stats.prefilter_false_pass += fp
        stats.singletons += fp
        stats.prefilter_dropped += dr
        stats.prefilter_dropped_hq += int(r.get("dropped_hq", 0))
        if prefiltered:
            reg.counter("prefilter_dropped_total").inc(dr)
            reg.counter("prefilter_false_pass_total").inc(fp)
        reg.gauge(f'partition_distinct{{partition="{p}"}}').set(
            int(r["n_entries"]))


def _build_partitioned(paths: Sequence[str], cfg: BuildConfig, output: str,
                       device: torch.device,
                       batches_factory: Callable[[], Iterable] | None,
                       cmdline: list[str] | None,
                       mesh: list | None = None,
                       tele: _Tele | None = None) -> BuildStats:
    """The partitioned multi-pass build (quorum_tpu's
    _build_database_partitioned on one host): P passes, each rebased
    onto the global geometry (HK13) and exported as shard p of it as it
    finishes, then the sealed manifest at `output`. Each pass runs on
    one device or, with cfg.devices > 1, over the mesh (`mesh`, by
    default the first cfg.devices devices of `device`'s type). With
    two-pass the sketch pass runs once and survives geometry restarts.
    With cfg.checkpoint_dir a cursor commits after every pass
    (Stage1PartitionCursor; each pass's shard file is its own
    checkpoint) and the sketch is snapshotted; a resume re-runs only the
    passes the cursor does not vouch for. Returns the BuildStats; no
    table stays on the card."""
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
    tele = tele if tele is not None else _Tele()
    reg = tele.reg
    reg.set_meta(stage="create_database", k=cfg.k, bits=cfg.bits,
                 qual_thresh=cfg.qual_thresh, batch_size=cfg.batch_size,
                 devices=S, partitions=P, prefilter=cfg.prefilter)
    reg.counter("partition_passes_total")
    if cfg.prefilter != "off":
        reg.counter("prefilter_dropped_total")
        reg.counter("prefilter_false_pass_total")
    times: dict = {}
    if batches_factory is None:
        batches_factory = default_factory(paths, cfg, times, reg,
                                          tele.tracer)
    if S > 1 and mesh is None:
        from ..parallel import tile_sharded as ts

        mesh = ts.make_mesh(S, device=device)
    cursor = sk_ck = None
    if cfg.checkpoint_dir:
        cursor = ckpt_mod.Stage1PartitionCursor(cfg.checkpoint_dir)
        if cfg.prefilter == "two-pass":
            sk_ck = ckpt_mod.SketchCheckpoint(cfg.checkpoint_dir)
    out_dir = os.path.dirname(os.path.abspath(output)) or "."
    sk = smeta = None
    if cfg.prefilter == "two-pass":
        sk, smeta = _load_sketch(sk_ck, cfg, paths, device, stats, reg)
        if sk is None:
            sk, smeta = _sketch_pass(batches_factory, cfg, device, stats,
                                     tele)
            _save_sketch(sk_ck, sk, cfg, paths, smeta)
    for _ in range(MAX_GROWS + 1):
        gmeta = ctable.GlobalMeta(k=cfg.k, bits=cfg.bits, rb_log2=rb_local + g)
        identity = _partition_identity(cfg, paths, rb_local,
                                       smeta.cells_log2 if smeta else 0)
        completed: dict = {}
        if cursor is not None and cfg.resume:
            completed = {int(r["shard"]): r
                         for r in cursor.load(identity, out_dir) or ()}
            if completed:
                _restore_passes(completed, stats, reg, cfg.prefilter != "off")
        step0 = 0
        try:
            for p in range(P):
                if p in completed:
                    continue
                t_pass = time.perf_counter()
                b0 = tele.step
                dropped0 = stats.prefilter_dropped
                dropped_hq0 = stats.prefilter_dropped_hq
                if S > 1:
                    state, lmeta, (occ, distinct, total, singles) = \
                        _pass_table_sharded(batches_factory, cfg, mesh,
                                            stats, rb_local, p, tele, step0)
                else:
                    state, lmeta, (occ, distinct, total, singles) = \
                        _pass_table(batches_factory, cfg, device, stats,
                                    rb_local, p, sk, smeta, tele, step0)
                step0 += tele.step - b0
                with tele.timer.stage("export"), tele.tracer.span(
                        "partition_export", partition=p), \
                        kernels.device_scope(state.rows.device):
                    state, bad = ctable.tile_departition_rows(state, lmeta,
                                                              g, p)
                    if bad:
                        raise RuntimeError("internal error: partition pass "
                                           "counted a mer outside its bin")
                    rec = db_format.write_db_shard_file(
                        output, state.rows, gmeta, p, P, cmdline,
                        cfg.db_version, n_entries=occ)
                del state
                false_pass = singles if sk is not None else 0
                # the cursor record: the manifest's record plus the
                # pass's statistics a resumed build restores
                completed[p] = {
                    **rec, "distinct_hq": distinct, "total_hq": total,
                    "false_pass": false_pass,
                    "dropped": stats.prefilter_dropped - dropped0,
                    "dropped_hq": stats.prefilter_dropped_hq - dropped_hq0}
                stats.distinct += occ
                stats.poisson_distinct_hq += distinct
                stats.poisson_total_hq += total
                stats.singletons += singles
                if sk is not None:
                    stats.prefilter_false_pass += singles
                    reg.counter("prefilter_false_pass_total").inc(singles)
                reg.counter("partition_passes_total").inc()
                reg.gauge(f'partition_distinct{{partition="{p}"}}').set(occ)
                reg.event("partition_pass", partition=p, n_partitions=P,
                          batches=tele.step - b0, distinct=occ,
                          seconds=round(time.perf_counter() - t_pass, 3))
                if cursor is not None:
                    cursor.save(identity,
                                [completed[i] for i in sorted(completed)],
                                out_dir)
                else:
                    faults.inject("partition.commit", path=rec["path"])
            break
        except _PartitionGrew as e:
            vlog("Partition pass overflowed at local rb_log2=", rb_local,
                 "; restarting all passes at ", e.rb_local)
            stats.grows += 1
            reg.counter("hash_grows").inc()
            reg.event("partition_geometry_grow", rb_local_before=rb_local,
                      rb_local_after=e.rb_local)
            for field in ("distinct", "poisson_distinct_hq", "poisson_total_hq",
                          "singletons", "prefilter_dropped",
                          "prefilter_dropped_hq", "prefilter_false_pass",
                          "reads", "bases", "batches"):
                setattr(stats, field, 0)
            rb_local = e.rb_local
            if cursor is not None:
                cursor.clear()
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
    recs = [{k: completed[p][k] for k in _MANIFEST_KEYS} for p in range(P)]
    db_format.write_db_manifest(output, recs, gmeta, P, cmdline,
                                cfg.db_version, stats.db_extra_header())
    # the manifest is the commit point: the pass-granular artifacts die
    # with it
    for art in (cursor, sk_ck):
        if art is not None:
            art.clear()
    stats.seconds = time.perf_counter() - t0
    _stamp_times(stats, times)
    tele.finish(stats, gmeta.rows)
    reg.gauge("partition_rows_local").set(1 << rb_local)
    vlog("Counted ", stats.reads, " reads, ", stats.bases, " bases, ",
         stats.distinct, " distinct mers over ", P,
         " partition passes (peak table rows 1/", P, " of global)")
    return stats


def create_database_main(paths: Sequence[str], output: str, cfg: BuildConfig,
                         cmdline: list[str] | None = None,
                         handoff: dict | None = None,
                         batches_factory: Callable[[], Iterable] | None = None,
                         mesh: list | None = None,
                         ref_format: bool = False, metrics=None,
                         tracer=None) -> BuildStats:
    """Build and write the database (one file, or a sharded manifest
    with --db-layout sharded or --partitions P; with `ref_format` the
    reference's binary/quorum_db file, io/quorum_db, written from the
    sealed table's entries on the host). With `handoff` (a
    dict) the BuildStats go to handoff["stats"], and a single-pass
    build keeps its device-resident table as handoff["db"] = (state,
    meta, stats) for an in-process stage 2; a partitioned build never
    holds the whole table, so its stage 2 loads the manifest. A
    --devices N build writes one shard file per shard (sharded layout)
    or its table gathered onto the lead device (single). `metrics` and
    `tracer` record the build; with cfg.profile all of it (build, seal,
    export) runs under the profiler."""
    from .. import resolve_device

    if ref_format and (cfg.partitions > 1 or cfg.prefilter != "off"):
        raise ValueError(
            "--ref-format supports neither --partitions nor "
            "--prefilter (the reference format carries no manifest "
            "or prefilter declaration)")
    device = resolve_device(cfg.device)
    with trace(cfg.profile, device):
        stats = _build_and_write(paths, output, cfg, device, cmdline,
                                 handoff, batches_factory, mesh,
                                 ref_format, metrics, tracer)
    if handoff is not None:
        handoff["stats"] = stats
    return stats


def _build_and_write(paths, output, cfg: BuildConfig, device, cmdline,
                     handoff, batches_factory, mesh, ref_format: bool,
                     metrics, tracer) -> BuildStats:
    """create_database_main's build and export."""
    if cfg.partitions > 1:
        return _build_partitioned(paths, cfg, output, device,
                                  batches_factory, cmdline, mesh,
                                  _Tele(metrics, tracer))
    state, meta, stats = build_database(paths, cfg, device,
                                        batches_factory, mesh,
                                        metrics, tracer)
    if ref_format:
        wstate, wmeta = state, meta
        if cfg.devices > 1:
            from ..parallel import tile_sharded as ts

            wstate, wmeta = ts.gather_table(state, meta)
        khi, klo, vals = ctable.tile_iterate(wstate, wmeta)
        del wstate
        quorum_db.write_ref_db(output, khi, klo, vals, wmeta.k,
                               wmeta.bits, cfg.max_reprobe, cmdline)
    elif cfg.devices > 1 and cfg.db_layout == "single":
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
    if cfg.checkpoint_dir:
        # the finished database is the durable artifact now; a stale
        # snapshot must not feed a later unrelated --resume
        cls = (ckpt_mod.Stage1ShardedCheckpoint if cfg.devices > 1
               else ckpt_mod.Stage1Checkpoint)
        cls(cfg.checkpoint_dir).clear()
    if handoff is not None:
        handoff["db"] = (state, meta, stats)
    return stats
