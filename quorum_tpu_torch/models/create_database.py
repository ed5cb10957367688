"""Stage 1: build the quality-aware k-mer table from FASTQ reads
(counterpart of the single-device loop of
quorum_tpu/models/create_database.py:build_database).

Each batch crosses to the device as one packed wire buffer and HK1
counts every window straight into the tile build table. A batch that
meets a full 64-slot row reports its unplaced observations; the table
doubles (tile_grow_build) and exactly those observations re-insert, as
often as needed (the reference's "Hash is full" contract,
create_database.cc:87). HK2 seals the table at the end.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Iterable, Sequence

import torch

from .. import kernels
from ..io import db_format, fastq, packing
from ..ops import ctable

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


@dataclasses.dataclass
class BuildStats:
    reads: int = 0
    bases: int = 0
    batches: int = 0
    grows: int = 0
    distinct: int = 0
    distinct_hq: int = 0
    total_hq: int = 0
    seconds: float = 0.0


def default_batches(paths: Sequence[str], cfg: BuildConfig):
    """(ReadBatch, PackedReads) pairs packed with the stage-1 plane."""
    for b in fastq.read_batches(paths, cfg.batch_size):
        yield b, packing.pack_reads(b.codes, b.quals, b.lengths,
                                    thresholds=(cfg.qual_thresh,))


def build_database(paths: Sequence[str], cfg: BuildConfig,
                   device: torch.device,
                   batches: Iterable | None = None):
    """Run stage 1. Returns (TileState, TileMeta, BuildStats). `batches`
    overrides the disk reader with (ReadBatch, PackedReads) pairs whose
    planes include cfg.qual_thresh (the quorum driver shares one parse
    between both stages)."""
    t0 = time.perf_counter()
    meta = ctable.TileMeta(k=cfg.k, bits=cfg.bits, rb_log2=ctable.tile_rb_for(
        cfg.initial_size, cfg.k, cfg.bits))
    bstate = ctable.make_tile_build(meta, device)
    stats = BuildStats()
    if batches is None:
        batches = default_batches(paths, cfg)
    for batch, pk in batches:
        pk.require_plane(cfg.qual_thresh)
        stats.batches += 1
        stats.reads += batch.n
        stats.bases += int(batch.lengths.sum())
        wire = torch.from_numpy(pk.to_wire()).to(device)
        full, (keys, qual) = kernels.tile_insert_reads(
            bstate, meta, wire, pk.n_reads, pk.length, pk.thresholds,
            cfg.qual_thresh)
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
    state, dup, occ, distinct, total = ctable.tile_seal(bstate, meta)
    del bstate
    if dup:
        raise RuntimeError("internal error: duplicate tag pair in a bucket")
    stats.distinct, stats.distinct_hq, stats.total_hq = occ, distinct, total
    stats.seconds = time.perf_counter() - t0
    return state, meta, stats


def create_database_main(paths: Sequence[str], output: str, cfg: BuildConfig,
                         cmdline: list[str] | None = None,
                         handoff: dict | None = None,
                         batches: Iterable | None = None) -> BuildStats:
    """Build, write the database file, and with `handoff` (a dict) keep
    the device-resident table as handoff["db"] = (state, meta, stats)
    for an in-process stage 2."""
    from .. import resolve_device

    device = resolve_device(cfg.device)
    state, meta, stats = build_database(paths, cfg, device, batches)
    db_format.write_db(output, state, meta, cmdline, n_entries=stats.distinct,
                       db_version=cfg.db_version)
    if handoff is not None:
        handoff["db"] = (state, meta, stats)
    return stats
