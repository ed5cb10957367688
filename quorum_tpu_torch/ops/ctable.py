"""Tile-bucket k-mer table (counterpart of the tile half of
quorum_tpu/ops/ctable.py).

A row (bucket) is 128 u32 words = 64 slots of (lo, hi) pairs. The
Feistel-mixed key's low rb_log2 bits address the row; the remainder
splits into rlo (31 - bits bits) and rhi tags. Build side: `tag` holds
(rlo, rhi) pairs (0xFFFFFFFF = empty) with split hq/lq accumulators;
sealed side: ``lo = rlo << (bits+1) | q << bits | count``, ``hi = rhi``.

All u32 planes are int32 tensors holding the same bits. Inserts update
the build state IN PLACE (JAX returns new arrays; the port saves the
copy of a multi-GiB plane per batch).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..kernels import reference as ref
from ..kernels.reference import TSLOTS

TILE = 128


@dataclasses.dataclass(frozen=True)
class TileMeta:
    """Static geometry of the tile-bucket table."""

    k: int
    bits: int
    rb_log2: int  # log2(number of rows/buckets)

    def __post_init__(self):
        if self.rb_log2 < 0 or self.rb_log2 > 24:
            raise ValueError(f"rb_log2 out of range: {self.rb_log2}")
        if self.rem_bits - self.rlo_bits > 32:
            raise ValueError(
                f"tile layout infeasible: k={self.k} rb_log2={self.rb_log2} "
                f"bits={self.bits}: rem_high needs "
                f"{self.rem_bits - self.rlo_bits} > 32 bits")

    @property
    def rows(self) -> int:
        return 1 << self.rb_log2

    @property
    def rem_bits(self) -> int:
        return max(0, 2 * self.k - self.rb_log2)

    @property
    def rlo_bits(self) -> int:
        return 31 - self.bits

    @property
    def max_val(self) -> int:
        return (1 << self.bits) - 1

    @property
    def hi_bytes(self) -> int:
        """Live bytes of a hi word in the v4/v5 export."""
        return (max(0, self.rem_bits - self.rlo_bits) + 7) // 8


class TileState(NamedTuple):
    """Sealed, query-ready table: int32 [rows, 128]."""

    rows: torch.Tensor


class TBuildState(NamedTuple):
    """Build-side table: tag int32 [rows, 128] (even = rlo, odd = rhi,
    -1 = empty), hq/lq int32 [rows * 64] accumulators."""

    tag: torch.Tensor
    hq: torch.Tensor
    lq: torch.Tensor


def min_tile_rb_log2(k: int, bits: int) -> int:
    return max(0, 2 * k - (31 - bits) - 32)


def tile_rb_for(n_entries: int, k: int, bits: int,
                target_load: int = 24) -> int:
    """rows for ~target_load entries per 64-slot bucket."""
    want = max(1, (n_entries + target_load - 1) // target_load)
    return max(min_tile_rb_log2(k, bits), 4, int(want - 1).bit_length())


def make_tile_build(meta: TileMeta, device) -> TBuildState:
    r = meta.rows
    return TBuildState(
        torch.full((r, TILE), -1, dtype=torch.int32, device=device),
        torch.zeros(r * TSLOTS, dtype=torch.int32, device=device),
        torch.zeros(r * TSLOTS, dtype=torch.int32, device=device))


def tile_grow_build(bstate: TBuildState, meta: TileMeta,
                    chunk: int = 1 << 22) -> tuple[TBuildState, TileMeta]:
    """Double the rows and re-insert every slot (K6): the full hash is
    (rem << rb) | addr, so doubling moves rem's low bit into the address
    top bit. The prep is plain torch; the re-insert goes through HK1's
    parts entry. Raises "Hash is full" past the single-card geometry."""
    try:
        new_meta = dataclasses.replace(meta, rb_log2=meta.rb_log2 + 1)
    except ValueError as e:
        raise RuntimeError("Hash is full") from e
    new = make_tile_build(new_meta, bstate.tag.device)
    tag = bstate.tag.view(-1)
    n_slots = meta.rows * TSLOTS
    rl = meta.rlo_bits
    for start in range(0, n_slots, chunk):
        stop = min(n_slots, start + chunk)
        rlo = ref.u32(tag[2 * start:2 * stop:2])
        rhi = ref.u32(tag[2 * start + 1:2 * stop:2])
        hq = bstate.hq[start:stop]
        lq = bstate.lq[start:stop]
        valid = (rlo != ref.EMPTY) & ((hq | lq) != 0)
        idx = torch.nonzero(valid).squeeze(1)
        slot = idx + start
        addr = (slot // TSLOTS) | ((rlo[idx] & 1) << meta.rb_log2)
        nrlo = (rlo[idx] >> 1) | ((rhi[idx] & 1) << (rl - 1))
        nrhi = rhi[idx] >> 1
        if not kernels.tile_insert_parts(new, new_meta, addr, nrlo, nrhi,
                                         hq[idx], lq[idx]).all():
            raise RuntimeError("Hash is full")
    return new, new_meta


def tile_insert_pending(bstate: TBuildState, meta: TileMeta,
                        keys: torch.Tensor, qual: torch.Tensor):
    """Re-insert observations that found no room (after a grow): sum
    duplicate keys into (hq, lq) increments, hash them in plain torch
    and insert through HK1's parts entry. Returns the (keys, qual) of
    observations still without room, one per unplaced count."""
    uk, inv = torch.unique(keys, return_inverse=True)
    q = qual.to(torch.int32)
    hq = torch.zeros(uk.numel(), dtype=torch.int32, device=keys.device)
    lq = torch.zeros_like(hq)
    hq.index_add_(0, inv, q)
    lq.index_add_(0, inv, 1 - q)
    addr, rlo, rhi = ref.tile_key_parts(uk, meta)
    placed = kernels.tile_insert_parts(bstate, meta, addr, rlo, rhi, hq, lq)
    left = ~placed[inv]
    return keys[left], qual[left]


def tile_seal(bstate: TBuildState, meta: TileMeta):
    """End of build (HK2): duplicate check + fold + stats in one launch.
    Returns (TileState, dup, n_occupied, distinct_hq, total_hq); the
    statistics are exact integers (the JAX package sums total_hq in
    float32, equal below 2^24)."""
    rows, stats = kernels.tile_seal(bstate, meta)
    dup, occ, distinct, total = (int(x) for x in stats.cpu())
    return TileState(rows), bool(dup), occ, distinct, total


def tile_stats(state: TileState, meta: TileMeta):
    """(n_occupied, distinct_hq, total_hq) of a sealed table."""
    lo = ref.u32(state.rows[:, 0::2])
    count = lo & meta.max_val
    hq = (count != 0) & (((lo >> meta.bits) & 1) == 1)
    return (int((count != 0).sum()), int(hq.sum()),
            int(torch.where(hq, count, 0).sum()))


def tile_export_v4(state: TileState, meta: TileMeta) -> np.ndarray:
    """K8: the v4/v5 payload — per-row occupancy counts (u8), the
    occupied entries' lo words (LE u32) in canonical order (each row
    sorted by (empty, hi, lo), so the file is a pure function of the
    table's content), then `hi_bytes` byte planes of their hi words.
    Sorting and compaction run on the table's device; one D2H."""
    rows3 = state.rows.view(-1, TSLOTS, 2)
    lo = ref.u32(rows3[..., 0])
    hi = ref.u32(rows3[..., 1])
    occ = (lo & meta.max_val) != 0

    def by(key):  # stable re-order of every slot field along the row
        order = torch.sort(key, dim=1, stable=True).indices
        return tuple(torch.gather(x, 1, order) for x in (lo, hi, occ))

    # stable sorts, least significant key first: (empty, hi, lo)
    lo, hi, occ = by(lo)
    lo, hi, occ = by(hi)
    lo, hi, occ = by((~occ).to(torch.int8))
    counts = occ.sum(dim=1).to(torch.uint8)
    clo, chi = lo[occ], hi[occ]
    parts = [counts, ref.i32(clo).view(torch.uint8)]
    parts += [((chi >> (8 * j)) & 0xFF).to(torch.uint8)
              for j in range(meta.hi_bytes)]
    return torch.cat(parts).cpu().numpy()


def tile_rows_from_compact(counts: np.ndarray, lo: np.ndarray,
                           hi: np.ndarray, meta: TileMeta, device
                           ) -> TileState:
    """K9: scatter compact entries back into a fresh row plane on
    `device` (entry i of row a goes to slot rank-within-row)."""
    cnt = torch.as_tensor(np.asarray(counts, np.int64), device=device)
    n = int(lo.shape[0])
    rows = torch.zeros((meta.rows, TILE), dtype=torch.int32, device=device)
    if n:
        addr = torch.repeat_interleave(
            torch.arange(meta.rows, device=device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        rank = torch.arange(n, device=device) - first[addr]
        flat = rows.view(-1)
        base = addr * TILE + 2 * rank
        flat[base] = torch.as_tensor(np.asarray(lo, np.uint32).view(np.int32),
                                     device=device)
        flat[base + 1] = torch.as_tensor(
            np.asarray(hi, np.uint32).view(np.int32), device=device)
    return TileState(rows)
