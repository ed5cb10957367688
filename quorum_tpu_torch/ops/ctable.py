"""Tile-bucket k-mer table (counterpart of the tile half of
quorum_tpu/ops/ctable.py) and, at the end, the flat bucket-4 table (its
first half, "v0").

A row (bucket) is 128 u32 words = 64 slots of (lo, hi) pairs. The
Feistel-mixed key's low rb_log2 bits address the row; the remainder
splits into rlo (31 - bits bits) and rhi tags. Build side: `tag` holds
(rlo, rhi) pairs (0xFFFFFFFF = empty) with split hq/lq accumulators;
sealed side: ``lo = rlo << (bits+1) | q << bits | count``, ``hi = rhi``.

All u32 planes are int32 tensors holding the same bits. Inserts update
the build state IN PLACE (JAX returns new arrays; the port saves the
copy of a multi-GiB plane per batch).

The flat table (K25: HK18 inserts and grows, HK19 looks up, HK20 seals
and counts) keeps four slots a bucket in flat u32 planes, keytag / hq /
lq while it is built and one entry word ``rem << (bits+1) | q << bits |
count`` a slot once sealed. A key's bucket is the low nb_log2 bits of
its Feistel-mixed value and it lives only there: a bucket that would
take a fifth key makes the insert report `full`, the caller doubles
the table (grow_build) and inserts again the observations not placed.
JAX claims a slot with a scatter-set whose winner among lanes of one
slot is XLA's pick; HK18 claims with atomicCAS, whose winner is the
first lane to get there. So the SLOT a key takes inside its bucket, the
order iterate_entries yields the entries in, the ranks tile_from_build
gives them, and which lanes of an overflowing bucket stay pending may
differ from JAX's. What the port is held to is the table as a key ->
value map (iterate_entries sorted by key, lookup of present and absent
keys), `full`, the placed mask when not full, table_stats, and
tile_from_build as a tile entry map; never slot positions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..kernels.reference import TSLOTS

TILE = 128
MAX_GROWS = 16  # doublings one batch may ask for, on one card or a mesh


@dataclasses.dataclass(frozen=True)
class GlobalMeta:
    """Geometry of a database file or manifest: the tile layout's fields
    without the one-card cap, so rb_log2 may pass 24 (the global geometry
    of a partitioned build, which the JAX package writes through its
    TileShardedMeta). Only manifests and their shard files are written
    and read under it; a table on the card is a TileMeta."""

    k: int
    bits: int
    rb_log2: int  # log2(number of rows/buckets)

    def __post_init__(self):
        if self.rb_log2 < 0:
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


@dataclasses.dataclass(frozen=True)
class TileMeta(GlobalMeta):
    """Static geometry of the tile-bucket table on one card: at most
    2^24 rows."""

    def __post_init__(self):
        if self.rb_log2 > 24:
            raise ValueError(f"rb_log2 out of range: {self.rb_log2}")
        super().__post_init__()


class TileState(NamedTuple):
    """Sealed, query-ready table: int32 [rows, 128]."""

    rows: torch.Tensor


class TBuildState(NamedTuple):
    """Build-side table: tag int32 [rows, 128] (even = rlo, odd = rhi,
    -1 = empty), hq/lq int32 [rows * 64] accumulators."""

    tag: torch.Tensor
    hq: torch.Tensor
    lq: torch.Tensor


class ShardedTileState(NamedTuple):
    """Sealed table sharded by leading row bits (--devices N): shard s
    holds the global rows [s * rows / S, (s + 1) * rows / S) on its own
    device. Concatenated in shard order, the shards are the single-card
    table row for row."""

    shards: tuple  # of int32 [rows / S, 128]
    # the whole plane where every shard is a row range of it (a mesh
    # that names one device), else None
    whole: torch.Tensor | None = None


class ShardedBuildState(NamedTuple):
    """Build-side table sharded by leading row bits: one TBuildState a
    shard, on its device, whose row planes concatenate to the
    single-card build table's."""

    shards: tuple  # of TBuildState


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


def tile_grow_build(bstate: TBuildState, meta: TileMeta
                    ) -> tuple[TBuildState, TileMeta]:
    """Double the rows and re-insert every slot (K6, HK8: one launch).
    Raises "Hash is full" past the single-card geometry."""
    try:
        new_meta = dataclasses.replace(meta, rb_log2=meta.rb_log2 + 1)
    except ValueError as e:
        raise RuntimeError("Hash is full") from e
    new = make_tile_build(new_meta, bstate.tag.device)
    if kernels.tile_grow(bstate, meta, new, new_meta):
        raise RuntimeError("Hash is full")
    return new, new_meta


def tile_insert_pending(bstate: TBuildState, meta: TileMeta,
                        keys: torch.Tensor, qual: torch.Tensor):
    """Re-insert observations that found no room (after a grow), one
    count each, through HK1's keys entry. Returns the (keys, qual) of
    the observations still without room."""
    left = ~kernels.tile_insert_keys(bstate, meta, keys, qual)
    return keys[left], qual[left]


def tile_seal(bstate: TBuildState, meta: TileMeta):
    """End of build (HK2): duplicate check + fold + stats in one launch.
    Returns (TileState, dup, n_occupied, distinct_hq, total_hq,
    singletons); the statistics are exact integers (the JAX package sums
    total_hq in float32, equal below 2^24). `singletons` counts the
    entries with exactly one observation (sketch.singleton_entries: in
    a two-pass prefiltered build, the sketch's false passes)."""
    rows, stats = kernels.tile_seal(bstate, meta)
    dup, occ, distinct, total, singles = (int(x) for x in stats.cpu())
    return TileState(rows), bool(dup), occ, distinct, total, singles


def tile_floor(state: TileState, meta: TileMeta, floor: int) -> TileState:
    """The presence floor (K21, HK12): entries whose stored count is
    below `floor` become empty, IN PLACE on the sealed rows (the JAX
    package returns a new plane; the port saves the copy). A no-op for
    floor <= 1. Flooring the full table and the two-pass prefiltered
    one gives the same rows (ops/sketch)."""
    if floor > 1:
        kernels.tile_floor(state.rows, meta, floor)
    return state


def tile_export_v4(state: TileState, meta: GlobalMeta,
                   n: int | None = None) -> np.ndarray:
    """K8 (HK6): the v4/v5 payload -- per-row occupancy counts (u8), the
    occupied entries' lo words (LE u32) in canonical order (each row
    sorted by (empty, hi, lo), so the file is a pure function of the
    table's content), then `hi_bytes` byte planes of their hi words --
    built on the table's device, then one D2H. `state` may be a row
    range of meta's table (one shard, its rows at meta's geometry). `n`,
    where the caller holds it (the seal's occupied count), is the
    entries the rows hold: the export reads the rows once, and raises
    RuntimeError where they hold another number."""
    return kernels.tile_export(state.rows, meta, n).cpu().numpy()


def tile_compact_device(state: TileState, meta: GlobalMeta, cap: int):
    """K22 (HK6's compact entry): the occupied slots' (row address,
    lo, hi) in row-major slot order, in `cap` lanes (zeros past the
    n-th), and n. Returns (addr int32 [cap], lo, hi int32 [cap] holding
    the u32 bits, n int64 0-dim), on the rows' device."""
    return kernels.tile_compact(state.rows, meta, cap)


def partition_mask(keys: torch.Tensor, meta: TileMeta, part: int,
                   n_parts: int) -> torch.Tensor:
    """K20's ownership predicate, plain torch (HK1 and HK11 fuse it):
    pass `part` of `n_parts` (a power of two) owns the canonical int64
    mers whose hash remainder's low log2(n_parts) bits at `meta`'s
    geometry -- equivalently the global row address's leading bits at
    rb_log2 + log2(n_parts) -- equal `part`. Disjoint and exhaustive, so
    the passes count every mer exactly once."""
    return kernels.ref.partition_mask(keys, meta, part, n_parts)


def tile_departition_rows(state: TileState, lmeta: TileMeta, g: int,
                          part: int) -> tuple[TileState, bool]:
    """K20's rebase (HK13): pass `part`'s sealed rows at the local
    geometry `lmeta` become rows [part * rows, (part + 1) * rows) of the
    global geometry rb_log2 + g, bit for bit as a single-pass build
    would hold them (up to slot order). IN PLACE (the JAX package
    returns a new plane; the local one is dead once exported, so the
    port saves a copy). Returns (TileState, bad): `bad` flags an entry
    whose dropped bits disagree with `part`. g = 0 is the identity."""
    if g == 0:
        return state, False
    bad = kernels.tile_departition(state.rows, lmeta, g, part)
    return state, bool(bad.item())


def tile_load(payload: np.ndarray, meta: TileMeta, n: int, device
              ) -> tuple[TileState, tuple[int, int, int]]:
    """K9 + K7's statistics (HK7): a v4/v5 payload of n entries, whose
    structure the caller has checked, copied to `device` once and
    scattered into a fresh row plane there (entry i of row a goes to
    slot rank-within-row). Returns (TileState, (n_occupied,
    distinct_hq, total_hq))."""
    rows, stats = kernels.tile_load(torch.from_numpy(payload).to(device),
                                    meta, n)
    occ, distinct, total = (int(x) for x in stats.cpu())
    return TileState(rows), (occ, distinct, total)


def tile_from_entries(khi, klo, vals, k: int, bits: int, device,
                      rb_log2: int | None = None
                      ) -> tuple[TileState, TileMeta, tuple[int, int, int]]:
    """K9 from raw entries (quorum_tpu's ctable.tile_from_entries):
    canonical mers as (khi, klo) u32 halves with their value words
    ``count << 1 | qual`` become a sealed table on `device`. The host
    hashes and ranks them (one stable sort by row; the rows double while
    one would take more than 64) into a v4 payload, which HK7 places.
    `rb_log2` is the first row count tried (by default tile_rb_for's).
    Returns (TileState, TileMeta, (n_occupied, distinct_hq, total_hq))."""
    vals = np.asarray(vals, np.uint32)
    n = len(vals)
    keys = torch.from_numpy((np.asarray(khi, np.int64) << 32)
                            | np.asarray(klo, np.int64))
    full = host_feistel(keys, k).numpy()
    rb = tile_rb_for(n, k, bits) if rb_log2 is None else rb_log2
    while True:
        meta = TileMeta(k=k, bits=bits, rb_log2=rb)
        addr = full & (meta.rows - 1)
        counts = np.bincount(addr, minlength=meta.rows)
        if n == 0 or counts.max() <= TSLOTS:
            break
        rb += 1
    order = stable_argsort(addr)
    del addr
    rows = meta.rows
    payload = np.empty(rows + (4 + meta.hi_bytes) * n, np.uint8)
    payload[:rows] = counts
    lo_out = payload[rows:rows + 4 * n].view("<u4")
    his = [payload[rows + (4 + j) * n:rows + (5 + j) * n]
           for j in range(meta.hi_bytes)]
    # the payload a chunk of the row-sorted entries at a time
    for a in range(0, n, _CHUNK):
        o = order[a:a + _CHUNK]
        v = vals[o]
        rem = full[o] >> meta.rb_log2
        lo_out[a:a + len(o)] = (
            ((rem & ((1 << meta.rlo_bits) - 1)) << (bits + 1))
            | ((v & 1).astype(np.int64) << bits)
            | np.minimum(v >> 1, meta.max_val))
        rhi = rem >> meta.rlo_bits
        for j, h in enumerate(his):
            h[a:a + len(o)] = (rhi >> (8 * j)) & 0xFF
    state, stats = tile_load(payload, meta, n, device)
    return state, meta, stats


# ------------------------------------------------------------ host helpers
# The reference-format writer's and the inspection CLIs' host view of a
# sealed table (quorum_tpu/ops/ctable.py:837-905), on kernels.ref's
# Feistel over CPU int64 tensors.

# keys a pass of the host Feistel takes: its temporaries stay in the
# core's cache, and under torch's intra-op grain (32,768) each op runs
# on the calling thread
_CHUNK = 1 << 14
# rows a pass of the host iteration reads (1 MiB of the plane)
_ROW_CHUNK = 1 << 11


def host_feistel(keys: torch.Tensor, k: int,
                 inverse: bool = False) -> torch.Tensor:
    """kernels.ref.feistel (or feistel_inverse) of a CPU int64 tensor,
    a cache-sized chunk at a time."""
    fn = kernels.ref.feistel_inverse if inverse else kernels.ref.feistel
    out = torch.empty_like(keys)
    for a in range(0, keys.numel(), _CHUNK):
        out[a:a + _CHUNK] = fn(keys[a:a + _CHUNK], k)
    return out


def stable_argsort(a: np.ndarray) -> np.ndarray:
    """np.argsort(a, kind="stable") of an integer array, by torch's
    stable sort on the host (several threads; numpy's takes one)."""
    return torch.sort(torch.from_numpy(np.ascontiguousarray(a)),
                      stable=True)[1].numpy()


def host_rows(rows) -> np.ndarray:
    """A row plane (an int32 tensor on any device, or numpy) as numpy
    uint32 [rows, 128] on the host."""
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    return np.asarray(rows).view(np.uint32)


def tile_iterate(state: TileState, meta: TileMeta):
    """(khi, klo, val) numpy uint32 arrays of every occupied entry, in
    row-major slot order (quorum_tpu's np.nonzero order); val = count
    << 1 | qual. The rows come to the host once."""
    rows = host_rows(state.rows)
    khi, klo, vals = [], [], []
    for a in range(0, rows.shape[0], _ROW_CHUNK):
        lo = rows[a:a + _ROW_CHUNK, 0::2]
        count = lo & np.uint32(meta.max_val)
        r, s = np.nonzero(count)
        lo = lo[r, s]
        vals.append((count[r, s] << np.uint32(1))
                    | ((lo >> np.uint32(meta.bits)) & np.uint32(1)))
        rem = ((lo >> np.uint32(meta.bits + 1)).astype(np.int64)
               | (rows[a:a + _ROW_CHUNK, 1::2][r, s].astype(np.int64)
                  << meta.rlo_bits))
        keys = host_feistel(torch.from_numpy((rem << meta.rb_log2) | (r + a)),
                            meta.k, inverse=True).numpy()
        khi.append((keys >> 32).astype(np.uint32))
        klo.append((keys & 0xFFFFFFFF).astype(np.uint32))
    if not vals:
        return tuple(np.zeros(0, np.uint32) for _ in range(3))
    return np.concatenate(khi), np.concatenate(klo), np.concatenate(vals)


def slot_values(rows: torch.Tensor, meta: TileMeta) -> torch.Tensor:
    """The value word (count << 1 | qual, int64; 0 where empty) of
    every slot of a row plane, on the plane's device."""
    lo = kernels.ref.u32(rows[:, 0::2])
    count = lo & meta.max_val
    return torch.where(count != 0, (count << 1) | ((lo >> meta.bits) & 1),
                       0)


def tile_lookup_np(rows, meta: TileMeta, khi, klo) -> int:
    """Scalar host lookup over a [rows, 128] plane (numpy uint32): the
    key's row matched against its tags; the stored value word, or 0."""
    key = torch.tensor([(int(khi) << 32) | int(klo)])
    addr, rlo, rhi = (int(x) for x in kernels.ref.tile_key_parts(key, meta))
    lo, hi = rows[addr, 0::2], rows[addr, 1::2]
    count = lo & np.uint32(meta.max_val)
    idx = np.flatnonzero((count != 0) & (hi == rhi)
                         & ((lo >> np.uint32(meta.bits + 1)) == rlo))
    if not len(idx):
        return 0
    j = idx[0]
    return (int(count[j]) << 1) | ((int(lo[j]) >> meta.bits) & 1)


# ------------------------------------------------------------ flat table
# K25 (quorum_tpu/ops/ctable.py:51-560): the bucket-4 table in the
# reference's hash_with_quality layout, entry = [rem | qual | count].

BUCKET = kernels.ref.BUCKET  # slots a bucket: one aligned 16-byte row
_EMPTY_TAG = kernels.ref.EMPTY
_ROUND_C = kernels.ref._ROUND_C  # the Feistel round constants


@dataclasses.dataclass(frozen=True)
class CTableMeta:
    """Static geometry. `nb_log2` = log2(number of buckets)."""

    k: int
    bits: int  # count field width (reference -b flag, default 7)
    nb_log2: int

    def __post_init__(self):
        if self.rem_bits + 1 + self.bits > 32:
            raise ValueError(
                f"compact layout infeasible: k={self.k} nb_log2="
                f"{self.nb_log2} bits={self.bits} needs "
                f"{self.rem_bits + 1 + self.bits} > 32 entry bits; "
                f"grow nb_log2 to >= {2 * self.k - (31 - self.bits)} "
                "or use the wide table")
        if self.nb_log2 < 0 or self.nb_log2 > 30:
            raise ValueError(f"nb_log2 out of range: {self.nb_log2}")

    @property
    def n_buckets(self) -> int:
        return 1 << self.nb_log2

    @property
    def size(self) -> int:
        return self.n_buckets * BUCKET

    @property
    def rem_bits(self) -> int:
        return max(0, 2 * self.k - self.nb_log2)

    @property
    def max_val(self) -> int:
        return (1 << self.bits) - 1


def min_nb_log2(k: int, bits: int = 7) -> int:
    """Smallest nb_log2 whose compact layout fits k and bits."""
    return max(0, 2 * k - (31 - bits))


def layout_fits(k: int, bits: int, nb_log2: int) -> bool:
    return max(0, 2 * k - nb_log2) + 1 + bits <= 32


def required_nb_log2(requested_entries: int, k: int, bits: int = 7) -> int:
    """nb_log2 for a user-requested entry count: buckets >= entries
    (bucket load at most 1) and the layout constraint."""
    cap = max(4, int(requested_entries - 1).bit_length())
    return max(cap, min_nb_log2(k, bits))


class CTableState(NamedTuple):
    """Sealed table (finalize_build): entries int32 [size] (slot j of
    bucket b at 4b + j) and HK20's statistics int64 [3] (occupied,
    distinct_hq, total_hq) on the same device."""

    entries: torch.Tensor
    stats: torch.Tensor


class CBuildState(NamedTuple):
    """Build-side table: keytag (-1 = 0xFFFFFFFF, empty) and the split
    quality counts hq / lq, each int32 [size]."""

    keytag: torch.Tensor
    hq: torch.Tensor
    lq: torch.Tensor


def make_build_table(meta: CTableMeta, device) -> CBuildState:
    size = meta.size
    return CBuildState(
        torch.full((size,), -1, dtype=torch.int32, device=device),
        torch.zeros(size, dtype=torch.int32, device=device),
        torch.zeros(size, dtype=torch.int32, device=device))


def bucket_rem(keys: torch.Tensor, meta: CTableMeta):
    """Canonical int64 mers -> (bucket, remainder) int64 (plain torch on
    the keys' device; HK18 and HK19 compute it inline)."""
    return kernels.ref.flat_bucket_rem(keys, meta)


def _mix32_int(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def bucket_rem_np(khi, klo, meta: CTableMeta):
    """Host twin of bucket_rem for one key given as its u32 halves:
    (bucket int, rem np.uint32), bit for bit."""
    k = meta.k
    kmask = (1 << k) - 1
    key = (int(khi) << 32) | int(klo)
    l, r = (key >> k) & kmask, key & kmask
    for c in _ROUND_C:
        l, r = r, l ^ (_mix32_int((r + c) & 0xFFFFFFFF) & kmask)
    full = (l << k) | r
    rem = (full >> meta.nb_log2) & ((1 << meta.rem_bits) - 1)
    return full & ((1 << meta.nb_log2) - 1), np.uint32(rem)


def rehash_grow(bucket, rem, nb_log2: int):
    """(bucket, rem) under nb_log2 -> the same under nb_log2 + 1: the
    full hash is (rem << nb) | bucket, so doubling moves rem's low bit
    into the bucket's top bit."""
    return bucket | ((rem & 1) << nb_log2), rem >> 1


def keys_from_table(bucket, rem, meta: CTableMeta) -> torch.Tensor:
    """Canonical int64 mers from their (bucket, rem): the Feistel
    inverse of (rem << nb_log2) | bucket (the iterator's primitive)."""
    return kernels.ref.feistel_inverse((rem << meta.nb_log2) | bucket,
                                       meta.k)


def pack_entry(rem, qual, count, meta: CTableMeta):
    """Entry words (int64 holding u32) from rem, qual bit and count."""
    return (rem << (meta.bits + 1)) | (qual.to(torch.int64) << meta.bits) \
        | count


def entry_val(entry, meta: CTableMeta):
    """Entry -> reference value word (count << 1 | qual); 0 if empty."""
    return kernels.ref.flat_entry_val(entry, meta)


def entry_rem(entry, meta: CTableMeta):
    return kernels.ref.u32(entry) >> (meta.bits + 1)


def lookup(state: CTableState, meta: CTableMeta, keys: torch.Tensor
           ) -> torch.Tensor:
    """The value word (int32) of each canonical int64 mer, 0 if absent:
    one 16-byte bucket row and four compares a key (HK19)."""
    return kernels.flat_lookup(state.entries, meta, keys)


def lookup_np(entries, meta: CTableMeta, khi, klo) -> int:
    """Scalar host lookup over a flat entry array (int32 or uint32)."""
    bucket, rem = bucket_rem_np(khi, klo, meta)
    row = np.asarray(entries).reshape(-1)[bucket * BUCKET:
                                          bucket * BUCKET + BUCKET]
    for e in row.astype(np.int64) & 0xFFFFFFFF:
        e = int(e)
        if e & ((1 << (meta.bits + 1)) - 1) and e >> (meta.bits + 1) == rem:
            return ((e & meta.max_val) << 1) | ((e >> meta.bits) & 1)
    return 0


def insert_observations(bstate: CBuildState, meta: CTableMeta,
                        keys: torch.Tensor, qual: torch.Tensor,
                        valid: torch.Tensor):
    """Count a flat batch of raw observations (canonical int64 mers,
    their qual bits, `valid` lanes only), IN PLACE (HK18: one launch;
    JAX's bounded claim rounds become one atomicCAS loop a lane, so no
    `max_rounds`). Returns (bstate, full: bool, placed mask). On full
    the caller grows and retries with `valid & ~placed`: every
    observation counts exactly once."""
    placed, full = kernels.flat_insert(bstate, meta, keys, qual, valid)
    return bstate, bool(full), placed


def finalize_build(bstate: CBuildState, meta: CTableMeta) -> CTableState:
    """Pack the split counts into entries: count-at-best-quality (the hq
    count if any hq observation, else the lq count), saturated at
    max_val; and count the statistics in the same pass (HK20)."""
    return CTableState(*kernels.flat_finalize(bstate, meta))


def grow_build(bstate: CBuildState, meta: CTableMeta
               ) -> tuple[CBuildState, CTableMeta]:
    """Double the bucket count and move every entry by rehash_grow's bit
    move, hq and lq verbatim (HK18's grow entry, one launch; JAX's
    chunks only bound its temporaries). Raises ValueError past nb_log2
    30, as JAX's does."""
    new_meta = dataclasses.replace(meta, nb_log2=meta.nb_log2 + 1)
    new = make_build_table(new_meta, bstate.keytag.device)
    kernels.flat_grow(bstate, meta, new, new_meta)
    return new, new_meta


def table_stats(state: CTableState, meta: CTableMeta
                ) -> tuple[int, int, int]:
    """(n_occupied, distinct_hq, total_hq): the statistics HK20 counted
    as it sealed the table. Exact integers (JAX sums total_hq in
    float32, the same value below 2^24)."""
    occ, distinct, total = (int(x) for x in state.stats.cpu())
    return occ, distinct, total


def iterate_entries(state: CTableState, meta: CTableMeta):
    """(khi, klo, val) numpy u32 arrays of every occupied entry, in slot
    order, computed on the entries' device (reference
    database_query::const_iterator)."""
    ent = state.entries
    chunk = 1 << 26  # bounds the mask's and nonzero's temporaries
    occ = torch.cat([torch.nonzero(ent[s:s + chunk] != 0).squeeze(1) + s
                     for s in range(0, max(ent.numel(), 1), chunk)])
    e = ent[occ]
    keys = keys_from_table(occ // BUCKET, entry_rem(e, meta), meta)
    val = entry_val(e, meta)
    return ((keys >> 32).cpu().numpy().astype(np.uint32),
            (keys & 0xFFFFFFFF).cpu().numpy().astype(np.uint32),
            val.cpu().numpy().astype(np.uint32))


def tile_from_build(bstate: CBuildState, meta: CTableMeta,
                    rb_log2: int | None = None):
    """Seal a flat build straight into the tile query layout on its
    device (HK20, then tile_from_entries: the host ranks, HK7 places).
    Returns (TileState, TileMeta, (n_occupied, distinct_hq, total_hq))."""
    khi, klo, vals = iterate_entries(finalize_build(bstate, meta), meta)
    return tile_from_entries(khi, klo, vals, meta.k, meta.bits,
                             bstate.keytag.device, rb_log2)
