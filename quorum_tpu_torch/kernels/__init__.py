"""Wrappers of the twenty-one hand-written Hopper kernels (csrc/*.cu) and
their entries.

Every wrapper checks device, dtype, shape and contiguity, then either
launches its CUDA kernel (tensors on a CUDA device) or runs the plain
PyTorch version from kernels/reference.py (tensors on the CPU). There is
no fallback: a CUDA tensor always goes to the kernel, and a failed build
or launch raises.

  HK1 tile_insert   stage-1 counting (wire -> canonical mers -> 64-bit
                    CAS claim in the 64-slot row; with the partition
                    filter of a partitioned build), plus the keys entry
                    that re-inserts observations left over by a grow,
                    and the shard entry that counts routed lanes in one
                    shard's slice (--devices N)
  HK2 tile_seal     duplicate check + fold + statistics
  HK3 tile_lookup   canonical mer -> value word; shard entry: the same
                    in a table sharded by leading row bits, read in
                    place (the routed stage-2 layout)
  HK4 extend_reads  per-(read, direction) extension with edit logs
                    (and the contaminant checks); sharded-table entry;
                    event entry: the walk that reads HK17's planes
                    (teleports, synced steps without probes)
  HK5 stage2_head   stage-2 wire widening, window lookups, anchor scan
                    (and the contaminant probe and kill); sharded-table
                    entry
  HK6 tile_export   sealed rows (a table or a row range of one) -> the
                    v4/v5 payload (sorted, compacted); compact entry
                    (counted apart): the occupied slots in slot order,
                    one pass
  HK7 tile_load     the v4/v5 payload -> sealed rows + statistics
  HK8 tile_grow     double the build table and re-insert every slot;
                    shard entry: the same for a table sharded by
                    leading row bits (bucket by new shard, then place)
  HK9 batch_aggregate  a batch's distinct mers with their multiplicities
  HK10 sketch_update   the prefilter's count-min sketch: update, query
  HK11 gated_insert    HK1 behind the sketch (two-pass and inline)
  HK12 tile_floor      the stage-2 presence floor on the sealed rows
  HK13 tile_departition  a partition pass's sealed rows -> the global
                       geometry (in place)
  HK14 pack_finish     a stage-2 batch's result -> one packed u32 buffer
                       (the single device-to-host copy of the batch)
  HK15 shard_route     a batch's observations (or left-over lanes) in
                       exact buckets by the shard that owns their row;
                       partition entry: only a partition pass's mers
  HK16 event_planes    every window's get_best_alternatives facts in
                       the frame that consumes it, classified (clean,
                       counts, level, count, ucode), and the 16-probe
                       continuation bits of every ambiguous position;
                       sharded-table entry
  HK17 event_scan      HK16's planes -> the [2B, L] frame planes of the
                       event walk (rc remap, next event, last
                       prev-defining keep and its count)
  HK18 flat_insert     counting into the flat bucket-4 table (K25): one
                       atomicCAS claim a lane; grow entry: the doubled
                       table in one launch
  HK19 flat_lookup     the flat table's lookup (one 16-byte bucket row)
  HK20 flat_finalize   the flat table's seal with its statistics
  HK21 minimizer       every k-window's mixed canonical m-mer minimizer

The sharded wrappers (HK15, the shard entries) launch on their tensors'
device; the others on the current device, which the sharded paths set
with `device_scope`. HK3, HK4, HK5 and HK16 take the sealed table as one
plane (int32 [rows, 128] under a TileMeta) or as the planes of a table
sharded by leading row bits (a list of int32 [2^local_rb, 128], shard s
on mesh[s], under a TileShardedMeta): the second form launches the
sharded-table entry, counted apart, whose probes read each row in its
owner's plane, on another card through peer access (enabled here, once
per ordered pair of devices).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import reference as ref
from .loader import call, launch, launching, library

MAX_SHARDS = 1024  # the bucket passes keep 12 bytes a shard in shared memory
# shards of a table the probes read in place (table.cuh MAX_ROUTED_SHARDS:
# the pointer table is one kernel parameter)
MAX_ROUTED_SHARDS = 64
COMPACT_TILE = 24  # rows a block of HK6's compact entry takes (CT_TILE)
# the least capacity of HK1's failure list (a sixteenth of the batch's
# windows past it); a batch that fails more lists them in a second launch
FAIL_CAP_MIN = 4096
_PEERS: set = set()  # (device, peer) pairs with peer access enabled


def _on_cuda(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devs)}")
    dev = devs.pop()
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev == "cuda"


def device_scope(dev: torch.device):
    """Make `dev` the current CUDA device (its current stream takes the
    launches); nothing for the CPU."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _check(t: torch.Tensor, dtype, name: str, align8: bool = False):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if align8 and t.data_ptr() % 8:
        raise ValueError(f"{name}: must be 8-byte aligned")


def _check_build(bstate, meta):
    _check(bstate.tag, torch.int32, "tag", align8=True)
    _check(bstate.hq, torch.int32, "hq")
    _check(bstate.lq, torch.int32, "lq")
    if tuple(bstate.tag.shape) != (meta.rows, 2 * ref.TSLOTS) \
            or bstate.hq.numel() != meta.rows * ref.TSLOTS \
            or bstate.lq.numel() != meta.rows * ref.TSLOTS:
        raise ValueError("build state does not match the table geometry")


def _wire_offsets(wire, b: int, length: int, thresholds, qual_thresh: int):
    """Check a batch's packed wire; returns (sorted thresholds,
    (off_nmask, off_hq, off_len)) for its qual >= qual_thresh plane."""
    _check(wire, torch.uint8, "wire")
    ts = sorted(int(t) for t in thresholds)
    if int(qual_thresh) not in ts:
        raise KeyError(f"wire lacks the qual>={qual_thresh} plane")
    c4, c8 = -(-length // 4), -(-length // 8)
    if wire.numel() != b * c4 + b * c8 * (1 + len(ts)) + 4 * b:
        raise ValueError("wire size does not match its geometry")
    off_nmask = b * c4
    off_hq = off_nmask + b * c8 * (1 + ts.index(int(qual_thresh)))
    return ts, (off_nmask, off_hq, b * c4 + b * c8 * (1 + len(ts)))


def _check_parts(part: int, n_parts: int):
    if n_parts < 1 or n_parts > 256 or n_parts & (n_parts - 1) \
            or not 0 <= part < n_parts:
        raise ValueError(f"partition {part} of {n_parts}: n_parts must be "
                         "a power of two in [1, 256] above part")


def _check_shards(meta):
    S = meta.n_shards
    if S < 1 or S > MAX_SHARDS or S & (S - 1):
        raise ValueError(f"{S} shards: a power of two in [1, {MAX_SHARDS}]")


def _buckets(counter: str, lib: str, fn: str, jobs: list, S: int,
             lane_shape: tuple, dtype) -> list:
    """Exact owner buckets for each job (the arguments of C launcher
    `fn` of `lib`, and the device it runs on), counted once a job as
    `counter`: phase 0 counts each owner's lanes on every job's device,
    the host then reads the S counts of each (every count pass is in
    flight before the first read waits) and scans them, and phase 1
    scatters each job's lanes into their exact buckets. Returns, in job
    order, (lanes [n, *lane_shape] in owner order, sizes: S ints)."""
    counts = []
    for args, dev in jobs:
        with device_scope(dev), launching(counter):
            c = torch.zeros(S, dtype=torch.int64, device=dev)
            call(lib, fn, *args, 0, c.data_ptr(), None)
        counts.append(c)
    sizes = [c.cpu() for c in counts]
    out = []
    for (args, dev), n in zip(jobs, sizes):
        with device_scope(dev), launching(counter, count=False):
            cursor = (torch.cumsum(n, 0) - n).to(dev)
            lanes = torch.empty((int(n.sum()), *lane_shape), dtype=dtype,
                                device=dev)
            call(lib, fn, *args, 1, cursor.data_ptr(), lanes.data_ptr())
        out.append((lanes, n.tolist()))
    return out


def _listed(plain):
    """A plain version's (lanes, sizes tensor) as a wrapper returns it."""
    lanes, sizes = plain
    return lanes, sizes.tolist()


def _pending(failed, keys):
    idx = torch.nonzero(failed).squeeze(1)
    return keys[idx], (failed[idx] >> 1).bool()


# --------------------------------------------------------------- HK1


def tile_insert_reads(bstate, meta, wire: torch.Tensor, b: int, length: int,
                      thresholds, qual_thresh: int, part: int = 0,
                      n_parts: int = 1):
    """Insert every observation of one packed batch (in place) whose mer
    pass `part` of `n_parts` owns (ref.partition_mask; every mer when
    n_parts = 1). Returns (full, (keys, qual)) with the observations that
    found no room (on the card in the order its list took them; the
    plain version's is window order, and no caller depends on it)."""
    _check_build(bstate, meta)
    _check_parts(part, n_parts)
    ts, offs = _wire_offsets(wire, b, length, thresholds, qual_thresh)
    if not _on_cuda(wire, bstate.tag):
        keys, qual = ref.tile_insert_reads(bstate, meta, wire, b, length, ts,
                                           qual_thresh, part, n_parts)
        return bool(keys.numel()), (keys, qual)
    dev = wire.device
    cap = max(FAIL_CAP_MIN, (b * length) >> 4)
    flist = torch.empty(cap, dtype=torch.int64, device=dev)
    n_fail = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (wire.data_ptr(), b, length, *offs, meta.k, meta.rb_log2,
            meta.bits, part, n_parts)
    table = (bstate.tag.data_ptr(), bstate.hq.data_ptr(),
             bstate.lq.data_ptr())
    launch("tile_insert", "tile_insert_reads", *args, 0, *table,
           flist.data_ptr(), cap, n_fail.data_ptr())
    nf = int(n_fail.item())
    if nf > cap:
        # the list overflowed: list the failed windows again, exactly (the
        # windows whose key the table now lacks)
        flist = torch.empty(nf, dtype=torch.int64, device=dev)
        n_fail.zero_()
        with launching("tile_insert", count=False):
            call("tile_insert", "tile_insert_reads", *args, 1, *table,
                 flist.data_ptr(), nf, n_fail.data_ptr())
    words = flist[:nf]
    return nf > 0, (words >> 1, (words & 1).bool())


def tile_insert_keys(bstate, meta, keys: torch.Tensor, qual: torch.Tensor):
    """Insert observations given as canonical int64 mers with their
    qual bit, one count each (keys may repeat). Returns `placed` (bool
    per observation; False where the 64-slot row is full of other
    keys)."""
    _check_build(bstate, meta)
    _check(keys, torch.int64, "keys")
    _check(qual, torch.bool, "qual")
    if not _on_cuda(keys, qual, bstate.tag):
        return ref.insert_keys(bstate, meta, keys, qual)
    placed = torch.empty(keys.numel(), dtype=torch.uint8, device=keys.device)
    launch("tile_insert", "tile_insert_keys", keys.data_ptr(),
           qual.data_ptr(), keys.numel(), meta.k, meta.rb_log2, meta.bits,
           bstate.tag.data_ptr(), bstate.hq.data_ptr(), bstate.lq.data_ptr(),
           placed.data_ptr())
    return placed.bool()


def tile_insert_shard(bstate, meta, lanes: torch.Tensor):
    """HK1's shard entry: count lanes routed to one shard (HK15's words
    (key << 1) | qual, one observation each) in `bstate`, that shard's
    slice of the table sharded as `meta` (TileShardedMeta) describes.
    Returns `placed` (bool per lane; False where the row is full)."""
    _check_shards(meta)
    _check_build(bstate, meta.local_meta)
    _check(lanes, torch.int64, "lanes")
    if not _on_cuda(lanes, bstate.tag):
        return ref.insert_shard(bstate, meta, lanes)
    placed = torch.empty(lanes.numel(), dtype=torch.uint8,
                         device=lanes.device)
    with device_scope(lanes.device), launching("tile_insert_shard"):
        call("tile_insert", "tile_insert_shard", lanes.data_ptr(),
             lanes.numel(), meta.k, meta.rb_log2, meta.bits, meta.local_rb,
             bstate.tag.data_ptr(), bstate.hq.data_ptr(),
             bstate.lq.data_ptr(), placed.data_ptr())
    return placed.bool()


# --------------------------------------------------------------- HK2


def tile_seal(bstate, meta, out: torch.Tensor | None = None):
    """Returns (rows int32 [rows, 128], stats int64 [5] = dup, occupied,
    distinct_hq, total_hq, singletons: slots with hq + lq == 1). With
    `out` (int32 [rows, 128], contiguous) the rows are written there."""
    _check_build(bstate, meta)
    if out is not None:
        _check(out, torch.int32, "out", align8=True)
        if out.shape != bstate.tag.shape or out.device != bstate.tag.device:
            raise ValueError("out does not match the build table")
    if not _on_cuda(bstate.tag):
        rows, stats = ref.tile_seal(bstate, meta)
        if out is not None:
            rows = out.copy_(rows)
        return rows, stats
    dev = bstate.tag.device
    rows = torch.empty_like(bstate.tag) if out is None else out
    stats = torch.zeros(5, dtype=torch.int64, device=dev)
    launch("tile_seal", "tile_seal", bstate.tag.data_ptr(),
           bstate.hq.data_ptr(), bstate.lq.data_ptr(), meta.rows, meta.bits,
           rows.data_ptr(), stats.data_ptr())
    return rows, stats


# --------------------------------------------------------------- HK3


def _check_rows(rows, meta):
    _check(rows, torch.int32, "rows")
    if tuple(rows.shape) != (meta.rows, 2 * ref.TSLOTS):
        raise ValueError("row plane does not match the table geometry")
    if rows.data_ptr() % 16:
        raise ValueError("rows: must be 16-byte aligned")


def enable_peer_access(dev: torch.device, peers) -> None:
    """Let kernels on CUDA device `dev` read the memory of each device of
    `peers` (cudaDeviceEnablePeerAccess once per ordered pair; a pair
    that names one device needs nothing). Raises where the host does
    not allow it."""
    for peer in peers:
        if peer.type != "cuda" or peer == dev or (dev, peer) in _PEERS:
            continue
        if not torch.cuda.can_device_access_peer(dev, peer):
            raise RuntimeError(f"{dev} cannot access the memory of {peer} "
                               "(no peer access between them)")
        rc = library("tile_lookup").enable_peer_access(dev.index, peer.index)
        if rc != 0:
            raise RuntimeError(f"enabling peer access {dev} -> {peer} "
                               f"failed with CUDA error {rc}")
        _PEERS.add((dev, peer))


def _table(rows, meta):
    """Check a sealed table in either form (one plane under a TileMeta,
    or a sequence of shard planes under a TileShardedMeta). Returns the
    tensors it is made of and, for the sharded form, its (pointer array,
    n_shards, local_rb) launch arguments (None for one plane)."""
    if isinstance(rows, torch.Tensor):
        _check_rows(rows, meta)
        return (rows,), None
    shards = tuple(rows)
    S = meta.n_shards
    if len(shards) != S or not 1 <= S <= MAX_ROUTED_SHARDS:
        raise ValueError(f"{len(shards)} shard planes for {S} shards (at "
                         f"most {MAX_ROUTED_SHARDS})")
    for s, t in enumerate(shards):
        _check(t, torch.int32, f"shard {s}")
        if tuple(t.shape) != (1 << meta.local_rb, 2 * ref.TSLOTS):
            raise ValueError(f"shard {s} does not hold 2^{meta.local_rb} "
                             "rows")
        if t.data_ptr() % 16:
            raise ValueError(f"shard {s}: must be 16-byte aligned")
    ptrs = (ctypes.c_void_p * S)(*(t.data_ptr() for t in shards))
    return shards, (ptrs, S, meta.local_rb)


def _table_ptrs(rows, parts, sharded, dev, name: str):
    """The launch's table arguments and the C launcher (also the counter
    it launches under): one pointer for `name` itself, or the shard
    pointer array, its count and local_rb for name_shard, the
    sharded-table entry, with peer access to every shard."""
    if sharded is None:
        return [rows.data_ptr()], name
    enable_peer_access(dev, [t.device for t in parts])
    return list(sharded), name + "_shard"


def tile_lookup(rows, meta, keys: torch.Tensor):
    """Value word (int64) of each canonical int64 mer, 0 if absent, in
    `rows`: one plane, or shard planes (HK3's shard entry, K10 routed:
    tile_sharded.routed_lookup_local)."""
    parts, sharded = _table(rows, meta)
    _check(keys, torch.int64, "keys")
    if not _on_cuda(keys, *parts):
        return ref.lookup(rows, meta, keys)
    out = torch.empty_like(keys)
    table, fn = _table_ptrs(rows, parts, sharded, keys.device, "tile_lookup")
    with launching(fn):
        call("tile_lookup", fn, *table, keys.data_ptr(), keys.numel(),
             meta.k, meta.rb_log2, meta.bits, out.data_ptr())
    return out


# --------------------------------------------------------------- HK4


def _contam_args(contam, meta):
    """(rows pointer or None, rb_log2, bits) of an optional contaminant
    table (rows, meta) at the main table's k."""
    if contam is None:
        return None, 0, 0
    crows, cmeta = contam
    _check_rows(crows, cmeta)
    if cmeta.k != meta.k:
        raise ValueError(f"contaminant table k = {cmeta.k}, main table "
                         f"k = {meta.k}")
    return crows.data_ptr(), cmeta.rb_log2, cmeta.bits


def extend_reads(rows, meta, codes, hqb, lengths, status0, start_off, anc_f,
                 anc_r, prev0, keep, *, window: int, error: int,
                 min_count: int, cutoff: int, maxe: int, contam=None,
                 trim_contaminant: bool = False, planes=None):
    """Extend every read whose anchor status is OK both ways, checking
    the optional contaminant table (rows, meta) (see
    reference.extend_reads for the outputs). The table is one plane on
    the reads' device or shard planes (the sharded-table entry); every
    other tensor on the reads' device. With `planes` (event_scan's
    output) the event entry walks the JAX package's event mode, counted
    apart as extend_reads_event (and _shard)."""
    parts, sharded = _table(rows, meta)
    b, l = codes.shape
    _check(codes, torch.int8, "codes")
    _check(hqb, torch.bool, "hqb")
    _check(lengths, torch.int32, "lengths")
    _check(status0, torch.int32, "status0")
    _check(start_off, torch.int32, "start_off")
    _check(anc_f, torch.int64, "anc_f")
    _check(anc_r, torch.int64, "anc_r")
    _check(prev0, torch.int32, "prev0")
    _check(keep, torch.uint8, "keep")
    if tuple(keep.shape) != (4 * meta.max_val + 1, meta.max_val + 1):
        raise ValueError("keep table does not match max_val")
    cptr, crb, cbits = _contam_args(contam, meta)
    if planes is not None:
        _check_planes(planes, b, l)
    kw = dict(window=window, error=error, min_count=min_count,
              cutoff=cutoff, maxe=maxe)
    if not _on_cuda(*parts, codes, keep, *(contam[:1] if contam else ()),
                    *(planes or ())):
        return ref.extend_reads(rows, meta, codes, hqb, lengths, status0,
                                start_off, anc_f, anc_r, prev0, keep,
                                contam=contam,
                                trim_contaminant=trim_contaminant,
                                planes=planes, **kw)
    dev = codes.device
    out = codes.clone()
    start = torch.empty(b, dtype=torch.int32, device=dev)
    end = torch.empty(b, dtype=torch.int32, device=dev)
    lstatus = torch.empty(2 * b, dtype=torch.int32, device=dev)
    log_n = torch.empty(2 * b, dtype=torch.int32, device=dev)
    log_lwin = torch.empty(2 * b, dtype=torch.int32, device=dev)
    log_pos = torch.zeros((2 * b, maxe), dtype=torch.int32, device=dev)
    log_meta = torch.zeros((2 * b, maxe), dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    table, fn = _table_ptrs(rows, parts, sharded, dev,
                            "extend_reads" if planes is None
                            else "extend_reads_event")
    pargs = [] if planes is None else [t.data_ptr() for t in planes]
    with launching(fn):
        call("extend_reads", fn, *table, meta.k, meta.rb_log2, meta.bits,
             cptr, crb, cbits, int(trim_contaminant), codes.data_ptr(),
             hqb.data_ptr(), lengths.data_ptr(), status0.data_ptr(),
             start_off.data_ptr(), anc_f.data_ptr(), anc_r.data_ptr(),
             prev0.data_ptr(), keep.data_ptr(), *pargs, b, l, window, error,
             min_count, cutoff, maxe, out.data_ptr(), start.data_ptr(),
             end.data_ptr(), lstatus.data_ptr(), log_n.data_ptr(),
             log_lwin.data_ptr(), log_pos.data_ptr(), log_meta.data_ptr(),
             overflow.data_ptr())
    fwd = (log_n[:b], log_lwin[:b], log_pos[:b], log_meta[:b])
    bwd = (log_n[b:], log_lwin[b:], log_pos[b:], log_meta[b:])
    return out, start, end, lstatus, fwd, bwd, overflow


# --------------------------------------------------------------- HK5


def stage2_head(rows, meta, wire: torch.Tensor, b: int, length: int,
                thresholds, qual_cutoff: int, *, skip: int, good: int,
                anchor_count: int, contam=None,
                trim_contaminant: bool = False):
    """One stage-2 batch from its packed wire to HK4's inputs: (codes
    int8 [B, L], hqb bool [B, L] = qual >= qual_cutoff, lengths int32
    [B], (found bool, start_off int32, f int64, r int64, prev int32,
    status int32)) -- the anchors of corrector.find_anchors, with the
    optional contaminant table (rows, meta). The table is one plane or
    shard planes (the sharded-table entry)."""
    parts, sharded = _table(rows, meta)
    ts, offs = _wire_offsets(wire, b, length, thresholds, qual_cutoff)
    cptr, crb, cbits = _contam_args(contam, meta)
    kw = dict(skip=skip, good=good, anchor_count=anchor_count)
    if not _on_cuda(*parts, wire, *(contam[:1] if contam else ())):
        return ref.stage2_head(rows, meta, wire, b, length, ts, qual_cutoff,
                               contam=contam,
                               trim_contaminant=trim_contaminant, **kw)
    dev = wire.device
    codes = torch.empty((b, length), dtype=torch.int8, device=dev)
    hqb = torch.empty((b, length), dtype=torch.bool, device=dev)
    lengths = torch.empty(b, dtype=torch.int32, device=dev)
    found = torch.empty(b, dtype=torch.bool, device=dev)
    start_off = torch.empty(b, dtype=torch.int32, device=dev)
    anc_f = torch.empty(b, dtype=torch.int64, device=dev)
    anc_r = torch.empty(b, dtype=torch.int64, device=dev)
    prev = torch.empty(b, dtype=torch.int32, device=dev)
    status = torch.empty(b, dtype=torch.int32, device=dev)
    table, fn = _table_ptrs(rows, parts, sharded, dev, "stage2_head")
    with launching(fn):
        call("stage2_head", fn, wire.data_ptr(), b, length, *offs, *table,
             meta.k, meta.rb_log2, meta.bits, cptr, crb, cbits,
             int(trim_contaminant), skip, good, anchor_count,
             codes.data_ptr(), hqb.data_ptr(), lengths.data_ptr(),
             found.data_ptr(), start_off.data_ptr(), anc_f.data_ptr(),
             anc_r.data_ptr(), prev.data_ptr(), status.data_ptr())
    return codes, hqb, lengths, (found, start_off, anc_f, anc_r, prev,
                                 status)


# --------------------------------------------------------------- HK6


def _scan_scratch(nrows: int, dev):
    """HK6/HK7 scratch: chunk sums and per-row first entry (+ total)."""
    return (torch.empty(-(-nrows // 1024), dtype=torch.int64, device=dev),
            torch.empty(nrows + 1, dtype=torch.int64, device=dev))


def _check_range(rows, meta) -> int:
    """A sealed plane that is `meta`'s table or a row range of it (one
    shard: meta.rows / 2^j rows); returns its row count."""
    _check(rows, torch.int32, "rows")
    nrows = rows.shape[0]
    if rows.dim() != 2 or rows.shape[1] != 2 * ref.TSLOTS or nrows < 1 \
            or nrows > meta.rows or meta.rows % nrows:
        raise ValueError("row plane is not the table or a shard of it")
    if rows.data_ptr() % 16:
        raise ValueError("rows: must be 16-byte aligned")
    return nrows


def _export_counts(rows, nrows: int, meta):
    """HK6 pass 1 (inside the caller's launch): per-row occupancy
    counts and their exclusive scan `first` (first[nrows] = total)."""
    dev = rows.device
    counts = torch.empty(nrows, dtype=torch.uint8, device=dev)
    sums, first = _scan_scratch(nrows, dev)
    call("tile_export", "tile_export_counts", rows.data_ptr(), nrows,
         meta.bits, counts.data_ptr(), sums.data_ptr(), first.data_ptr())
    return counts, first


def tile_export(rows: torch.Tensor, meta) -> torch.Tensor:
    """The v4/v5 payload (uint8 tensor on the rows' device) of `rows`,
    meta's table or a row range of it at meta's geometry (one shard):
    per-row occupancy counts, the entries' LE u32 lo words in canonical
    order (each row sorted by (hi, lo)), then meta.hi_bytes byte planes
    of their hi words."""
    nrows = _check_range(rows, meta)
    if not _on_cuda(rows):
        return ref.tile_export(rows, meta)
    with launching("tile_export"):
        counts, first = _export_counts(rows, nrows, meta)
        n = int(first[nrows].item())  # sizes the payload
        out = torch.empty(nrows + (4 + meta.hi_bytes) * n,
                          dtype=torch.uint8, device=rows.device)
        call("tile_export", "tile_export_rows", rows.data_ptr(), nrows,
             meta.bits, counts.data_ptr(), first.data_ptr(), n,
             meta.hi_bytes, out.data_ptr())
    return out


def tile_compact(rows: torch.Tensor, meta, cap: int):
    """HK6's compact entry (K22), counted apart as tile_export_compact:
    the occupied slots of `rows` (meta's table or a row range of it) as
    (row address int32, lo int32, hi int32) in row-major slot order, in
    `cap` lanes (zeros past the n-th; entries past cap are dropped), and
    n int64 (0-dim), the occupied slots in all. One pass over the rows;
    the kernel writes every lane and n."""
    nrows = _check_range(rows, meta)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    if not _on_cuda(rows):
        return ref.tile_compact(rows, meta, cap)
    dev = rows.device
    addr, lo, hi = (torch.empty(cap, dtype=torch.int32, device=dev)
                    for _ in range(3))
    # a status word per tile of COMPACT_TILE rows, the tile ticket, n
    status = torch.zeros(-(-nrows // COMPACT_TILE) + 2, dtype=torch.int64,
                         device=dev)
    with launching("tile_export_compact"):
        call("tile_export", "tile_export_compact", rows.data_ptr(), nrows,
             meta.bits, cap, addr.data_ptr(), lo.data_ptr(), hi.data_ptr(),
             status.data_ptr(), status.numel())
    return addr, lo, hi, status[-1]


# --------------------------------------------------------------- HK7


def tile_load(payload: torch.Tensor, meta, n: int, nrows: int | None = None):
    """The sealed rows (int32 [nrows, 128]) of a v4/v5 payload of n
    entries, and their stats int64 [3] = (occupied, distinct_hq,
    total_hq): meta's table, or with `nrows` a row range of it at meta's
    geometry (one shard of a table sharded by leading row bits; hi words
    of meta.hi_bytes). The caller has checked the payload's structure
    (size, at most 64 entries a row, counts summing to n)."""
    nrows = meta.rows if nrows is None else nrows
    _check(payload, torch.uint8, "payload")
    if nrows < 1 or meta.rows % nrows:
        raise ValueError("row range is not the table or a shard of it")
    if payload.numel() != nrows + (4 + meta.hi_bytes) * n:
        raise ValueError("payload size does not match its geometry")
    if not _on_cuda(payload):
        return ref.tile_load(payload, meta, n, nrows)
    dev = payload.device
    rows = torch.empty((nrows, 2 * ref.TSLOTS), dtype=torch.int32,
                       device=dev)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    sums, first = _scan_scratch(nrows, dev)
    launch("tile_load", "tile_load", payload.data_ptr(), nrows, n,
           meta.hi_bytes, meta.bits, sums.data_ptr(), first.data_ptr(),
           rows.data_ptr(), stats.data_ptr())
    return rows, stats


# --------------------------------------------------------------- HK8


def tile_grow(bstate, meta, new, new_meta) -> bool:
    """Re-insert every live slot of `bstate` into `new`, a fresh build
    table of twice the rows (new_meta.rb_log2 = meta.rb_log2 + 1).
    Returns True if a slot found no room (it cannot: a doubled row
    takes the keys of one old row)."""
    _check_build(bstate, meta)
    _check_build(new, new_meta)
    if new_meta.rb_log2 != meta.rb_log2 + 1 or new_meta.k != meta.k \
            or new_meta.bits != meta.bits:
        raise ValueError("new table is not the doubled geometry")
    if not _on_cuda(bstate.tag, new.tag):
        return ref.tile_grow(bstate, meta, new, new_meta)
    full = torch.zeros(1, dtype=torch.int32, device=new.tag.device)
    launch("tile_grow", "tile_grow", bstate.tag.data_ptr(),
           bstate.hq.data_ptr(), bstate.lq.data_ptr(), meta.rows,
           meta.rb_log2, meta.rlo_bits, new.tag.data_ptr(),
           new.hq.data_ptr(), new.lq.data_ptr(), full.data_ptr())
    return bool(full.item())


def tile_grow_shard(shards: list, meta) -> list:
    """HK8's shard entry, pass 1: the live slots of every shard
    (`shards[s]`, shard s's slice under the sharded geometry `meta`
    before the doubling) as lanes int32 [n, 5] = (row, rlo, rhi, hq, lq)
    of the doubled geometry, in exact buckets by their new shard.
    Returns [(lanes, sizes: S ints)] in shard order; tile_grow_place
    claims each bucket on its shard."""
    _check_shards(meta)
    if len(shards) != meta.n_shards:
        raise ValueError(f"{len(shards)} shards of {meta.n_shards}")
    for b in shards:
        _check_build(b, meta.local_meta)
    if not _on_cuda(*(b.tag for b in shards)):
        return [_listed(ref.grow_shard(b, meta, s))
                for s, b in enumerate(shards)]
    return _buckets("tile_grow_shard", "tile_grow", "tile_grow_shard",
                    [([b.tag.data_ptr(), b.hq.data_ptr(), b.lq.data_ptr(),
                       meta.local_rb, s, meta.owner_bits, meta.rlo_bits],
                      b.tag.device) for s, b in enumerate(shards)],
                    meta.n_shards, (5,), torch.int32)


def tile_grow_place(new, new_meta, lanes: torch.Tensor) -> bool:
    """HK8's shard entry, pass 2: claim the grow lanes routed to one
    shard in `new`, its fresh slice under the doubled sharded geometry
    `new_meta`. Returns True if a lane found no room (it cannot)."""
    _check_shards(new_meta)
    _check_build(new, new_meta.local_meta)
    _check(lanes, torch.int32, "lanes")
    if lanes.dim() != 2 or lanes.shape[1] != 5:
        raise ValueError("grow lanes must be int32 [n, 5]")
    if not _on_cuda(lanes, new.tag):
        return ref.grow_place(new, lanes)
    full = torch.zeros(1, dtype=torch.int32, device=lanes.device)
    with device_scope(lanes.device), launching("tile_grow_shard"):
        call("tile_grow", "tile_grow_place", lanes.data_ptr(), lanes.shape[0],
             new.tag.data_ptr(), new.hq.data_ptr(), new.lq.data_ptr(),
             full.data_ptr())
        return bool(full.item())


# --------------------------------------------------------------- HK9


def batch_aggregate(wire: torch.Tensor, b: int, length: int, thresholds,
                    qual_thresh: int, k: int):
    """One packed batch's distinct canonical mers as lanes: (keys int64,
    hq int32, lq int32) -- each mer's observations in the batch by qual
    class. On the card the lanes are the slots of a scratch hash of at
    least twice the batch's windows, empty ones holding key -1; the
    plain version returns the distinct mers only. Every consumer skips
    keys < 0 and reads lanes in any order."""
    ts, offs = _wire_offsets(wire, b, length, thresholds, qual_thresh)
    if not _on_cuda(wire):
        return ref.batch_aggregate(wire, b, length, ts, qual_thresh, k)
    dev = wire.device
    slots_log2 = max(10, (2 * b * length - 1).bit_length())
    keys = torch.empty(1 << slots_log2, dtype=torch.int64, device=dev)
    hq = torch.empty(1 << slots_log2, dtype=torch.int32, device=dev)
    lq = torch.empty_like(hq)
    launch("batch_aggregate", "batch_aggregate", wire.data_ptr(), b, length,
           *offs, k, slots_log2, keys.data_ptr(), hq.data_ptr(),
           lq.data_ptr())
    return keys, hq, lq


# --------------------------------------------------------------- HK10


def _check_sketch(cells: torch.Tensor, cells_log2: int):
    _check(cells, torch.uint8, "cells")
    if not 10 <= cells_log2 <= 30 or cells.numel() != 1 << cells_log2:
        raise ValueError("sketch does not match its geometry")
    if cells.data_ptr() % 4:
        raise ValueError("cells: must be 4-byte aligned")


def _check_lanes(keys, hq, lq):
    _check(keys, torch.int64, "keys")
    _check(hq, torch.int32, "hq")
    _check(lq, torch.int32, "lq")
    if not keys.numel() == hq.numel() == lq.numel():
        raise ValueError("lanes differ in length")


def sketch_min(cells: torch.Tensor, cells_log2: int, keys: torch.Tensor):
    """The count-min query of each lane: min(cell[a1], cell[a2]) as
    int32, 0 for an empty lane (key < 0)."""
    _check_sketch(cells, cells_log2)
    _check(keys, torch.int64, "keys")
    if not _on_cuda(cells, keys):
        return ref.sketch_min(cells, cells_log2, keys)
    out = torch.empty(keys.numel(), dtype=torch.int32, device=keys.device)
    launch("sketch_update", "sketch_min", keys.data_ptr(), keys.numel(),
           cells_log2, cells.data_ptr(), out.data_ptr())
    return out


def sketch_update(cells: torch.Tensor, cells_log2: int, keys: torch.Tensor,
                  hq: torch.Tensor, lq: torch.Tensor) -> None:
    """Update the sketch in place with a batch's DISTINCT lanes (HK9):
    per hash in turn, each touched cell becomes min(2, old + the largest
    min(mult, 2) of the lanes hashing to it)."""
    _check_sketch(cells, cells_log2)
    _check_lanes(keys, hq, lq)
    if not _on_cuda(cells, keys, hq, lq):
        ref.sketch_update(cells, cells_log2, keys, hq, lq)
        return
    launch("sketch_update", "sketch_update", keys.data_ptr(), hq.data_ptr(),
           lq.data_ptr(), keys.numel(), cells_log2, cells.data_ptr())


# --------------------------------------------------------------- HK11


def gated_insert_reads(bstate, meta, cells: torch.Tensor, cells_log2: int,
                       wire: torch.Tensor, b: int, length: int, thresholds,
                       qual_thresh: int, part: int = 0, n_parts: int = 1):
    """Two-pass prefilter insert of one packed batch (in place): HK1 on
    the observations whose mer pass `part` of `n_parts` owns and the
    finished sketch saw >= 2 times (the partition filter first). Returns
    (full, (keys, qual) of the gated observations that found no room,
    dropped int64 [2] = the owned observations the gate dropped, hq and
    lq)."""
    _check_build(bstate, meta)
    _check_sketch(cells, cells_log2)
    _check_parts(part, n_parts)
    ts, offs = _wire_offsets(wire, b, length, thresholds, qual_thresh)
    if not _on_cuda(wire, cells, bstate.tag):
        (keys, qual), dropped = ref.gated_insert_reads(
            bstate, meta, cells, cells_log2, wire, b, length, ts,
            qual_thresh, part, n_parts)
        return bool(keys.numel()), (keys, qual), dropped
    dev = wire.device
    n = b * length
    failed = torch.empty(n, dtype=torch.uint8, device=dev)
    fkeys = torch.empty(n, dtype=torch.int64, device=dev)
    full = torch.zeros(1, dtype=torch.int32, device=dev)
    dropped = torch.zeros(2, dtype=torch.int64, device=dev)
    launch("gated_insert", "gated_insert_reads", wire.data_ptr(), b, length,
           *offs, meta.k, meta.rb_log2, meta.bits, part, n_parts,
           cells.data_ptr(),
           cells_log2, bstate.tag.data_ptr(), bstate.hq.data_ptr(),
           bstate.lq.data_ptr(), failed.data_ptr(), fkeys.data_ptr(),
           full.data_ptr(), dropped.data_ptr())
    if not int(full.item()):
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return False, (empty, empty.bool()), dropped
    return True, _pending(failed, fkeys), dropped


def gated_insert_lanes(bstate, meta, keys: torch.Tensor, hq: torch.Tensor,
                       lq: torch.Tensor, old: torch.Tensor):
    """Inline prefilter insert of a batch's distinct lanes (HK9) with
    `old`, the PRE-batch sketch's query of each (sketch_min): the gate,
    the retro credit and the claim (in place). Returns (failed bool per
    lane: gated but without room, dropped int64 [2] = the gated-out
    lanes' hq and lq totals)."""
    _check_build(bstate, meta)
    _check_lanes(keys, hq, lq)
    _check(old, torch.int32, "old")
    if old.numel() != keys.numel():
        raise ValueError("old differs from the lanes in length")
    if not _on_cuda(keys, hq, lq, old, bstate.tag):
        return ref.gated_insert_lanes(bstate, meta, keys, hq, lq, old)
    dev = keys.device
    failed = torch.empty(keys.numel(), dtype=torch.uint8, device=dev)
    full = torch.zeros(1, dtype=torch.int32, device=dev)
    dropped = torch.zeros(2, dtype=torch.int64, device=dev)
    launch("gated_insert", "gated_insert_lanes", keys.data_ptr(),
           hq.data_ptr(), lq.data_ptr(), old.data_ptr(), keys.numel(),
           meta.k, meta.rb_log2, meta.bits, bstate.tag.data_ptr(),
           bstate.hq.data_ptr(), bstate.lq.data_ptr(), failed.data_ptr(),
           full.data_ptr(), dropped.data_ptr())
    return failed.bool(), dropped


# --------------------------------------------------------------- HK12


def tile_floor(rows: torch.Tensor, meta, floor: int) -> None:
    """Zero, in place, both words of every entry of the sealed rows
    whose stored count is below `floor`."""
    _check_rows(rows, meta)
    if not 0 <= floor < 2 ** 31:
        raise ValueError(f"presence floor out of range: {floor}")
    if not _on_cuda(rows):
        ref.tile_floor(rows, meta, floor)
        return
    launch("tile_floor", "tile_floor", rows.data_ptr(), meta.rows, meta.bits,
           floor)


# --------------------------------------------------------------- HK13


def tile_departition(rows: torch.Tensor, meta, g: int, part: int):
    """Rebase, IN PLACE, pass `part` of 2^g's sealed rows at the local
    geometry `meta` onto the global geometry meta.rb_log2 + g (K20,
    ctable.tile_departition_rows). Returns bad int32 [1]: 1 if an
    occupied slot's dropped remainder bits disagree with `part`."""
    _check_rows(rows, meta)
    if not 1 <= g <= 8 or not 0 <= part < 1 << g:
        raise ValueError(f"partition {part} of 2^{g}: g must be in [1, 8]")
    if not _on_cuda(rows):
        return ref.tile_departition(rows, meta, g, part)
    bad = torch.zeros(1, dtype=torch.int32, device=rows.device)
    hi_bits = max(0, 2 * meta.k - (meta.rb_log2 + g) - meta.rlo_bits)
    launch("tile_departition", "tile_departition", rows.data_ptr(),
           meta.rows, meta.bits, g, part, hi_bits, bad.data_ptr())
    return bad

# --------------------------------------------------------------- HK14


def pack_finish(start, end, status_f, status_b, fwd, bwd, overflow, *,
                length: int, cap: int):
    """K14: one stage-2 batch's result -- start, end, the forward and
    backward lanes' statuses (int32 [B]), fwd/bwd = (n [B], pos
    [B, maxe], meta [B, maxe]) int32 logs and HK4's overflow flag -- in
    one buffer (see reference.pack_finish for the layout) with room for
    `cap` log entries. Returns (buffer int32 [2 + 3B + cap], merged
    status int32 [B]). Raises where `length` (the batch's read length)
    would not fit a biased 16-bit position."""
    if length >= (1 << 15) - ref.POS_BIAS:
        raise ValueError(f"read length {length} overflows the int16 packed "
                         "layout")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    b = start.numel()
    maxe = fwd[1].shape[1]
    for name, t in (("start", start), ("end", end), ("status_f", status_f),
                    ("status_b", status_b), ("f_n", fwd[0]),
                    ("b_n", bwd[0])):
        _check(t, torch.int32, name)
        if t.numel() != b:
            raise ValueError(f"{name}: expected {b} values")
    for name, t in (("f_pos", fwd[1]), ("f_meta", fwd[2]), ("b_pos", bwd[1]),
                    ("b_meta", bwd[2])):
        _check(t, torch.int32, name)
        if tuple(t.shape) != (b, maxe):
            raise ValueError(f"{name}: expected shape ({b}, {maxe})")
    _check(overflow, torch.int32, "overflow")
    if not _on_cuda(start, end, status_f, status_b, *fwd, *bwd, overflow):
        return ref.pack_finish(start, end, status_f, status_b, fwd, bwd,
                               overflow, cap)
    dev = start.device
    buf = torch.empty(2 + 3 * b + cap, dtype=torch.int32, device=dev)
    status = torch.empty(b, dtype=torch.int32, device=dev)
    sums = torch.empty(max(b, 1), dtype=torch.int64, device=dev)  # scratch
    launch("pack_finish", "pack_finish", start.data_ptr(), end.data_ptr(),
           status_f.data_ptr(), status_b.data_ptr(), fwd[0].data_ptr(),
           bwd[0].data_ptr(), overflow.data_ptr(), fwd[1].data_ptr(),
           fwd[2].data_ptr(), bwd[1].data_ptr(), bwd[2].data_ptr(), b, maxe,
           cap, buf.data_ptr(), status.data_ptr(), sums.data_ptr())
    return buf, status


# --------------------------------------------------------------- HK15


def shard_route(batches: list, qual_thresh: int, meta, part: int = 0,
                n_parts: int = 1) -> list:
    """HK15: for each packed batch (wire, b, length, thresholds) -- one
    a shard, each a shard's row range of one batch, on that shard's
    device -- every observation as a lane (key << 1) | qual int64, in
    exact buckets by the shard that owns the mer's row under `meta`
    (TileShardedMeta). With n_parts > 1, HK15's partition entry (a pass
    of the partitioned build): only the observations whose mer pass
    `part` owns (ref.partition_mask at meta's global geometry). Returns
    [(lanes, sizes: S ints)] in batch order; bucket o is
    lanes[sum(sizes[:o]):sum(sizes[:o + 1])], in the launch's order."""
    _check_shards(meta)
    _check_parts(part, n_parts)
    parsed = [(w, b, n, *_wire_offsets(w, b, n, t, qual_thresh))
              for w, b, n, t in batches]
    if not _on_cuda(*(p[0] for p in parsed)):
        return [_listed(ref.shard_route(w, b, n, ts, qual_thresh, meta, part,
                                        n_parts))
                for w, b, n, ts, _offs in parsed]
    fn, extra = (("shard_route_part", [part, n_parts]) if n_parts > 1
                 else ("shard_route_wire", []))
    return _buckets("shard_route_part" if n_parts > 1 else "shard_route",
                    "shard_route", fn,
                    [([w.data_ptr(), b, n, *offs, meta.k, meta.rb_log2,
                       meta.bits, meta.local_rb, meta.n_shards, *extra],
                      w.device)
                     for w, b, n, _ts, offs in parsed],
                    meta.n_shards, (), torch.int64)


def shard_route_lanes(lanes: list, meta) -> list:
    """HK15's lanes entry: each tensor of lanes (key << 1) | qual (the
    observations a full row left over, one tensor a shard, routed again
    after the grow) in exact buckets by their owner under `meta`.
    Returns [(lanes, sizes: S ints)] in the same order."""
    _check_shards(meta)
    for x in lanes:
        _check(x, torch.int64, "lanes")
    if not _on_cuda(*lanes):
        return [_listed(ref.shard_route_lanes(x, meta)) for x in lanes]
    return _buckets("shard_route", "shard_route", "shard_route_lanes",
                    [([x.data_ptr(), x.numel(), meta.k, meta.rb_log2,
                       meta.bits, meta.local_rb, meta.n_shards], x.device)
                     for x in lanes], meta.n_shards, (), torch.int64)


# --------------------------------------------------------------- HK16


# HK17's frame planes: clean, nd, cnt, aux, lastc1, prevval, mf, mr
_PLANE_DTYPES = (torch.bool, torch.int32, torch.int32, torch.int32,
                 torch.int32, torch.int32, torch.int64, torch.int64)


def _check_planes(planes, b: int, l: int):
    """HK17's output, as the event walk takes it."""
    if len(planes) != len(_PLANE_DTYPES):
        raise ValueError(f"expected {len(_PLANE_DTYPES)} event planes")
    for i, (t, dt) in enumerate(zip(planes, _PLANE_DTYPES)):
        _check(t, dt, f"plane {i}")
        if tuple(t.shape) != (2 * b, l):
            raise ValueError(f"plane {i}: expected shape ({2 * b}, {l})")


def event_planes(rows, meta, codes, hqb, lengths, start_off, keep, *,
                 min_count: int, cutoff: int, contam=None):
    """HK16: every window's exact get_best_alternatives facts in the
    frame that consumes it, classified, and the continuation bits of
    every ambiguous position (see reference.event_planes): (clean bool,
    cnt int32, aux int32, val int32, f int64, r int64), all [B, L] in
    read coordinates. Pass 1 (classify) runs a thread per window, its
    warp probing the rows of its windows together, and lists the
    ambiguous positions; pass 2 (prepass) a warp per listed position. The table is one plane or shard planes (the sharded-table
    entry, counted apart as event_planes_shard); the optional
    contaminant table (rows, meta) marks member windows unclean."""
    parts, sharded = _table(rows, meta)
    b, l = codes.shape
    _check(codes, torch.int8, "codes")
    _check(hqb, torch.bool, "hqb")
    _check(lengths, torch.int32, "lengths")
    _check(start_off, torch.int32, "start_off")
    _check(keep, torch.uint8, "keep")
    if tuple(keep.shape) != (4 * meta.max_val + 1, meta.max_val + 1):
        raise ValueError("keep table does not match max_val")
    cptr, crb, cbits = _contam_args(contam, meta)
    if not _on_cuda(*parts, codes, keep, *(contam[:1] if contam else ())):
        return ref.event_planes(rows, meta, codes, hqb, lengths, start_off,
                                keep, min_count=min_count, cutoff=cutoff,
                                contam=contam)
    dev = codes.device
    clean = torch.empty((b, l), dtype=torch.bool, device=dev)
    cnt = torch.empty((b, l), dtype=torch.int32, device=dev)
    aux = torch.empty((b, l), dtype=torch.int32, device=dev)
    val = torch.empty((b, l), dtype=torch.int32, device=dev)
    f = torch.empty((b, l), dtype=torch.int64, device=dev)
    r = torch.empty((b, l), dtype=torch.int64, device=dev)
    amb = torch.empty(b * l, dtype=torch.int32, device=dev)
    n_amb = torch.zeros(1, dtype=torch.int32, device=dev)
    table, name = _table_ptrs(rows, parts, sharded, dev, "event_planes")
    suffix = name[len("event_planes"):]
    geom = [meta.k, meta.rb_log2, meta.bits]
    with launching(name):
        call("event_planes", "event_classify" + suffix, *table, *geom, cptr,
             crb, cbits, codes.data_ptr(), hqb.data_ptr(),
             lengths.data_ptr(), start_off.data_ptr(), keep.data_ptr(), b, l,
             min_count, cutoff, clean.data_ptr(), cnt.data_ptr(),
             aux.data_ptr(), val.data_ptr(), f.data_ptr(), r.data_ptr(),
             amb.data_ptr(), n_amb.data_ptr())
        call("event_planes", "event_prepass" + suffix, *table, *geom,
             codes.data_ptr(), lengths.data_ptr(), start_off.data_ptr(), b,
             l, min_count, cnt.data_ptr(), aux.data_ptr(), f.data_ptr(),
             r.data_ptr(), amb.data_ptr(), n_amb.data_ptr())
    return clean, cnt, aux, val, f, r


# --------------------------------------------------------------- HK17


def event_scan(clean, cnt, aux, val, f, r, lengths, k: int):
    """HK17: HK16's [B, L] planes -> the [2B, L] frame planes of the
    event walk, forward rows then reverse-complement rows (see
    reference.event_scan): (clean bool, nd, cnt, aux, lastc1, prevval
    int32, mf, mr int64)."""
    b, l = clean.shape
    for name, t, dt in (("clean", clean, torch.bool), ("cnt", cnt,
                                                       torch.int32),
                        ("aux", aux, torch.int32), ("val", val, torch.int32),
                        ("f", f, torch.int64), ("r", r, torch.int64)):
        _check(t, dt, name)
        if tuple(t.shape) != (b, l):
            raise ValueError(f"{name}: expected shape ({b}, {l})")
    _check(lengths, torch.int32, "lengths")
    if not _on_cuda(clean, cnt, aux, val, f, r, lengths):
        return ref.event_scan(clean, cnt, aux, val, f, r, lengths, k)
    dev = clean.device
    out = [torch.empty((2 * b, l), dtype=dt, device=dev)
           for dt in _PLANE_DTYPES]
    launch("event_scan", "event_scan", clean.data_ptr(), cnt.data_ptr(),
           aux.data_ptr(), val.data_ptr(), f.data_ptr(), r.data_ptr(),
           lengths.data_ptr(), b, l, k, *(t.data_ptr() for t in out))
    return tuple(out)


# --------------------------------------------------------------- HK18


def _check_flat(bstate, meta):
    for name in ("keytag", "hq", "lq"):
        t = getattr(bstate, name)
        _check(t, torch.int32, name)
        if t.numel() != meta.size:
            raise ValueError("build state does not match the table geometry")
    if bstate.keytag.data_ptr() % 16:
        raise ValueError("keytag: must be 16-byte aligned")


def _check_obs(keys, *masks):
    _check(keys, torch.int64, "keys")
    for i, t in enumerate(masks):
        _check(t, torch.bool, f"mask {i}")
        if t.shape != keys.shape:
            raise ValueError("observation planes differ in shape")


def flat_insert(bstate, meta, keys: torch.Tensor, qual: torch.Tensor,
                valid: torch.Tensor):
    """Count each `valid` observation (canonical int64 mer, qual bit) in
    the flat build table, in place. Returns (placed bool per lane, full:
    a valid lane met a bucket holding four other keys; an int32 [1]
    tensor on the card)."""
    _check_flat(bstate, meta)
    _check_obs(keys, qual, valid)
    if not _on_cuda(keys, qual, valid, bstate.keytag):
        return ref.flat_insert(bstate, meta, keys, qual, valid)
    placed = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    full = torch.zeros(1, dtype=torch.int32, device=keys.device)
    launch("flat_insert", "flat_insert", keys.data_ptr(), qual.data_ptr(),
           valid.data_ptr(), keys.numel(), meta.k, meta.nb_log2,
           meta.rem_bits, bstate.keytag.data_ptr(), bstate.hq.data_ptr(),
           bstate.lq.data_ptr(), placed.data_ptr(), full.data_ptr())
    return placed, full


def flat_grow(bstate, meta, new, new_meta) -> None:
    """HK18's grow entry: move every occupied slot of the build table
    into the empty doubled table `new` (rehash_grow's bit move, hq and lq
    verbatim); a doubled bucket takes the keys of one old bucket, so
    every key finds room."""
    _check_flat(bstate, meta)
    _check_flat(new, new_meta)
    if new_meta.nb_log2 != meta.nb_log2 + 1:
        raise ValueError("the new table must have twice the buckets")
    if not _on_cuda(bstate.keytag, new.keytag):
        return ref.flat_grow(bstate, meta, new, new_meta)
    with launching("flat_grow"):
        call("flat_insert", "flat_grow", bstate.keytag.data_ptr(),
             bstate.hq.data_ptr(), bstate.lq.data_ptr(), meta.size,
             new.keytag.data_ptr(), new.hq.data_ptr(), new.lq.data_ptr())


# --------------------------------------------------------------- HK19


def _check_entries(entries, meta):
    _check(entries, torch.int32, "entries")
    if entries.numel() != meta.size:
        raise ValueError("entry plane does not match the table geometry")
    if entries.data_ptr() % 16:
        raise ValueError("entries: must be 16-byte aligned")


def flat_lookup(entries: torch.Tensor, meta, keys: torch.Tensor):
    """The value word (int32) of each canonical int64 mer in the sealed
    flat table, 0 if absent."""
    _check_entries(entries, meta)
    _check(keys, torch.int64, "keys")
    if not _on_cuda(entries, keys):
        return ref.flat_lookup(entries, meta, keys)
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    launch("flat_lookup", "flat_lookup", entries.data_ptr(), keys.data_ptr(),
           keys.numel(), meta.k, meta.nb_log2, meta.rem_bits, meta.bits,
           out.data_ptr())
    return out


# --------------------------------------------------------------- HK20


def flat_finalize(bstate, meta):
    """Seal the flat build table: returns (entries int32 [size], stats
    int64 [3] = occupied, distinct_hq, total_hq)."""
    _check_flat(bstate, meta)
    if not _on_cuda(bstate.keytag):
        return ref.flat_finalize(bstate, meta)
    entries = torch.empty_like(bstate.keytag)
    if entries.data_ptr() % 16:
        raise ValueError("entries: must be 16-byte aligned")
    stats = torch.zeros(3, dtype=torch.int64, device=entries.device)
    launch("flat_finalize", "flat_finalize", bstate.keytag.data_ptr(),
           bstate.hq.data_ptr(), bstate.lq.data_ptr(), meta.size, meta.bits,
           meta.rem_bits, entries.data_ptr(), stats.data_ptr())
    return entries, stats


# --------------------------------------------------------------- HK21


def minimizer(codes: torch.Tensor, k: int, m: int):
    """Every k-window's mixed canonical m-mer minimizer of an int8 code
    batch [B, L]: (int32 [B, L] holding the u32 values, kvalid bool
    [B, L]); 1 <= m <= min(k, 15), k <= 31."""
    _check(codes, torch.int8, "codes")
    if codes.dim() != 2:
        raise ValueError("codes: expected [B, L]")
    if not 1 <= m <= min(k, 15) or k > 31:
        raise ValueError(f"minimizer k={k} m={m} out of range")
    if not _on_cuda(codes):
        return ref.minimizer(codes, k, m)
    b, l = codes.shape
    out = torch.empty((b, l), dtype=torch.int32, device=codes.device)
    kvalid = torch.empty((b, l), dtype=torch.bool, device=codes.device)
    launch("minimizer", "minimizer", codes.data_ptr(), b, l, k, m,
           out.data_ptr(), kvalid.data_ptr())
    return out, kvalid
