"""Stage 1 and stage 2 over several devices (`--devices N`) on the tile
table sharded by leading row bits (counterpart of
quorum_tpu/parallel/tile_sharded.py, both stage-2 layouts).

Layout: the GLOBAL table has 2^rb_log2 rows addressed by the Feistel-
mixed key; shard s of the mesh owns rows [s * 2^local_rb, (s + 1) *
2^local_rb), those whose address has s as its leading owner_bits. Tags
hold the GLOBAL key parts and only the row is localized, so the shards,
concatenated, are the single-card table row for row: the export, the
stage-2 lookups and the output bytes equal `--devices 1`'s.

A mesh is a list of torch devices, one a shard, held by ONE process.
It may name one device more than once (one card standing in for
several, or the CPU in the tests), as the JAX package's virtual CPU
mesh does; the shards then share that device's memory and its stream.

* Stage 1 (build_step_wire): each shard takes its row range of the
  batch's packed wire, and HK15 buckets its observations by owner; the
  host copies each bucket to its owner's device (JAX's lax.all_to_all,
  here device-to-device copies between launches; a copy onto the
  lanes' own device is none); HK1's shard entry counts each owner's
  lanes in its slice. Lanes that meet a full row come back pending;
  every shard then doubles (grow: HK8's shard entry buckets each live
  slot by its new shard, the buckets cross, its place pass claims
  them) and the pending lanes route again under the doubled geometry,
  so every observation counts exactly once. HK2 seals each shard. A
  pass of the partitioned build (--partitions P) routes through HK15's
  partition entry (only the pass's mers) and cannot grow: a full row
  raises PassFull, and the build restarts at the next geometry.
* Stage 2 (ShardedCorrector), in the layout JAX's picks: each batch's
  reads split into N equal row ranges, HK5 and HK4 correct each range
  on its shard's device, and one HK14 packs the global result on the
  lead device, so the host's finish and render are those of one card.
  - replicated (a table of at most replicate_cap_bytes() and 2^24
    rows): the table once on each distinct device of the mesh;
  - routed (past either): the table stays row-sharded, shard s on
    mesh[s], and HK5's and HK4's sharded-table entries read every
    probe's row in its owner's plane, over NVLink where it lies on
    another card (peer access). JAX routes each lookup through two
    all_to_all exchanges inside a lockstep loop; a card's lanes here
    walk their extensions alone, so the table is read in place and
    the answers are routed_lookup_local's. The contaminant set is
    replicated, as JAX's is. A mesh of cards without peer access
    between them cannot take this layout (peer_reason).

* Unpacked entries (build_database_tile_sharded, correct_step,
  correct_step_routed, and dryrun, which drives them): JAX's callers
  hand (codes, quals) batches; each is packed on the host and takes the
  wire path above. Batches given as CUDA tensors are copied to the
  host for the pack and the wire goes back to the card: a round trip
  that JAX's build_step, which extracts observations on the device,
  does not make.

torch.distributed is not used: NCCL takes one process per card and
refuses two ranks on one card, and the exchange here is between
tensors of one process.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .. import kernels
from ..io import packing
from ..kernels import device_scope
from ..kernels.loader import launching
from ..ops import ctable
from ..ops.ctable import (MAX_GROWS, GlobalMeta, ShardedBuildState,
                          ShardedTileState, TileMeta, TileState)
from ..utils import levers
from ..utils.sizes import parse_size
from ..utils.vlog import vlog


def _device(d) -> torch.device:
    """`d` as tensors on it report their device: a CUDA device with its
    index, the CPU without one."""
    dev = torch.device(d)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int, devices=None, device="cuda"
              ) -> list[torch.device]:
    """The host-local mesh of n shards: a list of n torch devices.
    `devices` may name one device more than once; by default the first
    n CUDA devices, or the CPU n times for device="cpu"."""
    if devices is not None:
        devs = [_device(d) for d in devices]
    elif torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * n_devices
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if len(devs) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    return devs[:n_devices]


def distinct(mesh) -> list[torch.device]:
    """The mesh's devices, each once, in mesh order."""
    return list(dict.fromkeys(mesh))


def synchronize(mesh) -> None:
    for dev in distinct(mesh):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def resolve_devices(spec, device="cuda") -> int:
    """`--devices` semantics shared by the three CLIs (quorum_tpu's
    resolve_devices): `auto` (the default) takes every CUDA device and 1
    on the CPU; `all` forces every CUDA device; an integer asks for that
    many. auto and all round DOWN to the largest power of two present.
    On the CPU an explicit N runs N shards on the CPU (the tests' mesh);
    on CUDA, N must be present. Anything above 1 must be a power of two
    (the leading-bit shard layout)."""
    cuda = torch.device(device).type == "cuda"
    avail = torch.cuda.device_count() if cuda else 1
    pow2 = 1 << (avail.bit_length() - 1) if avail else 1
    if spec is None or spec in ("", "auto"):
        return pow2 if cuda else 1
    if spec == "all":
        n = pow2
    else:
        try:
            n = int(spec)
        except (TypeError, ValueError):
            raise ValueError(
                f"--devices must be an integer, 'all' or 'auto', got "
                f"{spec!r}") from None
    if n < 1:
        raise ValueError(f"--devices must be >= 1, got {n}")
    if cuda and n > avail:
        raise ValueError(
            f"--devices {n} but only {avail} local device(s) present")
    if n & (n - 1):
        raise ValueError(
            f"--devices must be a power of two (leading-bit shard "
            f"layout), got {n}")
    return n


def explicit_devices(spec) -> bool:
    """Whether a `--devices` value names a count (not auto/all)."""
    return spec not in (None, "", "auto", "all")


def resolve_devices_and_batch(spec, batch_size: int, prog: str, err=None,
                              device="cuda") -> tuple[int, int]:
    """The one `--devices` CLI policy: resolve the device count and
    round `--batch-size` UP to a multiple of it (each shard takes an
    equal row range of every batch), noting the round-up as `prog` on
    `err` (default stderr)."""
    out = err if err is not None else sys.stderr
    devices = resolve_devices(spec, device)
    if batch_size % devices:
        batch_size += devices - batch_size % devices
        print(f"{prog}: rounding --batch-size up to {batch_size} "
              f"(multiple of --devices {devices})", file=out)
    return devices, batch_size


@dataclasses.dataclass(frozen=True)
class TileShardedMeta(GlobalMeta):
    """Geometry of a tile table sharded by leading row bits over
    n_shards devices: the GLOBAL geometry (rb_log2 may pass the
    one-card cap of 24) and each shard's local one (local_rb <= 24)."""

    n_shards: int = 1

    def __post_init__(self):
        S = self.n_shards
        if S < 1 or S & (S - 1):
            raise ValueError("n_shards must be a power of two")
        if self.owner_bits > self.rb_log2:
            raise ValueError("more shards than buckets")
        if self.local_rb > 24:
            raise ValueError(
                f"local rb_log2 {self.local_rb} exceeds the per-chip cap")
        super().__post_init__()

    @property
    def owner_bits(self) -> int:
        return self.n_shards.bit_length() - 1

    @property
    def local_rb(self) -> int:
        return self.rb_log2 - self.owner_bits

    @property
    def local_meta(self) -> TileMeta:
        return TileMeta(k=self.k, bits=self.bits, rb_log2=self.local_rb)


def initial_rb(initial_size: int, k: int, bits: int, n_shards: int) -> int:
    """The global rb_log2 a sharded build starts at for `-s
    initial_size`: the one-card sizing, at least a few rows a shard and
    at most the per-card cap on every shard (growth lifts it from
    there), as the JAX package clamps it."""
    owner_bits = n_shards.bit_length() - 1
    rb = ctable.tile_rb_for(initial_size, k, bits)
    return min(max(rb, owner_bits + 4), 24 + owner_bits)


def make_build_state(meta: TileShardedMeta, mesh) -> ShardedBuildState:
    """An empty build table: shard s's slice on mesh[s]."""
    return ShardedBuildState(tuple(ctable.make_tile_build(meta.local_meta, d)
                                   for d in mesh))


def _exchange(sent, mesh) -> list:
    """The all-to-all: sent[s] = (lanes on mesh[s] in owner buckets,
    their S sizes) -> for each owner o, its buckets from every shard in
    shard order, on mesh[o]. Copies between devices are ordered after
    the sender's and before the receiver's current streams (torch's
    cross-device copy); a bucket already on its owner's device is a
    view, not a copy."""
    recv = []
    for o, dev in enumerate(mesh):
        with device_scope(dev), launching("exchange", count=False):
            parts = []
            for lanes, sizes in sent:
                a, n = sum(sizes[:o]), sizes[o]
                if n:
                    parts.append(lanes[a:a + n].to(dev, non_blocking=True))
            if len(parts) == 1:
                recv.append(parts[0])
            elif parts:
                recv.append(torch.cat(parts))
            else:
                lanes = sent[0][0]
                recv.append(lanes.new_empty((0, *lanes.shape[1:]),
                                            device=dev))
    return recv


def _insert(bstate: ShardedBuildState, meta: TileShardedMeta, mesh,
            recv) -> list:
    """HK1's shard entry on every owner (all launched before the first
    wait); returns each owner's lanes that found no room (on its
    device)."""
    placed = [kernels.tile_insert_shard(bstate.shards[o], meta, lanes)
              for o, lanes in enumerate(recv)]
    pending = []
    for o, (lanes, ok) in enumerate(zip(recv, placed)):
        with device_scope(mesh[o]):
            pending.append(lanes[~ok])
    return pending


class PassFull(Exception):
    """A pass of a partitioned build met a full row: growing inside the
    pass would move the partition bits, so the build restarts every
    pass at the next geometry (JAX's _PartitionGrew)."""


def build_step_wire(bstate: ShardedBuildState, meta: TileShardedMeta, mesh,
                    pk: packing.PackedReads, qual_thresh: int,
                    part: int = 0, n_parts: int = 1,
                    max_grows: int = MAX_GROWS, shard_inserts=None):
    """Count one packed batch into the sharded build table (JAX's
    build_step_wire and its caller's grow loop): each shard routes its
    row range of the batch (HK15), the buckets cross to their owners,
    each owner counts them (HK1's shard entry); lanes that found no room
    re-route after a doubling of every shard (grow), as often as needed.
    With n_parts > 1 (pass `part` of a partitioned build) HK15's
    partition entry routes only the pass's mers, and a full row raises
    PassFull instead of growing; past `max_grows` doublings in one batch
    it raises "Hash is full". Each step is launched on every shard
    before the host waits on any: the waits are HK15's bucket counts and
    the unplaced lanes' sizes. `shard_inserts` (an int64 numpy array of
    S, or None) accumulates the lanes each owner inserted, retries
    included (record_shard_metrics). Returns (bstate, meta, grows)."""
    pk.require_plane(qual_thresh)
    subs = packing.split_rows(pk, meta.n_shards)
    wires = [torch.from_numpy(sub.to_wire()).to(mesh[s])
             for s, sub in enumerate(subs)]
    sent = kernels.shard_route(
        [(w, sub.n_reads, sub.length, sub.thresholds)
         for w, sub in zip(wires, subs)], qual_thresh, meta, part, n_parts)
    del wires
    grows = 0
    while True:
        recv = _exchange(sent, mesh)
        del sent
        if shard_inserts is not None:
            shard_inserts += [lanes.shape[0] for lanes in recv]
        pending = _insert(bstate, meta, mesh, recv)
        del recv
        if not any(p.numel() for p in pending):
            return bstate, meta, grows
        if n_parts > 1:
            raise PassFull
        if grows >= max_grows:
            raise RuntimeError("Hash is full")
        vlog("Sharded hash full at ", meta.rows, " buckets; doubling")
        bstate, meta = grow(bstate, meta, mesh)
        grows += 1
        sent = kernels.shard_route_lanes(pending, meta)
        del pending


def grow(bstate: ShardedBuildState, meta: TileShardedMeta, mesh
         ) -> tuple[ShardedBuildState, TileShardedMeta]:
    """Double the GLOBAL geometry: every shard's live slots move to the
    shard that owns their doubled address (HK8's shard entry buckets
    them, the buckets cross, its place pass claims them in fresh
    doubled slices). One doubling always suffices (a new row takes keys
    of one old row), where JAX's grow may double again. Raises "Hash is
    full" past a local geometry of 2^24 rows."""
    try:
        nmeta = dataclasses.replace(meta, rb_log2=meta.rb_log2 + 1)
    except ValueError as e:
        raise RuntimeError("Hash is full") from e
    sent = kernels.tile_grow_shard(list(bstate.shards), meta)
    recv = _exchange(sent, mesh)
    del sent
    shards = []
    for d, lanes in enumerate(recv):
        new = ctable.make_tile_build(nmeta.local_meta, mesh[d])
        if kernels.tile_grow_place(new, nmeta, lanes):
            raise RuntimeError("Hash is full")
        shards.append(new)
    return ShardedBuildState(tuple(shards)), nmeta


def finalize(bstate: ShardedBuildState, meta: TileShardedMeta, mesh):
    """Seal every shard (HK2 on its device). On a mesh that names one
    device only, the sealed shards are row ranges of ONE plane there
    (ShardedTileState.whole), so stage 2 replicates without a copy.
    Returns (ShardedTileState, stats int64 [S, 5] on the host: HK2's dup,
    occupied, distinct_hq, total_hq, singletons per shard)."""
    local = meta.local_meta
    whole = None
    if len(distinct(mesh)) == 1:
        whole = torch.empty((meta.rows, ctable.TILE), dtype=torch.int32,
                            device=mesh[0])
    rows, stats = [], []
    for s, b in enumerate(bstate.shards):
        out = None if whole is None else whole[s * local.rows:
                                               (s + 1) * local.rows]
        with device_scope(mesh[s]):
            r, st = kernels.tile_seal(b, local, out=out)
        rows.append(r)
        stats.append(st)
    return (ShardedTileState(tuple(rows), whole),
            torch.stack([st.cpu() for st in stats]))


def shard_occupancy(seal_stats) -> list[int]:
    """Distinct mers per shard (HK2's occupied count of each shard, the
    load-balance number JAX's shard_occupancy reports)."""
    return [int(x) for x in seal_stats[:, 1]]


def floor(state: ShardedTileState, meta: TileShardedMeta,
          presence_floor: int) -> ShardedTileState:
    """The presence floor (HK12) on every shard, in place."""
    for rows in state.shards:
        with device_scope(rows.device):
            ctable.tile_floor(TileState(rows), meta.local_meta,
                              presence_floor)
    return state


def gather_table(state: ShardedTileState, meta: TileShardedMeta
                 ) -> tuple[TileState, TileMeta]:
    """The row-sharded table as one card's table on the lead shard's
    device (the concatenated shards; no copy where they already are
    one plane there)."""
    if meta.rb_log2 > 24:
        raise ValueError("table exceeds the single-chip geometry")
    lead = state.shards[0].device
    if state.whole is not None and state.whole.device == lead:
        rows = state.whole
    else:
        with device_scope(lead):
            rows = torch.cat([r.to(lead) for r in state.shards])
    return TileState(rows), TileMeta(k=meta.k, bits=meta.bits,
                                     rb_log2=meta.rb_log2)


def replicate_table(state, mesh) -> list:
    """The sealed rows once on each distinct device of the mesh (a
    ShardedTileState or one card's TileState); returns the plane of each
    mesh entry, the same tensor where entries name one device. A plane
    already on a device is not copied there."""
    copies: dict = {}
    for dev in distinct(mesh):
        if isinstance(state, TileState):
            copies[dev] = state.rows.to(dev)
        elif state.whole is not None and state.whole.device == dev:
            copies[dev] = state.whole
        else:
            with device_scope(dev):
                parts = [r.to(dev) for r in state.shards]
                copies[dev] = (parts[0] if len(parts) == 1
                               else torch.cat(parts))
    return [copies[d] for d in mesh]


def row_shards(state, meta: TileShardedMeta, mesh) -> ShardedTileState:
    """The sealed table row-sharded over the mesh: shard s, the global
    rows [s * 2^local_rb, (s + 1) * 2^local_rb), on mesh[s]. A sharded
    build's or a mesh load's own shards are used as they are; one
    plane (a stand-alone stage 2 from one file, or shards that are row
    ranges of one plane) splits into views where the mesh names its
    device and copies elsewhere."""
    if isinstance(state, ShardedTileState) and len(state.shards) == len(mesh) \
            and all(r.device == d for r, d in zip(state.shards, mesh)):
        return state
    plane = state.rows if isinstance(state, TileState) else state.whole
    if plane is None:
        raise ValueError("a table sharded over another mesh")
    per = 1 << meta.local_rb
    shards = tuple(plane[s * per:(s + 1) * per].to(d)
                   for s, d in enumerate(mesh))
    same = all(r.device == plane.device for r in shards)
    return ShardedTileState(shards, plane if same else None)


def replicate_cap_bytes() -> int:
    """Stage-2 layout threshold: tables at or under this many bytes are
    replicated per device; bigger ones take the routed layout.
    QUORUM_REPLICATE_TABLE_BYTES (k/M/G/T suffixes, decimal), as the
    JAX package reads it; default 4 GiB."""
    raw = levers.raw("QUORUM_REPLICATE_TABLE_BYTES")
    if raw:
        try:
            return parse_size(raw)
        except ValueError:
            pass
    return 4 * 1024 ** 3


def table_bytes(rb_log2: int) -> int:
    """Bytes of a sealed table of 2^rb_log2 rows."""
    return (1 << rb_log2) * ctable.TILE * 4


def routed_layout(rb_log2: int, cap: int | None = None) -> bool:
    """Whether stage 2 over a mesh keeps a table of 2^rb_log2 rows
    row-sharded (JAX's ShardedCorrector rule: past the one-card geometry
    of 2^24 rows, or over `cap` bytes, by default
    replicate_cap_bytes())."""
    cap = replicate_cap_bytes() if cap is None else cap
    return rb_log2 > 24 or table_bytes(rb_log2) > cap


def peer_reason(mesh) -> str | None:
    """Why the routed layout cannot run on this mesh (a pair of its
    distinct CUDA devices without peer access: every probe reads its
    row in place), or None. Asks torch.cuda.can_device_access_peer
    only; nothing is allocated."""
    cards = [d for d in distinct(mesh) if d.type == "cuda"]
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                return (f"the routed stage-2 layout reads every shard of "
                        f"the table in place and needs peer access between "
                        f"the mesh's cards, which {a} -> {b} lacks")
    return None


@dataclasses.dataclass(frozen=True)
class RoutedTileMeta(TileShardedMeta):
    """The geometry of a table corrected in the routed layout (JAX's
    marker subclass of the same name): corrector probes read each row
    in its owner's plane (the sharded-table entries of HK3, HK4, HK5)."""


def routed_lookup(state: ShardedTileState, meta: TileShardedMeta,
                  keys: torch.Tensor) -> torch.Tensor:
    """K10 routed (JAX's routed_lookup_local): the value word of each
    canonical int64 mer, the (count << 1) | qual of its owner shard's
    row, 0 when absent; HK3's shard entry on the keys' device."""
    return kernels.tile_lookup(state.shards, meta, keys)


def query_step(mesh, meta: TileShardedMeta):
    """f(state, keys) -> values (JAX's query_step): the queries split in
    equal row ranges over the mesh, each range answered on its shard's
    device through routed_lookup against the row-sharded table, the
    answers gathered in order on the keys' device."""

    def step(state: ShardedTileState, keys: torch.Tensor) -> torch.Tensor:
        n = keys.shape[0]
        if n % len(mesh):
            raise ValueError(f"{n} queries do not split over {len(mesh)} "
                             "shards")
        per = n // len(mesh)
        out = []
        for s, dev in enumerate(mesh):
            with device_scope(dev):
                out.append(routed_lookup(state, meta,
                                         keys[s * per:(s + 1) * per].to(dev)))
        return torch.cat([o.to(keys.device) for o in out])

    return step


def correct_step_wire(mesh, rows, meta, pk: packing.PackedReads, cfg,
                      keeps: list, contams: list, event_driven: bool = True):
    """One stage-2 batch over the mesh (JAX's correct_step_wire): shard
    s corrects its row range of the batch (HK5, HK4) on mesh[s] against
    the table, which is `rows[s]`, the replicated plane on mesh[s] under
    a TileMeta, or, under a RoutedTileMeta, `rows` itself, the
    ShardedTileState every shard reads in place; the lanes gather on the
    lead device and one HK14 packs the global result, so the finish
    buffer, and the bytes rendered from it, are one card's. Event mode
    (the default, as JAX's sharded stage 2 runs it, tile_sharded.py:951)
    adds HK16 and HK17 on each shard's rows (HK16's sharded-table entry
    on the routed layout) and HK4's event entry."""
    from ..models import corrector

    routed = isinstance(meta, RoutedTileMeta)
    parts = []
    for s, sub in enumerate(packing.split_rows(pk, len(mesh))):
        table = rows if routed else TileState(rows[s])
        with device_scope(mesh[s]):
            parts.append(corrector.extend_batch(
                table, meta, sub, cfg, keeps[s], contams[s], event_driven))
    with device_scope(mesh[0]):
        return corrector.pack_batch(corrector.merge_lanes(parts, mesh[0]))


class ShardedCorrector:
    """Stage 2 over a local mesh (JAX's ShardedCorrector): the layout as
    JAX picks it (routed_layout), the table (a ShardedTileState or one
    card's TileState) placed once, then `(pk) -> BatchResult` per batch,
    a drop-in for corrector.correct_batch_packed, in event mode as JAX's
    always runs (`event_driven=False`, the plain walk, is a test hook
    that JAX's lacks). The routed layout raises where the mesh's cards
    lack peer access (peer_reason)."""

    def __init__(self, mesh, state, meta, cfg, contam=None,
                 replicate_max_bytes: int | None = None,
                 event_driven: bool = True):
        self.mesh, self.cfg = list(mesh), cfg
        self.event_driven = event_driven
        k, bits, rb = meta.k, meta.bits, meta.rb_log2
        self.routed = routed_layout(rb, replicate_max_bytes)
        if self.routed:
            why = peer_reason(self.mesh)
            if why is not None:
                raise RuntimeError(why)
            self.meta = RoutedTileMeta(k=k, bits=bits, rb_log2=rb,
                                       n_shards=len(self.mesh))
            self.rows = row_shards(state, self.meta, self.mesh)
        else:
            self.meta = TileMeta(k=k, bits=bits, rb_log2=rb)
            self.rows = replicate_table(state, self.mesh)
        ctab = {dev: None if contam is None else
                (TileState(contam[0].rows.to(dev)), contam[1])
                for dev in distinct(self.mesh)}
        self.keeps = _keeps(self.mesh, self.meta, cfg)
        self.contams = [ctab[d] for d in self.mesh]

    @property
    def layout(self) -> str:
        return "routed" if self.routed else "replicated"

    def __call__(self, pk: packing.PackedReads):
        return correct_step_wire(self.mesh, self.rows, self.meta, pk,
                                 self.cfg, self.keeps, self.contams,
                                 self.event_driven)


# ------------------------------------------------- unpacked entries (K24)
# JAX's build_step (:332) and its caller build_database_tile_sharded
# (:600), correct_step (:800) and correct_step_routed (:878) take
# unpacked (codes int8 [B, L], quals uint8 [B, L]); the port packs each
# batch on the host into the wire its CLIs send, then runs the wire path
# above. Packing is exact: JAX's observation extraction resets a window
# on codes < 0, the wire's N mask, and on quals < qual_thresh, the
# wire's qual >= qual_thresh plane.


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pack_unpacked(codes, quals, lengths, qual_thresh: int
                   ) -> packing.PackedReads:
    """One unpacked batch packed on the host (a tensor on a card is
    copied to the host first)."""
    codes = _host(codes).astype(np.int8)
    if lengths is None:
        lengths = np.full(codes.shape[0], codes.shape[1], np.int32)
    return packing.pack_reads(codes, _host(quals).astype(np.uint8),
                              _host(lengths).astype(np.int32),
                              thresholds=(qual_thresh,))


def build_database_tile_sharded(batches, mesh, meta: TileShardedMeta,
                                qual_thresh: int, max_grows: int = 8,
                                metrics=None, tracer=None):
    """Stage 1 over the mesh from unpacked batches: every (codes, quals)
    batch (rows a multiple of the shard count) packed on the host with
    every row's length L and the qual >= qual_thresh plane, counted by
    build_step_wire (HK15, the exchange, HK1's shard entry; HK8's shard
    entry where a batch needs a doubling, at most `max_grows` a batch)
    and sealed by HK2. CUDA-tensor batches take a round trip through
    the host for the pack. Returns (ShardedTileState, meta). JAX's
    `bucket_slack` overflow retries have no counterpart (HK15 buckets
    exactly: the same table).

    `metrics` (a telemetry registry, or None) records the batches and
    reads routed, the grows, each step's `shard_step_dispatch_us` /
    `shard_step_wait_us` and, at the end, record_shard_metrics; `tracer`
    (a span tracer, or None) marks each batch a `shard_build_step`
    device step."""
    import time

    from ..telemetry import NULL, NULL_TRACER, observe_dispatch_wait

    reg = metrics if metrics is not None else NULL
    tracer = tracer if tracer is not None else NULL_TRACER
    mesh = list(mesh)
    bstate = make_build_state(meta, mesh)
    inserts = np.zeros(meta.n_shards, np.int64)
    for step, (codes, quals) in enumerate(batches):
        reg.counter("shard_batches").inc()
        reg.counter("shard_reads").inc(codes.shape[0])
        pk = _pack_unpacked(codes, quals, None, qual_thresh)
        rb_before = meta.rb_log2
        t0 = time.perf_counter()
        with tracer.step("shard_build_step", step):
            bstate, meta, grows = build_step_wire(bstate, meta, mesh, pk,
                                                  qual_thresh,
                                                  max_grows=max_grows,
                                                  shard_inserts=inserts)
        t1 = time.perf_counter()
        observe_dispatch_wait(reg, "shard_step", t0, t1, t1)
        if grows:
            reg.counter("shard_grows").inc(grows)
            reg.event("shard_grow", rb_log2_before=rb_before,
                      rb_log2_after=meta.rb_log2)
    state, seal = finalize(bstate, meta, mesh)
    if reg.enabled:
        record_shard_metrics(reg, meta, inserts, shard_occupancy(seal))
    return state, meta


def record_shard_metrics(reg, meta: TileShardedMeta, shard_inserts,
                         per: list[int]) -> None:
    """The per-shard telemetry of a finished sharded build (JAX's
    record_shard_metrics): the occupancy spread gauges, the per-shard
    distinct-mer and insert lists in meta, and the totals;
    tools/metrics_check.py requires them when n_shards > 1. `per` is
    shard_occupancy of the seal's statistics."""
    ins = [int(x) for x in shard_inserts]
    reg.gauge("n_shards").set(meta.n_shards)
    reg.gauge("shard_distinct_min").set(min(per))
    reg.gauge("shard_distinct_max").set(max(per))
    reg.counter("distinct_mers").inc(sum(per))
    reg.counter("shard_inserts_total").inc(sum(ins))
    reg.gauge("shard_inserts_min").set(min(ins))
    reg.gauge("shard_inserts_max").set(max(ins))
    reg.set_meta(shard_distinct_mers=per, shard_inserts=ins)


def _keeps(mesh, meta, cfg) -> list:
    """The corrector's keep table of each mesh entry, made once on each
    distinct device."""
    from ..models.corrector import make_keep_table

    keep = {dev: make_keep_table(meta, cfg, dev) for dev in distinct(mesh)}
    return [keep[d] for d in mesh]


def correct_step(mesh, tmeta: TileMeta, cfg):
    """Stage 2 over the mesh with the table replicated (JAX's
    correct_step): f(state, codes, quals, lengths) -> BatchResult. The
    batch is packed on the host (corrector.correct_batch's packing; a
    batch on a card is copied there first) and runs correct_step_wire, each shard's row range on its device against
    its copy of the table. `state` is one card's TileState, a
    ShardedTileState (replicated here) or replicate_table's planes."""
    mesh = list(mesh)
    keeps = _keeps(mesh, tmeta, cfg)

    def step(state, codes, quals, lengths):
        rows = state if isinstance(state, list) else replicate_table(state,
                                                                     mesh)
        pk = _pack_unpacked(codes, quals, lengths, cfg.qual_cutoff)
        return correct_step_wire(mesh, rows, tmeta, pk, cfg, keeps,
                                 [None] * len(mesh))

    return step


def correct_step_routed(mesh, meta: TileShardedMeta, cfg):
    """Stage 2 over the mesh with the table row-sharded (JAX's
    correct_step_routed): f(state, codes, quals, lengths) ->
    BatchResult, every probe read in its owner shard's plane (HK5's,
    HK16's and HK4's sharded-table entries). `state` is a
    ShardedTileState, or one plane (split here over the mesh)."""
    mesh = list(mesh)
    rmeta = RoutedTileMeta(k=meta.k, bits=meta.bits, rb_log2=meta.rb_log2,
                           n_shards=meta.n_shards)
    why = peer_reason(mesh)
    if why is not None:
        raise RuntimeError(why)
    keeps = _keeps(mesh, rmeta, cfg)

    def step(state, codes, quals, lengths):
        pk = _pack_unpacked(codes, quals, lengths, cfg.qual_cutoff)
        return correct_step_wire(mesh, row_shards(state, rmeta, mesh), rmeta,
                                 pk, cfg, keeps, [None] * len(mesh))

    return step


def table_entries(state: TileState, meta: TileMeta):
    """The sealed table's entries as (canonical int64 mers, value words
    int64), in row-major slot order, on the table's device (HK6's
    compact entry, then the Feistel inverse)."""
    rows = state.rows
    cap = int((rows[:, 0::2] != 0).sum())
    addr, lo, hi, n = ctable.tile_compact_device(state, meta, cap)
    lo, hi = lo.to(torch.int64) & 0xFFFFFFFF, hi.to(torch.int64) & 0xFFFFFFFF
    full = (((hi << meta.rlo_bits) | (lo >> (meta.bits + 1)))
            << meta.rb_log2) | addr.to(torch.int64)
    vals = ((lo & meta.max_val) << 1) | ((lo >> meta.bits) & 1)
    return kernels.ref.feistel_inverse(full, meta.k)[:int(n)], vals[:int(n)]


def dryrun(mesh, n_devices: int) -> None:
    """The multi-device dryrun (JAX's dryrun, on its inputs: seed 11,
    k = 15, a 512 bp genome, 8 * n_devices reads of 48 bp, 3% errors):
    the sharded build from unpacked batches, a routed query spot-check
    against the gathered table's own entries, then both stage-2 layouts
    (replicated, routed) held equal to the one-card corrector on out,
    start, end and status. Raises AssertionError on a mismatch."""
    from ..models import corrector
    from ..models.ec_config import ECConfig

    mesh = list(mesh)
    k = 15
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=512, dtype=np.int8)
    n_reads = 8 * n_devices
    starts = rng.integers(0, len(genome) - 48, size=n_reads)
    codes = genome[starts[:, None] + np.arange(48)[None, :]].astype(np.int8)
    err = rng.random(codes.shape) < 0.03
    codes = np.where(err, (codes + rng.integers(1, 4, size=codes.shape)) % 4,
                     codes).astype(np.int8)
    quals = np.full(codes.shape, 70, np.uint8)
    quals[err] = 34
    lengths = np.full((n_reads,), 48, np.int32)

    meta = TileShardedMeta(k=k, bits=7,
                           rb_log2=max(8, (n_devices - 1).bit_length() + 3),
                           n_shards=n_devices)
    state, meta = build_database_tile_sharded([(codes, quals)], mesh, meta,
                                              53)

    gstate, gmeta = gather_table(state, meta)
    keys, vals = table_entries(gstate, gmeta)
    nq = max(n_devices, (min(len(keys), 8 * n_devices) // n_devices)
             * n_devices)
    pad = nq - min(len(keys), nq)
    q = torch.cat([keys[:nq - pad], keys.new_zeros(pad)])
    got = query_step(mesh, meta)(state, q)
    assert torch.equal(got[:nq - pad].cpu(), vals[:nq - pad].cpu()), \
        "routed tile query mismatch"

    cfg = ECConfig(k=k, cutoff=2)
    single = corrector.correct_batch(gstate, gmeta, codes, quals, lengths,
                                     cfg)
    for tag, step, st in (
            ("replicated", correct_step(mesh, gmeta, cfg),
             replicate_table(gstate, mesh)),
            ("routed", correct_step_routed(mesh, meta, cfg), state)):
        res = step(st, codes, quals, lengths)
        for name in ("out", "start", "end", "status"):
            assert torch.equal(getattr(res, name).cpu(),
                               getattr(single, name).cpu()), \
                f"tile {tag} corrector mismatch on {name}"
    n_ok = int((single.status == corrector.OK).sum())
    assert n_ok > 0, "tile dryrun corrected nothing"
    print(f"dryrun tile: {n_ok}/{n_reads} reads corrected on the tile "
          f"path (replicated + routed), parity vs single-chip OK")
