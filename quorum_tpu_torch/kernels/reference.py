"""Plain PyTorch versions of the twenty-one hand-written kernels and their
entries.

Each function computes what its CUDA kernel computes (csrc/*.cu) with
ordinary tensor operations. The wrappers in kernels/__init__.py call
them only for tensors that lie on the CPU; chip_smoke.py runs them on
the card beside the kernels to hold the two against each other.

32-bit words are stored as int32 tensors (the bit pattern of the JAX
package's uint32 planes). Arithmetic here widens them to int64 and
masks with 0xFFFFFFFF after every multiply and shift; a k-mer is one
int64 of at most 62 bits (ops/mer.py).
"""

from __future__ import annotations

import torch

from ..ops import mer

M32 = 0xFFFFFFFF
EMPTY = 0xFFFFFFFF  # an empty tag word (quorum_tpu.ops.ctable._EMPTY_TAG)
TSLOTS = 64
_ROUND_C = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
# the sketch's two hash streams (quorum_tpu.ops.sketch._H_C)
_SKETCH_C = ((0x9E3779B9, 0x85EBCA6B), (0xC2B2AE35, 0x27D4EB2F))
SKETCH_SAT = 2  # cells saturate at 2: {0, 1, >= 2} is all the gate reads
_LOOKUP_CHUNK = 1 << 18
# read statuses the stage-2 kernels write (quorum_tpu's corrector.OK,
# ST_CONTAMINANT, ST_NO_ANCHOR)
OK, ST_CONTAMINANT, ST_NO_ANCHOR = 0, 1, 2
# HK14: log positions cross biased in u16 lanes (corrector._POS_BIAS)
POS_BIAS = 4
# HK16's aux plane (corrector._AX_*): bit 0 level, bits 1-3 count, bits
# 4-5 ucode, bit 6 pre-pass data valid, bit 7 prev-defining keep, bits
# 8-11 continuation success and 12-15 continues-with-next-base, a bit a
# variant
AX_COUNT, AX_UCODE, AX_PRE, AX_C1K, AX_SUCC, AX_CWN = 1, 4, 6, 7, 8, 12


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 storage -> the unsigned value as int64."""
    return x.to(torch.int64) & M32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> int32 storage."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x < 2^32 without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def feistel(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The 4-round Feistel bijection on the 2k-bit key
    (ctable.feistel_mix); returns the mixed value (L << k) | R."""
    kmask = (1 << k) - 1
    r = keys & kmask
    l = (keys >> k) & kmask
    for c in _ROUND_C:
        f = mix32((r + c) & M32) & kmask
        l, r = r, l ^ f
    return (l << k) | r


def tile_key_parts(keys: torch.Tensor, meta):
    """Canonical int64 mers -> (addr, rlo, rhi) int64: the row address
    is the low rb_log2 bits of the mixed key, the remainder splits into
    a (31 - bits)-bit low tag and the high tag (ctable.tile_key_parts)."""
    full = feistel(keys, meta.k)
    addr = full & ((1 << meta.rb_log2) - 1)
    rem = full >> meta.rb_log2
    rlo = rem & ((1 << meta.rlo_bits) - 1)
    return addr, rlo, rem >> meta.rlo_bits


def preferred_slot(rlo, rhi):
    return (rlo ^ (rlo >> 7) ^ ((rhi << 3) & M32)) & (TSLOTS - 1)


def partition_mask(keys, meta, part: int, n_parts: int):
    """K20's ownership predicate (ctable.partition_mask): pass `part` of
    `n_parts` (a power of two) owns the canonical mers whose remainder's
    low log2(n_parts) bits, at `meta`'s geometry, equal `part` (rlo holds
    only the low 31 - bits of them)."""
    _addr, rlo, rhi = tile_key_parts(keys, meta)
    return ((rlo | (rhi << meta.rlo_bits)) & (n_parts - 1)) == part


# --------------------------------------------------------------- HK1


def widen_wire(wire, b: int, length: int, thresholds, qual_thresh: int):
    """K1: the fused wire -> (codes int8 [B, L], hq bool [B, L]) where
    hq is the qual >= qual_thresh predicate."""
    pcodes, nmask, hq, lengths = mer.wire_parts(wire, b, length, thresholds)
    codes = mer.unpack_codes(pcodes, nmask, lengths, length)
    return codes, mer.unpack_bits(hq[int(qual_thresh)], length)


def extract_observations(codes, hqb, k: int):
    """K2: per window end, the canonical mer, `valid` (k consecutive
    ACGT bases) and `qual` (all k bases high quality: reset on a
    non-ACGT or low-quality base, ctable.py:1189-1191). Flat [B*L]."""
    f, r, valid = mer.rolling_kmers(codes, k)
    qual = mer.run_at_least((codes < 0) | ~hqb, k)
    return (mer.canonical(f, r).reshape(-1), qual.reshape(-1),
            valid.reshape(-1))


def insert_parts(bstate, meta, addr, rlo, rhi, hq_add, lq_add):
    """Insert keys given by their (addr, rlo, rhi) with count
    increments. Deterministic claim rounds: every pending lane looks for
    its tag pair (match) or the first empty slot in rotated order from
    its preferred slot; one winner per contested (row, slot) is picked
    by the smallest lane id (scatter_reduce amin) and writes both tag
    words. A key may repeat: its lanes contest the same empty slot, the
    losers match it in the next round. Returns `placed` (False only
    where the 64-slot bucket is full of other keys)."""
    n = addr.shape[0]
    dev = addr.device
    tag = bstate.tag.view(-1, TSLOTS, 2)
    placed = torch.zeros(n, dtype=torch.bool, device=dev)
    pend = torch.arange(n, device=dev)
    p0 = preferred_slot(rlo, rhi)
    slots = torch.arange(TSLOTS, device=dev)
    while pend.numel():
        a = addr[pend]
        rows = tag[a]
        tlo, thi = u32(rows[..., 0]), u32(rows[..., 1])
        j = (slots[None, :] - p0[pend, None]) & (TSLOTS - 1)
        match = (tlo == rlo[pend, None]) & (thi == rhi[pend, None])
        score = torch.where(match, j, torch.where(tlo == EMPTY, TSLOTS + j,
                                                  3 * TSLOTS))
        best, slot = score.min(dim=1)
        flat = a * TSLOTS + slot
        win = best < TSLOTS
        claim = ~win & (best < 2 * TSLOTS)
        if claim.any():
            cl = torch.nonzero(claim).squeeze(1)
            uslot, inv = torch.unique(flat[cl], return_inverse=True)
            owner = torch.full(uslot.shape, n, dtype=torch.int64, device=dev)
            owner.scatter_reduce_(0, inv, pend[cl], "amin")
            won = cl[owner[inv] == pend[cl]]
            tflat = bstate.tag.view(-1)
            tflat[2 * flat[won]] = i32(rlo[pend[won]])
            tflat[2 * flat[won] + 1] = i32(rhi[pend[won]])
            win = win.clone()
            win[won] = True
        w = torch.nonzero(win).squeeze(1)
        bstate.hq.index_add_(0, flat[w], hq_add[pend[w]].to(torch.int32))
        bstate.lq.index_add_(0, flat[w], lq_add[pend[w]].to(torch.int32))
        placed[pend[w]] = True
        # retire winners and lanes whose bucket holds no room for them
        pend = pend[~win & claim]
    return placed


def insert_keys(bstate, meta, keys, qual):
    """Insert canonical-mer observations, one count each (hq when
    `qual`; keys may repeat), as HK1 does. Returns `placed` per
    observation."""
    addr, rlo, rhi = tile_key_parts(keys, meta)
    q = qual.to(torch.int64)
    return insert_parts(bstate, meta, addr, rlo, rhi, q, 1 - q)


def _owned_observations(wire, b: int, length: int, thresholds,
                        qual_thresh: int, meta, part: int, n_parts: int):
    """The batch's valid observations (keys, qual) that pass `part` of
    `n_parts` owns."""
    codes, hqb = widen_wire(wire, b, length, thresholds, qual_thresh)
    keys, qual, valid = extract_observations(codes, hqb, meta.k)
    keys, qual = keys[valid], qual[valid]
    if n_parts > 1:
        own = partition_mask(keys, meta, part, n_parts)
        keys, qual = keys[own], qual[own]
    return keys, qual


def tile_insert_reads(bstate, meta, wire, b: int, length: int, thresholds,
                      qual_thresh: int, part: int = 0, n_parts: int = 1):
    """HK1 (K1 + K2 + K4 + K5, with K20's filter): widen the wire,
    extract the batch's observations and insert those that pass `part`
    of `n_parts` owns. Returns (keys, qual) of the inserted observations
    that found no room (empty when the batch fit)."""
    keys, qual = _owned_observations(wire, b, length, thresholds,
                                     qual_thresh, meta, part, n_parts)
    placed = insert_keys(bstate, meta, keys, qual)
    return keys[~placed], qual[~placed]


def shard_key_parts(keys, meta):
    """Canonical int64 mers -> (owner, local row, rlo, rhi) int64 under
    a table sharded by leading row bits (parallel/tile_sharded
    .TileShardedMeta): the key parts of the GLOBAL geometry, the
    address split into its leading owner_bits (the shard) and its low
    local_rb bits (the row in the shard)."""
    addr, rlo, rhi = tile_key_parts(keys, meta)
    return (addr >> meta.local_rb, addr & ((1 << meta.local_rb) - 1), rlo,
            rhi)


def insert_shard(bstate, meta, lanes):
    """HK1's shard entry: insert lanes routed to this shard (HK15's
    words (key << 1) | qual, one observation each) into its slice of the
    table sharded as `meta` describes. Returns `placed` per lane."""
    _owner, row, rlo, rhi = shard_key_parts(lanes >> 1, meta)
    q = lanes & 1
    return insert_parts(bstate, meta, row, rlo, rhi, q, 1 - q)


# --------------------------------------------------------------- HK2


def tile_seal(bstate, meta):
    """K7 + K19: duplicate-tag check, fold into the query layout
    ``lo = rlo << (bits+1) | q << bits | min(cnt, max_val)``, ``hi =
    rhi``, and the (occupied, distinct-hq, total-hq) statistics, plus
    the occupied slots with exactly one observation (hq + lq == 1,
    sketch.singleton_entries). Returns (rows int32 [rows, 128], stats
    int64 [5] = dup, occupied, distinct_hq, total_hq, singletons)."""
    t = bstate.tag.view(-1, TSLOTS, 2)
    tlo, thi = u32(t[..., 0]), u32(t[..., 1])
    hq = u32(bstate.hq.view(-1, TSLOTS))
    lq = u32(bstate.lq.view(-1, TSLOTS))
    occ = (tlo != EMPTY) & ((hq | lq) != 0)
    q = (hq > 0) & occ
    cnt = torch.clamp(torch.where(q, hq, lq), max=meta.max_val)
    lo = torch.where(occ, (tlo << (meta.bits + 1))
                     | (q.to(torch.int64) << meta.bits) | cnt, 0)
    hi = torch.where(occ, thi, 0)
    rows = torch.stack([i32(lo), i32(hi)], dim=2).view(-1, 2 * TSLOTS)
    # duplicate tag pairs within a row: sort by (hi, lo), compare
    # neighbours (unoccupied slots sort last as an all-ones pair)
    klo = torch.where(occ, tlo, M32)
    khi = torch.where(occ, thi, M32)
    klo, order = torch.sort(klo, dim=1, stable=True)
    khi = torch.gather(khi, 1, order)
    khi, order = torch.sort(khi, dim=1, stable=True)
    klo = torch.gather(klo, 1, order)
    same = ((khi[:, 1:] == khi[:, :-1]) & (klo[:, 1:] == klo[:, :-1])
            & (khi[:, 1:] != M32))
    stats = torch.stack([same.any().to(torch.int64), occ.sum(),
                         q.sum(), torch.where(q, cnt, 0).sum(),
                         (occ & (hq + lq == 1)).sum()])
    return rows, stats


# --------------------------------------------------------------- HK3


def _probe(rows, meta, addr, rlo, rhi):
    """The value word of each key given by its (row of `rows`, rlo, rhi)
    at `meta`'s geometry, 0 when absent (all on the rows' device)."""
    out = torch.zeros(addr.shape[0], dtype=torch.int64, device=rows.device)
    r3 = rows.view(-1, TSLOTS, 2)
    for s in range(0, addr.shape[0], _LOOKUP_CHUNK):
        e = s + _LOOKUP_CHUNK
        g = r3[addr[s:e]]
        lo, hi = u32(g[..., 0]), u32(g[..., 1])
        count = lo & meta.max_val
        match = ((count != 0) & ((lo >> (meta.bits + 1)) == rlo[s:e, None])
                 & (hi == rhi[s:e, None]))
        val = (count << 1) | ((lo >> meta.bits) & 1)
        out[s:e] = torch.where(match, val, 0).sum(dim=1)
    return out


def tile_lookup(rows, meta, keys):
    """K10: the value word ``(count << 1) | qual`` of each canonical
    mer, 0 when absent."""
    return _probe(rows, meta, *tile_key_parts(keys, meta))


def routed_lookup(shards, meta, keys):
    """K10 routed (tile_sharded.routed_lookup_local, HK3's shard entry):
    the value word of each canonical mer in a table sharded by leading
    row bits -- `shards`, shard s's plane of 2^local_rb rows on its own
    device, under `meta` (TileShardedMeta) -- read in its owner's row;
    0 when absent. Returns int64 on the keys' device."""
    owner, row, rlo, rhi = shard_key_parts(keys, meta)
    out = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    for s, rows in enumerate(shards):
        idx = torch.nonzero(owner == s).squeeze(1)
        if idx.numel():
            dev = rows.device
            out[idx] = _probe(rows, meta, row[idx].to(dev), rlo[idx].to(dev),
                              rhi[idx].to(dev)).to(keys.device)
    return out


def lookup(table, meta, keys):
    """The stage-2 probe on either table form: one plane (tile_lookup)
    or a sequence of shard planes (routed_lookup)."""
    if isinstance(table, torch.Tensor):
        return tile_lookup(table, meta, keys)
    return routed_lookup(table, meta, keys)


# --------------------------------------------------------------- HK4


class _Logs:
    """Per-lane err_log state (err_log.hpp:22-106) for the lockstep
    extension: entry buffers, count n, window start lwin."""

    def __init__(self, nl: int, maxe: int, d, window: int, error: int,
                 dev):
        self.pos = torch.zeros((nl, maxe), dtype=torch.int64, device=dev)
        self.meta = torch.zeros_like(self.pos)
        self.n = torch.zeros(nl, dtype=torch.int64, device=dev)
        self.lwin = torch.zeros_like(self.n)
        self.d, self.window, self.error, self.maxe = d, window, error, maxe
        self.overflow = False
        self.j = torch.arange(maxe, device=dev)[None, :]

    def _check(self, mask, back):
        """check_nb_error's window advance: entry positions are
        monotone in direction order, so the first in-window index is
        the count of over-window entries."""
        d = self.d
        guard = mask & torch.where(d > 0, back > self.window,
                                   back < self.window)
        dist = d[:, None] * (back[:, None] - self.pos)
        over = ((self.j < self.n[:, None]) & (dist > self.window)).sum(1)
        self.lwin = torch.where(guard, torch.maximum(self.lwin, over),
                                self.lwin)

    def append(self, mask, raw, meta):
        """Append (raw, meta) for `mask` lanes; returns the lanes whose
        error budget tripped."""
        self.overflow |= bool((mask & (self.n >= self.maxe)).any())
        m = mask & (self.n < self.maxe)
        idx = torch.nonzero(m).squeeze(1)
        self.pos[idx, self.n[idx]] = raw[idx]
        self.meta[idx, self.n[idx]] = meta[idx]
        self.n = self.n + m
        self._check(m, raw)
        return m & ((self.n - self.lwin - 1) >= self.error)

    def _at(self, i):
        return torch.gather(self.pos, 1, i.clamp(0, self.maxe - 1)[:, None]
                            ).squeeze(1)

    def remove_last_window(self, mask):
        diff = torch.where(mask & (self.n > 0),
                           self.d * (self._at(self.n - 1) - self._at(self.lwin)),
                           0)
        self.n = torch.where(mask, torch.where(self.n > 0, self.lwin, 0),
                             self.n)
        self.lwin = torch.where(mask, 0, self.lwin)
        self._check(mask & (self.n > 0), self._at(self.n - 1))
        return diff


def _gba_reduce(vals):
    """get_best_alternatives' reduction (mer_database.hpp:302-329) of
    value words [..., 4] (variant order): counts kept only at the best
    quality level present; ucode the largest variant with a kept count.
    Returns (counts [..., 4], ucode, level, count)."""
    cnt, q = vals >> 1, vals & 1
    level = torch.where(cnt > 0, q, 0).amax(dim=-1)
    counts = torch.where((cnt > 0) & (q == level[..., None]), cnt, 0)
    count = (counts > 0).sum(dim=-1)
    ucode = torch.zeros_like(count)
    for v in range(4):
        ucode = torch.where(counts[..., v] > 0, v, ucode)
    return counts, ucode, level, count


def _gba(rows, meta, f, r, d, active):
    """get_best_alternatives (mer_database.hpp:302-329): the 4 variant
    counts of base 0 kept at the best quality level present, in the
    table `rows` (a plane, or shard planes: `lookup`). Returns
    (counts [N, 4], ucode, level, count)."""
    k = meta.k
    idx = torch.nonzero(active).squeeze(1)
    vals = torch.zeros((f.shape[0], 4), dtype=torch.int64, device=f.device)
    if idx.numel():
        keys = []
        for v in range(4):
            fv, rv = mer.dir_replace0(f[idx], r[idx], torch.full_like(
                idx, v), d[idx], k)
            keys.append(mer.canonical(fv, rv))
        vals[idx] = lookup(rows, meta, torch.cat(keys)).view(4, -1).T
    return _gba_reduce(vals)


def _sub_meta(frm, to):
    return ((torch.where(frm >= 0, frm, 4) << 1)
            | (torch.where(to >= 0, to, 4) << 4))


def _contam_hit(contam, f, r, mask):
    """`mask` lanes whose mer (f, r) is in the contaminant table
    (corrector._contam_hit); all False without one."""
    hit = torch.zeros_like(mask)
    idx = torch.nonzero(mask).squeeze(1)
    if contam is not None and idx.numel():
        crows, cmeta = contam
        hit[idx] = tile_lookup(crows, cmeta,
                               mer.canonical(f[idx], r[idx])) != 0
    return hit


def extend_reads(rows, meta, codes, hqb, lengths, status0, start_off, anc_f,
                 anc_r, prev0, keep, *, window: int, error: int,
                 min_count: int, cutoff: int, maxe: int, contam=None,
                 trim_contaminant: bool = False, planes=None):
    """HK4 (K13 + K15): the reference's extension (oracle._extend,
    error_correct_reads.cc:384-565) for every (read, direction) lane in
    lockstep, both directions stepped directly in the read's own frame
    (d = +1 lanes then d = -1 lanes), from the reads whose anchor status
    `status0` is OK. Backward lanes shift a non-ACGT base in as T, the
    code the JAX package's reverse-complement frame gives it. With a
    contaminant table `contam` = (rows, meta), a lane checks the shifted
    mer (an ACGT base only) and each substituted mer; a hit truncates
    the lane at the position under `trim_contaminant`, else stops it
    with status ST_CONTAMINANT and no log entry. Returns (out int8
    [B, L], start, end, lane status [2B] (status0 of both lanes, where
    the lane met no contaminant), (fwd n, lwin, pos, meta), (bwd n,
    lwin, pos, meta), overflow [1] = 1 where a log outgrew maxe
    entries), all int32. `rows` is one plane, or the shard planes of a
    table sharded by leading row bits under its TileShardedMeta (HK4's
    sharded-table entry; `lookup`).

    With `planes` (event_scan's [2B, L] frame planes) the walk is the
    JAX package's event mode (corrector._extend_loop, planes != None),
    HK4's event entry: a lane is synced while its position is at or past
    `resync` (k past its last substitution, in frame coordinates), and a
    synced lane teleports over a run of clean positions to the next
    event (its mer, and prev where a prev-defining keep lies in the run,
    read from the planes at the run's end), takes a synced step's
    get_best_alternatives from cnt/aux instead of probing, and its
    ambiguous continuation bits from the pre-pass. A desynced lane
    steps live, as in the plain walk; JAX's tail probe is that live walk
    batched (its exact-keep prefix is what the live steps keep, one at a
    time), and its stalls and lane draining only delay a lane, so
    neither has a counterpart here. A backward lane at read position
    `pos` reads frame position len - 1 - pos of its reverse-complement
    row, whose variant v is read code 3 - v. Where the planes' N-as-A
    windows differ from the live mer (an N behind a backward lane that
    kept it), the synced step still takes the planes' facts, as JAX
    does."""
    b, l = codes.shape
    dev = codes.device
    k = meta.k
    nl = 2 * b
    lane = torch.arange(nl, device=dev)
    read = lane % b
    d = torch.where(lane < b, 1, -1)
    so = start_off.to(torch.int64)
    ln = lengths.to(torch.int64)
    codes64 = codes.to(torch.int64)
    f = torch.cat([anc_f, anc_f])
    r = torch.cat([anc_r, anc_r])
    prev = torch.cat([prev0, prev0]).to(torch.int64)
    pos = torch.cat([so, so - k - 1])
    end = torch.cat([ln, torch.full_like(ln, -1)])
    opos = pos.clone()
    found = status0 == OK
    alive = torch.cat([found, found])
    lstatus = torch.cat([status0, status0]).to(torch.int32)
    out = codes.clone()
    logs = _Logs(nl, maxe, d, window, error, dev)
    maxv = meta.max_val
    neg = torch.full_like(lane, -1)

    def in_range(p):
        return torch.where(d > 0, p < end, p > end)

    def trunc_raw(p):
        return p + (d < 0)  # backward_log::truncation records pos + 1

    if planes is not None:
        clean2, nd2, cnt2, aux2, lastc1, prevval, mf2, mr2 = planes
        ln2 = torch.cat([ln, ln])
        resync = torch.full_like(lane, -(1 << 30))
        # frame variant of read code v: v forward, 3 - v backward
        vmap = torch.where(d[:, None] > 0, torch.arange(4, device=dev),
                           3 - torch.arange(4, device=dev))

        def frame(p):  # read position <-> frame position (an involution)
            return torch.where(d > 0, p, ln2 - 1 - p)

        def at(plane, fp, mask):
            return plane_read(plane, lane, fp, mask).to(torch.int64)

    while True:
        act = alive & in_range(pos)
        if planes is not None:
            fp = frame(pos)
            syn0 = act & (fp >= resync)
            tel = syn0 & plane_read(clean2, lane, fp, syn0)
            if bool(tel.any()):
                tgt = torch.minimum(at(nd2, fp, tel), ln2)
                mf, mr = at(mf2, tgt - 1, tel), at(mr2, tgt - 1, tel)
                f = torch.where(tel, torch.where(d > 0, mf, mr), f)
                r = torch.where(tel, torch.where(d > 0, mr, mf), r)
                upd = tel & (at(lastc1, tgt - 1, tel) >= fp)
                prev = torch.where(upd, at(prevval, tgt - 1, upd), prev)
                opos = torch.where(tel, opos + d * (tgt - fp), opos)
                pos = torch.where(tel, frame(tgt), pos)
                act = alive & in_range(pos)
        if not bool(act.any()):
            break
        cpos = pos
        pos = torch.where(act, pos + d, pos)
        cp = cpos.clamp(0, l - 1)
        ori = torch.where(act, codes64[read, cp], neg)
        qb = act & hqb[read, cp]
        code = torch.where(ori >= 0, ori, torch.where(d > 0, 0, 3))
        nf, nr = mer.dir_shift(f, r, code, d, k)
        f, r = torch.where(act, nf, f), torch.where(act, nr, r)
        # contaminant on the shifted mer (error_correct_reads.cc:401-407)
        con1 = _contam_hit(contam, f, r, act & (ori >= 0))
        act = act & ~con1
        if planes is None:
            counts, ucode, level, count = _gba(rows, meta, f, r, d, act)
            pre = None
        else:
            cfp = frame(cpos)
            syn = act & (cfp >= resync)
            counts, ucode, level, count = _gba(rows, meta, f, r, d,
                                               act & ~syn)
            pc, pa = at(cnt2, cfp, syn), at(aux2, cfp, syn)
            counts = torch.where(syn[:, None], (pc[:, None] >> (7 * vmap))
                                 & 127, counts)
            level = torch.where(syn, pa & 1, level)
            count = torch.where(syn, (pa >> AX_COUNT) & 7, count)
            pu = (pa >> AX_UCODE) & 3
            ucode = torch.where(syn, torch.where(d > 0, pu, 3 - pu), ucode)
            # the pre-pass bits, in read variant order
            pre = (syn & (((pa >> AX_PRE) & 1) == 1),
                   ((pa[:, None] >> (AX_SUCC + vmap)) & 1) == 1,
                   ((pa[:, None] >> (AX_CWN + vmap)) & 1) == 1)

        t0 = act & (count == 0)
        c1 = act & (count == 1)
        prev = torch.where(c1, counts.gather(1, ucode[:, None])[:, 0], prev)
        sub1 = c1 & (ori != ucode)
        nf, nr = mer.dir_replace0(f, r, ucode, d, k)
        f, r = torch.where(c1, nf, f), torch.where(c1, nr, r)
        # log_substitution checks the substituted mer first (cc:360-379)
        con2 = _contam_hit(contam, f, r, sub1)
        sub1 = sub1 & ~con2
        trip1 = logs.append(sub1, cpos, _sub_meta(ori, ucode))
        diff1 = logs.remove_last_window(trip1)
        logs.append(trip1, trunc_raw(cpos - d * diff1),
                    torch.ones_like(lane))
        opos = torch.where(trip1, opos - d * diff1, opos)
        write = c1 & ~trip1 & ~con2

        cm = act & (count > 1)
        has_ori = cm & (ori >= 0)
        c_ori = torch.where(has_ori, counts.gather(1, ori.clamp(0)[:, None])
                            [:, 0], 0)
        ori_hi = has_ori & (c_ori > min_count)
        keep_cut = ori_hi & ((c_ori >= cutoff) | qb)
        ksum = counts.sum(dim=1).clamp(max=4 * maxv)
        keep_poi = (ori_hi & ~keep_cut
                    & keep[ksum, c_ori.clamp(0, maxv)].bool())
        keep_s = keep_cut | keep_poi
        t_a = has_ori & ~ori_hi & (level == 0) & (c_ori == 0)
        t_b = cm & (ori < 0) & (level == 0)
        ambig = cm & ~keep_s & ~t_a & ~t_b

        trip2 = torch.zeros_like(act)
        t_c = torch.zeros_like(act)
        amb_w = torch.zeros_like(act)
        con3 = torch.zeros_like(act)
        rep2 = torch.zeros_like(act)
        ia = torch.nonzero(ambig).squeeze(1)
        if ia.numel():
            (trip2, t_c, amb_w, con3, rep2, f, r, opos) = _ambiguous(
                rows, meta, logs, ia, f, r, d, pos, end, read, codes64,
                counts, level, prev, ori, cpos, opos, min_count, nl, contam,
                pre)
        if planes is not None:  # the mer left the original windows
            resync = torch.where(sub1 | rep2, cfp + k, resync)
        con = con1 | con2 | con3
        trunc = t0 | t_a | t_b | t_c
        if trim_contaminant:
            trunc = trunc | con
        else:
            lstatus = torch.where(con, ST_CONTAMINANT, lstatus)
        logs.append(trunc, trunc_raw(cpos), torch.ones_like(lane))
        alive = alive & ~(t0 | trip1 | t_a | t_b | trip2 | t_c | con)
        write = write | keep_s | amb_w
        w = torch.nonzero(write).squeeze(1)
        out[read[w], opos[w]] = mer.dir_base0(f[w], d[w], k).to(torch.int8)
        opos = torch.where(write, opos + d, opos)

    end_f = torch.where(found, opos[:b], so)
    start = torch.where(found, opos[b:] + 1, so - k)

    def i32s(*xs):
        return tuple(x.to(torch.int32) for x in xs)

    overflow = torch.tensor([int(logs.overflow)], dtype=torch.int32,
                            device=dev)
    return (out, *i32s(start, end_f), lstatus,
            i32s(logs.n[:b], logs.lwin[:b], logs.pos[:b], logs.meta[:b]),
            i32s(logs.n[b:], logs.lwin[b:], logs.pos[b:], logs.meta[b:]),
            overflow)


def plane_read(plane, lane, fp, mask):
    """plane[lane, fp] where `mask`, 0 elsewhere (fp clamped into the
    row): every read the event walk makes of an HK17 frame plane, one
    element a masked lane, as HK4's event entry reads them."""
    v = plane[lane, fp.clamp(0, plane.shape[1] - 1)]
    return torch.where(mask, v, torch.zeros_like(v))


def _ambiguous(rows, meta, logs, ia, f, r, d, pos, end, read, codes64,
               counts, level, prev, ori, cpos, opos, min_count, nl, contam,
               pre=None):
    """The multiple-alternatives path (error_correct_reads.cc:473-545)
    for the lanes `ia`: continuation probe, then the tie-break chain
    including the int-overflow dead code (prev_count <= min_count never
    substitutes; oracle module docstring), then the substitution's
    contaminant check. `pre` = (has, succ [N, 4], cwn [N, 4]) full-width:
    lanes with `has` take the event planes' pre-pass bits instead of
    probing. Also returns the lanes whose mer took another base."""
    k = meta.k
    da = d[ia]
    pa = pos[ia]
    inr = torch.where(da > 0, pa < end[ia], pa > end[ia])
    l = codes64.shape[1]
    rnb = torch.where(inr, codes64[read[ia], pa.clamp(0, l - 1)], -1)
    ca = counts[ia]
    elig = ca > min_count
    check = ori[ia]
    for i in range(4):
        check = torch.where(elig[:, i], i, check)
    succ = torch.zeros_like(elig)
    cwn = torch.zeros_like(elig)
    has = torch.zeros_like(inr) if pre is None else pre[0][ia]
    for i in range(4):
        fi, ri = mer.dir_replace0(f[ia], r[ia], torch.full_like(ia, i), da, k)
        fi, ri = mer.dir_shift(fi, ri, torch.zeros_like(ia), da, k)
        nc, _u, nlev, ncnt = _gba(rows, meta, fi, ri, da,
                                  elig[:, i] & ~has)
        s_i = elig[:, i] & (ncnt > 0) & (nlev >= level[ia])
        succ[:, i] = s_i
        cwn[:, i] = s_i & (rnb >= 0) & (nc.gather(1, rnb.clamp(0)[:, None])
                                         [:, 0] > 0)
    if pre is not None:
        succ = torch.where(has[:, None], pre[1][ia], succ)
        cwn = torch.where(has[:, None], pre[2][ia], cwn)
    success = succ.any(dim=1)
    cont = torch.where(succ, ca, 0)
    pr = prev[ia]
    diffs = (cont - pr[:, None]).abs()
    min_diff = torch.where(cont > 0, diffs, 2**31 - 1).amin(dim=1)
    cand = success[:, None] & (pr > min_count)[:, None] & (diffs == min_diff[:, None])
    ncand = cand.sum(dim=1)
    cc = torch.full_like(ia, -1)
    for i in range(4):
        cc = torch.where(cand[:, i], i, cc)
    tie = (ncand > 1) & (rnb >= 0)
    ncand = torch.where(tie, (cand & cwn).sum(dim=1), ncand)
    for i in range(4):
        cc = torch.where(tie & cand[:, i] & cwn[:, i], i, cc)
    cc = torch.where(ncand != 1, -1, cc)
    check = torch.where(success, cc, check)

    do_rep = success & (check >= 0)
    nf, nr = mer.dir_replace0(f[ia], r[ia], check.clamp(0), da, k)
    f, r = f.clone(), r.clone()
    f[ia] = torch.where(do_rep, nf, f[ia])
    r[ia] = torch.where(do_rep, nr, r[ia])

    def full(x, fill=False):
        o = torch.full((nl,), fill, dtype=x.dtype, device=x.device)
        o[ia] = x
        return o

    rep2 = full(do_rep & (check != ori[ia]))
    con3 = _contam_hit(contam, f, r, rep2)
    sub2 = rep2 & ~con3
    check_f = full(check, -1)
    trip2 = logs.append(sub2, cpos, _sub_meta(ori, check_f))
    diff2 = logs.remove_last_window(trip2)
    logs.append(trip2, cpos - d * diff2 + (d < 0), torch.ones_like(pos))
    opos = torch.where(trip2, opos - d * diff2, opos)
    amb = full(torch.ones_like(do_rep)) & ~con3
    t_c = amb & ~trip2 & (ori < 0) & (check_f < 0)
    return trip2, t_c, amb & ~trip2 & ~t_c, con3, rep2, f, r, opos


# --------------------------------------------------------------- HK5


def stage2_head(rows, meta, wire, b: int, length: int, thresholds,
                qual_cutoff: int, *, skip: int, good: int,
                anchor_count: int, contam=None,
                trim_contaminant: bool = False):
    """K1 + K2 + K10 + K11 (corrector.find_anchors): widen the wire,
    look every window's canonical mer up (non-ACGT bases enter the mer
    as A; such windows are invalid), and anchor each read at the first p
    where `good` consecutive checked windows had an hq count >=
    anchor_count; invalid windows and low checked counts reset the run.
    With a contaminant table `contam` = (rows, meta), a valid window
    (past `skip`) whose mer is a member is neither good nor a reset, and
    unless `trim_contaminant` a checked one before the anchor kills the
    read (ST_CONTAMINANT). Returns (codes, hqb, lengths int32, (found,
    start_off int32, f, r, prev int32, status int32)); start_off is one
    past the first window whose run reaches `good` (1 where there is
    none), and a read that is not anchored gets position 0's mers and
    value. `rows` is one plane, or shard planes under a TileShardedMeta
    (HK5's sharded-table entry; `lookup`)."""
    k = meta.k
    _pc, _nm, _hq, lengths = mer.wire_parts(wire, b, length, thresholds)
    codes, hqb = widen_wire(wire, b, length, thresholds, qual_cutoff)
    f, r, validk = mer.rolling_kmers(codes, k)
    canon = mer.canonical(f, r)
    vals = lookup(rows, meta, canon.reshape(-1)).view(b, length)
    p = torch.arange(length, device=codes.device)[None, :]
    vw = validk & (p >= skip + k - 1)
    val_hq = torch.where(vw & ((vals & 1) == 1), vals >> 1, 0)
    checked = vw & (p <= lengths[:, None].to(torch.int64) - 2)
    con = _contam_hit(contam, canon.reshape(-1), canon.reshape(-1),
                      vw.reshape(-1)).view(b, length)  # canonical(x, x) = x
    a = checked & ~con & (val_hq >= anchor_count)
    z = ~vw | (checked & ~con & (val_hq < anchor_count))
    cum_a = torch.cumsum(a.to(torch.int64), dim=1)
    last_z = torch.cummax(torch.where(z, p, -1), dim=1).values
    cum_at_z = torch.gather(cum_a, 1, last_z.clamp(min=0))
    run = cum_a - torch.where(last_z >= 0, cum_at_z, 0)
    hit = a & (run >= good)
    has_hit = hit.any(dim=1)
    anchor_p = torch.argmax(hit.to(torch.uint8), dim=1)
    kill = checked & con
    killed = torch.zeros_like(has_hit)
    if not trim_contaminant:
        kill_p = torch.argmax(kill.to(torch.uint8), dim=1)
        killed = kill.any(dim=1) & (~has_hit | (kill_p < anchor_p))
    found = has_hit & ~killed
    status = torch.where(found, OK, torch.where(killed, ST_CONTAMINANT,
                                                ST_NO_ANCHOR))
    ap = torch.where(found, anchor_p, 0)[:, None]
    return codes, hqb, lengths.to(torch.int32), (
        found, (anchor_p + 1).to(torch.int32), torch.gather(f, 1, ap)[:, 0],
        torch.gather(r, 1, ap)[:, 0],
        torch.gather(val_hq, 1, ap)[:, 0].to(torch.int32),
        status.to(torch.int32))


# --------------------------------------------------------------- HK6


def tile_export(rows, meta):
    """K8: the v4/v5 payload as one uint8 tensor -- per-row occupancy
    counts (u8), the occupied entries' lo words (LE u32) in canonical
    order (each row sorted by (empty, hi, lo), so the file is a pure
    function of the table's content), then `hi_bytes` byte planes of
    their hi words."""
    rows3 = rows.view(-1, TSLOTS, 2)
    lo = u32(rows3[..., 0])
    hi = u32(rows3[..., 1])
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
    parts = [counts, i32(clo).view(torch.uint8)]
    parts += [((chi >> (8 * j)) & 0xFF).to(torch.uint8)
              for j in range(meta.hi_bytes)]
    return torch.cat(parts)


def tile_compact(rows, meta, cap: int):
    """K22 (ctable.tile_compact_device): the occupied slots' (row
    address, lo, hi) in row-major slot order, in `cap` lanes (zeros past
    the n-th; entries past cap are dropped), and n, the occupied slots
    in all. Returns (addr int32 [cap], lo int32 [cap], hi int32 [cap],
    n int64)."""
    slots = rows.view(-1, 2)
    idx = torch.nonzero((slots[:, 0] & meta.max_val) != 0).squeeze(1)
    keep = idx[:cap]
    out = [torch.zeros(cap, dtype=torch.int32, device=rows.device)
           for _ in range(3)]
    m = keep.numel()
    out[0][:m] = (keep // TSLOTS).to(torch.int32)
    out[1][:m] = slots[keep, 0]
    out[2][:m] = slots[keep, 1]
    return (*out, torch.tensor(idx.numel(), dtype=torch.int64,
                               device=rows.device))


# --------------------------------------------------------------- HK7


def tile_load(payload, meta, n: int, nrows: int | None = None):
    """K9 + the statistics of K7: decode the payload's lo words and hi
    byte planes, scatter entry i of row a into slot rank-within-row of
    a fresh row plane (meta's rows, or `nrows` for a row range of the
    table), and count (occupied, distinct_hq, total_hq) over the
    entries. Returns (rows int32 [nrows, 128], stats int64 [3])."""
    nrows = meta.rows if nrows is None else nrows
    cnt = payload[:nrows].to(torch.int64)
    lo = payload[nrows:nrows + 4 * n].view(n, 4).to(torch.int64)
    lo = lo[:, 0] | (lo[:, 1] << 8) | (lo[:, 2] << 16) | (lo[:, 3] << 24)
    hi = torch.zeros(n, dtype=torch.int64, device=payload.device)
    base = nrows + 4 * n
    for j in range(meta.hi_bytes):
        hi |= payload[base + j * n:base + (j + 1) * n].to(torch.int64) \
            << (8 * j)
    rows = torch.zeros((nrows, 2 * TSLOTS), dtype=torch.int32,
                       device=payload.device)
    if n:
        addr = torch.repeat_interleave(
            torch.arange(nrows, device=payload.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        rank = torch.arange(n, device=payload.device) - first[addr]
        flat = rows.view(-1)
        at = addr * 2 * TSLOTS + 2 * rank
        flat[at] = i32(lo)
        flat[at + 1] = i32(hi)
    count = lo & meta.max_val
    occ = count != 0
    q = occ & (((lo >> meta.bits) & 1) == 1)
    return rows, torch.stack([occ.sum(), q.sum(),
                              torch.where(q, count, 0).sum()])


# --------------------------------------------------------------- HK8


def tile_grow(bstate, meta, new, new_meta, chunk: int = 1 << 22) -> bool:
    """K6: re-insert every live slot of `bstate` into the doubled table
    `new`. The full hash is (rem << rb) | addr, so doubling moves rem's
    low bit into the address top bit. Returns True if a slot found no
    room."""
    tag = bstate.tag.view(-1)
    n_slots = meta.rows * TSLOTS
    rl = meta.rlo_bits
    for start in range(0, n_slots, chunk):
        stop = min(n_slots, start + chunk)
        rlo = u32(tag[2 * start:2 * stop:2])
        rhi = u32(tag[2 * start + 1:2 * stop:2])
        hq = bstate.hq[start:stop]
        lq = bstate.lq[start:stop]
        valid = (rlo != EMPTY) & ((hq | lq) != 0)
        idx = torch.nonzero(valid).squeeze(1)
        addr = ((idx + start) // TSLOTS) | ((rlo[idx] & 1) << meta.rb_log2)
        nrlo = (rlo[idx] >> 1) | ((rhi[idx] & 1) << (rl - 1))
        nrhi = rhi[idx] >> 1
        if not insert_parts(new, new_meta, addr, nrlo & M32, nrhi,
                            hq[idx], lq[idx]).all():
            return True
    return False


def grow_shard(bstate, meta, s: int):
    """HK8's shard entry, pass 1: shard `s`'s live slots under `meta`
    (the geometry before the doubling) as lanes int32 [n, 5] of (row,
    rlo, rhi, hq, lq) in the doubled geometry, bucketed by their new
    shard (slot order inside a bucket), and the bucket sizes int64 [S].
    The doubled address is addr | (rlo & 1) << rb, so the new shard is
    ((rlo & 1) << (owner_bits - 1)) | (s >> 1) and the row there
    (s & 1) << local_rb | row; at owner_bits = 0, shard 0 and HK8's
    address."""
    tag = bstate.tag.view(-1)
    rlo, rhi = u32(tag[0::2]), u32(tag[1::2])
    hq, lq = u32(bstate.hq), u32(bstate.lq)
    idx = torch.nonzero((rlo != EMPTY) & ((hq | lq) != 0)).squeeze(1)
    row, bit = idx // TSLOTS, rlo[idx] & 1
    ob, lrb = meta.owner_bits, meta.local_rb
    if ob == 0:
        owner = torch.zeros_like(idx)
        row = row | (bit << lrb)
    else:
        owner = (bit << (ob - 1)) | (s >> 1)
        row = ((s & 1) << lrb) | row
    nrlo = (rlo[idx] >> 1) | ((rhi[idx] & 1) << (meta.rlo_bits - 1))
    lanes = torch.stack([row, nrlo, rhi[idx] >> 1, hq[idx], lq[idx]], 1)
    return bucket(owner, i32(lanes), meta.n_shards)


def grow_place(new, lanes) -> bool:
    """HK8's shard entry, pass 2: claim the lanes routed to a shard in
    its fresh doubled slice `new`. Returns True if a lane found no room
    (it cannot)."""
    x = u32(lanes)
    return not bool(insert_parts(new, None, x[:, 0], x[:, 1], x[:, 2],
                                 x[:, 3], x[:, 4]).all())


# --------------------------------------------------------------- HK9


def batch_aggregate(wire, b: int, length: int, thresholds, qual_thresh: int,
                    k: int):
    """K3 (ctable._aggregate_obs_impl at cap = n, as sketch._distinct_lanes
    calls it): the batch's distinct canonical mers as lanes -- keys int64,
    hq / lq int32 (the mer's observations in the batch by qual class).
    Lanes come in ascending key order here; HK9's come in its
    scratch-hash order with empty lanes (key -1) between."""
    codes, hqb = widen_wire(wire, b, length, thresholds, qual_thresh)
    keys, qual, valid = extract_observations(codes, hqb, k)
    ukeys, inv = torch.unique(keys[valid], return_inverse=True)
    q = qual[valid].to(torch.int32)
    hq = torch.zeros(ukeys.numel(), dtype=torch.int32, device=wire.device)
    hq.index_add_(0, inv, q)
    lq = torch.zeros_like(hq).index_add_(0, inv, 1 - q)
    return ukeys, hq, lq


# --------------------------------------------------------------- HK10


def _sketch_mix(x, c: int):
    x = _mul32(x, c | 1)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    return x ^ (x >> 15)


def sketch_addrs(keys, cells_log2: int):
    """The two sketch cells of each canonical int64 mer (int64 indices):
    sketch.sketch_addrs over the mer's high and low 32-bit words,
    h = mix(hi, ca) ^ mix(lo ^ cb, cb), unsigned 32-bit arithmetic."""
    mask = (1 << cells_log2) - 1
    hi = (keys >> 32) & M32
    lo = keys & M32
    return [(_sketch_mix(hi, ca) ^ _sketch_mix(lo ^ cb, cb)) & mask
            for ca, cb in _SKETCH_C]


def sketch_min(cells, cells_log2: int, keys):
    """K17's count-min query (sketch.sketch_min): min(cell[a1], cell[a2])
    per lane as int32, 0 where the lane is empty (key < 0)."""
    a1, a2 = sketch_addrs(keys, cells_log2)
    v = torch.minimum(cells[a1], cells[a2]).to(torch.int32)
    return torch.where(keys >= 0, v, 0)


def sketch_update(cells, cells_log2: int, keys, hq, lq) -> None:
    """K17's update (sketch._sketch_update_lanes), in place: for hash 1
    then hash 2, gather old = cells[a], then scatter-max
    min(2, old + min(mult, 2)) over the batch's distinct lanes (mult =
    hq + lq; empty lanes, key < 0, take no part)."""
    valid = keys >= 0
    k = keys[valid]
    mult = (hq[valid].to(torch.int64) + lq[valid].to(torch.int64)).clamp(
        max=SKETCH_SAT)
    for a in sketch_addrs(k, cells_log2):
        new = (cells[a].to(torch.int64) + mult).clamp(max=SKETCH_SAT)
        cells.scatter_reduce_(0, a, new.to(torch.uint8), "amax")


# --------------------------------------------------------------- HK11


def gated_insert_reads(bstate, meta, cells, cells_log2: int, wire, b: int,
                       length: int, thresholds, qual_thresh: int,
                       part: int = 0, n_parts: int = 1):
    """K18, two-pass mode (sketch._gated_insert_core): HK1 on the
    observations whose mer the finished sketch saw >= 2 times, after
    K20's filter (a mer another pass owns is neither inserted nor
    dropped). Returns ((keys, qual) of the gated observations that found
    no room, dropped int64 [2] = the owned observations that failed the
    gate, hq and lq)."""
    keys, qual = _owned_observations(wire, b, length, thresholds,
                                     qual_thresh, meta, part, n_parts)
    gate = sketch_min(cells, cells_log2, keys) >= SKETCH_SAT
    dropped = torch.stack([(qual & ~gate).sum(), (~qual & ~gate).sum()])
    keys, qual = keys[gate], qual[gate]
    placed = insert_keys(bstate, meta, keys, qual)
    return (keys[~placed], qual[~placed]), dropped


def gated_insert_lanes(bstate, meta, keys, hq, lq, old):
    """K18, inline mode (sketch._gated_insert_core): over a batch's
    distinct lanes (HK9) with `old` = the pre-batch sketch's query of
    each, the gate opens at old + min(mult, 2) >= 2; where old == 1 the
    deferred first observation is credited back (+1 hq if the lane saw
    a high-quality observation, else +1 lq) and the lane's counts go in
    with one claim. Returns (failed bool per lane: gated but no room,
    dropped int64 [2] = the gated-out lanes' hq and lq totals)."""
    h = hq.to(torch.int64)
    l = lq.to(torch.int64)
    o = old.to(torch.int64)
    gate = (keys >= 0) & (o + (h + l).clamp(max=SKETCH_SAT) >= SKETCH_SAT)
    retro = gate & (o == 1)
    drop = (keys >= 0) & ~gate
    dropped = torch.stack([h[drop].sum(), l[drop].sum()])
    idx = torch.nonzero(gate).squeeze(1)
    addr, rlo, rhi = tile_key_parts(keys[idx], meta)
    placed = insert_parts(bstate, meta, addr, rlo, rhi,
                          (h + (retro & (h > 0)))[idx],
                          (l + (retro & (h == 0)))[idx])
    failed = torch.zeros(keys.shape[0], dtype=torch.bool, device=keys.device)
    failed[idx[~placed]] = True
    return failed, dropped


# --------------------------------------------------------------- HK12


def tile_floor(rows, meta, floor: int) -> None:
    """K21 (ctable.tile_floor), in place: entries whose stored count
    (lo & max_val) is below `floor` lose both words."""
    r = rows.view(-1, TSLOTS, 2)
    r.masked_fill_(((r[..., 0] & meta.max_val) < floor)[..., None], 0)


# --------------------------------------------------------------- HK13


def tile_departition(rows, meta, g: int, part: int):
    """K20's rebase (ctable.tile_departition_rows), in place: each
    occupied slot of pass `part`'s sealed plane at the local geometry
    `meta` gets its remainder (hi:rlo, rlo = lo >> (bits + 1)) shifted
    right by g and repacked at the global geometry rb_log2 + g, hi masked
    to the global rem_high width, value and qual bits kept; empty slots
    become (0, 0). Returns bad int32 [1]: 1 if an occupied slot's dropped
    bits disagree with `part`."""
    r = rows.view(-1, 2)
    lo, hi = u32(r[:, 0]), u32(r[:, 1])
    occ = (lo & meta.max_val) != 0
    rl, bits = meta.rlo_bits, meta.bits
    rem = (lo >> (bits + 1)) | (hi << rl)  # < 2^63: rem_bits <= 62
    bad = (occ & ((rem & ((1 << g) - 1)) != part)).any()
    grem = rem >> g
    hi_bits = max(0, 2 * meta.k - (meta.rb_log2 + g) - rl)
    new_lo = (((grem & ((1 << rl) - 1)) << (bits + 1))
              | (lo & ((1 << (bits + 1)) - 1)))
    new_hi = (grem >> rl) & ((1 << min(hi_bits, 32)) - 1)
    r[:, 0] = i32(torch.where(occ, new_lo, 0))
    r[:, 1] = i32(torch.where(occ, new_hi, 0))
    return bad.to(torch.int32).reshape(1)


# --------------------------------------------------------------- HK14


def pack_finish(start, end, status_f, status_b, fwd, bwd, overflow,
                cap: int):
    """K14 (corrector._pack_finish_lean): one batch's result in one u32
    buffer (int32 storage), [maxn][total] [B x start << 16 | end]
    [B x status << 16 | f_n] [B x b_n] [cap x (pos + POS_BIAS) << 16 |
    meta], each field cut to 16 bits, read i's forward then backward
    entries at the exclusive prefix sum of f_n + b_n (entries past cap
    dropped; `total` tells). The read status is the forward lane's where
    it is not OK, else the backward lane's; maxn is the longest log,
    raised past maxe where `overflow` [1] is set. `fwd`/`bwd` are
    (n [B], pos [B, maxe], meta [B, maxe]). Returns (buffer, status
    int32 [B])."""
    dev = start.device
    f_n, f_pos, f_meta = (x.to(torch.int64) for x in fwd)
    b_n, b_pos, b_meta = (x.to(torch.int64) for x in bwd)
    status = torch.where(status_f != OK, status_f, status_b)
    tot = f_n + b_n
    offs = torch.cumsum(tot, 0) - tot
    maxe = f_pos.shape[1]
    j = torch.arange(maxe, device=dev)[None, :]
    flat = torch.zeros(cap, dtype=torch.int64, device=dev)
    for n, pos, meta, base in ((f_n, f_pos, f_meta, offs),
                               (b_n, b_pos, b_meta, offs + f_n)):
        slot = base[:, None] + j
        live = (j < n[:, None]) & (slot < cap)
        flat[slot[live]] = ((((pos + POS_BIAS) & 0xFFFF) << 16)
                            | (meta & 0xFFFF))[live]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    maxn = torch.cat([zero, f_n, b_n]).max()
    maxn = torch.where(overflow[0] != 0, torch.clamp(maxn, min=maxe + 1),
                       maxn)
    geom = torch.stack([maxn, tot.sum()])
    h1 = ((start.to(torch.int64) & 0xFFFF) << 16) | (end.to(torch.int64)
                                                      & 0xFFFF)
    h2 = ((status.to(torch.int64) & 0xFFFF) << 16) | (f_n & 0xFFFF)
    return (i32(torch.cat([geom, h1, h2, b_n & 0xFFFF, flat])),
            status.to(torch.int32))


# --------------------------------------------------------------- HK15


def bucket(owner, lanes, n_shards: int):
    """`lanes` in exact owner buckets: stably ordered by owner, with the
    bucket sizes int64 [n_shards]."""
    order = torch.sort(owner, stable=True).indices
    return lanes[order], torch.bincount(owner, minlength=n_shards)


def shard_route(wire, b: int, length: int, thresholds, qual_thresh: int,
                meta, part: int = 0, n_parts: int = 1):
    """HK15: the batch's observations (widen, extract) as lanes
    (key << 1) | qual int64, bucketed by the shard that owns the mer's
    row under `meta` (observation order inside a bucket), and the
    bucket sizes int64 [S]. With n_parts > 1 (the partition entry) only
    the observations whose mer pass `part` owns (partition_mask at
    `meta`'s global geometry)."""
    keys, qual = _owned_observations(wire, b, length, thresholds,
                                     qual_thresh, meta, part, n_parts)
    owner = shard_key_parts(keys, meta)[0]
    return bucket(owner, (keys << 1) | qual.to(torch.int64), meta.n_shards)


def shard_route_lanes(lanes, meta):
    """HK15's lanes entry: lanes (key << 1) | qual bucketed again by
    their owner under `meta` (after a grow)."""
    return bucket(shard_key_parts(lanes >> 1, meta)[0], lanes,
                  meta.n_shards)


# --------------------------------------------------------------- HK16


def _shr(x, n: int, fill):
    """out[:, j] = x[:, j - n], `fill` where j < n."""
    out = torch.full_like(x, fill)
    if n < x.shape[1]:
        out[:, n:] = x[:, :x.shape[1] - n]
    return out


def _comp(c):
    return torch.where(c >= 0, 3 - c, c)


def _frame_facts(codes, hqb, lengths, start_off, k: int):
    """corrector._frame_facts: per window end e, the step facts of the
    frame that consumes it, forward for e >= start_off and
    reverse-complement for e <= start_off - 2 (the two extensions read
    disjoint ranges). Returns (ori, qual, nbase, wf, wr, f, r, valid):
    the base the step adds (rc frame: the complement of the window's
    first base), its qual >= cutoff bit, the next base in frame
    direction (-1 past the read or at a non-ACGT base), the consuming
    frame's mer (rc frame: the original words swapped), and the window's
    own mer and validity (rolling_kmers: a non-ACGT base enters as A)."""
    l = codes.shape[1]
    c = codes.to(torch.int64)
    e = torch.arange(l, device=codes.device)[None, :]
    fwd = e >= start_off.to(torch.int64)[:, None]
    ln = lengths.to(torch.int64)[:, None]
    ori = torch.where(fwd, c, _comp(_shr(c, k - 1, -2)))
    qual = torch.where(fwd, hqb, _shr(hqb, k - 1, False))
    nb_f = torch.where(e + 1 < ln, torch.roll(c, -1, 1), -1)
    nb_r = torch.where(e - k >= 0, _comp(_shr(c, k, -2)), -1)
    nbase = torch.where(fwd, nb_f, nb_r)
    nbase = torch.where(nbase >= 0, nbase, -1)
    f, r, valid = mer.rolling_kmers(codes, k)
    return (ori, qual, nbase, torch.where(fwd, f, r), torch.where(fwd, r, f),
            f, r, valid)


def _replace0_fwd(f, r, code, k: int):
    return mer.dir_replace0(f, r, code, torch.ones_like(f), k)


def event_planes(rows, meta, codes, hqb, lengths, start_off, keep, *,
                 min_count: int, cutoff: int, contam=None):
    """HK16 (K16's sibling sweep and ambiguous pre-pass,
    corrector._class_planes + _classify + _pack_counts + _ambig_prepass
    with no cap): for every window end e of every read, in the frame
    that consumes it (_frame_facts), the own window's value word and the
    3 sibling probes (the other base-0 variants; a non-ACGT base is
    variant 0, as in the JAX sweep) give the exact get_best_alternatives
    facts, classified as the live step would take them:

      clean  bool  the step keeps the base and logs nothing (count-1
                   keep, cutoff/qual keep or Poisson keep) and the
                   window (valid only) is no contaminant member
      cnt    int32 the 4 kept counts, 7 bits each (variant order of the
                   frame)
      aux    int32 AX_* fields; for every ambiguous-class position the
                   16-probe continuation bits (pass 2)
      val    int32 the own window's value word (its count is prevval)
      f, r   int64 the window's own mers

    all [B, L] in read coordinates. `keep` is the Poisson keep table
    (corrector.make_keep_table). `rows` is one plane or shard planes
    (`lookup`)."""
    k = meta.k
    maxv = meta.max_val
    ori, qual, nbase, wf, wr, f, r, valid = _frame_facts(
        codes, hqb, lengths, start_off, k)
    shape = ori.shape
    own = lookup(rows, meta, mer.canonical(f, r).reshape(-1)).view(shape)
    orie = ori.clamp(0, 3)
    sib = []
    for j in range(3):
        v = j + (orie <= j).to(torch.int64)
        sf, sr = _replace0_fwd(wf, wr, v, k)
        sib.append(lookup(rows, meta, mer.canonical(sf, sr).reshape(-1))
                   .view(shape))
    sib = torch.stack(sib, -1)  # slot j holds variant j + (orie <= j)
    vals = torch.stack(
        [torch.where(orie == i, own, sib.gather(-1, torch.where(
            i > orie, i - 1, i).clamp(0, 2)[..., None])[..., 0])
         for i in range(4)], dim=-1)
    con = _contam_hit(contam, f.reshape(-1), r.reshape(-1),
                      valid.reshape(-1)).view(shape)
    counts, ucode, level, count = _gba_reduce(vals)
    c_ori = torch.where(ori >= 0, counts.gather(-1, orie[..., None])[..., 0],
                        0)
    c1keep = (count == 1) & (ucode == ori)
    ori_hi = (ori >= 0) & (c_ori > min_count)
    keep_cut = (count > 1) & ori_hi & ((c_ori >= cutoff) | qual)
    total = counts.sum(-1).clamp(max=4 * maxv)
    keep_poi = ((count > 1) & ori_hi & ~keep_cut
                & keep[total, c_ori.clamp(0, maxv)].bool())
    clean = (c1keep | keep_cut | keep_poi) & ~con
    t_a = (count > 1) & (ori >= 0) & ~ori_hi & (level == 0) & (c_ori == 0)
    t_b = (count > 1) & (ori < 0) & (level == 0)
    ambig = (count > 1) & ~(keep_cut | keep_poi) & ~t_a & ~t_b
    cnt = (counts[..., 0] | (counts[..., 1] << 7) | (counts[..., 2] << 14)
           | (counts[..., 3] << 21))
    aux = (level | (count << AX_COUNT) | (ucode << AX_UCODE)
           | ((clean & c1keep).to(torch.int64) << AX_C1K))
    # pass 2: the continuation probe of every ambiguous-class position
    ia = torch.nonzero(ambig.reshape(-1)).squeeze(1)
    if ia.numel():
        cf, cr = wf.reshape(-1)[ia], wr.reshape(-1)[ia]
        ca = counts.reshape(-1, 4)[ia]
        la = level.reshape(-1)[ia]
        nb = nbase.reshape(-1)[ia]
        bits = torch.full_like(ia, 1 << AX_PRE)
        for i in range(4):
            elig = ca[:, i] > min_count
            fi, ri = _replace0_fwd(cf, cr, torch.full_like(ia, i), k)
            fi, ri = mer.dir_shift(fi, ri, torch.zeros_like(ia),
                                   torch.ones_like(ia), k)
            nv = torch.zeros((ia.numel(), 4), dtype=torch.int64,
                             device=ia.device)
            ie = torch.nonzero(elig).squeeze(1)
            if ie.numel():
                keys = [mer.canonical(*_replace0_fwd(
                    fi[ie], ri[ie], torch.full_like(ie, j), k))
                    for j in range(4)]
                nv[ie] = lookup(rows, meta, torch.cat(keys)).view(4, -1).T
            ncounts, _u, nlevel, ncount = _gba_reduce(nv)
            s_i = elig & (ncount > 0) & (nlevel >= la)
            c_i = s_i & (nb >= 0) & (ncounts.gather(
                1, nb.clamp(0)[:, None])[:, 0] > 0)
            bits |= (s_i.to(torch.int64) << (AX_SUCC + i)) \
                | (c_i.to(torch.int64) << (AX_CWN + i))
        aux = aux.reshape(-1).clone()
        aux[ia] |= bits
        aux = aux.view(shape)
    return (clean, cnt.to(torch.int32), aux.to(torch.int32),
            i32(own), f, r)


# --------------------------------------------------------------- HK17


def rc_map(x, lengths, k: int, fill):
    """corrector._event_planes' rc_map: the reverse-complement frame's
    row of a per-window-end plane, x[len + k - 2 - p'] at frame position
    p' (the window ending there), `fill` where that lies outside the
    read."""
    l = x.shape[1]
    p = torch.arange(l, device=x.device)[None, :]
    src = lengths.to(torch.int64)[:, None] + (k - 2) - p
    inside = (src >= 0) & (src < lengths.to(torch.int64)[:, None])
    g = torch.gather(x, 1, src.clamp(0, l - 1))
    return torch.where(inside, g, torch.full_like(g, fill))


def event_scan(clean, cnt, aux, val, f, r, lengths, k: int):
    """HK17 (K16's remap and scans, corrector._event_planes :1670-1705):
    HK16's per-window planes [B, L] -> the [2B, L] frame planes the
    event walk reads, forward rows then reverse-complement rows (rc_map),
    as (clean bool, nd int32: the first non-clean frame position >= p,
    L if none, cnt int32, aux int32, lastc1 int32: the last
    prev-defining keep <= p, -1 if none, prevval int32: the own count at
    lastc1 (at 0 where none), mf int64, mr int64: the frame's forward
    and reverse mer of the window ending at p)."""
    l = clean.shape[1]

    def both(x, fill):
        return torch.cat([x, rc_map(x, lengths, k, fill)])

    clean2 = both(clean, False)
    cnt2 = both(cnt, 0)
    aux2 = both(aux, 0)
    mf2 = torch.cat([f, rc_map(r, lengths, k, 0)])
    mr2 = torch.cat([r, rc_map(f, lengths, k, 0)])
    co2 = both(val >> 1, 0)
    p = torch.arange(l, device=clean.device)[None, :].expand_as(clean2)
    nd = torch.flip(torch.cummin(torch.flip(
        torch.where(clean2, l, p), [1]), dim=1).values, [1])
    c1k = ((aux2 >> AX_C1K) & 1) == 1
    lastc1 = torch.cummax(torch.where(c1k, p, -1), dim=1).values
    prevval = torch.gather(co2, 1, lastc1.clamp(min=0))
    return (clean2, nd.to(torch.int32), cnt2, aux2, lastc1.to(torch.int32),
            prevval.to(torch.int32), mf2, mr2)


# --------------------------------------------------------------- HK18-HK20
# K25, the flat bucket-4 table (quorum_tpu/ops/ctable.py:51-560): flat
# u32 planes keytag / hq / lq of 4 * 2^nb_log2 slots (keytag EMPTY =
# empty slot) and, sealed, one entry word a slot.

BUCKET = 4
_FLAT_CHUNK = 1 << 26  # slots a step of a pass over the planes (bounds
#                        the int64 temporaries on a 2^32-slot table)


def feistel_inverse(full: torch.Tensor, k: int) -> torch.Tensor:
    """The canonical mers whose Feistel-mixed keys are `full` (int64):
    the four rounds of `feistel` undone (ctable.feistel_unmix)."""
    kmask = (1 << k) - 1
    l, r = (full >> k) & kmask, full & kmask
    for c in reversed(_ROUND_C):
        l, r = r ^ (mix32((l + c) & M32) & kmask), l
    return (l << k) | r


def flat_bucket_rem(keys, meta):
    """Canonical int64 mers -> (bucket, rem) int64: the low nb_log2 bits
    of the mixed key and the next rem_bits (ctable.bucket_rem)."""
    full = feistel(keys, meta.k)
    return (full & ((1 << meta.nb_log2) - 1),
            (full >> meta.nb_log2) & ((1 << meta.rem_bits) - 1))


def flat_claim(keytag, hq, lq, bucket, rem, hq_add, lq_add):
    """ctable._build_round, repeated until no lane can move: every
    pending lane targets its bucket's slot holding its rem, else the
    bucket's first empty slot; the claimers of one empty slot all write
    their rem there and the one whose rem landed wins (with the lanes of
    its key, which match it next round); every lane placed adds its
    (hq_add, lq_add). Lanes whose bucket holds four other keys stay
    pending. IN PLACE. Returns `placed` (bool per lane)."""
    n = bucket.shape[0]
    dev = bucket.device
    placed = torch.zeros(n, dtype=torch.bool, device=dev)
    pend = torch.arange(n, device=dev)
    j = torch.arange(BUCKET, device=dev)
    while pend.numel():
        base = bucket[pend] * BUCKET
        t = u32(keytag[base[:, None] + j[None, :]])
        r = rem[pend]
        m = t == r[:, None]
        e = t == EMPTY
        has_m, has_e = m.any(1), e.any(1)
        slot = torch.where(has_m, m.to(torch.int8).argmax(1),
                           e.to(torch.int8).argmax(1))
        flat = base + slot
        attempt = has_m | has_e
        if not attempt.any():
            break
        a = torch.nonzero(attempt).squeeze(1)
        keytag[flat[a]] = i32(r[a])
        won = attempt.clone()
        won[a] = u32(keytag[flat[a]]) == r[a]
        w = torch.nonzero(won).squeeze(1)
        hq.index_add_(0, flat[w], hq_add[pend[w]].to(torch.int32))
        lq.index_add_(0, flat[w], lq_add[pend[w]].to(torch.int32))
        placed[pend[w]] = True
        pend = pend[attempt & ~won]
    return placed


def flat_insert(bstate, meta, keys, qual, valid):
    """HK18 (ctable.insert_observations): count each valid observation
    (canonical int64 mer, qual bit) in the build table. Returns
    (placed bool, full: some valid lane found its bucket full)."""
    bucket, rem = flat_bucket_rem(keys, meta)
    q = qual.to(torch.int64)
    idx = torch.nonzero(valid).squeeze(1)
    placed = torch.zeros(keys.shape[0], dtype=torch.bool, device=keys.device)
    placed[idx] = flat_claim(bstate.keytag, bstate.hq, bstate.lq,
                             bucket[idx], rem[idx], q[idx], 1 - q[idx])
    return placed, bool((valid & ~placed).any())


def flat_grow(bstate, meta, new, new_meta) -> None:
    """HK18's grow entry (ctable.grow_build): every occupied slot of the
    build table re-inserted into the empty doubled one `new` by
    ctable.rehash_grow's bit move, its hq and lq carried verbatim (a
    doubled bucket takes the keys of one old bucket: all find room)."""
    occ = torch.cat([torch.nonzero(bstate.keytag[s:s + _FLAT_CHUNK] != -1)
                     .squeeze(1) + s
                     for s in range(0, max(meta.size, 1), _FLAT_CHUNK)])
    rem = u32(bstate.keytag[occ])
    bucket = (occ // BUCKET) | ((rem & 1) << meta.nb_log2)
    flat_claim(new.keytag, new.hq, new.lq, bucket, rem >> 1,
               bstate.hq[occ].to(torch.int64), bstate.lq[occ].to(torch.int64))


def flat_entry_val(entries, meta):
    """Entry words (int32 storage) -> value words count << 1 | qual
    (int64; 0 for an empty slot), ctable.entry_val."""
    e = u32(entries)
    return ((e & meta.max_val) << 1) | ((e >> meta.bits) & 1)


def flat_finalize(bstate, meta):
    """HK20 (ctable.finalize_build + table_stats): the entry plane,
    rem << (bits + 1) | q << bits | count with q = any hq observation
    and count = the hq count if q else the lq count, in [1, max_val];
    0 for an empty slot. Returns (entries int32, stats int64 [3] =
    occupied, distinct_hq (hq entries), total_hq (their counts), exact
    integers)."""
    entries = torch.empty_like(bstate.keytag)
    stats = torch.zeros(3, dtype=torch.int64, device=entries.device)
    for s in range(0, entries.numel(), _FLAT_CHUNK):
        e = slice(s, s + _FLAT_CHUNK)
        tag = u32(bstate.keytag[e])
        occ = tag != EMPTY
        hq, lq = u32(bstate.hq[e]), u32(bstate.lq[e])
        q = (hq > 0) & occ
        cnt = torch.where(q, hq, lq).clamp(1, meta.max_val)
        rem = tag & ((1 << meta.rem_bits) - 1)
        ent = (rem << (meta.bits + 1)) | (q.to(torch.int64) << meta.bits) \
            | cnt
        entries[e] = i32(torch.where(occ, ent, 0))
        stats += torch.stack([occ.sum(), q.sum(),
                              torch.where(q, cnt, 0).sum()])
    return entries, stats


def flat_lookup(entries, meta, keys):
    """HK19 (ctable.lookup): the value word (int32) of each canonical
    int64 mer in the entry plane, 0 if absent."""
    bucket, rem = flat_bucket_rem(keys, meta)
    base = bucket * BUCKET
    out = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    vmask = (1 << (meta.bits + 1)) - 1
    for j in range(BUCKET):
        e = u32(entries[base + j])
        match = ((e & vmask) != 0) & ((e >> (meta.bits + 1)) == rem)
        out = torch.where(match, flat_entry_val(entries[base + j], meta), out)
    return out.to(torch.int32)


# --------------------------------------------------------------- HK21


def minimizer(codes, k: int, m: int):
    """HK21 (mer.minimizer_kmers): for every k-window end p of an int8
    code batch [B, L], the minimum over the window's k - m + 1 m-mers of
    mix32(canonical m-mer), a mixed value equal to the sentinel
    0xFFFFFFFF pinned to 0xFFFFFFFE; the sentinel where the window is
    unfilled or holds a non-ACGT base. Returns (int32 [B, L] holding the
    u32 values, kvalid bool [B, L])."""
    sent = M32
    f, r, mvalid = mer.rolling_kmers(codes, m)
    mval = mer._mix32_mer(torch.minimum(f, r))
    mval = torch.where(mval == sent, sent - 1, mval)
    mval = torch.where(mvalid, mval, sent)
    out = mval.clone()
    for j in range(1, k - m + 1):
        shifted = torch.full_like(mval, sent)
        shifted[:, j:] = mval[:, :-j]
        out = torch.minimum(out, shifted)
    kvalid = mer.run_at_least(codes < 0, k)
    return i32(torch.where(kvalid, out, sent)), kvalid
