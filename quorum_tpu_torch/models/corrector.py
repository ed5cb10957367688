"""Stage-2 corrector on the device (counterpart of
quorum_tpu/models/corrector.py).

Per batch: HK5 widens the wire to codes and the qual>=cutoff plane,
looks every window's canonical mer up once (the position sweep, with
the contaminant table beside the main one when there is one) and runs
the reference's anchor scan (find_starting_mer,
error_correct_reads.cc:609-643); HK4 extends every anchored read in
both directions; HK14 packs the result into one buffer, which crosses
to the host once. The host then homo-trims and renders.

`event_driven` (default True, the JAX package's name and default) runs
the JAX event mode: between HK5 and HK4, HK16 classifies every window
in the frame that consumes it and HK17 scans the classes into the
frame planes, and HK4's event entry teleports over clean runs and takes
synced steps from the planes. Its output is the JAX package's event
mode, which departs from the reference at some Ns behind a backward
extension (ROADMAP Queue 3); event_driven=False is the plain walk,
the reference's.

Result fields match corrector.BatchResult: `out` corrected codes, `start`
first kept index, `end` one past the last, `status`, and the forward and
backward edit logs (n, lwin, raw positions, packed meta: bit 0 type
(0 sub, 1 trunc), bits 1-3 from, bits 4-6 to, base codes with 4 = N).
Backward truncations record raw + 1 (error_correct_reads.hpp:170-172).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..io import packing
from ..kernels.reference import OK, POS_BIAS, ST_CONTAMINANT, ST_NO_ANCHOR
from ..ops.ctable import TileMeta, TileState
from ..ops.poisson import keep_table
from .ec_config import (ECConfig, ERROR_CONTAMINANT, ERROR_HOMOPOLYMER,
                        ERROR_NO_STARTING_MER)

ST_HOMOPOLYMER = 3
STATUS_ERRORS = {
    ST_CONTAMINANT: ERROR_CONTAMINANT,
    ST_NO_ANCHOR: ERROR_NO_STARTING_MER,
    ST_HOMOPOLYMER: ERROR_HOMOPOLYMER,
}
_BASES = "ACGTN"
_BASE_U8 = np.frombuffer(b"ACGTN", np.uint8)
# per-(batch, maxe) entry capacity of HK14's buffer: grows (never
# shrinks) to what a batch needed; an overflow packs again, exactly
_LEAN_CAP_CACHE: dict = {}


class LogState(NamedTuple):
    n: torch.Tensor     # int32 [B]
    lwin: torch.Tensor  # int32 [B]
    pos: torch.Tensor   # int32 [B, maxe]
    meta: torch.Tensor  # int32 [B, maxe]


class BatchResult(NamedTuple):
    out: torch.Tensor    # int8 [B, L]
    start: torch.Tensor  # int32 [B]
    end: torch.Tensor    # int32 [B]
    status: torch.Tensor  # int32 [B]
    fwd_log: LogState
    bwd_log: LogState
    packed: torch.Tensor | None = None  # HK14's buffer of the above


class ReadResult(NamedTuple):
    ok: bool
    error: str = ""
    seq: str = ""
    fwd_log: str = ""
    bwd_log: str = ""
    start: int = 0
    end: int = 0


class Anchors(NamedTuple):
    found: torch.Tensor      # bool [B]
    start_off: torch.Tensor  # int32 [B]: first index after the anchor mer
    f: torch.Tensor          # int64 [B] anchor mer, forward
    r: torch.Tensor          # int64 [B] anchor mer, revcomp
    prev: torch.Tensor       # int32 [B] hq count of the anchor mer
    status: torch.Tensor     # int32 [B] OK, ST_CONTAMINANT, ST_NO_ANCHOR


def log_capacity(l: int, cfg: ECConfig) -> int:
    """Entries a lane's log can need (corrector.extend): the window
    budget retires a lane once a window holds more than `error`
    entries."""
    w = max(1, cfg.effective_window)
    return min(l + 2, -(-l // w) * (cfg.effective_error + 1) + 8)


def make_keep_table(meta: TileMeta, cfg: ECConfig, device) -> torch.Tensor:
    return torch.from_numpy(keep_table(meta.max_val, cfg.collision_prob,
                                       cfg.poisson_threshold)).to(device)


def correct_batch(state: TileState, meta: TileMeta, codes, quals, lengths,
                  cfg: ECConfig, contam=None,
                  event_driven: bool = True) -> BatchResult:
    """Library entry: codes int8 [B, L] (-1 non-ACGT, -2 past the
    read), quals uint8 [B, L], lengths [B]; packed like a parsed batch
    and corrected on the table's device. `contam` is an optional
    contaminant set (TileState, TileMeta) at the same k."""
    packed = packing.pack_reads(np.asarray(codes, np.int8),
                                np.asarray(quals, np.uint8),
                                np.asarray(lengths, np.int32),
                                thresholds=(cfg.qual_cutoff,))
    return correct_batch_packed(state, meta, packed, cfg,
                                make_keep_table(meta, cfg, state.rows.device),
                                contam, event_driven)


class Lanes(NamedTuple):
    """HK4's per-read output of one batch (or of one shard's rows of
    it), before HK14 packs it."""

    out: torch.Tensor       # int8 [B, L]
    start: torch.Tensor     # int32 [B]
    end: torch.Tensor       # int32 [B]
    status_f: torch.Tensor  # int32 [B]: the forward lane's status
    status_b: torch.Tensor  # int32 [B]: the backward lane's status
    fwd_log: LogState
    bwd_log: LogState
    overflow: torch.Tensor  # int32 [1]: a log outgrew maxe


def correct_batch_packed(state: TileState, meta: TileMeta, packed,
                         cfg: ECConfig, keep: torch.Tensor,
                         contam=None, event_driven: bool = True
                         ) -> BatchResult:
    """correct_batch over the packed wire (io/packing): one H2D buffer,
    then HK5 (widening, sweep, anchors), in event mode HK16 and HK17
    (the planes), HK4 (extension) and HK14 (the packed result) on the
    table's device."""
    return pack_batch(extend_batch(state, meta, packed, cfg, keep, contam,
                                   event_driven))


def extend_batch(state, meta, packed, cfg: ECConfig, keep: torch.Tensor,
                 contam=None, event_driven: bool = True) -> Lanes:
    """HK5, HK16 and HK17 (event mode) and HK4 on one packed batch, on
    the keep table's device, against `state`: one card's TileState
    (under a TileMeta), or a ShardedTileState read in place (the routed
    layout, under its RoutedTileMeta: HK5's, HK16's and HK4's
    sharded-table entries)."""
    packed.require_plane(cfg.qual_cutoff)
    if contam is not None and contam[1].k != cfg.k:
        raise ValueError(
            f"Contaminant mer length ({contam[1].k}) different than "
            f"correction mer length ({cfg.k})")
    rows = state.rows if isinstance(state, TileState) else state.shards
    ctab = None if contam is None else (contam[0].rows, contam[1])
    ckw = dict(contam=ctab, trim_contaminant=cfg.trim_contaminant)
    wire = torch.from_numpy(packed.to_wire()).to(keep.device)
    b, length = packed.n_reads, packed.length
    codes, hqb, lengths, anc = kernels.stage2_head(
        rows, meta, wire, b, length, packed.thresholds,
        cfg.qual_cutoff, skip=cfg.skip, good=cfg.good,
        anchor_count=cfg.anchor_count, **ckw)
    anc = Anchors(*anc)
    planes = None
    if event_driven:
        classes = kernels.event_planes(
            rows, meta, codes, hqb, lengths, anc.start_off, keep,
            min_count=cfg.min_count, cutoff=cfg.cutoff, contam=ctab)
        planes = kernels.event_scan(*classes, lengths, meta.k)
    out, start, end, lstatus, fwd, bwd, overflow = kernels.extend_reads(
        rows, meta, codes, hqb, lengths, anc.status, anc.start_off,
        anc.f, anc.r, anc.prev, keep, window=cfg.effective_window,
        error=cfg.effective_error, min_count=cfg.min_count,
        cutoff=cfg.cutoff, maxe=log_capacity(length, cfg), planes=planes,
        **ckw)
    return Lanes(out, start, end, lstatus[:b], lstatus[b:], LogState(*fwd),
                 LogState(*bwd), overflow)


def merge_lanes(parts: list, device) -> Lanes:
    """Shards' Lanes of consecutive row ranges of one batch as the
    batch's Lanes on `device` (the overflow flags summed)."""

    def cat(xs):
        return torch.cat([x.to(device) for x in xs])

    logs = [LogState(*(cat(f) for f in zip(*(getattr(p, name)
                                              for p in parts))))
            for name in ("fwd_log", "bwd_log")]
    return Lanes(*(cat([getattr(p, f) for p in parts])
                   for f in ("out", "start", "end", "status_f", "status_b")),
                 *logs,
                 torch.stack([p.overflow.to(device) for p in parts]).sum(
                     0, dtype=torch.int32))


def pack_batch(lanes: Lanes) -> BatchResult:
    """HK14 on one batch's Lanes: the BatchResult with its one packed
    buffer, on the lanes' device."""
    b, maxe = lanes.fwd_log.pos.shape
    fwd, bwd = lanes.fwd_log, lanes.bwd_log
    buf, status = kernels.pack_finish(
        lanes.start, lanes.end, lanes.status_f, lanes.status_b,
        (fwd.n, fwd.pos, fwd.meta), (bwd.n, bwd.pos, bwd.meta),
        lanes.overflow, length=lanes.out.shape[1],
        cap=_LEAN_CAP_CACHE.get((b, maxe), 16384))
    return BatchResult(lanes.out, lanes.start, lanes.end, status, fwd, bwd,
                       buf)


# ------------------------------------------------------------ host finish


def fetch_finish(res: BatchResult) -> np.ndarray:
    """The batch's one device-to-host copy: HK14's buffer as uint32.
    Where its entries outgrew the capacity (total > cap), it packs again
    once with room for all (4096 doubled as needed), and the capacity
    kept for the shape only grows (corrector.fetch_finish)."""
    b, maxe = res.fwd_log.pos.shape
    buf = res.packed.cpu().numpy().view(np.uint32)
    cap = len(buf) - 2 - 3 * b
    total = int(buf[1])
    if total > cap and int(buf[0]) <= maxe:
        cap = 4096
        while cap < total:
            cap *= 2
        # the read statuses are merged already: both lanes take them
        zero = torch.zeros(1, dtype=torch.int32, device=res.start.device)
        packed, _status = kernels.pack_finish(
            res.start, res.end, res.status, res.status,
            (res.fwd_log.n, res.fwd_log.pos, res.fwd_log.meta),
            (res.bwd_log.n, res.bwd_log.pos, res.bwd_log.meta), zero,
            length=res.out.shape[1], cap=cap)
        buf = packed.cpu().numpy().view(np.uint32)
    key = (b, maxe)
    _LEAN_CAP_CACHE[key] = max(_LEAN_CAP_CACHE.get(key, 0), cap, 4096,
                               1 << (max(1, total) - 1).bit_length())
    return buf


def _homo_trim_np(out, start, end, ok, homo_trim_val: int):
    """homo_trim (error_correct_reads.cc:567-597) over a batch: walking
    from the 3' end, score +1 per repeated base, -1 per change; trim at
    the highest-scoring position (the largest position wins ties) if
    the max score reaches the threshold. Returns (trim_mask, max_pos)."""
    l = out.shape[1]
    q = np.arange(l - 1)[None, :]
    inside = (q >= start[:, None]) & (q <= end[:, None] - 2)
    t = np.where(inside, 2 * (out[:, :-1] == out[:, 1:]).astype(np.int64)
                 - 1, 0)
    scores = np.flip(np.cumsum(np.flip(t, 1), 1), 1)  # S[p] = sum t[p:]
    valid = inside & ok[:, None]
    masked = np.where(valid, scores, np.int64(-(2**62)))
    max_score = masked.max(axis=1)
    has = valid.any(axis=1)
    is_max = valid & (masked == max_score[:, None])
    max_pos = np.where(has, np.where(is_max, q, -1).max(axis=1), -1)
    return has & (max_score >= homo_trim_val), max_pos


def _render_dir_flat(nv, offs, pos, meta, trunc: str) -> list[str]:
    """Each read's log text from the flat entries: read i's at
    [offs[i], offs[i] + nv[i])."""
    counts = nv.astype(np.int64)
    tot = int(counts.sum())
    if tot == 0:
        return [""] * len(nv)
    cc = np.cumsum(counts)
    idx = np.repeat(offs.astype(np.int64), counts) \
        + (np.arange(tot) - np.repeat(cc - counts, counts))
    m = meta[idx]
    ents = [f"{p}:{trunc}" if t else f"{p}:sub:{_BASES[f]}-{_BASES[to]}"
            for p, t, f, to in zip(pos[idx].tolist(), (m & 1).tolist(),
                                   ((m >> 1) & 7).tolist(),
                                   ((m >> 4) & 7).tolist())]
    bounds = np.concatenate([[0], cc])
    return [" ".join(ents[bounds[i]:bounds[i + 1]]) for i in range(len(nv))]


def finish_batch(res: BatchResult, n: int, codes: np.ndarray,
                 cfg: ECConfig | None = None) -> list[ReadResult]:
    """Host finish (corrector.finish_batch's lean path) for the first n
    reads: fetch_finish's copy, then finish_batch_host."""
    b, maxe = res.fwd_log.pos.shape
    return finish_batch_host(fetch_finish(res), n, codes, b,
                             res.out.shape[1], maxe, cfg)


def finish_batch_host(buf: np.ndarray, n: int, codes: np.ndarray, b: int,
                      l: int, maxe: int,
                      cfg: ECConfig | None = None) -> list[ReadResult]:
    """The host half of the finish, on numpy alone (a render worker runs
    it while the card corrects the next batch): the first n reads of a
    [b, l] batch with logs of maxe entries, from HK14's fetched buffer.
    The corrected sequence is rebuilt from the INPUT codes (`codes`,
    int8 [B, L]; a non-ACGT base prints as A) plus the logged
    substitutions; then, with cfg.homo_trim, the 3' homopolymer trim and
    its force-truncate, whose reference quirk is kept (err_log.hpp:42-46:
    the forward log drops entries at raw >= the trim position, the
    backward log those at raw <= it, and the forward log gains
    `pos:3_trunc`)."""
    if int(buf[0]) > maxe:
        raise RuntimeError(f"log overflow: more than {maxe} entries")
    total = int(buf[1])
    h1, h2, h3 = buf[2:2 + b], buf[2 + b:2 + 2 * b], buf[2 + 2 * b:2 + 3 * b]
    flat = buf[2 + 3 * b:]

    def s16(x):
        return x.astype(np.uint16).view(np.int16).astype(np.int64)

    start, end = s16(h1 >> 16), s16(h1 & 0xFFFF)
    status, f_n = s16(h2 >> 16), s16(h2 & 0xFFFF)
    b_n = s16(h3 & 0xFFFF)
    offs_f = np.cumsum(f_n + b_n) - (f_n + b_n)
    offs_b = offs_f + f_n
    pos = s16(flat[:total] >> 16) - POS_BIAS
    meta = s16(flat[:total] & 0xFFFF)
    seqs = _BASE_U8[np.clip(np.asarray(codes)[:, :l], 0, 3)]
    sub = ((meta & 1) == 0) & (((meta >> 4) & 7) < 4) & (pos >= 0) & (pos < l)
    ri = np.repeat(np.arange(b), f_n + b_n)
    seqs[ri[sub], pos[sub]] = _BASE_U8[(meta[sub] >> 4) & 7]

    trimmed: set = set()
    if cfg is not None and cfg.do_homo_trim:
        trim, max_pos = _homo_trim_np(seqs[:n], start[:n], end[:n],
                                      status[:n] == OK, cfg.homo_trim)
        for i in np.nonzero(trim)[0]:
            mp = int(max_pos[i])
            if mp < start[i]:  # dead in the reference binary too
                status[i] = ST_HOMOPOLYMER
                continue
            for o, cnt, fwd_side in ((offs_f, f_n, True),
                                     (offs_b, b_n, False)):
                s0, k0 = int(o[i]), int(cnt[i])
                seg_p, seg_m = pos[s0:s0 + k0], meta[s0:s0 + k0]
                keep = seg_p < mp if fwd_side else seg_p > mp
                nk = int(keep.sum())
                pos[s0:s0 + nk] = seg_p[keep]
                meta[s0:s0 + nk] = seg_m[keep]
                cnt[i] = nk
            end[i] = mp
            trimmed.add(int(i))

    fwd = _render_dir_flat(f_n[:n], offs_f[:n], pos, meta, "3_trunc")
    bwd = _render_dir_flat(b_n[:n], offs_b[:n], pos, meta, "5_trunc")
    results = []
    for i in range(n):
        st = int(status[i])
        if st != OK:
            results.append(ReadResult(False, STATUS_ERRORS[st]))
            continue
        s, e = int(start[i]), int(end[i])
        seq = seqs[i, s:e].tobytes().decode() if e > s else ""
        fwd_s = fwd[i]
        if i in trimmed:
            fwd_s = f"{fwd_s} {e}:3_trunc" if fwd_s else f"{e}:3_trunc"
        results.append(ReadResult(True, "", seq, fwd_s, bwd[i], s, e))
    return results
