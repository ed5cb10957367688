"""Stage-2 corrector on the device (counterpart of the plain path of
quorum_tpu/models/corrector.py).

Per batch: the wire widens to codes and the qual>=cutoff plane, every
window's canonical mer is looked up once (HK3, the position sweep), the
reference's anchor scan (find_starting_mer, error_correct_reads.cc
:609-643) runs in closed form, and HK4 extends every anchored read in
both directions. The host then renders the results.

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
from ..ops import mer
from ..ops.ctable import TileMeta, TileState
from ..ops.poisson import keep_table
from .ec_config import ECConfig, ERROR_NO_STARTING_MER

OK = 0
ST_NO_ANCHOR = 2
STATUS_ERRORS = {ST_NO_ANCHOR: ERROR_NO_STARTING_MER}
_BASES = "ACGTN"


class LogState(NamedTuple):
    n: torch.Tensor     # [B]
    lwin: torch.Tensor  # [B]
    pos: torch.Tensor   # [B, maxe]
    meta: torch.Tensor  # [B, maxe]


class BatchResult(NamedTuple):
    out: torch.Tensor    # int8 [B, L]
    start: torch.Tensor  # [B]
    end: torch.Tensor    # [B]
    status: torch.Tensor  # [B]
    fwd_log: LogState
    bwd_log: LogState


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


def log_capacity(l: int, cfg: ECConfig) -> int:
    """Entries a lane's log can need (corrector.extend): the window
    budget retires a lane once a window holds more than `error`
    entries."""
    w = max(1, cfg.effective_window)
    return min(l + 2, -(-l // w) * (cfg.effective_error + 1) + 8)


def find_anchors(state: TileState, meta: TileMeta, codes: torch.Tensor,
                 lengths: torch.Tensor, cfg: ECConfig) -> Anchors:
    """The position sweep (one HK3 lookup per window end; non-ACGT bases
    enter the mer as A, such windows are invalid) and the closed-form
    anchor scan of corrector.find_anchors: anchor at the first p where
    `good` consecutive checked windows had an hq count >= anchor_count;
    invalid windows and low checked counts reset the run."""
    k = cfg.k
    b, l = codes.shape
    f, r, validk = mer.rolling_kmers(codes, k)
    vals = kernels.tile_lookup(state.rows, meta,
                               mer.canonical(f, r).reshape(-1)).view(b, l)
    p = torch.arange(l, device=codes.device)[None, :]
    vw = validk & (p >= cfg.skip + k - 1)
    val_hq = torch.where(vw & ((vals & 1) == 1), vals >> 1, 0)
    checked = vw & (p <= lengths[:, None].to(torch.int64) - 2)
    a = checked & (val_hq >= cfg.anchor_count)
    z = ~vw | (checked & (val_hq < cfg.anchor_count))
    cum_a = torch.cumsum(a.to(torch.int64), dim=1)
    last_z = torch.cummax(torch.where(z, p, -1), dim=1).values
    cum_at_z = torch.gather(cum_a, 1, last_z.clamp(min=0))
    run = cum_a - torch.where(last_z >= 0, cum_at_z, 0)
    hit = a & (run >= cfg.good)
    found = hit.any(dim=1)
    anchor_p = torch.argmax(hit.to(torch.uint8), dim=1)
    ap = torch.where(found, anchor_p, 0)[:, None]
    return Anchors(found, (anchor_p + 1).to(torch.int32),
                   torch.gather(f, 1, ap)[:, 0], torch.gather(r, 1, ap)[:, 0],
                   torch.gather(val_hq, 1, ap)[:, 0].to(torch.int32))


def correct_codes(state: TileState, meta: TileMeta, codes: torch.Tensor,
                  hqb: torch.Tensor, lengths: torch.Tensor, cfg: ECConfig,
                  keep: torch.Tensor) -> BatchResult:
    """Correct a [B, L] batch already on the table's device: codes int8,
    hqb bool (qual >= cfg.qual_cutoff), lengths int32."""
    anc = find_anchors(state, meta, codes, lengths, cfg)
    maxe = log_capacity(codes.shape[1], cfg)
    out, start, end, fwd, bwd = kernels.extend_reads(
        state.rows, meta, codes, hqb, lengths, anc.found, anc.start_off,
        anc.f, anc.r, anc.prev, keep, window=cfg.effective_window,
        error=cfg.effective_error, min_count=cfg.min_count,
        cutoff=cfg.cutoff, maxe=maxe)
    status = torch.where(anc.found, OK, ST_NO_ANCHOR)
    return BatchResult(out, start, end, status, LogState(*fwd),
                       LogState(*bwd))


def make_keep_table(meta: TileMeta, cfg: ECConfig, device) -> torch.Tensor:
    return torch.from_numpy(keep_table(meta.max_val, cfg.collision_prob,
                                       cfg.poisson_threshold)).to(device)


def correct_batch(state: TileState, meta: TileMeta, codes, quals, lengths,
                  cfg: ECConfig) -> BatchResult:
    """Library entry: numpy or tensor codes int8 [B, L], quals uint8
    [B, L], lengths [B]; runs on the table's device."""
    dev = state.rows.device
    codes = torch.as_tensor(np.asarray(codes, np.int8)).to(dev)
    hqb = torch.as_tensor(np.asarray(quals, np.uint8)).to(dev) \
        >= cfg.qual_cutoff
    lengths = torch.as_tensor(np.asarray(lengths, np.int32)).to(dev)
    return correct_codes(state, meta, codes, hqb, lengths, cfg,
                         make_keep_table(meta, cfg, dev))


def correct_batch_packed(state: TileState, meta: TileMeta, packed,
                         cfg: ECConfig, keep: torch.Tensor) -> BatchResult:
    """correct_batch over the packed wire (io/packing): one H2D buffer,
    widened on the device (K1, plain torch)."""
    packed.require_plane(cfg.qual_cutoff)
    dev = state.rows.device
    wire = torch.from_numpy(packed.to_wire()).to(dev)
    pcodes, nmask, hq, lengths = mer.wire_parts(
        wire, packed.n_reads, packed.length, packed.thresholds)
    codes = mer.unpack_codes(pcodes, nmask, lengths, packed.length)
    hqb = mer.unpack_bits(hq[int(cfg.qual_cutoff)], packed.length)
    return correct_codes(state, meta, codes, hqb, lengths.to(torch.int32),
                         cfg, keep)


# ------------------------------------------------------------ host finish


def _render_entries(n, pos, meta, trunc: str) -> list[str]:
    out = []
    for i in range(len(n)):
        ents = []
        for j in range(int(n[i])):
            m = int(meta[i, j])
            if m & 1:
                ents.append(f"{int(pos[i, j])}:{trunc}")
            else:
                ents.append(f"{int(pos[i, j])}:sub:{_BASES[(m >> 1) & 7]}-"
                            f"{_BASES[(m >> 4) & 7]}")
        out.append(" ".join(ents))
    return out


def finish_batch(res: BatchResult, n: int,
                 codes: np.ndarray) -> list[ReadResult]:
    """Host finish (corrector.finish_batch_host without homo-trim) for
    the first n reads. Like the JAX lean finish, the corrected sequence
    is rebuilt from the INPUT codes (`codes`, int8 [B, L]; a non-ACGT
    base prints as A) plus the logged substitutions, so only the logs
    and three scalars per read cross back from the device."""
    start = res.start[:n].cpu().numpy()
    end = res.end[:n].cpu().numpy()
    status = res.status[:n].cpu().numpy()
    seqs = np.frombuffer(b"ACGT", np.uint8)[np.clip(codes[:n], 0, 3)]

    def host(lg):
        m = max(1, int(lg.n[:n].max()) if n else 1)
        ln, pos, meta = (lg.n[:n].cpu().numpy(),
                         lg.pos[:n, :m].cpu().numpy(),
                         lg.meta[:n, :m].cpu().numpy())
        live = np.arange(m)[None, :] < ln[:, None]
        to = (meta >> 4) & 7
        sel = live & ((meta & 1) == 0) & (to < 4)
        ri = np.nonzero(sel)[0]
        seqs[ri, pos[sel]] = np.frombuffer(b"ACGT", np.uint8)[to[sel]]
        return ln, pos, meta

    fwd = _render_entries(*host(res.fwd_log), "3_trunc")
    bwd = _render_entries(*host(res.bwd_log), "5_trunc")
    results = []
    for i in range(n):
        st = int(status[i])
        if st != OK:
            results.append(ReadResult(False, STATUS_ERRORS[st]))
            continue
        s, e = int(start[i]), int(end[i])
        seq = seqs[i, s:e].tobytes().decode() if e > s else ""
        results.append(ReadResult(True, "", seq, fwd[i], bwd[i], s, e))
    return results
