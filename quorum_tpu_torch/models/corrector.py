"""Stage-2 corrector on the device (counterpart of the plain path of
quorum_tpu/models/corrector.py).

Per batch: HK5 widens the wire to codes and the qual>=cutoff plane,
looks every window's canonical mer up once (the position sweep) and
runs the reference's anchor scan (find_starting_mer,
error_correct_reads.cc:609-643); HK4 extends every anchored read in
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
from ..io import packing
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


def make_keep_table(meta: TileMeta, cfg: ECConfig, device) -> torch.Tensor:
    return torch.from_numpy(keep_table(meta.max_val, cfg.collision_prob,
                                       cfg.poisson_threshold)).to(device)


def correct_batch(state: TileState, meta: TileMeta, codes, quals, lengths,
                  cfg: ECConfig) -> BatchResult:
    """Library entry: codes int8 [B, L] (-1 non-ACGT, -2 past the
    read), quals uint8 [B, L], lengths [B]; packed like a parsed batch
    and corrected on the table's device."""
    packed = packing.pack_reads(np.asarray(codes, np.int8),
                                np.asarray(quals, np.uint8),
                                np.asarray(lengths, np.int32),
                                thresholds=(cfg.qual_cutoff,))
    return correct_batch_packed(state, meta, packed, cfg,
                                make_keep_table(meta, cfg, state.rows.device))


def correct_batch_packed(state: TileState, meta: TileMeta, packed,
                         cfg: ECConfig, keep: torch.Tensor) -> BatchResult:
    """correct_batch over the packed wire (io/packing): one H2D buffer,
    then HK5 (widening, sweep, anchors) and HK4 (extension) on the
    table's device."""
    packed.require_plane(cfg.qual_cutoff)
    wire = torch.from_numpy(packed.to_wire()).to(state.rows.device)
    codes, hqb, lengths, anc = kernels.stage2_head(
        state.rows, meta, wire, packed.n_reads, packed.length,
        packed.thresholds, cfg.qual_cutoff, skip=cfg.skip, good=cfg.good,
        anchor_count=cfg.anchor_count)
    anc = Anchors(*anc)
    out, start, end, fwd, bwd = kernels.extend_reads(
        state.rows, meta, codes, hqb, lengths, anc.found, anc.start_off,
        anc.f, anc.r, anc.prev, keep, window=cfg.effective_window,
        error=cfg.effective_error, min_count=cfg.min_count,
        cutoff=cfg.cutoff, maxe=log_capacity(packed.length, cfg))
    status = torch.where(anc.found, OK, ST_NO_ANCHOR)
    return BatchResult(out, start, end, status, LogState(*fwd),
                       LogState(*bwd))


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
