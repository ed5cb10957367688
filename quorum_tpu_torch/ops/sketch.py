"""The singleton prefilter's counting sketch (counterpart of
quorum_tpu/ops/sketch.py).

In error-rich reads most DISTINCT canonical mers are error singletons,
seen once and never trusted by stage 2's count gates, yet each claims a
table slot. The prefilter counts approximately first and spends exact
table memory only on mers that can recur. The sketch is a count-min over
saturating cells {0: never seen, 1: seen once, 2: seen >= 2 times}, two
hash positions per canonical mer, one uint8 a cell. Cells never
undercount, so a mer whose sketch value is < 2 is certainly a singleton;
collisions only inflate (false PASSES: singletons that keep their slot),
never drop.

Two modes (models/create_database):

* ``two-pass``: pass 1 streams every batch into the sketch (HK9
  aggregates the batch to distinct lanes, HK10 updates the cells);
  pass 2 re-reads the input and HK11 inserts only observations whose
  mer the finished sketch saw >= 2 times. Exact: the dropped mers are
  a subset of the true singletons, every kept mer keeps its counts.
* ``inline``: one pass. Per batch HK9 aggregates, HK10 queries the
  pre-batch sketch, HK11 gates each lane on old + min(mult, 2) >= 2,
  credits back the deferred first observation where old == 1, and
  HK10 then updates the sketch with the same lanes. A stored count can
  be off by one under a cell collision or a quality-class change
  between a mer's first and later observations.

The database declares ``prefilter.min_obs = 2``; stage 2 applies that
presence floor after resolving its cutoff from the full-table
statistics the header carries, so a two-pass database corrects to the
same bytes as the unfiltered one at the same floor (the floor theorem:
every dropped mer finalizes below the floor).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..utils import levers

PREFILTER_MODES = ("off", "two-pass", "inline")


class SketchMeta(NamedTuple):
    """2^cells_log2 cells, one uint8 each."""

    cells_log2: int

    @property
    def cells(self) -> int:
        return 1 << self.cells_log2


class SketchState(NamedTuple):
    """The cell plane: uint8 [cells], values in {0, 1, 2}."""

    cells: torch.Tensor


def cells_log2_for(n_hint: int) -> int:
    """~8 cells per expected distinct mer (a false-pass rate near
    (1/8)^2), clamped to [16, 30]; an explicit QUORUM_SKETCH_BITS is
    clamped to [10, 30]."""
    explicit = float(levers.raw("QUORUM_SKETCH_BITS") or 0)
    if explicit:
        return int(min(30, max(10, explicit)))
    auto = max(1, int(n_hint)) * 8
    return int(min(30, max(16, (auto - 1).bit_length())))


def make_sketch(meta: SketchMeta, device) -> SketchState:
    return SketchState(torch.zeros(meta.cells, dtype=torch.uint8,
                                   device=device))


def sketch_min(sk: SketchState, smeta: SketchMeta, keys: torch.Tensor):
    """The count-min query of canonical int64 mers (HK10's query entry):
    min(cell[a1], cell[a2]) as int32, 0 where key < 0."""
    return kernels.sketch_min(sk.cells, smeta.cells_log2, keys)


def prefilter_default() -> str:
    """The mode when the flag is absent or `auto`: QUORUM_PREFILTER if
    it names a mode, else off (the prefilter implies the stage-2 floor,
    so it is an opt-in)."""
    raw = levers.raw("QUORUM_PREFILTER", "")
    return raw if raw in PREFILTER_MODES else "off"


def sketch_update_packed(sk: SketchState, smeta: SketchMeta, k: int, pk,
                         wire: torch.Tensor, qual_thresh: int) -> None:
    """Pass 1 of the two-pass prefilter for one packed batch (`pk`, its
    wire on the sketch's device): HK9 then HK10, in place."""
    keys, hq, lq = kernels.batch_aggregate(
        wire, pk.n_reads, pk.length, pk.thresholds, qual_thresh, k)
    kernels.sketch_update(sk.cells, smeta.cells_log2, keys, hq, lq)


def _lane_observations(failed, keys, hq, lq):
    """The observations of the lanes that found no room: a lane's hq
    high-quality and lq low-quality observations of its mer, as
    (keys, qual) one per observation, for the grow loop."""
    idx = torch.nonzero(failed).squeeze(1)
    k = keys[idx]
    h = hq[idx].to(torch.int64)
    l = lq[idx].to(torch.int64)
    qual = torch.cat([torch.ones(int(h.sum()), dtype=torch.bool,
                                 device=keys.device),
                      torch.zeros(int(l.sum()), dtype=torch.bool,
                                  device=keys.device)])
    return torch.cat([k.repeat_interleave(h), k.repeat_interleave(l)]), qual


def tile_insert_reads_packed_gated(bstate, tmeta, sk: SketchState,
                                   smeta: SketchMeta, pk,
                                   wire: torch.Tensor, qual_thresh: int,
                                   mode: str, part: int = 0,
                                   n_parts: int = 1):
    """The prefiltered twin of HK1's batch insert (in place). Returns
    (full, (keys, qual) of the observations that found no room,
    dropped_hq, dropped_lq): the grow loop's contract is HK1's. In
    inline mode the observations of a lane without room go to the grow
    loop one count each, without the retro credit (as in the JAX
    package); a gated-out observation is done, deferred through the
    sketch. Pass `part` of `n_parts` of a partitioned build (two-pass
    only: the online sketch is not pass-stable) filters the mers before
    the gate, as the JAX package does (sketch.py:224-238), so the
    dropped counts cover only the mers this pass owns."""
    if mode == "two-pass":
        full, pending, dropped = kernels.gated_insert_reads(
            bstate, tmeta, sk.cells, smeta.cells_log2, wire, pk.n_reads,
            pk.length, pk.thresholds, qual_thresh, part, n_parts)
    elif mode == "inline":
        if n_parts > 1:
            raise ValueError("--prefilter=inline does not compose with "
                             "--partitions (the online sketch is not "
                             "pass-stable); use two-pass")
        keys, hq, lq = kernels.batch_aggregate(
            wire, pk.n_reads, pk.length, pk.thresholds, qual_thresh, tmeta.k)
        old = sketch_min(sk, smeta, keys)
        failed, dropped = kernels.gated_insert_lanes(bstate, tmeta, keys, hq,
                                                     lq, old)
        kernels.sketch_update(sk.cells, smeta.cells_log2, keys, hq, lq)
        full = bool(failed.any())
        pending = (_lane_observations(failed, keys, hq, lq) if full else
                   (keys[:0], failed[:0]))
    else:
        raise ValueError(f"gated insert mode must be two-pass or inline, "
                         f"got {mode!r}")
    d_hq, d_lq = (int(x) for x in dropped.tolist())
    return full, pending, d_hq, d_lq
