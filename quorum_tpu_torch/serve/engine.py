"""The warm correction engine (counterpart of quorum_tpu/serve/engine.py):
one loaded database and the stage-2 corrector, reused across requests.

Where the offline path (models/error_correct.run_error_correct) loads the
database, resolves the Poisson cutoff, corrects one file and exits, the
engine does the load and the resolve ONCE at construction and then
exposes `step(records)`: correct one batch of reads and return each
read's exact offline output text. Byte parity with
`quorum_error_correct_reads` is structural: the device path is the same
`correct_batch_packed` -> `fetch_finish` -> `finish_batch_host` chain,
and the rendering is the same `render_result` the offline loop uses.

On a card the load is HK7 (`io/db_format.load_db`), a prefiltered file's
presence floor HK12 (`ctable.tile_floor`), and each step HK5, HK16,
HK17, HK4's event entry and HK14 (`models/corrector`); the warmup's
representative read counts its candidate mers with HK3.

Fixed shapes: every step pads its rows to the fixed `rows` capacity (the
batcher's `--max-batch`) and its columns to the read-length buckets the
offline pipeline uses (io/fastq.LENGTH_BUCKETS). The port compiles
nothing at run time, but `engine_compiles` keeps the JAX package's name
and meaning: the number of distinct `(rows, bucket)` shapes the engine
has stepped. Operators read it to see that `--warmup-lengths` covered
the traffic's buckets; a warm server's steady state never grows it.

The `serve_dispatch_us` / `serve_wait_us` split of each step: dispatch
holds the wire's H2D copy from pageable memory (which the host waits
for) and the enqueueing of the step's launches (HK5, HK16, HK17, HK4,
HK14); wait holds the host blocked in `torch.cuda.synchronize` on the
engine's device until those kernels finish. The one D2H copy
(`fetch_finish`, with its rare second HK14 pack) follows, in the
`serve_fetch` span, outside both.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from .. import resolve_device
from ..io import contaminant as contaminant_mod
from ..io import db_format, fastq
from ..models.corrector import (correct_batch_packed, fetch_finish,
                                finish_batch_host, make_keep_table)
from ..models.ec_config import ECConfig
from ..models.error_correct import (ECOptions, new_outcome,
                                    pack_for_stage2,
                                    precreate_outcome_counters,
                                    record_outcome, render_result,
                                    resolve_cutoff)
from ..ops import ctable, mer
from ..telemetry import NULL, observe_dispatch_wait
from ..telemetry.spans import NULL_TRACER
from ..utils import faults
from ..utils.vlog import vlog


class CorrectionEngine:
    """A warm, reusable stage-2 corrector on one device.

    `rows` is the fixed device-batch row capacity: every step is padded
    to exactly `rows` reads (padding rows are length 0 and cost only
    masked lanes). Reads longer than the largest length bucket get a
    one-off shape, as in the offline pipeline.

    Thread model: `step` serializes device access with a lock and enters
    the engine's device for the step (a new thread's current CUDA device
    is device 0, whatever `device` says); the host render afterwards runs
    outside the lock. One dispatcher thread calling `step` is the
    intended shape (serve/batcher.py), but the watchdog's step and
    rebuild threads call it too.
    """

    def __init__(self, db_path: str, *, cutoff: int | None = None,
                 qual_cutoff: int = 127, skip: int = 1, good: int = 2,
                 anchor_count: int = 3, min_count: int = 1,
                 window: int = 10, error: int = 3,
                 homo_trim: int | None = None,
                 trim_contaminant: bool = False,
                 no_discard: bool = False,
                 contaminant: str | None = None,
                 apriori_error_rate: float = 0.01,
                 poisson_threshold: float = 1e-6,
                 no_mmap: bool = False, rows: int = 1024,
                 verify_db: str = "full", device: str = "cuda",
                 registry=NULL, tracer=NULL_TRACER):
        if rows < 1:
            raise ValueError("rows must be >= 1")
        self.rows = int(rows)
        self.db_path = db_path
        self.registry = registry
        self.tracer = tracer
        self.verify_db = verify_db
        self.device = resolve_device(device)
        opts = ECOptions(cutoff=cutoff,
                         apriori_error_rate=apriori_error_rate,
                         poisson_threshold=poisson_threshold,
                         no_mmap=no_mmap)
        vlog("Loading mer database")
        # verify_db: checksum verification of v5 databases before serving
        # from them ("sample" keeps hot /reload and watchdog rebuilds
        # latency-bounded); a bad digest refuses the build and a reload
        # rolls back
        with self._on_device():
            self.state, self.meta, header, (_occ, distinct, total) = \
                db_format.load_db(db_path, device=self.device,
                                  verify=verify_db, no_mmap=no_mmap)
            cutoff = resolve_cutoff(opts, (distinct, total), header)
            # a prefiltered database declares its presence floor; applying
            # it keeps serve byte-identical to the offline CLI over the
            # same database (plain databases declare none: floor 1)
            floor = int((header.get("prefilter") or {}).get("min_obs", 1))
            if floor > 1:
                self.state = ctable.tile_floor(self.state, self.meta, floor)
            vlog("Using cutoff of ", cutoff)
            if cutoff == 0 and opts.cutoff is None:
                raise RuntimeError(
                    "Cutoff computation failed. Pass it explicitly with "
                    "-p switch.")
            self.cfg = ECConfig(
                k=self.meta.k, skip=skip, good=good,
                anchor_count=anchor_count, min_count=min_count,
                cutoff=cutoff, qual_cutoff=qual_cutoff, window=window,
                error=error, homo_trim=homo_trim,
                trim_contaminant=trim_contaminant, no_discard=no_discard,
                collision_prob=apriori_error_rate / 3.0,
                poisson_threshold=poisson_threshold)
            # built once here, not per step
            self.keep = make_keep_table(self.meta, self.cfg, self.device)
            self.contam = None
            if contaminant is not None:
                vlog("Loading contaminant sequences")
                self.contam = contaminant_mod.load_contaminant(
                    contaminant, self.cfg.k, self.device)
        self._lock = threading.Lock()
        self._shapes: set[tuple[int, int]] = set()
        # monotone device-step index: serve_device regions are tagged
        # with it, as the batch loops tag theirs
        self._step_i = 0
        # immutable snapshot of the column widths seen, reassigned whole
        # under the lock: `warm_lengths` must be readable WITHOUT the
        # lock (the watchdog's rebuild reads it while a wedged step may
        # hold the lock forever)
        self._warm: tuple[int, ...] = ()
        # the warmup's representative read (None before a warmup or when
        # it fell back to all-A) and the number of such fallbacks: a
        # failed HK3 launch lands there, where no step would show it
        self.warmup_read: str | None = None
        self.warmup_fallbacks = 0
        registry.gauge("cutoff").set(cutoff)
        registry.set_meta(db=db_path, rows=self.rows, cutoff=cutoff,
                          device=str(self.device))
        # the data-plane quality surface: zero-count skip reasons land in
        # the serve document too, and the header's coverage statistic
        # arms the scorecard's coverage model
        precreate_outcome_counters(registry)
        if getattr(registry, "enabled", False):
            ps = header.get("poisson_stats")
            if ps and ps.get("distinct_hq"):
                registry.set_meta(coverage_mean=round(
                    float(ps["total_hq"]) / float(ps["distinct_hq"]), 4))

    def _on_device(self):
        """The engine's device as the calling thread's current one."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- device step ------------------------------------------------------
    def step(self, records, _warmup: bool = False) -> list[tuple[str, str]]:
        """Correct `records` (a list of (header, seq_bytes, qual_bytes)
        tuples, at most `self.rows` long) and return one (fa_text,
        log_text) pair per record, in order, exactly as the offline CLI
        would write them. Updates the engine's telemetry (outcome
        counters, the dispatch/wait split, the shape count). `_warmup`
        steps count only `engine_compiles`: synthetic warmup reads must
        not pollute the read/skip counters or the latency histograms."""
        if len(records) > self.rows:
            raise ValueError(
                f"batch of {len(records)} exceeds engine rows "
                f"{self.rows}")
        if not records:
            return []
        # chaos-harness site: a plan can fail or hang the Nth device step
        # to exercise the batcher's fault isolation (utils/faults.py)
        faults.inject("serve.engine.step")
        reg = NULL if _warmup else self.registry
        batch = fastq._make_batch(list(records), self.rows)
        pk = pack_for_stage2(batch, self.cfg)
        shape = (batch.codes.shape[0], batch.codes.shape[1])
        with self._lock, self._on_device():
            if shape not in self._shapes:
                # first time this (rows, bucket) shape reaches the device;
                # counted on the REAL registry even during warmup (warmup
                # exists to move first sights before traffic)
                self._shapes.add(shape)
                self._warm = tuple(sorted(
                    {cols for _rows, cols in self._shapes}))
                self.registry.counter("engine_compiles").inc()
                vlog("Engine first sight of shape ", shape)
            step_i = self._step_i
            self._step_i += 1
            t0 = time.perf_counter()
            with self.tracer.step("serve_device", step_i, reads=batch.n):
                res = correct_batch_packed(self.state, self.meta, pk,
                                           self.cfg, self.keep, self.contam)
                t1 = time.perf_counter()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t2 = time.perf_counter()
            with self.tracer.span("serve_fetch"):
                buf = fetch_finish(res)
        # the same *_dispatch_us/*_wait_us split the offline device
        # loops record, so one dashboard reads both
        observe_dispatch_wait(reg, "serve", t0, t1, t2)
        b, maxe = res.fwd_log.pos.shape
        l = res.out.shape[1]
        with self.tracer.span("serve_render", reads=batch.n):
            results = finish_batch_host(buf, batch.n, batch.codes, b, l,
                                        maxe, self.cfg)
            outcome = new_outcome() if reg.enabled else None
            out: list[tuple[str, str]] = []
            n_corr = 0
            for hdr, r in zip(batch.headers, results):
                out.append(render_result(hdr, r, self.cfg, outcome,
                                         maxe=maxe))
                if r.ok:
                    n_corr += 1
        if reg.enabled:
            record_outcome(reg, outcome)
            reg.counter("reads_in").inc(batch.n)
            reg.counter("reads_corrected").inc(n_corr)
            reg.counter("reads_skipped").inc(batch.n - n_corr)
            reg.counter("bases_in").inc(int(batch.lengths[:batch.n].sum()))
            reg.counter("batches").inc()
            reg.histogram("batch_reads").observe(batch.n)
            # per-batch heartbeat: it drives the textfile exporter and
            # (with --metrics-interval) the JSONL event stream
            reg.heartbeat(stage="serve",
                          reads=reg.counter("reads_in").value,
                          bases=reg.counter("bases_in").value)
        return out

    # -- warmup -----------------------------------------------------------
    def warmup(self, lengths=(None,)) -> int:
        """Step once per read length of `lengths` (None entries are
        skipped) before serving, so that each length bucket's shape is
        seen before traffic. Returns the number of steps run; the
        default single-None argument is a no-op (the serve CLI passes
        `--warmup-lengths`).

        Each warmup read is REPRESENTATIVE, not synthetic: assembled by
        walking mers the loaded database holds, with one mid-read flip
        to an absent mer (`representative_read`), so the read anchors
        and the correction extends across an error as real traffic
        does."""
        n = 0
        base = None
        want = [int(ln) for ln in lengths if ln is not None]
        if any(ln <= 0 for ln in want):
            raise ValueError("warmup length must be positive")
        if want:
            try:
                with self._on_device():
                    base = representative_read(self.state, self.meta,
                                               max(want))
            except Exception as e:  # noqa: BLE001 - warmup must not kill boot
                self.warmup_fallbacks += 1
                vlog("Representative warmup read unavailable (", e,
                     "); falling back to all-A")
            self.warmup_read = base
        for ln in want:
            if base is not None:
                seq = bytearray(base[:ln].encode())
                # one flip to a (near-certainly) absent mer, so the
                # corrector anchors on the clean flank and extends
                # across an error
                mid = ln // 2
                seq[mid] = ord("ACGT"["ACGT".index(chr(seq[mid])) ^ 1])
                seq = bytes(seq)
            else:
                seq = b"A" * ln
            qual = b"I" * ln
            self.step([("warmup", seq, qual)], _warmup=True)
            n += 1
        return n

    @property
    def compiles(self) -> int:
        """Distinct device shapes stepped so far (mirrors the
        `engine_compiles` counter even when telemetry is off)."""
        return len(self._shapes)

    @property
    def warm_lengths(self) -> tuple[int, ...]:
        """The column widths (length buckets) this engine has stepped:
        a replacement engine's `warmup()` takes them, so a watchdog
        rebuild or hot reload sees the same buckets before traffic (a
        read as long as a bucket's width maps to that bucket).
        Lock-free on purpose: the rebuild reads it off an engine whose
        wedged step may hold the lock forever."""
        return self._warm


# ---------------------------------------------------------------------------
# Representative warmup reads
# ---------------------------------------------------------------------------


def _counts(state, meta, keys: list[int]) -> list[int]:
    """The stored count of each canonical mer (int, hi << 32 | lo): on a
    card one HK3 launch for them all, on the host each looked up in the
    rows (cli/query_mer_database.lookup_values)."""
    from ..cli.query_mer_database import lookup_values

    return [v >> 1 for v in lookup_values(state, meta, keys)]


def representative_read(state, meta, length: int,
                        sample_rows: int = 2048) -> str:
    """Assemble a read of `length` bases by walking mers the loaded
    database holds (the JAX package's walk, tie-break and filler, so the
    same database gives the same string): sample the first occupied
    table rows (one bounded row slice to the host, never the whole
    table), seed with the highest-count mer found, then extend greedily,
    at each step keeping the base whose next canonical mer the table
    counts highest (the four candidates' counts in one HK3 launch on a
    card). Deterministic per database.

    Raises RuntimeError on an empty sample (callers fall back to
    all-A)."""
    k = meta.k
    if length < k:
        raise RuntimeError(f"length {length} is below k={k}")
    n_sample = min(int(meta.rows), int(sample_rows))
    # slice from row 0 so the sampled rows keep their global bucket
    # addresses: tile_iterate rebuilds keys from the row index
    khi, klo, vals = ctable.tile_iterate(
        ctable.TileState(state.rows[:n_sample]), meta)
    if len(vals) == 0:
        raise RuntimeError("no occupied entries in the sampled rows")
    best = int((vals >> 1).argmax())
    seq = mer.unpack_kmer(int(khi[best]), int(klo[best]), k)
    while len(seq) < length:
        tail = seq[-(k - 1):]
        keys = []
        for b in "ACGT":
            fh, fl = mer.pack_kmer(tail + b, k)
            chi, clo = mer.canonical_py(fh, fl, k)
            keys.append((chi << 32) | clo)
        best_base, best_count = None, 0
        for b, c in zip("ACGT", _counts(state, meta, keys)):
            if c > best_count:
                best_base, best_count = b, c
        # off the end of the sampled contigs: keep the read length with
        # a deterministic filler (its mers are absent, which ends the
        # anchored run like a real read end)
        seq += best_base if best_base else "ACGT"[len(seq) & 3]
    return seq[:length]
