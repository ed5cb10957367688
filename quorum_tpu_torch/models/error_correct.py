"""Stage 2 as a program: FASTQ in, corrected FASTA + skip log out
(counterpart of quorum_tpu/models/error_correct.py).

The pipeline: a producer thread parses and packs batches ahead
(utils/pipeline.prefetch; the quorum driver's replayed batches skip it);
the main thread makes every CUDA call: H2D, the correction, the
synchronize and the one D2H (corrector.fetch_finish, which may launch
HK14 again); N render workers finish and render the fetched numpy
buffers (render_batch_host), drained in submission order
(ReorderingPool); one writer thread writes `.fa`/`.log` (AsyncWriter).
The output bytes do not depend on -t or --render-workers.

Telemetry (ECOptions.metrics, .trace_spans, .profile; run through
cli/observability) follows quorum_tpu's names: the read, base and
outcome counters (substitutions, truncations, one `skipped_<slug>` per
skip reason), the quality histograms, `render_ms` and
`reorder_wait_ms`, the per-batch `device_dispatch_us` /
`device_wait_us`, the `stage2` timer table, and the spans
`stage2_batch`, `stage2_device` (a device step), `fetch` and `render`.
The outcome tallies are counted only when metrics are on; each render
worker returns its batch's, and the consuming thread folds them in
batch order, so the totals do not depend on --render-workers.

Crash safety (quorum_tpu's journal, io/checkpoint.Stage2Journal, the
same format): with ECOptions.checkpoint_every N the output streams to
`PREFIX.fa.partial` / `.log.partial`; every N batches the render pool
and the writer drain, then the journal commits the batch cursor, the
stats and each partial's byte length and CRC32C. With `resume` the
partials are truncated back to the commit, the journaled batches go by
on the consumer side (parsed, not corrected), and a finished run
renames the partials over `PREFIX.fa` / `.log`. Every batch passes the
`stage2.correct` fault site and the stall watchdog's beat.

Output contract (byte-compatible with the reference):
  * `.fa` record: ``>header fwd_log bwd_log\\nseq\\n``;
  * `.log` record per skipped read: ``Skipped <header>: <reason>\\n``;
  * `--no-discard`: skipped reads also emit ``>header\\nN\\n``;
  * `-o PREFIX` writes PREFIX.fa / PREFIX.log (plus .gz with --gzip),
    else stdout / stderr.
"""

from __future__ import annotations

import dataclasses
import gzip as gzip_mod
import os
import sys
import time
from typing import Iterable, Sequence

from ..io import checkpoint as ckpt_mod
from ..io import contaminant as contaminant_mod
from ..io import db_format, fastq, packing
from ..ops import ctable
from ..ops.poisson import compute_poisson_cutoff
from ..telemetry import observe_dispatch_wait, quality
from ..utils import faults, resources
from ..utils.pipeline import AsyncWriter, ReorderingPool, prefetch
from ..utils.profiling import StageTimer, trace
from .corrector import (correct_batch_packed, fetch_finish,
                        finish_batch_host, make_keep_table)
from ..utils.vlog import vlog
from .ec_config import (DEFAULT_QUAL_CUTOFF, ECConfig, ERROR_CONTAMINANT,
                        ERROR_HOMOPOLYMER, ERROR_NO_STARTING_MER, jax_repr)

# skip reason -> counter slug (the reasons the .log prints, so the
# counters can be recovered from the .log)
REASON_SLUGS = {
    ERROR_CONTAMINANT: "contaminant",
    ERROR_NO_STARTING_MER: "no_anchor",
    ERROR_HOMOPOLYMER: "homopolymer",
}


def _tally_log(log: str, outcome: dict) -> int:
    """Decode one edit log (space-separated ``pos:sub:X-Y`` /
    ``pos:3_trunc`` / ``pos:5_trunc`` entries) into the outcome tally,
    bucketing each entry's read-cycle position for the quality spectra.
    Returns the substitution count."""
    ns = 0
    for ent in log.split():
        pos_s, _, kind = ent.partition(":")
        try:
            bucket = quality.position_bucket(int(pos_s))
        except ValueError:  # pragma: no cover - malformed entry
            continue
        if kind.startswith("sub:"):
            ns += 1
            d = outcome["sub_pos"]
        elif kind == "3_trunc":
            outcome["t3"] += 1
            d = outcome["t3_pos"]
        elif kind == "5_trunc":
            outcome["t5"] += 1
            d = outcome["t5_pos"]
        else:  # pragma: no cover - unknown entry kind
            continue
        d[bucket] = d.get(bucket, 0) + 1
    outcome["subs"] += ns
    return ns


def render_result(hdr: str, r, cfg: ECConfig, outcome: dict | None = None,
                  maxe: int | None = None) -> tuple[str, str]:
    """One read's `.fa` and `.log` text (error_correct_reads.cc
    :246-341). `outcome` (from new_outcome()), when given, accumulates
    the read's outcome tallies; `maxe` bounds the per-read substitution
    count its histogram records."""
    if r.ok:
        if outcome is not None:
            ns = _tally_log(r.fwd_log, outcome)
            ns += _tally_log(r.bwd_log, outcome)
            if maxe is not None:
                ns = quality.bounded(ns, maxe)
            outcome["hist"][ns] = outcome["hist"].get(ns, 0) + 1
        return f">{hdr} {r.fwd_log} {r.bwd_log}\n{r.seq}\n", ""
    if outcome is not None:
        slug = REASON_SLUGS.get(r.error, "other")
        outcome["skips"][slug] = outcome["skips"].get(slug, 0) + 1
    fa = f">{hdr}\nN\n" if cfg.no_discard else ""
    return fa, f"Skipped {hdr}: {r.error}\n"


def new_outcome() -> dict:
    """A fresh outcome tally for render_result: event counts (subs, t3,
    t5), the per-read substitution histogram (hist), the skip reasons
    (skips) and the bucketed read-cycle position spectra (sub_pos,
    t3_pos, t5_pos)."""
    return {"subs": 0, "t3": 0, "t5": 0, "hist": {}, "skips": {},
            "sub_pos": {}, "t3_pos": {}, "t5_pos": {}}


def precreate_outcome_counters(reg) -> None:
    """Create the whole outcome surface at zero, so that the names land
    in the document even when nothing happens (metrics_check requires
    them of every stage-2 document)."""
    if not getattr(reg, "enabled", False):
        return
    for name in ("substitutions", "truncations_3p", "truncations_5p",
                 "skipped_contaminant", "skipped_no_anchor",
                 "skipped_homopolymer", "skipped_other"):
        reg.counter(name)
    for name in ("substitutions_per_read", "sub_pos_bucket",
                 "trunc_cycle_3p", "trunc_cycle_5p"):
        reg.histogram(name)


def record_outcome(reg, outcome: dict) -> None:
    """Fold one batch's outcome tally into the registry."""
    reg.counter("substitutions").inc(outcome["subs"])
    reg.counter("truncations_3p").inc(outcome["t3"])
    reg.counter("truncations_5p").inc(outcome["t5"])
    hist = reg.histogram("substitutions_per_read")
    for v, n in outcome["hist"].items():
        hist.observe(v, n)
    for name, key in (("sub_pos_bucket", "sub_pos"),
                      ("trunc_cycle_3p", "t3_pos"),
                      ("trunc_cycle_5p", "t5_pos")):
        spectrum = reg.histogram(name)
        for v, n in outcome[key].items():
            spectrum.observe(v, n)
    for slug, n in outcome["skips"].items():
        reg.counter(f"skipped_{slug}").inc(n)


def resolve_render_workers(n: int) -> int:
    """`--render-workers`: 0 (the default) = min(4, cores); an explicit
    N as given (1 = one worker)."""
    if n and n > 0:
        return int(n)
    return min(4, os.cpu_count() or 1)


def render_batch_host(batch: fastq.ReadBatch, buf, b: int, l: int,
                      maxe: int, cfg: ECConfig, count_outcomes: bool = False):
    """One batch's host tail on numpy alone (a render worker runs it):
    finish the fetched buffer and render every read's `.fa`/`.log`
    text. Returns (fa_text, log_text, n_corrected, n_skipped, bases_out,
    outcome, seconds); `outcome` is the batch's tally with
    `count_outcomes` (metrics on), else None."""
    t0 = time.perf_counter()
    results = finish_batch_host(buf, batch.n, batch.codes, b, l, maxe, cfg)
    fa_parts: list[str] = []
    log_parts: list[str] = []
    n_corr = n_skip = bases_out = 0
    outcome = new_outcome() if count_outcomes else None
    for hdr, r in zip(batch.headers, results):
        fa, lg = render_result(hdr, r, cfg, outcome, maxe)
        if r.ok:
            n_corr += 1
            bases_out += r.end - r.start
        else:
            n_skip += 1
        if fa:
            fa_parts.append(fa)
        if lg:
            log_parts.append(lg)
    return ("".join(fa_parts), "".join(log_parts), n_corr, n_skip,
            bases_out, outcome, time.perf_counter() - t0)


def pack_for_stage2(batch: fastq.ReadBatch, cfg: ECConfig):
    """Bit-pack one batch for the corrector's wire, on the producer
    thread (the main thread only copies the wire to the card)."""
    pk = packing.pack_reads(batch.codes, batch.quals, batch.lengths,
                            thresholds=(cfg.qual_cutoff,))
    pk.to_wire()  # build the fused buffer off the main thread
    return pk


def _open_out(prefix: str | None, suffix: str, default_stream, gzip: bool):
    """open_file (error_correct_reads.cc:133-155): the default stream
    without a prefix; --gzip appends .gz to named files and compresses
    at level 1."""
    if prefix is None:
        if gzip:
            return gzip_mod.open(default_stream.buffer, "wt", compresslevel=1)
        return default_stream
    path = prefix + suffix + (".gz" if gzip else "")
    if gzip:
        return gzip_mod.open(path, "wt", compresslevel=1)
    return open(path, "w")


@dataclasses.dataclass
class ECStats:
    reads: int = 0
    corrected: int = 0
    skipped: int = 0
    bases_in: int = 0
    bases_out: int = 0
    cutoff: int = 0
    presence_floor: int = 1
    render_workers: int = 1
    host_s: float = 0.0        # parse, pack, finish and render, summed
    parse_pack_s: float = 0.0  # the producer thread's parse and pack
    render_s: float = 0.0      # the render workers' finish and render
    device_s: float = 0.0      # H2D + correction until the result is ready
    fetch_s: float = 0.0       # the one D2H (and an overflow re-pack)
    queue_wait_s: float = 0.0  # main thread blocked on the next batch
    drain_wait_s: float = 0.0  # main thread blocked on a rendered batch
    commits: int = 0           # journal commits (checkpoint_every)
    commit_s: float = 0.0      # their seconds: drain, flush and commit


@dataclasses.dataclass(frozen=True)
class ECOptions:
    output: str | None = None  # -o prefix; None = stdout/stderr
    cutoff: int | None = None  # -p; None = compute from the table
    apriori_error_rate: float = 0.01
    poisson_threshold: float = 1e-6
    batch_size: int = 8192
    verify_db: str = "full"
    device: str = "cuda"
    # --presence-floor: entries with count < N are absent (0 = the
    # database's declared prefilter floor, else none)
    presence_floor: int = 0
    # --contaminant: sequences or a mer database (io/contaminant)
    contaminant: str | None = None
    # --devices N: correct each batch's reads in N row ranges, one a
    # device, against the table replicated on each or, past the
    # replicated layout, row-sharded over them (parallel/tile_sharded)
    devices: int = 1
    threads: int = 1  # -t: parse workers (several files, or spans)
    # --render-workers: finish/render workers behind the reorder stage
    # (0 = min(4, cores)); the output is the same for any count
    render_workers: int = 0
    gzip: bool = False  # --gzip: .fa.gz/.log.gz at compresslevel 1
    on_bad_read: str = "abort"  # abort, skip or quarantine
    no_mmap: bool = False  # -M: read the database instead of mapping it
    # telemetry (cli/observability): the final metrics JSON, its
    # heartbeat period, a live registry without a path, the span JSONL,
    # the torch.profiler directory
    metrics: str | None = None
    metrics_interval: float = 0.0
    metrics_force: bool = False
    trace_spans: str | None = None
    profile: str | None = None
    # crash safety: journal every N batches (needs output, no gzip; 0 =
    # off); resume from the journal
    checkpoint_every: int = 0
    resume: bool = False
    # the resource guards: the disk preflight mode and the stall
    # watchdog's timeout (0 = off)
    preflight: str = "warn"
    stall_timeout_s: float = 0.0


def resolve_cutoff(opts: ECOptions, stats: tuple[int, int],
                   header: dict | None = None) -> int:
    """-p, or compute_poisson_cutoff over (distinct_hq, total_hq) with
    the reference's parameterization (error_correct_reads.cc:710-717):
    the header's full-table `poisson_stats` where a prefiltered build
    declared them, else the table's own statistics (the build's or the
    load's). 0 = failed."""
    if opts.cutoff is not None:
        return opts.cutoff
    vlog("Computing Poisson cutoff")
    ps = (header or {}).get("poisson_stats")
    distinct, total = ((ps["distinct_hq"], ps["total_hq"]) if ps
                       else stats)
    return compute_poisson_cutoff(
        int(distinct), int(total), opts.apriori_error_rate / 3.0,
        opts.poisson_threshold / opts.apriori_error_rate)


def run_error_correct(db_path: str, sequences: Sequence[str],
                      opts: ECOptions, qual_cutoff: int = DEFAULT_QUAL_CUTOFF,
                      skip: int = 1, good: int = 2, anchor_count: int = 3,
                      min_count: int = 1, window: int = 10, error: int = 3,
                      no_discard: bool = False, homo_trim: int | None = None,
                      trim_contaminant: bool = False, db=None,
                      prepacked: Iterable | None = None,
                      mesh: list | None = None,
                      event_driven: bool = True,
                      records: Iterable | None = None) -> ECStats:
    """Run stage 2. `db` is an in-process handoff (state, meta, build
    stats) that skips reading the database file; `prepacked` replays
    (ReadBatch, PackedReads) pairs packed with the qual_cutoff plane
    instead of parsing `sequences` again; `records`, an iterator of
    (header, seq, qual) tuples (the quorum driver's merged mate pairs,
    cli/merge_mate_pairs.merge_records), is batched by
    fastq.batch_records in opts.batch_size rows and read instead of
    `sequences`, never through the native parser. A handed-off table is floored
    in place. With opts.devices > 1 the batches are corrected over a
    mesh of that many devices (a --devices N build hands off its
    row-sharded table): `mesh`, or by default the first opts.devices
    devices of opts.device's type, in the layout
    tile_sharded.ShardedCorrector picks; a file whose table takes the
    routed layout loads row-sharded onto the mesh (one HK7 launch a
    shard), any other onto the lead device. A row-sharded table
    corrected on one device is gathered onto the lead shard's device
    first. `event_driven=False` is a measurement hook that the JAX
    package's run_error_correct lacks: the plain walk
    (corrector.correct_batch), for chip_smoke.py's plain-mode stage 2
    beside the event mode on the same entry point. The CLIs never pass
    it and run event mode, as the JAX package's do.

    The run goes through cli/observability.observability() with the
    options' metrics, span and profile paths, the resource guards over
    the output and metrics filesystems and the stall watchdog: a failed
    run still lands its document, stamped status=error. Output files
    (not the driver's replay or merged records) are held to the disk
    preflight first. ENOSPC at the output streams raises
    ResourceExhausted (rc 4)."""
    from ..cli.observability import observability

    watch = [p for p in (opts.output and opts.output + ".fa", opts.metrics)
             if p]
    with observability(opts.metrics, opts.metrics_interval,
                       live=opts.metrics_force,
                       trace_spans=opts.trace_spans, profile=opts.profile,
                       watch_paths=watch,
                       stall_timeout_s=opts.stall_timeout_s,
                       stage="error_correct", batch_size=opts.batch_size,
                       no_discard=bool(no_discard)) as obs:
        if opts.output and records is None and prepacked is None:
            resources.preflight(opts.preflight,
                                resources.estimate_stage2_needs(
                                    opts.output + ".fa", sequences))
        try:
            return _run_ec(db_path, sequences, opts, obs.registry,
                           obs.tracer, qual_cutoff=qual_cutoff, skip=skip,
                           good=good, anchor_count=anchor_count,
                           min_count=min_count, window=window, error=error,
                           no_discard=no_discard, homo_trim=homo_trim,
                           trim_contaminant=trim_contaminant, db=db,
                           prepacked=prepacked, mesh=mesh,
                           event_driven=event_driven, records=records)
        except resources.ResourceExhausted:
            raise  # already laddered (the journal's guard, the preflight)
        except OSError as e:
            if resources.is_enospc(e):
                # a bare ENOSPC out of stage 2 is the .fa/.log stream
                # (reads cannot ENOSPC): required, fail fast
                raise resources.fail_required("output.stream", e) from e
            raise


def _run_ec(db_path: str, sequences: Sequence[str], opts: ECOptions, reg,
            tracer, *, qual_cutoff: int, skip: int, good: int,
            anchor_count: int, min_count: int, window: int, error: int,
            no_discard: bool, homo_trim: int | None, trim_contaminant: bool,
            db, prepacked, mesh, event_driven: bool, records) -> ECStats:
    from .. import resolve_device
    from ..parallel import tile_sharded as ts

    if opts.checkpoint_every > 0 and (not opts.output or opts.gzip):
        # before the DB load: a misconfigured flag fails fast
        raise RuntimeError(
            "--checkpoint-every requires -o PREFIX and is "
            "incompatible with --gzip (a gzip stream cannot be "
            "truncated back to a commit point)")
    device = resolve_device(opts.device)
    devices = opts.devices
    if devices > 1:
        if opts.batch_size % devices:
            raise RuntimeError(
                f"--batch-size {opts.batch_size} is not divisible by "
                f"--devices {devices}; round it up")
        if mesh is None:
            mesh = ts.make_mesh(devices, device=device)
    # the outcome surface lands (at zero) even when the load refuses
    precreate_outcome_counters(reg)
    with trace(opts.profile, device):
        stats = _correct(db_path, sequences, opts, reg, tracer, device, mesh,
                         qual_cutoff=qual_cutoff, skip=skip, good=good,
                         anchor_count=anchor_count, min_count=min_count,
                         window=window, error=error, no_discard=no_discard,
                         homo_trim=homo_trim,
                         trim_contaminant=trim_contaminant, db=db,
                         prepacked=prepacked, event_driven=event_driven,
                         records=records)
    if reg.enabled:
        reg.counter("reads_in").inc(stats.reads)
        reg.counter("reads_corrected").inc(stats.corrected)
        reg.counter("reads_skipped").inc(stats.skipped)
        reg.counter("bases_in").inc(stats.bases_in)
        reg.counter("bases_out").inc(stats.bases_out)
        reg.gauge("cutoff").set(stats.cutoff)
        reg.set_meta(status="ok")
        reg.write()
    return stats


def _correct(db_path: str, sequences: Sequence[str], opts: ECOptions, reg,
             tracer, device, mesh, *, qual_cutoff: int, skip: int,
             good: int, anchor_count: int, min_count: int, window: int,
             error: int, no_discard: bool, homo_trim: int | None,
             trim_contaminant: bool, db, prepacked, event_driven: bool,
             records) -> ECStats:
    """Load the table, then correct every batch (run_error_correct)."""
    from ..parallel import tile_sharded as ts

    devices = opts.devices
    vlog("Loading mer database")
    if db is not None:
        # the header fields the build wrote into the file
        state, meta, bstats = db
        table_stats = (bstats.distinct_hq, bstats.total_hq)
        header = bstats.db_extra_header() or {}
    else:
        rb = db_format.header_rb_log2(db_path)
        on_mesh = devices > 1 and rb is not None and ts.routed_layout(rb)
        state, meta, header, (_occ, distinct, total) = db_format.load_db(
            db_path, device=device, verify=opts.verify_db,
            mesh=mesh if on_mesh else None, no_mmap=opts.no_mmap)
        table_stats = (distinct, total)
    if devices == 1 and isinstance(state, ctable.ShardedTileState):
        state, meta = ts.gather_table(state, meta)
    cutoff = resolve_cutoff(opts, table_stats, header)
    vlog("Using cutoff of ", cutoff)
    if cutoff == 0 and opts.cutoff is None:
        raise RuntimeError(
            "Cutoff computation failed. Pass it explicitly with -p switch.")
    # presence floor: the flag, else the database's prefilter
    # declaration, else none. After the cutoff (a full-table statistic
    # either way) and before the first probe, so a prefiltered table and
    # the floored full table are the same corrector input.
    floor = opts.presence_floor
    if floor <= 0:
        floor = int((header.get("prefilter") or {}).get("min_obs", 1))
    if isinstance(state, ctable.ShardedTileState):
        state = ts.floor(state, meta, floor)
    else:
        state = ctable.tile_floor(state, meta, floor)
    if floor > 1:
        vlog("Applying presence floor of ", floor,
             " (count-below-floor mers treated as absent)")
    if reg.enabled:
        reg.set_meta(presence_floor=floor)
        # the header's coverage statistic feeds the quality scorecard's
        # coverage model (mean hq multiplicity predicts the anchor rate)
        ps = header.get("poisson_stats")
        if ps and ps.get("distinct_hq"):
            reg.set_meta(coverage_mean=round(
                float(ps["total_hq"]) / float(ps["distinct_hq"]), 4))
    cfg = ECConfig(k=meta.k, skip=skip, good=good,
                   anchor_count=anchor_count, min_count=min_count,
                   cutoff=cutoff, qual_cutoff=qual_cutoff, window=window,
                   error=error, homo_trim=homo_trim,
                   trim_contaminant=trim_contaminant, no_discard=no_discard,
                   collision_prob=opts.apriori_error_rate / 3.0,
                   poisson_threshold=opts.poisson_threshold)
    contam = None
    if opts.contaminant is not None:
        vlog("Loading contaminant sequences")
        contam = contaminant_mod.load_contaminant(opts.contaminant, cfg.k,
                                                  device)
    if devices > 1:
        correct = ts.ShardedCorrector(mesh, state, meta, cfg, contam,
                                      event_driven=event_driven)
        vlog("Correcting over ", devices, " devices, table ",
             correct.layout)
        reg.gauge("n_shards").set(devices)
        reg.set_meta(devices=devices, table_layout=correct.layout)
    else:
        mesh = [device]
        keep = make_keep_table(meta, cfg, device)

        def correct(pk):
            return correct_batch_packed(state, meta, pk, cfg, keep, contam,
                                        event_driven)
    n_render = resolve_render_workers(opts.render_workers)
    stats = ECStats(cutoff=cutoff, presence_floor=floor,
                    render_workers=n_render)
    journal = jctx = jstate = None
    skip_batches = 0
    if opts.checkpoint_every > 0:  # the flags were validated at entry
        journal = ckpt_mod.Stage2Journal(opts.output)
        # the resume identity: the same database, inputs and correction
        # config (JAX's repr of it, so either package resumes the
        # other's journal); anything else would splice two corrections
        jctx = {"db": db_path, "inputs": list(sequences),
                "config": jax_repr(cfg)}
        reg.counter("checkpoint_writes_total")  # lands even at 0
        reg.set_meta(checkpoint_every=opts.checkpoint_every)
        if opts.resume:
            jstate = journal.load()
        if jstate is not None:
            journal.check_config(jstate, opts.batch_size, jctx)
            skip_batches = int(jstate["batches"])
            for field in ("reads", "corrected", "skipped", "bases_in",
                          "bases_out"):
                setattr(stats, field, int(jstate[field]))
            reg.counter("resume_skipped_reads")  # lands even at 0
            reg.set_meta(resumed=True, resumed_from_batch=skip_batches)
            reg.event("resume", stage="error_correct", cursor=skip_batches)
            vlog("Resuming stage 2 from journal: ", skip_batches,
                 " batches (", stats.reads, " reads) already written")
    pipe_metrics = reg if reg.enabled else None
    policy = None
    if opts.on_bad_read != "abort":
        qpath = opts.output + ".quarantine.fastq" if opts.output else None
        if opts.on_bad_read == "quarantine" and qpath is None:
            raise RuntimeError(
                "--on-bad-read=quarantine requires -o PREFIX (the "
                "quarantine file lands beside the output)")
        policy = fastq.BadReadPolicy(opts.on_bad_read, qpath, pipe_metrics)
        reg.counter("bad_reads_total")  # lands even at 0
        reg.set_meta(on_bad_read=opts.on_bad_read)
    count_outcomes = reg.enabled
    if reg.enabled:
        reg.set_meta(render_workers=n_render)
        reg.histogram("render_ms")  # lands even for an empty input
        reg.histogram("reorder_wait_ms")
    timer = StageTimer()
    if journal is not None:
        out, log = journal.open_outputs(jstate)
    else:
        out = _open_out(opts.output, ".fa", sys.stdout, opts.gzip)
        log = _open_out(opts.output, ".log", sys.stderr, opts.gzip)
    writer = AsyncWriter([out, log], metrics=pipe_metrics)
    times: dict = {}
    vlog("Correcting reads")
    try:
        if prepacked is not None and records is None:
            # the driver's replay: parsed and packed already
            batches = prepacked
        else:
            src = (fastq.batch_records(records, opts.batch_size)
                   if records is not None else
                   fastq.read_batches(sequences, opts.batch_size,
                                      threads=opts.threads, policy=policy))
            batches = prefetch(((b, pack_for_stage2(b, cfg)) for b in src),
                               times=times, metrics=pipe_metrics,
                               tracer=tracer)

        def render(batch, buf, b, l, maxe):
            with tracer.span("render", reads=batch.n):
                return render_batch_host(batch, buf, b, l, maxe, cfg,
                                         count_outcomes)

        def sink(result):
            fa, lg, n_corr, n_skip, bases_out, outcome, render_s = result
            wait_s = pool.take_reorder_wait()
            stats.drain_wait_s += wait_s
            timer.add_time("drain", wait_s)
            stats.corrected += n_corr
            stats.skipped += n_skip
            stats.bases_out += bases_out
            stats.render_s += render_s
            if outcome is not None:
                record_outcome(reg, outcome)
            if reg.enabled:
                reg.histogram("render_ms").observe(round(render_s * 1e3, 3))
                reg.histogram("reorder_wait_ms").observe(
                    round(wait_s * 1e3, 3))
            writer.write(0, fa)
            writer.write(1, lg)

        pool = ReorderingPool(n_render, sink)
        it = iter(batches)
        step = 0
        try:
            while True:
                t0 = time.perf_counter()
                item = next(it, None)
                t1 = time.perf_counter()
                stats.queue_wait_s += t1 - t0
                if item is None:
                    break
                batch, pk = item
                if skip_batches > 0:
                    # committed before the kill (the stats came back
                    # from the journal): parsed, but neither corrected
                    # nor rendered
                    skip_batches -= 1
                    reg.counter("resume_skipped_reads").inc(batch.n)
                    step += 1
                    continue
                faults.inject("stage2.correct", batch=step)
                resources.watchdog_beat("stage2.correct", step)
                with tracer.span("stage2_batch", step=step, reads=batch.n):
                    with tracer.step("stage2_device", step, reads=batch.n):
                        res = correct(pk)
                        t_enq = time.perf_counter()
                        ts.synchronize(mesh)
                        t2 = time.perf_counter()
                    observe_dispatch_wait(reg, "device", t1, t_enq, t2,
                                          timer=timer)
                    with timer.stage("fetch"), tracer.span("fetch"):
                        buf = fetch_finish(res)
                    stats.fetch_s += time.perf_counter() - t2
                    stats.device_s += t2 - t1
                    b, maxe = res.fwd_log.pos.shape
                    l = res.out.shape[1]
                    del res
                    pool.submit(render, batch, buf, b, l, maxe)
                    stats.reads += batch.n
                    nb = int(batch.lengths[:batch.n].sum())
                    stats.bases_in += nb
                    timer.add_units("device_wait", nb)
                    reg.heartbeat(stage="error_correct", reads=stats.reads,
                                  bases=stats.bases_in)
                step += 1
                if journal is not None and step % opts.checkpoint_every == 0:
                    # the commit point: every byte of batches [0, step)
                    # is rendered in order, written and flushed before
                    # the journal names the offsets
                    tc = time.perf_counter()
                    with timer.stage("checkpoint"):
                        pool.flush()
                        writer.flush()
                        journal.commit(step, stats, out.tell(), log.tell(),
                                       opts.batch_size, jctx)
                    stats.commits += 1
                    stats.commit_s += time.perf_counter() - tc
                    reg.counter("checkpoint_writes_total").inc()
                    reg.event("checkpoint", stage="error_correct",
                              cursor=step)
            pool.flush()
        finally:
            stats.drain_wait_s += pool.take_reorder_wait()
            pool.shutdown()
            close = getattr(it, "close", None)
            if close is not None:
                close()  # stops and joins the producer
    finally:
        try:
            writer.close()
        finally:
            # every stream closes, even if another failed (a gzip
            # stream needs its trailer)
            try:
                _finish(out)
            finally:
                _finish(log)
                if policy is not None:
                    policy.close()
    if journal is not None:
        # success only: promote the partials over the outputs and drop
        # the journal (a failed run keeps both, ready for --resume)
        journal.finalize()
    stats.parse_pack_s = times.get("produce_s", 0.0)
    stats.host_s = stats.parse_pack_s + stats.render_s
    timer.report(stats.bases_in)
    reg.set_timer("stage2", timer.as_dict(stats.bases_in))
    vlog("Done. ", stats.corrected, " corrected, ", stats.skipped,
         " skipped of ", stats.reads, " reads")
    return stats


def _finish(f) -> None:
    if f is sys.stdout or f is sys.stderr:
        f.flush()
    else:
        f.close()
