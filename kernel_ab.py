#!/usr/bin/env python3
"""Time the kernels of two checkouts of the port on one card, on the
same table and batch: HK2 (the stage-1 seal), HK6's export (K8) and its
compact entry (K22), HK5 (the stage-2 head), HK14 (the packed result),
HK16 (K16's planes and pre-pass), HK1 (the stage-1 insert) and HK4's
entries.

    python3 kernel_ab.py OTHER_TREE     # from the root of a checkout

OTHER_TREE is another checkout of this repository, for example the
parent commit unpacked into a gitignored directory:

    mkdir -p .archive/parent && git archive HEAD~ | tar -x -C .archive/parent
    python3 kernel_ab.py .archive/parent

The script runs chip_smoke.py's `full` phase with this checkout (the
quorum driver on the seeded E. coli-size FASTQ), packs that run's
batches and writes the contaminant phase's FASTA (the adapters and a
5,000 bp genome segment), then starts one process a tree in the order
other, this, this, other. Each process builds its own tree's kernels,
loads the full run's database (HK7) and times, on the first 8192 reads
of the FASTQ:

- HK16 at B = 8192 and on the first quarter of the batch (its classify
  and pre-pass C launches apart), its sharded-table entry (the table as
  four row ranges) and its two contaminant modes at B = 8192 (the
  contaminant set built by the tree's own stage 1; HK5 makes the
  inputs), the planes digested (the ambiguous list's order follows the
  atomics);
- HK1's reads entry on batch 150 into a copy of a build table at the
  full geometry that holds every other batch (built by the tree's own
  HK1, as chip_smoke.py's loaded phase does), its partition entry (pass
  0 of 4, a 2^20-row pass table holding the other batches' pass-0 mers)
  and its shard entry (batch 150's lanes routed to shard 0 of a 4-shard
  build table holding the other batches), each digested as the map it
  holds: the sealed table's v5 payload and statistics (the slot a new key
  takes depends on which CAS wins);
- HK2 on the table the quorum driver seals (every packed batch
  inserted by the tree's own HK1 at the full geometry, copied before
  each timed seal), digested as the map it holds (its sealed rows'
  payload by the plain export, and the five statistics: which slot a
  new key takes depends on which CAS wins), and on a seeded dense table
  at that geometry (60-64 occupied slots a row: chip_smoke.py's
  seal_planes), its rows and statistics digested;
- HK6's export on the HK7-loaded table and on the handoff table (that
  table sealed by the tree's HK2), with the seal's count where the
  tree's wrapper takes one, else as it runs, and here also without it:
  each C launch, the wrapper's span and the profiler duration, the
  payload digested;
- HK6's compact entry at cap = n beside boolean-mask indexing, HK4's
  event entry at B = 8192 and on the first quarter of the batch (HK5,
  HK16 and HK17 make its inputs), its sharded-table entry and HK4's
  plain entry at B = 8192;
- HK5 at B = 8192 and on the first quarter of the batch, on that
  table and on the table the quorum driver hands to stage 2 (every
  batch inserted by the tree's own HK1 and sealed by its HK2: keys at or
  after their preferred slot, where HK7 packs each row from slot 0), its
  sharded-table entry and its two contaminant modes at B = 8192, every
  output digested (codes, hqb, lengths, found, start_off, f, r, prev,
  status); HK14 on HK4's event-entry output for the batch at the main
  path's capacity (16384 entries) and at half the batch's entries (the
  overflow), and on that output repeated LARGE_REPEAT times (B = 2^18,
  a large --batch-size) at LARGE_REPEAT times the capacity, each C
  launcher apart, the buffer and merged status digested.

Times are medians of the kernels' own C launches (CUDA events), each
call behind chip_smoke.py's lead spin (`lead`); HK2's, HK6's export's,
HK5's and HK14's are also given as the kernels' own durations from
torch.profiler (CUPTI: `_prof_ms`, the mean a call). Beside them, the floor a launch can
reach: an empty kernel built here and launched through ctypes as the
port's launchers are (`empty_*`), and the stage 2 of the full run's
first PATH_BATCHES batches in a plain loop and through the stage-2
CLI's own loop (`path_loop_*`, `path_cli_*`: HK5's and HK14's event
spans on the path, as chip_smoke.py's path means take them, against
their profiler durations there). Each process
prints one JSON line; the last line holds both trees' times, this
tree's over the other's, and whether every output digest agrees across
the four processes. Needs one card: exits non-zero without one, or
when an output differs.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 10
QUARTER = 4  # the short batch: the first 1/QUARTER of the reads
SHARDS = 4
PARTS = 4  # HK1's partition entry: pass 0 of PARTS
PATH_BATCHES = 16  # the stage 2 whose path spans are split
LARGE_REPEAT = 32  # HK14's large batch: the batch's lanes this many times
# the kernels' names as the profiler reports them (HK14's two kernels
# are pack_head/pack_entries in the parent, pack_sums/pack here)
PROFILED = {"stage2_head": r"\bhead_kernel\b",
            "pack_finish": r"\bpack_(head_|entries_|sums_)?kernel\b",
            "tile_seal": r"\bseal_kernel\b",
            # the parent's two passes and its row scan; this tree's
            # export and, without the count, its count launch
            "tile_export": r"\b(export|scan)_\w*kernel\b"}
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def _smoke():
    """This checkout's chip_smoke.py, whatever quorum_tpu_torch is first
    on sys.path (its functions import the package when they run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if isinstance(t, (tuple, list)):
            h.update(_digest(t).encode())
        else:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def prof_ms(fn, reps: int, match: str) -> float | None:
    """The mean device time a call of fn() spends in the kernels whose
    profiler name `match` (a regular expression) finds (torch.profiler's
    CUPTI kernel records), over reps calls; None where the profiler saw
    no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and re.search(match, e.name)]
    return round(sum(us) / reps / 1e3, 5) if us else None


def timed(c, res: dict, key: str, fn, counter: str, setup=None,
          span: bool = False) -> None:
    """fn()'s C launches timed two ways into res (see the module
    docstring): behind the lead spin (each C launcher apart too, and
    with `span` the whole wrapper call) and by the profiler."""
    parts: dict = {}
    res[f"{key}_ms"] = c.kernel_ms(fn, counter, REPS, setup, detail=parts)
    for launcher, t in parts.items():
        if launcher != "span" or span:
            res[f"{key}_{launcher}_ms"] = t
    res[f"{key}_prof_ms"] = prof_ms(fn, REPS,
                                    PROFILED[counter.replace("_shard", "")])


def handoff_build(meta, packed: str):
    """The full run's build table as the quorum driver seals it: every
    packed batch inserted by the tree's own HK1 at the full geometry
    (keys at or after their preferred slot, where HK7's load packs each
    row from slot 0; which slot a new key takes depends on which CAS
    wins, so the layout differs from run to run, not the content)."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.ops import ctable

    dev = torch.device("cuda")
    batches, qt = _packed_batches(packed, dev)
    build = ctable.make_tile_build(meta, dev)
    for p, wire in batches:
        full, _left = kernels.tile_insert_reads(build, meta, wire, p.n_reads,
                                                p.length, p.thresholds, qt)
        if full:
            raise RuntimeError("the handoff table is full")
    return build


def seal_export_times(c, rows, meta, n: int, packed: str) -> tuple:
    """HK2's and HK6's export's times and output digests (see the module
    docstring). Returns (res, the handoff table's sealed rows)."""
    import inspect

    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable

    res = {}
    # HK2 on the handoff build table, a fresh copy before each seal, and
    # on a seeded dense table at the same geometry
    base = handoff_build(meta, packed)
    work = ctable.TBuildState(*(t.clone() for t in base))

    def reset():
        for dst, src in zip(work, base):
            dst.copy_(src)

    timed(c, res, "seal_handoff", lambda: kernels.tile_seal(work, meta),
          "tile_seal", reset)
    hrows, hstats = kernels.tile_seal(base, meta)
    # its layout differs from run to run: digested as the map it holds
    res["seal_handoff_digest"] = _digest([ref.tile_export(hrows, meta),
                                          hstats])
    del base, work
    torch.cuda.empty_cache()
    dense = c.seal_planes(meta, 0.97, None, c.SEED + 3000)
    timed(c, res, "seal_dense", lambda: kernels.tile_seal(dense, meta),
          "tile_seal")
    drows, dstats = kernels.tile_seal(dense, meta)
    res["seal_dense_digest"] = _digest([drows, dstats])
    del dense, drows
    torch.cuda.empty_cache()
    # HK6's export with the seal's count where the tree's wrapper takes
    # it, on the HK7-loaded and the handoff table; without it too here
    with_n = "n" in inspect.signature(kernels.tile_export).parameters
    for key, r in (("export_loaded", rows), ("export_handoff", hrows)):
        def fn(r=r):
            return (kernels.tile_export(r, meta, n) if with_n
                    else kernels.tile_export(r, meta))
        timed(c, res, key, fn, "tile_export", span=True)
        res[f"{key}_digest"] = _digest([fn()])
    if with_n:
        timed(c, res, "export_loaded_no_n",
              lambda: kernels.tile_export(rows, meta), "tile_export",
              span=True)
    return res, hrows


def head_pack_times(c, state, meta, srows, smeta, cb, qb, lb, fasta,
                    hrows) -> dict:
    """HK5's and HK14's times and output digests (see the module
    docstring)."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import packing
    from quorum_tpu_torch.models import corrector

    dev = state.rows.device
    cset = c.load_contaminant(fasta)
    ctab = (cset[0].rows, cset[1])
    res = {}
    b = cb.shape[0]
    cfg = corrector.ECConfig(k=meta.k, cutoff=4, qual_cutoff=33 + 40)
    for n in (b, b // QUARTER):
        pk = packing.pack_reads(cb[:n], qb[:n], lb[:n],
                                thresholds=(cfg.qual_cutoff,))
        tail = (torch.from_numpy(pk.to_wire()).to(dev), n, pk.length,
                pk.thresholds, cfg.qual_cutoff)
        kw = dict(skip=cfg.skip, good=cfg.good,
                  anchor_count=cfg.anchor_count)
        cases = {f"head_b{n}": (state.rows, meta, {}, "stage2_head"),
                 f"head_handoff_b{n}": (hrows, meta, {}, "stage2_head")}
        if n == b:
            cases.update({
                f"head_shard_b{n}": (srows, smeta, {}, "stage2_head_shard"),
                f"head_contaminant_b{n}": (state.rows, meta,
                                           dict(contam=ctab), "stage2_head"),
                f"head_trim_b{n}": (state.rows, meta,
                                    dict(contam=ctab, trim_contaminant=True),
                                    "stage2_head")})
        for key, (rows, m, extra, counter) in cases.items():
            def fn(rows=rows, m=m, extra=extra):
                return kernels.stage2_head(rows, m, *tail, **kw, **extra)
            timed(c, res, key, fn, counter)
            out = fn()
            res[f"{key}_digest"] = _digest(list(out[:3]) + list(out[3]))
    # HK14 on HK4's event-entry output for the batch
    w = c.walk_inputs(state, meta, cb, qb, lb)
    _out, start, end, lstatus, fwd, bwd, overflow = kernels.extend_reads(
        *w.args, **w.kw, planes=w.sk)
    args = (start, end, lstatus[:b], lstatus[b:], (fwd[0], fwd[2], fwd[3]),
            (bwd[0], bwd[2], bwd[3]), overflow)
    total = int((fwd[0].sum() + bwd[0].sum()).item())
    res["pack_batch_entries"] = total

    def repeat(t):  # the lanes LARGE_REPEAT times (the flag once)
        if isinstance(t, tuple):
            return tuple(repeat(x) for x in t)
        return t.repeat(LARGE_REPEAT, *[1] * (t.dim() - 1))
    large = repeat(args[:-1]) + (overflow,)
    for key, a, cap in (("pack_cap16384", args, 16384),
                        ("pack_overflow", args, total // 2),
                        (f"pack_b{b * LARGE_REPEAT}", large,
                         16384 * LARGE_REPEAT)):
        def fn(a=a, cap=cap):
            return kernels.pack_finish(*a, length=cb.shape[1], cap=cap)
        timed(c, res, key, fn, "pack_finish")
        res[f"{key}_digest"] = _digest(fn())
    return res


def empty_floor(c) -> dict:
    """An empty kernel's launch, built here with the port's nvcc flags and
    called through ctypes as the port's launchers are: its event time
    behind the lead spin and its profiler duration (the floor a launch's
    reading can reach)."""
    import ctypes

    import torch

    from quorum_tpu_torch.kernels import loader

    d = os.path.join(c.WORK, "empty")
    os.makedirs(d, exist_ok=True)
    cu, so = os.path.join(d, "empty.cu"), os.path.join(d, "libempty.so")
    with open(cu, "w") as f:
        f.write(EMPTY_CU)
    subprocess.run([loader.nvcc_path(), *loader.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int

    def fn():
        stream = torch.cuda.current_stream()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        rc = lib.empty_launch(stream.cuda_stream)
        b.record(stream)
        if rc:
            raise RuntimeError(f"empty kernel: CUDA error {rc}")
        return a, b

    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        c.lead()
        a, b = fn()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return {"empty_ms": sorted(times)[len(times) // 2],
            "empty_prof_ms": prof_ms(fn, REPS, r"\bempty_kernel\b")}


def _kernel_prof(fn) -> dict:
    """The device durations (us) of PROFILED's kernels over one call of
    fn(), by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {name: [e.time_range.elapsed_us() for e in kernels
                   if re.search(match, e.name)]
            for name, match in PROFILED.items()}


def path_split(state, meta, path_npz: str, db: str, fastq: str) -> dict:
    """The full run's first PATH_BATCHES batches through stage 2 as the
    main path runs them, twice: in a plain loop (the packed wire's copy,
    HK5, HK16, HK17, HK4's event entry, HK14, the buffer's copy to the
    host; nothing else running) and through the stage-2 CLI's own loop
    (error_correct.run_error_correct on their FASTQ and the full run's
    database: the parse, the finish and the render worker beside the
    kernels). Each once with the loader's event spans on (the path means'
    reading) and once under the profiler: HK5's and HK14's mean span a
    call against their kernels' mean device time a call."""
    import numpy as np
    import torch

    from quorum_tpu_torch.io import packing
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.models import corrector
    from quorum_tpu_torch.models import error_correct as ec

    z = np.load(path_npz)
    cfg = corrector.ECConfig(k=meta.k, cutoff=4, qual_cutoff=33 + 40)
    keep = corrector.make_keep_table(meta, cfg, state.rows.device)
    pks = [packing.pack_reads(z["c"][j], z["q"][j], z["lengths"][j],
                              thresholds=(cfg.qual_cutoff,))
           for j in range(z["c"].shape[0])]

    def loop():
        for pk in pks:
            corrector.fetch_finish(corrector.correct_batch_packed(
                state, meta, pk, cfg, keep))
        torch.cuda.synchronize()

    opts = ec.ECOptions(output=os.path.splitext(fastq)[0] + "_out",
                        device="cuda")

    def cli():
        ec.run_error_correct(db, [fastq], opts)
        torch.cuda.synchronize()

    loop()  # warm: the capacity kept for the shape settles
    res = {}
    for label, run in (("loop", loop), ("cli", cli)):
        STATS.reset()
        STATS.timing = True
        try:
            run()
        finally:
            STATS.timing = False
        kms = STATS.kernel_ms()
        calls = dict(STATS.launches)
        for name, us in _kernel_prof(run).items():  # HK14 was two kernels
            if not calls[name]:  # HK2, HK6: stage 1's
                continue
            res[f"path_{label}_{name}_span_ms"] = round(
                kms[name] / calls[name], 5)
            res[f"path_{label}_{name}_prof_ms"] = round(
                sum(us) / calls[name] / 1e3, 5) if us else None
    return res


def time_tree(tree: str, db: str, npz: str, packed: str, fasta: str,
              path_npz: str, path_fq: str) -> dict:
    """One tree's times and output digests (see the module docstring)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import quorum_tpu_torch
    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.kernels import loader
    from quorum_tpu_torch.ops import ctable
    from quorum_tpu_torch.parallel import tile_sharded as ts

    pkg = os.path.dirname(os.path.abspath(quorum_tpu_torch.__file__))
    if pkg != os.path.join(tree, "quorum_tpu_torch"):
        raise RuntimeError(f"imported {pkg}, not {tree}'s package")
    c = _smoke()
    loader.build_all()
    dev = torch.device("cuda")
    h = db_format.read_header(db)
    meta = ctable.TileMeta(h["key_len"] // 2, h["bits"], h["rb_log2"])
    n = h["n_entries"]
    payload = torch.from_numpy(np.frombuffer(db_format.db_payload_bytes(db),
                                             np.uint8).copy()).to(dev)
    rows, _stats = kernels.tile_load(payload, meta, n)
    del payload
    # the compact entry is counted apart where the tree does so
    compact = ("tile_export_compact" if "tile_export_compact"
               in loader.COUNTERS else "tile_export")
    res = {"tree": tree, "card": c.card_line(), "entries": n}
    res["compact_ms"] = c.kernel_ms(lambda: kernels.tile_compact(rows, meta,
                                                                 n),
                                    compact, REPS)
    slots = rows.view(-1, 2)
    occupied = (slots[:, 0] & meta.max_val) != 0
    res["compact_library_ms"] = c.event_ms(lambda: slots[occupied], REPS)
    del slots, occupied
    res["compact_digest"] = _digest(kernels.tile_compact(rows, meta, n))
    sx, hrows = seal_export_times(c, rows, meta, n, packed)
    res.update(sx)
    batch = np.load(npz)
    cb, qb, lb = batch["c"], batch["q"], batch["lengths"]
    state = ctable.TileState(rows)
    smeta = ts.RoutedTileMeta(k=meta.k, bits=meta.bits, rb_log2=meta.rb_log2,
                              n_shards=SHARDS)
    srows = list(ts.row_shards(state, smeta, [dev] * SHARDS).shards)
    res.update(planes_times(c, state, meta, srows, smeta, cb, qb, lb, fasta))
    res.update(head_pack_times(c, state, meta, srows, smeta, cb, qb, lb,
                               fasta, hrows))
    del hrows
    res.update(path_split(state, meta, path_npz, db, path_fq))
    for b in (cb.shape[0], cb.shape[0] // QUARTER):
        w = c.walk_inputs(state, meta, cb[:b], qb[:b], lb[:b])
        runs = {f"event_b{b}": (lambda: kernels.extend_reads(
            *w.args, **w.kw, planes=w.sk), "extend_reads_event")}
        if b == cb.shape[0]:
            sargs = (srows, smeta) + w.args[2:]
            runs[f"event_shard_b{b}"] = (lambda: kernels.extend_reads(
                *sargs, **w.kw, planes=w.sk), "extend_reads_event_shard")
            runs[f"plain_b{b}"] = (lambda: kernels.extend_reads(
                *w.args, **w.kw), "extend_reads")
        for key, (fn, name) in runs.items():
            res[f"{key}_ms"] = c.kernel_ms(fn, name, REPS)
            res[f"{key}_digest"] = _digest(fn())
    del rows, state, srows, w
    torch.cuda.empty_cache()
    res.update(insert_times(c, h["rb_log2"], packed))
    return res


def planes_times(c, state, meta, srows, smeta, cb, qb, lb, fasta) -> dict:
    """HK16's times and plane digests (see the module docstring)."""
    from quorum_tpu_torch import kernels

    res = {}
    cset = c.load_contaminant(fasta)
    ctab = (cset[0].rows, cset[1])
    b = cb.shape[0]
    cases = [(f"planes_b{b}", b, None, False, True),
             (f"planes_b{b // QUARTER}", b // QUARTER, None, False, False),
             (f"planes_contaminant_b{b}", b, ctab, False, False),
             (f"planes_trim_b{b}", b, ctab, True, False)]
    for key, n, mtab, trim, shard in cases:
        w = c.walk_inputs(state, meta, cb[:n], qb[:n], lb[:n], mtab, trim)
        runs = {key: (state.rows, meta, "event_planes")}
        if shard:
            runs[key.replace("planes", "planes_shard")] = (
                srows, smeta, "event_planes_shard")
        for name, (rows, m, counter) in runs.items():
            def fn():
                return kernels.event_planes(rows, m, *w.pargs, **w.pkw)
            parts: dict = {}
            res[f"{name}_ms"] = c.kernel_ms(fn, counter, REPS, detail=parts)
            for launcher, t in parts.items():
                if launcher != "span":
                    res[f"{name}_{launcher.split('_')[1]}_ms"] = t
            res[f"{name}_digest"] = _digest(fn())
    return res


def _packed_batches(packed: str, dev):
    """The full run's batches as (PackedReads, wire on the card)."""
    import numpy as np
    import torch

    from quorum_tpu_torch.io import packing

    z = np.load(packed)
    qt, batch, length = (int(z[x]) for x in ("qt", "batch", "length"))
    out = []
    for a in range(0, z["lengths"].shape[0], batch):
        pk = packing.PackedReads(pcodes=z["pcodes"][a:a + batch],
                                 nmask=z["nmask"][a:a + batch],
                                 hq={qt: z["hq"][a:a + batch]},
                                 lengths=z["lengths"][a:a + batch],
                                 length=length)
        out.append((pk, torch.from_numpy(pk.to_wire()).to(dev)))
    return out, qt


def insert_times(c, rb: int, packed: str) -> dict:
    """HK1's times and table digests (see the module docstring)."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import packing
    from quorum_tpu_torch.ops import ctable
    from quorum_tpu_torch.parallel import tile_sharded as ts

    dev = torch.device("cuda")
    batches, qt = _packed_batches(packed, dev)
    timed = len(batches) - 2
    pk, wire = batches[timed]
    wargs = (wire, pk.n_reads, pk.length, pk.thresholds, qt)
    res = {}

    def timed_copy(key, base, meta, fn, counter, seal_meta=None,
                   export_meta=None):
        work = ctable.TBuildState(*(t.clone() for t in base))

        def reset():
            for dst, src in zip(work, base):
                dst.copy_(src)

        res[f"{key}_ms"] = c.kernel_ms(lambda: fn(work), counter, REPS, reset)
        reset()
        fn(work)
        rows, stats = kernels.tile_seal(work, seal_meta or meta)
        res[f"{key}_digest"] = _digest(
            [kernels.tile_export(rows, export_meta or meta), stats])
        del work, rows

    # the reads entry: batch `timed` into the loaded table at the full
    # geometry; the partition entry: pass 0 of PARTS at 2^(rb - 2) rows
    g = PARTS.bit_length() - 1
    for key, m, part, n_parts in (
            ("insert", ctable.TileMeta(c.K, 7, rb), 0, 1),
            ("insert_partition", ctable.TileMeta(c.K, 7, rb - g), 0, PARTS)):
        loaded = ctable.make_tile_build(m, dev)
        for i, (p, wr) in enumerate(batches):
            if i != timed:
                full, _left = kernels.tile_insert_reads(
                    loaded, m, wr, p.n_reads, p.length, p.thresholds, qt,
                    part, n_parts)
                if full:
                    raise RuntimeError(f"{key}: the loaded table is full")
        timed_copy(key, loaded, m, lambda st, m=m, part=part, n=n_parts:
                   kernels.tile_insert_reads(st, m, *wargs, part, n),
                   "tile_insert")
        del loaded
        torch.cuda.empty_cache()
    # the shard entry: batch `timed`'s lanes for shard 0 of the 4-shard
    # table at the full geometry that holds every other batch
    smeta = ts.TileShardedMeta(k=c.K, bits=7, rb_log2=rb, n_shards=SHARDS)
    mesh = [dev] * SHARDS
    loaded = ts.make_build_state(smeta, mesh)
    for i, (p, _wr) in enumerate(batches):
        if i != timed:
            loaded, _m, grows = ts.build_step_wire(loaded, smeta, mesh, p, qt)
            if grows:
                raise RuntimeError("shard entry: the loaded table grew")
    subs = packing.split_rows(pk, SHARDS)
    sent = kernels.shard_route(
        [(torch.from_numpy(sb.to_wire()).to(dev), sb.n_reads, sb.length,
          sb.thresholds) for sb in subs], qt, smeta)
    lanes = ts._exchange(sent, mesh)[0]
    timed_copy("insert_shard", loaded.shards[0], smeta,
               lambda st: kernels.tile_insert_shard(st, smeta, lanes),
               "tile_insert_shard", seal_meta=smeta.local_meta)
    return res


def main(argv) -> int:
    import numpy as np
    import torch

    if len(argv) == 8 and argv[0] == "--time":
        print(json.dumps(time_tree(*argv[1:])), flush=True)
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    if not os.path.isdir(os.path.join(other, "quorum_tpu_torch")):
        print(f"kernel_ab: {other} holds no quorum_tpu_torch",
              file=sys.stderr)
        return 2
    c = _smoke()
    card = c.card_line()
    os.makedirs(c.WORK, exist_ok=True)
    try:
        c.phase_build()
        full = c.phase_full(card)
        cb, qb, lb, _pk = c.pack_batch(full["codes"][:c.BATCH],
                                       full["quals"][:c.BATCH], c.QT)
        npz = os.path.join(c.WORK, "ab_batch.npz")
        np.savez(npz, c=cb, q=qb, lengths=lb)
        # the stage 2 whose path spans are split: the first batches
        path = [c.pack_batch(full["codes"][a:a + c.BATCH],
                             full["quals"][a:a + c.BATCH], c.QT)[:3]
                for a in range(0, PATH_BATCHES * c.BATCH, c.BATCH)]
        path_npz = os.path.join(c.WORK, "ab_path.npz")
        np.savez(path_npz, **{x: np.stack([p[j] for p in path])
                              for j, x in enumerate(("c", "q", "lengths"))})
        del path
        path_fq = os.path.join(c.WORK, "ab_path.fastq")
        c.write_fastq(path_fq, full["codes"][:PATH_BATCHES * c.BATCH],
                      full["quals"][:PATH_BATCHES * c.BATCH])
        floor = empty_floor(c)
        # the full run's batches, packed (HK1's loaded tables), and the
        # contaminant phase's FASTA (HK16's contaminant modes)
        pks = [c.pack_batch(full["codes"][a:a + c.BATCH],
                            full["quals"][a:a + c.BATCH], c.QT)[3]
               for a in range(0, full["codes"].shape[0], c.BATCH)]
        packed = os.path.join(c.WORK, "ab_packed.npz")
        np.savez(packed, pcodes=np.concatenate([p.pcodes for p in pks]),
                 nmask=np.concatenate([p.nmask for p in pks]),
                 hq=np.concatenate([p.hq[c.QT] for p in pks]),
                 lengths=np.concatenate([p.lengths for p in pks]),
                 qt=c.QT, batch=c.BATCH, length=pks[0].length)
        del pks
        fasta = os.path.join(c.WORK, "ab_contaminant.fa")
        c.write_contaminant(fasta, full["genome"][c.SEGMENT[0]:
                                                  c.SEGMENT[1]])
        db = full["db"]
        del full
        torch.cuda.empty_cache()
        runs = []
        for tree in (other, HERE, HERE, other):
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--time", tree, db, npz, packed, fasta,
                                path_npz, path_fq],
                               capture_output=True, text=True, timeout=1200)
            sys.stderr.write(p.stderr[-4000:])
            if p.returncode != 0:
                print(f"kernel_ab: the {tree} process exited "
                      f"{p.returncode}", file=sys.stderr)
                return 1
            line = p.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    finally:
        shutil.rmtree(c.WORK, ignore_errors=True)
    # a C launcher only one tree has (HK14's two launches in the parent,
    # one here) is reported for that tree alone
    times = {}
    for key in dict.fromkeys(k for r in runs for k in r):
        if key.endswith("_ms"):
            o = [runs[j].get(key) for j in (0, 3)]
            t = [runs[j].get(key) for j in (1, 2)]
            both = None not in o + t
            times[key] = {"other": o, "this": t, "this_over_other": (
                round(sum(t) / sum(o), 4) if both and sum(o) else None)}
    same = {key: len({r.get(key) for r in runs}) == 1
            for key in runs[0] if key.endswith("_digest")}
    print(card, flush=True)
    print(json.dumps({"ab": times, "floor": floor,
                      "order": ["other", "this", "this", "other"],
                      "outputs_equal": same}), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
