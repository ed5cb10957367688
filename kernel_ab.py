#!/usr/bin/env python3
"""Time the kernels of two checkouts of the port on one card, on the
same table and batch: HK16 (K16's planes and pre-pass), HK1 (the
stage-1 insert), HK6's compact entry (K22) and HK4's entries.

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
- HK6's compact entry at cap = n beside boolean-mask indexing, HK4's
  event entry at B = 8192 and on the first quarter of the batch (HK5,
  HK16 and HK17 make its inputs), its sharded-table entry and HK4's
  plain entry at B = 8192.

Times are medians of the kernels' own C launches (CUDA events). Each
process prints one JSON line; the last line holds both trees' times,
this tree's over the other's, and whether every output digest agrees
across the four processes. Needs one card: exits non-zero without one,
or when an output differs.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 10
QUARTER = 4  # the short batch: the first 1/QUARTER of the reads
SHARDS = 4
PARTS = 4  # HK1's partition entry: pass 0 of PARTS


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


def time_tree(tree: str, db: str, npz: str, packed: str, fasta: str) -> dict:
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
    batch = np.load(npz)
    cb, qb, lb = batch["c"], batch["q"], batch["lengths"]
    state = ctable.TileState(rows)
    smeta = ts.RoutedTileMeta(k=meta.k, bits=meta.bits, rb_log2=meta.rb_log2,
                              n_shards=SHARDS)
    srows = list(ts.row_shards(state, smeta, [dev] * SHARDS).shards)
    res.update(planes_times(c, state, meta, srows, smeta, cb, qb, lb, fasta))
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

    if len(argv) == 6 and argv[0] == "--time":
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
                                "--time", tree, db, npz, packed, fasta],
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
    times = {}
    for key in runs[0]:
        if key.endswith("_ms"):
            o = [runs[0][key], runs[3][key]]
            t = [runs[1][key], runs[2][key]]
            times[key] = {"other": o, "this": t,
                          "this_over_other": round(sum(t) / sum(o), 4)}
    same = {key: len({r[key] for r in runs}) == 1
            for key in runs[0] if key.endswith("_digest")}
    print(card, flush=True)
    print(json.dumps({"ab": times, "order": ["other", "this", "this",
                                              "other"],
                      "outputs_equal": same}), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
