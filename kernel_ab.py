#!/usr/bin/env python3
"""Time the kernels of two checkouts of the port on one card, on the
same table and batch: HK6's compact entry (K22) and HK4's entries.

    python3 kernel_ab.py OTHER_TREE     # from the root of a checkout

OTHER_TREE is another checkout of this repository, for example the
parent commit unpacked into a gitignored directory:

    mkdir -p .archive/parent && git archive HEAD~ | tar -x -C .archive/parent
    python3 kernel_ab.py .archive/parent

The script runs chip_smoke.py's `full` phase with this checkout (the
quorum driver on the seeded E. coli-size FASTQ), then starts one process
a tree in the order other, this, this, other. Each process builds its
own tree's kernels, loads the full run's database (HK7) and times, on
the first 8192 reads of the FASTQ: HK6's compact entry at cap = n beside
boolean-mask indexing, HK4's event entry at B = 8192 and on the first
quarter of the batch (HK5, HK16 and HK17 make its inputs), its
sharded-table entry (the table as four row ranges) and HK4's plain entry
at B = 8192. Times are medians of the kernels' own C launches (CUDA
events). Each process prints one JSON line; the last line holds both
trees' times, this tree's over the other's, and whether every output
digest agrees across the four processes. Needs one card: exits non-zero
without one, or when an output differs.
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


def time_tree(tree: str, db: str, npz: str) -> dict:
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
    return res


def main(argv) -> int:
    import numpy as np
    import torch

    if len(argv) == 4 and argv[0] == "--time":
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
        db = full["db"]
        del full
        torch.cuda.empty_cache()
        runs = []
        for tree in (other, HERE, HERE, other):
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--time", tree, db, npz],
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
