#!/usr/bin/env python3
"""Time the host code of two checkouts of the port on one machine, on
the same inputs: the stage-2 batch build of parsed records
(fastq.batch_records: what the Python parser and the driver's paired
mode feed stage 2), the decode of a reference-format database
(quorum_db.read_ref_db) and the table built from its entries
(ctable.tile_from_entries, HK7 placing the payload).

    python3 host_ab.py OTHER_TREE     # from the root of a checkout
    python3 host_ab.py OTHER_TREE --device cpu --records 20000 \\
        --entries 200000              # a small trial without a card

OTHER_TREE is another checkout of this repository, for example the
parent commit unpacked into a gitignored directory:

    mkdir -p .archive/parent && git archive HEAD~ | tar -x -C .archive/parent
    python3 host_ab.py .archive/parent

The inputs are made once, by this checkout: RECORDS seeded 150-base
FASTQ records (as many as chip_smoke.py's full and paired runs read)
and a binary/quorum_db file of ENTRIES distinct seeded mers at k = 24,
bits = 7 (as many as the full run's table holds), written by this
checkout's write_ref_db (the mers' making and the write timed apart).
Then one process a tree, in the order other, this, this, other, times
each step once (wall seconds; the file is warm in the page cache,
written just before) after an untimed warm-up that builds HK7, and
digests each output. Each process prints one JSON line;
then come the card's name and power limit, and a last line with both
trees' times, this tree's over the other's, and whether every digest
agrees across the four processes (exit 1 when one differs).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".host_ab_work")
SEED = 15
READ_LEN = 150
BATCH = 8192  # stage 2's default --batch-size
RECORDS = 1_237_774  # chip_smoke.py's full run: 618,887 pairs in `paired`
ENTRIES = 36_991_395  # the full run's distinct mers
K, BITS = 24, 7


def records(n: int):
    """n seeded FASTQ records as the parsers yield them: (header, seq,
    qual), mates of pairs, ~10% of the bases of low quality."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                          (n, READ_LEN))]
    quals = np.where(rng.random((n, READ_LEN)) < 0.1, 35, 73).astype(np.uint8)
    return [(f"r{i // 2}/{i % 2 + 1}", seqs[i].tobytes(), quals[i].tobytes())
            for i in range(n)]


def make_entries(n: int):
    """(khi, klo, vals) of n distinct seeded mers at (K, BITS), counts
    1-127 with either quality bit, in a seeded order."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    keys = np.unique(rng.integers(0, 1 << (2 * K), n + n // 500 + 16,
                                  dtype=np.int64))
    keys = rng.permutation(keys)[:n]
    vals = ((rng.integers(1, 1 << BITS, n) << 1)
            | rng.integers(0, 2, n)).astype(np.uint32)
    return ((keys >> 32).astype(np.uint32),
            (keys & 0xFFFFFFFF).astype(np.uint32), vals)


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()[:16]


def time_tree(tree: str, path: str, n_records: int, device: str) -> dict:
    """Each step of `tree`'s port timed once on the inputs, and its
    output digested."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from quorum_tpu_torch.io import fastq, quorum_db
    from quorum_tpu_torch.ops import ctable

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    res = {"tree": tree}
    recs = records(n_records)
    t = time.perf_counter()
    batches = list(fastq.batch_records(iter(recs), BATCH))
    res["batch_records_s"] = time.perf_counter() - t
    del recs
    res["batch_records_digest"] = _digest(
        [x for b in batches for x in (b.codes, b.quals, b.lengths,
                                      "\n".join(b.headers).encode())])
    del batches
    t = time.perf_counter()
    khi, klo, vals, k, bits = quorum_db.read_ref_db(path)
    res["read_ref_db_s"] = time.perf_counter() - t
    res["read_ref_db_digest"] = _digest([np.ascontiguousarray(x)
                                         for x in (khi, klo, vals)])
    # HK7 built and loaded before the timed call
    ctable.tile_from_entries(khi[:64], klo[:64], vals[:64], k, bits, device)
    sync()
    t = time.perf_counter()
    state, meta, stats = ctable.tile_from_entries(khi, klo, vals, k, bits,
                                                  device)
    sync()
    res["tile_from_entries_s"] = time.perf_counter() - t
    res["tile_from_entries_digest"] = _digest(
        [state.rows.cpu().numpy(), np.asarray([meta.rb_log2, *stats])])
    return res


def main(argv) -> int:
    if argv[:1] == ["--time"]:
        tree, path, n, device = argv[1:]
        print(json.dumps(time_tree(tree, path, int(n), device)), flush=True)
        return 0
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other", help="another checkout of this repository")
    p.add_argument("--device", default="cuda")
    p.add_argument("--records", type=int, default=RECORDS)
    p.add_argument("--entries", type=int, default=ENTRIES)
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("host_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    if not os.path.isdir(os.path.join(other, "quorum_tpu_torch")):
        print(f"host_ab: {other} holds no quorum_tpu_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.makedirs(WORK, exist_ok=True)
    try:
        from quorum_tpu_torch.io import quorum_db

        path = os.path.join(WORK, "entries.jf")
        t = time.perf_counter()
        entries = make_entries(args.entries)
        made = time.perf_counter() - t
        t = time.perf_counter()
        quorum_db.write_ref_db(path, *entries, K, BITS,
                               cmdline=["host_ab.py"])
        print(json.dumps({"make_entries_s": made,
                          "write_ref_db_s": time.perf_counter() - t,
                          "file_bytes": os.path.getsize(path)}), flush=True)
        del entries
        runs = []
        for tree in (other, HERE, HERE, other):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--time", tree, path, str(args.records),
                                args.device],
                               capture_output=True, text=True, timeout=1800)
            sys.stderr.write(r.stderr[-4000:])
            if r.returncode != 0:
                print(f"host_ab: the {tree} process exited {r.returncode}",
                      file=sys.stderr)
                return 1
            line = r.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    times = {}
    for key in runs[0]:
        if key.endswith("_s"):
            o = [runs[j][key] for j in (0, 3)]
            t = [runs[j][key] for j in (1, 2)]
            times[key] = {"other": o, "this": t,
                          "this_over_other": sum(t) / sum(o)}
    same = {key: len({r[key] for r in runs}) == 1
            for key in runs[0] if key.endswith("_digest")}
    if args.device == "cuda":
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True)
        print(q.stdout.strip(), flush=True)
    print(json.dumps({"ab": times, "records": args.records,
                      "entries": args.entries,
                      "order": ["other", "this", "this", "other"],
                      "outputs_equal": same}), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
