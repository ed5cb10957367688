"""Crash-safe checkpoint/resume artifacts for both stages (counterpart of
quorum_tpu/io/checkpoint.py). The formats are the JAX package's, byte
for byte, so each package resumes from the other's artifacts.

* **Stage-1 snapshot** (`Stage1Checkpoint`): the build table
  (ops/ctable.TBuildState: tag, hq and lq planes), the input batch
  cursor and the running stats, as ONE file: a sealed JSON header line,
  then the raw planes (tag, hq, lq), written tmp-then-rename. The
  port's planes are int32 and the JAX package's uint32: they are
  written and read as the same bits. `--resume` reloads the last valid
  snapshot and skips the first `cursor` batches of the re-batched
  input.

* **Sharded stage-1 snapshot** (`Stage1ShardedCheckpoint`, --devices
  N): one payload file a shard under one sealed manifest, the manifest
  swap the commit point.

* **Partition cursor** (`Stage1PartitionCursor`, --partitions P) and
  **sketch snapshot** (`SketchCheckpoint`, the two-pass prefilter's
  finished sketch).

* **Stage-2 journal** (`Stage2Journal`): corrected output streams to
  `<prefix>.fa.partial` / `<prefix>.log.partial`; every
  `--checkpoint-every` batches the pipeline drains and flushes, then
  `<prefix>.resume.json` commits the batch cursor, the completed-read
  stats and the committed byte length and CRC32C of each partial.
  `--resume` truncates the partials back to the commit, skips the
  journaled batches and appends; `finalize()` renames the partials over
  the real outputs.

* **Replay cache** (`ReplayCache`): the quorum driver's parsed and
  packed reads on disk, so a resumed driver does not parse the FASTQ
  again.

Every artifact carries CRC32C digests (payloads digested, headers and
manifests self-sealed by io/integrity.seal); a digest mismatch on load
is a CheckpointError (rc 3) counted in `integrity_errors_total`. The
`checkpoint.commit`, `journal.append` and `partition.commit` fault
sites fire after each commit with the committed path.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..telemetry.registry import atomic_write
from ..utils import faults, resources
from . import integrity

STAGE1_FORMAT = "quorum_tpu_stage1_ckpt/1"
STAGE1_SHARDED_FORMAT = "quorum_tpu_stage1_sharded/1"
STAGE1_SHARD_FORMAT = "quorum_tpu_stage1_shard/1"
STAGE2_FORMAT = "quorum_tpu_stage2_journal/1"


class CheckpointError(RuntimeError):
    """A checkpoint/journal exists but cannot be used (corrupt, or
    written by a run with different parameters). Deterministic — the
    driver's retry loop must NOT back off and re-try it."""


# the rc the stage CLIs return for a CheckpointError, so the driver's
# retry loop can tell a deterministic refusal from a transient failure
# across the main()-returns-int boundary
NON_RETRYABLE_RC = 3


def _check_seal_ckpt(doc: dict, what: str, path: str) -> None:
    """Header self-digest check, surfaced as CheckpointError (the
    refusal every checkpoint consumer already maps to rc 3). The
    detection is still counted/evented by the integrity layer."""
    try:
        integrity.check_seal(doc, what, path)
    except integrity.IntegrityError as e:
        raise CheckpointError(str(e)) from None


def _check_payload_crc(payload, header: dict, what: str,
                       path: str) -> None:
    """Verify a snapshot payload against its recorded digest (absent
    on the oldest JAX artifacts: they load on the length check
    alone)."""
    want = header.get("payload_crc32c")
    if want is None:
        return
    got = integrity.crc32c(payload)
    if got != int(want):
        integrity.record_error(
            f"{what} '{path}': payload digest mismatch (crc32c "
            f"{got:#010x} != recorded {int(want):#010x})",
            path=path, section="payload")
        raise CheckpointError(
            f"{what} '{path}' failed its payload digest (crc32c "
            f"{got:#010x} != recorded {int(want):#010x}); the "
            "snapshot is silently corrupted — refusing to resume "
            "from it (delete it to start over)")
    integrity.record_verified(len(payload))


def _to_host(plane) -> np.ndarray:
    """A table plane as contiguous host uint32 (the file's bits): the
    port's int32 tensors are copied off their device and viewed; a
    numpy array is viewed as it is."""
    if not isinstance(plane, np.ndarray):
        plane = plane.detach().contiguous().cpu().numpy()
    return np.ascontiguousarray(plane).view(np.uint32)


def _to_device(plane: np.ndarray, device):
    """A host uint32 plane as the port's int32 tensor on `device`."""
    import torch
    return torch.from_numpy(
        np.ascontiguousarray(plane).view(np.int32)).to(device)


def _read_rest(f) -> bytearray:
    """The rest of a binary file, read into one writable buffer (the
    planes built over it are handed to torch without a second copy)."""
    buf = bytearray(max(0, os.fstat(f.fileno()).st_size - f.tell()))
    n = f.readinto(buf)
    del buf[n:]
    return buf


# ---------------------------------------------------------------------------
# Stage 1: counting-table snapshot
# ---------------------------------------------------------------------------


class Stage1Snapshot:
    """A loaded stage-1 snapshot: host-side table planes (uint32, the
    file's bits) + cursor. `build_state(device)` puts them on a device
    as the port's int32 TBuildState."""

    def __init__(self, header: dict, tag: np.ndarray, hq: np.ndarray,
                 lq: np.ndarray):
        self.header = header
        self.tag = tag
        self.hq = hq
        self.lq = lq

    @property
    def rb_log2(self) -> int:
        return int(self.header["rb_log2"])

    @property
    def cursor(self) -> int:
        return int(self.header["cursor"])

    def build_state(self, device):
        """The planes as the port's TBuildState on `device` (the same
        bits, viewed as int32)."""
        from ..ops.ctable import TBuildState
        return TBuildState(*(_to_device(a, device)
                             for a in (self.tag, self.hq, self.lq)))

    def check_config(self, k: int, bits: int, qual_thresh: int,
                     batch_size: int, paths) -> None:
        h = self.header
        want = {"k": k, "bits": bits, "qual_thresh": qual_thresh,
                "batch_size": batch_size}
        for key, val in want.items():
            if int(h.get(key, -1)) != int(val):
                raise CheckpointError(
                    f"stage-1 checkpoint was written with {key}="
                    f"{h.get(key)}, this run uses {val}; refusing to "
                    "resume (delete the checkpoint to start over)")
        if list(h.get("paths", [])) != list(paths):
            raise CheckpointError(
                f"stage-1 checkpoint covers inputs {h.get('paths')}, "
                f"this run reads {list(paths)}; refusing to resume")


class Stage1Checkpoint:
    """Atomic snapshot file `<dir>/stage1.ckpt`. `last_save` holds the
    last save's bytes and seconds split into the device-to-host copy,
    the CRC32C and the write with its fsync (`d2h_s`, `crc_s`,
    `write_s`)."""

    def __init__(self, directory: str):
        self.dir = directory
        self.path = os.path.join(directory, "stage1.ckpt")
        self.last_save: dict | None = None

    def save(self, bstate, meta, cfg, cursor: int, stats,
             paths) -> None:
        """Snapshot the build table after `cursor` fully-inserted
        batches. The device-to-host copy is the sync point (a batch
        whose insert has not finished is never counted), which is why
        `--checkpoint-every` is a cadence knob. Streamed
        tmp-then-rename: same atomicity contract as atomic_write
        without a second host copy of the table."""
        if resources.degraded("stage1.checkpoint"):
            return
        with resources.guard("stage1.checkpoint", path=self.path):
            os.makedirs(self.dir, exist_ok=True)
            t0 = time.perf_counter()
            tag, hq, lq = (_to_host(x)
                           for x in (bstate.tag, bstate.hq, bstate.lq))
            t1 = time.perf_counter()
            # payload digest: incremental CRC over the planes in write
            # order, so load can refuse silent corruption (bit rot,
            # torn sectors) — the length check only catches truncation
            pcrc = integrity.crc32c(tag)
            pcrc = integrity.crc32c(hq, pcrc)
            pcrc = integrity.crc32c(lq, pcrc)
            t2 = time.perf_counter()
            header = integrity.seal({
                "format": STAGE1_FORMAT,
                "k": meta.k,
                "bits": meta.bits,
                "rb_log2": meta.rb_log2,
                "cursor": int(cursor),
                "reads": int(stats.reads),
                "bases": int(stats.bases),
                "batches": int(stats.batches),
                "grows": int(stats.grows),
                "qual_thresh": int(cfg.qual_thresh),
                "batch_size": int(cfg.batch_size),
                "paths": list(paths),
                "tag_shape": list(tag.shape),
                "acc_len": int(hq.shape[0]),
                "payload_crc32c": pcrc,
            })
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(json.dumps(header).encode() + b"\n")
                f.write(tag.data)
                f.write(hq.data)
                f.write(lq.data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            integrity.fsync_dir(self.path)
            t3 = time.perf_counter()
            self.last_save = {
                "bytes": int(tag.nbytes + hq.nbytes + lq.nbytes),
                "d2h_s": t1 - t0, "crc_s": t2 - t1, "write_s": t3 - t2}
            faults.inject("checkpoint.commit", path=self.path)

    def load(self) -> Stage1Snapshot | None:
        """The last valid snapshot, or None when there is none. A
        truncated/corrupt file raises CheckpointError (resuming from
        garbage must not look like a fresh start)."""
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            line = f.readline(1 << 20)
            try:
                header = json.loads(line)
            except ValueError:
                raise CheckpointError(
                    f"corrupt stage-1 checkpoint '{self.path}' (bad "
                    "header)") from None
            if header.get("format") != STAGE1_FORMAT:
                raise CheckpointError(
                    f"'{self.path}' is not a stage-1 checkpoint "
                    f"(format={header.get('format')!r})")
            _check_seal_ckpt(header, "stage-1 checkpoint", self.path)
            rows, tile = header["tag_shape"]
            acc = header["acc_len"]
            want = (rows * tile + 2 * acc) * 4
            payload = _read_rest(f)
        if len(payload) != want:
            raise CheckpointError(
                f"corrupt stage-1 checkpoint '{self.path}': payload "
                f"{len(payload)} bytes, want {want}")
        _check_payload_crc(payload, header, "stage-1 checkpoint",
                           self.path)
        arr = np.frombuffer(payload, dtype=np.uint32)
        tag = arr[:rows * tile].reshape(rows, tile)
        hq = arr[rows * tile:rows * tile + acc]
        lq = arr[rows * tile + acc:]
        return Stage1Snapshot(header, tag, hq, lq)

    def cursor(self) -> int | None:
        """Header-only peek at the snapshot's batch cursor (for the
        driver's retry events); None when no usable snapshot."""
        try:
            if not os.path.exists(self.path):
                return None
            with open(self.path, "rb") as f:
                header = json.loads(f.readline(1 << 20))
            return int(header["cursor"])
        except (OSError, ValueError, KeyError):
            return None

    def clear(self) -> None:
        """Remove the snapshot (a completed build must not feed a
        later unrelated --resume)."""
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


# ---------------------------------------------------------------------------
# Stage 1, sharded (--devices N): per-shard snapshots under one manifest
# ---------------------------------------------------------------------------


class Stage1ShardedSnapshot:
    """A loaded sharded stage-1 snapshot: the manifest header plus the
    REASSEMBLED global table planes (shard slices concatenated in
    leading-row-bit order — the global array is identical to what the
    build held, whatever mesh it re-lands on)."""

    def __init__(self, header: dict, tag: np.ndarray, hq: np.ndarray,
                 lq: np.ndarray):
        self.header = header
        self.tag = tag
        self.hq = hq
        self.lq = lq

    @property
    def rb_log2(self) -> int:
        return int(self.header["rb_log2"])

    @property
    def n_shards(self) -> int:
        return int(self.header["n_shards"])

    def build_state(self, mesh):
        """The planes as the port's ShardedBuildState: shard s's row
        range (and its accumulator range) on mesh[s]."""
        from ..ops.ctable import ShardedBuildState, TBuildState
        S = len(mesh)
        rows = self.tag.shape[0] // S
        acc = self.hq.shape[0] // S
        return ShardedBuildState(tuple(
            TBuildState(_to_device(self.tag[s * rows:(s + 1) * rows], d),
                        _to_device(self.hq[s * acc:(s + 1) * acc], d),
                        _to_device(self.lq[s * acc:(s + 1) * acc], d))
            for s, d in enumerate(mesh)))

    @property
    def cursor(self) -> int:
        return int(self.header["cursor"])

    def check_config(self, k: int, bits: int, qual_thresh: int,
                     batch_size: int, paths, n_shards: int) -> None:
        h = self.header
        want = {"k": k, "bits": bits, "qual_thresh": qual_thresh,
                "batch_size": batch_size, "n_shards": n_shards}
        for key, val in want.items():
            if int(h.get(key, -1)) != int(val):
                raise CheckpointError(
                    f"sharded stage-1 checkpoint was written with "
                    f"{key}={h.get(key)}, this run uses {val}; refusing "
                    "to resume (delete the checkpoint to start over)")
        if list(h.get("paths", [])) != list(paths):
            raise CheckpointError(
                f"sharded stage-1 checkpoint covers inputs "
                f"{h.get('paths')}, this run reads {list(paths)}; "
                "refusing to resume")


class Stage1ShardedCheckpoint:
    """Crash-safe snapshots of a SHARDED stage-1 build (`--devices N`,
    parallel/tile_sharded): one payload file per shard plus ONE
    manifest, `<dir>/stage1.sharded.json`.

    Write protocol (kill-safe at any instant): every shard of the new
    generation lands first (tmp-then-rename each, its own header
    recording shard id / generation / cursor / geometry), then the
    manifest is atomically replaced (the commit point), and only then
    are the previous generation's shard files removed. A kill before
    the manifest swap resumes from the OLD generation; after it, from
    the new one.

    Load verifies the shard set against the manifest (every shard
    present, same generation, same cursor, same geometry, exact payload
    size) and REFUSES (CheckpointError) on any disagreement. One host
    only: the JAX package's multi-host barriers and `fleet_agreement`
    wait for the fleet (ROADMAP Queue 1 item 9)."""

    MANIFEST = "stage1.sharded.json"

    def __init__(self, directory: str):
        self.dir = directory
        self.path = os.path.join(directory, self.MANIFEST)

    def _shard_path(self, s: int, gen: int) -> str:
        return os.path.join(self.dir, f"stage1.shard{s:04d}.g{gen}.ckpt")

    def _read_manifest(self) -> dict | None:
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as f:
                header = json.load(f)
        except ValueError:
            raise CheckpointError(
                f"corrupt sharded stage-1 manifest '{self.path}'"
            ) from None
        if header.get("format") != STAGE1_SHARDED_FORMAT:
            raise CheckpointError(
                f"'{self.path}' is not a sharded stage-1 manifest "
                f"(format={header.get('format')!r})")
        _check_seal_ckpt(header, "sharded stage-1 manifest", self.path)
        return header

    def save(self, bstate, meta, cfg, cursor: int, stats, paths) -> None:
        """Snapshot the sharded build planes after `cursor` fully
        inserted batches; the manifest swap is the commit point.
        Checkpoints are optional: on ENOSPC the writer disables itself
        and the run goes on."""
        if resources.degraded("stage1.checkpoint"):
            return
        with resources.guard("stage1.checkpoint", path=self.path):
            self._save_guarded(bstate, meta, cfg, cursor, stats, paths)

    def _save_guarded(self, bstate, meta, cfg, cursor, stats,
                      paths) -> None:
        from ..ops.ctable import TSLOTS
        os.makedirs(self.dir, exist_ok=True)
        try:
            old = self._read_manifest()
        except CheckpointError:
            old = None  # never let a corrupt old manifest block saving
        gen = (int(old.get("gen", 0)) + 1) if old else 1
        S = meta.n_shards
        rows_local = meta.rows // S
        acc_local = rows_local * TSLOTS
        for s, shard in enumerate(bstate.shards):
            tag_s, hq_s, lq_s = (_to_host(x)
                                 for x in (shard.tag, shard.hq, shard.lq))
            pcrc = integrity.crc32c(tag_s)
            pcrc = integrity.crc32c(hq_s, pcrc)
            pcrc = integrity.crc32c(lq_s, pcrc)
            header = integrity.seal({
                "format": STAGE1_SHARD_FORMAT, "shard": s,
                "n_shards": S, "gen": gen, "cursor": int(cursor),
                "rb_log2": meta.rb_log2,
                "rows_local": rows_local, "acc_local": acc_local,
                "payload_crc32c": pcrc,
            })
            tmp = self._shard_path(s, gen) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(json.dumps(header).encode() + b"\n")
                f.write(tag_s.data)
                f.write(hq_s.data)
                f.write(lq_s.data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._shard_path(s, gen))
            faults.inject("checkpoint.commit",
                          path=self._shard_path(s, gen))
        integrity.fsync_dir(self.dir)
        # every shard is durable BEFORE the manifest commits to this
        # generation
        atomic_write(self.path, json.dumps(integrity.seal({
            "format": STAGE1_SHARDED_FORMAT,
            "gen": gen,
            "cursor": int(cursor),
            "k": meta.k, "bits": meta.bits,
            "rb_log2": meta.rb_log2, "n_shards": S,
            "rows_local": rows_local, "acc_local": acc_local,
            "reads": int(stats.reads), "bases": int(stats.bases),
            "batches": int(stats.batches), "grows": int(stats.grows),
            "qual_thresh": int(cfg.qual_thresh),
            "batch_size": int(cfg.batch_size),
            "paths": list(paths),
        })) + "\n")
        faults.inject("checkpoint.commit", path=self.path)
        # the old generation is dead only now that the manifest moved on
        if old:
            for s in range(int(old.get("n_shards", 0))):
                try:
                    os.remove(self._shard_path(s, int(old["gen"])))
                except OSError:
                    pass

    def load(self) -> Stage1ShardedSnapshot | None:
        """The last committed snapshot, or None when there is none. Any
        shard missing, truncated, or disagreeing with the manifest
        (generation, cursor, geometry) raises CheckpointError."""
        manifest = self._read_manifest()
        if manifest is None:
            return None
        S = int(manifest["n_shards"])
        gen = int(manifest["gen"])
        rows_local = int(manifest["rows_local"])
        acc_local = int(manifest["acc_local"])
        from ..ops.ctable import TILE
        want_payload = (rows_local * TILE + 2 * acc_local) * 4
        tags, hqs, lqs = [], [], []
        for s in range(S):
            p = self._shard_path(s, gen)
            if not os.path.exists(p):
                raise CheckpointError(
                    f"sharded stage-1 checkpoint is missing shard {s} "
                    f"('{p}'); refusing to resume from a partial "
                    "snapshot")
            with open(p, "rb") as f:
                try:
                    h = json.loads(f.readline(1 << 20))
                except ValueError:
                    raise CheckpointError(
                        f"corrupt shard snapshot '{p}' (bad header)"
                    ) from None
                payload = _read_rest(f)
            for key, want in (("format", STAGE1_SHARD_FORMAT),
                              ("shard", s), ("n_shards", S),
                              ("gen", gen),
                              ("cursor", int(manifest["cursor"])),
                              ("rb_log2", int(manifest["rb_log2"]))):
                if h.get(key) != want:
                    raise CheckpointError(
                        f"shard snapshot '{p}' disagrees with the "
                        f"manifest on {key} ({h.get(key)!r} != "
                        f"{want!r}); every shard must restore at the "
                        "same cursor — refusing to resume")
            if len(payload) != want_payload:
                raise CheckpointError(
                    f"corrupt shard snapshot '{p}': payload "
                    f"{len(payload)} bytes, want {want_payload}")
            _check_seal_ckpt(h, "shard snapshot", p)
            _check_payload_crc(payload, h, "shard snapshot", p)
            arr = np.frombuffer(payload, dtype=np.uint32)
            tags.append(arr[:rows_local * TILE].reshape(rows_local,
                                                        TILE))
            hqs.append(arr[rows_local * TILE:rows_local * TILE
                           + acc_local])
            lqs.append(arr[rows_local * TILE + acc_local:])
        return Stage1ShardedSnapshot(
            manifest, np.concatenate(tags, axis=0),
            np.concatenate(hqs), np.concatenate(lqs))

    def cursor(self) -> int | None:
        """Header-only peek at the committed batch cursor (driver
        retry events); None when no usable manifest."""
        try:
            manifest = self._read_manifest()
            return None if manifest is None else int(manifest["cursor"])
        except (CheckpointError, KeyError, ValueError):
            return None

    def clear(self) -> None:
        """Remove the manifest and every shard payload (the finished
        database is the durable artifact now)."""
        import glob
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass
        # the *.ckpt.tmp pattern catches orphans of a save() killed
        # between the tmp write and its rename — later generations
        # never reuse the name, so nothing else would reap them
        for p in glob.glob(os.path.join(self.dir,
                                        "stage1.shard*.ckpt*")):
            try:
                os.remove(p)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Stage 1, partitioned (--partitions P): pass-granular cursor manifest
# ---------------------------------------------------------------------------

STAGE1_PARTITIONS_FORMAT = "quorum_tpu_stage1_partitions/1"
SKETCH_FORMAT = "quorum_tpu_sketch_ckpt/1"


class Stage1PartitionCursor:
    """Crash-safe progress cursor for the minimizer-partitioned
    multi-pass stage-1 build: the Stage1ShardedCheckpoint
    manifest protocol at PARTITION-PASS granularity: the completed
    partitions' shard files (already durable at their final output
    paths — each pass's export IS its checkpoint) plus ONE sealed
    cursor manifest, ``<dir>/stage1.partitions.json``, atomically
    replaced after every pass. A kill mid-pass leaves the cursor at
    the last completed partition; ``--resume`` validates the config
    identity AND every completed shard file's whole-file digest, then
    re-runs only the torn/remaining partitions — byte-identical
    output, no batch-level snapshots needed (a pass restarts from its
    first batch)."""

    MANIFEST = "stage1.partitions.json"

    def __init__(self, directory: str):
        self.dir = directory
        self.path = os.path.join(directory, self.MANIFEST)

    def _read(self) -> dict | None:
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except ValueError:
            raise CheckpointError(
                f"corrupt partition cursor '{self.path}'") from None
        if doc.get("format") != STAGE1_PARTITIONS_FORMAT:
            raise CheckpointError(
                f"'{self.path}' is not a stage-1 partition cursor "
                f"(format={doc.get('format')!r})")
        _check_seal_ckpt(doc, "stage-1 partition cursor", self.path)
        return doc

    def save(self, identity: dict, completed: list[dict],
             out_dir: str) -> None:
        """Commit the cursor after a pass: `completed` is the ordered
        list of write_db_shard_file manifest records (plus per-pass
        stat fields) for every finished partition. Each record gains
        the PHYSICAL whole-file digest of its shard (the manifest's
        `file_crc32c` is the v5 header+payload digest, which excludes
        the trailer line) so load() can verify with one crc32c_file
        pass. atomic_write = the commit point."""
        if resources.degraded("partition.cursor"):
            return
        with resources.guard("partition.cursor", path=self.path):
            os.makedirs(self.dir, exist_ok=True)
            for rec in completed:
                # memoized ON the caller's record: the cursor commits
                # after EVERY pass with the same record objects, and
                # re-hashing all prior shards each time would be
                # O(P^2) whole-file reads
                if "ckpt_file_crc32c" not in rec:
                    rec["ckpt_file_crc32c"] = integrity.crc32c_file(
                        os.path.join(out_dir, str(rec["path"])))
            atomic_write(self.path, json.dumps(integrity.seal({
                "format": STAGE1_PARTITIONS_FORMAT,
                "identity": identity,
                "completed": list(completed),
            })) + "\n")
            faults.inject("partition.commit", path=self.path)

    def load(self, identity: dict, out_dir: str) -> list[dict] | None:
        """The completed-partition records, or None when there is no
        usable cursor. A cursor written by a different run (identity
        mismatch) is None — a fresh build, not an error. A completed
        shard file that is missing or fails its recorded digest
        raises CheckpointError: resuming must never trust a partition
        the manifest can't vouch for."""
        doc = self._read()
        if doc is None or doc.get("identity") != identity:
            return None
        completed = doc.get("completed") or []
        for rec in completed:
            p = os.path.join(out_dir, str(rec.get("path", "")))
            if not os.path.exists(p):
                raise CheckpointError(
                    f"partition cursor names completed shard '{p}' "
                    "but the file is missing; delete the cursor to "
                    "rebuild from scratch")
            got = integrity.crc32c_file(p)
            if got != int(rec.get("ckpt_file_crc32c", -1)):
                integrity.record_error(
                    f"completed partition shard '{p}': digest "
                    f"mismatch (crc32c {got:#010x} != cursor "
                    f"{int(rec.get('ckpt_file_crc32c', -1)):#010x})",
                    path=p, section="shard", offset=0)
                raise CheckpointError(
                    f"completed partition shard '{p}' failed its "
                    "digest; refusing to resume over a corrupted "
                    "partition (delete it and the cursor to rebuild)")
        return completed

    def cursor(self) -> int | None:
        """Header-only peek: how many partitions are committed (the
        driver's retry events); None when no usable cursor."""
        try:
            doc = self._read()
        except CheckpointError:
            return None
        if doc is None:
            return None
        return len(doc.get("completed") or [])

    def clear(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


class SketchCheckpoint:
    """Snapshot of the two-pass prefilter's finished sketch
    (``<dir>/stage1.sketch.ckpt``), so a resumed partitioned+
    prefiltered build skips the sketch pass instead of re-streaming
    the whole input. Same streamed tmp-then-rename + payload-digest
    contract as Stage1Checkpoint."""

    def __init__(self, directory: str):
        self.dir = directory
        self.path = os.path.join(directory, "stage1.sketch.ckpt")

    def save(self, cells: np.ndarray, identity: dict) -> None:
        if resources.degraded("sketch.checkpoint"):
            return
        with resources.guard("sketch.checkpoint", path=self.path):
            os.makedirs(self.dir, exist_ok=True)
            cells = np.ascontiguousarray(np.asarray(cells, np.uint8))
            header = integrity.seal({
                "format": SKETCH_FORMAT,
                "identity": identity,
                "cells": int(cells.shape[0]),
                "payload_crc32c": integrity.crc32c(cells),
            })
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(json.dumps(header).encode() + b"\n")
                f.write(cells.tobytes())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            integrity.fsync_dir(self.path)
            faults.inject("checkpoint.commit", path=self.path)

    def load(self, identity: dict) -> np.ndarray | None:
        """The sketch cell plane, or None (mismatched identity = a
        different run's sketch = fresh pass, not an error). A corrupt
        payload raises CheckpointError."""
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            try:
                header = json.loads(f.readline(1 << 20))
            except ValueError:
                raise CheckpointError(
                    f"corrupt sketch checkpoint '{self.path}' (bad "
                    "header)") from None
            if header.get("format") != SKETCH_FORMAT:
                raise CheckpointError(
                    f"'{self.path}' is not a sketch checkpoint "
                    f"(format={header.get('format')!r})")
            _check_seal_ckpt(header, "sketch checkpoint", self.path)
            if header.get("identity") != identity:
                return None
            payload = f.read()
        if len(payload) != int(header["cells"]):
            raise CheckpointError(
                f"corrupt sketch checkpoint '{self.path}': payload "
                f"{len(payload)} bytes, want {header['cells']}")
        _check_payload_crc(payload, header, "sketch checkpoint",
                           self.path)
        return np.frombuffer(payload, dtype=np.uint8)

    def clear(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


# ---------------------------------------------------------------------------
# Stage 2: output journal
# ---------------------------------------------------------------------------


class _CrcStream:
    """A partial-output stream that tracks the running CRC32C of every
    byte written (str writes are utf-8 encoded), so a journal commit
    digests the committed ranges for free — no re-read pass. Binary
    under the hood: `tell()` is a real byte offset, which is what the
    journal records."""

    def __init__(self, path: str, mode: str, crc: int = 0):
        self._f = open(path, mode)
        self.crc = crc

    def write(self, data) -> int:
        b = data.encode() if isinstance(data, str) else data
        self.crc = integrity.crc32c(b, self.crc)
        return self._f.write(b)

    def tell(self) -> int:
        return self._f.tell()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class Stage2Journal:
    """Journal + partial-output lifecycle for one `-o PREFIX` run."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.fa_final = prefix + ".fa"
        self.log_final = prefix + ".log"
        self.fa_partial = self.fa_final + ".partial"
        self.log_partial = self.log_final + ".partial"
        self.path = prefix + ".resume.json"
        # the live CRC streams (set by open_outputs) whose running
        # digests commit() records
        self._out: _CrcStream | None = None
        self._log: _CrcStream | None = None

    def load(self) -> dict | None:
        """The committed journal state, or None when there is nothing
        to resume (no journal, or the partials are gone — e.g. a
        crash landed between finalize's renames; the run simply
        starts fresh and converges on the same bytes)."""
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except ValueError:
            raise CheckpointError(
                f"corrupt stage-2 journal '{self.path}'") from None
        if doc.get("format") != STAGE2_FORMAT:
            raise CheckpointError(
                f"'{self.path}' is not a stage-2 journal "
                f"(format={doc.get('format')!r})")
        # self-digest: a flipped digit in a cursor or byte count can
        # still parse as valid JSON — the seal catches it
        _check_seal_ckpt(doc, "stage-2 journal", self.path)
        if not (os.path.exists(self.fa_partial)
                and os.path.exists(self.log_partial)):
            return None
        return doc

    def check_config(self, st: dict, batch_size: int,
                     context: dict | None = None) -> None:
        """Refuse to resume across a changed run: a different batch
        size skips the wrong reads; a different database, input set,
        or correction config would silently splice two different
        corrections into one output file."""
        if int(st.get("batch_size", -1)) != int(batch_size):
            raise CheckpointError(
                f"stage-2 journal was written with batch_size="
                f"{st.get('batch_size')}, this run uses {batch_size}; "
                "resuming would skip the wrong reads")
        want = st.get("context", {})
        for key, val in (context or {}).items():
            if key in want and want[key] != val:
                raise CheckpointError(
                    f"stage-2 journal was written with {key}="
                    f"{want[key]!r}, this run uses {val!r}; refusing "
                    "to resume (remove the journal to start over)")

    def open_outputs(self, st: dict | None):
        """Open the partial output streams (CRC-tracking; see
        _CrcStream). With a journal state, verify each partial's
        committed byte range against the journaled digest (silent
        corruption inside the committed range must refuse, not splice
        into a clean-looking output), truncate back to the committed
        length (a kill mid-write leaves a torn tail past the commit;
        the truncate discards exactly that), and append with the CRC
        state restored from the journal; without one, start fresh."""
        if st is not None:
            crcs = {}
            for p, committed, key in (
                    (self.fa_partial, st["fa_bytes"], "fa_crc32c"),
                    (self.log_partial, st["log_bytes"], "log_crc32c")):
                size = os.path.getsize(p)
                committed = int(committed)
                if size < committed:
                    raise CheckpointError(
                        f"'{p}' is {size} bytes but the journal "
                        f"committed {committed}; cannot resume")
                want = st.get(key)
                got = integrity.crc32c_file(p, 0, committed)
                if want is not None:
                    if got != int(want):
                        integrity.record_error(
                            f"'{p}': committed range digest mismatch "
                            f"(crc32c {got:#010x} != journaled "
                            f"{int(want):#010x})", path=p,
                            section="committed", offset=0)
                        raise CheckpointError(
                            f"'{p}' is corrupted INSIDE the committed "
                            f"{committed} bytes (crc32c {got:#010x} != "
                            f"journaled {int(want):#010x}); resuming "
                            "would splice damaged output — refusing "
                            "(remove the partials and journal to "
                            "start over)")
                    integrity.record_verified(committed)
                # seed the stream with the COMPUTED digest either way:
                # a pre-upgrade journal carries no digest, and seeding
                # 0 there would make the next commit journal a CRC
                # covering only the post-resume bytes — a later resume
                # would then refuse an undamaged file
                crcs[key] = got
                with open(p, "r+b") as f:
                    f.truncate(committed)
            self._out = _CrcStream(self.fa_partial, "ab",
                                   crc=crcs.get("fa_crc32c", 0))
            self._log = _CrcStream(self.log_partial, "ab",
                                   crc=crcs.get("log_crc32c", 0))
        else:
            self._out = _CrcStream(self.fa_partial, "wb")
            self._log = _CrcStream(self.log_partial, "wb")
        return self._out, self._log

    def commit(self, batches: int, stats, fa_bytes: int,
               log_bytes: int, batch_size: int,
               context: dict | None = None) -> None:
        """Record that the first `batches` batches are fully rendered,
        written, and flushed. Caller guarantees the flush happened
        BEFORE this call — the journal must never claim bytes the
        partials might not have. `context` (db path, input paths,
        config fingerprint) is what check_config holds a resume to.
        The committed ranges' running digests (from the CRC streams)
        and the document's self-seal ride along, so both torn-write
        corruption and journal tampering refuse on resume."""
        doc = {
            "format": STAGE2_FORMAT,
            "batches": int(batches),
            "fa_bytes": int(fa_bytes),
            "log_bytes": int(log_bytes),
            "batch_size": int(batch_size),
            "context": context or {},
            "reads": int(stats.reads),
            "corrected": int(stats.corrected),
            "skipped": int(stats.skipped),
            "bases_in": int(stats.bases_in),
            "bases_out": int(stats.bases_out),
        }
        if self._out is not None and self._log is not None:
            doc["fa_crc32c"] = self._out.crc
            doc["log_crc32c"] = self._log.crc
        # REQUIRED writer: resumability is part of the
        # output contract — ENOSPC here seals a flight dump and fails
        # the run fast (rc DISK_FULL_RC, not retried) instead of
        # grinding on with an un-journaled partial.
        with resources.guard("stage2.journal", path=self.path):
            atomic_write(self.path,
                         json.dumps(integrity.seal(doc)) + "\n")
            faults.inject("journal.append", path=self.path)

    def batches_done(self) -> int | None:
        """Peek at the journaled batch cursor (driver retry events)."""
        try:
            st = self.load()
        except CheckpointError:
            return None
        return int(st["batches"]) if st else None

    def finalize(self) -> None:
        """Atomically promote the partials to the real outputs and
        drop the journal. Idempotent: a crash between the renames
        leaves a state this (or a fresh run) completes."""
        if os.path.exists(self.fa_partial):
            os.replace(self.fa_partial, self.fa_final)
        if os.path.exists(self.log_partial):
            os.replace(self.log_partial, self.log_final)
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass
        # the promoted outputs must survive power loss, not just
        # process death: sync the directory entries the renames moved
        integrity.fsync_dir(self.fa_final)


# ---------------------------------------------------------------------------
# Driver replay cache
# ---------------------------------------------------------------------------

REPLAY_FORMAT = "quorum_tpu_replay_cache/1"


class ReplayCache:
    """The quorum driver's stage-2 replay cache, persisted under
    `--checkpoint-dir` so a RESUMED run doesn't re-parse the input
    FASTQ. In one process the driver parses+packs the reads once and
    replays them into stage 2 from RAM, and the RAM cache dies with a
    killed process. This store is that cache on disk: one `.npz` per batch (the
    decoded int8 codes stage-2 rendering needs, the bit-packed stage-2
    wire planes, lengths, headers) streamed out as stage 1 consumes
    the producer, plus a manifest written ATOMICALLY only once every
    batch landed — the manifest is the commit point, so a kill
    mid-write just means the next resume re-parses (correct, only
    slower). `load()` validates the recorded identity (inputs,
    batch size, qual cutoff) and hands back lazily-loaded
    (ReadBatch, PackedReads) pairs, one batch in RAM at a time."""

    def __init__(self, directory: str):
        self.dir = os.path.join(directory, "replay")
        self.manifest_path = os.path.join(self.dir, "manifest.json")

    def _batch_path(self, i: int) -> str:
        return os.path.join(self.dir, f"batch_{i:06d}.npz")

    # -- writer ----------------------------------------------------------
    def start(self, identity: dict, cap_bytes: int) -> "_ReplayWriter":
        """Begin a fresh capture (drops any previous one — a retried
        stage-1 attempt re-consumes the producer from batch 0)."""
        self.clear()
        os.makedirs(self.dir, exist_ok=True)
        return _ReplayWriter(self, identity, cap_bytes)

    # -- reader ----------------------------------------------------------
    def manifest(self) -> dict | None:
        try:
            with open(self.manifest_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if doc.get("format") != REPLAY_FORMAT:
            return None
        # a tampered/bit-rotted manifest is CORRUPTION, not a missing
        # capture: refuse loudly (rc 3) rather than silently reusing
        # byte counts and digests that no longer describe the payloads
        _check_seal_ckpt(doc, "replay-cache manifest",
                         self.manifest_path)
        return doc

    def load(self, identity: dict):
        """A complete, identity-matched capture, or None (caller falls
        back to the disk re-parse). Returns an object whose
        `.batches()` yields fresh (ReadBatch, PackedReads) pairs per
        call (driver retries need a new iterator per attempt). A
        capture that exists but fails its digests raises
        CheckpointError — damaged bytes must never be silently
        replayed into stage 2."""
        doc = self.manifest()
        if doc is None or doc.get("identity") != identity:
            return None
        n = int(doc.get("n_batches", -1))
        if n < 0 or not all(os.path.exists(self._batch_path(i))
                            for i in range(n)):
            return None
        return _ReplayReader(self, n, doc.get("payloads"))

    def clear(self) -> None:
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)


class _ReplayWriter:
    """Streaming side of ReplayCache: `add()` per cached batch,
    `finish()` commits the manifest. Exceeding `cap_bytes` (the same
    budget as the RAM replay cache) aborts and removes the capture."""

    def __init__(self, cache: ReplayCache, identity: dict,
                 cap_bytes: int):
        self.cache = cache
        self.identity = identity
        self.cap_bytes = cap_bytes
        self.bytes = 0
        self.n = 0
        self.ok = True
        self.payloads: list[dict] = []  # per-batch {bytes, crc32c}

    def add(self, batch, pk) -> None:
        if not self.ok:
            return
        path = self.cache._batch_path(self.n)
        arrays = {
            "codes": batch.codes,
            "lengths": np.asarray(batch.lengths, np.int32),
            "n": np.int64(batch.n),
            "headers": np.asarray(batch.headers),
            # the packed side stores the ONE fused wire buffer (the
            # same bytes the device consumes) + geometry; the reader
            # rebuilds the planes as views of it (packing.from_wire)
            "pk_wire": pk.to_wire(),
            "pk_b": np.int64(pk.n_reads),
            "pk_lengths": np.asarray(pk.lengths, np.int32),
            "pk_length": np.int64(pk.length),
            "pk_thresholds": np.asarray(sorted(pk.hq), np.int64),
        }
        try:
            with open(path + ".tmp", "wb") as f:
                np.savez(f, **arrays)
            os.replace(path + ".tmp", path)
            size = os.path.getsize(path)
            # npz writes seek (zip central directory), so the digest
            # is a read-back — page-cache-hot, one pass per batch
            self.payloads.append(
                {"bytes": size, "crc32c": integrity.crc32c_file(path)})
            self.bytes += size
        except OSError as e:
            # the replay cache was already self-degrading (a failed
            # capture just means stage 2 re-parses from FASTQ); a full
            # disk additionally records the ladder event so the run's
            # telemetry shows WHY the capture vanished
            if resources.is_enospc(e):
                resources.degrade("replay.cache", e, path=path)
            self.abort()
            return
        self.n += 1
        if self.bytes > self.cap_bytes:
            self.abort()

    def abort(self) -> None:
        self.ok = False
        self.cache.clear()

    def finish(self) -> bool:
        """Commit: the manifest is written only when every batch is on
        disk (atomic_write = the commit point)."""
        if not self.ok:
            return False
        committed = False
        with resources.guard("replay.cache",
                             path=self.cache.manifest_path):
            atomic_write(self.cache.manifest_path, json.dumps(
                integrity.seal({
                    "format": REPLAY_FORMAT,
                    "identity": self.identity,
                    "n_batches": self.n,
                    "bytes": self.bytes,
                    "payloads": self.payloads,
                })) + "\n")
            committed = True
        if not committed:  # ENOSPC degraded the writer mid-commit
            self.abort()
        return committed


class _ReplayReader:
    def __init__(self, cache: ReplayCache, n: int,
                 payloads: list | None = None):
        self.cache = cache
        self.n_batches = n
        self.payloads = payloads

    def _check_batch(self, i: int, path: str) -> None:
        """Verify batch `i` against the manifest's digest before it
        is decoded — a corrupted capture must refuse (CheckpointError
        → rc 3), never feed damaged reads into stage 2."""
        if not self.payloads or i >= len(self.payloads):
            return  # an old JAX capture: no digests recorded
        want = self.payloads[i]
        size = os.path.getsize(path)
        if size != int(want.get("bytes", -1)):
            raise CheckpointError(
                f"replay-cache batch '{path}' is {size} bytes but the "
                f"manifest recorded {want.get('bytes')}; the capture "
                "is damaged — delete the replay directory to re-parse")
        got = integrity.crc32c_file(path)
        if got != int(want.get("crc32c", -1)):
            integrity.record_error(
                f"replay-cache batch '{path}': digest mismatch "
                f"(crc32c {got:#010x} != manifest "
                f"{int(want.get('crc32c', -1)):#010x})",
                path=path, section="batch", offset=0)
            raise CheckpointError(
                f"replay-cache batch '{path}' failed its digest "
                f"(crc32c {got:#010x} != manifest "
                f"{int(want.get('crc32c', -1)):#010x}); refusing to "
                "replay corrupted reads — delete the replay "
                "directory to re-parse from FASTQ")
        integrity.record_verified(size)

    def batches(self):
        """Fresh lazy iterator of (ReadBatch, PackedReads) pairs."""
        from . import fastq, packing

        def gen():
            for i in range(self.n_batches):
                self._check_batch(i, self.cache._batch_path(i))
                with np.load(self.cache._batch_path(i),
                             allow_pickle=False) as z:
                    pk = packing.from_wire(
                        z["pk_wire"], int(z["pk_b"]), int(z["pk_length"]),
                        [int(t) for t in z["pk_thresholds"]])
                    batch = fastq.ReadBatch(
                        codes=z["codes"], quals=None,
                        lengths=z["lengths"],
                        headers=[str(h) for h in z["headers"]],
                        n=int(z["n"]))
                yield batch, pk
        return gen()
