"""On-disk mer database: single-file v4/v5 and the sharded manifest
(counterpart of quorum_tpu/io/db_format.py; files are interchangeable
both ways).

A JSON header line, then the v4 payload — per-row occupancy counts
(u8[rows]), the occupied entries' lo words (LE u32) in canonical
row-major order, then `hi_bytes` byte planes of their hi words. v5 adds
per-section CRC32C digests to the header and a trailer line carrying the
header's and the whole file's digests; the payload bytes are the same.

A sharded database is a sealed manifest at PREFIX naming S shard files
``PREFIX.shard-s-of-S.qdb``: shard s is a self-contained v4/v5 file of
the global rows [s * rows / S, (s + 1) * rows / S) at the global
geometry (`layout: shard`), and the manifest carries each shard's
whole-file digest. The shards' counts planes, then their lo words, then
each hi byte plane, concatenated in shard order, are the single-file
payload. The partitioned build (--partitions P) writes one shard a
pass; --db-layout sharded on one card writes a 1-shard manifest.
"""

from __future__ import annotations

import getpass
import json
import os
import random
import socket
import time

import numpy as np
import torch

from .. import kernels
from ..ops import ctable
from ..ops.ctable import GlobalMeta, TileMeta, TileState
from . import integrity, quorum_db
from .integrity import IntegrityError

FORMAT = "binary/quorum_tpu_db"
TRAILER_FORMAT = "quorum_tpu_db_trailer/1"
MANIFEST_FORMAT = "binary/quorum_tpu_db_manifest"
DB_LAYOUTS = ("single", "sharded")
DEFAULT_DB_VERSION = 5
CHECKSUM_CHUNK_BYTES = 4 << 20
VERIFY_MODES = ("full", "sample", "off")


def tile_state_from_numpy(rows_u32: np.ndarray, k: int, bits: int,
                          rb_log2: int, device) -> tuple[TileState, TileMeta]:
    """The JAX package's sealed tile rows (the [rows, 128] uint32 plane
    of ctable.TileState, as numpy) plus its TileMeta fields -> the
    port's table on `device`."""
    meta = TileMeta(k=k, bits=bits, rb_log2=rb_log2)
    rows = np.ascontiguousarray(rows_u32, np.uint32)
    if rows.shape != (meta.rows, ctable.TILE):
        raise ValueError(f"rows shape {rows.shape} != ({meta.rows}, "
                         f"{ctable.TILE})")
    return TileState(torch.from_numpy(rows.view(np.int32).copy())
                     .to(device)), meta


def _header_common(cmdline):
    return {
        "cmdline": cmdline or [],
        "hostname": socket.gethostname(),
        "pwd": os.getcwd(),
        "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "user": getpass.getuser(),
    }


def _v5_checksums(buf: np.ndarray, rows_n: int) -> tuple[dict, int]:
    counts_crc = integrity.crc32c(buf[:rows_n])
    entries = buf[rows_n:]
    e_len = int(entries.shape[0])
    chunk = CHECKSUM_CHUNK_BYTES
    chunks = [integrity.crc32c(entries[i:i + chunk])
              for i in range(0, e_len, chunk)]
    entries_crc = 0
    for i, c in enumerate(chunks):
        entries_crc = integrity.crc32c_combine(
            entries_crc, c, min(chunk, e_len - i * chunk))
    payload_crc = integrity.crc32c_combine(counts_crc, entries_crc, e_len)
    return {
        "algo": "crc32c",
        "chunk_bytes": chunk,
        "sections": {
            "bucket_index": {"offset": 0, "length": rows_n,
                             "crc32c": counts_crc},
            "entries": {"offset": rows_n, "length": e_len,
                        "crc32c": entries_crc, "chunks": chunks},
        },
    }, payload_crc


def _atomic_write(path: str, line: bytes, payload: bytes,
                  trailer: bytes = b"") -> None:
    """tmp, fsync, rename, fsync the directory: a killed run never
    leaves a torn file at `path`."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(line)
        f.write(payload)
        f.write(trailer)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    integrity.fsync_dir(path)


def _write_payload_file(path: str, header: dict, buf: np.ndarray,
                        rows_n: int, db_version: int) -> int:
    """Write one v4/v5 file (header line, payload `buf` of rows_n
    counts, and for v5 the section digests and the trailer). Returns
    its whole-file CRC32C (header line + payload), as a manifest
    records it."""
    if db_version >= 5:
        cks, payload_crc = _v5_checksums(buf, rows_n)
        header["checksum"] = cks
    else:
        payload_crc = integrity.crc32c(buf)
    line = json.dumps(header).encode() + b"\n"
    hcrc = integrity.crc32c(line)
    fcrc = integrity.crc32c_combine(hcrc, payload_crc, int(buf.nbytes))
    trailer = b""
    if db_version >= 5:
        trailer = (json.dumps({"format": TRAILER_FORMAT,
                               "header_crc32c": hcrc,
                               "file_crc32c": fcrc}) + "\n").encode()
    _atomic_write(path, line, buf.tobytes(), trailer)
    return fcrc


def _check_version(db_version: int) -> None:
    if db_version not in (4, 5):
        raise ValueError(f"db_version must be 4 or 5, got {db_version}")


def write_db(path: str, state: TileState, meta: TileMeta,
             cmdline: list[str] | None = None, n_entries: int | None = None,
             db_version: int = DEFAULT_DB_VERSION,
             extra_header: dict | None = None) -> None:
    """Export the sealed table (K8 on its device, one D2H) as a v4 or
    v5 file, atomically (tmp, fsync, rename). `n_entries`, where the
    caller holds it (the seal's occupied count), lets the export read the
    table once; a table that holds another number raises RuntimeError
    and writes nothing. `extra_header` merges into the header (a
    prefiltered build's `prefilter` declaration and full-table
    `poisson_stats`); the payload bytes do not change."""
    _check_version(db_version)
    buf = ctable.tile_export_v4(state, meta, n_entries)
    n = int(buf[:meta.rows].sum(dtype=np.int64))
    header = {
        "format": FORMAT,
        "version": db_version,
        "key_len": 2 * meta.k,
        "bits": meta.bits,
        "rb_log2": meta.rb_log2,
        "rows": meta.rows,
        "n_entries": n,
        "hi_bytes": meta.hi_bytes,
        "value_bytes": int(buf.nbytes),
        **(extra_header or {}),
        **_header_common(cmdline),
    }
    _write_payload_file(path, header, buf, meta.rows, db_version)


def shard_file_name(prefix: str, shard: int, n_shards: int) -> str:
    """The on-disk name of one shard of a sharded database."""
    return f"{prefix}.shard-{shard}-of-{n_shards}.qdb"


def write_db_shard_file(path_prefix: str, rows_s: torch.Tensor,
                        meta: GlobalMeta, s: int, S: int,
                        cmdline: list[str] | None = None,
                        db_version: int = DEFAULT_DB_VERSION,
                        n_entries: int | None = None) -> dict:
    """Write shard `s` of S: `rows_s`, the sealed rows [s * rows / S,
    (s + 1) * rows / S) of the GLOBAL geometry `meta` (a partition
    pass's rows after HK13, or a card's whole table when S = 1),
    exported by HK6 on their device into ``PREFIX.shard-s-of-S.qdb``, a
    self-contained v4/v5 file; `n_entries` as for write_db, the shard's
    own. Returns the manifest record."""
    _check_version(db_version)
    rows_local = meta.rows // S
    if rows_s.shape[0] != rows_local:
        raise ValueError(f"shard {s} of {S} holds {rows_s.shape[0]} rows, "
                         f"not {rows_local}")
    buf = ctable.tile_export_v4(TileState(rows_s), meta, n_entries)
    occ = int(buf[:rows_local].sum(dtype=np.int64))
    shard_path = shard_file_name(path_prefix, s, S)
    header = {
        "format": FORMAT,
        "version": db_version,
        "layout": "shard",
        "shard": s,
        "n_shards": S,
        "key_len": 2 * meta.k,
        "bits": meta.bits,
        "rb_log2": meta.rb_log2,  # GLOBAL geometry
        "rows": meta.rows,
        "rows_local": rows_local,
        "n_entries": occ,
        "hi_bytes": meta.hi_bytes,
        "value_bytes": int(buf.nbytes),
        **_header_common(cmdline),
    }
    fcrc = _write_payload_file(shard_path, header, buf, rows_local,
                               db_version)
    return {"path": os.path.basename(shard_path), "shard": s,
            "n_entries": occ, "value_bytes": int(buf.nbytes),
            "file_crc32c": fcrc}


def write_db_manifest(path: str, recs: list, meta: GlobalMeta, S: int,
                      cmdline: list[str] | None = None,
                      db_version: int = DEFAULT_DB_VERSION,
                      extra_header: dict | None = None) -> None:
    """Commit the sealed manifest over `recs` (write_db_shard_file
    records, in shard order): every shard file is durable already, and
    the manifest's rename is the commit point. `extra_header` (the
    prefilter declaration and poisson_stats) merges into the sealed
    document, which load_db returns as the header."""
    manifest = integrity.seal({
        "format": MANIFEST_FORMAT,
        "version": db_version,
        "layout": "sharded",
        "key_len": 2 * meta.k,
        "bits": meta.bits,
        "rb_log2": meta.rb_log2,
        "rows": meta.rows,
        "n_shards": S,
        "n_entries": sum(int(r["n_entries"]) for r in recs),
        "hi_bytes": meta.hi_bytes,
        "shards": recs,
        **(extra_header or {}),
        **_header_common(cmdline),
    })
    _atomic_write(path, json.dumps(manifest).encode() + b"\n", b"")


def write_db_sharded(path: str, state, meta: GlobalMeta,
                     cmdline: list[str] | None = None,
                     db_version: int = DEFAULT_DB_VERSION,
                     extra_header: dict | None = None,
                     n_entries: list | None = None) -> None:
    """`--db-layout sharded`: one shard file per shard of a row-sharded
    table (a ShardedTileState under its TileShardedMeta, --devices N),
    each exported by HK6's row-range entry on its own device, with no
    gather; or one card's table as a 1-shard manifest. `n_entries`, where
    the caller holds them, are the shards' entries (HK2's occupied count
    of each), as for write_db. Then the sealed manifest at `path`; its
    payload (db_payload_bytes) is the single file's."""
    _check_version(db_version)
    from ..kernels import device_scope

    shards = (state.shards if isinstance(state, ctable.ShardedTileState)
              else (state.rows,))
    S = len(shards)
    if n_entries is not None and len(n_entries) != S:
        raise ValueError(f"{len(n_entries)} entry counts for {S} shards")
    recs = []
    for s, rows in enumerate(shards):
        with device_scope(rows.device):
            recs.append(write_db_shard_file(
                path, rows, meta, s, S, cmdline, db_version,
                None if n_entries is None else n_entries[s]))
    write_db_manifest(path, recs, meta, S, cmdline, db_version, extra_header)


def read_header(path: str) -> dict:
    with open(path, "rb") as f:
        line = f.readline(1 << 20)
    try:
        header = json.loads(line)
    except ValueError:
        raise ValueError(
            f"'{path}' is not a quorum_tpu database (no JSON header)"
        ) from None
    if not isinstance(header, dict) \
            or header.get("format") not in (FORMAT, MANIFEST_FORMAT):
        fmt = header.get("format") if isinstance(header, dict) else None
        raise ValueError(f"Wrong type '{fmt}' for file '{path}'")
    return header


def header_rb_log2(path: str) -> int | None:
    """The table geometry (rb_log2) a database file or manifest declares
    in its header, or None for a reference `binary/quorum_db` file
    (whose geometry comes from its entries at load)."""
    if quorum_db.is_ref_db(path):
        return None
    return int(read_header(path)["rb_log2"])


def _verify_v5(path: str, header: dict, offset: int, mode: str) -> dict:
    """Check a v5 file's digests: "full" every section plus the derived
    whole-file digest, "sample" the header, the bucket index and a
    random subset of entry chunks. Raises IntegrityError; returns the
    trailer."""
    def bad(section, off, msg):
        raise IntegrityError(f"v5 database '{path}': {msg}", path=path,
                             section=section, offset=off)

    cks = header.get("checksum") or {}
    sections = cks.get("sections") or {}
    bi = sections.get("bucket_index") or {}
    en = sections.get("entries") or {}
    if cks.get("algo") != "crc32c" or not bi or not en:
        bad("header", 0, "header carries no usable checksum section")
    bi_len, e_len = int(bi["length"]), int(en["length"])
    payload_len = bi_len + e_len
    with open(path, "rb") as f:
        line = f.readline(1 << 20)
        f.seek(offset)
        payload = np.frombuffer(f.read(payload_len), np.uint8)
        trailer_line = f.readline(1 << 20)
    try:
        trailer = json.loads(trailer_line)
    except ValueError:
        trailer = None
    if not isinstance(trailer, dict) \
            or trailer.get("format") != TRAILER_FORMAT:
        bad("trailer", offset + payload_len, "no valid trailer "
            "(truncated or overwritten file)")
    hcrc = integrity.crc32c(line)
    if hcrc != int(trailer.get("header_crc32c", -1)):
        bad("header", 0, "header digest mismatch")
    if payload.shape[0] != payload_len:
        bad("entries", offset, "payload truncated")
    if integrity.crc32c(payload[:bi_len]) != int(bi.get("crc32c", -1)):
        bad("bucket_index", offset, "bucket index digest mismatch")
    chunk = int(cks.get("chunk_bytes", CHECKSUM_CHUNK_BYTES))
    chunks = list(en.get("chunks", []))
    if len(chunks) != (-(-e_len // chunk) if e_len else 0):
        bad("entries", offset + bi_len, "wrong number of chunk digests")
    idxs = list(range(len(chunks)))
    if mode == "sample" and len(chunks) > 4:
        idxs = sorted(random.Random().sample(idxs, max(4, len(idxs) // 16)))
    entries = payload[bi_len:]
    for i in idxs:
        lo, hi = i * chunk, min((i + 1) * chunk, e_len)
        if integrity.crc32c(entries[lo:hi]) != int(chunks[i]):
            bad("entries", offset + bi_len + lo,
                f"entry chunk {i} digest mismatch")
    if mode == "full":
        ecrc = 0
        for i, c in enumerate(chunks):
            ecrc = integrity.crc32c_combine(ecrc, int(c),
                                            min(chunk, e_len - i * chunk))
        if ecrc != int(en.get("crc32c", -1)):
            bad("entries", offset + bi_len,
                "entries section digest disagrees with its chunks")
        pcrc = integrity.crc32c_combine(int(bi["crc32c"]), ecrc, e_len)
        fcrc = integrity.crc32c_combine(hcrc, pcrc, payload_len)
        if fcrc != int(trailer.get("file_crc32c", -1)):
            bad("trailer", offset + payload_len,
                "whole-file digest mismatch")
    return trailer


def _read_payload(path: str, offset: int, rows_n: int, n: int,
                  hi_bytes: int, what: str = "database") -> np.ndarray:
    """One v4/v5 payload as raw bytes, after its structural refusals
    (size, at most 64 entries a row, counts summing to n_entries)."""
    count = rows_n + (4 + hi_bytes) * n
    with open(path, "rb") as f:
        f.seek(offset)
        payload = np.fromfile(f, np.uint8, count)
    if payload.shape[0] != count:
        raise IntegrityError(f"corrupt {what} '{path}': payload "
                             "truncated", path=path, section="entries",
                             offset=offset)
    counts = payload[:rows_n]
    if n and int(counts.max()) > ctable.TSLOTS:
        raise IntegrityError(
            f"corrupt {what} '{path}': {int(counts.max())} entries in "
            f"one bucket (capacity {ctable.TSLOTS})", path=path,
            section="bucket_index", offset=offset)
    if int(counts.sum(dtype=np.int64)) != n:
        raise IntegrityError(
            f"corrupt {what} '{path}': row counts sum "
            f"{int(counts.sum(dtype=np.int64))} != n_entries {n}",
            path=path, section="bucket_index", offset=offset)
    return payload


def _load_manifest(path: str, header: dict, verify: str, on_mesh: bool):
    """A sharded database through its manifest (quorum_tpu's
    _read_db_manifest): the seal, every shard's own digests per
    `verify`, and the manifest's per-shard whole-file digests (a shard
    swapped or regenerated after the commit refuses even with
    consistent digests of its own), then every shard's structure.
    Returns (the single-file payload assembled from the shards on the
    host, its entries, its GlobalMeta). Past rb_log2 24 only a mesh
    load (`on_mesh`) takes it."""
    if verify != "off":
        integrity.check_seal(header, "sharded database manifest", path)
    rb = int(header["rb_log2"])
    S = int(header["n_shards"])
    if rb > 24 and not on_mesh:
        raise ValueError(
            f"sharded database '{path}' has rb_log2={rb}, past the "
            "single-chip geometry cap of 24 — run stage 2 with --devices "
            "N (the routed layout hosts it row-sharded); loading it onto "
            "one chip is not supported")
    meta = GlobalMeta(k=header["key_len"] // 2, bits=header["bits"],
                      rb_log2=rb)
    rows_local = meta.rows // S
    hi_bytes = int(header["hi_bytes"])
    if hi_bytes != meta.hi_bytes:
        raise IntegrityError(
            f"corrupt sharded database manifest '{path}': hi_bytes "
            f"{hi_bytes} != {meta.hi_bytes} for this geometry",
            path=path, section="header", offset=0)
    recs = header.get("shards") or []
    if len(recs) != S:
        raise IntegrityError(
            f"corrupt sharded database manifest '{path}': {len(recs)} "
            f"shard records for n_shards={S}", path=path,
            section="header", offset=0)
    dirn = os.path.dirname(os.path.abspath(path))
    counts, los, his = [], [], [[] for _ in range(hi_bytes)]
    total = 0
    for s, rec in enumerate(recs):
        sp = os.path.join(dirn, str(rec["path"]))
        if not os.path.exists(sp):
            raise IntegrityError(
                f"sharded database '{path}' is missing shard {s} "
                f"('{sp}') — refusing to load a partial table",
                path=sp, section="shard")
        sh = read_header(sp)
        for key, want in (("layout", "shard"), ("shard", s),
                          ("n_shards", S), ("rb_log2", rb),
                          ("key_len", header["key_len"]),
                          ("bits", header["bits"]),
                          ("n_entries", int(rec["n_entries"]))):
            if sh.get(key) != want:
                raise IntegrityError(
                    f"shard file '{sp}' disagrees with the manifest on "
                    f"{key} ({sh.get(key)!r} != {want!r})",
                    path=sp, section="header", offset=0)
        with open(sp, "rb") as f:
            offset = len(f.readline(1 << 20))
        n_s = int(sh["n_entries"])
        if verify != "off":
            if int(sh.get("version", 1)) >= 5:
                got = int(_verify_v5(sp, sh, offset, verify)
                          .get("file_crc32c", -1))
            else:
                got = integrity.crc32c_file(sp)
            if got != int(rec.get("file_crc32c", -2)):
                raise IntegrityError(
                    f"shard file '{sp}' digest {got:#010x} != manifest "
                    f"{int(rec.get('file_crc32c', -1)):#010x} — the "
                    "shard was swapped or regenerated after the "
                    "manifest committed", path=sp, section="shard",
                    offset=0)
        pay = _read_payload(sp, offset, rows_local, n_s, hi_bytes,
                            f"shard {s} of sharded database")
        counts.append(pay[:rows_local])
        los.append(pay[rows_local:rows_local + 4 * n_s])
        base = rows_local + 4 * n_s
        for j in range(hi_bytes):
            his[j].append(pay[base + j * n_s:base + (j + 1) * n_s])
        total += n_s
    if total != int(header.get("n_entries", total)):
        raise IntegrityError(
            f"corrupt sharded database manifest '{path}': shard entries "
            f"sum {total} != n_entries {header.get('n_entries')}",
            path=path, section="header", offset=0)
    payload = np.concatenate(counts + los + [x for pl in his for x in pl])
    return payload, total, meta


def _load_on_mesh(payload: np.ndarray, n: int, gmeta: GlobalMeta, mesh):
    """A checked single-file payload of n entries row-sharded over the
    mesh: shard s's row range of it (its counts, and its entries' lo
    words and hi byte planes) crosses to mesh[s], and HK7's row-range
    load places it there, one launch a shard. Returns (ShardedTileState,
    TileShardedMeta, summed (occupied, distinct_hq, total_hq))."""
    from ..kernels import device_scope
    from ..parallel.tile_sharded import TileShardedMeta

    meta = TileShardedMeta(k=gmeta.k, bits=gmeta.bits,
                           rb_log2=gmeta.rb_log2, n_shards=len(mesh))
    per = 1 << meta.local_rb
    counts = payload[:meta.rows]
    first = np.concatenate([[0], np.cumsum(
        counts.reshape(len(mesh), per).sum(1, dtype=np.int64))])
    lo0, hi0 = meta.rows, meta.rows + 4 * n
    shards, totals = [], np.zeros(3, np.int64)
    for s, dev in enumerate(mesh):
        a, b = int(first[s]), int(first[s + 1])
        sub = np.concatenate(
            [counts[s * per:(s + 1) * per], payload[lo0 + 4 * a:lo0 + 4 * b]]
            + [payload[hi0 + j * n + a:hi0 + j * n + b]
               for j in range(meta.hi_bytes)])
        with device_scope(dev):
            rows, st = kernels.tile_load(torch.from_numpy(sub).to(dev), meta,
                                         b - a, per)
        shards.append(rows)
        totals += st.cpu().numpy()
    return (ctable.ShardedTileState(tuple(shards)), meta,
            tuple(int(x) for x in totals))


def load_db(path: str, device="cpu", verify: str = "full", mesh=None):
    """Load a single-file v4/v5 database, or a sharded one through its
    manifest, onto `device`. Returns (TileState, TileMeta, header,
    (n_occupied, distinct_hq, total_hq)); the header (a manifest's own)
    carries a prefiltered build's `prefilter` and `poisson_stats`.
    Digests and the payload's structure are checked on the host BEFORE
    any byte reaches the device; then the raw payload crosses once and
    HK7 decodes and places it there. A reference `binary/quorum_db` file
    (io/quorum_db) is decoded on the host and placed the same way.

    With `mesh` (a list of devices, --devices N's routed stage-2
    layout) the table is loaded row-sharded instead, shard s of
    len(mesh) on mesh[s] (_load_on_mesh), as (ShardedTileState,
    TileShardedMeta, header, stats); only such a load takes a table past
    rb_log2 24 (a manifest the JAX package or a --devices N build
    wrote)."""
    if verify not in VERIFY_MODES:
        raise ValueError(f"verify must be one of {VERIFY_MODES}, "
                         f"got {verify!r}")
    if mesh is not None and quorum_db.is_ref_db(path):
        raise ValueError(f"'{path}' is a reference quorum_db file; it "
                         "loads onto one device only")
    if quorum_db.is_ref_db(path):
        khi, klo, vals, k, bits = quorum_db.read_ref_db(path)
        state, meta, stats = ctable.tile_from_entries(khi, klo, vals, k,
                                                      bits, device)
        header = {"format": quorum_db.REF_FORMAT, "version": 2,
                  "key_len": 2 * k, "bits": bits, "rb_log2": meta.rb_log2}
        return state, meta, header, stats
    header = read_header(path)
    if header.get("format") == MANIFEST_FORMAT:
        payload, n, gmeta = _load_manifest(path, header, verify,
                                           mesh is not None)
        if mesh is not None:
            state, meta, stats = _load_on_mesh(payload, n, gmeta, mesh)
            return state, meta, header, stats
        meta = TileMeta(k=gmeta.k, bits=gmeta.bits, rb_log2=gmeta.rb_log2)
        state, stats = ctable.tile_load(payload, meta, n, device)
        return state, meta, header, stats
    if header.get("layout") == "shard":
        raise ValueError(
            f"'{path}' is shard {header.get('shard')} of "
            f"{header.get('n_shards')} — load the sharded database "
            "through its manifest (the PREFIX the export wrote)")
    version = header.get("version", 1)
    if version not in (4, 5):
        raise ValueError(f"'{path}': database version {version} is not "
                         "supported (single-file v4/v5 only)")
    with open(path, "rb") as f:
        offset = len(f.readline(1 << 20))
    if version == 5 and verify != "off":
        _verify_v5(path, header, offset, verify)
    meta = TileMeta(k=header["key_len"] // 2, bits=header["bits"],
                    rb_log2=header["rb_log2"])
    if header["hi_bytes"] != meta.hi_bytes:
        raise IntegrityError(
            f"corrupt database '{path}': hi_bytes {header['hi_bytes']} != "
            f"{meta.hi_bytes} for this geometry", path=path,
            section="header", offset=0)
    n = int(header["n_entries"])
    payload = _read_payload(path, offset, meta.rows, n, meta.hi_bytes)
    if mesh is not None:
        state, meta, stats = _load_on_mesh(payload, n, meta, mesh)
        return state, meta, header, stats
    state, stats = ctable.tile_load(payload, meta, n, device)
    return state, meta, header, stats


def db_payload_bytes(path: str) -> bytes:
    """Exactly the table payload of a database file (what byte-parity
    checks compare; the header is timestamped). A sharded manifest
    reassembles the single-file payload from its shards: the counts
    planes, then the lo words, then each hi byte plane, each in shard
    order."""
    with open(path, "rb") as f:
        header = json.loads(f.readline(1 << 20))
        if header.get("format") != MANIFEST_FORMAT:
            return f.read(int(header["value_bytes"]))
    hi_bytes = int(header["hi_bytes"])
    rows_local = int(header["rows"]) // int(header["n_shards"])
    dirn = os.path.dirname(os.path.abspath(path))
    counts, los, his = [], [], [[] for _ in range(hi_bytes)]
    for rec in header.get("shards") or []:
        with open(os.path.join(dirn, str(rec["path"])), "rb") as f:
            sh = json.loads(f.readline(1 << 20))
            pay = f.read(int(sh["value_bytes"]))
        n_s = int(sh["n_entries"])
        counts.append(pay[:rows_local])
        los.append(pay[rows_local:rows_local + 4 * n_s])
        base = rows_local + 4 * n_s
        for j in range(hi_bytes):
            his[j].append(pay[base + j * n_s:base + (j + 1) * n_s])
    return b"".join(counts + los + [x for pl in his for x in pl])
