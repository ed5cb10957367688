"""On-disk mer database, single-file v4/v5 (counterpart of
quorum_tpu/io/db_format.py; files are interchangeable both ways).

A JSON header line, then the v4 payload — per-row occupancy counts
(u8[rows]), the occupied entries' lo words (LE u32) in canonical
row-major order, then `hi_bytes` byte planes of their hi words. v5 adds
per-section CRC32C digests to the header and a trailer line carrying the
header's and the whole file's digests; the payload bytes are the same.
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

from ..ops import ctable
from ..ops.ctable import TileMeta, TileState
from . import integrity
from .integrity import IntegrityError

FORMAT = "binary/quorum_tpu_db"
TRAILER_FORMAT = "quorum_tpu_db_trailer/1"
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


def write_db(path: str, state: TileState, meta: TileMeta,
             cmdline: list[str] | None = None, n_entries: int | None = None,
             db_version: int = DEFAULT_DB_VERSION,
             extra_header: dict | None = None) -> None:
    """Export the sealed table (K8 on its device, one D2H) as a v4 or
    v5 file, atomically (tmp, fsync, rename). `extra_header` merges
    into the header (a prefiltered build's `prefilter` declaration and
    full-table `poisson_stats`); the payload bytes do not change."""
    if db_version not in (4, 5):
        raise ValueError(f"db_version must be 4 or 5, got {db_version}")
    buf = ctable.tile_export_v4(state, meta)
    n = int(buf[:meta.rows].sum(dtype=np.int64))
    if n_entries is not None and n_entries != n:
        raise RuntimeError(f"export holds {n} entries, seal counted "
                           f"{n_entries}")
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
    trailer = b""
    if db_version >= 5:
        cks, payload_crc = _v5_checksums(buf, meta.rows)
        header["checksum"] = cks
    line = json.dumps(header).encode() + b"\n"
    if db_version >= 5:
        hcrc = integrity.crc32c(line)
        fcrc = integrity.crc32c_combine(hcrc, payload_crc, int(buf.nbytes))
        trailer = (json.dumps({"format": TRAILER_FORMAT,
                               "header_crc32c": hcrc,
                               "file_crc32c": fcrc}) + "\n").encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(line)
        f.write(buf.tobytes())
        f.write(trailer)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    integrity.fsync_dir(path)


def read_header(path: str) -> dict:
    with open(path, "rb") as f:
        line = f.readline(1 << 20)
    try:
        header = json.loads(line)
    except ValueError:
        raise ValueError(
            f"'{path}' is not a quorum_tpu database (no JSON header)"
        ) from None
    if not isinstance(header, dict) or header.get("format") != FORMAT:
        fmt = header.get("format") if isinstance(header, dict) else None
        raise ValueError(f"Wrong type '{fmt}' for file '{path}'")
    return header


def _verify_v5(path: str, header: dict, offset: int, mode: str) -> None:
    """Check a v5 file's digests: "full" every section plus the derived
    whole-file digest, "sample" the header, the bucket index and a
    random subset of entry chunks. Raises IntegrityError."""
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


def _read_payload(path: str, offset: int, rows_n: int, n: int,
                  hi_bytes: int) -> np.ndarray:
    """One v4/v5 payload as raw bytes, after its structural refusals
    (size, at most 64 entries a row, counts summing to n_entries)."""
    count = rows_n + (4 + hi_bytes) * n
    with open(path, "rb") as f:
        f.seek(offset)
        payload = np.fromfile(f, np.uint8, count)
    if payload.shape[0] != count:
        raise IntegrityError(f"corrupt database '{path}': payload "
                             "truncated", path=path, section="entries",
                             offset=offset)
    counts = payload[:rows_n]
    if n and int(counts.max()) > ctable.TSLOTS:
        raise IntegrityError(
            f"corrupt database '{path}': {int(counts.max())} entries in "
            f"one bucket (capacity {ctable.TSLOTS})", path=path,
            section="bucket_index", offset=offset)
    if int(counts.sum(dtype=np.int64)) != n:
        raise IntegrityError(
            f"corrupt database '{path}': row counts sum "
            f"{int(counts.sum(dtype=np.int64))} != n_entries {n}",
            path=path, section="bucket_index", offset=offset)
    return payload


def load_db(path: str, device="cpu", verify: str = "full"):
    """Load a single-file v4/v5 database onto `device`. Returns
    (TileState, TileMeta, header, (n_occupied, distinct_hq, total_hq));
    the header carries a prefiltered build's `prefilter` and
    `poisson_stats`.
    v5 digests and the payload's structure are checked on the host
    BEFORE any byte reaches the device; then the raw payload crosses
    once and HK7 decodes and places it there."""
    if verify not in VERIFY_MODES:
        raise ValueError(f"verify must be one of {VERIFY_MODES}, "
                         f"got {verify!r}")
    header = read_header(path)
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
    state, stats = ctable.tile_load(payload, meta, n, device)
    return state, meta, header, stats


def db_payload_bytes(path: str) -> bytes:
    """Exactly the table payload of a database file (what byte-parity
    checks compare; the header is timestamped)."""
    with open(path, "rb") as f:
        header = json.loads(f.readline(1 << 20))
        return f.read(int(header["value_bytes"]))
