"""The reference's `binary/quorum_db` database, read and written
(counterpart of quorum_tpu/io/quorum_db.py; stage 1 writes it with
`--ref-format`).

A Jellyfish `file_header` (JSON, io/ref_db) followed by two raw planes
(`hash_with_quality::write`, mer_database.hpp:115-126):

* keys: an offsets-packed open-addressing table whose field per slot
  is ((M.key >> lsize) << obits) | (reprobe index + 1), 0 = empty, for
  a GF(2) hash matrix M from the header; the key is recovered as
  M^-1 . ((high << lsize) | home), home = (slot - reprobes[i]) mod size;
  fields of kb = key_len - lsize + obits bits are packed consecutively
  across little-endian u64 words;
* vals: (bits + 1)-bit fields, floor(64 / (bits + 1)) to a u64 word.

Every geometry comes from the header. The layout is the JAX package's
codec: validated there by round trip and header byte counts, not
against a Jellyfish-built file.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from . import integrity, ref_db
from .integrity import IntegrityError

REF_FORMAT = ref_db.REF_FORMAT
DEFAULT_MAX_REPROBE = 126


def _reprobes(max_reprobe: int) -> list[int]:
    return [i * (i + 1) // 2 for i in range(max_reprobe + 1)]


def _gf2_invert(rows: list[int], n: int) -> list[int] | None:
    """Invert an n x n GF(2) matrix given as n row bitmasks (bit j =
    column j). Returns the inverse's rows, or None if singular."""
    a = list(rows)
    inv = [1 << i for i in range(n)]
    for col in range(n):
        piv = next((r for r in range(col, n) if (a[r] >> col) & 1), None)
        if piv is None:
            return None
        a[col], a[piv] = a[piv], a[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        for r in range(n):
            if r != col and (a[r] >> col) & 1:
                a[r] ^= a[col]
                inv[r] ^= inv[col]
    return inv


# elements a pass of the host decode and hash works on (its temporaries
# stay in the core's cache)
_CHUNK = 1 << 16


def _matrix_tables(rows: list[int]) -> np.ndarray:
    """The GF(2) product M . key is linear in the key, so it is the XOR
    of one 256-entry table a key byte: tables[j, b] = M . (b << 8j)."""
    b = np.arange(256, dtype=np.uint64)
    tables = np.zeros((-(-len(rows) // 8), 256), np.uint64)
    for j in range(tables.shape[0]):
        for r, row in enumerate(rows):
            x = b & np.uint64((row >> (8 * j)) & 0xFF)
            for s in (4, 2, 1):
                x ^= x >> np.uint64(s)
            tables[j] |= (x & np.uint64(1)) << np.uint64(r)
    return tables


def _apply_matrix(rows: list[int], keys: np.ndarray) -> np.ndarray:
    """M . key over GF(2) for a uint64 vector: output bit r is the
    parity of key & rows[r]."""
    return _apply_tables(_matrix_tables(rows), keys)


def _apply_tables(tables: np.ndarray, keys: np.ndarray) -> np.ndarray:
    out = np.zeros(len(keys), np.uint64)
    for a in range(0, len(keys), _CHUNK):
        k = keys[a:a + _CHUNK]
        o = out[a:a + _CHUNK]
        for j, table in enumerate(tables):
            o ^= table[((k >> np.uint64(8 * j)) & np.uint64(0xFF))
                       .astype(np.intp)]
    return out


def make_matrix(key_len: int, seed: int = 0x5EED) -> tuple[list[int],
                                                           list[int]]:
    """A random invertible key_len x key_len GF(2) matrix (rows as ints)
    and its inverse, the same for the same (key_len, seed)."""
    rng = np.random.default_rng(seed + key_len)
    while True:
        rows = [int.from_bytes(rng.bytes(8), "little")
                & ((1 << key_len) - 1) for _ in range(key_len)]
        inv = _gf2_invert(rows, key_len)
        if inv is not None:
            return rows, inv


def _or_runs(words: np.ndarray, wi: np.ndarray, vals: np.ndarray) -> None:
    """words[wi[i]] |= vals[i] for every i, where wi never decreases
    (np.bitwise_or.at's result, one reduce a run of equal indices)."""
    if not len(wi):
        return
    starts = np.flatnonzero(np.r_[True, wi[1:] != wi[:-1]])
    words[wi[starts]] |= np.bitwise_or.reduceat(vals, starts)


def _pack_fields(fields: np.ndarray, width: int) -> np.ndarray:
    """Pack uint64 `fields` of `width` bits consecutively into
    little-endian uint64 words (a field may straddle two words)."""
    n = len(fields)
    nwords = -(-n * width // 64)
    words = np.zeros(nwords + 1, np.uint64)  # room for the last spill
    bitpos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    wi = (bitpos >> np.uint64(6)).astype(np.int64)
    sh = bitpos & np.uint64(63)
    _or_runs(words, wi, fields << sh)
    # the spill shift in two steps, so that no shift by 64 happens
    _or_runs(words, wi + 1,
             (fields >> np.uint64(1)) >> (np.uint64(63) - sh))
    return words[:nwords]


def _key_bytes(size: int, kb: int) -> int:
    return (-(-size * kb // 64)) * 8


def _val_geometry(size: int, vbits: int) -> tuple[int, int]:
    """(fields a u64 word, value plane bytes)."""
    per_word = 64 // vbits
    return per_word, -(-size // per_word) * 8


def write_ref_db(path: str, khi, klo, vals, k: int, bits: int,
                 max_reprobe: int = DEFAULT_MAX_REPROBE,
                 cmdline=None, min_fill: float = 0.8) -> None:
    """Write (canonical key, value word) entries as a binary/quorum_db
    file. Each key is placed by quadratic probing from its GF(2)-hashed
    address, the first of the keys claiming a free slot in a probe round
    taking it; the table doubles until every key places within
    `max_reprobe` probes."""
    keys = ((np.asarray(khi, np.uint64) << np.uint64(32))
            | np.asarray(klo, np.uint64))
    vals = np.asarray(vals, np.uint64)
    n = len(keys)
    key_len = 2 * k
    rows, _inv = make_matrix(key_len)
    reprobes = _reprobes(max_reprobe)
    hashed = _apply_matrix(rows, keys)

    lsize = max(4, math.ceil(math.log2(max(1, n) / min_fill)))
    while True:
        size = 1 << lsize
        home = (hashed & np.uint64(size - 1)).astype(np.int64)
        slot_of = np.full(n, -1, np.int64)
        o_of = np.zeros(n, np.int64)
        occupied = np.zeros(size, bool)
        pending = np.arange(n)
        for o, rp in enumerate(reprobes):
            if not len(pending):
                break
            s = (home[pending] + rp) & (size - 1)
            free = ~occupied[s]
            cand = pending[free]
            # the claimed slots, each with its first claimer (a stable
            # sort: np.unique(..., return_index=True))
            cs, order = (x.numpy() for x in torch.sort(
                torch.from_numpy(s[free]), stable=True))
            head = np.ones(len(cs), bool)
            head[1:] = cs[1:] != cs[:-1]
            uniq = cs[head]
            winners = cand[order[head]]
            occupied[uniq] = True
            slot_of[winners] = uniq
            o_of[winners] = o
            pending = pending[slot_of[pending] < 0]
        if not len(pending):
            break
        lsize += 1  # a key found no slot within the reprobe limit

    obits = (max_reprobe + 1).bit_length()
    kb = key_len - lsize + obits
    if kb <= 0:
        raise ValueError("table size exceeds key information content")
    fields = np.zeros(size, np.uint64)
    fields[slot_of] = ((hashed >> np.uint64(lsize)) << np.uint64(obits)) \
        | (o_of.astype(np.uint64) + np.uint64(1))
    key_words = _pack_fields(fields, kb)
    kbytes = _key_bytes(size, kb)

    vbits = bits + 1
    per_word, vbytes = _val_geometry(size, vbits)
    vfields = np.zeros(vbytes // 8 * per_word, np.uint64)
    vfields[slot_of] = vals & np.uint64((1 << vbits) - 1)
    vsh = np.arange(per_word, dtype=np.uint64) * np.uint64(vbits)
    val_words = np.bitwise_or.reduce(
        vfields.reshape(-1, per_word) << vsh, axis=1)

    header = {
        "format": REF_FORMAT,
        "size": size,
        "key_len": key_len,
        "val_len": 0,
        "max_reprobe": max_reprobe,
        "reprobes": reprobes,
        "matrix": {"r": key_len, "c": key_len, "rows": rows},
        "bits": bits,
        "key_bytes": kbytes,
        "value_bytes": vbytes,
        "alignment": 8,
        "cmdline": list(cmdline) if cmdline else [],
        "hostname": os.uname().nodename,
    }
    kw = key_words.tobytes()
    # a sibling file renamed over the target: a failed write never
    # leaves a torn database, and the payload is streamed, not joined
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(json.dumps(header).encode())
        f.write(kw)
        f.write(b"\0" * (kbytes - len(kw)))
        f.write(val_words.astype("<u8").tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    integrity.fsync_dir(path)


def _unpack_fields(words: np.ndarray, a: int, b: int,
                   width: int) -> np.ndarray:
    """Fields a..b-1 of `width` bits packed across little-endian u64
    `words` (which end with one spare zero word)."""
    bitpos = np.arange(a, b, dtype=np.uint64) * np.uint64(width)
    wi = (bitpos >> np.uint64(6)).astype(np.int64)
    sh = bitpos & np.uint64(63)
    lo = words[wi] >> sh
    # the spill shift in two steps, so that no shift by 64 happens
    hi = (words[wi + 1] << np.uint64(1)) << (np.uint64(63) - sh)
    return (lo | hi) & np.uint64((1 << width) - 1)


def read_ref_db(path: str):
    """Decode a binary/quorum_db file. Returns (khi u32[N], klo u32[N],
    vals u32[N], k, bits)."""
    with open(path, "rb") as f:
        data = f.read()
    header, off = ref_db.parse_jf_header(data)
    if header.get("format") != REF_FORMAT:
        raise ValueError(f"'{path}': format '{header.get('format')}' is "
                         f"not '{REF_FORMAT}'")
    size = int(header["size"])
    key_len = int(header["key_len"])
    bits = int(header["bits"])
    max_reprobe = int(header.get("max_reprobe", DEFAULT_MAX_REPROBE))
    reprobes = [int(x) for x in header.get("reprobes",
                                           _reprobes(max_reprobe))]
    kbytes = int(header["key_bytes"])
    vbytes = int(header["value_bytes"])
    rows = [int(r) for r in (header.get("matrix") or {}).get("rows", [])]
    if len(rows) != key_len:
        raise ValueError(f"'{path}': matrix is {len(rows)} rows, need "
                         f"{key_len}")
    inv = _gf2_invert(rows, key_len)
    if inv is None:
        raise ValueError(f"'{path}': hash matrix is singular")
    lsize = size.bit_length() - 1
    if (1 << lsize) != size:
        raise ValueError(f"'{path}': size {size} is not a power of two")
    obits = (max_reprobe + 1).bit_length()
    kb = key_len - lsize + obits
    exp_kbytes = _key_bytes(size, kb)
    per_word, exp_vbytes = _val_geometry(size, bits + 1)
    if kbytes != exp_kbytes or vbytes != exp_vbytes:
        raise ValueError(
            f"'{path}': payload geometry mismatch (key {kbytes} vs "
            f"{exp_kbytes} expected, value {vbytes} vs {exp_vbytes})")
    if len(data) < off + kbytes + vbytes:
        raise integrity.record_error(
            f"'{path}': truncated payload ({len(data) - off} of "
            f"{kbytes + vbytes} payload bytes)", path=path,
            section="payload", offset=off)

    words = np.concatenate([np.frombuffer(data, np.uint64, kbytes // 8, off),
                            np.zeros(1, np.uint64)])
    val_words = np.frombuffer(data, np.uint64, vbytes // 8, off + kbytes)
    tables = _matrix_tables(inv)
    rp = np.asarray(reprobes, np.int64)
    vbits = np.uint64(bits + 1)
    parts = []
    # a slot range at a time: decode the fields, recover each occupied
    # slot's key as M^-1 . ((high << lsize) | home) and read its value
    for a in range(0, size, _CHUNK):
        fields = _unpack_fields(words, a, min(size, a + _CHUNK), kb)
        occ = np.nonzero(fields)[0]
        fld = fields[occ]
        occ += a
        o_of = (fld & np.uint64((1 << obits) - 1)).astype(np.int64) - 1
        if o_of.size and o_of.max() >= len(reprobes):
            raise ValueError(f"'{path}': reprobe index out of range")
        home = (occ - rp[o_of]) & (size - 1)
        keys = _apply_tables(tables, ((fld >> np.uint64(obits))
                                      << np.uint64(lsize))
                             | home.astype(np.uint64))
        vals = ((val_words[occ // per_word]
                 >> ((occ % per_word).astype(np.uint64) * vbits))
                & np.uint64((1 << (bits + 1)) - 1))
        parts.append(((keys >> np.uint64(32)).astype(np.uint32),
                      (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                      vals.astype(np.uint32)))
    khi, klo, vals = (np.concatenate([p[i] for p in parts])
                      if parts else np.zeros(0, np.uint32)
                      for i in range(3))
    return khi, klo, vals, key_len // 2, bits


def verify_ref_db(path: str) -> list[tuple]:
    """The checks the digest-less format allows (header geometry and a
    full decode). Returns (section, offset, message) problems; empty =
    as clean as the format can prove."""
    try:
        read_ref_db(path)
    except IntegrityError as e:
        return [(e.section or "payload", e.offset, str(e))]
    except (ValueError, OSError) as e:
        return [("header", None, str(e))]
    return []


def is_ref_db(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(1 << 16)
        header, _ = ref_db.parse_jf_header(head)
        return header.get("format") == REF_FORMAT
    except (OSError, ref_db.RefHeaderError):
        return False
