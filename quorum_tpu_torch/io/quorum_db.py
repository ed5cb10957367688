"""Reader of the reference's `binary/quorum_db` database (counterpart of
the reader half of quorum_tpu/io/quorum_db.py; the writer and stage 1's
`--ref-format` are not ported yet).

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

import numpy as np

from . import ref_db
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


def _apply_matrix(rows: list[int], keys: np.ndarray) -> np.ndarray:
    """M . key over GF(2) for a uint64 vector: output bit r is the
    parity of key & rows[r]."""
    out = np.zeros_like(keys)
    for r, row in enumerate(rows):
        x = keys & np.uint64(row)
        for s in (32, 16, 8, 4, 2, 1):
            x ^= x >> np.uint64(s)
        out |= (x & np.uint64(1)) << np.uint64(r)
    return out


def _unpack_fields(words: np.ndarray, n: int, width: int) -> np.ndarray:
    words = np.concatenate([words, np.zeros(1, np.uint64)])
    bitpos = np.arange(n, dtype=np.uint64) * np.uint64(width)
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
    per_word = 64 // (bits + 1)
    exp_kbytes = -(-size * kb // 64) * 8
    exp_vbytes = -(-size // per_word) * 8
    if kbytes != exp_kbytes or vbytes != exp_vbytes:
        raise ValueError(
            f"'{path}': payload geometry mismatch (key {kbytes} vs "
            f"{exp_kbytes} expected, value {vbytes} vs {exp_vbytes})")
    if len(data) < off + kbytes + vbytes:
        raise IntegrityError(
            f"'{path}': truncated payload ({len(data) - off} of "
            f"{kbytes + vbytes} payload bytes)", path=path,
            section="payload", offset=off)

    fields = _unpack_fields(np.frombuffer(data, np.uint64, kbytes // 8, off),
                            size, kb)
    occ = np.nonzero(fields != 0)[0]
    fld = fields[occ]
    o_of = (fld & np.uint64((1 << obits) - 1)).astype(np.int64) - 1
    if o_of.size and o_of.max() >= len(reprobes):
        raise ValueError(f"'{path}': reprobe index out of range")
    home = (occ - np.asarray(reprobes, np.int64)[o_of]) % size
    hashed = ((fld >> np.uint64(obits)) << np.uint64(lsize)) \
        | home.astype(np.uint64)
    keys = _apply_matrix(inv, hashed)

    val_words = np.frombuffer(data, np.uint64, vbytes // 8, off + kbytes)
    vsh = (occ % per_word * (bits + 1)).astype(np.uint64)
    vals = (val_words[occ // per_word] >> vsh) \
        & np.uint64((1 << (bits + 1)) - 1)
    khi = (keys >> np.uint64(32)).astype(np.uint32)
    klo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return khi, klo, vals.astype(np.uint32), key_len // 2, bits


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
