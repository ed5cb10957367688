"""Jellyfish `binary_dumper` record files, the `jellyfish count` output
the reference takes for `--contaminant` (counterpart of the reader half
of quorum_tpu/io/jf_binary.py).

Layout: a Jellyfish JSON header (io/ref_db), then fixed-size records of
ceil(key_len / 8) key bytes (the 2-bit packed mer, little-endian, base
0 of the mer in the least significant bits, as ops/mer packs it) and
`counter_len` count bytes (little-endian).
"""

from __future__ import annotations

import numpy as np

from . import ref_db

# binary_dumper's tag; accepted spellings across Jellyfish 2.x
FORMATS = ("binary/sorted", "binary/jellyfish", "binary/binary_dumper")


def is_jf_binary(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(1 << 16)
        header, _ = ref_db.parse_jf_header(head)
        return header.get("format") in FORMATS
    except (OSError, ref_db.RefHeaderError):
        return False


def read_jf_binary(path: str):
    """-> (khi u32[N], klo u32[N], counts u64[N], k)."""
    with open(path, "rb") as f:
        data = f.read()
    header, off = ref_db.parse_jf_header(data)
    if header.get("format") not in FORMATS:
        raise ValueError(
            f"'{path}': format '{header.get('format')}' is not a "
            "binary_dumper file")
    key_len = int(header["key_len"])
    if key_len > 64:
        raise ValueError(f"'{path}': key_len {key_len} > 64 unsupported")
    counter_len = int(header.get("counter_len", 4))
    if not 1 <= counter_len <= 8:
        raise ValueError(
            f"'{path}': counter_len {counter_len} outside 1..8")
    kbytes = -(-key_len // 8)
    rec = kbytes + counter_len
    payload = data[off:]
    n = len(payload) // rec
    if n * rec != len(payload):
        raise ValueError(
            f"'{path}': payload size {len(payload)} is not a multiple of "
            f"the record size {rec}")
    raw = np.frombuffer(payload, np.uint8, n * rec).reshape(n, rec)

    def le_int(cols):
        v = np.zeros(n, np.uint64)
        for i in range(cols.shape[1]):
            v |= cols[:, i].astype(np.uint64) << np.uint64(8 * i)
        return v

    keys = le_int(raw[:, :kbytes]) & np.uint64((1 << key_len) - 1)
    counts = le_int(raw[:, kbytes:])
    khi = (keys >> np.uint64(32)).astype(np.uint32)
    klo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return khi, klo, counts, key_len // 2
