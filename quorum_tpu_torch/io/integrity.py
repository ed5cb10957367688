"""CRC-32C digests, sealed JSON documents and the verification
telemetry hook (counterpart of quorum_tpu/io/integrity.py).

`crc32c()` chains like zlib.crc32 (``crc32c(b, crc32c(a)) ==
crc32c(a + b)``); large inputs split into equal chunks whose CRCs run
column-vectorized in numpy and fold with the GF(2) combine operator
(`crc32c_combine`, zlib's crc32_combine construction).

The loaders report what they verified (`integrity_bytes_verified_total`)
and what they refused (`integrity_errors_total`, and an
`integrity_error` event naming file, section and offset) into the run's
registry, installed ambiently by cli/observability.observability().
"""

from __future__ import annotations

import json
import os

import numpy as np

_POLY = np.uint32(0x82F63B78)  # CRC-32C (Castagnoli), reflected
_VECTOR_MIN = 1 << 12


def _make_table() -> np.ndarray:
    crc = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> 1) ^ _POLY, crc >> 1)
    return crc


_TABLE = _make_table()
_TABLE_PY = [int(x) for x in _TABLE]


class IntegrityError(ValueError):
    """An artifact failed checksum verification (deterministic: the CLIs
    map it to the non-retryable rc 3)."""

    def __init__(self, message: str, path: str | None = None,
                 section: str | None = None, offset: int | None = None):
        super().__init__(message)
        self.path = path
        self.section = section
        self.offset = offset


def _as_bytes_view(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.frombuffer(
            memoryview(np.ascontiguousarray(data)).cast("B"), np.uint8)
    return np.frombuffer(memoryview(data).cast("B"), np.uint8)


def _crc_scalar(buf: np.ndarray, c: int) -> int:
    t = _TABLE_PY
    for b in buf.tolist():
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c


def _gf2_times(mat: list[int], vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: list[int]) -> list[int]:
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def _zero_operator(nbytes: int) -> list[int]:
    """The GF(2) matrix advancing a raw CRC register past `nbytes` zero
    bytes."""
    odd = [int(_POLY)] + [1 << (n - 1) for n in range(1, 32)]
    even = _gf2_square(odd)
    odd = _gf2_square(even)
    op = None
    mat = _gf2_square(odd)  # one zero byte
    n = nbytes
    while n:
        if n & 1:
            op = mat if op is None else [_gf2_times(mat, r) for r in op]
        n >>= 1
        if n:
            mat = _gf2_square(mat)
    return op if op is not None else [1 << i for i in range(32)]


_OP_CACHE: dict[int, list[int]] = {}


def _zero_operator_cached(nbytes: int) -> list[int]:
    op = _OP_CACHE.get(nbytes)
    if op is None:
        if len(_OP_CACHE) > 64:
            _OP_CACHE.clear()
        op = _OP_CACHE[nbytes] = _zero_operator(nbytes)
    return op


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32C of A+B from crc32c(A), crc32c(B) and len(B)."""
    if len2 == 0:
        return crc1
    return _gf2_times(_zero_operator_cached(len2), crc1) ^ crc2


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of `data`, chained from `crc`."""
    buf = _as_bytes_view(data)
    n = buf.shape[0]
    c = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    if n < _VECTOR_MIN:
        return _crc_scalar(buf, c) ^ 0xFFFFFFFF
    L = 1 << max(11, min(24, int(n).bit_length() // 2))
    K = n // L
    body = K * L
    cols = np.ascontiguousarray(buf[:body].reshape(K, L).T)
    crcs = np.full((K,), 0xFFFFFFFF, np.uint32)
    for j in range(L):
        crcs = _TABLE[(crcs ^ cols[j]) & np.uint32(0xFF)] ^ (crcs >> 8)
    crcs ^= np.uint32(0xFFFFFFFF)
    total = c ^ 0xFFFFFFFF
    op = _zero_operator_cached(L)
    for chunk_crc in crcs.tolist():
        total = _gf2_times(op, total) ^ chunk_crc
    if body < n:
        total = _crc_scalar(buf[body:], total ^ 0xFFFFFFFF) ^ 0xFFFFFFFF
    return total


def crc32c_file(path: str, start: int = 0, length: int | None = None,
                crc: int = 0, block: int = 8 << 20) -> int:
    """Streaming CRC32C of `length` bytes of `path` from `start`
    (None = to EOF), chained from `crc` (a v4 shard file's whole-file
    digest)."""
    with open(path, "rb") as f:
        f.seek(start)
        remaining = length
        while remaining is None or remaining > 0:
            want = block if remaining is None else min(block, remaining)
            chunk = f.read(want)
            if not chunk:
                if remaining is not None:
                    raise record_error(
                        f"'{path}' ends {remaining} bytes short of the "
                        f"digested range", path=path, offset=start)
                break
            crc = crc32c(chunk, crc)
            if remaining is not None:
                remaining -= len(chunk)
    return crc


SEAL_FIELD = "crc32c"


def _body(doc: dict) -> bytes:
    return json.dumps({k: v for k, v in doc.items() if k != SEAL_FIELD},
                      sort_keys=True).encode()


def seal(doc: dict) -> dict:
    """`doc` plus its self-digest over the canonical serialization."""
    return {**doc, SEAL_FIELD: crc32c(_body(doc))}


def check_seal(doc: dict, what: str, path: str) -> None:
    """Verify a sealed document (one without the field passes)."""
    want = doc.get(SEAL_FIELD)
    if want is None:
        return
    body = _body(doc)
    got = crc32c(body)
    if got != int(want):
        raise record_error(
            f"{what} '{path}' failed its header self-digest (crc32c "
            f"{got:#010x} != recorded {int(want):#010x}) — the document "
            "was altered after it was written",
            path=path, section="header", offset=0)
    record_verified(len(body))


# -- verification telemetry hook -------------------------------------------
# The loaders run far below the CLIs, so the run's registry is installed
# ambiently; with none installed every record call is a no-op.

_REG = None

COUNTER_ERRORS = "integrity_errors_total"
COUNTER_BYTES = "integrity_bytes_verified_total"


def install_registry(reg):
    """Install the ambient registry of verification telemetry; returns
    the previous one (the caller restores it)."""
    global _REG
    prev = _REG
    _REG = reg
    return prev


def _registry():
    reg = _REG
    return reg if reg is not None and getattr(reg, "enabled", False) \
        else None


def record_verified(nbytes: int, **meta) -> None:
    """Count `nbytes` of artifact bytes that passed verification; `meta`
    (db_version=..., verify_db=...) declares the feature in the run's
    document, so metrics_check requires these counters."""
    reg = _registry()
    if reg is None:
        return
    reg.counter(COUNTER_ERRORS)  # lands even at 0
    reg.counter(COUNTER_BYTES).inc(int(nbytes))
    if meta:
        reg.set_meta(**meta)


def record_error(message: str, path: str | None = None,
                 section: str | None = None,
                 offset: int | None = None) -> IntegrityError:
    """Count one detection, emit the event naming file, section and
    offset, and return the IntegrityError for the caller to raise."""
    reg = _registry()
    if reg is not None:
        reg.counter(COUNTER_BYTES)  # lands even at 0
        reg.counter(COUNTER_ERRORS).inc()
        reg.event("integrity_error", file=path, section=section,
                  offset=offset, detail=message)
    return IntegrityError(message, path=path, section=section,
                          offset=offset)


def fsync_dir(path: str) -> None:
    """Make a rename in `path`'s directory durable."""
    d = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
