"""FASTQ/FASTA ingestion (counterpart of the pure-Python parser of
quorum_tpu/io/fastq.py): streaming records, fixed-shape batches.

Handles 4-line and multi-line FASTQ, FASTA (quality absent), gzip
inputs (by extension or magic) and '-' for stdin. One thread; the
native C++ parser and the span-parallel parse are not ported.
"""

from __future__ import annotations

import dataclasses
import gzip
import sys
from typing import Iterable, Iterator, Sequence

import numpy as np

from ..ops import mer

# Read-length buckets: batches are padded to the smallest bucket that
# fits the longest read, so batch shapes stay few.
LENGTH_BUCKETS = (64, 128, 160, 192, 256, 384, 512, 1024, 2048, 4096)


@dataclasses.dataclass
class ReadBatch:
    """codes int8 [B, L] (-1 non-ACGT, -2 beyond length), quals uint8
    [B, L] (0 beyond length / FASTA), lengths int32 [B], headers of the
    n real reads (rows beyond n are padding)."""

    codes: np.ndarray
    quals: np.ndarray | None
    lengths: np.ndarray
    headers: list
    n: int


def _open(path: str):
    if path in ("-", "/dev/fd/0", "/dev/stdin"):
        return sys.stdin.buffer
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        f.close()
        return gzip.open(path, "rb")
    return f


def iter_records(paths: Sequence[str]) -> Iterator[tuple[str, bytes, bytes]]:
    """Yield (header, seq, qual) records across files; qual is b'' for
    FASTA. A malformed record raises."""
    for path in paths:
        f = _open(path)
        try:
            yield from _iter_one(f, path)
        finally:
            if f is not sys.stdin.buffer:
                f.close()


def _iter_one(f, path: str) -> Iterator[tuple[str, bytes, bytes]]:
    line = f.readline()
    while line:
        stripped = line.rstrip(b"\r\n")
        if not stripped:
            line = f.readline()
            continue
        if stripped.startswith(b">"):
            header = stripped[1:].decode()
            seq_parts = []
            line = f.readline()
            while line and not line.startswith((b">", b"@")):
                seq_parts.append(line.rstrip(b"\r\n"))
                line = f.readline()
            yield header, b"".join(seq_parts), b""
        elif stripped.startswith(b"@"):
            header = stripped[1:].decode()
            seq_parts = []
            line = f.readline()
            while line and not line.startswith(b"+"):
                seq_parts.append(line.rstrip(b"\r\n"))
                line = f.readline()
            seq = b"".join(seq_parts)
            qual_parts = []
            qlen = 0
            line = f.readline()
            while line and qlen < len(seq):
                q = line.rstrip(b"\r\n")
                qual_parts.append(q)
                qlen += len(q)
                line = f.readline()
            qual = b"".join(qual_parts)
            if len(qual) != len(seq):
                raise ValueError(
                    f"{path}: quality length {len(qual)} != sequence "
                    f"length {len(seq)} for read '{header}'")
            yield header, seq, qual
        else:
            raise ValueError(
                f"{path}: unrecognized record start: {stripped[:40]!r}")


def bucket_for(length: int) -> int:
    for b in LENGTH_BUCKETS:
        if length <= b:
            return b
    return length  # oversized: one-off shape


def batch_records(records: Iterable[tuple[str, bytes, bytes]],
                  batch_size: int = 8192) -> Iterator[ReadBatch]:
    """Group records into fixed-shape ReadBatches of `batch_size` rows."""
    buf: list = []
    for rec in records:
        buf.append(rec)
        if len(buf) == batch_size:
            yield _make_batch(buf, batch_size)
            buf = []
    if buf:
        yield _make_batch(buf, batch_size)


def _make_batch(buf, batch_size) -> ReadBatch:
    maxlen = max((len(seq) for _, seq, _ in buf), default=1)
    L = bucket_for(max(maxlen, 1))
    codes = np.full((batch_size, L), -2, dtype=np.int8)
    quals = np.zeros((batch_size, L), dtype=np.uint8)
    lengths = np.zeros((batch_size,), dtype=np.int32)
    headers = []
    for i, (hdr, seq, qual) in enumerate(buf):
        headers.append(hdr)
        m = len(seq)
        lengths[i] = m
        codes[i, :m] = mer.seq_to_codes(seq)
        if qual:
            quals[i, :m] = np.frombuffer(qual, dtype=np.uint8)
    return ReadBatch(codes=codes, quals=quals, lengths=lengths,
                     headers=headers, n=len(buf))


def read_batches(paths: Sequence[str],
                 batch_size: int = 8192) -> Iterator[ReadBatch]:
    """Batched reads from FASTQ/FASTA files, in file order."""
    yield from batch_records(iter_records(paths), batch_size)
