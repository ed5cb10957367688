"""FASTQ/FASTA ingestion (counterpart of quorum_tpu/io/fastq.py):
streaming records, fixed-shape batches.

Handles 4-line and multi-line FASTQ, FASTA (quality absent), gzip
inputs (by extension or magic) and '-' for stdin. Strict 4-line FASTQ
goes through the native C++ parser (native/binding.py) where it built;
this module is the always-available Python parser, the batching, the
malformed-record policy and the multi-threaded readers: several files
decode concurrently, and one large uncompressed file parses in
record-aligned spans on a worker pool, both yielding the serial parse's
batches in file order.
"""

from __future__ import annotations

import dataclasses
import gzip
import itertools
import os
import queue
import sys
import threading
from typing import Iterable, Iterator, Sequence

import numpy as np

from ..ops import mer
from ..utils import faults, resources

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


class BadReadPolicy:
    """What to do with a malformed record mid-stream (`--on-bad-read`):
    ``abort`` (the default) raises; ``skip`` drops the record and counts
    it (`bad`); ``quarantine`` also appends the record's raw lines to
    `quarantine_path`. Thread-safe (the pooled readers parse on worker
    threads). `registry` (an enabled telemetry registry, or None) counts
    each bad record in `bad_reads_total`. The quarantine stream is an
    optional writer (utils/resources): ENOSPC there disables it for the
    rest of the run, never the run; each append passes the
    `quarantine.write` fault site."""

    MODES = ("abort", "skip", "quarantine")

    def __init__(self, mode: str = "abort",
                 quarantine_path: str | None = None, registry=None):
        if mode not in self.MODES:
            raise ValueError(f"bad on-bad-read mode {mode!r} "
                             f"(one of {self.MODES})")
        if mode == "quarantine" and not quarantine_path:
            raise ValueError("quarantine mode needs a quarantine path")
        self.mode = mode
        self.quarantine_path = quarantine_path
        self.registry = registry
        self.bad = 0
        self._lock = threading.Lock()
        self._f = None
        self._closed = False

    @property
    def wants_raw(self) -> bool:
        return self.mode == "quarantine"

    def handle(self, path: str, err: Exception, raw_lines) -> None:
        """One malformed record: raise (abort), or count it and, in
        quarantine mode, append its raw lines."""
        if self.mode == "abort":
            raise err
        if self.registry is not None:
            self.registry.counter("bad_reads_total").inc()
        with self._lock:
            self.bad += 1
            if (self.mode == "quarantine" and raw_lines
                    and not self._closed
                    and not resources.degraded("quarantine.stream")):
                with resources.guard("quarantine.stream",
                                     path=self.quarantine_path):
                    faults.inject("quarantine.write",
                                  path=self.quarantine_path)
                    if self._f is None:
                        self._f = open(self.quarantine_path, "wb")
                    for ln in raw_lines:
                        self._f.write(ln)
                    self._f.flush()

    def close(self) -> None:
        """Idempotent; a record met after close is counted, not written
        (reopening would truncate the quarantine file)."""
        with self._lock:
            self._closed = True
            if self._f is not None:
                f, self._f = self._f, None
                # a degraded stream may still hold bytes a full disk
                # refuses: closing it degrades, not the teardown
                with resources.guard("quarantine.stream",
                                     path=self.quarantine_path):
                    f.close()


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


def iter_records(paths: Sequence[str],
                 policy: BadReadPolicy | None = None,
                 ) -> Iterator[tuple[str, bytes, bytes]]:
    """Yield (header, seq, qual) records across files; qual is b'' for
    FASTA. `policy` (None = abort) decides what a malformed record
    does."""
    for path in paths:
        f = _open(path)
        try:
            yield from _iter_one(f, path, policy)
        finally:
            if f is not sys.stdin.buffer:
                f.close()


def _iter_one(f, path: str, policy: BadReadPolicy | None = None,
              ) -> Iterator[tuple[str, bytes, bytes]]:
    # raw lines are kept only for a quarantine
    capture = policy is not None and policy.wants_raw
    line = f.readline()
    while line:
        stripped = line.rstrip(b"\r\n")
        if not stripped:
            line = f.readline()
            continue
        if stripped.startswith(b">"):
            raw = [line] if capture else None
            header_b = stripped[1:]
            seq_parts = []
            line = f.readline()
            while line and not line.startswith((b">", b"@")):
                if capture:
                    raw.append(line)
                seq_parts.append(line.rstrip(b"\r\n"))
                line = f.readline()
            try:
                header = header_b.decode()
            except UnicodeDecodeError as err:
                # the record's lines are consumed: the stream resyncs
                if policy is None:
                    raise
                policy.handle(path, err, raw or [])
                continue
            faults.inject("fastq.read")
            yield header, b"".join(seq_parts), b""
        elif stripped.startswith(b"@"):
            raw = [line] if capture else None
            header_b = stripped[1:]
            seq_parts = []
            line = f.readline()
            while line and not line.startswith(b"+"):
                if capture:
                    raw.append(line)
                seq_parts.append(line.rstrip(b"\r\n"))
                line = f.readline()
            seq = b"".join(seq_parts)
            if capture and line:
                raw.append(line)  # the '+' separator
            qual_parts = []
            qlen = 0
            line = f.readline()
            while line and qlen < len(seq):
                if capture:
                    raw.append(line)
                q = line.rstrip(b"\r\n")
                qual_parts.append(q)
                qlen += len(q)
                line = f.readline()
            qual = b"".join(qual_parts)
            try:
                header = header_b.decode()
            except UnicodeDecodeError as err:
                if policy is None:
                    raise
                policy.handle(path, err, raw or [])
                continue
            if len(qual) != len(seq):
                err = ValueError(
                    f"{path}: quality length {len(qual)} != sequence "
                    f"length {len(seq)} for read '{header}'")
                if policy is None:
                    raise err
                # `line` holds the first unconsumed line: the stream
                # resyncs at the next record
                policy.handle(path, err, raw or [])
                continue
            faults.inject("fastq.read")
            yield header, seq, qual
        else:
            err = ValueError(
                f"{path}: unrecognized record start: {stripped[:40]!r}")
            if policy is None:
                raise err
            policy.handle(path, err, [line] if capture else [])
            line = f.readline()


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
    """One ReadBatch of the records in `buf`: the sequences' codes and
    the qualities (zeros for a FASTA record's empty quality) laid row by
    row from their concatenation, in one pass for the batch."""
    n = len(buf)
    lens = np.fromiter((len(seq) for _, seq, _ in buf), np.int64, n)
    L = bucket_for(max(int(lens.max()) if n else 1, 1))
    codes = np.full((batch_size, L), -2, dtype=np.int8)
    quals = np.zeros((batch_size, L), dtype=np.uint8)
    lengths = np.zeros((batch_size,), dtype=np.int32)
    lengths[:n] = lens
    headers = [hdr for hdr, _, _ in buf]
    if any(qual and len(qual) != len(seq) for _, seq, qual in buf):
        raise ValueError("a record's quality and sequence lengths differ")
    inside = np.arange(L)[None, :] < lens[:, None]
    codes[:n][inside] = mer.seq_to_codes(b"".join(seq for _, seq, _ in buf))
    quals[:n][inside] = np.frombuffer(
        b"".join(qual or bytes(len(seq)) for _, seq, qual in buf), np.uint8)
    return ReadBatch(codes=codes, quals=quals, lengths=lengths,
                     headers=headers, n=n)


# ---------------------------------------------------------------------------
# Single-file span-parallel parse
# ---------------------------------------------------------------------------

# below this size probing spans costs more than the serial parse; tests
# lower it to exercise the path on small inputs
PARALLEL_SPAN_MIN_BYTES = 4 << 20

# bases a sequence line may hold (IUPAC, lowercase): quality strings
# almost never pass, which tells an '@'-leading quality line from a
# header
_SEQ_CHARS = frozenset(b"ACGTUNRYSWKMBDHVacgtunryswkmbdhv.-")


def _is_seq_line(line: bytes) -> bool:
    s = line.rstrip(b"\r\n")
    return bool(s) and all(c in _SEQ_CHARS for c in s)


def _rec4_at(lines, i: int) -> bool:
    """lines[i:i+4] look like one strict 4-line FASTQ record."""
    return (i + 3 < len(lines)
            and lines[i].startswith(b"@")
            and _is_seq_line(lines[i + 1])
            and lines[i + 2].startswith(b"+")
            and len(lines[i + 3].rstrip(b"\r\n"))
            == len(lines[i + 1].rstrip(b"\r\n")))


def _probe_record_start(f, offset: int, window: int = 64) -> int | None:
    """The byte offset of the first confident 4-line FASTQ record start
    at or after `offset`: TWO consecutive strict records (one alone can
    be impersonated by a wrapped record's quality chunks), within
    `window` lines; else None."""
    f.seek(offset)
    if offset:
        f.readline()  # the partial line the cut landed in
    positions, lines = [], []
    for _ in range(window):
        pos = f.tell()
        line = f.readline()
        if not line:
            break
        positions.append(pos)
        lines.append(line)
    for i in range(len(lines) - 7):
        if _rec4_at(lines, i) and _rec4_at(lines, i + 4):
            return positions[i]
    return None


def _single_file_spans(path: str, n: int) -> list[tuple[int, int]] | None:
    """Record-aligned [start, end) spans of ONE uncompressed 4-line
    FASTQ file, or None where it cannot be split safely (stdin, gzip,
    FASTA, wrapped records, small files). Each span parses alone, and
    their records concatenate to the serial parse's."""
    if path in ("-", "/dev/fd/0", "/dev/stdin") or path.endswith(".gz"):
        return None
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    if n <= 1 or size < max(PARALLEL_SPAN_MIN_BYTES, 4 * n):
        return None
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":  # gzip by magic
            return None
        f.seek(0)
        if not f.readline().startswith(b"@"):
            return None  # FASTA: the serial parser
        # the head must be strict 4-line FASTQ: a wrapped file has no
        # record-aligned byte cuts
        if _probe_record_start(f, 0) != 0:
            return None
        cuts = [0]
        for i in range(1, n):
            pos = _probe_record_start(f, size * i // n)
            if pos is None or pos <= cuts[-1] or pos >= size:
                continue  # fold this span into its neighbour
            cuts.append(pos)
    cuts.append(size)
    spans = [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)
             if cuts[i + 1] > cuts[i]]
    return spans if len(spans) > 1 else None


class _SpanReader:
    """readline()-only view of [start, end) of a binary file; the span
    ends between two records, where the parser sees a clean end."""

    def __init__(self, f, start: int, end: int):
        f.seek(start)
        self._f = f
        self._end = end
        self._pos = start

    def readline(self) -> bytes:
        if self._pos >= self._end:
            return b""
        line = self._f.readline()
        self._pos += len(line)
        return line


def _iter_sources_pooled(n: int, threads: int, produce) -> Iterator:
    """The items of produce(0), ..., produce(n - 1) concatenated in
    source order, the producers running on up to `threads` workers.
    Workers claim source indices in order (pinning a later source to
    every worker while the consumer waits on source 0 would deadlock).
    A producer exception re-raises at the consumer in order; closing
    the generator stops and joins the workers."""
    from ..utils.pipeline import put_or_stop

    qs = [queue.Queue(maxsize=4) for _ in range(n)]
    stop = threading.Event()
    claim = itertools.count()
    claim_lock = threading.Lock()

    def worker():
        while not stop.is_set():
            with claim_lock:
                i = next(claim)
            if i >= n:
                return
            try:
                for item in produce(i):
                    # a 1-tuple: data is never the error or end marker
                    if not put_or_stop(qs[i], (item,), stop):
                        return
                if not put_or_stop(qs[i], None, stop):
                    return
            except BaseException as e:  # noqa: BLE001 - forwarded
                put_or_stop(qs[i], ("__err__", e), stop)
                return

    ts = [threading.Thread(target=worker, daemon=True, name="parse")
          for _ in range(min(max(1, threads), n))]
    for t in ts:
        t.start()
    try:
        for i in range(n):
            while True:
                item = qs[i].get()
                if item is None:
                    break
                if len(item) == 2:
                    raise item[1]
                yield item[0]
    finally:
        stop.set()
        for t in ts:
            if t is not threading.current_thread():
                t.join()


def _iter_records_spans(path: str, spans: list, threads: int,
                        policy: BadReadPolicy | None,
                        ) -> Iterator[tuple[str, bytes, bytes]]:
    """One file's record-aligned spans parsed on a worker pool, records
    in file order (so batching matches the serial parse)."""
    CHUNK = 512  # records a queue item

    def produce(i):
        with open(path, "rb") as f:
            rdr = _SpanReader(f, *spans[i])
            chunk: list = []
            for rec in _iter_one(rdr, path, policy):
                chunk.append(rec)
                if len(chunk) >= CHUNK:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

    for chunk in _iter_sources_pooled(len(spans), threads, produce):
        yield from chunk


def _native_ok(policy: BadReadPolicy | None) -> bool:
    """Whether the native parser serves this read: only under abort
    (it has no record-recovery hooks) and where its library built."""
    if policy is not None and policy.mode != "abort":
        return False
    from ..native import binding
    return binding.available()


def _read_batches_one(paths: Sequence[str], batch_size: int,
                      policy: BadReadPolicy | None = None,
                      ) -> Iterator[ReadBatch]:
    if _native_ok(policy):
        from ..native import binding
        yield from binding.read_batches(paths, batch_size)
    else:
        yield from batch_records(iter_records(paths, policy), batch_size)


def read_batches(paths: Sequence[str], batch_size: int = 8192,
                 threads: int = 1, policy: BadReadPolicy | None = None,
                 ) -> Iterator[ReadBatch]:
    """Batched reads from FASTQ/FASTA files, in file order, with the
    JAX package's dispatch (so the batch boundaries are its own):

    * one file, threads > 1, no native parser and an abort policy: the
      file splits into record-aligned spans parsed on `threads` workers
      (_single_file_spans; gzip, stdin, FASTA, wrapped records and small
      files stay serial);
    * several files, threads > 1: up to `threads` files decode at once,
      each batched on its own, batches yielded in file order;
    * else one serial reader, native where it serves.

    skip/quarantine policies never take the span path: which records a
    resync swallows depends on parser state a span cut would lose. The
    reader owns `policy` and closes it however the generator ends."""
    try:
        if threads > 1 and len(paths) == 1:
            deterministic_only = policy is not None and policy.mode != "abort"
            spans = (None if deterministic_only or _native_ok(policy)
                     else _single_file_spans(paths[0], threads))
            if spans:
                yield from batch_records(
                    _iter_records_spans(paths[0], spans, threads, policy),
                    batch_size)
                return
        if threads <= 1 or len(paths) <= 1:
            yield from _read_batches_one(paths, batch_size, policy)
            return
        yield from _iter_sources_pooled(
            len(paths), threads,
            lambda i: _read_batches_one([paths[i]], batch_size, policy))
    finally:
        if policy is not None:
            policy.close()
