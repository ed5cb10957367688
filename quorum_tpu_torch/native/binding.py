"""ctypes binding for the native FASTQ parser (fastq_parser.cpp; the
counterpart of quorum_tpu/native/binding.py).

The shared library is built on first use with the system g++ into
quorum_tpu_torch/_build/native-<source hash>/ (through a per-process
temporary name and os.replace, so concurrent processes may build it at
once). Without a compiler, or where the build fails, `available()` is
False and io/fastq.py parses in Python; so does any file that is not
strict 4-line FASTQ (FASTA, wrapped records), and stdin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from typing import Iterator, Sequence

import numpy as np

from ..utils import faults

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "fastq_parser.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(HERE), "_build")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
CHUNK = 8 << 20

_LIB = None
_TRIED = False
_LOAD_LOCK = threading.Lock()
_STATS_LOCK = threading.Lock()
# batches and reads the native parser produced in this process
STATS = {"batches": 0, "reads": 0}


def library_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}",
                        "libqtfastq.so")


def _build() -> str | None:
    out = library_path()
    if os.path.exists(out):
        return out
    tmp = None
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
        os.close(fd)
        subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)
        return None


def _load():
    global _LIB, _TRIED
    with _LOAD_LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.qt_parse.restype = ctypes.c_long
            lib.qt_parse.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64),
            ]
            _LIB = lib
        except OSError:
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


class Fallback(Exception):
    """The input is not strict 4-line FASTQ: use the Python parser."""


def _parse_stream(f, batch_size: int, stride: int = 4096):
    """Yield raw (codes, quals, lengths, headers, n) tuples from one
    binary stream. Raises Fallback on a grammar mismatch in the first
    buffer (nothing yielded yet)."""
    lib = _load()
    assert lib is not None
    codes = np.empty((batch_size, stride), dtype=np.int8)
    quals = np.empty((batch_size, stride), dtype=np.uint8)
    lengths = np.empty((batch_size,), dtype=np.int32)
    hdr_off = np.empty((batch_size,), dtype=np.int64)
    hdr_len = np.empty((batch_size,), dtype=np.int32)
    consumed = ctypes.c_int64(0)
    buf = b""
    eof = False
    first = True
    while not eof or buf:
        while not eof and len(buf) < CHUNK:
            chunk = f.read(CHUNK)
            if not chunk:
                eof = True
                break
            buf += chunk
        if not buf:
            break
        n = lib.qt_parse(
            buf, len(buf), int(eof),
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hdr_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            hdr_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            batch_size, stride, ctypes.byref(consumed))
        if n == -1:
            if first:
                raise Fallback()
            raise ValueError("malformed FASTQ record (native parser)")
        if n == -2:
            # a read longer than the stride: grow it and parse the same
            # buffer again (nothing yielded is lost)
            stride = min(stride * 2, 1 << 22)
            codes = np.empty((batch_size, stride), dtype=np.int8)
            quals = np.empty((batch_size, stride), dtype=np.uint8)
            continue
        if n == 0 and eof:
            break
        if n == 0:
            chunk = f.read(CHUNK)  # one record needs more bytes
            if not chunk:
                eof = True
            else:
                buf += chunk
            continue
        first = False
        headers = [buf[hdr_off[i]:hdr_off[i] + hdr_len[i]].decode()
                   for i in range(n)]
        yield codes, quals, lengths, headers, int(n)
        buf = buf[consumed.value:]


def read_batches(paths: Sequence[str], batch_size: int = 8192
                 ) -> Iterator["object"]:
    """fastq.ReadBatch iterator through the native parser, falling back
    per file to the Python parser (FASTA, wrapped records, stdin)."""
    from ..io import fastq

    for path in paths:
        if path in ("-", "/dev/fd/0", "/dev/stdin"):
            # stdin cannot be opened again for the fallback
            yield from fastq.batch_records(fastq.iter_records([path]),
                                           batch_size)
            continue
        f = fastq._open(path)
        try:
            try:
                for codes, quals, lengths, headers, n in _parse_stream(
                        f, batch_size):
                    if faults.active():
                        for _ in range(int(n)):
                            faults.inject("fastq.read")
                    if n < batch_size:  # inert padding rows
                        codes[n:] = -2
                        quals[n:] = 0
                        lengths[n:] = 0
                    maxlen = int(lengths[:n].max()) if n else 1
                    L = fastq.bucket_for(maxlen)
                    with _STATS_LOCK:
                        STATS["batches"] += 1
                        STATS["reads"] += n
                    yield fastq.ReadBatch(
                        codes=codes[:, :L].copy(),
                        quals=quals[:, :L].copy(),
                        lengths=lengths.copy(),
                        headers=headers, n=n)
            except Fallback:
                f.close()
                f = fastq._open(path)
                yield from fastq.batch_records(
                    fastq.iter_records([path]), batch_size)
        finally:
            if f is not sys.stdin.buffer:
                f.close()
