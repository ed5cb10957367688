"""Build and load the hand-written CUDA kernels.

Each `csrc/*.cu` source compiles with nvcc into its own shared library
with a plain C interface (``extern "C"`` launchers taking device
pointers, sizes and the CUDA stream), loaded with ctypes. Builds happen
at first use, never at import, into ``quorum_tpu_torch/_build/<hash>/``
keyed by a digest of every source and the flags, so a checkout builds
its kernels from the sources it holds and a changed source rebuilds.
All sources compile in parallel (one nvcc each).

`STATS` counts the launches of each kernel, and of each entry counted
apart (ENTRIES), under its name (a wrapper adds one where it launches,
nowhere else: one per wrapper call, whatever number of C launchers the
call enqueues) and, when `STATS.timing` is on, keeps CUDA
events around everything the wrapper call enqueues (`events`) and
around each C launch (`calls`): for a wrapper with two C launches and
host work between them the two differ by the device's idle gap. While
`STATS.annotate` is on (a `--profile` run, utils/profiling.trace) each
wrapper call is also a profiler range named `launch:<kernel>`, which
telemetry/devtrace.py reads.

Threads: the correction server launches kernels from its dispatcher,
step-watchdog and rebuild threads (serve/batcher.py), so a library's
build-and-load runs under one lock (one build, one loaded object for
every thread) and the launch counts under another; the kernel a wrapper
is launching (`STATS.current`, the label of its timed C launches) is
kept per thread.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(HERE), "_build")

KERNELS = ("tile_insert", "tile_seal", "tile_lookup", "extend_reads",
           "stage2_head", "tile_export", "tile_load", "tile_grow",
           "batch_aggregate", "sketch_update", "gated_insert", "tile_floor",
           "tile_departition", "pack_finish", "shard_route", "event_planes",
           "event_scan", "flat_insert", "flat_lookup", "flat_finalize",
           "minimizer")
# entries of a kernel counted apart from it: on the --devices N path
# HK1's and HK8's shard entries, HK3's shard entry and HK4's, HK5's and
# HK16's sharded-table entries (the routed stage-2 layout), HK15's
# partition entry (--partitions P with --devices N); on the event-mode
# stage 2 HK4's event entry (and its sharded-table entry). Each but
# HK16's is also its C launcher; HK16's sharded-table entry is the two
# launchers event_classify_shard and event_prepass_shard. The flat
# table's grow is HK18's grow entry (flat_grow, in flat_insert.cu), and
# K22 HK6's compact entry (tile_export_compact, in tile_export.cu).
ENTRIES = ("tile_insert_shard", "tile_grow_shard", "tile_lookup_shard",
           "extend_reads_shard", "stage2_head_shard", "shard_route_part",
           "event_planes_shard", "extend_reads_event",
           "extend_reads_event_shard", "flat_grow", "tile_export_compact")
COUNTERS = KERNELS + ENTRIES

NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C signatures of the launchers (every one returns cudaGetLastError()).
SIGNATURES = {
    "tile_insert": {
        "tile_insert_reads": [_P, _I, _I, _LL, _LL, _LL, _I, _I, _I, _I, _I,
                              _I, _P, _P, _P, _P, _I, _P, _P],
        "tile_insert_keys": [_P, _P, _LL, _I, _I, _I, _P, _P, _P, _P, _P],
        "tile_insert_shard": [_P, _LL, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    },
    "tile_seal": {"tile_seal": [_P, _P, _P, _LL, _I, _P, _P, _P]},
    "tile_lookup": {
        "tile_lookup": [_P, _P, _LL, _I, _I, _I, _P, _P],
        "tile_lookup_shard": [_P, _I, _I, _P, _LL, _I, _I, _I, _P, _P],
        # no stream: called directly (kernels.enable_peer_access)
        "enable_peer_access": [_I, _I],
    },
    "extend_reads": {
        "extend_reads": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _P],
        "extend_reads_shard": [_P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P,
                               _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P],
        "extend_reads_event": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                               _P, _P, _P, _P, _P, _P, *[_P] * 8, _I, _I,
                               _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P],
        "extend_reads_event_shard": [_P, _I, _I, _I, _I, _I, _P, _I, _I, _I,
                                     _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     *[_P] * 8, _I, _I, _I, _I, _I, _I, _I,
                                     _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P],
    },
    "stage2_head": {
        "stage2_head": [_P, _I, _I, _LL, _LL, _LL, _P, _I, _I, _I, _P, _I,
                        _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P],
        "stage2_head_shard": [_P, _I, _I, _LL, _LL, _LL, _P, _I, _I, _I, _I,
                              _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _P],
    },
    "tile_export": {
        "tile_export_total": [_P, _LL, _I, _P, _P],
        "tile_export_rows": [_P, _LL, _I, _LL, _I, _P, _P, _LL, _P],
        "tile_export_compact": [_P, _LL, _I, _LL, _P, _P, _P, _P, _LL, _P],
    },
    "tile_load": {"tile_load": [_P, _LL, _LL, _I, _I, _P, _P, _P, _P, _P]},
    "tile_grow": {
        "tile_grow": [_P, _P, _P, _LL, _I, _I, _P, _P, _P, _P, _P],
        "tile_grow_shard": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
        "tile_grow_place": [_P, _LL, _P, _P, _P, _P, _P],
    },
    "batch_aggregate": {
        "batch_aggregate": [_P, _I, _I, _LL, _LL, _LL, _I, _I, _P, _P, _P,
                            _P],
    },
    "sketch_update": {
        "sketch_update": [_P, _P, _P, _LL, _I, _P, _P],
        "sketch_min": [_P, _LL, _I, _P, _P, _P],
    },
    "gated_insert": {
        "gated_insert_reads": [_P, _I, _I, _LL, _LL, _LL, _I, _I, _I, _I, _I,
                               _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
        "gated_insert_lanes": [_P, _P, _P, _P, _LL, _I, _I, _I, _P, _P, _P,
                               _P, _P, _P, _P],
    },
    "tile_floor": {"tile_floor": [_P, _LL, _I, _I, _P]},
    "tile_departition": {"tile_departition": [_P, _LL, _I, _I, _I, _I, _P,
                                              _P]},
    "pack_finish": {
        "pack_finish": [*[_P] * 11, _I, _I, _LL, _P, _P, _P, _P],
    },
    "shard_route": {
        "shard_route_wire": [_P, _I, _I, _LL, _LL, _LL, _I, _I, _I, _I, _I,
                             _I, _P, _P, _P],
        "shard_route_part": [_P, _I, _I, _LL, _LL, _LL, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P, _P, _P],
        "shard_route_lanes": [_P, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    },
    "event_planes": {
        "event_classify": [_P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P],
        "event_classify_shard": [_P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                                 _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P],
        "event_prepass": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                          _P, _P, _P, _P],
        "event_prepass_shard": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I,
                                _I, _P, _P, _P, _P, _P, _P, _P],
    },
    "event_scan": {
        "event_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P],
    },
    "flat_insert": {
        "flat_insert": [_P, _P, _P, _LL, _I, _I, _I, _P, _P, _P, _P, _P, _P],
        "flat_grow": [_P, _P, _P, _LL, _P, _P, _P, _P],
    },
    "flat_lookup": {
        "flat_lookup": [_P, _P, _LL, _I, _I, _I, _I, _P, _P],
    },
    "flat_finalize": {
        "flat_finalize": [_P, _P, _P, _LL, _I, _I, _P, _P, _P],
    },
    "minimizer": {"minimizer": [_P, _I, _I, _I, _I, _P, _P, _P]},
}


class KernelStats:
    """Launch counts per kernel, and optional CUDA-event timing."""

    def __init__(self):
        self.launches = {name: 0 for name in COUNTERS}
        self.timing = False
        self.annotate = False  # a profiler range per wrapper call
        self._local = threading.local()  # .current, per thread
        self._lock = threading.Lock()  # the counts' increments
        self.events: list = []  # (kernel, start event, end event)
        self.calls: list = []  # (kernel, C launcher, start, end)

    @property
    def current(self) -> str | None:
        """The counter this thread is launching under (None outside a
        wrapper)."""
        return getattr(self._local, "current", None)

    @current.setter
    def current(self, name: str | None) -> None:
        self._local.current = name

    def count(self, name: str) -> None:
        """One launch of `name`, atomically across threads."""
        with self._lock:
            self.launches[name] += 1

    def reset(self) -> None:
        with self._lock:
            for name in self.launches:
                self.launches[name] = 0
        self.events.clear()
        self.calls.clear()

    def kernel_ms(self) -> dict:
        """Summed event time per kernel, and per span (waits for every
        event, on whichever device it was recorded)."""
        out = {name: 0.0 for name in COUNTERS}
        for name, a, b in self.events:
            b.synchronize()
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


STATS = KernelStats()
_LIBS: dict = {}
# one build-and-load at a time: concurrent first users of a library wait
# for the one build and share the one loaded object
_LOAD_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> dict:
    """Compile every kernel whose library is missing, all at once.
    Returns {name: ptxas report}. Raises on any failed build."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    reports = {}
    for name in KERNELS:
        lib = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(lib):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            os.unlink(tmp)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name` (built on first use; safe to
    call from several threads at once)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = os.path.join(build_dir(), f"lib{name}.so")
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


@contextlib.contextmanager
def launching(name: str, count: bool = True):
    """Count one launch of kernel `name` (unless `count` is False: a
    later phase of a launch already counted, or work that is no kernel,
    such as the sharded build's bucket exchange) and, when timing, time
    all the work enqueued inside the block on the current device's
    current stream."""
    import torch

    if count:
        STATS.count(name)
    outer, STATS.current = STATS.current, name
    annotation = contextlib.nullcontext()
    if STATS.annotate:
        from torch.profiler import record_function

        annotation = record_function("launch:" + name)
    try:
        with annotation:
            if not STATS.timing:
                yield
                return
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            STATS.events.append((name, a, b))
    finally:
        STATS.current = outer


def call(name: str, fn: str, *args) -> None:
    """Call C launcher `fn` of kernel `name` on the current stream and
    raise if CUDA refused the launch (no count: see `launching`; timed
    on its own when timing, under the name being launched)."""
    import torch

    c_fn = getattr(library(name), fn)
    stream = torch.cuda.current_stream()
    if STATS.timing:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
    rc = c_fn(*args, stream.cuda_stream)
    if STATS.timing:
        b.record(stream)
        STATS.calls.append((STATS.current or name, fn, a, b))
    if rc != 0:
        raise RuntimeError(f"{name}.{fn}: CUDA launch failed with error {rc}")


def launch(name: str, fn: str, *args) -> None:
    """A wrapper's one launcher call: counted, timed, checked."""
    with launching(name):
        call(name, fn, *args)
