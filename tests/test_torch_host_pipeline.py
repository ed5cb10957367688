"""The port's host pipeline (quorum_tpu_torch/utils/pipeline.py and the
stage-2 loop of models/error_correct.py), on the CPU: the primitives
keep the JAX package's semantics (order, error propagation, abandon,
backpressure, byte budgets, writer fail-fast); on the golden reads
with --device cpu, stage 2's .fa/.log equal the committed fixtures and
the JAX package's CLI for every -t and --render-workers, with and
without --gzip; a failing render worker or producer fails the run and
leaves no thread; no torch tensor reaches a render worker; -M loads the
same table; and the driver at -t 4 --render-workers 3 equals the JAX
driver's payload and output."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import filecmp
import gzip
import io
import os
import threading
import time

import numpy as np
import pytest
import torch

from quorum_tpu.cli import error_correct_reads as jec_cli
from quorum_tpu.cli import quorum as jquorum
from quorum_tpu.io import db_format as jdb
from quorum_tpu.models import error_correct as jec
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.models import error_correct as tec
from quorum_tpu_torch.utils import pipeline
from quorum_tpu_torch.utils.pipeline import (AsyncWriter, ReorderingPool,
                                             prefetch)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
BATCH = ["--batch-size", "64"]  # 242 golden reads: four batches
PIPE_THREADS = ("prefetch", "render", "writer", "parse")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops: one thread, so the
    suite's parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipeline_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(PIPE_THREADS)]


# --------------------------------------------------------------- prefetch


def test_prefetch_passes_items_in_order():
    assert list(prefetch(iter(range(100)), depth=3)) == list(range(100))


def test_prefetch_producer_exception_reraises_at_consumer():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("producer blew up")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="producer blew up"):
        next(it)
    assert not _pipeline_threads()


def test_prefetch_immediate_producer_error():
    def gen():
        raise ValueError("dead on arrival")
        yield  # pragma: no cover

    with pytest.raises(ValueError, match="dead on arrival"):
        list(prefetch(gen()))


def test_prefetch_abandon_releases_and_joins_the_producer():
    state = {"produced": 0, "closed": False}

    def gen():
        try:
            for i in range(10_000):
                state["produced"] += 1
                yield i
        finally:
            state["closed"] = True

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()
    assert state["produced"] < 10_000
    assert state["closed"]  # the source was closed on the producer
    assert not _pipeline_threads()


def test_prefetch_count_backpressure():
    produced = []

    def gen():
        for i in range(50):
            produced.append(i)
            yield i

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    time.sleep(0.3)
    # one taken, two queued, one held by the blocked producer
    assert len(produced) <= 4
    assert list(it) == list(range(1, 50))


def test_prefetch_byte_budget_blocks_below_depth():
    produced = []

    def gen():
        for i in range(6):
            produced.append(i)
            yield np.zeros(100, np.uint8)

    it = prefetch(gen(), depth=8, max_bytes=250)
    next(it)
    time.sleep(0.3)
    # 250 bytes hold two 100-byte items; the third producer put waits
    assert len(produced) <= 4
    assert len(list(it)) == 5


def test_prefetch_admits_an_item_over_the_whole_budget():
    items = [np.zeros(1000, np.uint8) for _ in range(3)]
    assert len(list(prefetch(iter(items), max_bytes=10))) == 3


def test_prefetch_budget_from_the_environment(monkeypatch):
    monkeypatch.setenv("QUORUM_PREFETCH_QUEUE_BYTES", "2k")
    assert pipeline.queue_bytes_budget("QUORUM_PREFETCH_QUEUE_BYTES",
                                       "1G") == 2000
    monkeypatch.setenv("QUORUM_PREFETCH_QUEUE_BYTES", "junk")
    assert pipeline.queue_bytes_budget("QUORUM_PREFETCH_QUEUE_BYTES",
                                       "1G") == 10 ** 9
    monkeypatch.delenv("QUORUM_WRITER_QUEUE_BYTES", raising=False)
    w = AsyncWriter([io.StringIO()])
    w.close()
    assert w.max_bytes == 256 * 10 ** 6


def test_prefetch_times():
    times = {}

    def gen():
        for i in range(3):
            time.sleep(0.05)
            yield i

    assert list(prefetch(gen(), times=times)) == [0, 1, 2]
    assert times["produce_s"] >= 0.15 and times["wait_s"] > 0.0


def test_batch_nbytes_matches_jax():
    from quorum_tpu.utils.pipeline import batch_nbytes
    a = np.zeros((4, 8), np.int32)
    for item in ((a, [b"xy", "abc"], {"k": a}), object(), "text"):
        assert pipeline.batch_nbytes(item) == batch_nbytes(item)
    assert pipeline.batch_nbytes((a, [b"xy", "abc"], {"k": a})) == 261


# ----------------------------------------------------------- AsyncWriter


class BrokenStream:
    def __init__(self, fail_after=0):
        self.n = 0
        self.fail_after = fail_after

    def write(self, text):
        self.n += 1
        if self.n > self.fail_after:
            raise OSError("dead pipe")

    def flush(self):
        pass


def _wait_err(w):
    deadline = time.time() + 5.0
    while w.err is None and time.time() < deadline:
        time.sleep(0.01)
    assert w.err is not None


def test_async_writer_writes_and_closes():
    a, b = io.StringIO(), io.StringIO()
    w = AsyncWriter([a, b])
    w.write(0, "x1")
    w.write(1, "y1")
    w.write(0, "")
    w.write(0, "x2")
    w.close()
    assert a.getvalue() == "x1x2"
    assert b.getvalue() == "y1"
    assert not _pipeline_threads()


def test_async_writer_fail_fast_on_write():
    w = AsyncWriter([BrokenStream()])
    w.write(0, "first")
    _wait_err(w)
    with pytest.raises(OSError, match="dead pipe"):
        w.write(0, "second")
    w.close()  # raised already at write: not again


def test_async_writer_single_raise_on_close():
    w = AsyncWriter([BrokenStream()])
    w.write(0, "boom")
    _wait_err(w)
    with pytest.raises(OSError, match="dead pipe"):
        w.close()


def test_async_writer_byte_budget():
    gate = threading.Event()

    class Gated(io.StringIO):
        def write(self, text):
            gate.wait(10)
            return super().write(text)

    s = Gated()
    w = AsyncWriter([s], max_bytes=10)
    w.write(0, "aaaaaaaa")  # the writer thread takes it and blocks
    w.write(0, "bbbbbbbb")  # queued: 8 bytes pending
    done = threading.Event()

    def third():
        w.write(0, "cccccccc")  # 16 > 10: waits for the queue to drain
        done.set()

    t = threading.Thread(target=third)
    t.start()
    assert not done.wait(0.3)
    gate.set()
    t.join(10)
    w.close()
    assert s.getvalue() == "aaaaaaaabbbbbbbbcccccccc"


# --------------------------------------------------------- ReorderingPool


def test_reorder_out_of_order_completion():
    release = [threading.Event() for _ in range(6)]
    done: list = []

    def work(i):
        release[i].wait(timeout=10)
        return i

    pool = ReorderingPool(3, done.append, max_pending=6)
    for i in range(6):
        pool.submit(work, i)
    for i in reversed(range(6)):
        release[i].set()
        time.sleep(0.005)
    pool.flush()
    pool.shutdown()
    assert done == [0, 1, 2, 3, 4, 5]
    assert pool.take_reorder_wait() >= 0.0
    assert not _pipeline_threads()


def test_reorder_worker_error_propagates():
    done: list = []

    def work(i):
        if i == 2:
            raise ValueError("injected render failure")
        return i

    pool = ReorderingPool(2, done.append, max_pending=4)
    try:
        with pytest.raises(ValueError, match="injected render"):
            for i in range(8):
                pool.submit(work, i)
            pool.flush()
    finally:
        pool.shutdown()
    assert done == [0, 1]
    assert not _pipeline_threads()


def test_reorder_backpressure_bounds_pending():
    gate = threading.Event()
    done: list = []

    def work(i):
        gate.wait(timeout=10)
        return i

    pool = ReorderingPool(2, done.append, max_pending=3)
    for i in range(3):
        pool.submit(work, i)
    assert pool.depth == 3
    gate.set()
    pool.submit(work, 3)  # drains the head first
    assert pool.depth <= 3
    pool.flush()
    pool.shutdown()
    assert done == [0, 1, 2, 3]


@pytest.mark.parametrize("n", [0, 1, 3, 7])
def test_resolve_render_workers_matches_jax(n):
    assert tec.resolve_render_workers(n) == jec.resolve_render_workers(n)


# ------------------------------------------------- stage 2 on golden reads


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden reads' database (the port's stage 1), the JAX stage-2
    CLI's output on it, and the JAX driver at -t 4 --render-workers 3."""
    d = tmp_path_factory.mktemp("hostpipe")
    db = str(d / "db.jf")
    assert tcdb_cli.main(["-s", "64k", "-m", "13", "-b", "7", "-q", "38",
                          "-t", "4", "-o", db, "--device", "cpu",
                          READS]) == 0
    jax = str(d / "jax")
    assert jec_cli.main(["-p", "4", *BATCH, "-t", "4", "--render-workers",
                         "2", "-o", jax, db, READS]) == 0
    assert jquorum.main(["-s", "64k", "-k", "13", "-t", "4",
                         "--render-workers", "3", "--devices", "1", *BATCH,
                         "-p", str(d / "jdrv"), READS]) == 0
    return d, db, jax


def _same(a, b):
    return filecmp.cmp(a, b, shallow=False)


def _port_ec(db, out, *extra):
    return tec_cli.main(["-p", "4", *BATCH, *extra, "-o", out, "--device",
                         "cpu", db, READS])


@pytest.mark.parametrize("threads,workers", [(1, 1), (1, 2), (4, 4),
                                             (4, 1)])
def test_stage2_bytes_for_every_thread_count(golden, tmp_path, threads,
                                             workers):
    _d, db, jax = golden
    out = str(tmp_path / "port")
    assert _port_ec(db, out, "-t", str(threads), "--render-workers",
                    str(workers)) == 0
    for ext in (".fa", ".log"):
        assert _same(out + ext, os.path.join(GOLDEN, "expected" + ext))
        assert _same(out + ext, jax + ext)
    assert not _pipeline_threads()


def test_stage2_gzip_output(golden, tmp_path):
    _d, db, jax = golden
    out = str(tmp_path / "gz")
    assert _port_ec(db, out, "--gzip") == 0
    assert not os.path.exists(out + ".fa")
    for ext in (".fa", ".log"):
        with gzip.open(out + ext + ".gz", "rb") as f:
            assert f.read() == open(jax + ext, "rb").read()


def test_no_mmap_loads_the_same_table(golden, tmp_path):
    _d, db, jax = golden
    mapped = tdb.load_db(db, device="cpu")
    read = tdb.load_db(db, device="cpu", no_mmap=True)
    assert torch.equal(mapped[0].rows, read[0].rows)
    assert mapped[3] == read[3]
    out = str(tmp_path / "m")
    assert _port_ec(db, out, "-M") == 0
    assert _same(out + ".fa", jax + ".fa")


def test_render_worker_failure_fails_the_run(golden, tmp_path,
                                             monkeypatch, capsys):
    _d, db, _jax = golden
    real = tec.finish_batch_host
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected finish failure")
        return real(*a, **kw)

    monkeypatch.setattr(tec, "finish_batch_host", flaky)
    out = str(tmp_path / "boom")
    assert _port_ec(db, out, "--render-workers", "3") == 1
    assert "injected finish failure" in capsys.readouterr().err
    assert not _pipeline_threads()


def test_producer_failure_fails_the_run(golden, tmp_path, monkeypatch,
                                        capsys):
    _d, db, _jax = golden
    real = tec.pack_for_stage2
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 3:
            raise ValueError("injected pack failure")
        return real(*a)

    monkeypatch.setattr(tec, "pack_for_stage2", flaky)
    assert _port_ec(db, str(tmp_path / "p"), "-t", "2") == 1
    assert "injected pack failure" in capsys.readouterr().err
    assert not _pipeline_threads()


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _leaves(y)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            yield from _leaves(getattr(x, name))
    else:
        yield x


def test_render_workers_get_numpy_only(golden, tmp_path, monkeypatch):
    """No torch tensor reaches a render worker, and the workers are not
    the main thread (every CUDA call stays there)."""
    _d, db, jax = golden
    real = tec.render_batch_host
    seen = []

    def spy(*args):
        seen.append((threading.current_thread() is threading.main_thread(),
                     [type(v) for v in _leaves(args)
                      if isinstance(v, torch.Tensor)]))
        return real(*args)

    monkeypatch.setattr(tec, "render_batch_host", spy)
    out = str(tmp_path / "spy")
    assert _port_ec(db, out, "--render-workers", "2") == 0
    assert len(seen) == 4
    assert all(not on_main and not tensors for on_main, tensors in seen)
    assert _same(out + ".fa", jax + ".fa")


def test_quarantine_needs_an_output_prefix(golden):
    _d, db, _jax = golden
    assert tec_cli.main(["-p", "4", "--on-bad-read", "quarantine",
                         "--device", "cpu", db, READS]) == 1


def test_driver_matches_jax_driver_with_threads(golden, tmp_path):
    d, _db, _jax = golden
    out = str(tmp_path / "drv")
    report: dict = {}
    assert tquorum.main(["-s", "64k", "-k", "13", "-t", "4",
                         "--render-workers", "3", *BATCH, "-p", out,
                         "--device", "cpu", READS], report=report) == 0
    jout = str(d / "jdrv")
    for ext in (".fa", ".log"):
        assert _same(out + ext, jout + ext)
    assert (tdb.db_payload_bytes(out + "_mer_database.jf")
            == jdb.db_payload_bytes(jout + "_mer_database.jf"))
    ec = report["ec"]
    assert report["threads"] == 4 and ec.render_workers == 3
    assert report["stage1_host_s"] > 0 and ec.render_s > 0
    assert not _pipeline_threads()
