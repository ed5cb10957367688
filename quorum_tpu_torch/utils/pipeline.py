"""Host pipeline stages (counterpart of quorum_tpu/utils/pipeline.py):
a prefetching producer thread, ordered render workers and an
asynchronous writer.

One producer thread parses and packs reads ahead of the card; the main
thread makes every CUDA call (H2D, kernels, synchronize, D2H); N render
workers turn fetched numpy buffers into text, drained in submission
order; one writer thread drains that text to the output streams. The
threads other than the main one touch numpy arrays and bytes only.
"""

from __future__ import annotations

import collections
import concurrent.futures
import queue
import threading
import time
from typing import Iterable, Iterator, TypeVar

from . import faults, levers
from .sizes import parse_size

T = TypeVar("T")

_STOP = object()
_ITEM = object()
_FLUSH = object()


def queue_bytes_budget(lever: str, default: str) -> int:
    """The byte budget of one bounded queue, from the lever `lever`
    (k/M/G/T suffixes), else `default`; 0 disables."""
    try:
        return parse_size(levers.raw(lever) or default)
    except ValueError:
        return parse_size(default)


def batch_nbytes(item) -> int:
    """Estimated resident bytes of one queued item: buffers by .nbytes,
    str/bytes by length, containers recursively; an unknown leaf costs
    0, so it escapes the budget instead of deadlocking the queue."""
    nb = getattr(item, "nbytes", None)
    if nb is not None:
        try:
            return int(nb)
        except (TypeError, ValueError):
            return 0
    if isinstance(item, (str, bytes, bytearray)):
        return len(item)
    if isinstance(item, (tuple, list)):
        return sum(batch_nbytes(x) for x in item)
    if isinstance(item, dict):
        return sum(batch_nbytes(v) for v in item.values())
    return 0


def put_or_stop(q: queue.Queue, item, stop: threading.Event,
                timeout: float = 0.2, stall_gauge=None) -> bool:
    """Put on a bounded queue, giving up once `stop` is set (the
    consumer went away). Returns False if stopped. `stall_gauge` (a
    telemetry Gauge, or None) accumulates the seconds spent blocked on
    a full queue."""
    t0 = time.perf_counter() if stall_gauge is not None else 0.0
    blocked = False
    while not stop.is_set():
        try:
            q.put(item, timeout=timeout)
            if blocked and stall_gauge is not None:
                stall_gauge.add(time.perf_counter() - t0)
            return True
        except queue.Full:
            blocked = True
            continue
    return False


def prefetch(it: Iterable[T], depth: int = 4,
             max_bytes: int | None = None, size_fn=batch_nbytes,
             times: dict | None = None, metrics=None,
             name: str = "prefetch", tracer=None) -> Iterator[T]:
    """Run `it` on a producer thread, buffering up to `depth` items and,
    past `max_bytes` queued (default QUORUM_PREFETCH_QUEUE_BYTES, "1G";
    0 disables), blocking even below `depth`; an empty queue always
    admits one item. A producer exception re-raises at the consumer;
    abandoning the returned generator stops the producer and joins it.

    `times` (a dict, or None) accumulates "produce_s", the producer's
    seconds inside `it`, and "wait_s", the consumer's seconds blocked
    on the queue.

    `metrics` (an enabled telemetry registry, or None) records
    `<name>_queue_depth_max` (items buffered when the consumer asks),
    `<name>_queue_bytes_max` (the buffer's byte high-water) and
    `<name>_producer_stall_seconds` (the producer's seconds blocked on
    a full or over-budget queue: the consumer was the bottleneck).
    `tracer` (an enabled span tracer, or None) records one
    `<name>_produce` span per item on the producer thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    budget = (queue_bytes_budget("QUORUM_PREFETCH_QUEUE_BYTES", "1G")
              if max_bytes is None else int(max_bytes))
    cv = threading.Condition()
    pending = {"bytes": 0}
    if times is not None:
        times.setdefault("produce_s", 0.0)
        times.setdefault("wait_s", 0.0)
    depth_g = metrics.gauge(f"{name}_queue_depth_max") if metrics else None
    bytes_g = (metrics.gauge(f"{name}_queue_bytes_max")
               if metrics and budget else None)
    stall_g = (metrics.gauge(f"{name}_producer_stall_seconds")
               if metrics else None)
    span = (tracer.span if tracer is not None and tracer.enabled
            else None)

    def put_data(item) -> bool:
        sz = size_fn(item) if budget else 0
        if budget and sz:
            t0 = time.perf_counter()
            blocked = False
            with cv:
                while (pending["bytes"] > 0
                       and pending["bytes"] + sz > budget):
                    if stop.is_set():
                        return False
                    blocked = True
                    cv.wait(0.2)
            if blocked and stall_g is not None:
                stall_g.add(time.perf_counter() - t0)
        if not put_or_stop(q, (_ITEM, sz, item), stop, stall_gauge=stall_g):
            return False
        if budget and sz:
            with cv:
                pending["bytes"] += sz
                high = pending["bytes"]
            if bytes_g is not None:
                bytes_g.set_max(high)
        return True

    def produce(src):
        if span is None:
            return next(src)
        with span(f"{name}_produce"):
            return next(src)

    def loop():
        src = iter(it)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = produce(src)
                except StopIteration:
                    break
                finally:
                    if times is not None:
                        times["produce_s"] += time.perf_counter() - t0
                if not put_data(item):
                    return
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            put_or_stop(q, ("__prefetch_error__", e), stop)
        finally:
            # release what the source holds (a pooled reader's workers)
            close = getattr(src, "close", None)
            if close is not None:
                close()
            put_or_stop(q, _STOP, stop)

    t = threading.Thread(target=loop, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            if depth_g is not None:
                depth_g.set_max(q.qsize())
            t0 = time.perf_counter()
            item = q.get()
            if times is not None:
                times["wait_s"] += time.perf_counter() - t0
            if item is _STOP:
                break
            if item[0] == "__prefetch_error__":
                raise item[1]
            _tag, sz, payload = item
            if budget and sz:
                with cv:
                    pending["bytes"] -= sz
                    cv.notify_all()
            yield payload
    finally:
        stop.set()
        with cv:
            cv.notify_all()
        if t is not threading.current_thread():  # a collector may run here
            t.join()


class ReorderingPool:
    """N workers behind a sequence-numbered reorder stage: work is
    submitted in input order, runs on any worker, and its results reach
    `sink` (on the caller's thread) strictly in submission order, so the
    output bytes do not depend on N. With `max_pending` (default 2N)
    items in flight, submit() first drains the head. A worker exception
    re-raises at the drain point (submit or flush)."""

    def __init__(self, workers: int, sink, max_pending: int | None = None):
        self.workers = max(1, int(workers))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            self.workers, thread_name_prefix="render")
        self._pending: collections.deque = collections.deque()
        self._sink = sink
        self._max = max_pending if max_pending else 2 * self.workers
        self._reorder_wait = 0.0

    def submit(self, fn, *args) -> None:
        while len(self._pending) >= self._max:
            self._drain_one()
        self._pending.append(self._pool.submit(fn, *args))

    def _drain_one(self) -> None:
        fut = self._pending.popleft()
        t0 = time.perf_counter()
        result = fut.result()  # re-raises a worker exception, in order
        self._reorder_wait += time.perf_counter() - t0
        self._sink(result)

    def flush(self) -> None:
        """Drain every pending item in submission order."""
        while self._pending:
            self._drain_one()

    def take_reorder_wait(self) -> float:
        """Seconds the drain spent blocked since the last call."""
        w, self._reorder_wait = self._reorder_wait, 0.0
        return w

    @property
    def depth(self) -> int:
        return len(self._pending)

    def shutdown(self) -> None:
        """Cancel what has not started and join the workers (flush()
        first for a clean drain)."""
        self._pending.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)


class AsyncWriter:
    """One writer thread draining (stream index, text) records to the
    streams. write() blocks only when `maxsize` records or more than
    `max_bytes` of text (default QUORUM_WRITER_QUEUE_BYTES, "256M"; 0
    disables) are queued; an empty queue always admits one record. A
    stream error makes the next write() raise (fail fast) and close()
    raise it once if no write() did; close() drains and joins; flush()
    is the barrier a stage-2 journal commit waits on. Each write passes
    the `writer.stream` fault site (utils/faults).
    `metrics` (an enabled telemetry registry, or None) records
    `writer_queue_depth_max` (records queued when the caller writes:
    maxsize means output I/O was the bottleneck) and
    `writer_queue_bytes_max` (the pending text's byte high-water)."""

    def __init__(self, streams, maxsize: int = 64,
                 max_bytes: int | None = None, metrics=None):
        self.streams = list(streams)
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.err: BaseException | None = None
        self._raised = False
        self.max_bytes = (queue_bytes_budget("QUORUM_WRITER_QUEUE_BYTES",
                                             "256M")
                          if max_bytes is None else int(max_bytes))
        self._cv = threading.Condition()
        self._pending_bytes = 0
        self._depth_g = (metrics.gauge("writer_queue_depth_max")
                         if metrics else None)
        self._bytes_g = (metrics.gauge("writer_queue_bytes_max")
                         if metrics and self.max_bytes else None)
        self.t = threading.Thread(target=self._loop, daemon=True,
                                  name="writer")
        self.t.start()

    def _loop(self):
        while True:
            item = self.q.get()
            if item is _STOP:
                return
            if isinstance(item, tuple) and item[0] is _FLUSH:
                # barrier: everything queued before it is written; the
                # streams are flushed before the waiter goes on
                if self.err is None:
                    try:
                        for s in self.streams:
                            s.flush()
                    except BaseException as e:  # noqa: BLE001
                        self.err = e
                item[1].set()
                continue
            i, text = item
            if self.max_bytes:
                with self._cv:
                    self._pending_bytes -= len(text)
                    self._cv.notify_all()
            if self.err is not None:
                continue  # drain without writing after a failure
            try:
                faults.inject("writer.stream", batch=i,
                              path=getattr(self.streams[i], "name", None))
                self.streams[i].write(text)
            except BaseException as e:  # noqa: BLE001 - surfaced later
                self.err = e

    def flush(self) -> None:
        """Block until every record queued so far is written and the
        streams are flushed (a stage-2 journal must never claim bytes
        the files might not have); raise a stream error."""
        done = threading.Event()
        self.q.put((_FLUSH, done))
        done.wait()
        if self.err is not None:
            self._raised = True
            raise self.err

    def write(self, i: int, text: str) -> None:
        if self.err is not None:
            self._raised = True
            raise self.err
        if not text:
            return
        if self.max_bytes:
            with self._cv:
                while (self._pending_bytes > 0
                       and self._pending_bytes + len(text) > self.max_bytes):
                    if self.err is not None:
                        break  # close() surfaces it
                    self._cv.wait(0.2)
                self._pending_bytes += len(text)
                high = self._pending_bytes
            if self._bytes_g is not None:
                self._bytes_g.set_max(high)
        if self._depth_g is not None:
            self._depth_g.set_max(self.q.qsize() + 1)
        self.q.put((i, text))

    def close(self) -> None:
        self.q.put(_STOP)
        self.t.join()
        if self.err is not None and not self._raised:
            self._raised = True
            raise self.err
