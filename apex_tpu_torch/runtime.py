"""The prefetching input pipeline.

Counterpart of ``apex_tpu/runtime/__init__.py``'s ``PrefetchLoader``
(:222-441), the reference's ``data_prefetcher`` of
``examples/imagenet/main_amp.py``: a worker thread stages ``depth``
batches ahead, each copied from pinned host memory to the device on a
CUDA stream of its own, while the device runs the current step. The
consumer's stream waits on the batch's copy before using it.

The transfer's fault handling is the reference's: each copy is retried
``transfer_retries`` times with backoff and jitter (the ``device_put``
fault site); a batch that still fails kills the worker, which restarts
from the same source iterator (the failed batch first) up to
``max_worker_restarts`` times; past that the loader degrades to
synchronous loading (``degraded``). Errors of the source or of
``transform`` are never retried: they reach the consumer as they are.
The ``prefetch_*`` counters and gauges go to the process registry, and
each consumer-side wait is a ``data_wait`` span on the global timeline
when it is enabled.

The rest of the reference's runtime (``HostFlatSpace``, the host casts
and the native host library behind them) comes with the checkpoint and
host-runtime planes (the roadmap's A 10 and A 11).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from apex_tpu_torch._backend import DeviceLike, resolve_device


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _Staged:
    """A batch on the device and the event its copy recorded."""

    def __init__(self, batch, event):
        self.batch = batch
        self.event = event


class PrefetchLoader:
    """Background host-to-device pipeline over an iterable of batches
    (numpy arrays or tensors, in dicts, lists or tuples). ``depth``
    batches are staged ahead; ``transform`` runs on the worker thread.
    ``device`` is the card unless the caller names another; on the CPU
    the transfer is a ``torch.as_tensor``."""

    def __init__(self, batches: Iterable, depth: int = 2,
                 transform: Optional[Callable] = None,
                 device: DeviceLike = None, transfer_retries: int = 3,
                 max_worker_restarts: int = 2,
                 retry_base_delay: float = 0.05, join_timeout: float = 5.0):
        self._batches = batches
        self._depth = depth
        self._transform = transform
        self._device = resolve_device(device)
        self._consumed = False
        self._transfer_retries = int(transfer_retries)
        self._max_worker_restarts = int(max_worker_restarts)
        self._retry_base_delay = float(retry_base_delay)
        self._join_timeout = float(join_timeout)
        self.degraded = False          # fell back to synchronous loading
        self.worker_deaths = 0

    def __iter__(self) -> Iterator:
        # eager check (a generator body would defer it to the first next)
        if self._consumed:
            raise RuntimeError(
                "PrefetchLoader is single-pass: wrap a fresh iterable per "
                "epoch (two workers on one source would race and drop "
                "batches)")
        self._consumed = True
        return self._run()

    def _copy(self, a):
        t = torch.as_tensor(a)
        if self._device.type != "cuda":
            return t.to(self._device)
        if not t.is_cuda:
            t = t.pin_memory()
        return t.to(self._device, non_blocking=True)

    def _run(self) -> Iterator:
        from apex_tpu_torch.resilience import faults
        from apex_tpu_torch.resilience.retry import retry_call
        from apex_tpu_torch.telemetry import metrics as _metrics
        from apex_tpu_torch.telemetry import timeline as _timeline

        reg = _metrics.registry()
        m_depth = reg.gauge("prefetch_queue_depth",
                            "staged batches waiting in the prefetch queue")
        m_batches = reg.counter("prefetch_batches",
                                "batches delivered to the consumer")
        m_retries = reg.counter("prefetch_device_put_retries",
                                "device_put attempts that were retried")
        m_deaths = reg.counter("prefetch_worker_deaths",
                               "prefetch workers killed by exhausted "
                               "transfer retries")
        m_degraded = reg.gauge("prefetch_degraded",
                               "1 = loader fell back to synchronous "
                               "loading")

        cuda = self._device.type == "cuda"
        src = iter(self._batches)
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        end = object()

        class _TransferFailure:
            def __init__(self, exc):
                self.exc = exc

        # the batch a dying worker had staged but not delivered: the next
        # worker (or the synchronous fallback) takes it first
        pending = {"batch": None}
        streams = {}

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def transfer(b):
            faults.check("device_put")
            stall = faults.data_stall_s()
            if stall:
                time.sleep(stall)
            if not cuda:
                return _Staged(_tree_map(self._copy, b), None)
            tid = threading.get_ident()
            if tid not in streams:
                streams[tid] = torch.cuda.Stream(self._device)
            stream = streams[tid]
            with torch.cuda.stream(stream):
                d = _tree_map(self._copy, b)
                event = torch.cuda.Event()
                event.record(stream)
            return _Staged(d, event)

        def count_retry(attempt, exc, delay):  # noqa: ARG001
            m_retries.inc()

        def worker():
            try:
                while not stop.is_set():
                    if pending["batch"] is not None:
                        b, pending["batch"] = pending["batch"], None
                    else:
                        try:
                            b = next(src)
                        except StopIteration:
                            put(end)
                            return
                        if self._transform is not None:
                            b = self._transform(b)
                    pending["batch"] = b
                    try:
                        d = retry_call(
                            transfer, b, retries=self._transfer_retries,
                            base_delay=self._retry_base_delay,
                            retry_on=(Exception,), on_retry=count_retry,
                            site="device_put")
                    except Exception as e:  # noqa: BLE001 — death notice
                        put(_TransferFailure(e))
                        return
                    pending["batch"] = None
                    if not put(d):
                        return
            except BaseException as e:  # source/transform: as they are
                put(e)

        def spawn():
            t = threading.Thread(target=worker, daemon=True)
            t.start()
            return t

        def deliver(staged: _Staged):
            if staged.event is not None:
                cur = torch.cuda.current_stream(self._device)
                cur.wait_event(staged.event)
                _tree_map(lambda t: t.record_stream(cur), staged.batch)
            m_batches.inc()
            return staged.batch

        t = spawn()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                _timeline.record_global_span(
                    "data_wait", t0, time.perf_counter() - t0)
                m_depth.set(q.qsize())
                if item is end:
                    break
                if isinstance(item, _TransferFailure):
                    t.join(timeout=self._join_timeout)
                    self.worker_deaths += 1
                    m_deaths.inc()
                    if self.worker_deaths <= self._max_worker_restarts:
                        t = spawn()
                        continue
                    # no more workers: finish synchronously (the overlap
                    # is lost, no batch is), errors propagate
                    self.degraded = True
                    m_degraded.set(1.0)
                    if pending["batch"] is not None:
                        b, pending["batch"] = pending["batch"], None
                        yield deliver(transfer(b))
                    for b in src:
                        if self._transform is not None:
                            b = self._transform(b)
                        yield deliver(transfer(b))
                    break
                if isinstance(item, BaseException):
                    raise item
                yield deliver(item)
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=self._join_timeout)


__all__ = ["PrefetchLoader"]
