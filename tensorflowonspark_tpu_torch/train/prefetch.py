"""Device-side batch prefetch (port of ``train/prefetch.py``): the copy of
batch N+1 to the card rides under the compute of batch N.

A background thread pulls host batches from any iterator (a generator, a
data pipeline, ``(arrays, mask)`` tuples: dicts, lists and tuples of
arrays) and places each with a :class:`BatchPlacer`, keeping ``depth``
placed batches queued. On the card the producer copies on a side
``torch.cuda.Stream`` of its own, from pinned host memory with
``non_blocking=True``, and records an event after the batch's copies; the
consumer's ``next()`` makes its current stream wait on that event and
marks each tensor with ``record_stream``, so the caching allocator does not
hand the memory out again while the step still reads it. The host never
waits for a copy. On the CPU the placer is ``torch.as_tensor(...,
device="cpu")`` and there are no streams.

``depth=0`` is the synchronous mode: no thread, each ``next()`` pulls and
places one batch on the consumer's thread and stream.

Usage::

    pf = DevicePrefetch(source, depth=2, placer=trainer.batch_placer)
    for batch in pf:            # leaves are tensors on the device;
        state, m = trainer.train_step(state, batch)   # no second copy
    pf.close()
"""

import logging
import queue as queue_mod
import threading
import time
import types
import weakref

import numpy as np
import torch

from tensorflowonspark_tpu_torch import device_info, telemetry, util

logger = logging.getLogger(__name__)

_END = object()


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _tensors(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class BatchPlacer:
    """Places a host batch's array leaves on one device.

    Tensors already on the device pass through unchanged; numeric numpy
    arrays and CPU tensors are copied there (on the card from pinned
    memory, ``non_blocking``, on the calling thread's current stream).
    Python scalars and object or string arrays pass through untouched."""

    def __init__(self, device):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

    def _leaf(self, x):
        if isinstance(x, np.ndarray):
            if x.dtype == object or x.dtype.kind in "USV":
                return x
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor) or x.device == self.device:
            return x
        if self.device.type == "cuda":
            if x.device.type == "cpu" and not x.is_pinned():
                x = x.pin_memory()
            return x.to(self.device, non_blocking=True)
        return torch.as_tensor(x, device=self.device)

    def __call__(self, batch):
        return _map_leaves(self._leaf, batch)


class DevicePrefetch:
    """Iterator of device-resident batches, ``depth`` in flight.

    One-shot (consumes ``source``); re-create per epoch. Producer
    exceptions surface in the consumer at the position they occurred.
    ``close()`` stops the background thread promptly and, when the source
    has a thread-safe ``close()``, closes it too, so a producer blocked
    inside the source unwinds. ``placer`` defaults to a
    :class:`BatchPlacer` for ``device`` (the card unless ``"cpu"`` is
    asked for).
    """

    def __init__(self, source, depth=2, placer=None, device="cuda"):
        if placer is None:
            placer = BatchPlacer(device_info.resolve_device(device))
        self.placer = placer
        self._device = getattr(placer, "device", None)
        self._source = source
        self._done = False
        self._sync = int(depth) <= 0
        if self._sync:
            self._iter = iter(source)
            self._q = None
            self._thread = None
            return
        self._q = queue_mod.Queue(maxsize=int(depth))
        self._stop = threading.Event()
        # The producer is a module-level function holding no reference to
        # self, so an abandoned DevicePrefetch is collectable; the
        # finalizer then stops the thread and frees the batches it held.
        self._thread = threading.Thread(
            target=_produce, name="device-prefetch", daemon=True,
            args=(source, placer, self._device, self._q, self._stop),
        )
        self._finalizer = weakref.finalize(self, self._stop.set)
        self._thread.start()

    # -- consumer -----------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        if self._sync:
            try:
                batch = next(self._iter)
            except StopIteration:
                self._done = True
                raise
            return self.placer(batch)
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue_mod.Empty:
                if self._stop.is_set() or (
                        not self._thread.is_alive() and self._q.empty()):
                    self._done = True
                    raise StopIteration
        # Queue occupancy and consumer stall: a depth near 0 under a rising
        # wait is the "producer cannot keep up" signal of cluster_stats.
        telemetry.set_gauge("prefetch_depth", self._q.qsize())
        telemetry.inc("prefetch_consumer_wait_seconds",
                      time.perf_counter() - t0)
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        telemetry.inc("prefetch_batches_total")
        placed, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in _tensors(placed):
                if t.device == self._device:
                    t.record_stream(stream)
        return placed

    # -- lifecycle ----------------------------------------------------------

    def close(self, timeout=2.0, close_source=True):
        """Stop prefetching and release the producer thread.

        Safe to call twice and mid-stream. ``close_source=False`` stops the
        prefetcher but leaves the source open for re-iteration
        (``Trainer.fit``'s steps-capped exit); batches already prefetched
        are dropped.
        """
        self._done = True
        if self._sync:
            if close_source:
                _close_source(self._source, generator_ok=True)
            return
        self._stop.set()
        if close_source:
            _close_source(self._source, generator_ok=False)
        # Unblock a producer waiting on a full queue; keep draining until
        # it exits (it may refill up to `depth` items after one drain).
        deadline = time.time() + timeout
        while self._thread.is_alive() and time.time() < deadline:
            while True:
                try:
                    self._q.get_nowait()
                except queue_mod.Empty:
                    break
            self._thread.join(0.05)
        if close_source and not self._thread.is_alive() and isinstance(
                self._source, types.GeneratorType):
            # Only once the producer has exited: closing a generator that
            # is inside __next__ on another thread raises ValueError.
            _close_source(self._source, generator_ok=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _produce(source, placer, device, q, stop):
    """Producer loop (module-level: it must not keep the DevicePrefetch
    alive, see the finalizer in ``__init__``)."""
    def put(item, always=False):
        return util.queue_put_bounded(
            q, item, stop.is_set, always=always, timeout=0.1)

    try:
        stream = None
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
            stream = torch.cuda.Stream(device)
        for batch in source:
            if stop.is_set():
                return
            t_place = time.perf_counter()
            if stream is None:
                item = (placer(batch), None)
            else:
                with torch.cuda.stream(stream):
                    placed = placer(batch)
                    item = (placed, stream.record_event())
            telemetry.observe("prefetch_place_seconds",
                              time.perf_counter() - t_place)
            t0 = time.perf_counter()
            ok = put(item)
            stalled = time.perf_counter() - t0
            if stalled > 0.001:
                # Blocked on a full queue: the device is the bottleneck.
                telemetry.inc("prefetch_producer_stall_seconds", stalled)
                telemetry.inc("prefetch_producer_stalls")
            if not ok:
                return
            telemetry.set_gauge("prefetch_depth", q.qsize())
        put(_END, always=True)
    except BaseException as e:  # surfaces in the consumer
        put(e, always=True)


def _close_source(source, generator_ok):
    close_fn = getattr(source, "close", None)
    if not callable(close_fn):
        return
    if isinstance(source, types.GeneratorType) and not generator_ok:
        return
    try:
        close_fn()
    except Exception:  # best-effort: the source may already be dead
        logger.debug("source close() failed", exc_info=True)
