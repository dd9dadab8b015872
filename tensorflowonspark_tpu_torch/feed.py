"""In-node user API: the feed-plane consumer (``DataFeed``), the port's
copy of the JAX package's ``feed.py``. The lockstep loop
(:meth:`DataFeed.sync_batches`) agrees through
:func:`~tensorflowonspark_tpu_torch.parallel.multihost.agree_sum` on a gloo
group; :meth:`DataFeed.decoded_batches` needs the decode pool, which is
ROADMAP A12.

Keeps the reference's user contract exactly
(``tensorflowonspark/TFNode.py:182-291``):

* ``next_batch(n)`` blocks on the executor's ``input`` queue, returns up to
  ``n`` items; ``None`` on the queue means end-of-feed; an ``EndPartition``
  marker flushes the current batch during inference so outputs stay aligned
  per partition;
* ``batch_results(results)`` pushes inference outputs 1:1 onto the
  ``output`` queue;
* ``terminate()`` flips the executor state to ``'terminating'`` and drains
  whatever the feeder still has queued;
* ``should_stop()`` reports end-of-feed.

An addition: ``next_batch_arrays`` stacks items into contiguous
numpy arrays (optionally padding the short final batch) so the training loop
can hand a fixed-shape batch straight to the device — the per-item
Python object path of the reference (``TFSparkNode.py:392-394``) is the
throughput ceiling this framework removes.
"""

import logging
import queue as _queue_mod
import time

import numpy as np

from tensorflowonspark_tpu_torch import marker, telemetry

logger = logging.getLogger(__name__)


class DataFeed:
    """Consumer side of an executor's input/output queues."""

    def __init__(self, mgr, train_mode=True, qname_in="input", qname_out="output",
                 input_mapping=None):
        self.mgr = mgr
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.done_feeding = False
        # Sorted for deterministic column order, like the reference's sorted
        # feed columns (pipeline.py:404).
        self.input_tensors = (
            sorted(input_mapping.values()) if input_mapping is not None else None
        )
        # Per-item (trailing-shape, dtype) struct of the last non-empty
        # batch: an empty batch must reproduce it, not degrade to
        # np.asarray([])'s float64 (see next_batch_arrays).
        self._empty_template = None
        # Queue proxies by name, made once: each get_queue builds a new
        # proxy over three fresh authenticated manager connections, which
        # a call per batch (as in the JAX package) made the feed's main
        # cost per batch.
        self._queues = {}

    def _queue(self, name):
        q = self._queues.get(name)
        if q is None:
            q = self._queues[name] = self.mgr.get_queue(name)
        return q

    # -- input side ---------------------------------------------------------

    def next_batch(self, batch_size, block=True, poll=0.2):
        """Collect up to ``batch_size`` items (or until the feed ends).

        With ``block`` (default) each item is waited for indefinitely —
        the reference's semantics. With ``block=False`` items are waited at
        most ``poll`` seconds each and a short (possibly empty) batch is
        returned as soon as the queue runs dry — the SPMD mode, where a
        worker must never stall inside a collective-free region while its
        peers wait in one (see :meth:`sync_batches`).

        Returns a list of items, or — when ``input_mapping`` was given — a
        dict of per-tensor column lists.
        """
        if self.input_tensors is not None:
            batch = {name: [] for name in self.input_tensors}
        else:
            batch = []
        q = self._queue(self.qname_in)
        count = 0
        t_call = time.perf_counter()
        waited = 0.0
        while count < batch_size:
            t_get = time.perf_counter()
            try:
                item = q.get(block=True, timeout=None if block else poll)
            except _queue_mod.Empty:
                waited += time.perf_counter() - t_get
                break
            waited += time.perf_counter() - t_get
            if item is None:
                q.task_done()
                self.done_feeding = True
                break
            if isinstance(item, marker.EndPartition):
                q.task_done()
                # During inference a partition boundary must flush the batch
                # so batch_results stays aligned per partition
                # (reference TFNode.py:231-235).
                if not self.train_mode and count > 0:
                    break
                continue
            if self.input_tensors is not None:
                for name, value in zip(self.input_tensors, item):
                    batch[name].append(value)
            else:
                batch.append(item)
            count += 1
            q.task_done()
        # Feed-plane backpressure accounting: time blocked on the input
        # queue (vs. the call's total) is the "feeder can't keep up" split
        # that rides heartbeats into cluster_stats()/statusz; the span
        # lands per-call on the node timeline when recording is on.
        telemetry.inc("feed_wait_seconds", waited)
        telemetry.inc("feed_items_total", count)
        # Per-call wait histogram beside the cumulative counter: the
        # counter trends, the p99 names the stall.
        telemetry.observe("feed_batch_wait_seconds", waited)
        telemetry.record_span(
            "feed/next_batch", time.perf_counter() - t_call,
            items=count, wait=round(waited, 6))
        return batch

    def next_batch_arrays(self, batch_size, pad_to_full=False, block=True):
        """Like :meth:`next_batch` but stacked into numpy arrays.

        With ``pad_to_full`` the short final batch is zero-padded to
        ``batch_size`` (static shapes) and the boolean validity mask is
        returned alongside.

        Returns ``(arrays, mask)`` where ``arrays`` is an ndarray (or dict of
        ndarrays under ``input_mapping``) and ``mask`` has shape
        ``(batch_size,)`` (or ``(n,)`` unpadded).

        A zero-item batch (a drained queue in non-blocking SPMD mode)
        reuses the dtype/shape template of the last non-empty batch:
        ``np.asarray([])`` is float64, and letting an empty round change
        dtype or rank vs. real batches would hand the step a fresh
        signature. With ``pad_to_full`` the empty case is a full-size zero
        batch with an all-False mask (the same shape every other padded
        batch has); before any template exists the legacy empty arrays
        are returned.
        """
        batch = self.next_batch(batch_size, block=block)
        if self.input_tensors is not None:
            n = len(next(iter(batch.values()))) if batch else 0
            arrays = {k: np.asarray(v) for k, v in batch.items()}
        else:
            n = len(batch)
            arrays = np.asarray(batch)
        if n:
            self._empty_template = _struct_of(arrays, None)
        elif self._empty_template is not None:
            rows = batch_size if pad_to_full else 0
            return (_zeros_from_struct(self._empty_template, rows=rows),
                    np.zeros((rows,), dtype=bool))
        mask = np.ones((n,), dtype=bool)
        if pad_to_full and 0 < n < batch_size:
            pad = batch_size - n
            if isinstance(arrays, dict):
                arrays = {
                    k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                    for k, v in arrays.items()
                }
            else:
                arrays = np.concatenate(
                    [arrays, np.zeros((pad,) + arrays.shape[1:], arrays.dtype)]
                )
            mask = np.concatenate([mask, np.zeros((pad,), dtype=bool)])
        return arrays, mask

    def should_stop(self):
        """True once the feeder signalled end-of-feed."""
        return self.done_feeding

    def sync_batches(self, batch_size, example=None):
        """Yield ``(arrays, mask)`` batches, kept in lockstep across an SPMD
        multi-process runtime.

        Single-process this is just the standard blocking batch loop. In a
        multi-process runtime (``ctx.initialize_distributed()``) every
        worker's train step is one global SPMD program, so all workers must
        issue the same number of steps even when the feed hands them uneven
        partitions — otherwise the job deadlocks in a collective. Protocol:
        drain the local queue without indefinite blocking, then all-reduce
        ``(have_data, done)`` each round (:func:`multihost.agree_sum`);
        workers with no local data contribute a zero batch with a zero mask
        (shaped from ``example`` or the last real batch), and the loop ends
        only when *every* worker agrees its feed is done.

        ``example``: optional dict/array giving the per-item shapes+dtypes,
        needed only for the corner where a worker must emit a zero batch
        before it ever saw a real one.
        """
        from tensorflowonspark_tpu_torch.parallel import multihost

        multi = multihost.is_multiprocess()
        # Template = {name: (shape, dtype)} structs; zero arrays are built
        # lazily on the rare round that actually needs one.
        template = _struct_of(example, batch_size) if example is not None else None

        while True:
            arrays, mask = self.next_batch_arrays(
                batch_size, pad_to_full=True, block=not multi
            )
            n = int(mask.sum())
            if not multi:
                if n > 0:
                    yield arrays, mask
                # Re-check AFTER the yield too: the end-of-feed sentinel can
                # arrive inside a partial batch, and re-entering a blocking
                # get() on a drained queue would hang the node forever.
                if self.should_stop():
                    return
                continue

            done = 1.0 if self.should_stop() else 0.0
            have, all_done = multihost.agree_sum([1.0 if n else 0.0, done])
            if have == 0.0:
                if all_done >= multihost.process_count():
                    return
                time.sleep(0.05)
                continue
            if n == 0:
                # next_batch_arrays already shaped the empty round as a
                # full-size zero batch when it had seen a real batch (its
                # _empty_template); only the never-saw-data corner needs
                # the constructor-supplied `example` struct.
                if mask.shape[0] != batch_size:
                    if template is None:
                        raise RuntimeError(
                            "sync_batches needs `example` to emit a zero "
                            "batch before the first real one"
                        )
                    arrays = _zeros_from_struct(template)
                    mask = np.zeros((batch_size,), dtype=bool)
            else:
                template = _struct_of(arrays, None)
            yield arrays, mask

    def decoded_batches(self, batch_size, decode_fn, workers=0,
                        window=None, block=True):
        """The JAX package's decode-pool face of the feed (decode fanned
        out to worker processes, results in feed order). Not ported: it
        raises, naming ROADMAP A12."""
        raise NotImplementedError(
            "DataFeed.decoded_batches needs data/decode_pool, which is not "
            "ported (ROADMAP A12); decode in the node program over "
            "next_batch or sync_batches instead")

    # -- output side --------------------------------------------------------

    def batch_results(self, results):
        """Push one batch of inference results (1:1 with consumed inputs)."""
        q = self._queue(self.qname_out)
        for item in results:
            q.put(item, block=True)

    # -- lifecycle ----------------------------------------------------------

    def terminate(self):
        """Stop training early: mark terminating and drain pending input.

        Mirrors reference ``TFNode.py:268-291`` — the feeder tasks see the
        ``'terminating'`` state and skip their partitions, while we drain
        whatever is already queued so their ``queue.join()`` unblocks.
        """
        logger.info("terminate() invoked — draining input queue")
        self.mgr.set("state", "terminating")
        q = self.mgr.get_queue(self.qname_in)
        done = False
        while not done:
            try:
                item = q.get(block=True, timeout=5)
                q.task_done()
                if item is None:
                    self.done_feeding = True
            except _queue_mod.Empty:
                done = True


def _struct_of(arrays, batch_size):
    """``(shape, dtype)`` structs for a batch (or per-item ``example`` when
    ``batch_size`` is given — its leading dim is replaced)."""
    def _s(v):
        v = np.asarray(v)
        shape = v.shape if batch_size is None else (batch_size,) + v.shape[1:]
        return (shape, v.dtype)

    if isinstance(arrays, dict):
        return {k: _s(v) for k, v in arrays.items()}
    return _s(arrays)


def _zeros_from_struct(struct, rows=None):
    """Zero batch from a ``_struct_of`` struct; ``rows`` overrides the
    leading (batch) dim — e.g. 0 for a typed empty batch."""
    def _z(s):
        shape, dtype = s
        if rows is not None:
            shape = (rows,) + tuple(shape[1:])
        return np.zeros(shape, dtype)

    if isinstance(struct, dict):
        return {k: _z(s) for k, s in struct.items()}
    return _z(struct)


def _poll_error_queue(mgr, timeout=0):
    """Re-raise a compute-child traceback recorded on the ``error`` queue.

    Analog of the reference's feeder-side error monitoring
    (``TFSparkNode.py:397-404``).
    """
    deadline = time.time() + timeout
    err_q = mgr.get_queue("error")
    while True:
        try:
            tb = err_q.get(block=False)
            err_q.task_done()
            raise RuntimeError("remote compute process failed:\n{}".format(tb))
        except _queue_mod.Empty:
            if time.time() >= deadline:
                return
            time.sleep(0.1)
