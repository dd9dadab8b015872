"""Host-side input pipeline for FILES mode (the port's copy of the JAX
package's ``data/input_pipeline.py``; the batches are equal).

The reference's ``InputMode.TENSORFLOW`` delegated input to TF readers —
file queues / ``tf.data`` with per-worker ``shard(num_workers, task_index)``
(``examples/mnist/tf/mnist_dist_dataset.py:25,78``). This is the TPU-native
equivalent: each host strides the shard list, decodes TFRecords through the
native (C++) record + Example codecs into columnar numpy batches, and a
background prefetch thread keeps the next batches ready so the card never
waits on record IO (SURVEY.md §7.3). Batches are numpy: tensors appear only
at the Trainer's and ``DevicePrefetch``'s boundary.

Scaling levers:

* ``decode_workers=N`` — batches decode on a :class:`~.decode_pool
  .DecodePool` of N worker *processes* (record bytes fan out, decoded
  columnar batches come back in order), so the decode stage scales with
  host cores instead of riding the single producer thread. The workers
  start by forkserver, so a ``transform`` must pickle (a module-level
  function, a ``functools.partial`` or a callable object);
* ``reader_threads=R`` — R record readers pull different files of this
  host's shard concurrently (record order across files becomes interleaved;
  per-file order is preserved);
* ``cache_dir=...`` — finished batches spill to a columnar cache file
  during the first decoded epoch; later epochs replay from it and skip
  decode entirely (:mod:`~.batch_cache`).

Usage::

    pipe = InputPipeline(
        data_dir, columns={"image": ("float", 784), "label": ("int64", 1)},
        batch_size=256, shard=(ctx.num_workers, ctx.task_index),
        epochs=2, shuffle_files=True, seed=0,
    )
    for batch in pipe:            # {"image": (256, 784) f32,
        ...                       #  "label": (256,) i64, "mask": (256,) bool}
"""

import logging
import queue as queue_mod
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch import telemetry, util
from tensorflowonspark_tpu_torch.data import (
    batch_cache,
    batch_decode,
    decode_pool,
    dfutil,
    tfrecord,
)

logger = logging.getLogger(__name__)

_END = object()


class InputPipeline:
    """Sharded, prefetching, fixed-shape TFRecord batch iterator."""

    def __init__(self, source, columns, batch_size, shard=(1, 0),
                 epochs=1, shuffle_files=False, shuffle_buffer=0, seed=0,
                 pad_final=True, drop_remainder=False, prefetch=2,
                 use_native=True, transform=None, decode_workers=0,
                 reader_threads=1, cache_dir=None, cache_tag="",
                 prefetch_batches=None, decode_shared_memory=None):
        """``source``: a TFRecord dir or explicit file list. ``columns``:
        the :mod:`batch_decode` column spec ``{name: (kind, length)}``.
        ``shard=(n, i)``: this host's stride of the sorted file list.
        ``epochs=None``: cycle forever. ``shuffle_buffer=N``: streaming
        record-level shuffle through an N-record reservoir (tf.data's
        ``shuffle(buffer_size)`` semantics; ``shuffle_files`` only
        permutes whole files). ``pad_final``: zero-pad the short final
        batch (static shapes for XLA) with validity in ``"mask"``;
        ``drop_remainder`` drops it instead. ``transform``: optional
        ``dict -> dict`` applied to each finished batch (decode/augment/
        cast). With ``decode_workers`` the transform runs inside the
        worker processes — it must pickle, stay torch-free and be
        deterministic; batch
        dicts carry a ``"_base_index"`` key (the global index of the
        batch's first record) while the transform runs so augmentation
        can seed per record index regardless of which worker decodes
        (``image_preprocessing.batch_transform`` uses it).

        ``decode_workers=N``: decode on an N-process pool (0 = inline on
        the producer thread, the previous behavior). ``reader_threads=R``:
        R concurrent record readers over this shard's files (R > 1
        interleaves records across files — per-file order is kept, global
        order is no longer deterministic; combine with ``shuffle_buffer``
        when stochastic order is wanted anyway). ``cache_dir``: spill
        decoded batches during the first epoch, replay later epochs from
        the cache (epochs become batch-aligned — the remainder flushes
        per epoch instead of spanning into the next; cached replays reuse
        the first epoch's augmentations). ``cache_tag``
        must name the transform configuration: the cache fingerprints its
        source files and geometry but cannot fingerprint a callable.
        ``prefetch_batches`` is the public alias of ``prefetch`` (decoded
        batches buffered ahead of the consumer)."""
        files = (
            list(source) if isinstance(source, (list, tuple))
            else dfutil.tfrecord_files(source)
        )
        num_shards, index = shard
        self.files = sorted(files)[index::num_shards]
        self.columns = dict(columns)
        self.batch_size = int(batch_size)
        self.epochs = epochs
        self.shuffle_files = shuffle_files
        self.shuffle_buffer = int(shuffle_buffer)
        self.seed = seed
        self.pad_final = pad_final
        self.drop_remainder = drop_remainder
        if prefetch_batches is not None:
            prefetch = prefetch_batches
        self.prefetch = max(1, int(prefetch))
        self.use_native = use_native
        self.transform = transform
        self.decode_workers = int(decode_workers)
        # None = DecodePool's auto default (shared-memory result path on
        # POSIX); False forces the pickle-over-pipe transport.
        self.decode_shared_memory = decode_shared_memory
        self.reader_threads = max(1, int(reader_threads))
        self.cache_dir = None if cache_dir is None else str(cache_dir)
        self.cache_tag = cache_tag
        self._stop = threading.Event()
        # The current iteration's DecodePool (None until a decoded epoch
        # starts). Exposed for the chaos harness — testing/faults.py's
        # kill_decode_worker drill SIGKILLs one of its workers.
        self._pool = None

    @property
    def prefetch_batches(self):
        """Decoded batches buffered ahead of the consumer (the bounded
        hand-off queue's size)."""
        return self.prefetch

    # -- iteration -----------------------------------------------------------

    def __iter__(self):
        # Re-iterable: each iter() gets its own producer thread and stop
        # event (a shared stop would make the second iteration silently
        # empty); close() ends all current and future iterations.
        q = queue_mod.Queue(maxsize=self.prefetch)
        empty = queue_mod.Empty
        stop = threading.Event()
        worker = threading.Thread(
            target=self._produce, args=(q, stop), name="input-pipeline",
            daemon=True,
        )
        worker.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.2)
                except empty:
                    # The producer exits WITHOUT a sentinel when it sees
                    # stop mid-epoch (close() from another thread) or
                    # dies hard — a bare blocking get() here would hang
                    # this consumer forever on the drained queue.
                    if stop.is_set() or self._stop.is_set():
                        return
                    if not worker.is_alive():
                        # One last non-blocking look: the producer may
                        # have enqueued its final item between our
                        # timeout and the liveness check.
                        try:
                            item = q.get_nowait()
                        except empty:
                            return
                    else:
                        continue
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Unblock a producer waiting on a full queue. NB: `empty` was
            # bound before the yield loop — this finally can run at
            # generator finalization during interpreter shutdown, after
            # module globals (queue_mod) have been cleared.
            while True:
                try:
                    q.get_nowait()
                except empty:
                    break

    def _produce(self, q, stop):
        def stopped():
            return stop.is_set() or self._stop.is_set()

        pool = None
        writer = None
        readers = {}  # digest -> BatchCacheReader (index built once)
        # Shared decode cursor: epoch counter, the partial batch, and the
        # global record index (augmentation seed base). A dict so the
        # payload generators below mutate the SAME cursor the loop reads.
        state = {"epoch": 0, "pending": [], "base": 0}
        try:
            digest = self._cache_digest() if self.cache_dir else None
            while not stopped():
                if self.epochs is not None and state["epoch"] >= self.epochs:
                    break
                manifest = (
                    batch_cache.load_manifest(self.cache_dir, digest,
                                              tag=self._cache_name(digest))
                    if digest else None
                )
                if manifest is not None:
                    if not self._replay_epoch(q, manifest, readers,
                                              state["epoch"], stopped):
                        return
                    state["epoch"] += 1
                    continue
                # Decode run. Without a cache this is ONE continuous
                # payload stream over ALL remaining epochs — a single
                # pool.imap keeps the lookahead window full across epoch
                # boundaries (a per-epoch stream would drain the pool to
                # empty between epochs: a full pipeline barrier that
                # measurably halves short-epoch throughput). With a
                # cache the run is exactly one batch-aligned epoch, so
                # the finished file can be committed at its boundary.
                one_epoch = digest is not None
                payloads = self._epoch_payloads(
                    state, stopped, max_epochs=1 if one_epoch else None)
                if self.decode_workers > 0:
                    if pool is None:
                        pool = self._pool = decode_pool.DecodePool(
                            self._decoder(),
                            workers=self.decode_workers,
                            name="input-pipeline",
                            shared_memory=self.decode_shared_memory)
                    batches = pool.imap(
                        payloads,
                        context_fn=lambda i, p: p[3], stopped=stopped)
                else:
                    decode = self._decoder()
                    batches = (decode(p) for p in payloads)
                if one_epoch:
                    writer = batch_cache.BatchCacheWriter(
                        self.cache_dir, digest, tag=self._cache_name(digest))
                delivered = True
                for batch in batches:
                    if writer is not None:
                        writer.append(batch)
                    if not self._put(q, batch, stopped) or stopped():
                        delivered = False
                        break
                if not delivered or stopped():
                    # finally aborts the writer: a partial epoch must
                    # never be committed as a complete cache.
                    return
                if writer is not None:
                    writer.finalize()
                    writer = None
                    if pool is not None:
                        # The committed manifest guarantees every later
                        # epoch replays — close the decode workers now
                        # instead of letting them idle-poll through the
                        # rest of the run (the respawn path above covers
                        # the rare mid-run rebuild).
                        pool.close()
                        pool = self._pool = None
            if pool is not None:
                # Reap workers on the clean-exit path before signalling
                # end-of-stream — a finished pipeline must not leave
                # children for the process-exit reaper.
                pool.close()
                pool = None
            self._put(q, _END, stopped, always=True)
        except BaseException as e:  # surfaces in the consumer
            self._put(q, e, stopped, always=True)
        finally:
            if writer is not None:
                writer.abort()
            if pool is not None:
                pool.close()

    def _epoch_payloads(self, state, stopped, max_epochs=None):
        """Yield decode payloads, advancing ``state`` as epochs complete.

        ``max_epochs=1`` (the cache path): exactly one epoch, with the
        short remainder flushed at the epoch boundary so the cached
        epoch is self-contained. ``max_epochs=None`` (the plain path):
        every remaining epoch as one continuous stream — batches may
        span epoch boundaries (the historical semantics) and the
        remainder is yielded once, at the very end."""
        done = 0
        while not stopped():
            epoch = state["epoch"]
            if self.epochs is not None and epoch >= self.epochs:
                break
            if max_epochs is not None and done >= max_epochs:
                break
            files = list(self.files)
            if self.shuffle_files:
                np.random.RandomState(self.seed + epoch).shuffle(files)
            stream = self._epoch_records(files, stopped)
            if self.shuffle_buffer > 1:
                stream = _reservoir_shuffle(
                    stream, self.shuffle_buffer,
                    np.random.RandomState(self.seed + 7919 * (epoch + 1)),
                )
            for item in stream:
                state["pending"].append(item)
                if len(state["pending"]) >= self.batch_size:
                    records, state["pending"] = state["pending"], []
                    yield self._payload(records, True, state["base"])
                    state["base"] += len(records)
                if stopped():
                    return  # partial epoch: do not advance the cursor
            if stopped():
                return
            state["epoch"] += 1
            done += 1
            if max_epochs is not None:
                records, state["pending"] = state["pending"], []
                if records and not self.drop_remainder:
                    yield self._payload(records, False, state["base"])
                    state["base"] += len(records)
        if max_epochs is None and state["pending"] \
                and not self.drop_remainder and not stopped():
            records, state["pending"] = state["pending"], []
            yield self._payload(records, False, state["base"])
            state["base"] += len(records)

    # -- record readers ------------------------------------------------------

    def _epoch_records(self, files, stopped):
        """Yield ``(record, path, offset)`` provenance-tagged records.

        With ``reader_threads > 1``, that many reader threads each take a
        stride of ``files`` and feed a bounded hand-off queue — record IO
        and native record parsing for several files overlap. Per-file
        record order is preserved; cross-file interleaving is
        scheduler-dependent."""
        n = min(self.reader_threads, max(1, len(files)))
        if n <= 1:
            for path in files:
                offset = 0
                for record in tfrecord.read_records(
                        path, use_native=self.use_native):
                    yield (record, path, offset)
                    offset += 1
            return
        rq = queue_mod.Queue(maxsize=max(256, 2 * self.batch_size))

        def read(mine):
            # Every reader enqueues its OWN end sentinel; the consumer
            # returns after collecting all n. In-order delivery per
            # thread means a sentinel is always behind that reader's
            # records — no liveness checks, no tail-drain races.
            try:
                for path in mine:
                    offset = 0
                    for record in tfrecord.read_records(
                            path, use_native=self.use_native):
                        if not util.queue_put_bounded(
                                rq, (record, path, offset), stopped):
                            return
                        offset += 1
            except BaseException as e:
                util.queue_put_bounded(rq, e, stopped, always=True)
            finally:
                util.queue_put_bounded(rq, _END, stopped, always=True)

        threads = [
            threading.Thread(target=read, args=(files[i::n],),
                             name="record-reader-{}".format(i), daemon=True)
            for i in range(n)
        ]
        for t in threads:
            t.start()
        ended = 0
        while ended < n:
            try:
                item = rq.get(timeout=0.2)
            except queue_mod.Empty:
                if stopped():
                    return
                continue
            if item is _END:
                ended += 1
            elif isinstance(item, BaseException):
                raise item
            else:
                yield item

    # -- decode --------------------------------------------------------------

    def _payload(self, items, full, base):
        """A decode-pool task: raw record bytes + provenance context."""
        records = [r for r, _, _ in items]
        first, last = items[0], items[-1]
        context = {"file": first[1], "record": first[2],
                   "last_file": last[1], "last_record": last[2]}
        return (records, bool(full), int(base), context)

    def _decoder(self):
        """The picklable payload decoder (runs inline or in a pool
        worker)."""
        return PayloadDecoder(self.columns, self.batch_size, self.pad_final,
                              self.use_native, self.transform)

    # -- cache ---------------------------------------------------------------

    def _cache_name(self, digest):
        # Digest-keyed file names: pipelines sharing one cache_dir
        # (per-shard SPMD workers, train + eval) must not clobber each
        # other's data files — a constant name would let shard A stream
        # shard B's decoded records after B's commit replaced the file.
        return "cache-" + digest[:12]

    def _cache_digest(self):
        return batch_cache.config_digest(
            self.files, self.batch_size, self.columns, self.pad_final,
            self.drop_remainder, cache_tag=self.cache_tag,
            extra={"seed": self.seed, "shuffle_files": self.shuffle_files,
                   "shuffle_buffer": self.shuffle_buffer})

    def _replay_epoch(self, q, manifest, readers, epoch, stopped):
        """One epoch straight from the committed cache — no decode."""
        digest = manifest["digest"]
        reader = readers.get(digest)
        if reader is None:
            reader = readers[digest] = batch_cache.BatchCacheReader(
                self.cache_dir, manifest, tag=self._cache_name(digest))
        order = None
        if (epoch > 0 and (self.shuffle_files or self.shuffle_buffer > 1)
                and manifest["batches"] > 1):
            # Stochastic epochs keep a per-epoch batch order on replay;
            # intra-batch composition is fixed by the cached epoch.
            # Epoch 0 replays in FILE order: the cache was written in the
            # first epoch's (already-shuffled) stream order, so a rebuilt
            # same-seed pipeline reproduces the original stream exactly.
            order = np.random.RandomState(
                self.seed + 7919 * (epoch + 1)).permutation(
                    manifest["batches"])
        t0 = time.perf_counter()
        n = 0
        for batch in reader.iter_batches(order):
            if not self._put(q, batch, stopped) or stopped():
                return False
            n += 1
        telemetry.record_span(
            "ingest/cache_replay", time.perf_counter() - t0,
            batches=n, records=manifest.get("records"), epoch=epoch)
        telemetry.inc("ingest_cached_batches_total", n)
        return True

    # -- plumbing ------------------------------------------------------------

    def _put(self, q, item, stopped, always=False):
        """Queue-put that gives up when the consumer went away.

        ``always`` items (the ``_END`` sentinel, a producer exception) keep
        retrying while the pipeline is live — they must reach a slow
        consumer — but once ``stopped()`` the retries are bounded (~5s) so
        an abandoned pipeline cannot leak its producer thread."""
        return util.queue_put_bounded(q, item, stopped, always=always)

    def close(self):
        self._stop.set()


def _reservoir_shuffle(stream, size, rng):
    """Streaming shuffle: keep a ``size``-record reservoir; each incoming
    record evicts (yields) a uniformly random resident, then the reservoir
    drains in random order."""
    buf = []
    for record in stream:
        if len(buf) < size:
            buf.append(record)
            continue
        i = rng.randint(size)
        out, buf[i] = buf[i], record
        yield out
    rng.shuffle(buf)
    for record in buf:
        yield record


class PayloadDecoder:
    """Decodes one payload into a finished batch: the records' columns, the
    short batch's padding and ``"mask"``, then the transform. A plain
    object, so it pickles to a decode-pool worker (the JAX package hands
    its pool the pipeline's bound method, which ``fork`` carries)."""

    def __init__(self, columns, batch_size, pad_final, use_native,
                 transform):
        self.columns = columns
        self.batch_size = batch_size
        self.pad_final = pad_final
        self.use_native = use_native
        self.transform = transform

    def __call__(self, payload):
        """Raises :class:`decode_pool.DecodeError` carrying the failing
        file/record offsets."""
        records, full, base, context = payload
        try:
            batch = batch_decode.decode_batch(
                records, self.columns, use_native=self.use_native
            )
            n = len(records)
            mask = np.ones((n,), dtype=bool)
            if not full and self.pad_final and n < self.batch_size:
                pad = self.batch_size - n
                for name, arr in batch.items():
                    batch[name] = np.concatenate(
                        [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)]
                    )
                mask = np.concatenate([mask, np.zeros((pad,), dtype=bool)])
            batch["mask"] = mask
            if self.transform is not None:
                # The record-index hint is OPT-IN (batch_transform sets
                # wants_base_index): arbitrary user transforms that map
                # over every column must never see a surprise int key.
                wants_base = getattr(
                    self.transform, "wants_base_index", False)
                if wants_base:
                    batch["_base_index"] = base
                batch = self.transform(batch)
                if wants_base and isinstance(batch, dict):
                    batch.pop("_base_index", None)
            return batch
        except decode_pool.DecodeError:
            raise
        except BaseException as e:
            raise decode_pool.DecodeError(
                "batch decode failed: {}: {} (batch of {} record(s) from "
                "{!r} record {} through {!r} record {})".format(
                    type(e).__name__, e, len(records), context["file"],
                    context["record"], context["last_file"],
                    context["last_record"]),
                context=context) from e
