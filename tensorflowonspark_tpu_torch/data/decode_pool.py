"""Multi-process decode pool: the host-ingest plane's parallel unit (the
port's counterpart of the JAX package's ``data/decode_pool.py``).

A :class:`DecodePool` fans raw payloads (record lists, JPEG bytes, any
picklable unit) out to N worker *processes* and hands results back **in
submission order**, so both ingest tiers scale with host cores instead
of one:

* FILES mode — ``InputPipeline(decode_workers=N)`` submits each formed
  batch's raw records and re-enqueues decoded columnar batches;
* FEED mode — ``DataFeed.decoded_batches(..., workers=N)`` pipelines
  queue drain with decode.

Design (the same backpressure discipline as the rest of the feed plane —
bounded queues everywhere, ``util.queue_put_bounded`` for giving up when
the consumer vanishes):

* workers are never ``fork``-ed from the pool's owner. A forked child of
  a process that has initialised CUDA cannot use CUDA, and a forked child
  keeps its parent's descriptors (a test runner's pipes among them), so it
  can pin a dying parent's peers. Workers start from the ``forkserver``
  context: one clean server process per owner, started by ``exec`` with
  this package's data modules preloaded, forks each worker in
  milliseconds. Where the platform has no forkserver, ``spawn``. So the
  decode fn crosses to the workers by pickle: a module-level function, a
  ``functools.partial`` or a callable object, never a closure (the JAX
  pool forks and takes closures). An unpicklable fn raises ``TypeError``
  when the pool starts. As under ``spawn``, each worker imports the
  owner's main script, so a script that starts a pool keeps its work
  under ``if __name__ == "__main__":``. Workers stay torch-free: they
  decode with numpy (and PIL), never touch the card, and exit on their
  own once the owner (or its forkserver) is gone.
* each worker owns a small **bounded** task queue (round-robin dispatch
  with least-loaded preference) and a result pipe of its own, which only
  it writes — task bytes in flight are capped at ``window`` batches, so
  a fast reader cannot balloon the pool's memory. A worker killed in the
  middle of a write breaks only its own pipe (the JAX pool's workers
  share one result queue, whose lock a killed writer can hold forever).
* the parent retains every submitted payload until its result arrives.
  If a worker dies mid-task (OOM-killed, segfaulted, chaos-injected),
  the parent detects the dead child, **re-decodes the lost sequence
  numbers inline**, replaces the worker, and the ordered stream
  continues with no duplicated or dropped units — the property
  ``tests/test_torch_decode_pool.py`` drills under ``testing/faults.py``.
* workers never block indefinitely (``get(timeout=...)`` loops), so they
  notice a stop and their owner's death within one poll.

Telemetry (parent-side only — worker durations ride the result tuples,
so no cross-process metric aggregation is needed): ``ingest_*`` gauges
and counters, an ``ingest_decode_seconds`` histogram whose p50/p95/p99
ride ``node_stats()`` into heartbeats, and ``ingest/*`` spans on the
node timeline.
"""

import itertools
import logging
import multiprocessing
import multiprocessing.connection as mp_connection
import os
import pickle
import queue as queue_mod
import signal
import threading
import time
import traceback

import numpy as np

from tensorflowonspark_tpu_torch import telemetry

logger = logging.getLogger(__name__)

_END = object()

# Tasks in flight per worker: 2 keeps a worker busy while its previous
# result crosses its pipe without letting one slow worker hoard work.
WORKER_DEPTH = 2

# Result poll period. Also the worker wake period: a worker checks its
# stop event and its owner's liveness once a period.
_POLL = 0.2

# The modules the forkserver imports before it forks any worker: a worker
# then starts with its decode code loaded.
PRELOAD = ("tensorflowonspark_tpu_torch.data.decode_pool",
           "tensorflowonspark_tpu_torch.data.input_pipeline",
           "tensorflowonspark_tpu_torch.data.image_preprocessing")

# Shared-memory result path: a pickled result (~150 KB an image) crosses
# a pipe that the parent's one reading thread drains. Results whose
# ndarray payload exceeds this threshold are written to a POSIX
# shared-memory segment by the worker and only a (name, layout)
# descriptor crosses the pipe; the parent copies straight out of the
# mapping (one memcpy, no pickle decode) and unlinks. Segment names are
# deterministic per (pool, seq) so worker-death recovery and close() can
# reap orphans. Below the threshold the pipe wins (segment setup is
# ~30us).
SHM_MIN_BYTES = 128 * 1024
_SHM_MARK = "__tfos_shm__"
_SHM_ARRAY = "__tfos_shm_nd__"
_pool_ids = itertools.count()


def _shm_supported():
    try:
        from multiprocessing import shared_memory  # noqa: F401
    except ImportError:  # pragma: no cover - ancient python
        return False
    return os.name == "posix"


def _shm_collect(obj, out):
    """Depth-first ndarray leaves of a dict/list/tuple result tree (the
    columnar-batch shapes the decode fns produce); object-dtype and
    empty arrays stay inline."""
    if isinstance(obj, np.ndarray):
        if obj.dtype != object and obj.size:
            out.append(obj)
        return
    if isinstance(obj, dict):
        for v in obj.values():
            _shm_collect(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _shm_collect(v, out)


def _shm_spec(obj, offsets):
    """The result tree with each exported array replaced by a
    placeholder (offset, dtype, shape) — same traversal order as
    :func:`_shm_collect`."""
    if isinstance(obj, np.ndarray):
        if obj.dtype != object and obj.size:
            off = next(offsets)
            return {_SHM_ARRAY: [off, obj.dtype.str, list(obj.shape)]}
        return obj
    if isinstance(obj, dict):
        return {k: _shm_spec(v, offsets) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_shm_spec(v, offsets) for v in obj)
    if isinstance(obj, list):
        return [_shm_spec(v, offsets) for v in obj]
    return obj


def _shm_export(result, name, min_bytes):
    """Worker side: move the result's array payload into segment
    ``name``; returns the descriptor to send instead, or None when the
    payload is too small (or shm failed) — send inline then."""
    arrays = []
    _shm_collect(result, arrays)
    total = sum(int(a.nbytes) for a in arrays)
    if total < min_bytes:
        return None
    try:
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(name=name, create=True,
                                         size=total)
    except Exception:  # no /dev/shm, name collision, quota: fall back
        return None
    # Ownership handoff: create registered the segment with the
    # resource tracker this worker reports to, which would report it as
    # "leaked" at exit once the parent unlinks. Unregister here; the
    # parent re-registers with its own tracker just before unlinking
    # (_shm_release), so both ledgers stay balanced. A worker SIGKILLed
    # mid-task leaves an untracked segment — reaped by name via the
    # recovery/close paths; it leaks only if the parent dies too.
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:  # pragma: no cover - exotic platform
        pass
    try:
        offsets = []
        off = 0
        for a in arrays:
            offsets.append(off)
            view = np.frombuffer(seg.buf, dtype=a.dtype, count=a.size,
                                 offset=off)
            np.copyto(view.reshape(a.shape), a)
            # Views export seg.buf; anything still alive at close()
            # raises BufferError ("exported pointers exist").
            del view
            off += int(a.nbytes)
        spec = _shm_spec(result, iter(offsets))
        return {_SHM_MARK: name, "spec": spec, "bytes": total}
    except Exception:
        try:
            seg.unlink()
        except OSError:  # pragma: no cover
            pass
        return None
    finally:
        # The parent unlinks after its copy. Close only drops THIS
        # process's mapping.
        seg.close()


def _shm_release(seg):
    """Unlink a segment the parent is done with, balancing the parent
    tracker's ledger first (the worker unregistered its own entry at
    create — see _shm_export)."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.register(seg._name, "shared_memory")
    except Exception:  # pragma: no cover - exotic platform
        pass
    try:
        seg.unlink()
    except FileNotFoundError:  # pragma: no cover - already reaped
        pass


def _shm_import(descriptor):
    """Parent side: rebuild the result (one memcpy per array) and unlink
    the segment."""
    from multiprocessing import shared_memory

    seg = shared_memory.SharedMemory(name=descriptor[_SHM_MARK])
    try:
        def rebuild(node):
            if isinstance(node, dict) and _SHM_ARRAY in node:
                off, dtype, shape = node[_SHM_ARRAY]
                dt = np.dtype(dtype)
                count = int(np.prod(shape)) if shape else 1
                return np.frombuffer(
                    seg.buf, dtype=dt, count=count,
                    offset=off).reshape(shape).copy()
            if isinstance(node, dict):
                return {k: rebuild(v) for k, v in node.items()}
            if isinstance(node, tuple):
                return tuple(rebuild(v) for v in node)
            if isinstance(node, list):
                return [rebuild(v) for v in node]
            return node

        return rebuild(descriptor["spec"])
    finally:
        seg.close()
        _shm_release(seg)


def _shm_reap(name):
    """Unlink a possibly-orphaned segment (worker died before its result
    was consumed, or close() dropped in-flight work)."""
    try:
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(name=name)
    except (FileNotFoundError, ImportError):
        return
    except (OSError, ValueError):
        # A worker killed between creating the segment and sizing it left
        # it empty: it cannot be mapped, and was never registered with a
        # resource tracker. Unlink it by name.
        try:
            shared_memory._posixshmem.shm_unlink("/" + name)
        except (AttributeError, OSError):
            pass
        return
    seg.close()
    _shm_release(seg)

# Live pools in this process. The ingest_pool_* gauges that ride
# node_stats() are process-global, so they aggregate across pools (a
# FILES pipeline pool and a FEED pool can coexist) — a single pool
# writing them directly would clobber its sibling's numbers, and one
# pool's close() would zero a still-live plane.
_live_pools = {}
_live_lock = threading.Lock()


def _publish_gauges():
    with _live_lock:
        pools = list(_live_pools.values())
    workers = sum(
        sum(1 for proc, _, _ in p._procs if proc.is_alive()) for p in pools)
    inflight = sum(
        len(p._outstanding) + len(p._ready) for p in pools)
    telemetry.set_gauge("ingest_pool_workers", float(workers))
    telemetry.set_gauge("ingest_pool_inflight", float(inflight))


class DecodeError(RuntimeError):
    """A decode task failing, with provenance.

    Carries ``context`` (the submitter's description of the payload —
    file/record offsets for FILES mode, queue position for FEED mode)
    and the worker-side traceback, so the consumer sees *which record*
    broke instead of a bare queue error.
    """

    def __init__(self, message, context=None, worker_tb=None):
        super().__init__(message)
        self.context = context or {}
        self.worker_tb = worker_tb


def _worker_main(task_q, results, decode_fn, stop_ev, shm_prefix=None,
                 shm_min_bytes=SHM_MIN_BYTES, owner=None):
    """Worker-process loop: pull (seq, payload, context), decode, send
    (seq, elapsed, ok, result-or-traceback) down its own ``results``
    pipe. Runs until the _END sentinel, the stop event, the pipe's
    closing, or the death of its parent process (the owner under
    ``spawn``, the owner's forkserver, which exits with its owner, under
    ``forkserver``). It waits on its task queue with a timeout; a send
    blocks only while the owner holds the pipe open.
    ``shm_prefix``: when set, large array results ride a shared-memory
    segment named ``<prefix>s<seq>`` and only the descriptor crosses
    the pipe."""
    # Decode workers die quietly on Ctrl-C and let the parent clean up.
    try:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    except (ValueError, OSError):  # pragma: no cover - exotic platform
        pass
    parent = os.getppid()

    def orphaned():
        # Reparented: the process that started this worker is gone.
        return os.getppid() != parent or (
            owner is not None and not _alive(owner))

    while not stop_ev.is_set():
        try:
            task = task_q.get(timeout=_POLL)
        except queue_mod.Empty:
            if orphaned():
                return
            continue
        if task is _END or task is None:
            return
        seq, payload, context = task
        t0 = time.perf_counter()
        try:
            result = decode_fn(payload)
            ok = True
        except BaseException:
            result = traceback.format_exc()
            ok = False
        elapsed = time.perf_counter() - t0
        if ok and shm_prefix is not None:
            packed = _shm_export(result, "{}s{}".format(shm_prefix, seq),
                                 shm_min_bytes)
            if packed is not None:
                result = packed
        if stop_ev.is_set():
            return
        try:
            results.send((seq, elapsed, ok, result))
        except OSError:  # the owner closed the pipe, or is gone
            return


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - a reused pid
        return True
    return True


_ctx = None
_ctx_lock = threading.Lock()


def mp_context():
    """The multiprocessing context every pool of the port starts workers
    from: ``forkserver`` with :data:`PRELOAD` (``spawn`` where there is no
    forkserver). Never ``fork``."""
    global _ctx
    with _ctx_lock:
        if _ctx is None:
            if "forkserver" in multiprocessing.get_all_start_methods():
                ctx = multiprocessing.get_context("forkserver")
                ctx.set_forkserver_preload(list(PRELOAD))
            else:  # pragma: no cover - no forkserver on this platform
                ctx = multiprocessing.get_context("spawn")
            _ctx = ctx
    return _ctx


def _start_from_any_process(proc):
    """``proc.start()``, also from a daemonic process. A node program runs
    in one (a FEED node's compute child, an executor), and multiprocessing
    refuses children there, because a daemon's exit would orphan them.
    Decode workers do not outlive their owner (they exit once orphaned),
    so the pool lifts the refusal for the start of its own workers."""
    me = multiprocessing.current_process()
    daemon = me._config.get("daemon")
    if daemon:
        me._config["daemon"] = False
    try:
        proc.start()
    finally:
        if daemon:
            me._config["daemon"] = daemon


def check_picklable(fn):
    """Raise ``TypeError`` naming ``fn`` when it cannot cross to a worker
    process by pickle."""
    try:
        pickle.dumps(fn)
    except Exception as e:  # noqa: BLE001 - any pickling failure
        raise TypeError(
            "decode_fn {!r} cannot be pickled ({}: {}): the port's pools "
            "start workers by forkserver, not fork, so a decode function "
            "must be a module-level function, a functools.partial or a "
            "callable object, not a closure or lambda".format(
                fn, type(e).__name__, e)) from None


class DecodePool:
    """Ordered multi-process map over an unbounded stream of payloads.

    ``decode_fn(payload) -> result`` runs in the worker processes; it
    crosses to them by pickle (see the module docstring), so it must be a
    module-level function, a ``functools.partial`` or a callable object.
    Keep it torch-free and deterministic per payload — a payload lost to
    a worker death is re-decoded in the parent, and a nondeterministic
    fn would make the recovered unit differ.

    Use as a context manager or call :meth:`close`, which is prompt,
    joins the workers and unlinks every shared-memory segment in flight.
    """

    def __init__(self, decode_fn, workers=None, window=None, name="decode",
                 shared_memory=None, shm_min_bytes=SHM_MIN_BYTES):
        self.decode_fn = decode_fn
        self.workers = max(1, int(workers or (os.cpu_count() or 2) - 1))
        # Submission lookahead: how many payloads may be in flight
        # (queued + decoding + reordering) before submit blocks.
        self.window = max(self.workers, int(window or 2 * self.workers))
        self.name = name
        # Shared-memory result transport (None = auto: on wherever POSIX
        # shm exists). Per-pool name prefix keeps sibling pools' and
        # parallel test runs' segments apart; deterministic per-seq
        # names let the recovery/close paths reap orphans.
        self.shared_memory = (_shm_supported() if shared_memory is None
                              else bool(shared_memory) and _shm_supported())
        self.shm_min_bytes = int(shm_min_bytes)
        self._shm_prefix = ("tfos{}p{}".format(os.getpid(),
                                               next(_pool_ids))
                            if self.shared_memory else None)
        self._ctx = mp_context()
        self._stop_ev = self._ctx.Event()
        self._procs = []        # [(proc, task_q, result pipe's read end)]
        # Dead workers' task queues, kept until close(): their semaphores
        # are released there, at a known point, not by whatever garbage
        # collection runs inside the resource tracker's next call (which
        # it reports as a reentrant call and a possible leak).
        self._retired = []
        self._outstanding = {}  # seq -> (worker_index, payload, context)
        self._ready = {}        # seq -> result (reorder buffer)
        self._next_submit = 0
        self._next_yield = 0
        self._closed = False
        self.worker_deaths = 0
        self.requeued = 0

    # -- lifecycle -----------------------------------------------------------

    def _ensure_started(self):
        if self._procs or self._closed:
            return
        check_picklable(self.decode_fn)
        for i in range(self.workers):
            self._procs.append(self._spawn(i))
        with _live_lock:
            _live_pools[id(self)] = self
        _publish_gauges()

    def _spawn(self, index):
        task_q = self._ctx.Queue(maxsize=WORKER_DEPTH)
        reader, writer = self._ctx.Pipe(duplex=False)
        proc = self._ctx.Process(
            target=_worker_main,
            args=(task_q, writer, self.decode_fn, self._stop_ev,
                  self._shm_prefix, self.shm_min_bytes, os.getpid()),
            name="{}-pool-{}".format(self.name, index), daemon=True,
        )
        _start_from_any_process(proc)
        # The worker holds the only write end: its death closes the pipe.
        writer.close()
        return (proc, task_q, reader)

    def close(self, timeout=2.0):
        """Stop workers promptly and reap them. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop_ev.set()
        for proc, task_q, reader in self._procs:
            task_q.cancel_join_thread()
            # A worker blocked sending a result sees the pipe break.
            reader.close()
        deadline = time.time() + timeout
        for proc, _, _ in self._procs:
            proc.join(max(0.05, deadline - time.time()))
            if proc.is_alive():
                proc.terminate()
                proc.join(0.5)
        if self._shm_prefix is not None:
            # In-flight results' segments die with the pool: anything
            # not yet imported (queued descriptors included) is reaped
            # by its deterministic name.
            for seq in list(self._outstanding):
                _shm_reap("{}s{}".format(self._shm_prefix, seq))
        self._retired.clear()
        with _live_lock:
            _live_pools.pop(id(self), None)
        _publish_gauges()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def worker_pids(self):
        """Live worker PIDs (chaos harness hook: testing/faults.py kills
        one of these to drill the recovery path)."""
        self._ensure_started()
        return [p.pid for p, _, _ in self._procs if p.is_alive()]

    # -- ordered streaming map ----------------------------------------------

    def imap(self, payloads, context_fn=None, stopped=None):
        """Yield ``decode_fn(p)`` for each payload, **in order**, keeping
        up to ``window`` payloads in flight across the workers.

        ``context_fn(index, payload) -> dict`` labels each task for error
        provenance (file/record offsets). ``stopped`` is an optional
        zero-arg callable polled while blocked, the same contract as
        ``util.queue_put_bounded`` — the InputPipeline producer passes
        its stop predicate so an abandoned pipeline unwinds promptly.
        """
        self._ensure_started()
        stopped = stopped or (lambda: False)
        it = iter(payloads)
        exhausted = False
        while True:
            # Liveness sweep every iteration (an is_alive() per worker —
            # a waitpid poll, negligible next to a batch decode): a
            # worker that dies while IDLE leaves no starvation or
            # backpressure to trigger the recovery paths below, and the
            # pool would silently run degraded on the survivors forever.
            self._recover_dead_workers()
            # Fill the lookahead window.
            while not exhausted and len(self._outstanding) + len(
                    self._ready) < self.window:
                try:
                    payload = next(it)
                except StopIteration:
                    exhausted = True
                    break
                context = (context_fn(self._next_submit, payload)
                           if context_fn else {})
                if not self._submit(payload, context, stopped):
                    return  # abandoned mid-submit
            if exhausted and self._next_yield >= self._next_submit:
                return
            # Drain results until the next in-order seq is ready.
            if not self._await(self._next_yield, stopped):
                return
            seq = self._next_yield
            self._next_yield += 1
            ok, result = self._ready.pop(seq)
            _publish_gauges()
            if not ok:
                raise result
            yield result

    # -- internals -----------------------------------------------------------

    def _submit(self, payload, context, stopped):
        seq = self._next_submit
        # Least-loaded live worker (round-robin tie-break by seq).
        while True:
            order = sorted(
                range(len(self._procs)),
                key=lambda w: (self._load(w), (w - seq) % len(self._procs)))
            placed = False
            for w in order:
                proc, task_q, _ = self._procs[w]
                if not proc.is_alive():
                    continue
                try:
                    task_q.put((seq, payload, context), timeout=0.05)
                except queue_mod.Full:
                    continue
                self._outstanding[seq] = (w, payload, context)
                placed = True
                break
            if placed:
                break
            # All task queues full (healthy backpressure) or workers
            # dead: make progress by reaping results / reviving.
            self._reap_results(block=True)
            self._recover_dead_workers()
            if stopped():
                return False
        self._next_submit = seq + 1
        _publish_gauges()
        return True

    def _load(self, w):
        return sum(1 for s, (wi, _, _) in self._outstanding.items()
                   if wi == w)

    def _await(self, seq, stopped):
        """Block until ``seq``'s result is in the reorder buffer. A seq
        lost to a worker death lands in the buffer via the inline
        re-decode in :meth:`_recover_dead_workers`."""
        while seq not in self._ready:
            got = self._reap_results(block=True)
            if not got and seq not in self._ready:
                self._recover_dead_workers()
                if stopped():
                    return False
        return True

    def _reap_results(self, block=False):
        """Move completed tasks from the workers' pipes into the reorder
        buffer. Returns True when at least one result arrived."""
        got = False
        while True:
            readers = [r for _, _, r in self._procs if not r.closed]
            if not readers:
                if block and not got:
                    time.sleep(_POLL)  # every worker gone: recovery's turn
                return got
            ready = mp_connection.wait(
                readers, timeout=_POLL if (block and not got) else 0)
            if not ready:
                return got
            for reader in ready:
                try:
                    msg = reader.recv()
                except (EOFError, OSError):
                    # Its worker died (a SIGKILL may cut a message short):
                    # the recovery sweep re-decodes what it held.
                    reader.close()
                    continue
                got = True
                self._accept(*msg)

    def _accept(self, seq, elapsed, ok, result):
        shm_desc = (isinstance(result, dict) and _SHM_MARK in result)
        entry = self._outstanding.pop(seq, None)
        if entry is None:
            # Already recovered inline after a death race — but the
            # orphaned segment must still be reaped.
            if shm_desc:
                _shm_reap(result[_SHM_MARK])
            return
        _, payload, context = entry
        if ok and shm_desc:
            try:
                result = _shm_import(result)
            except (OSError, ValueError) as e:
                ok = False
                result = "shared-memory import failed: {!r}".format(e)
        if ok:
            self._ready[seq] = (True, result)
            telemetry.observe("ingest_decode_seconds", elapsed)
            telemetry.inc("ingest_batches_total")
            telemetry.record_span(
                "ingest/decode_batch", elapsed, seq=seq, **context)
        else:
            self._ready[seq] = (False, self._decode_error(context, result))

    def _decode_error(self, context, worker_tb):
        where = ", ".join(
            "{}={}".format(k, v) for k, v in sorted(context.items()))
        return DecodeError(
            "decode worker failed ({}) — worker traceback:\n{}".format(
                where or "no context", worker_tb),
            context=context, worker_tb=worker_tb)

    def _recover_dead_workers(self):
        """Detect dead children; re-decode their lost tasks inline and
        replace them. The drain in _reap_results ran first, so only
        sequences whose results never arrived are re-run — no unit is
        duplicated, none dropped."""
        dead = [w for w, (proc, _, _) in enumerate(self._procs)
                if not proc.is_alive()]
        if not dead:
            return
        for w in dead:
            proc, task_q, reader = self._procs[w]
            # Drain first: a result the worker sent whole before dying
            # must not be re-decoded.
            while not reader.closed:
                try:
                    if not reader.poll(0):
                        break
                    self._accept(*reader.recv())
                except (EOFError, OSError):
                    reader.close()
            reader.close()
            lost = sorted(s for s, (wi, _, _) in self._outstanding.items()
                          if wi == w)
            self.worker_deaths += 1
            telemetry.inc("ingest_worker_deaths_total")
            telemetry.event("ingest/worker_death", pid=proc.pid,
                            exitcode=proc.exitcode, lost=len(lost))
            logger.warning(
                "decode worker pid=%s died (exit %s); re-decoding %d lost "
                "task(s) inline and respawning", proc.pid, proc.exitcode,
                len(lost))
            task_q.cancel_join_thread()
            self._retired.append(task_q)
            for seq in lost:
                _, payload, context = self._outstanding.pop(seq)
                if self._shm_prefix is not None:
                    # The dead worker may have exported its result and
                    # died before (or after) queueing the descriptor —
                    # the deterministic name makes the orphan reapable.
                    _shm_reap("{}s{}".format(self._shm_prefix, seq))
                self.requeued += 1
                telemetry.inc("ingest_requeues_total")
                t0 = time.perf_counter()
                try:
                    self._ready[seq] = (True, self.decode_fn(payload))
                    telemetry.observe("ingest_decode_seconds",
                                      time.perf_counter() - t0)
                except BaseException:
                    self._ready[seq] = (False, self._decode_error(
                        context, traceback.format_exc()))
            if not self._closed:
                self._procs[w] = self._spawn(w)

    def stats(self):
        """Parent-side pool stats (tests + /statusz convenience)."""
        return {
            "workers": sum(1 for p, _, _ in self._procs if p.is_alive()),
            "inflight": len(self._outstanding) + len(self._ready),
            "worker_deaths": self.worker_deaths,
            "requeued": self.requeued,
            "submitted": self._next_submit,
            "yielded": self._next_yield,
            "shared_memory": self.shared_memory,
        }
