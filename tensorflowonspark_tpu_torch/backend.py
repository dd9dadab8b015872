"""Execution backend: the "Spark executor" tier (the port's copy of the
JAX package's ``backend.py``).

The reference ran inside Spark executors and used ``foreachPartition`` /
``mapPartitions`` closures as its unit of remote execution
(``TFCluster.py:272-289``, ``TFCluster.py:110``). This module provides the
same contract without Spark: a pool of **persistent executor processes**
(one per cluster node slot) that accept serialized partition-closures.

* :class:`LocalBackend` — N executor OS processes on this host, each with
  its own working directory (the analog of a Spark executor's cwd). This is
  both the test backend (process separation is real, as in the reference's
  3-worker Standalone cluster, ``test/run_tests.sh``) and the single-host
  production backend (one executor per device process slot).
* Tasks are cloudpickle-serialized, so closures work exactly as they do
  under Spark.
* A task raising ``RetryTask`` is resubmitted to a *different* executor —
  the analog of Spark rescheduling a failed task (``TFSparkNode.py:166-167``).

Multi-host: :class:`~tensorflowonspark_tpu_torch.backend_remote
.RemoteBackend` carries the same task protocol to per-host agents. Both
serve the supervision layer as they are: a pool outlives a failed
attempt (a relaunch reuses its executors), and ``assign=`` pins a reap or
an elastic respawn to the executor slot that hosts the node.
"""

import logging
import multiprocessing
import os
import queue as queue_lib
import threading
import traceback

import cloudpickle

logger = logging.getLogger(__name__)


def dumps(obj):
    """Serialize a task or a compute child's payload (closures included)."""
    return cloudpickle.dumps(obj)


def loads(payload):
    return cloudpickle.loads(payload)


class RetryTask(Exception):
    """Raised by a task to request rescheduling on another executor."""


class Partitioned:
    """Minimal RDD analog: an ordered list of partitions (each a list)."""

    def __init__(self, partitions):
        self.partitions = [list(p) for p in partitions]

    @classmethod
    def from_items(cls, items, num_partitions):
        items = list(items)
        n = max(1, num_partitions)
        return cls([items[i::n] for i in range(n)])

    @property
    def num_partitions(self):
        return len(self.partitions)

    def union(self, other):
        return Partitioned(self.partitions + other.partitions)

    def repeat(self, times):
        """Epoch emulation: the reference's ``sc.union([rdd] * n)``
        (``TFCluster.py:86-90``)."""
        return Partitioned(self.partitions * times)

    def __iter__(self):
        for p in self.partitions:
            yield p


def _executor_main(executor_idx, base_dir, task_queue, result_conn,
                   pdeathsig=True):
    """Persistent executor process loop.

    Results go out over a per-executor pipe (this process is its only
    writer), not a pool-shared queue: a SIGKILL landing mid-``put`` on a
    shared queue would leave its lock held and wedge every surviving
    executor, whereas a half-written pipe frame strands only this
    executor's own channel (which the pool replaces on respawn).
    """
    if pdeathsig:
        from tensorflowonspark_tpu_torch.util import set_pdeathsig

        set_pdeathsig()  # die with the driver, even a SIGKILLed one
    # Monitor-thread respawns cannot use PDEATHSIG (it fires on the
    # spawning THREAD's exit), so every executor also ties itself to the
    # driver by ppid: reparenting means the driver died with this child
    # still alive: the orphan leak.
    # ~2 s latency vs PDEATHSIG's instant kill; covers all spawn paths.
    parent = os.getppid()

    def orphan_watch():
        import time
        while True:
            time.sleep(2.0)
            if os.getppid() != parent:
                os._exit(113)

    threading.Thread(target=orphan_watch, name="orphan-watch",
                     daemon=True).start()
    workdir = os.path.join(base_dir, "executor_{}".format(executor_idx))
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    os.environ["TPU_FRAMEWORK_EXECUTOR_IDX"] = str(executor_idx)
    while True:
        item = task_queue.get()
        if item is None:
            break
        job_id, part_idx, payload = item
        try:
            fn, partition = loads(payload)
            result = fn(iter(partition))
            if result is not None and not isinstance(result, list):
                result = list(result)
            result_conn.send((job_id, part_idx, "ok", result))
        except RetryTask as e:
            result_conn.send((job_id, part_idx, "retry", str(e)))
        except BaseException:
            result_conn.send((job_id, part_idx, "error", traceback.format_exc()))


class Job:
    """Handle for one submitted partition job."""

    def __init__(self, backend, job_id, num_parts):
        self._backend = backend
        self.job_id = job_id
        self.num_parts = num_parts
        self.results = [None] * num_parts
        self.completed = 0
        self.error = None
        self._done = threading.Event()

    def wait(self, timeout=None):
        """Block until every partition finished; re-raise the first error.

        A timeout is treated as a cluster failure, not a polite decline:
        executors still holding this job's partitions are SIGKILLed (a
        task wedged inside a collective ignores everything softer: a CPU
        all-reduce participant can wait for its peers at 0% CPU forever)
        and respawned by the liveness monitor, so the pool
        stays usable and nothing outlives the caller.
        """
        if not self._done.wait(timeout):
            reaped = self._backend._reap_stragglers(self.job_id)
            raise TimeoutError(
                "job {} timed out; killed wedged executor(s) {}".format(
                    self.job_id, sorted(reaped) or "none"
                )
            )
        if self.error:
            raise RuntimeError(
                "task failed on executor:\n{}".format(self.error)
            )
        return self.results


class LocalBackend:
    """Pool of persistent executor processes on this host."""

    MAX_RETRIES = 3

    def __init__(self, num_executors, base_dir=None):
        self.num_executors = num_executors
        self.base_dir = base_dir or os.path.join(os.getcwd(), ".executors")
        # spawn, not fork: executors run CUDA compute (directly or in their
        # compute children), and a CUDA context does not survive a fork.
        self._ctx = multiprocessing.get_context("spawn")
        # Per-executor result pipes funneled into one in-process queue by
        # per-pipe reader threads. A killed executor can at worst strand its
        # own pipe (replaced on respawn) and leak one blocked reader thread;
        # it cannot corrupt any channel a surviving executor depends on.
        self._results = queue_lib.Queue()
        self._task_queues = []
        self._procs = []
        self._jobs = {}
        self._job_lock = threading.Lock()
        for i in range(num_executors):
            self._task_queues.append(None)
            self._procs.append(None)
            self._spawn(i)
        self._next_job_id = 0
        # (job_id, part_idx) -> [payload, tried_executors, current_executor]
        self._pending = {}
        self._stopped = False
        self._collector = threading.Thread(
            target=self._collect_loop, name="backend-collector", daemon=True
        )
        self._collector.start()
        # Liveness: tasks report outcomes only via the result queue, so a
        # killed executor *process* (OOM, SIGKILL) would otherwise leave its
        # partitions unresolved until the caller's timeout. Spark owned this
        # detection for the reference; this pool owns it now.
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="backend-monitor", daemon=True
        )
        self._monitor.start()

    # -- submission ---------------------------------------------------------

    def foreach_partition(self, partitions, fn, block=True, timeout=None,
                          assign=None):
        """Run ``fn(iter(partition))`` for every partition.

        ``assign`` optionally maps partition index -> executor index; the
        default spreads round-robin (Spark's behavior with one core per
        executor). Returns the :class:`Job`; with ``block`` the job is waited
        and errors re-raised.
        """
        parts = list(partitions)
        with self._job_lock:
            job_id = self._next_job_id
            self._next_job_id += 1
            job = Job(self, job_id, len(parts))
            self._jobs[job_id] = job
            if not parts:
                job._done.set()
        for idx, part in enumerate(parts):
            executor = assign(idx) if assign else idx % self.num_executors
            payload = dumps((fn, part))
            # Book and enqueue under one lock acquisition: _spawn swaps
            # the slot's task queue under the same lock, so a task can
            # never land in an abandoned queue after its pending entry was
            # failed on the death path.
            with self._job_lock:
                self._pending[(job_id, idx)] = [payload, {executor}, executor]
                self._task_queues[executor].put((job_id, idx, payload))
        if block:
            return job.wait(timeout)
        return job

    def map_partitions(self, partitions, fn, timeout=None, assign=None):
        """Like :meth:`foreach_partition` but returns the per-partition
        result lists, in partition order."""
        return self.foreach_partition(
            partitions, fn, block=True, timeout=timeout, assign=assign
        )

    # -- result collection --------------------------------------------------

    def _pipe_reader(self, executor_idx, conn):
        """Drain one executor's result pipe into the in-process results
        queue. Exits on EOF (executor exited; the parent closed its copy of
        the send end). If the executor was SIGKILLed mid-send this thread
        can block on the half-written frame forever — it is a daemon
        holding only the dead pipe, and the respawned executor gets a
        fresh pipe and reader."""
        while True:
            try:
                item = conn.recv()
            except (EOFError, OSError):
                return
            self._results.put(item)

    def _collect_loop(self):
        while True:
            item = self._results.get()
            if item is None:
                break
            job_id, part_idx, status, payload = item
            with self._job_lock:
                job = self._jobs.get(job_id)
                key = (job_id, part_idx)
                if job is None:
                    continue
                if status == "retry":
                    entry = self._pending.get(key)
                    if entry is not None:
                        task_payload, tried, _ = entry
                        if len(tried) < min(self.MAX_RETRIES + 1, self.num_executors):
                            candidates = [
                                i for i in range(self.num_executors) if i not in tried
                            ] or list(range(self.num_executors))
                            nxt = candidates[0]
                            tried.add(nxt)
                            entry[2] = nxt
                            logger.info(
                                "rescheduling job %s partition %s on executor %s",
                                job_id, part_idx, nxt,
                            )
                            self._task_queues[nxt].put((job_id, part_idx, task_payload))
                            continue
                        status, payload = "error", "task exhausted retries: " + payload
                self._pending.pop(key, None)
                if status == "error":
                    job.error = job.error or payload
                    job._done.set()  # fail fast, like the reference's abort path
                else:
                    job.results[part_idx] = payload
                    job.completed += 1
                    if job.completed == job.num_parts:
                        job._done.set()

    # -- liveness -----------------------------------------------------------

    def _monitor_loop(self):
        """Watch executor process sentinels; a death fails its outstanding
        partitions immediately and a replacement executor is respawned on
        the same task queue for subsequent jobs."""
        from multiprocessing import connection as mp_conn

        handled = set()  # proc objects whose exit was already processed
        while not self._stopped:
            procs = list(self._procs)
            # No is_alive() filter: a dead process's sentinel stays ready,
            # so deaths landing between wait windows (e.g. while a prior
            # death was being handled) are still picked up next round.
            sentinels = {p.sentinel: i for i, p in enumerate(procs)
                         if p not in handled}
            if not sentinels:
                return
            ready = mp_conn.wait(list(sentinels), timeout=0.5)
            if self._stopped:
                return
            for s in ready:
                if self._stopped:  # a stop() racing this batch: no respawns
                    return
                idx = sentinels[s]
                p = procs[idx]
                p.join(0.1)
                handled.add(p)
                # Any exit while the pool is live is a failure: the loop
                # only returns cleanly when stop() sends the None sentinel.
                logger.error(
                    "executor %d died (exitcode %s); failing its pending "
                    "partitions and respawning", idx, p.exitcode,
                )
                self._spawn(idx, fail_exitcode=p.exitcode)

    def _reap_stragglers(self, job_id):
        """SIGKILL every executor still assigned one of ``job_id``'s
        pending partitions (see :meth:`Job.wait`). Death-path bookkeeping
        (failing pending entries, respawning the slot) is the monitor
        loop's job — it sees the sentinel exactly as it would for a
        crash. Returns the reaped executor indices."""
        with self._job_lock:
            stale = {
                entry[2] for (jid, _), entry in self._pending.items()
                if jid == job_id
            }
            # Snapshot the proc objects under the SAME lock: a crash-
            # triggered _spawn raced against this reap swaps a fresh
            # process into the slot (and clears the job's pending
            # entries) atomically, so a lock-free read here could
            # SIGKILL the healthy replacement.
            procs = [self._procs[idx] for idx in stale]
        for idx, p in zip(stale, procs):
            try:
                if p is not None and p.is_alive():
                    logger.error(
                        "executor %d wedged past job %d's deadline; "
                        "SIGKILL", idx, job_id,
                    )
                    p.kill()
            except (OSError, ValueError):  # already gone / closed
                pass
        return stale

    def _fail_pending_locked(self, executor_idx, exitcode):
        """Caller holds ``_job_lock``."""
        for (job_id, part_idx), entry in list(self._pending.items()):
            if entry[2] == executor_idx:  # currently assigned there
                job = self._jobs.get(job_id)
                if job is not None and not job._done.is_set():
                    job.error = (
                        "executor {} died (exitcode {}) with partition {} "
                        "outstanding".format(executor_idx, exitcode, part_idx)
                    )
                    job._done.set()
                self._pending.pop((job_id, part_idx), None)

    def _spawn(self, executor_idx, fail_exitcode=None):
        """Start (or replace) the executor in ``executor_idx``'s slot with a
        fresh task queue and result pipe — never reuse the old ones: a
        SIGKILL may have left the task queue's reader lock held or the
        result pipe mid-frame, and a replacement on those channels would
        wedge silently. On the death path (``fail_exitcode`` set), failing
        the dead executor's pending tasks and swapping in the fresh queue
        are one atomic section, so no submitter can book a task against a
        queue that is about to be abandoned (or have a task bound for the
        fresh queue failed spuriously)."""
        recv_conn, send_conn = self._ctx.Pipe(duplex=False)
        tq = self._ctx.Queue()
        # PR_SET_PDEATHSIG fires when the spawning THREAD exits, not the
        # process: main-thread spawns get died-with-the-driver
        # protection, but monitor-thread respawns must NOT set it — the
        # monitor exiting at stop() (or dying unexpectedly) would
        # SIGKILL healthy executors before the graceful drain.
        pdeathsig = threading.current_thread() is threading.main_thread()
        p = self._ctx.Process(
            target=_executor_main,
            args=(executor_idx, self.base_dir, tq, send_conn, pdeathsig),
            name="executor-{}".format(executor_idx),
        )
        p.start()
        # Close the parent's copy of the send end so the reader sees EOF
        # when the executor exits.
        send_conn.close()
        with self._job_lock:
            if fail_exitcode is not None:
                self._fail_pending_locked(executor_idx, fail_exitcode)
            old = self._task_queues[executor_idx]
            self._task_queues[executor_idx] = tq
            self._procs[executor_idx] = p
        if old is not None:
            old.close()
        threading.Thread(
            target=self._pipe_reader, args=(executor_idx, recv_conn),
            name="backend-pipe-reader-{}".format(executor_idx), daemon=True,
        ).start()

    # -- lifecycle ----------------------------------------------------------

    def stop(self, grace=5.0):
        if self._stopped:
            return
        self._stopped = True
        for tq in self._task_queues:
            tq.put(None)
        for p in self._procs:
            p.join(grace)
            if p.is_alive():
                p.terminate()
                p.join(grace)
            if p.is_alive():
                # SIGTERM didn't land (wedged in native code with the
                # signal blocked, or mid-spawn): escalate. An executor
                # that survives stop() is a non-daemon child that blocks
                # interpreter exit via multiprocessing's atexit join.
                logger.error(
                    "executor pid=%s ignored SIGTERM at stop(); SIGKILL",
                    p.pid,
                )
                p.kill()
                p.join(grace)
        self._results.put(None)
        self._collector.join(grace)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
