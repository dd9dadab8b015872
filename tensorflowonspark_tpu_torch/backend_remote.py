"""Cross-host executor backend: driver-side pool of remote agents (the
port of the JAX package's ``backend_remote.py``; the message format is
that module's).

The reference's executors were Spark's — JVM processes on many machines
receiving serialized task closures (``foreachPartition``). This is the
native equivalent: each host runs one agent process
(``python -m tensorflowonspark_tpu_torch.tools.agent``) that dials the driver's
:class:`RemoteBackend`, authenticates (HMAC challenge via
``multiprocessing.connection`` authkeys), and executes cloudpickled
partition tasks — exactly the task surface :class:`backend.LocalBackend`
provides in-process, so ``cluster.run`` works unchanged over either. The
feed/control planes already cross hosts (TCP managers, rendezvous
server); this closes the task-dispatch plane.

An agent runs tasks inline; a FEED-mode node program runs in a compute
child that the node runtime starts with ``spawn`` (a CUDA context does not
survive a fork), and ``CUDA_VISIBLE_DEVICES`` passes from the agent's
environment to its children. Agents started together on one host share
the kernel build through its file lock (``ops/_build.py``).

Driver::

    pool = RemoteBackend(num_executors=4, listen=("0.0.0.0", 7077))
    print(pool.address, pool.authkey.hex())   # give these to the agents
    pool.wait_for_agents(timeout=120)
    c = cluster.run(pool, map_fun, args, ...)

Each host::

    python -m tensorflowonspark_tpu_torch.tools.agent \
        --driver driver-host:7077 --authkey <hex>
"""

import logging
import os
import threading
import traceback
from multiprocessing.connection import Client, Listener

from tensorflowonspark_tpu_torch import backend as backend_mod

logger = logging.getLogger(__name__)


class RemoteBackend:
    """Dispatches partition tasks to connected agent processes.

    Presents the same interface as :class:`backend.LocalBackend`
    (``num_executors``, ``foreach_partition``, ``map_partitions``,
    ``stop``); executor index = agent connect order.
    """

    MAX_RETRIES = 3

    def __init__(self, num_executors, listen=("0.0.0.0", 0), authkey=None):
        self.num_executors = num_executors
        self.authkey = authkey or os.urandom(16)
        self._listener = Listener(tuple(listen), authkey=self.authkey)
        self.address = self._listener.address
        self._conns = []
        self._send_locks = []  # Connection.send is not thread-safe
        self.agent_pids = []   # reported in each agent's hello
        self._dead = set()     # executor idxs whose agent disconnected
        self._conn_lock = threading.Lock()
        self._jobs = {}
        self._job_lock = threading.Lock()
        self._next_job_id = 0
        # (job_id, part_idx) -> [payload, tried_executors, current_executor]
        self._pending = {}
        self._stopped = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="remote-backend-accept", daemon=True
        )
        self._agents_ready = threading.Event()
        self._accept_thread.start()

    # -- agent lifecycle -----------------------------------------------------

    def _accept_loop(self):
        """Accept agents for the pool's lifetime: initial fills take the
        next free slot; later arrivals RECLAIM a dead slot (an agent the
        driver disconnected for wedging, or that self-killed on its task
        watchdog, rejoins via ``tools.agent --restart`` — the elastic
        recovery Spark provided by relaunching executors)."""
        import multiprocessing

        while not self._stopped:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError,
                    multiprocessing.AuthenticationError,
                    multiprocessing.ProcessError):
                # AuthenticationError is a ProcessError, NOT an OSError:
                # one wrong-key dial must not kill the accept thread
                # that dead-slot reclaim depends on for the pool's life.
                if self._stopped:
                    return
                continue
            try:
                hello = conn.recv()
            except (OSError, EOFError):  # died between auth and hello
                try:
                    conn.close()
                except (OSError, EOFError):
                    pass
                continue
            # Pick a slot WITHOUT publishing it (this thread is the only
            # accepter, so the pick cannot be stolen), complete the
            # assignment handshake on the still-private connection, and
            # only then publish. Publishing first raced task routing:
            # a task frame could interleave with the assignment send on
            # a connection whose send lock the accept thread never held.
            # Both locks for the pick: _dead is mutated under _job_lock
            # (recv threads' _fail_pending_on) while _conns length needs
            # _conn_lock — a lock-mismatched min() over a concurrently
            # resized set would kill the accept thread.
            with self._job_lock:
                with self._conn_lock:
                    if self._dead:
                        idx = min(self._dead)
                        reclaimed = True
                    elif len(self._conns) < self.num_executors:
                        idx = len(self._conns)
                        reclaimed = False
                    else:
                        idx = None
            if idx is None:
                logger.warning(
                    "agent from %s rejected: pool full and no dead slot",
                    hello.get("host"))
                try:
                    conn.close()
                except (OSError, EOFError):
                    pass
                continue
            try:
                conn.send({"executor_idx": idx})
            except (OSError, EOFError):
                # Died before assignment: nothing was published, so
                # nothing to roll back.
                try:
                    conn.close()
                except (OSError, EOFError):
                    pass
                continue
            with self._job_lock:
                with self._conn_lock:
                    if reclaimed:
                        self._dead.discard(idx)
                        self._conns[idx] = conn
                        self._send_locks[idx] = threading.Lock()
                        self.agent_pids[idx] = hello.get("pid")
                    else:
                        self._conns.append(conn)
                        self._send_locks.append(threading.Lock())
                        self.agent_pids.append(hello.get("pid"))
            logger.info("agent %d %s from %s (pid %s)", idx,
                        "reclaimed" if reclaimed else "connected",
                        hello.get("host"), hello.get("pid"))
            threading.Thread(
                target=self._recv_loop, args=(idx, conn),
                name="remote-backend-recv-{}".format(idx), daemon=True,
            ).start()
            with self._conn_lock:
                if (len(self._conns) >= self.num_executors
                        and not self._dead):
                    self._agents_ready.set()

    def wait_for_agents(self, timeout=None):
        """Block until every executor slot has an agent."""
        if not self._agents_ready.wait(timeout):
            raise TimeoutError(
                "only {}/{} agents connected".format(
                    len(self._conns), self.num_executors
                )
            )

    # -- submission (same bookkeeping as LocalBackend) -----------------------

    def foreach_partition(self, partitions, fn, block=True, timeout=None,
                          assign=None):
        self.wait_for_agents(timeout)
        parts = list(partitions)
        with self._job_lock:
            job_id = self._next_job_id
            self._next_job_id += 1
            job = backend_mod.Job(self, job_id, len(parts))
            self._jobs[job_id] = job
            if not parts:
                job._done.set()
        for idx, part in enumerate(parts):
            payload = backend_mod.dumps((fn, part))
            executor = (assign(idx) if assign else idx) % self.num_executors
            with self._job_lock:
                if executor in self._dead:
                    live = [i for i in range(self.num_executors)
                            if i not in self._dead]
                    if not live:
                        job.error = "all agents disconnected"
                        job._done.set()
                        break
                    executor = live[idx % len(live)]
                self._pending[(job_id, idx)] = [payload, {executor}, executor]
            self._send(executor, ("task", job_id, idx, payload))
        if block:
            # Same return contract as LocalBackend: the results list (and
            # errors re-raised) when blocking, the Job handle otherwise.
            return job.wait(timeout)
        return job

    def map_partitions(self, partitions, fn, timeout=None, assign=None):
        return self.foreach_partition(
            partitions, fn, block=True, timeout=timeout, assign=assign
        )

    def _send(self, executor_idx, msg):
        """Serialized per-connection send; a failed send marks the agent
        dead and fails its outstanding tasks (raising would otherwise
        escape a recv thread and silently kill it)."""
        with self._conn_lock:
            conn = self._conns[executor_idx]
            lock = self._send_locks[executor_idx]
        try:
            with lock:
                conn.send(msg)
            return True
        except (OSError, EOFError, ValueError):
            if self._stopped:
                return False
            with self._conn_lock:
                # Same stale-connection guard as the recv loop: a send
                # captured on the OLD conn failing after the slot was
                # reclaimed must not mark the fresh agent dead.
                stale = (executor_idx >= len(self._conns)
                         or self._conns[executor_idx] is not conn)
            if not stale:
                logger.warning("send to agent %d failed; marking it dead",
                               executor_idx)
                self._fail_pending_on(executor_idx)
            elif msg[0] == "task":
                # The stale send was CARRYING a task; dropping it would
                # strand the pending entry until the job deadline.
                # Re-route it like a retry (the fresh agent at this slot
                # is excluded by the tried-set; exhaustion fails fast).
                resend = self._redispatch(msg[1], msg[2])
                if resend is not None:
                    self._send(*resend)
            return False

    def _pick_retry_target_locked(self, job_id, part_idx):
        """The ONE retry policy (caller holds ``_job_lock``): route the
        pending task to an executor not yet tried and not dead, within
        the retry budget. Returns the ``(executor, frame)`` to send, or
        None when exhausted — shared by agent-requested retries and
        in-flight-loss redispatch so the semantics cannot drift."""
        entry = self._pending.get((job_id, part_idx))
        if entry is None:
            return None
        payload, tried, _ = entry
        candidates = [
            i for i in range(self.num_executors)
            if i not in tried and i not in self._dead
        ]
        if candidates and len(tried) < self.MAX_RETRIES + 1:
            target = candidates[0]
            tried.add(target)
            entry[2] = target
            return (target, ("task", job_id, part_idx, payload))
        return None

    def _redispatch(self, job_id, part_idx):
        """Move a task whose in-flight send was lost to a replaced agent
        onto a live executor, or fail its job fast. Returns the
        ``(executor, frame)`` to send, or None."""
        with self._job_lock:
            if (job_id, part_idx) not in self._pending:
                return None
            resend = self._pick_retry_target_locked(job_id, part_idx)
            if resend is not None:
                return resend
            self._pending.pop((job_id, part_idx), None)
            job = self._jobs.get(job_id)
            if job is not None and not job._done.is_set():
                job.error = ("task lost in transit to a replaced agent "
                             "and no executor remained to retry it")
                job._done.set()
            return None

    def _recv_loop(self, executor_idx, conn):
        # All job bookkeeping happens under self._job_lock — one recv thread
        # runs per agent, and concurrent completions would otherwise race on
        # job.completed/results/pending (LocalBackend serializes the same
        # bookkeeping in its single collector thread).
        while True:
            try:
                msg = conn.recv()
            # TypeError: the handle can be torn down mid-read at stop().
            except (EOFError, OSError, TypeError):
                with self._conn_lock:
                    # A reclaimed slot's OLD recv thread observing its
                    # (replaced) connection's EOF must not re-mark the
                    # FRESH agent dead.
                    stale_conn = (executor_idx >= len(self._conns)
                                  or self._conns[executor_idx] is not conn)
                if not self._stopped and not stale_conn:
                    self._fail_pending_on(executor_idx)
                return
            job_id, part_idx, status, result = msg
            resend = None
            with self._job_lock:
                job = self._jobs.get(job_id)
                key = (job_id, part_idx)
                if job is None:
                    continue
                if status == "retry":
                    if key not in self._pending:
                        continue  # already resolved (e.g. job failed)
                    resend = self._pick_retry_target_locked(job_id, part_idx)
                    if resend is None:
                        status, result = "error", "no executor accepted the task"
                if resend is None:
                    self._pending.pop(key, None)
                    if status == "error":
                        job.error = job.error or result
                        job._done.set()  # fail fast
                    else:
                        job.results[part_idx] = result
                        job.completed += 1
                        if job.completed >= job.num_parts:
                            job._done.set()
            if resend is not None:
                # Send outside the lock: a slow agent socket must not stall
                # every other agent's bookkeeping.
                self._send(*resend)

    def _reap_stragglers(self, job_id):
        """Remote analog of LocalBackend's timeout reap (Job.wait calls
        this on EVERY backend): the driver cannot SIGKILL a process on
        another host, so it disconnects the wedged agent — the recv loop
        sees EOF, fails its pending tasks, and stops routing to it. The
        agent *process* dies by its own task watchdog
        (``agent_main(task_timeout=...)``, hard ``os._exit`` — a wedged
        inline task cannot even receive a kill frame), and
        ``tools.agent --restart`` reconnects a fresh one, which the
        accept loop slots back in (dead-slot reclaim). Returns the
        disconnected indices."""
        with self._job_lock:
            stale = {
                entry[2] for (jid, _), entry in self._pending.items()
                if jid == job_id
            }
        for idx in stale:
            logger.error(
                "agent %d wedged past job %d's deadline; disconnecting",
                idx, job_id,
            )
            with self._conn_lock:
                conn = self._conns[idx] if idx < len(self._conns) else None
            try:
                if conn is not None:
                    conn.close()
            except (OSError, EOFError):
                pass
            self._fail_pending_on(idx)
        return stale

    def _fail_pending_on(self, executor_idx):
        """An agent died: fail its outstanding tasks (fail-fast, like a
        lost Spark executor failing its tasks) and stop routing to it."""
        with self._job_lock:
            self._dead.add(executor_idx)
            for (job_id, part_idx), entry in list(self._pending.items()):
                if entry[2] == executor_idx:  # currently assigned there
                    job = self._jobs.get(job_id)
                    if job is not None and not job._done.is_set():
                        job.error = (
                            "agent {} disconnected with tasks outstanding".format(
                                executor_idx
                            )
                        )
                        job._done.set()
                    self._pending.pop((job_id, part_idx), None)

    def stop(self, grace=5.0):
        self._stopped = True
        with self._conn_lock:
            conns = list(zip(self._conns, self._send_locks))
        for conn, send_lock in conns:
            # Take the per-connection send lock so the stop frame cannot
            # interleave with an in-flight task send — but bounded: a hung
            # agent socket (holder blocked mid-send) must not turn stop()
            # into the very hang it exists to escape.
            if not send_lock.acquire(timeout=grace):
                logger.warning(
                    "send lock busy for %.1fs at stop(); closing connection "
                    "without a stop frame", grace,
                )
                try:
                    conn.close()
                except (OSError, EOFError):
                    pass
                continue
            try:
                conn.send(("stop",))
                conn.close()
            except (OSError, EOFError):
                pass
            finally:
                send_lock.release()
        try:
            self._listener.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def agent_main(driver_addr, authkey, base_dir=None, task_timeout=None):
    """One host's executor agent: connect, take tasks, run them inline
    (compute children are spawned by the node runtime itself), report
    results. Returns when the driver stops the pool.

    ``task_timeout`` arms a hard per-task watchdog: a task wedged past
    the deadline (e.g. inside a native collective, where no signal
    handler ever runs) gets the whole agent ``os._exit(114)``-ed — the
    only remedy that works from inside the wedged process. Pair with
    ``tools.agent --restart`` so a fresh agent reconnects and the
    driver's accept loop reclaims the slot.

    Returns ``(executor_idx, clean)``: ``clean`` is True only for the
    driver's explicit stop frame; a connection EOF returns False so a
    supervisor knows to reconnect rather than shut down."""
    conn = Client(tuple(driver_addr), authkey=authkey)
    import socket

    conn.send({"host": socket.gethostname(), "pid": os.getpid()})
    assignment = conn.recv()
    idx = assignment["executor_idx"]
    workdir = os.path.join(
        base_dir or os.path.join(os.getcwd(), ".agent"),
        "executor_{}".format(idx),
    )
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    os.environ["TPU_FRAMEWORK_EXECUTOR_IDX"] = str(idx)
    logger.info("agent %d serving from %s", idx, workdir)

    deadline = [None]  # armed while a task runs; None = idle
    if task_timeout:
        def watch():
            import time as time_mod
            while True:
                time_mod.sleep(min(task_timeout / 4, 1.0))
                d = deadline[0]
                if d is not None and time_mod.monotonic() > d:
                    logger.error(
                        "agent %d task exceeded %.1fs; exiting for the "
                        "supervisor to restart", idx, task_timeout)
                    os._exit(114)

        threading.Thread(target=watch, name="agent-task-watchdog",
                         daemon=True).start()

    import time as time_mod

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return idx, False  # connection lost: a supervisor reconnects
        if msg[0] == "stop":
            return idx, True
        _, job_id, part_idx, payload = msg
        if task_timeout:
            deadline[0] = time_mod.monotonic() + task_timeout
        try:
            fn, partition = backend_mod.loads(payload)
            result = fn(iter(partition))
            # Disarm BEFORE serializing/sending: the deadline bounds the
            # task, and a large result crawling into a backpressured
            # driver socket must not get a finished task killed.
            deadline[0] = None
            if result is not None and not isinstance(result, list):
                result = list(result)
            conn.send((job_id, part_idx, "ok", result))
        except backend_mod.RetryTask as e:
            deadline[0] = None
            conn.send((job_id, part_idx, "retry", str(e)))
        except BaseException:
            deadline[0] = None
            conn.send((job_id, part_idx, "error", traceback.format_exc()))
        finally:
            deadline[0] = None
