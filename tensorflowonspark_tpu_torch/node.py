"""Executor-side node runtime: bring-up, rendezvous, feeding, shutdown
(the port of the JAX package's ``node.py``).

A re-design of the reference's ``TFSparkNode``
(``tensorflowonspark/TFSparkNode.py``). Every executor runs
:class:`NodeRunner` exactly once per cluster: it claims its node id, assigns
its role from the cluster template, starts the per-executor state manager,
reserves a port, registers with the driver's rendezvous server, awaits the
full cluster, exports the cluster layout to the environment, and then runs
the user function — inline for FILES-mode workers, in a background compute
process for FEED-mode workers, or as a lifecycle-only service loop for
``ps``-role nodes.

There is no parameter server: the ``ps`` role is kept for lifecycle parity
only (remote manager + driver-driven control-queue shutdown, the
reference's ``TFCluster.py:163-172`` trick); gradients are all-reduced
over ``torch.distributed`` (:meth:`NodeContext.initialize_distributed`).

An incident-capture request riding a heartbeat reply is answered with
``incident.node_snapshot`` on a thread of its own, published to the
manager KV and sent back as a ``SNAP`` message; a crashing node program
publishes its crash snapshot to the manager KV before it raises.

A spot preemption (``testing.faults.preempt_node``) reaches the node
program as :class:`~tensorflowonspark_tpu_torch.testing.faults.Preempted`,
raised by its SIGTERM handler on the compute process's main thread: the
node program's normal error path (traceback to the error queue, manager
state ``error``, final ``error`` heartbeat) reports it like any other
death.
"""

import json
import logging
import multiprocessing
import os
import queue as _queue_mod
import signal
import socket
import sys
import threading
import time
import traceback
import uuid

from tensorflowonspark_tpu_torch import backend as backend_mod
from tensorflowonspark_tpu_torch import (
    device_info, feed, incident, manager, marker, paths, reservation,
    telemetry, util,
)
from tensorflowonspark_tpu_torch.testing import faults

logger = logging.getLogger(__name__)

DEFAULT_QUEUES = ("input", "output", "error", "control")
_MANAGER_FILE = "manager.json"

# Per-process cache of manager connections, keyed by (host, executor_id) —
# the reference's `_get_manager` singleton (TFSparkNode.py:91-117).
_mgr_cache = {}

# Managers *started* by this executor process. Holding the Handle here keeps
# the BaseManager referenced for the life of the executor — dropping the last
# reference would finalize (kill) the manager child as soon as the bring-up
# task returned.
_started_managers = {}

# The chief's metrics HTTP server for the CURRENT cluster run on this
# executor (stopped by ShutdownTask / the next cluster's bring-up, so
# persistent executors don't accumulate servers).
_metrics_servers = {}

# FEED-mode compute children this executor spawned, by pid: the handle the
# supervisor's reap joins after its SIGKILL (ReapComputeTask).
_compute_procs = {}


def _stop_metrics_server():
    for key in ("chief", "tensorboard"):
        server = _metrics_servers.pop(key, None)
        if server is not None:
            try:
                server.stop()
            except Exception:  # pragma: no cover - best-effort cleanup
                logger.warning("%s stop failed", key, exc_info=True)


class _TensorBoardProc:
    """A live ``tensorboard`` child process on the chief (the reference's
    runtime behavior: a real TensorBoard subprocess on a dynamically
    bound port, ``TFSparkNode.py:197-230``)."""

    def __init__(self, proc, port):
        self.proc = proc
        self.port = port
        self.pid = proc.pid

    def stop(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except Exception:
            self.proc.kill()
            self.proc.wait(timeout=10)


def _maybe_start_tensorboard(log_dir):
    """Spawn a REAL ``tensorboard`` subprocess over ``log_dir`` when the
    binary is on PATH (searched the way the reference searched for it,
    ``TFSparkNode.py:208-217``); returns None when unavailable — the
    built-in metrics HTTP service still serves scalars either way, so
    environments without the tensorboard package degrade to the built-in
    service instead of failing."""
    import shutil
    import socket
    import subprocess

    exe = shutil.which("tensorboard")
    if exe is None:
        return None
    sock = socket.socket()
    sock.bind(("", 0))
    port = sock.getsockname()[1]
    sock.close()
    try:
        proc = subprocess.Popen(
            [exe, "--logdir", log_dir, "--port", str(port), "--bind_all"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    except OSError:  # pragma: no cover - PATH raced away
        return None
    # Catch instant deaths (port snatched in the bind race, an older
    # tensorboard without --bind_all, unreadable logdir): stderr goes to
    # DEVNULL, so without this check a dead server's port would be
    # advertised in the reservation and tensorboard_url() would never
    # fall back.
    import time

    time.sleep(0.3)
    if proc.poll() is not None:
        logger.warning("tensorboard exited immediately (rc=%s); falling "
                       "back to the built-in metrics service",
                       proc.returncode)
        return None
    logger.info("tensorboard pid %s on port %s over %s",
                proc.pid, port, log_dir)
    return _TensorBoardProc(proc, port)


class HeartbeatSender:
    """Background liveness beacon to the driver's rendezvous server.

    Runs inside the process that executes user compute (the FEED-mode
    compute child, the FILES-mode executor, the ps service loop), so a
    wedge that holds the GIL — a native collective that never returns —
    silences it: that is the signal the driver-side ``LivenessMonitor``
    classifies as *hung*, vs *crashed* (error state reported) and *slow*
    (late but beating). Each beat carries the node's manager state.

    ``testing.faults`` can drop beats process-locally (the injected
    network-partition/hang emulation); the sender keeps running so the
    drop is reversible within one process lifetime.
    """

    # Consecutive beat failures (each already carrying the Client's own
    # ~30s retry budget) tolerated before the sender gives up. One failed
    # beat must NOT be fatal: a driver GC pause or network blip longer
    # than the Client budget would otherwise silence a healthy node for
    # good, and large miss budgets could never be honored.
    MAX_BEAT_FAILURES = 3

    def __init__(self, server_addr, executor_id, mgr, interval=2.0):
        self.server_addr = tuple(server_addr)
        self.executor_id = executor_id
        self.mgr = mgr
        self.interval = float(interval)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._client = None
        self._capture_seen = None  # last answered incident-capture id
        self._epoch = None         # newest applied resize-directive epoch
        self._thread = threading.Thread(
            target=self._run, name="heartbeat-{}".format(executor_id),
            daemon=True,
        )

    def start(self):
        try:
            self._client = reservation.Client(self.server_addr)
        except (ConnectionError, OSError):
            logger.warning("heartbeat sender could not reach %s; liveness "
                           "reporting disabled for node %d",
                           self.server_addr, self.executor_id)
            return self
        self._thread.start()
        return self

    def _beat(self, state):
        client = self._client  # racing stop() may None the attribute
        if client is None:
            raise ConnectionError("no heartbeat connection")
        # Every beat carries the node's live stats (current step,
        # steps/sec, data-wait fraction, prefetch depth, ...): the
        # driver's LivenessMonitor.cluster_stats() is fed entirely from
        # here — hung-node diagnosis without SSH. The same dict is
        # published to the manager KV: in FEED mode the chief's
        # MetricsServer lives in the EXECUTOR process while these numbers
        # are produced in the compute child — the KV is the hop that lets
        # /metrics+/statusz serve the child's live stats.
        stats = telemetry.node_stats()
        try:
            self.mgr.set("node_stats", stats)
        except Exception:  # manager gone (teardown) or a test fake
            pass
        return client.heartbeat(self.executor_id, state, stats=stats,
                                epoch=self._epoch)

    def flush(self, state=None):
        """Send one immediate beat from the caller's thread — used for the
        final ``error``/``finished`` state so the driver classifies the
        node from its last state instead of from silence."""
        with self._lock:
            try:
                self._beat(state if state is not None else self._state())
            except Exception:  # server gone: nothing to report to
                pass

    def _state(self):
        try:
            return self.mgr.get("state")
        except Exception:  # manager died with the executor
            return None

    def _run(self):
        failures = 0
        while not self._stop.wait(self.interval):
            if faults.heartbeats_dropped():
                continue  # injected partition: alive but silent
            state = self._state()
            reply = None
            with self._lock:
                try:
                    reply = self._beat(state)
                    failures = 0
                except (ConnectionError, OSError):
                    failures += 1
                    if failures >= self.MAX_BEAT_FAILURES or \
                            self._stop.is_set():
                        return  # server really gone (or we were stopped)
                    try:  # transient stall: re-dial on a short budget
                        self._client = reservation.Client(
                            self.server_addr, retries=1, deadline=2.0
                        )
                    except (ConnectionError, OSError):
                        pass  # counted by the next round's failure
            # Incident capture rides the beat reply (the driver cannot
            # push to nodes): a new capture id means "dump your black
            # box now". Runs here in the compute process — the ring and
            # stacks captured are the ones doing the actual work.
            if isinstance(reply, dict) and reply.get("capture"):
                self._maybe_snapshot(reply["capture"])
            # Elastic resize directives ride the same client-initiated
            # channel: publish to the manager KV (the node program polls
            # it at step boundaries via ctx.poll_resize) and echo the
            # epoch on subsequent beats as the ack.
            if isinstance(reply, dict) and reply.get("resize"):
                self._apply_resize(reply["resize"])
            # Never exit on the server's STOP flag: after request_stop the
            # node is still draining/finishing, and going silent here
            # would let the miss budget misclassify it as hung mid-drain.
            if state in ("stopped",):
                return

    def _apply_resize(self, directive):
        epoch = directive.get("epoch") if isinstance(directive, dict) else None
        if epoch is None or epoch == self._epoch:
            return
        self._epoch = epoch
        try:
            self.mgr.set("resize", dict(directive))
        except Exception:  # manager gone (teardown) or a test fake
            return
        telemetry.event("cluster/resize_rx", executor_id=self.executor_id,
                        epoch=epoch,
                        world_size=directive.get("world_size"),
                        reason=directive.get("reason"))
        logger.info("node %d received resize directive: epoch %s world %s "
                    "(%s)", self.executor_id, epoch,
                    directive.get("world_size"), directive.get("reason"))

    def _maybe_snapshot(self, cap):
        cid = cap.get("id") if isinstance(cap, dict) else None
        if cid is None or cid == self._capture_seen:
            return
        self._capture_seen = cid
        # Capture runs on its OWN thread: a snapshot that includes a
        # profiler trace sleeps for profile_secs, and sleeping on the
        # beat loop would silence heartbeats past the miss budget — the
        # capture itself would make a healthy node classify hung and
        # hand the supervisor a phantom incident.
        threading.Thread(
            target=self._snapshot_and_send, args=(cap, cid),
            name="capture-{}".format(self.executor_id), daemon=True,
        ).start()

    def _snapshot_and_send(self, cap, cid):
        try:
            with telemetry.span("capture/snapshot", capture=cid):
                snap = incident.node_snapshot(
                    profile_secs=float(cap.get("profile_secs") or 0.0))
        except Exception:  # capture must never kill the liveness beacon
            logger.warning("node snapshot failed", exc_info=True)
            return
        try:
            # KV bridge: the driver's manager fallback can read the latest
            # snapshot even if the SNAP reply below is lost.
            self.mgr.set("node_snapshot", dict(snap, capture=cid))
        except Exception:
            pass
        # The lock serializes the shared control socket against the beat
        # loop (and makes a long profile capture's send wait its turn).
        with self._lock:
            client = self._client
            if client is None:
                return
            try:
                client.send_snapshot(self.executor_id, cid, snap)
            except Exception:
                logger.warning("snapshot send failed", exc_info=True)

    def stop(self):
        # No lock: closing the socket from here unblocks a beat in flight
        # (the sender thread then exits on the resulting OSError).
        self._stop.set()
        client, self._client = self._client, None
        if client is not None:
            client.close()


def _manager_status_fn(mgr):
    """/statusz enrichment: the node's manager-reported lifecycle state
    and the compute process's last published stats (best-effort — the
    manager may die before the server does)."""
    def status():
        out = {"state": None, "node_stats": None}
        try:
            out["state"] = mgr.get("state")
            out["node_stats"] = mgr.get("node_stats")
        except Exception:
            pass
        return out
    return status


def _manager_stats_fn(mgr):
    """/metrics enrichment: the compute child's heartbeat-published stats
    dict, rendered as ``tfos_node_*`` gauges by the server."""
    def stats():
        try:
            return mgr.get("node_stats")
        except Exception:
            return None
    return stats


def _maybe_start_heartbeat(ctx, mgr):
    """Start a :class:`HeartbeatSender` when the ctx carries the server
    address (clusters predating the supervision layer simply don't beat)."""
    if not getattr(ctx, "server_addr", None):
        return None
    return HeartbeatSender(
        ctx.server_addr, ctx.executor_id, mgr,
        interval=getattr(ctx, "heartbeat_interval", 2.0) or 2.0,
    ).start()


class NodeContext:
    """The ``ctx`` handed to user code (reference ``TFSparkNode.py:32-71``)."""

    def __init__(self, executor_id, job_name, task_index, cluster_spec,
                 default_fs, working_dir, mgr, devices=None,
                 server_addr=None, heartbeat_interval=2.0,
                 telemetry_dir=None):
        self.executor_id = executor_id
        self.worker_num = executor_id  # reference alias
        self.job_name = job_name
        self.task_index = task_index
        self.cluster_spec = cluster_spec
        self.default_fs = default_fs
        self.working_dir = working_dir
        self.mgr = mgr
        self.devices = devices or {}
        # Liveness beacon wiring (the supervision layer): the rendezvous
        # server doubles as the heartbeat sink.
        self.server_addr = tuple(server_addr) if server_addr else None
        self.heartbeat_interval = heartbeat_interval
        # Span-export root for this cluster run (None = not exporting);
        # the FEED compute child configures its exporter from this.
        self.telemetry_dir = telemetry_dir
        # The rendezvous-reserved port's bound socket (foreground nodes
        # only): held open until the consumer of the port binds it, closing
        # the steal window (reference holds its bound socket until the TF
        # server takes it, TFSparkNode.py:233).
        self._reserved_sock = None

    def __getstate__(self):
        # Sockets don't pickle (background compute children receive the ctx
        # via cloudpickle); the child's port was released pre-spawn.
        state = dict(self.__dict__)
        state["_reserved_sock"] = None
        return state

    def release_port(self):
        """Close the reserved-port placeholder socket; call immediately
        before binding the advertised port."""
        sock, self._reserved_sock = self._reserved_sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:  # pragma: no cover - already closed
                pass

    @property
    def num_workers(self):
        return sum(
            len(hosts) for job, hosts in self.cluster_spec.items() if job != "ps"
        )

    def absolute_path(self, path):
        """Fully-qualified URI against the cluster default FS
        (reference ``TFNode.hdfs_path``)."""
        return paths.absolute_path(path, self.default_fs, self.working_dir)

    def poll_resize(self):
        """The newest elastic resize directive this node program has not
        yet consumed, or None.

        Call at a step boundary (the resize barrier): a directive means
        membership changed — the program should roll back to its last
        committed checkpoint step, rebuild its mesh at the directive's
        ``world_size``, and continue. Delivery is one-shot per epoch:
        the same directive is never handed out twice, so the barrier
        runs exactly once per membership change. The directive lands in
        the manager KV via the heartbeat reply
        (``HeartbeatSender._apply_resize``).
        """
        try:
            directive = self.mgr.get("resize")
        except Exception:  # manager gone (teardown)
            return None
        if not isinstance(directive, dict):
            return None
        epoch = directive.get("epoch")
        if epoch is None or epoch == getattr(self, "_resize_epoch_seen", None):
            return None
        self._resize_epoch_seen = epoch
        return directive

    def get_data_feed(self, train_mode=True, qname_in="input",
                      qname_out="output", input_mapping=None):
        """The feed-plane consumer for this node (reference ``TFNode.DataFeed``)."""
        return feed.DataFeed(self.mgr, train_mode, qname_in, qname_out, input_mapping)

    def export_saved_model(self, export_dir, model_name, **kwargs):
        """Write an export directory (reference ``ctx.export_saved_model``,
        ``TFSparkNode.py:60-66`` delegating to ``TFNode.py:126-169``):
        :func:`~tensorflowonspark_tpu_torch.export.export_saved_model` at
        this cluster's absolute path. Every rank of a process group calls
        it (a state sharded over a mesh is gathered); rank 0 writes."""
        from tensorflowonspark_tpu_torch import export as export_lib

        return export_lib.export_saved_model(
            paths.strip_scheme(self.absolute_path(export_dir)),
            model_name, **kwargs,
        )

    def initialize_distributed(self, device="cuda"):
        """Join the ``torch.distributed`` process group of this cluster's
        workers, using the rendezvoused layout.

        The analog of the reference's ``start_cluster_server``
        (``TFNode.py:52-118``): every worker joins one process group at the
        chief's coordinator address (its rendezvous-reserved port, released
        here just before rank 0's ``TCPStore`` binds it), with the rank and
        world size that ``_export_environment`` put in the
        ``TPU_FRAMEWORK_*`` environment. :data:`multihost.DEFAULT_TIMEOUT`
        bounds the rendezvous and every collective after it.

        Sets :attr:`device`, this rank's device: on the card ``cuda:<local
        rank modulo the cards>``, else the CPU (``device="cpu"``). The
        backend is ``nccl`` when each local rank has a card of its own and
        ``gloo`` when ranks share a card or run on the CPU (NCCL refuses two ranks on one card). The choice and
        its reason are logged and kept in :attr:`distributed_backend` and
        :attr:`distributed_backend_reason`. An ``nccl`` initialisation
        that fails raises; nothing falls back to gloo.

        Returns True when a multi-process group was joined (or already
        is), False for single-process clusters and ps-role nodes.
        """
        import torch
        import torch.distributed as dist

        from tensorflowonspark_tpu_torch.parallel import multihost

        dev = device_info.resolve_device(device)
        coord = os.environ.get("TPU_FRAMEWORK_COORDINATOR")
        nprocs = int(os.environ.get("TPU_FRAMEWORK_NUM_PROCESSES", "1"))
        rank = os.environ.get("TPU_FRAMEWORK_PROCESS_ID")
        local_rank = int(os.environ.get("TPU_FRAMEWORK_LOCAL_RANK", "0"))
        local_world = int(os.environ.get("TPU_FRAMEWORK_LOCAL_WORLD", "1"))
        shared = False
        if dev.type == "cuda":
            cards = torch.cuda.device_count()
            dev = torch.device("cuda", local_rank % cards)
            torch.cuda.set_device(dev)
            shared = local_world > cards
        self.device = dev
        if not coord or nprocs <= 1 or rank is None:
            return False
        if dev.type == "cpu":
            backend, why = "gloo", "ranks run on the CPU"
        elif shared:
            backend, why = "gloo", (
                "{} local ranks share {} card(s), and NCCL refuses two "
                "ranks on one card".format(local_world,
                                           torch.cuda.device_count()))
        else:
            backend, why = "nccl", "each local rank has a card of its own"
        self.distributed_backend = backend
        self.distributed_backend_reason = why
        if dist.is_available() and dist.is_initialized():
            return True
        logger.info("rank %s/%d on %s: backend %s (%s)", rank, nprocs, dev,
                    backend, why)
        telemetry.event("node/distributed_init", rank=int(rank),
                        world_size=nprocs, backend=backend, reason=why,
                        device=str(dev))
        # Release the reserved port only now: the chief binds it next, so
        # the steal window is short.
        self.release_port()
        multihost.initialize(coord, nprocs, int(rank), backend)
        return True


class NodeRunner:
    """The once-per-executor bring-up closure (reference ``_mapfn``,
    ``TFSparkNode.py:120-354``)."""

    def __init__(self, fn, tf_args, cluster_meta, background,
                 queues=DEFAULT_QUEUES, driver_side=False):
        self.fn = fn
        self.tf_args = tf_args
        self.cluster_meta = cluster_meta
        self.background = background
        self.queues = tuple(queues)
        # Driver-side service nodes (driver_ps_nodes) run as threads in the
        # driver process: skip the executor-local bookkeeping files, which
        # assume one node per working directory.
        self.driver_side = driver_side

    def __call__(self, iterator):
        meta = self.cluster_meta
        executor_id = next(iter(iterator))
        if not self.driver_side:
            util.write_executor_id(executor_id)
            # Wedge diagnosis: SIGUSR2 dumps every thread's stack to
            # stderr (kill -USR2 <executor pid>).
            incident.register_sigusr2()

        job_name, task_index = _assign_role(meta["cluster_template"], executor_id)
        logger.info("node %d assigned role %s:%d", executor_id, job_name, task_index)

        # Opt-in span export from the runtime itself — configured BEFORE
        # the reservation client so rendezvous lands on the timeline.
        # The executor gets its own file; the FEED-mode compute child
        # (a different process) exports to `node<id>.jsonl` separately —
        # two processes must never interleave one buffered stream.
        # Driver-side service nodes skip this: they share the driver
        # process, whose recorder belongs to the driver.
        if meta.get("telemetry_dir") and not self.driver_side:
            telemetry.configure(
                node_id="node{}-exec".format(executor_id),
                export_dir=meta["telemetry_dir"])

        if not self.driver_side:
            _check_stale_manager(meta["id"])

        authkey = uuid.uuid4().bytes
        mode = "remote" if (job_name == "ps" or self.background) else "local"
        mgr = manager.start(authkey, self.queues, mode=mode)
        _started_managers[executor_id] = mgr
        mgr.set("state", "running")
        if not self.driver_side:
            with open(_MANAGER_FILE, "w") as f:
                json.dump(
                    {
                        "cluster_id": meta["id"],
                        "address": list(mgr.address),
                        "authkey": authkey.hex(),
                    },
                    f,
                )

        # Reserve this node's port while we rendezvous (reference holds the
        # bound socket open until the TF server takes it, TFSparkNode.py:233).
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.bind(("", 0))
        port = sock.getsockname()[1]
        host = util.get_ip_address()

        # Advertise a reachable manager address: remote managers bind 0.0.0.0.
        mgr_host, mgr_port = mgr.address
        if mgr_host in ("", "0.0.0.0"):
            mgr_host = host

        client = reservation.Client(meta["server_addr"])
        node_meta = {
            "executor_id": executor_id,
            "host": host,
            "job_name": job_name,
            "task_index": task_index,
            "port": port,
            "addr": [mgr_host, mgr_port],
            "authkey": authkey.hex(),
        }

        # Chief worker hosts the metrics/TensorBoard service over the log
        # dir (reference: the TensorBoard subprocess spawned on the chief
        # with a dynamically-bound port, TFSparkNode.py:197-221, registered
        # as tb_port in the reservation, :248-249). Exactly ONE chief: the
        # lowest non-ps executor id in the template (with a master role the
        # first worker would otherwise also match task_index == 0).
        chief_id = min(
            (i for job, ids in meta["cluster_template"].items()
             if job != "ps" for i in ids),
            default=None,
        )
        if meta.get("tensorboard") and executor_id == chief_id:
            from tensorflowonspark_tpu_torch.train import metrics as metrics_lib

            log_dir = paths.strip_scheme(
                paths.absolute_path(
                    meta.get("log_dir") or os.getcwd(),
                    meta["default_fs"], os.getcwd(),
                )
            )
            os.makedirs(log_dir, exist_ok=True)
            _stop_metrics_server()  # a prior cluster's server, if any
            # Bound to the address this node advertises: the server is the
            # cluster-facing service (its port rides the reservation, the
            # driver and peers scrape it).
            metrics_server = metrics_lib.MetricsServer(
                host=host, status_fn=_manager_status_fn(mgr),
                stats_fn=_manager_stats_fn(mgr))
            metrics_server.start()
            _metrics_servers["chief"] = metrics_server
            node_meta["metrics_port"] = metrics_server.port
            logger.info("metrics server on %s:%s serving %s",
                        host, metrics_server.port, log_dir)
            # And the real thing when available: a live tensorboard
            # subprocess over the same log dir (the reference's actual
            # chief behavior, TFSparkNode.py:197-230); its port rides
            # the reservation like the reference's tb_port (:248-249).
            tb = _maybe_start_tensorboard(log_dir)
            if tb is not None:
                _metrics_servers["tensorboard"] = tb
                node_meta["tb_port"] = tb.port
                node_meta["tb_pid"] = tb.pid
        try:
            client.register(node_meta)
            cluster_info = client.await_reservations(
                timeout=meta.get("reservation_timeout", 600)
            )
        except Exception:
            # Failed bring-up (driver died, rendezvous timeout): reap the
            # chief's metrics server AND the tensorboard OS subprocess —
            # in a persistent executor a leaked child would hold its port
            # until some future cluster reuses this slot as chief.
            _stop_metrics_server()
            raise

        cluster_spec = build_cluster_spec(cluster_info)
        if not self.driver_side:
            # Driver-side service nodes must not leak cluster coordinator
            # variables into the driver process environment.
            _export_environment(cluster_spec, cluster_info, job_name, task_index)

        ctx = NodeContext(
            executor_id=executor_id,
            job_name=job_name,
            task_index=task_index,
            cluster_spec=cluster_spec,
            default_fs=meta["default_fs"],
            working_dir=os.getcwd(),
            mgr=mgr,
            server_addr=meta["server_addr"],
            heartbeat_interval=meta.get("heartbeat_interval", 2.0),
            telemetry_dir=meta.get("telemetry_dir"),
        )

        if job_name == "ps":
            sock.close()
            self._service_loop(ctx, mgr, client)
        elif self.background:
            # The child interpreter cannot inherit the fd across spawn;
            # closing pre-spawn is the narrowest window available here.
            sock.close()
            self._spawn_compute(ctx, mgr)
        else:
            # Foreground: hand the bound socket to the ctx so the port stays
            # reserved until initialize_distributed (or user code via
            # ctx.release_port) actually binds it.
            ctx._reserved_sock = sock
            sender = _maybe_start_heartbeat(ctx, mgr)
            try:
                _run_user_fn(self.fn, self.tf_args, ctx, mgr)
            except BaseException:
                if sender is not None:
                    sender.flush("error")
                    sender.stop()
                raise
            finally:
                ctx.release_port()
                # FILES mode has no ShutdownTask; release the chief's
                # metrics server with the node program.
                _stop_metrics_server()
            mgr.set("state", "finished")
            if sender is not None:
                sender.flush("finished")
                sender.stop()
        client.close()
        return []

    def _spawn_compute(self, ctx, mgr):
        """FEED mode: user fn runs in a child process; this task returns so
        the executor can accept feeder tasks (reference ``TFSparkNode.py:321-329``).

        spawn + cloudpickle payload: the child gets a fresh interpreter (a
        CUDA context must not be inherited across a fork) and the user fn
        may be a closure.
        """
        payload = backend_mod.dumps((self.fn, self.tf_args, ctx, mgr))
        p = multiprocessing.get_context("spawn").Process(
            target=_compute_child_entry, args=(payload,),
            name="compute-{}".format(ctx.executor_id),
            daemon=True,  # dies with its executor; spawns no processes itself
        )
        p.start()
        # Published so a supervisor teardown (ReapComputeTask) can SIGKILL
        # a wedged child before relaunching — a hung process that wakes
        # later must never double-write the relaunched job's checkpoints.
        # The handle stays here, in the executor that spawned the child,
        # so that the reap can wait for the exit.
        for pid, old in list(_compute_procs.items()):
            if not old.is_alive():  # an earlier cluster's, finished
                del _compute_procs[pid]
        _compute_procs[p.pid] = p
        mgr.set("compute_pid", p.pid)
        logger.info("node %d compute child pid=%d", ctx.executor_id, p.pid)

    def _service_loop(self, ctx, mgr, client):
        """ps-role lifecycle loop: block on the control queue until the
        driver sends ``None`` (reference ``TFSparkNode.py:331-349``)."""
        sender = _maybe_start_heartbeat(ctx, mgr)
        control = mgr.get_queue("control")
        done = False
        while not done:
            while True:
                msg = control.get(block=True)
                control.task_done()
                if msg is None:
                    done = True
                    break
        mgr.set("state", "stopped")
        if sender is not None:
            sender.flush("stopped")
            sender.stop()


def _compute_child_entry(payload):
    # daemon=True handles a cleanly-exiting executor; PDEATHSIG handles a
    # SIGKILLed one (the pool's own straggler remedy), which runs no
    # multiprocessing atexit and would otherwise orphan this child.
    util.set_pdeathsig()
    # A wedged compute child (native collective that never returns) can
    # always be diagnosed externally: kill -USR2 <pid> dumps all stacks.
    incident.register_sigusr2()
    fn, tf_args, ctx, mgr = backend_mod.loads(payload)
    _compute_child(fn, tf_args, ctx, mgr)


def _compute_child(fn, tf_args, ctx, mgr):
    # Span export for the process that does the actual work (the
    # executor's runner exported under `node<id>-exec`); user programs
    # that configure their own exporter simply replace this recorder.
    if getattr(ctx, "telemetry_dir", None):
        telemetry.configure(
            node_id="node{}".format(ctx.executor_id),
            export_dir=ctx.telemetry_dir)
    # The liveness beacon lives HERE, in the compute process — not in the
    # executor: an executor-side beacon would keep beating over a dead or
    # wedged child and mask exactly the failures it exists to expose.
    sender = _maybe_start_heartbeat(ctx, mgr)
    try:
        _run_user_fn(fn, tf_args, ctx, mgr)
        mgr.set("state", "finished")
        if sender is not None:
            sender.flush("finished")
    except BaseException:
        tb = traceback.format_exc()
        mgr.get_queue("error").put(tb)
        mgr.set("state", "error")
        # Synchronous final beat: the periodic thread dies with this
        # process and might never report the error state, which would
        # downgrade the driver's classification from crashed to hung.
        if sender is not None:
            sender.flush("error")
        raise
    finally:
        if sender is not None:
            sender.stop()


def _run_user_fn(fn, tf_args, ctx, mgr):
    """Invoke user code with ARGV passthrough parity
    (reference ``TFSparkNode.py:306-310``)."""
    if isinstance(tf_args, list):
        sys.argv = [sys.argv[0]] + list(tf_args)
    try:
        fn(tf_args, ctx)
    except BaseException as e:
        # Timeline marker BEFORE the error-queue put: if the node program
        # configured telemetry export, the crash lands in the merged trace
        # at the moment it happened, not when the driver noticed.
        telemetry.event("node/error", executor_id=ctx.executor_id,
                        error="{}: {}".format(type(e).__name__, e))
        # Black-box preservation: the flight-recorder ring and stacks of
        # a crashing process die with it, but the per-executor manager
        # process survives — publish the crash snapshot there so the
        # driver's incident capture can pull it after this process is
        # gone (incident.IncidentRecorder._fallback_from_managers).
        try:
            mgr.set("crash_snapshot",
                    dict(incident.node_snapshot(),
                         executor_id=ctx.executor_id,
                         error="{}: {}".format(type(e).__name__, e)))
        except Exception:  # evidence is best-effort; the raise is not
            logger.debug("crash snapshot publish failed", exc_info=True)
        mgr.get_queue("error").put(traceback.format_exc())
        mgr.set("state", "error")
        raise


def _assign_role(cluster_template, executor_id):
    """Role + task index from the cluster template
    (reference ``TFSparkNode.py:146-156``)."""
    for job_name, ids in cluster_template.items():
        if executor_id in ids:
            return job_name, ids.index(executor_id)
    raise ValueError(
        "executor {} not present in cluster template {}".format(
            executor_id, cluster_template
        )
    )


def _check_stale_manager(cluster_id):
    """Detect a live manager from a previous/overlapping cluster and request
    rescheduling (reference ``TFSparkNode.py:163-170``)."""
    if not os.path.exists(_MANAGER_FILE):
        return
    try:
        with open(_MANAGER_FILE) as f:
            prior = json.load(f)
        mgr = manager.connect(tuple(prior["address"]), bytes.fromhex(prior["authkey"]))
        state = mgr.get("state")
    except Exception:
        return  # dead manager: fine, we replace it
    if state in ("running", "terminating"):
        if prior.get("cluster_id") != cluster_id:
            raise backend_mod.RetryTask(
                "executor has a live manager from cluster {} (state={}); "
                "rescheduling".format(prior.get("cluster_id"), state)
            )
        raise backend_mod.RetryTask(
            "duplicate node bring-up for cluster {} on this executor".format(cluster_id)
        )


def build_cluster_spec(cluster_info):
    """``{job: ["host:port", ...]}`` ordered by executor id
    (reference ``TFSparkNode.py:260-272``)."""
    spec = {}
    for node in sorted(cluster_info, key=lambda n: n["executor_id"]):
        spec.setdefault(node["job_name"], []).append(
            "{}:{}".format(node["host"], node["port"])
        )
    return spec


def _export_environment(cluster_spec, cluster_info, job_name, task_index):
    """Publish the cluster layout to the process environment.

    ``TPU_FRAMEWORK_CLUSTER`` is the ``TF_CONFIG`` analog
    (reference ``TFSparkNode.py:274-281``); the coordinator variables feed
    ``NodeContext.initialize_distributed``. The port adds
    ``TPU_FRAMEWORK_LOCAL_RANK`` and ``TPU_FRAMEWORK_LOCAL_WORLD`` (this
    worker's index among the workers of its host, and their count): they
    pick the card and the backend.
    """
    os.environ["TPU_FRAMEWORK_CLUSTER"] = json.dumps(
        {"cluster": cluster_spec, "task": {"type": job_name, "index": task_index}}
    )
    workers = sorted(
        (n for n in cluster_info if n["job_name"] != "ps"),
        key=lambda n: n["executor_id"],
    )
    if workers:
        chief = workers[0]
        os.environ["TPU_FRAMEWORK_COORDINATOR"] = "{}:{}".format(
            chief["host"], chief["port"]
        )
        os.environ["TPU_FRAMEWORK_NUM_PROCESSES"] = str(len(workers))
        # This worker's rank in the global runtime (ps nodes do not join).
        for rank, n in enumerate(workers):
            if n["job_name"] == job_name and n["task_index"] == task_index:
                os.environ["TPU_FRAMEWORK_PROCESS_ID"] = str(rank)
                local = [w for w in workers if w["host"] == n["host"]]
                os.environ["TPU_FRAMEWORK_LOCAL_RANK"] = str(local.index(n))
                os.environ["TPU_FRAMEWORK_LOCAL_WORLD"] = str(len(local))
                break
        else:
            for var in ("TPU_FRAMEWORK_PROCESS_ID",
                        "TPU_FRAMEWORK_LOCAL_RANK",
                        "TPU_FRAMEWORK_LOCAL_WORLD"):
                os.environ.pop(var, None)


# ---------------------------------------------------------------------------
# Feeder tasks (run on executors *after* bring-up; reference
# TFSparkNode.train/inference/shutdown, :359-525)
# ---------------------------------------------------------------------------


def _get_manager(cluster_info, host, executor_id):
    match = [n for n in cluster_info if n["executor_id"] == executor_id]
    if not match:
        raise RuntimeError(
            "no cluster node for executor {} on {}".format(executor_id, host)
        )
    node = match[0]
    # The authkey is unique per cluster run, so a second cluster on the same
    # executors never reuses a stale connection to the previous manager.
    key = (host, executor_id, node["authkey"])
    if key not in _mgr_cache:
        _mgr_cache[key] = manager.connect(
            tuple(node["addr"]), bytes.fromhex(node["authkey"])
        )
    return _mgr_cache[key]


def _join_with_error_monitor(mgr, q):
    """Block on ``q.join()`` while surfacing compute-child tracebacks
    (reference ``TFSparkNode.py:397-404``) — and while observing the
    node's lifecycle state, so a consumer that died (or was torn down by
    the supervisor) after the puts completed cannot strand this feeder in
    ``join()`` forever."""
    joiner = threading.Thread(target=q.join, daemon=True)
    joiner.start()
    while joiner.is_alive():
        feed._poll_error_queue(mgr)
        state = mgr.get("state")
        if state == "error":
            # The traceback may lag the state flip by one queue hop.
            feed._poll_error_queue(mgr, timeout=5)
            raise RuntimeError(
                "remote compute process failed (state=error) with queued "
                "items unconsumed; no traceback was recorded"
            )
        if state in ("stopped", "finished"):
            # stopped: supervisor teardown. finished: the node program
            # returned early without terminate() — either way nothing
            # will ever consume the queued items.
            logger.warning(
                "node went %s with queued items unconsumed; abandoning "
                "join", state
            )
            return
        joiner.join(1.0)


def _put_checked(mgr, q, item, poll=2.0):
    """Bounded-queue put that observes the node's failure state.

    Returns True when the item was enqueued; False when the node reached a
    terminal-but-healthy state mid-partition (``terminating``/``finished``/
    ``stopped`` — the caller should drain and stop feeding). A consumer
    that *died* raises the remote traceback instead of blocking forever on
    a full queue (the reference's feeder had no such check — a crashed TF
    process mid-partition hung the Spark task until its timeout).
    """
    while True:
        try:
            q.put(item, block=True, timeout=poll)
            return True
        except _queue_mod.Full:
            feed._poll_error_queue(mgr)
            state = mgr.get("state")
            if state == "error":
                feed._poll_error_queue(mgr, timeout=5)
                raise RuntimeError(
                    "remote compute process failed (state=error) while the "
                    "feed queue was full; no traceback was recorded"
                )
            if state in ("terminating", "finished", "stopped"):
                return False


class TrainFeeder:
    """Push one partition of training data into the local node's input queue
    (reference ``TFSparkNode.train``, ``:359-422``)."""

    def __init__(self, cluster_info, cluster_meta, qname="input"):
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.qname = qname

    def __call__(self, iterator):
        host = util.get_ip_address()
        executor_id = util.read_executor_id()
        mgr = _get_manager(self.cluster_info, host, executor_id)

        state = mgr.get("state")
        if state in ("terminating", "finished", "stopped"):
            # Training ended (early-terminate or the node program already
            # returned): drain this partition so the job can finish instead
            # of feeding a queue nobody consumes, and ask the rendezvous
            # server to stop (streaming case). A "stopped" state means the
            # DRIVER tore this node down (supervisor teardown) — it already
            # knows, and its server is likely gone: don't dial it.
            logger.info("node %d %s; draining partition", executor_id, state)
            for _ in iterator:
                pass
            if state != "stopped":
                self._request_stop()
            return []
        if state == "error":
            for _ in iterator:
                pass
            feed._poll_error_queue(mgr)
            return []

        q = mgr.get_queue(self.qname)
        count = 0
        for item in iterator:
            if not _put_checked(mgr, q, item):
                # Terminal state mid-partition: drain and (streaming case)
                # ask the server to stop, like the pre-check path above.
                logger.info("node %d went terminal mid-partition after %d "
                            "item(s); draining", executor_id, count)
                for _ in iterator:
                    pass
                if mgr.get("state") != "stopped":
                    self._request_stop()
                return []
            count += 1
        logger.info("node %d fed %d items", executor_id, count)
        _join_with_error_monitor(mgr, q)
        return []

    def _request_stop(self):
        """Best-effort STOP to the rendezvous server, on a short budget
        (the server may be mid-teardown)."""
        try:
            reservation.Client(
                self.cluster_meta["server_addr"], retries=2, deadline=3.0
            ).request_stop()
        except (ConnectionError, TimeoutError, OSError):
            pass


class InferenceFeeder:
    """Feed one partition and collect exactly one result per input item
    (reference ``TFSparkNode.inference``, ``:425-482``)."""

    def __init__(self, cluster_info, qname_in="input", qname_out="output"):
        self.cluster_info = cluster_info
        self.qname_in = qname_in
        self.qname_out = qname_out

    def __call__(self, iterator):
        host = util.get_ip_address()
        executor_id = util.read_executor_id()
        mgr = _get_manager(self.cluster_info, host, executor_id)

        q_in = mgr.get_queue(self.qname_in)
        count = 0
        for item in iterator:
            if not _put_checked(mgr, q_in, item):
                # Unlike training, inference owes one output per input:
                # a consumer gone terminal mid-partition cannot produce
                # them, so this partition must fail loudly.
                raise RuntimeError(
                    "inference consumer on executor {} stopped (state={}) "
                    "after {} of its partition's items were fed".format(
                        executor_id, mgr.get("state"), count
                    )
                )
            count += 1
        if count == 0:
            return []
        if not _put_checked(mgr, q_in, marker.EndPartition()):
            raise RuntimeError(
                "inference consumer on executor {} stopped before the "
                "partition boundary marker could be fed".format(executor_id)
            )
        _join_with_error_monitor(mgr, q_in)

        q_out = mgr.get_queue(self.qname_out)
        results = []
        while len(results) < count:
            try:
                results.append(q_out.get(block=True, timeout=5))
            except _queue_mod.Empty:
                feed._poll_error_queue(mgr)
                # "finished" is terminal too: a consumer that exited
                # cleanly but under-produced will never send more — 5s of
                # queue silence plus a terminal state means stop waiting.
                if mgr.get("state") in ("error", "stopped", "finished"):
                    # The traceback can lag the state flip by a queue hop;
                    # give it a moment before degrading to the generic error.
                    feed._poll_error_queue(mgr, timeout=5)
                    raise RuntimeError(
                        "inference consumer on executor {} stopped (state="
                        "{}) with {} of {} result(s) delivered".format(
                            executor_id, mgr.get("state"), len(results), count
                        )
                    )
                continue
            q_out.task_done()
        return results


class ShutdownTask:
    """End-of-feed for one worker node: push ``None`` into every queue and
    wait for the compute process to finish (reference ``TFSparkNode.shutdown``,
    ``:485-525``)."""

    def __init__(self, cluster_info, queues=("input", "control"), grace=60):
        self.cluster_info = cluster_info
        self.queues = queues
        self.grace = grace

    def __call__(self, iterator):
        host = util.get_ip_address()
        executor_id = util.read_executor_id()
        mgr = _get_manager(self.cluster_info, host, executor_id)
        deadline = time.time() + self.grace
        for qname in self.queues:
            # The input queue is bounded: a slow-but-alive consumer can
            # keep it Full past any single put timeout, and a silently
            # dropped sentinel would wedge it in next_batch forever once
            # it drains the backlog. Keep retrying inside the grace
            # budget; give up early only when the node is already
            # terminal (then nobody is waiting for the sentinel).
            while True:
                try:
                    mgr.get_queue(qname).put(None, block=True, timeout=2)
                    break
                except _queue_mod.Full:
                    if time.time() >= deadline:
                        break
                    try:  # manager may die mid-shutdown: stay best-effort
                        if mgr.get("state") in ("finished", "error", "stopped"):
                            break
                    except Exception:
                        break
                except Exception:  # queue may not exist for this node
                    break
        while time.time() < deadline:
            if mgr.get("state") in ("finished", "error", "stopped"):
                break
            time.sleep(0.5)
        feed._poll_error_queue(mgr)
        mgr.set("state", "stopped")
        _stop_metrics_server()  # chief only; no-op elsewhere
        return []


class ReapComputeTask:
    """Supervisor-teardown task: SIGKILL this executor's compute child and
    wait for it to exit.

    A node classified dead may still have a live process — wedged in a
    native collective that could return minutes later, or sleeping in an
    injected hang. Flipping the manager state stops the *feed* plane, but
    only killing the process guarantees it cannot wake after the relaunch
    and double-write the new job's checkpoint tree (or hold the devices
    and ports the relaunch needs). The kill is not enough on its own: a
    dying process holds its CUDA context (and the card memory in it)
    until it has exited, so the task waits up to ``grace`` seconds for the
    exit and reaps it, and the relaunch finds the memory free. Runs on the
    executor (same host as the child); the pid was published to the
    manager KV at spawn.
    """

    def __init__(self, cluster_info, grace=30.0):
        self.cluster_info = cluster_info
        self.grace = float(grace)

    def __call__(self, iterator):
        for _ in iterator:
            pass
        host = util.get_ip_address()
        executor_id = util.read_executor_id()
        try:
            mgr = _get_manager(self.cluster_info, host, executor_id)
            pid = mgr.get("compute_pid")
        except Exception:  # manager died with the node: nothing to reap
            return []
        if pid:
            try:
                os.kill(int(pid), signal.SIGKILL)
                logger.warning("teardown killed compute child pid=%s on "
                               "executor %d", pid, executor_id)
            except (OSError, ValueError):  # already gone
                pass
            if not _wait_exited(int(pid), self.grace):
                logger.error("compute child pid=%s on executor %d still "
                             "alive %.0fs after SIGKILL", pid, executor_id,
                             self.grace)
        try:
            mgr.set("state", "stopped")
        except Exception:
            pass
        return []


def _wait_exited(pid, timeout):
    """Join compute child ``pid`` of this executor for up to ``timeout``
    seconds; True once it has exited. A pid this executor did not spawn
    died with the executor that did (``util.set_pdeathsig``)."""
    proc = _compute_procs.pop(pid, None)
    if proc is None:
        return True
    proc.join(timeout)
    return not proc.is_alive()
