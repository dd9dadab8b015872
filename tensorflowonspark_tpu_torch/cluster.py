"""Driver-side cluster lifecycle: the ``TFCluster`` analog (the port of
the JAX package's ``cluster.py``).

A re-design of the reference's ``tensorflowonspark/TFCluster.py``:
``run()`` turns a backend's executors into a rendezvoused node set, whose
node programs join one ``torch.distributed`` group
(``ctx.initialize_distributed()``) instead of starting a
``tf.train.Server``; ``train()`` pushes partitioned data into per-node
input queues; ``inference()`` returns per-partition results;
``shutdown()`` tears everything down with the same busy-node
control-channel trick the reference used for parameter servers.

``restart_policy`` makes ``run`` return a
:class:`~tensorflowonspark_tpu_torch.supervisor.SupervisedCluster`
(relaunch from the latest committed checkpoint); ``elastic`` an
:class:`~tensorflowonspark_tpu_torch.elastic.ElasticCluster` (a dead node
departs and is replaced in place). Any backend with the
``foreach_partition`` surface serves: ``LocalBackend`` or
:class:`~tensorflowonspark_tpu_torch.backend_remote.RemoteBackend`.
``incident_dir`` arms the cluster black box (:mod:`.incident`), ``slos``
the burn-rate SLO monitor over the heartbeat history store, and
:meth:`Cluster.start_dashboard` the driver's observability HTTP service.
"""

import logging
import os
import random
import threading

from tensorflowonspark_tpu_torch import backend as backend_mod
from tensorflowonspark_tpu_torch import manager, node, reservation, telemetry_store

logger = logging.getLogger(__name__)


class InputMode:
    """How data reaches the compute processes (reference ``TFCluster.py:40-43``).

    * ``FILES`` — nodes read sharded files themselves (the reference's
      ``InputMode.TENSORFLOW``).
    * ``FEED`` — the driver pushes partitions through per-node queues (the
      reference's ``InputMode.SPARK``).
    """

    FILES = 0
    FEED = 1
    # Reference-compatible aliases.
    TENSORFLOW = FILES
    SPARK = FEED


class Cluster:
    """A running cluster (returned by :func:`run`)."""

    def __init__(self, backend, cluster_info, cluster_meta, server, input_mode,
                 node_job, status, queues, executor_map=None):
        self.backend = backend
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.server = server
        self.input_mode = input_mode
        self._node_job = node_job
        self._status = status
        self.queues = queues
        # executor id -> backend executor index (differs when service nodes
        # run on the driver and don't occupy backend slots).
        self._executor_map = executor_map or {}
        # Incident-capture recorder (set by run(incident_dir=...)).
        self.incidents = None
        # Driver-side dashboard server (started on demand).
        self._dashboard = None

    def _backend_slot(self, executor_id):
        """The backend executor index that hosts node ``executor_id``
        (feeders, reaps and elastic respawns are pinned there)."""
        return self._executor_map.get(executor_id, executor_id)

    def capture_incident(self, reason="manual", **attrs):
        """Write a cluster black-box bundle now (requires
        ``run(incident_dir=...)``): every node's flight-recorder ring,
        stack dump, stats and profile window, the driver's liveness and
        restart evidence, and the merged timeline. Returns the bundle
        directory (None when rate-limited or capture is not configured).
        The elastic controller calls it before it retires a node."""
        if self.incidents is None:
            return None
        return self.incidents.capture(reason, **attrs)

    # -- data movement ------------------------------------------------------

    def train(self, dataset, num_epochs=1, qname="input", timeout=None):
        """Feed a :class:`~tensorflowonspark_tpu_torch.backend.Partitioned` dataset
        to the cluster (reference ``TFCluster.train``, ``:60-90``)."""
        assert self.input_mode == InputMode.FEED, "train() requires InputMode.FEED"
        logger.info("feeding %d partition(s) x %d epoch(s)",
                    dataset.num_partitions, num_epochs)
        if num_epochs > 1:
            dataset = dataset.repeat(num_epochs)
        feeder = node.TrainFeeder(self.cluster_info, self.cluster_meta, qname)
        self.backend.foreach_partition(
            dataset, feeder, block=True, timeout=timeout,
            assign=self._assign_to_workers(dataset.num_partitions),
        )

    def train_stream(self, stream, qname="input", timeout=None):
        """Feed an unbounded stream of datasets (the DStream analog,
        reference ``TFCluster.train`` with a DStream, ``TFCluster.py:79-81``).

        ``stream`` is an iterable of :class:`Partitioned` micro-batches (or
        of plain partition lists). Feeding continues until the stream is
        exhausted or a ``STOP`` reaches the reservation server — sent either
        by a node calling ``DataFeed.terminate()`` or out-of-band through a
        reservation ``Client.request_stop()``.
        Returns the number of micro-batches fed.
        """
        assert self.input_mode == InputMode.FEED, "train_stream() requires InputMode.FEED"
        fed = 0
        feeder = node.TrainFeeder(self.cluster_info, self.cluster_meta, qname)
        workers = self._worker_ids()
        offset = 0  # rotate across micro-batches so 1-partition streams
        for micro in stream:  # don't pin every batch to the same worker
            if self.server.done.is_set():
                logger.info("stream stopped after %d micro-batch(es)", fed)
                break
            if not isinstance(micro, backend_mod.Partitioned):
                micro = backend_mod.Partitioned(micro)
            self.backend.foreach_partition(
                micro, feeder, block=True, timeout=timeout,
                assign=lambda idx: self._backend_slot(
                    workers[(offset + idx) % len(workers)]
                ),
            )
            offset += micro.num_partitions
            fed += 1
        return fed

    def inference(self, dataset, qname="input", timeout=None):
        """Distributed inference; returns one result per input item, grouped
        by partition (reference ``TFCluster.inference``, ``:92-110``)."""
        assert self.input_mode == InputMode.FEED, "inference() requires InputMode.FEED"
        feeder = node.InferenceFeeder(self.cluster_info, qname_in=qname)
        return self.backend.map_partitions(
            dataset, feeder, timeout=timeout,
            assign=self._assign_to_workers(dataset.num_partitions),
        )

    def _worker_ids(self):
        """Executor ids of the feedable (non-ps) nodes, sorted."""
        return sorted(
            n["executor_id"] for n in self.cluster_info if n["job_name"] != "ps"
        )

    def _assign_to_workers(self, num_partitions):
        """Pin feed tasks to worker (non-ps) executors round-robin."""
        workers = self._worker_ids()
        return lambda idx: self._backend_slot(workers[idx % len(workers)])

    # -- lifecycle ----------------------------------------------------------

    @property
    def liveness(self):
        """The driver-side :class:`~tensorflowonspark_tpu_torch.reservation
        .LivenessMonitor` fed by node heartbeats."""
        return self.server.liveness

    def cluster_stats(self):
        """Live per-node stats on the driver, no SSH: each node's
        liveness status merged with its last heartbeat-reported
        ``telemetry.node_stats()`` (current step, steps/sec, data-wait
        fraction, prefetch depth, last checkpoint step, rss) plus a
        ``straggler: True`` flag on nodes failing the MAD-vs-median
        test."""
        return self.server.liveness.cluster_stats()

    @property
    def history(self):
        """The driver's heartbeat history store
        (:class:`~tensorflowonspark_tpu_torch.telemetry_store.TelemetryStore`):
        retained per-node series, goodput accounting, and the SLO
        monitor. One store per driver process; supervised relaunches keep
        feeding it."""
        return telemetry_store.get_store()

    def goodput(self):
        """Cumulative goodput summary (productive / data-wait /
        checkpoint / compile / restart breakdown) from the history
        store; None before any accounted heartbeat interval."""
        store = telemetry_store.get_store()
        return None if store is None else store.goodput.summary()

    def start_dashboard(self, host=None, port=0):
        """Start the driver-side observability HTTP service
        (:class:`~tensorflowonspark_tpu_torch.train.metrics.MetricsServer`
        over the history store): cluster-aggregated ``/metrics``, the
        ``/timeseries`` query API, ``/dashboard``, ``/traces``,
        ``/profilez`` and ``/incidents``. Returns the bound port.
        Loopback-only unless ``host`` says otherwise."""
        if self._dashboard is not None:
            return self._dashboard.port
        from tensorflowonspark_tpu_torch.train import metrics as metrics_mod

        self._dashboard = metrics_mod.MetricsServer(
            host=host, port=port, store=telemetry_store.get_store(),
            cluster_fn=self.cluster_stats)
        return self._dashboard.start()

    def stop_dashboard(self):
        if self._dashboard is not None:
            self._dashboard.stop()
            self._dashboard = None

    def stragglers(self):
        """Currently-flagged stragglers with evidence
        (:meth:`~tensorflowonspark_tpu_torch.reservation.LivenessMonitor
        .stragglers`): nodes whose steps/sec or data-wait deviated more
        than k·MAD from the cluster median for N consecutive
        heartbeats."""
        return self.server.liveness.stragglers()

    def describe_outstanding(self):
        """Per-node liveness detail (executor id, role, last-heartbeat
        age) for the nodes not known to have reached a terminal state —
        the payload of shutdown-timeout errors."""
        snap = self.server.liveness.snapshot()
        pending = [
            n["executor_id"] for n in self.cluster_info
            if snap.get(n["executor_id"], {}).get("state")
            not in ("finished", "stopped")
        ]
        return self.server.liveness.describe(pending)

    def shutdown(self, timeout=600):
        """Graceful teardown (reference ``TFCluster.shutdown``, ``:112-180``).

        Workers get end-of-feed sentinels via their queues; busy ``ps``
        service nodes are stopped straight from the driver through their
        remote managers (the reference's ``TFCluster.py:163-172`` pattern);
        any recorded error is re-raised after cleanup. A timeout names the
        nodes still outstanding (id, role, heartbeat age) instead of
        raising bare.
        """
        workers = [n for n in self.cluster_info if n["job_name"] != "ps"]
        ps_nodes = [n for n in self.cluster_info if n["job_name"] == "ps"]

        try:
            if self.input_mode == InputMode.FEED:
                task = node.ShutdownTask(self.cluster_info)
                self.backend.foreach_partition(
                    [[0]] * len(workers), task, block=True, timeout=timeout,
                    assign=lambda idx: self._backend_slot(
                        workers[idx]["executor_id"]
                    ),
                )

            # Stop lifecycle-only service nodes from the driver: their
            # executors are blocked in the service loop and cannot accept
            # tasks.
            for meta in ps_nodes:
                mgr = manager.connect(
                    tuple(meta["addr"]), bytes.fromhex(meta["authkey"])
                )
                mgr.get_queue("control").put(None, block=True)

            if self._node_job is not None:
                self._node_job.wait(timeout)
        except TimeoutError as e:
            self.server.stop()
            raise TimeoutError(
                "cluster shutdown timed out after {}s ({}); outstanding "
                "nodes: {}".format(timeout, e, self.describe_outstanding())
            ) from e

        self.server.stop()
        if self._status.get("error"):
            raise RuntimeError(
                "cluster failed:\n{}".format(self._status["error"])
            )

    def metrics_url(self):
        """URL of the chief node's metrics HTTP service, if running
        (the built-in scalar server; always present under
        ``tensorboard=True``)."""
        for n in self.cluster_info:
            if n.get("metrics_port"):
                return "http://{}:{}".format(n["host"], n["metrics_port"])
        return None

    def tensorboard_url(self):
        """URL of the REAL TensorBoard subprocess on the chief, when the
        ``tensorboard`` binary was available there (reference
        ``tensorboard_url``, ``TFCluster.py:182-187``); falls back to
        :meth:`metrics_url`'s built-in scalar service otherwise."""
        for n in self.cluster_info:
            if n.get("tb_port"):
                return "http://{}:{}".format(n["host"], n["tb_port"])
        return self.metrics_url()


def run(backend, map_fun, tf_args=None, num_executors=None, num_ps=0,
        input_mode=InputMode.FILES, master_node=None, default_fs="file://",
        reservation_timeout=600, queues=node.DEFAULT_QUEUES,
        tensorboard=False, log_dir=None, driver_ps_nodes=False,
        heartbeat_interval=2.0, heartbeat_miss_budget=5,
        restart_policy=None, checkpoint_dir=None, telemetry_dir=None,
        incident_dir=None, slos=None, elastic=None):
    """Start a cluster on ``backend``'s executors (reference
    ``TFCluster.run``, ``:190-335``).

    ``map_fun(args, ctx)`` is the user's per-node program. ``num_ps`` keeps
    the reference's parameter-server *lifecycle* slot (service nodes the
    driver stops out-of-band); parameter sharding itself is a mesh concern.
    ``tensorboard`` starts the chief-hosted metrics HTTP service over
    ``log_dir`` (the reference's TensorBoard-on-chief, ``TFCluster.py:196``
    + ``TFSparkNode.py:197-221``); its URL is ``cluster.metrics_url()``.

    Every node's compute process heartbeats the driver every
    ``heartbeat_interval`` seconds; after ``heartbeat_miss_budget`` missed
    intervals the node classifies as dead (``cluster.liveness``).

    ``telemetry_dir`` turns on per-node span export from the node
    *runtime* itself (before user code runs, so rendezvous is captured):
    each executor writes ``<telemetry_dir>/node<id>-exec.jsonl``, each
    FEED-mode compute child ``node<id>.jsonl``. The directory must be
    reachable from the executors (shared mount or single host). The
    heartbeat history store is always on (bounded memory;
    ``cluster.history`` and ``cluster.goodput()`` read it).

    ``restart_policy`` (a :class:`~tensorflowonspark_tpu_torch.supervisor
    .RestartPolicy`) returns a :class:`~tensorflowonspark_tpu_torch
    .supervisor.SupervisedCluster`: each ``train``/``inference`` call is
    one supervised job, relaunched on a crashed or hung node from the
    latest committed step under ``checkpoint_dir`` (the supervisor's
    probe; it needs a policy). The node program restores from there
    itself.

    ``elastic`` (True / kwargs dict / :class:`~tensorflowonspark_tpu_torch
    .elastic.ElasticConfig`; FEED mode only, no ps nodes) returns an
    :class:`~tensorflowonspark_tpu_torch.elastic.ElasticCluster`: a dead
    node is *departed* from the membership instead of tearing the job
    down — survivors get a resize directive on their next heartbeat
    (``ctx.poll_resize()``), a replacement is respawned onto the freed
    executor slot, and ``train()`` feeds waves sized to the live
    membership. Composes with ``restart_policy``: the supervisor only
    tears down when membership falls below ``min_nodes``.

    ``incident_dir`` binds an :class:`~tensorflowonspark_tpu_torch
    .incident.IncidentRecorder` to the rendezvous server
    (``cluster.incidents``): straggler flags trigger it, the supervisor
    captures before each teardown, and ``capture_incident`` on demand.
    ``slos`` (specs for :class:`~tensorflowonspark_tpu_torch
    .telemetry_store.SLO`, e.g. ``"serve_ttft_ms_p95 < 250"``) arm the
    burn-rate monitor over the history store; a breach fires the recorder
    when one is armed.
    """
    if restart_policy is None and checkpoint_dir is not None:
        raise ValueError(
            "checkpoint_dir is only consumed by the supervision layer; "
            "pass restart_policy=RestartPolicy(...) with it (plain "
            "clusters checkpoint from the node program instead)"
        )
    if restart_policy is not None:
        from tensorflowonspark_tpu_torch import supervisor as supervisor_mod

        return supervisor_mod.SupervisedCluster(
            backend, map_fun, tf_args,
            restart_policy=restart_policy, checkpoint_dir=checkpoint_dir,
            run_kwargs=dict(
                num_executors=num_executors, num_ps=num_ps,
                input_mode=input_mode, master_node=master_node,
                default_fs=default_fs,
                reservation_timeout=reservation_timeout, queues=queues,
                tensorboard=tensorboard, log_dir=log_dir,
                driver_ps_nodes=driver_ps_nodes,
                heartbeat_interval=heartbeat_interval,
                heartbeat_miss_budget=heartbeat_miss_budget,
                telemetry_dir=telemetry_dir,
                incident_dir=incident_dir, slos=slos, elastic=elastic,
            ),
        )

    elastic_cfg = None
    if elastic:
        from tensorflowonspark_tpu_torch import elastic as elastic_mod

        elastic_cfg = elastic_mod.ElasticConfig.normalize(elastic)
        if input_mode != InputMode.FEED:
            raise ValueError(
                "elastic clusters require InputMode.FEED (FILES-mode "
                "nodes own their shards for the whole job; there is no "
                "wave boundary to reshape at)"
            )
        if num_ps > 0 or driver_ps_nodes:
            raise ValueError(
                "elastic clusters do not support ps/service nodes: a "
                "service node's lifetime is the job, it cannot depart"
            )

    num_executors = num_executors or backend.num_executors
    executors_needed = num_executors - (num_ps if driver_ps_nodes else 0)
    if executors_needed > backend.num_executors:
        raise ValueError(
            "cluster of {} nodes needs {} executors, backend has {}".format(
                num_executors, executors_needed, backend.num_executors
            )
        )

    # Role template (reference TFCluster.py:218-226): ps first, then an
    # optional dedicated master/chief, then workers.
    executors = list(range(num_executors))
    template = {}
    if num_ps > 0:
        template["ps"] = executors[:num_ps]
    rest = executors[num_ps:]
    if master_node:
        template[master_node] = rest[:1]
        template["worker"] = rest[1:]
    else:
        template["worker"] = rest
    if not rest:
        raise ValueError("cluster has no worker nodes")

    # History plane: heartbeat stats are retained in the process-wide
    # store (ensure, not configure: a supervised relaunch must keep ONE
    # store so the goodput curve spans the restart).
    history = telemetry_store.ensure()

    server = reservation.Server(
        num_executors, heartbeat_interval=heartbeat_interval,
        heartbeat_miss_budget=heartbeat_miss_budget,
        elastic=elastic_cfg is not None,
        min_nodes=elastic_cfg.min_nodes if elastic_cfg is not None else 1,
    )
    server_addr = server.start()

    cluster_meta = {
        "id": random.getrandbits(64),
        "cluster_template": template,
        "num_executors": num_executors,
        "default_fs": default_fs,
        "working_dir": os.getcwd(),
        "server_addr": list(server_addr),
        "reservation_timeout": reservation_timeout,
        "tensorboard": bool(tensorboard),
        "log_dir": log_dir,
        "heartbeat_interval": heartbeat_interval,
        "telemetry_dir": telemetry_dir,
    }
    logger.info("starting cluster: template=%s server=%s", template, server_addr)

    runner = node.NodeRunner(
        map_fun, tf_args, cluster_meta,
        background=(input_mode == InputMode.FEED),
        queues=queues,
    )
    status = {"error": None}

    # driver_ps_nodes: service nodes run as threads in THIS process instead
    # of occupying executors (reference TFCluster.py:251-269) — their
    # managers are 'remote' mode, so shutdown reaches them the same way.
    backend_ids = executors
    if driver_ps_nodes and num_ps > 0:
        ps_ids, backend_ids = executors[:num_ps], executors[num_ps:]
        ps_runner = node.NodeRunner(
            map_fun, tf_args, cluster_meta,
            background=(input_mode == InputMode.FEED),
            queues=queues, driver_side=True,
        )

        def run_ps(eid):
            try:
                ps_runner(iter([eid]))
            except Exception as e:  # noqa: BLE001 - must reach the driver
                logger.exception("driver-side ps node %d failed", eid)
                status["error"] = str(e)

        for eid in ps_ids:
            threading.Thread(
                target=run_ps, args=(eid,),
                name="driver-ps-{}".format(eid), daemon=True,
            ).start()

    node_jobs = []
    if elastic_cfg is not None:
        # One single-partition bring-up job PER node slot: the backend
        # fails every job with pending partitions on a dead executor, so
        # batching all slots into one job would couple the survivors'
        # bring-up to the first casualty. Per-slot jobs keep each node's
        # bring-up an independent failure domain (and respawns reuse the
        # same shape).
        for k, eid in enumerate(backend_ids):
            node_jobs.append(backend.foreach_partition(
                [[eid]], runner, block=False,
                assign=lambda idx, s=k % backend.num_executors: s,
            ))

    def launch():
        try:
            if elastic_cfg is not None:
                for job in node_jobs:
                    job.wait(reservation_timeout)
            else:
                backend.foreach_partition(
                    [[i] for i in backend_ids], runner, block=True,
                    assign=lambda idx: idx % backend.num_executors,
                )
        except Exception as e:  # noqa: BLE001 - recorded for the driver
            logger.exception("node launch failed")
            status["error"] = str(e)

    launch_thread = threading.Thread(target=launch, name="node-launch", daemon=True)
    launch_thread.start()

    cluster_info = server.await_reservations(status, timeout=reservation_timeout)

    # Duplicate-node sanity check (reference TFCluster.py:310-322).
    seen = set()
    for meta in cluster_info:
        key = (meta["host"], meta["executor_id"])
        if key in seen:
            raise RuntimeError(
                "duplicate node {} in cluster; this usually means an executor "
                "was retried while its prior manager was still alive".format(key)
            )
        seen.add(key)

    logger.info("cluster of %d node(s) ready", len(cluster_info))
    executor_map = {
        eid: k % backend.num_executors for k, eid in enumerate(backend_ids)
    }
    if elastic_cfg is None:
        cluster_obj = Cluster(
            backend, cluster_info, cluster_meta, server, input_mode,
            node_job=None if input_mode == InputMode.FEED
            else _JobProxy(launch_thread),
            status=status, queues=queues, executor_map=executor_map,
        )
    else:
        cluster_obj = elastic_mod.ElasticCluster(
            backend, cluster_info, cluster_meta, server, input_mode,
            node_job=None, status=status, queues=queues,
            executor_map=executor_map, runner=runner, node_jobs=node_jobs,
            elastic_config=elastic_cfg,
        )
    if incident_dir:
        from tensorflowonspark_tpu_torch import incident as incident_mod

        cluster_obj.incidents = incident_mod.IncidentRecorder(
            incident_dir, server=server, cluster_info=cluster_info,
            telemetry_dir=telemetry_dir,
        )
        # Straggler flags auto-capture (async: trigger() spawns its own
        # thread — the flag fires under the liveness lock).
        server.liveness.incident_cb = cluster_obj.incidents.trigger
    if slos:
        # Burn-rate SLO monitoring over the history store; breaches
        # trigger the incident recorder when one is armed, so every SLO
        # breach gets a black-box bundle.
        history.set_slos(slos, recorder=cluster_obj.incidents)
    if elastic_cfg is not None:
        # Controller starts LAST: a death during the wiring above must
        # not race the incident recorder it is supposed to trigger.
        cluster_obj.controller = elastic_mod.ElasticController(
            cluster_obj, elastic_cfg)
        cluster_obj.controller.start()
    return cluster_obj


class _JobProxy:
    """Adapts the launch thread to the Job.wait interface for FILES mode
    (where node tasks run user fns inline and finish at training end)."""

    def __init__(self, thread):
        self._thread = thread

    def wait(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("node job did not finish")
