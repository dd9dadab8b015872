"""Elastic cluster membership: reshape-on-failure without teardown (the
port of the JAX package's ``elastic.py``).

The supervision layer (:mod:`~tensorflowonspark_tpu_torch.supervisor`)
recovers from a dead node by tearing the *whole* cluster down and
relaunching at the same world size — correct, but each recovery pays a
full rendezvous plus a fresh model build (and kernel load) on every node,
and it needs every original executor back. On preemptible/spot fleets the
common case is gentler: one node leaves, the rest are fine.

This module handles that case in place:

* :class:`ElasticController` — a driver-side thread that watches the
  reservation server's :class:`~tensorflowonspark_tpu_torch.reservation
  .LivenessMonitor`. On a dead node it *departs* the node from the
  membership (``Server.depart`` publishes a resize directive that reaches
  every survivor on its next heartbeat reply), retires the node's manager
  (state → ``stopped``, error queue drained, compute child reaped), and —
  when ``rejoin`` is on — resubmits the node bring-up to the freed executor
  slot so a replacement re-registers and the cluster re-expands at the
  next barrier. Only when membership would fall below ``min_nodes`` does it
  *escalate*, handing the failure back to the supervisor's teardown path.
* :class:`ElasticCluster` — a :class:`~tensorflowonspark_tpu_torch.cluster
  .Cluster` whose ``train()`` feeds data in *waves* sized to the live
  membership: each wave re-reads the reservation list (a rejoined node's
  fresh manager address included), submits one single-partition job per
  live worker, and re-queues partitions whose feed failed mid-wave on a
  dying node. Training continues degraded instead of aborting.

Node programs observe resizes through
:meth:`~tensorflowonspark_tpu_torch.node.NodeContext.poll_resize`: a
directive is a resize barrier (roll back to the last committed step,
continue at the directive's world size). A node program that joined a
``torch.distributed`` group must rebuild the group at the barrier; the
drills' node programs train independent single-device replicas.

Enable with ``cluster.run(..., input_mode=InputMode.FEED, elastic=True)``
(or ``elastic=ElasticConfig(...)`` / a kwargs dict).
"""

import collections
import logging
import threading
import time

from tensorflowonspark_tpu_torch import cluster as cluster_mod
from tensorflowonspark_tpu_torch import manager, node, telemetry

logger = logging.getLogger(__name__)

# A partition whose feed job failed (its node died mid-wave) is re-queued
# at most this many times before it is dropped with a warning.
MAX_PARTITION_RETRIES = 3


class ElasticConfig:
    """Knobs for elastic membership.

    * ``min_nodes`` — smallest membership the cluster may shrink to; one
      more departure *escalates* to the supervisor's teardown/relaunch.
    * ``rejoin`` — respawn a replacement node onto the freed executor
      slot after each departure (off = shrink-only).
    * ``rejoin_delay`` — seconds between retiring the dead node and
      resubmitting the bring-up (lets the executor finish failing feed
      tasks and the old manager get replaced cleanly).
    * ``poll`` — controller liveness poll interval.
    * ``retire_grace`` — budget for reaping the dead node's compute child.
    """

    def __init__(self, min_nodes=1, rejoin=True, rejoin_delay=1.0,
                 poll=0.25, retire_grace=5.0):
        self.min_nodes = max(1, int(min_nodes))
        self.rejoin = bool(rejoin)
        self.rejoin_delay = float(rejoin_delay)
        self.poll = float(poll)
        self.retire_grace = float(retire_grace)

    @classmethod
    def normalize(cls, value):
        """Accept ``True`` / dict / ElasticConfig; None/False → None."""
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(
            "elastic= expects True, a dict, or ElasticConfig; got {!r}"
            .format(type(value).__name__)
        )


class ElasticController(threading.Thread):
    """Driver-side membership reconciler (see module doc)."""

    def __init__(self, cluster, config):
        super().__init__(name="elastic-controller", daemon=True)
        self.cluster = cluster
        self.config = config
        # True once membership fell below min_nodes: the controller stands
        # down and the supervisor's _LivenessWatcher owns the failure.
        self.escalated = False
        self.replacements = 0
        self.tracebacks = []  # drained from retired nodes' error queues
        # Executors departed on purpose (retire_replica): their silence
        # is policy, not failure — the supervisor's liveness watcher must
        # not relaunch the world over them.
        self.scaled_down = set()
        self._halt = threading.Event()

    def run(self):
        while not self._halt.wait(self.config.poll):
            if self.escalated:
                return
            try:
                for eid in self.cluster.server.liveness.dead():
                    self._handle_death(eid)
                    if self.escalated:
                        return
            except Exception:  # pragma: no cover - must keep reconciling
                logger.exception("elastic controller poll failed")

    def stop(self):
        self._halt.set()

    # -- death handling ------------------------------------------------------

    def _handle_death(self, eid):
        if eid in self.scaled_down:
            # Departed on purpose (retire_replica); its liveness silence
            # is not a failure.
            return
        server = self.cluster.server
        status = server.liveness.classify(eid)
        members = server.reservations.get()
        member_ids = {m.get("executor_id") for m in members
                      if isinstance(m, dict)}
        if eid not in member_ids:
            # Raced with a concurrent departure; the liveness record is
            # already gone or about to be.
            return
        if len(member_ids) - 1 < self.config.min_nodes:
            # Shrinking further would leave too few nodes to make
            # progress: leave the dead node in the liveness ledger so the
            # supervisor's watcher sees it and runs the full teardown.
            self.escalated = True
            logger.error(
                "elastic membership would drop below min_nodes=%d on "
                "executor %d (%s); escalating to supervised teardown",
                self.config.min_nodes, eid, status,
            )
            telemetry.event("cluster/escalate", executor_id=eid,
                            status=status, min_nodes=self.config.min_nodes)
            return
        # Evidence BEFORE retiring: the reap below kills the compute child
        # whose flight ring the capture wants.
        try:
            self.cluster.capture_incident(
                "elastic_departure", executor_id=eid, status=status)
        except Exception:  # pragma: no cover - capture must never block us
            logger.warning("incident capture failed", exc_info=True)
        meta = server.depart(eid, reason=status)
        if meta is None:
            return
        self._retire(meta)
        if self.config.rejoin and not self._halt.is_set():
            threading.Thread(
                target=self._respawn, args=(eid,),
                name="elastic-respawn-{}".format(eid), daemon=True,
            ).start()

    def _retire(self, meta):
        """Best-effort cleanup of the departed node: drain its remote
        tracebacks, flip its manager to ``stopped`` (unblocks any feeder
        mid-put AND lets the replacement bring-up pass the stale-manager
        probe — a SIGTERM'd child leaves the state ``running`` otherwise),
        push end-of-feed sentinels, and SIGKILL the compute child, waiting
        for it to exit (its CUDA context is freed only then)."""
        eid = meta.get("executor_id")
        try:
            mgr = manager.connect(
                tuple(meta["addr"]), bytes.fromhex(meta["authkey"])
            )
        except Exception:
            mgr = None  # manager died with its executor: nothing to flip
        if mgr is not None:
            try:
                err_q = mgr.get_queue("error")
                while True:
                    tb = err_q.get(block=False)
                    err_q.task_done()
                    self.tracebacks.append(tb)
            except Exception:
                pass
            try:
                mgr.set("state", "stopped")
            except Exception:
                pass
            for qname in ("input", "control"):
                try:
                    mgr.get_queue(qname).put(None, block=True, timeout=1.0)
                except Exception:
                    pass
        try:
            self.cluster.backend.foreach_partition(
                [[0]], node.ReapComputeTask([meta],
                                            grace=self.config.retire_grace),
                block=True, timeout=self.config.retire_grace + 10.0,
                assign=lambda idx: self.cluster._backend_slot(eid),
            )
        except Exception:
            logger.warning("compute-child reap for retired executor %s "
                           "failed", eid, exc_info=True)
        telemetry.event("cluster/retire", executor_id=eid)

    # -- policy directives ----------------------------------------------------

    def retire_replica(self, eid, reason="scale_down"):
        """Depart executor ``eid`` as a POLICY decision (a scale-down after
        its engine drained): membership shrinks through
        the same epoched ``Server.depart`` → resize-directive path a
        failure takes, but nothing is escalated, no failure is counted,
        and the supervisor's watcher is told (via ``scaled_down``) to
        leave the silence alone. Returns the departed meta, or None if
        the executor was not a member."""
        server = self.cluster.server
        self.scaled_down.add(eid)
        meta = server.depart(eid, reason=reason)
        if meta is None:
            self.scaled_down.discard(eid)
            return None
        telemetry.event("cluster/scale_retire", executor_id=eid,
                        reason=reason)
        self._retire(meta)
        return meta

    def spawn_replica(self, eid):
        """Bring up a replica on executor slot ``eid`` NOW (a scale-up): the respawn path without the failure
        delay — the node re-registers and the membership epoch bumps on
        its join. Returns the submitted bring-up job, or None."""
        self.scaled_down.discard(eid)
        try:
            job = self.cluster.backend.foreach_partition(
                [[eid]], self.cluster._runner, block=False,
                assign=lambda idx: self.cluster._backend_slot(eid),
            )
        except Exception:
            logger.exception("replica spawn on executor %d failed", eid)
            return None
        self.cluster._node_jobs.append(job)
        telemetry.event("cluster/scale_spawn", executor_id=eid)
        return job

    def _respawn(self, eid):
        time.sleep(self.config.rejoin_delay)
        if self._halt.is_set() or self.escalated:
            return
        try:
            job = self.cluster.backend.foreach_partition(
                [[eid]], self.cluster._runner, block=False,
                assign=lambda idx: self.cluster._backend_slot(eid),
            )
        except Exception:
            logger.exception("elastic respawn of executor %d failed", eid)
            return
        self.cluster._node_jobs.append(job)
        self.replacements += 1
        logger.info("elastic respawn submitted for executor %d", eid)
        telemetry.event("cluster/respawn", executor_id=eid,
                        replacements=self.replacements)


class ElasticCluster(cluster_mod.Cluster):
    """A :class:`~tensorflowonspark_tpu_torch.cluster.Cluster` that survives
    membership changes (see module doc). Construct via
    ``cluster.run(..., elastic=...)``."""

    def __init__(self, backend, cluster_info, cluster_meta, server,
                 input_mode, node_job, status, queues, executor_map=None,
                 runner=None, node_jobs=None, elastic_config=None):
        super().__init__(backend, cluster_info, cluster_meta, server,
                         input_mode, node_job, status, queues,
                         executor_map=executor_map)
        self._runner = runner
        self._node_jobs = list(node_jobs or [])
        self.elastic_config = elastic_config or ElasticConfig()
        self.controller = None  # set by cluster.run() after incident wiring

    # -- membership ----------------------------------------------------------

    def live_info(self):
        """The CURRENT reservation list — unlike ``cluster_info`` (the
        initial rendezvous snapshot) this reflects departures and carries
        a rejoined node's fresh manager address/authkey."""
        return self.server.reservations.get()

    def _live_workers(self):
        """(current info, sorted executor ids of feedable live workers)."""
        info = self.live_info()
        workers = []
        for meta in info:
            if not isinstance(meta, dict) or meta.get("job_name") == "ps":
                continue
            eid = meta.get("executor_id")
            if self.server.liveness.classify(eid) in (
                    "starting", "alive", "slow"):
                workers.append(eid)
        return info, sorted(workers)

    def membership(self):
        """Server-side membership gauges (epoch, world size, counters)."""
        return self.server.membership()

    # -- data movement -------------------------------------------------------

    def train(self, dataset, num_epochs=1, qname="input", timeout=None):
        """Feed ``dataset`` in waves sized to the live membership.

        Each wave targets the workers currently alive — one
        single-partition job per worker, so a node dying mid-wave fails
        only its own partition, which is re-queued (up to
        ``MAX_PARTITION_RETRIES`` times) onto a survivor in a later wave.
        The feeder is rebuilt per wave from the live reservation list, so
        a rejoined node is fed through its NEW manager.
        """
        assert self.input_mode == cluster_mod.InputMode.FEED, \
            "train() requires InputMode.FEED"
        if num_epochs > 1:
            dataset = dataset.repeat(num_epochs)
        pending = collections.deque(
            (list(part), 0) for part in dataset
        )
        logger.info("elastically feeding %d partition(s)", len(pending))
        dropped = 0
        while pending:
            if self.controller is not None and self.controller.escalated:
                raise RuntimeError(
                    "elastic cluster fell below min_nodes={}; supervised "
                    "teardown takes over".format(
                        self.elastic_config.min_nodes)
                )
            if self._status.get("error"):
                raise RuntimeError(
                    "cluster failed:\n{}".format(self._status["error"])
                )
            info, workers = self._live_workers()
            if not workers:
                time.sleep(self.elastic_config.poll)
                continue
            feeder = node.TrainFeeder(info, self.cluster_meta, qname)
            wave = [pending.popleft()
                    for _ in range(min(len(workers), len(pending)))]
            jobs = []
            for k, (part, tries) in enumerate(wave):
                slot = self._backend_slot(workers[k])
                job = self.backend.foreach_partition(
                    [part], feeder, block=False,
                    assign=lambda idx, s=slot: s,
                )
                jobs.append((job, part, tries, workers[k]))
            for job, part, tries, eid in jobs:
                try:
                    job.wait(timeout)
                except Exception as e:
                    if tries + 1 >= MAX_PARTITION_RETRIES:
                        dropped += 1
                        logger.warning(
                            "partition dropped after %d failed feed "
                            "attempt(s) (last on executor %d): %s",
                            tries + 1, eid, e,
                        )
                    else:
                        logger.info(
                            "re-queueing partition after feed failure on "
                            "executor %d: %s", eid, e,
                        )
                        pending.append((part, tries + 1))
        if dropped:
            logger.warning("elastic feed finished degraded: %d "
                           "partition(s) dropped", dropped)

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self, timeout=600):
        """Graceful teardown against the LIVE membership: sentinels go to
        the nodes that exist now (a departed node's queues are gone; a
        rejoined node's manager is new), then every bring-up job —
        initial and respawned — is waited."""
        if self.controller is not None:
            self.controller.stop()
            self.controller.join(2.0)
        info = self.live_info()
        workers = [m for m in info if m.get("job_name") != "ps"]
        try:
            if self.input_mode == cluster_mod.InputMode.FEED and workers:
                task = node.ShutdownTask(info)
                self.backend.foreach_partition(
                    [[0]] * len(workers), task, block=True, timeout=timeout,
                    assign=lambda idx: self._backend_slot(
                        workers[idx]["executor_id"]
                    ),
                )
            for job in self._node_jobs:
                try:
                    job.wait(timeout)
                except Exception:
                    # A departed incarnation's bring-up job may have
                    # failed with it; its replacement carried on.
                    logger.warning("node bring-up job ended with error",
                                   exc_info=True)
        except TimeoutError as e:
            self.server.stop()
            raise TimeoutError(
                "elastic cluster shutdown timed out after {}s ({}); "
                "outstanding nodes: {}".format(
                    timeout, e, self.describe_outstanding()
                )
            ) from e
        self.server.stop()
        if self._status.get("error"):
            raise RuntimeError(
                "cluster failed:\n{}".format(self._status["error"])
            )
