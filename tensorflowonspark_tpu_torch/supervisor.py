"""Job supervision: heartbeat-driven failure detection + bounded
relaunch-from-checkpoint (the port of the JAX package's ``supervisor.py``).

The reference was fail-fast by design: a crashed worker surfaced its
traceback through the error queue, the job aborted, and recovery meant an
*operator* relaunching so ``MonitoredTrainingSession`` could restore the
last checkpoint (SURVEY.md §5.3/§5.4, ``TFSparkNode.py:312-319``). This
module makes that loop a framework capability:

* the reservation server's :class:`~tensorflowonspark_tpu_torch
  .reservation.LivenessMonitor` classifies each node from its heartbeats — *crashed*
  (error state reported, traceback on the error queue), *hung* (beats
  stopped, no error), *slow* (late but alive, no action);
* :class:`JobSupervisor` runs a job attempt, watches liveness in the
  background, and on a dead node tears the cluster down (unblocking
  feeders, and SIGKILLs every compute child, a survivor blocked in a
  collective with a dead peer included, waiting for each to exit so that
  its card memory is free), waits out an exponential backoff with
  jitter, relaunches, and lets the node program resume from
  ``CheckpointManager``'s latest *committed* step;
* :class:`RestartPolicy` bounds the loop: at most ``max_restarts``
  relaunches inside the failure ``window``, and a job that keeps dying at
  the same committed step is classified permanent early — the original
  remote traceback is raised, not swallowed.

``cluster.run(..., restart_policy=RestartPolicy(...))`` returns a
:class:`SupervisedCluster` wrapping all of this behind the familiar
``train``/``inference``/``shutdown`` surface. Deterministic fault
injection for all of it lives in :mod:`tensorflowonspark_tpu_torch
.testing.faults`; the end-to-end matrix is
``tests/test_torch_supervisor.py``.

A relaunch is a new cluster: every node reserves a fresh port at
bring-up and registers it with the new rendezvous server, so the
``torch.distributed`` store never rebinds the dead attempt's port (which
may sit in TIME_WAIT). With ``incident_dir`` each attempt's cluster
writes an incident bundle before its teardown (``node_hung``,
``node_death`` or ``attempt_failure``).
"""

import logging
import threading
import time
import traceback as traceback_mod

from tensorflowonspark_tpu_torch import telemetry, telemetry_store, util

logger = logging.getLogger(__name__)


class PermanentFailure(RuntimeError):
    """A supervised job that restarts cannot fix: the restart budget is
    exhausted, or the same committed step keeps crashing. Carries the
    :class:`FailureRecord` history (``.failures``); the message embeds the
    last remote traceback."""

    def __init__(self, message, failures=()):
        super().__init__(message)
        self.failures = list(failures)


class FailureRecord:
    """One failed supervised attempt."""

    __slots__ = ("attempt", "kind", "committed_step", "error", "when")

    def __init__(self, attempt, kind, committed_step, error, when=None):
        self.attempt = attempt
        self.kind = kind  # "crashed" | "hung" | "failed"
        self.committed_step = committed_step
        self.error = error
        self.when = time.monotonic() if when is None else when

    def to_dict(self):
        return {
            "attempt": self.attempt,
            "kind": self.kind,
            "committed_step": self.committed_step,
            "error": self.error,
        }

    def __repr__(self):
        return "FailureRecord(attempt={}, kind={!r}, committed_step={})".format(
            self.attempt, self.kind, self.committed_step
        )


class RestartPolicy:
    """Bounds and paces a supervised job's relaunch loop.

    * ``max_restarts`` — relaunches allowed within ``window`` (None =
      forever) before the failure is permanent.
    * ``backoff``/``backoff_cap`` — delay before restart *i* is
      ``min(backoff * 2**i, backoff_cap)`` seconds...
    * ``jitter`` — ...scaled by ``1 ± jitter`` so a fleet of supervisors
      never relaunches in lockstep.
    * ``window`` — seconds over which failures count against the budget;
      older failures age out (a job that fails once a day under
      ``window=3600`` restarts forever, as it should).
    * ``same_step_limit`` — a *crash* recurring at the same committed
      step this many times is permanent even with budget left: restarting
      cannot fix a deterministic bug, and looping would retrain the same
      step until the window saved us. None disables the early exit.
    """

    def __init__(self, max_restarts=2, backoff=1.0, backoff_cap=30.0,
                 jitter=0.25, window=None, same_step_limit=None):
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.jitter = float(jitter)
        self.window = None if window is None else float(window)
        self.same_step_limit = (
            None if same_step_limit is None else int(same_step_limit)
        )

    def delay(self, restart_index):
        """Seconds to wait before restart ``restart_index`` (0-based)."""
        return util.backoff_delay(
            restart_index, self.backoff, self.backoff_cap, self.jitter
        )

    def relevant(self, failures, now=None):
        """The failures still inside the counting window."""
        if self.window is None:
            return list(failures)
        now = time.monotonic() if now is None else now
        return [f for f in failures if now - f.when <= self.window]

    def exhausted(self, failures, now=None):
        """True when the next relaunch would exceed ``max_restarts``."""
        return len(self.relevant(failures, now)) > self.max_restarts

    def stuck_step(self, failures):
        """The committed step the job is deterministically dying at, or
        None. Only consecutive *crashes* pinned to one known step count —
        hangs and unknown steps never trigger the early permanent exit."""
        if self.same_step_limit is None:
            return None
        run = 0
        step = None
        for f in reversed(failures):
            if f.kind != "crashed" or f.committed_step is None:
                break
            if step is None:
                step = f.committed_step
            elif f.committed_step != step:
                break
            run += 1
        if step is not None and run >= self.same_step_limit:
            return step
        return None


def _capture_incident(cluster, reason, **attrs):
    """Evidence before a teardown destroys it: the cluster's incident
    capture (``Cluster.capture_incident``, a no-op without
    ``incident_dir``); never raises — the supervisor's failure handling
    must not depend on evidence collection."""
    try:
        return cluster.capture_incident(reason, **attrs)
    except Exception:  # a full disk, say
        logger.warning("incident capture (%s) failed", reason, exc_info=True)
        return None


def _unplanned_deaths(cluster):
    """The liveness ledger's dead nodes, less those an elastic controller
    retired on purpose (``retire_replica``: silent by policy, never
    teardown material, even after an escalation)."""
    dead = cluster.server.liveness.dead()
    controller = getattr(cluster, "controller", None)
    if controller is not None:
        dead = [d for d in dead
                if d not in getattr(controller, "scaled_down", ())]
    return dead


def _death_reason(snapshot, dead):
    statuses = {snapshot.get(d, {}).get("status") for d in dead}
    return "node_hung" if "hung" in statuses else "node_death"


def _failure_cause(cluster):
    """``(reason, nodes)`` for a capture on the attempt's failure path.

    The attempt's exception and the liveness watcher see one death on two
    threads, and either may see it first. What the bundle says must not
    depend on which did: a node the liveness ledger holds dead, or one
    whose manager KV holds the crash snapshot its program published while
    raising (before its error reached a queue or a beat), makes the
    capture ``node_death`` (``node_hung``) naming those nodes, as the
    watcher's would. ``attempt_failure`` names no node: a feeder or
    shutdown error with every node alive."""
    try:
        dead = _unplanned_deaths(cluster)
        if dead:
            return (_death_reason(cluster.server.liveness.snapshot(), dead),
                    [str(d) for d in dead])
        recorder = getattr(cluster, "incidents", None)
        crashed = sorted(recorder.crashed()) if recorder is not None else []
    except Exception:  # a torn-down server: the evidence still gets written
        logger.warning("failure cause unreadable", exc_info=True)
        return "attempt_failure", []
    if crashed:
        return "node_death", crashed
    return "attempt_failure", []


def _teardown(cluster, grace=5.0):
    """Best-effort fast teardown of a failed cluster.

    Collects any remote tracebacks first (they are about to become
    unreachable), then flips every node's manager state to ``stopped`` —
    which unblocks feeders (``node._put_checked`` / the join monitor) and
    skips still-queued feed tasks — pushes end-of-feed sentinels for
    healthy consumers, SIGKILLs the compute children through the backend
    and waits for each to exit (a wedged process that woke after the
    relaunch would double-write the new job's checkpoint tree, and a dying
    one holds its CUDA context until it has exited; ``grace`` bounds how
    long each reap waits), and stops the rendezvous server. Every worker's
    child is killed, the survivors' too: a rank whose peer died blocks in
    its collective, which nothing interrupts short of the process group's
    timeout. Never raises. Returns the collected tracebacks.
    """
    from tensorflowonspark_tpu_torch import manager as manager_mod
    from tensorflowonspark_tpu_torch import node as node_mod

    with telemetry.span("supervise/teardown", grace=grace):
        return _teardown_inner(cluster, grace, manager_mod, node_mod)


def _teardown_inner(cluster, grace, manager_mod, node_mod):
    controller = getattr(cluster, "controller", None)
    if controller is not None:
        # Elastic controller must stand down first: a respawn submitted
        # mid-teardown would bring a node up into a cluster being killed.
        controller.stop()
    tracebacks = []
    for meta in cluster.cluster_info:
        try:
            mgr = manager_mod.connect(
                tuple(meta["addr"]), bytes.fromhex(meta["authkey"])
            )
        except Exception:
            continue  # manager died with its executor
        try:
            err_q = mgr.get_queue("error")
            while True:
                tb = err_q.get(block=False)
                err_q.task_done()
                tracebacks.append(tb)
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
    workers = [m for m in cluster.cluster_info if m["job_name"] != "ps"]
    if workers:
        try:
            cluster.backend.foreach_partition(
                [[0]] * len(workers),
                node_mod.ReapComputeTask(cluster.cluster_info, grace=grace),
                block=True, timeout=grace + 10.0,
                assign=lambda idx: cluster._backend_slot(
                    workers[idx]["executor_id"]
                ),
            )
        except Exception:
            logger.warning("compute-child reap during teardown failed",
                           exc_info=True)
    try:
        cluster.server.stop()
    except Exception:  # pragma: no cover - listener already closed
        pass
    return tracebacks


class _LivenessWatcher(threading.Thread):
    """Polls the cluster's LivenessMonitor during a job attempt; on the
    first dead node it snapshots the evidence and tears the cluster down
    so blocked feeders return and the attempt can fail fast."""

    def __init__(self, cluster, poll=0.25, grace=5.0):
        super().__init__(name="liveness-watcher", daemon=True)
        self.cluster = cluster
        self.poll = poll
        self.grace = grace
        self.dead = None          # liveness snapshot at detection time
        self.tracebacks = []      # remote tracebacks drained at teardown
        # NOT named _stop: threading.Thread has a private _stop METHOD the
        # interpreter calls after join() — shadowing it with an Event
        # breaks Thread internals.
        self._halt = threading.Event()

    def run(self):
        while not self._halt.wait(self.poll):
            dead = _unplanned_deaths(self.cluster)
            if dead:
                controller = getattr(self.cluster, "controller", None)
                if controller is not None and not controller.escalated:
                    # Elastic cluster: the ElasticController owns node
                    # departures (retire + reshape + respawn, no
                    # teardown). The watcher takes over only when the
                    # controller escalates — membership fell below
                    # min_nodes — and leaves the dead node in the ledger
                    # for this branch to see.
                    continue
                self.dead = self.cluster.server.liveness.snapshot()
                logger.error(
                    "liveness failure on node(s) %s: %s", dead,
                    self.cluster.server.liveness.describe(dead),
                )
                # Black box BEFORE teardown: the teardown flips states,
                # reaps compute children and stops the server — every
                # ring, stack and KV crash snapshot the capture needs is
                # about to be destroyed. Synchronous on purpose.
                _capture_incident(self.cluster,
                                  _death_reason(self.dead, dead),
                                  nodes=",".join(str(d) for d in dead))
                self.tracebacks = _teardown(self.cluster, self.grace)
                return

    def stop(self):
        self._halt.set()


class JobSupervisor:
    """Launch → monitor → relaunch loop around :func:`cluster.run`.

    ``backend`` is either a live backend (relaunches reuse its executors)
    or a zero-argument callable producing a fresh backend per attempt
    (each attempt then owns — and stops — its backend; the right shape
    when a failure may poison executor state). ``run_kwargs`` are
    forwarded to ``cluster.run`` verbatim. ``checkpoint_dir`` enables the
    committed-step probe that feeds the same-step permanent-failure
    classification and the failure records.
    """

    def __init__(self, backend, map_fun, tf_args=None, restart_policy=None,
                 checkpoint_dir=None, monitor_poll=0.25, teardown_grace=5.0,
                 run_kwargs=None):
        self._backend = backend
        self.map_fun = map_fun
        self.tf_args = tf_args
        self.policy = restart_policy or RestartPolicy()
        self.monitor_poll = monitor_poll
        self.teardown_grace = teardown_grace
        self.run_kwargs = dict(run_kwargs or {})
        self.run_kwargs.pop("restart_policy", None)  # never recurse
        # checkpoint_dir is the supervisor's probe, not an inner-cluster
        # argument (cluster.run rejects it without a policy).
        self.checkpoint_dir = (
            checkpoint_dir if checkpoint_dir is not None
            else self.run_kwargs.pop("checkpoint_dir", None)
        )
        self.run_kwargs.pop("checkpoint_dir", None)
        self.attempts = 0
        self.failures = []
        # Elastic membership gauges from the last successful attempt
        # (epoch, world size, departures/rejoins/replacements) — the
        # drill's proof that recovery happened IN PLACE (restarts == 0).
        self.last_membership = None

    # -- public surface -----------------------------------------------------

    @property
    def restarts(self):
        return max(0, self.attempts - 1)

    def report(self):
        out = {
            "attempts": self.attempts,
            "restarts": self.restarts,
            "failures": [f.to_dict() for f in self.failures],
            "committed_step": self._committed_step(),
        }
        if self.last_membership is not None:
            out["membership"] = self.last_membership
        return out

    def run(self, job, shutdown_timeout=600):
        """Run ``job(cluster)`` under supervision; returns its result.

        ``job`` must be re-callable: a relaunch invokes it again against
        the fresh cluster (feed it re-iterable datasets, not generators).
        Training already done is not repeated — the node program resumes
        from the latest committed checkpoint; the supervisor only re-feeds
        data. Raises :class:`PermanentFailure` when the policy gives up.
        """
        while True:
            self.attempts += 1
            ok, result, failure = self._attempt(job, shutdown_timeout)
            if ok:
                return result
            self.failures.append(failure)
            logger.warning(
                "supervised attempt %d failed (%s, committed step %s)",
                failure.attempt, failure.kind, failure.committed_step,
            )
            telemetry.event(
                "supervise/failure", attempt=failure.attempt,
                kind=failure.kind, committed_step=failure.committed_step,
            )
            # Goodput accounting: wall time from here until the
            # relaunched cluster is rendezvoused is restart downtime
            # (telemetry_store classifies the post-relaunch heartbeat
            # interval against this window — the dip on the curve).
            telemetry_store.downtime_start("restart")
            # Restart history for /statusz (error trimmed to the
            # traceback's LAST line — the exception message; the full
            # tracebacks live in the records).
            telemetry.put_status("restart_history", [
                {"attempt": f.attempt, "kind": f.kind,
                 "committed_step": f.committed_step,
                 "error": ((f.error or "").strip().splitlines() or [""])[-1]}
                for f in self.failures
            ])
            stuck = self.policy.stuck_step(self.failures)
            if stuck is not None:
                telemetry.event("supervise/permanent_failure",
                                reason="stuck_step", step=stuck)
                raise PermanentFailure(
                    "job is permanently failing: step {} crashed {} "
                    "consecutive time(s); remote traceback:\n{}".format(
                        stuck, self.policy.same_step_limit, failure.error
                    ),
                    self.failures,
                )
            if self.policy.exhausted(self.failures):
                telemetry.event("supervise/permanent_failure",
                                reason="budget_exhausted",
                                restarts=self.policy.max_restarts)
                raise PermanentFailure(
                    "restart budget exhausted ({} restart(s) allowed, {} "
                    "failure(s) in window); last failure was {} — remote "
                    "traceback:\n{}".format(
                        self.policy.max_restarts,
                        len(self.policy.relevant(self.failures)),
                        failure.kind, failure.error,
                    ),
                    self.failures,
                )
            delay = self.policy.delay(len(self.failures) - 1)
            logger.info(
                "relaunching from committed step %s in %.2fs (restart %d/%d)",
                self._committed_step(), delay,
                len(self.failures), self.policy.max_restarts,
            )
            telemetry.event(
                "supervise/relaunch", restart=len(self.failures),
                committed_step=self._committed_step(),
                delay=round(delay, 3),
            )
            time.sleep(delay)

    # -- internals ----------------------------------------------------------

    def _attempt(self, job, shutdown_timeout):
        with telemetry.span("supervise/attempt",
                            attempt=self.attempts) as sp:
            out = self._attempt_inner(job, shutdown_timeout)
            sp.set(ok=bool(out[0]))
            return out

    def _attempt_inner(self, job, shutdown_timeout):
        from tensorflowonspark_tpu_torch import cluster as cluster_mod

        backend, owned = self._backend_for_attempt()
        cluster = None
        watcher = None
        exc_text = None
        try:
            try:
                cluster = cluster_mod.run(
                    backend, self.map_fun, self.tf_args, **self.run_kwargs
                )
                # Cluster is rendezvoused again: close the goodput
                # downtime window opened at the previous failure.
                telemetry_store.downtime_end()
                watcher = _LivenessWatcher(
                    cluster, poll=self.monitor_poll, grace=self.teardown_grace
                )
                watcher.start()
                result = job(cluster)
                watcher.stop()
                watcher.join(self.teardown_grace)
                if watcher.dead is None and not cluster.server.liveness.dead():
                    if getattr(cluster.server, "elastic", False):
                        # Snapshot BEFORE shutdown: success sets cluster
                        # to None below, and the gauges don't change
                        # during teardown.
                        self.last_membership = cluster.server.membership()
                        controller = getattr(cluster, "controller", None)
                        if controller is not None:
                            self.last_membership["replacements"] = \
                                controller.replacements
                    try:
                        cluster.shutdown(timeout=shutdown_timeout)
                        cluster = None  # fully torn down; nothing to clean
                    except TimeoutError:
                        # The job itself completed — a sluggish teardown
                        # must not discard its result and retrain/re-infer
                        # everything; the finally below force-cleans the
                        # stuck cluster instead.
                        logger.warning(
                            "post-job shutdown timed out; keeping the job "
                            "result and force-tearing the cluster down",
                            exc_info=True,
                        )
                    # Any non-timeout shutdown error (e.g. a remote
                    # traceback surfacing during the drain) still falls
                    # through to the outer except: that is a real failure.
                    return True, result, None
            except (ValueError, TypeError, AssertionError):
                if cluster is None:
                    # Launch-phase config error (bad template, invalid
                    # kwargs): deterministic — no relaunch can fix it, so
                    # fail fast instead of burning the restart budget.
                    # Launch *timeouts* and runtime errors stay retriable.
                    raise
                exc_text = traceback_mod.format_exc()
            except Exception:
                exc_text = traceback_mod.format_exc()
        finally:
            if watcher is not None:
                watcher.stop()
                # A detection the watcher has begun ends (its capture and
                # teardown included) before this path decides: one
                # capture per failure.
                watcher.join(self.teardown_grace)
            # The watcher already ran the full teardown (states flipped,
            # tracebacks drained, children reaped) when it detected the
            # failure — a second pass would only burn ~10s re-dialing
            # dead managers per relaunch.
            already_torn = watcher is not None and watcher.dead is not None
            if cluster is not None and not already_torn \
                    and exc_text is not None:
                # A failure the watcher did NOT see first (a node's error
                # reached the feeder before a beat, a feeder exception, a
                # shutdown-path error): same rule — evidence before the
                # teardown below destroys it, under the cause the ledger
                # and the managers show.
                reason, nodes = _failure_cause(cluster)
                attrs = {"attempt": self.attempts}
                if nodes:
                    attrs["nodes"] = ",".join(nodes)
                _capture_incident(cluster, reason, **attrs)
            leftovers = _teardown(cluster, self.teardown_grace) \
                if (cluster is not None and not already_torn) else []
            if owned:
                try:
                    backend.stop()
                except Exception:  # pragma: no cover - best effort
                    logger.warning("backend stop failed", exc_info=True)
        return False, None, self._classify(watcher, exc_text, leftovers)

    def _backend_for_attempt(self):
        if callable(self._backend) and not hasattr(self._backend, "foreach_partition"):
            return self._backend(), True
        return self._backend, False

    def _classify(self, watcher, exc_text, leftover_tracebacks):
        """Fold the evidence (exception, liveness snapshot, drained error
        queues) into one FailureRecord."""
        snapshot = watcher.dead if watcher is not None else None
        tracebacks = list(leftover_tracebacks)
        if watcher is not None:
            tracebacks = watcher.tracebacks + tracebacks
        statuses = set()
        if snapshot:
            statuses = {rec["status"] for rec in snapshot.values()}
        if exc_text is not None or "crashed" in statuses or tracebacks:
            kind = "crashed"
        elif "hung" in statuses:
            kind = "hung"
        else:
            kind = "failed"
        error = exc_text or "\n".join(tracebacks)
        if snapshot:
            detail = "; ".join(
                "executor {}: {}".format(eid, rec["status"])
                for eid, rec in sorted(snapshot.items())
            )
            error = "{}\nliveness at failure: {}".format(
                error or "(no traceback)", detail
            )
        return FailureRecord(
            attempt=self.attempts, kind=kind,
            committed_step=self._committed_step(), error=error,
        )

    def _committed_step(self):
        if not self.checkpoint_dir:
            return None
        try:
            from tensorflowonspark_tpu_torch.train import checkpoint as ckpt_lib

            return ckpt_lib.latest_committed_step(self.checkpoint_dir)
        except Exception:  # pragma: no cover - probe must never kill the loop
            logger.warning("committed-step probe failed", exc_info=True)
            return None


class SupervisedCluster:
    """What ``cluster.run(..., restart_policy=...)`` returns.

    Keeps the familiar ``train``/``inference``/``shutdown`` calling
    pattern, but each ``train``/``inference`` call is one *supervised
    job*: launch, feed, graceful shutdown — with automatic
    relaunch-from-checkpoint in between on failure. There is no
    long-lived inner cluster between calls (each call owns its cluster
    end-to-end, because relaunch must be able to rebuild it);
    ``shutdown()`` is therefore a no-op kept for drop-in compatibility.
    """

    def __init__(self, backend, map_fun, tf_args=None, restart_policy=None,
                 checkpoint_dir=None, run_kwargs=None, shutdown_timeout=600):
        self._backend = backend
        self._map_fun = map_fun
        self._tf_args = tf_args
        self.policy = restart_policy or RestartPolicy()
        self.checkpoint_dir = checkpoint_dir
        self._run_kwargs = dict(run_kwargs or {})
        self._shutdown_timeout = shutdown_timeout
        self.last_supervisor = None

    def _supervise(self, job):
        sup = JobSupervisor(
            self._backend, self._map_fun, self._tf_args,
            restart_policy=self.policy, checkpoint_dir=self.checkpoint_dir,
            run_kwargs=self._run_kwargs,
        )
        self.last_supervisor = sup
        result = sup.run(job, shutdown_timeout=self._shutdown_timeout)
        return result, sup.report()

    def train(self, dataset, num_epochs=1, qname="input", timeout=None):
        """Supervised training feed; returns the supervision report."""
        _, report = self._supervise(
            lambda c: c.train(dataset, num_epochs=num_epochs, qname=qname,
                              timeout=timeout)
        )
        return report

    def inference(self, dataset, qname="input", timeout=None):
        """Supervised inference; returns the per-partition results."""
        results, _ = self._supervise(
            lambda c: c.inference(dataset, qname=qname, timeout=timeout)
        )
        return results

    def report(self):
        """The most recent supervision report (None before any job)."""
        return None if self.last_supervisor is None else \
            self.last_supervisor.report()

    def shutdown(self, timeout=None):
        """No-op (each supervised job shuts its cluster down itself);
        kept so supervised and plain clusters are call-compatible."""
