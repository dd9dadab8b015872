"""Autoscaler plane: SLO burn rates actuate fleet capacity (port of the
JAX package's ``serving/autoscaler.py``).

:class:`Autoscaler` closes the loop between the SLO monitor and a
:class:`~tensorflowonspark_tpu_torch.serving.fleet.ServingFleet`:

* **Signals in** — the
  :class:`~tensorflowonspark_tpu_torch.telemetry_store.SLOMonitor`'s policy
  callback delivers the multi-window burn state on every evaluation pass
  (the *level*, not just edges), and the fleet's live per-priority queue
  depths give admission pressure before latency degrades (a high-priority
  backlog weighs heavier: those requests preempt, so their queue growth
  predicts p95 damage earliest).
* **Actuation out** — scale-up builds a replica through ``spawn_fn`` and
  registers it with ``fleet.add_engine``. Scale-down picks the least-loaded
  local replica and puts it in **graceful drain**
  (``engine.begin_drain()``: admission closed, residents keep decoding);
  past ``drain_grace_s`` the residents' KV pages migrate to a surviving
  peer (``engine.migrate_requests``), and only once the victim is empty is
  it closed, deregistered and reported through ``retire_fn``. Each
  finished drain's ledger is audited (:attr:`Autoscaler.drain_audits`):
  ``accepted + migrated_in == finished + cancelled + failed +
  migrated_out`` on the victim, with no request failed or cancelled by the
  drain.
* **Policy is telemetry** — every decision is an event
  (``cluster/scale_up``, ``cluster/scale_down``, ``cluster/drain`` from the
  engine, ``cluster/drain_done``) plus ``autoscale_replicas`` /
  ``autoscale_target`` gauges.

Hysteresis is explicit and asymmetric: scale-up obeys a short
``cooldown_up_s`` (react inside the burn window; never flap faster than a
replica can warm), scale-down requires the pressure signals to stay quiet
for ``stable_down_s`` AND a long ``cooldown_down_s`` since the last scale
in either direction. The down trigger does NOT wait for SLO *recovery*: the
slow burn window keeps a breach firing long after the traffic is gone, so
queue and occupancy quiescence (and the fast window alone) is the signal.
``min_replicas`` / ``max_replicas`` bound everything.
"""

import logging
import threading
import time

from tensorflowonspark_tpu_torch import telemetry

logger = logging.getLogger(__name__)


class AutoscalePolicy:
    """The autoscaler's dials, all first-class (and echoed into every
    decision event so the timeline is self-describing).

    * ``metric`` — the SLO metric whose burn state triggers scale-up
      (default the TTFT p95 the serving SLO watches).
    * ``queue_high`` — priority-weighted queued requests per replica
      at which queue pressure alone (no SLO breach yet) scales up.
    * ``busy_load`` — mean per-replica load score above which the
      fleet is "busy" (blocks scale-down); see ``fleet._load_score``:
      < 1.0 means no queue anywhere.
    * ``min_replicas`` / ``max_replicas`` — hard bounds.
    * ``cooldown_up_s`` / ``cooldown_down_s`` — minimum spacing after
      any scale action before the next up / down decision.
    * ``stable_down_s`` — how long pressure must stay quiet before a
      scale-down arms.
    * ``drain_grace_s`` — how long a drained victim may run its
      residents down naturally before they are migrated to a peer.
    """

    def __init__(self, metric="serve_ttft_ms_p95", queue_high=4.0,
                 busy_load=0.75, min_replicas=1, max_replicas=4,
                 cooldown_up_s=15.0, cooldown_down_s=60.0,
                 stable_down_s=30.0, drain_grace_s=5.0,
                 priority_weight=0.5):
        self.metric = str(metric)
        self.queue_high = float(queue_high)
        self.busy_load = float(busy_load)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                "need 1 <= min_replicas <= max_replicas, got {}..{}"
                .format(self.min_replicas, self.max_replicas))
        self.cooldown_up_s = float(cooldown_up_s)
        self.cooldown_down_s = float(cooldown_down_s)
        self.stable_down_s = float(stable_down_s)
        self.drain_grace_s = float(drain_grace_s)
        # Each queued request of priority p counts 1 + weight*p: a
        # high-priority backlog preempts its way into damage faster.
        self.priority_weight = float(priority_weight)

    def to_dict(self):
        return {
            "metric": self.metric, "queue_high": self.queue_high,
            "busy_load": self.busy_load,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "cooldown_up_s": self.cooldown_up_s,
            "cooldown_down_s": self.cooldown_down_s,
            "stable_down_s": self.stable_down_s,
            "drain_grace_s": self.drain_grace_s,
        }


class _Drain:
    """One in-flight graceful drain: the victim client + engine and
    the bookkeeping the zero-drop assertion audits."""

    def __init__(self, client, t_begin):
        self.client = client
        self.engine = client.engine
        self.t_begin = t_begin
        self.migrated = 0
        self.done = False
        self.audit = None
        # The victim's failures and cancellations before the drain: the
        # drain itself must add none.
        self._failed0 = getattr(self.engine, "requests_failed", 0)
        self._cancelled0 = getattr(self.engine, "requests_cancelled", 0)

    def ledger(self, now):
        """The drained victim's ledger: its counters, whether ``accepted +
        migrated_in == finished + cancelled + failed + migrated_out``, and
        whether no request failed or was cancelled while it drained."""
        eng = self.engine
        keys = ("requests_accepted", "migrated_in", "requests_finished",
                "requests_cancelled", "requests_failed", "migrated_out")
        c = {k: int(getattr(eng, k, 0)) for k in keys}
        balanced = (c["requests_accepted"] + c["migrated_in"]
                    == c["requests_finished"] + c["requests_cancelled"]
                    + c["requests_failed"] + c["migrated_out"])
        dropped = (c["requests_failed"] - self._failed0
                   + c["requests_cancelled"] - self._cancelled0)
        return dict(c, replica=self.client.name, migrated=self.migrated,
                    drain_s=now - self.t_begin, balanced=balanced,
                    dropped=dropped, ok=balanced and dropped == 0)


class Autoscaler:
    """Closed-loop replica controller over a
    :class:`~tensorflowonspark_tpu_torch.serving.fleet.ServingFleet`.

    ``spawn_fn(name)`` must return a new started replica — a raw
    :class:`~tensorflowonspark_tpu_torch.serving.engine.ServingEngine` or a
    fleet client — warmed before it is returned, so its first routed
    request does not pay the first calls of each shape.
    ``retire_fn(client)`` (optional) reports a fully-drained replica's
    departure to the membership plane (e.g. the elastic controller, so
    the reservation epoch advances without tearing the world down).

    Wire the SLO side with :meth:`attach`, then either call
    :meth:`step` from your control loop (drills do, for determinism)
    or :meth:`start` a background thread. All decision state is
    guarded by one lock; the SLO callback only stores the latest burn
    level, so the monitor's ingest path never blocks on a spawn.
    """

    def __init__(self, fleet, store, policy=None, spawn_fn=None,
                 retire_fn=None, clock=time.monotonic):
        self.fleet = fleet
        self.store = store
        self.policy = policy or AutoscalePolicy()
        self.spawn_fn = spawn_fn
        self.retire_fn = retire_fn
        self.clock = clock
        self._lock = threading.Lock()
        self._burn = None        # latest policy-callback state dict
        self._quiet_since = None  # when pressure last went quiet
        self._last_scale = None   # (t, direction)
        self._spawned = 0
        self.drains = []          # in-flight _Drain records
        self.drain_audits = []    # one ledger audit per finished drain
        self.scale_ups = 0
        self.scale_downs = 0
        self._thread = None
        self._stop = threading.Event()
        self._publish()

    # -- signals in ----------------------------------------------------------

    def attach(self, monitor):
        """Register on an :class:`SLOMonitor`'s policy-callback hook;
        returns self for chaining."""
        monitor.add_policy_callback(self.on_slo_state)
        return self

    def on_slo_state(self, state):
        """SLO policy callback: keep the latest burn level for the
        autoscaler's metric. Cheap and non-blocking — actual decisions
        happen in :meth:`evaluate` on the control-loop clock."""
        slo = state.get("slo")
        if slo is not None and slo.metric == self.policy.metric:
            with self._lock:
                self._burn = state

    # -- signal reads --------------------------------------------------------

    def replicas(self):
        """Replicas counted against the bounds: registered and NOT
        draining (a draining victim is already spent capacity)."""
        return [c for c in list(self.fleet.engines)
                if not getattr(c, "draining", lambda: False)()]

    def _queue_pressure(self):
        """Priority-weighted queued requests per (non-draining)
        replica: the fleet's live per-priority depths, each class
        weighted ``1 + priority_weight * priority``."""
        try:
            by_prio = self.fleet.stats().get("queued_by_priority") or {}
        except Exception:
            by_prio = {}
        weighted = 0.0
        for prio, depth in by_prio.items():
            try:
                p = max(0, int(prio))
            except (TypeError, ValueError):
                p = 0
            weighted += float(depth) * (
                1.0 + self.policy.priority_weight * p)
        return weighted / max(1, len(self.replicas()))

    def _mean_load(self):
        loads = []
        for c in self.replicas():
            try:
                loads.append(float(c.load()))
            except Exception:
                continue
        return sum(loads) / len(loads) if loads else 0.0

    def _burn_levels(self):
        """``(firing, fast_breaching)`` from the latest burn state: the
        full multi-window firing level (scale-up trigger), and whether
        the SHORTEST window alone still breaches. Scale-down quiescence
        watches only the fast window — the slow window keeps firing for
        ~its whole width after the traffic is gone, and waiting it out
        would strand capacity for minutes (module doc, "Hysteresis")."""
        with self._lock:
            burn = self._burn
        if not burn:
            return False, False
        fast = None
        for w in burn.get("windows") or ():
            if fast is None or w["window_s"] < fast["window_s"]:
                fast = w
        fast_breaching = bool(fast
                              and fast["breach_frac"] >= fast["burn"])
        return bool(burn.get("firing")), fast_breaching

    def _cooldown_ok(self, now, direction):
        if self._last_scale is None:
            return True
        since = now - self._last_scale[0]
        limit = self.policy.cooldown_up_s if direction == "up" \
            else self.policy.cooldown_down_s
        return since >= limit

    # -- decisions -----------------------------------------------------------

    def evaluate(self, now=None):
        """One control-loop pass: decide, actuate, return the decision
        (``"scale_up"`` / ``"scale_down"`` / None)."""
        now = self.clock() if now is None else float(now)
        pressure = self._queue_pressure()
        burn, burn_fast = self._burn_levels()
        load = self._mean_load()
        n = len(self.replicas())
        want_up = burn or pressure >= self.policy.queue_high
        # Quiescence (arms scale-down) is NOT want_up's negation: the
        # slow burn window lingers after the burst, so calm watches the
        # fast window + live queue pressure only (see _burn_levels).
        calm = not burn_fast and pressure < self.policy.queue_high
        if not calm:
            self._quiet_since = None
        elif self._quiet_since is None:
            self._quiet_since = now
        if want_up and n < self.policy.max_replicas \
                and self._cooldown_ok(now, "up"):
            return self._scale_up(now, burn=burn, pressure=pressure,
                                  replicas=n)
        quiet = (calm and load < self.policy.busy_load
                 and self._quiet_since is not None
                 and now - self._quiet_since >= self.policy.stable_down_s)
        if quiet and n > self.policy.min_replicas \
                and not self.drains \
                and self._cooldown_ok(now, "down"):
            return self._scale_down(now, load=load, replicas=n)
        return None

    def _scale_up(self, now, **why):
        if self.spawn_fn is None:
            logger.warning("autoscale: scale-up wanted but no spawn_fn")
            return None
        self._spawned += 1
        name = "auto{}".format(self._spawned)
        telemetry.event("cluster/scale_up", replica=name, **why)
        try:
            engine = self.spawn_fn(name)
        except Exception:
            logger.warning("autoscale: spawn_fn failed", exc_info=True)
            return None
        client = self.fleet.add_engine(engine, name=name)
        self._last_scale = (now, "up")
        self.scale_ups += 1
        self._publish()
        logger.info("autoscale: scaled up to %d replicas (+%s)",
                    len(self.replicas()), client.name)
        return "scale_up"

    def _scale_down(self, now, **why):
        """Pick the least-loaded LOCAL replica and start its graceful
        drain. The victim stays registered (but drain-excluded from
        routing) until empty — removal happens in
        :meth:`poll_drains`."""
        # evaluate() guarantees replicas() > min_replicas >= 1 here, so
        # a local victim always leaves at least one survivor.
        locals_ = [c for c in self.replicas()
                   if not getattr(c, "remote", False)
                   and hasattr(c, "engine")]
        if not locals_:
            return None     # remote retirement needs its own owner
        victim = min(locals_, key=lambda c: c.load())
        telemetry.event("cluster/scale_down", replica=victim.name,
                        **why)
        victim.engine.begin_drain()   # emits cluster/drain
        self.drains.append(_Drain(victim, now))
        self._last_scale = (now, "down")
        self.scale_downs += 1
        self._publish()
        logger.info("autoscale: draining %s (scale down from %d)",
                    victim.name, len(self.replicas()) + 1)
        return "scale_down"

    # -- drain completion ----------------------------------------------------

    def _migration_target(self, drain):
        """Least-loaded surviving local engine, or None."""
        best = None
        for c in self.replicas():
            if getattr(c, "remote", False) or not hasattr(c, "engine"):
                continue
            if c.engine is drain.engine:
                continue
            if best is None or c.load() < best.load():
                best = c
        return best.engine if best is not None else None

    def poll_drains(self, now=None):
        """Advance every in-flight drain: past ``drain_grace_s`` the
        victim's residents are migrated (KV pages extracted host-side
        and restored byte-exact on the survivor); once empty the
        victim is closed, deregistered, and retired. Returns the
        drains finalized on this pass."""
        now = self.clock() if now is None else float(now)
        finished = []
        for drain in list(self.drains):
            eng = drain.engine
            if not eng.is_drained():
                if now - drain.t_begin >= self.policy.drain_grace_s:
                    dest = self._migration_target(drain)
                    if dest is not None:
                        moved = eng.migrate_requests(dest)
                        drain.migrated += len(moved)
                        if moved:
                            # The migrated requests keep their trace
                            # ids (the Request objects move); naming
                            # them here links the drain decision to
                            # each request's own waterfall.
                            telemetry.event(
                                "cluster/drain_migrate",
                                replica=drain.client.name,
                                count=len(moved),
                                traces=[t for t in (
                                    getattr(r, "trace", None)
                                    for r in moved) if t])
                if not eng.is_drained():
                    continue
            drain.done = True
            self.drains.remove(drain)
            self.fleet.remove_engine(drain.client)
            eng.close()
            drain.audit = drain.ledger(now)
            self.drain_audits.append(drain.audit)
            if not drain.audit["ok"]:
                logger.warning("autoscale: drain of %s failed its ledger "
                               "audit: %s", drain.client.name, drain.audit)
            telemetry.event(
                "cluster/drain_done", replica=drain.client.name,
                migrated=drain.migrated,
                finished=eng.requests_finished,
                cancelled=eng.requests_cancelled,
                drain_s=round(now - drain.t_begin, 3))
            if self.retire_fn is not None:
                try:
                    self.retire_fn(drain.client)
                except Exception:
                    logger.warning("autoscale: retire_fn failed",
                                   exc_info=True)
            finished.append(drain)
            self._publish()
            logger.info("autoscale: drain of %s done (%d migrated)",
                        drain.client.name, drain.migrated)
        return finished

    def step(self, now=None):
        """One full pass: decisions + drain progress. Drills call this
        inline for determinism; :meth:`start` loops it."""
        decision = self.evaluate(now=now)
        self.poll_drains(now=now)
        return decision

    # -- lifecycle -----------------------------------------------------------

    def start(self, interval=1.0):
        """Run :meth:`step` on a daemon thread every ``interval`` s."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.step()
                except Exception:
                    logger.warning("autoscale step failed",
                                   exc_info=True)

        self._thread = threading.Thread(
            target=loop, name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _publish(self):
        telemetry.set_gauge("autoscale_replicas",
                            float(len(self.replicas())))
        telemetry.set_gauge("autoscale_draining",
                            float(len(self.drains)))
        telemetry.set_gauge(
            "autoscale_target",
            float(min(self.policy.max_replicas,
                      max(self.policy.min_replicas,
                          len(self.replicas())))))

    def stats(self):
        return {
            "replicas": len(self.replicas()),
            "draining": len(self.drains),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "drain_audits": list(self.drain_audits),
            "policy": self.policy.to_dict(),
        }
