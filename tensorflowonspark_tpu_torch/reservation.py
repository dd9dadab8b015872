"""Cluster rendezvous and stop-signal control plane (the port's copy of
the JAX package's ``reservation.py``; the wire format is the same, frame
for frame, and a straggler flag carries no flame-diff evidence, since the
profiler is ROADMAP A12).

A re-design of the reference's reservation protocol
(``tensorflowonspark/reservation.py``). The *semantics* are
preserved — a driver-hosted TCP server that every node registers with
(``REG``), that clients poll for completeness (``QUERY``) and fetch the full
cluster membership from (``QINFO``), and that carries an out-of-band stop
signal (``STOP``) — because that is exactly the state machine a multi-host
job needs before ``torch.distributed`` can initialise (coordinator
address distribution, host/role/topology assignment).

The *implementation* is new:

* wire frames are length-prefixed **JSON**, not pickle (the reference's
  pickled frames, ``reservation.py:63-92``, execute arbitrary code on
  unpickle — unacceptable on a control port);
* the server runs a thread-per-connection accept loop instead of a manual
  ``select()`` dispatch (``reservation.py:143-186``);
* completeness waits use a ``Condition`` instead of 1 s polling where we
  control both sides (remote clients still poll, as in the reference).
"""

import json
import logging
import socket
import statistics
import struct
import threading
import time
import uuid

from tensorflowonspark_tpu_torch import telemetry, telemetry_store, util

logger = logging.getLogger(__name__)

# Message types — the reference vocabulary (reservation.py:125-141) plus the
# heartbeat extension the supervision layer rides on and the snapshot
# channel the incident-capture layer rides on.
REG = "REG"      # register one node's metadata
QUERY = "QUERY"  # "are all nodes registered?"
QINFO = "QINFO"  # fetch full cluster membership
STOP = "STOP"    # out-of-band stop signal (ends streaming jobs)
HEARTBEAT = "HB"  # periodic node liveness ping (carries manager state)
SNAPSHOT = "SNAP"  # node -> driver black-box dump (incident capture)

_HEADER = struct.Struct(">I")
_MAX_FRAME = 64 * 1024 * 1024


class Reservations:
    """Thread-safe registry of node reservations with a required count.

    Reference ``reservation.py:26-60``, re-done with a Condition so waiters
    block instead of polling.
    """

    def __init__(self, required):
        self._required = required
        self._nodes = []
        self._identity = {}  # identity key -> index into _nodes
        self._cond = threading.Condition()

    def add(self, meta, key=None):
        """Record one reservation, idempotently per node identity.

        The identity is the node's ``executor_id`` when present (falling back
        to the caller-supplied ``key``): a client-side REG retry after a
        dropped reply, or a relaunched executor re-registering after a crash
        (the Spark task-retry scenario, reference ``TFSparkNode.py:223-232``),
        must *replace* its previous entry — never double-count, which would
        let the cluster look complete while a real host is missing.
        """
        identity = meta.get("executor_id", key) if isinstance(meta, dict) else key
        with self._cond:
            if identity is not None and identity in self._identity:
                self._nodes[self._identity[identity]] = meta
            else:
                if identity is not None:
                    self._identity[identity] = len(self._nodes)
                self._nodes.append(meta)
            self._cond.notify_all()

    def done(self):
        with self._cond:
            return len(self._nodes) >= self._required

    def remove(self, identity):
        """Drop one node's reservation (elastic departure). Returns the
        removed meta, or None when the identity was never registered."""
        with self._cond:
            idx = self._identity.pop(identity, None)
            if idx is None:
                return None
            meta = self._nodes.pop(idx)
            for key, i in list(self._identity.items()):
                if i > idx:
                    self._identity[key] = i - 1
            self._cond.notify_all()
            return meta

    def resize(self, required):
        """Move the completeness bar (elastic resize): after a departure
        the remaining members still form a *complete* cluster at the new
        world size, and a rejoin raises the bar back up."""
        with self._cond:
            self._required = int(required)
            self._cond.notify_all()

    def get(self):
        with self._cond:
            return list(self._nodes)

    def remaining(self):
        with self._cond:
            return self._required - len(self._nodes)

    def wait(self, timeout=None, abort_check=None, poll=1.0):
        """Block until all reservations arrive.

        Returns True when complete, False on timeout. ``abort_check`` is an
        optional callable polled between waits; if it returns a truthy value
        the wait raises ``RuntimeError`` (analog of the reference aborting on
        ``status['error']``, ``reservation.py:113-117``).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while len(self._nodes) < self._required:
                if abort_check is not None:
                    err = abort_check()
                    if err:
                        raise RuntimeError("aborting reservation wait: {}".format(err))
                remaining = poll
                if deadline is not None:
                    remaining = min(poll, deadline - time.monotonic())
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining)
        return True


class LivenessMonitor:
    """Driver-side node-liveness ledger, fed by ``HEARTBEAT`` messages.

    The reference had no liveness signal at all — a dead worker was only
    discovered when a feeder task blocked or a join timed out (SURVEY.md
    §5.3). Here every node's *compute* process beats every ``interval``
    seconds, and the monitor classifies each node into one failure domain:

    * ``starting`` — registered, first beat not yet seen (bring-up: the
      FEED-mode compute child may still be importing torch);
    * ``alive``    — beating on cadence;
    * ``slow``     — late, but within the ``miss_budget`` (no action);
    * ``hung``     — beats stopped for more than ``miss_budget`` intervals
      with no error recorded (the wedged-in-a-collective class);
    * ``crashed``  — the node's last reported manager state was ``error``
      (the error queue carries the traceback);
    * ``finished`` — the node reported a terminal state and stopped
      beating deliberately.

    The beat runs in the process executing user compute, so a wedge that
    holds the GIL (a native collective that never returns) silences it —
    exactly the signal that distinguishes *hung* from *slow*.

    Beyond liveness, the monitor watches the heartbeat-borne node stats
    for **stragglers**: a node whose ``steps_per_sec`` falls (or whose
    ``data_wait_frac`` rises) more than ``straggler_k`` x MAD from the
    cluster median for ``straggler_beats`` consecutive heartbeats is
    flagged — surfaced in :meth:`stragglers` / :meth:`cluster_stats`, as
    a ``cluster/straggler`` event on the driver's timeline, and in the
    driver's ``/statusz`` (``telemetry.put_status``). In an SPMD job one
    slow host gates every collective, so the whole cluster reads "slow"
    while only one node is sick — the MAD-vs-median test names it.
    """

    # Straggler test knobs: deviation threshold in MADs, consecutive
    # beats before flagging, minimum cluster size for a meaningful
    # median, and a relative noise floor under the MAD so a perfectly
    # uniform cluster (MAD ~ 0) cannot flag micro-jitter.
    STRAGGLER_K = 4.0
    STRAGGLER_BEATS = 3
    STRAGGLER_MIN_NODES = 3
    STRAGGLER_MAD_FLOOR = 0.05

    # (stat key, True when LOWER values are the unhealthy direction,
    # absolute deviation floor). The absolute floor only makes sense for
    # stats with a fixed scale: data_wait_frac's healthy value is ~0 so
    # micro-jitter needs an absolute backstop, but steps_per_sec has no
    # natural unit — a 0.01 floor there would silently disable detection
    # for slow-step (large-model) clusters, where a median of 0.02
    # steps/s could never deviate past 4 x 0.01.
    _STRAGGLER_STATS = (("steps_per_sec", True, 0.0),
                        ("data_wait_frac", False, 0.01))

    #: Optional incident hook: ``cb(reason, **attrs)``, fired when the
    #: straggler test flags a node (the incident-capture layer points
    #: this at ``IncidentRecorder.trigger``, which captures on its own
    #: thread — the callback runs under the monitor's lock, so it must
    #: not wait on heartbeats synchronously).
    incident_cb = None

    def __init__(self, interval=2.0, miss_budget=5, start_grace=120.0,
                 straggler_k=None, straggler_beats=None,
                 straggler_min_nodes=None):
        """``start_grace``: seconds a registered node may stay beat-less
        (``starting``) before it classifies ``hung`` — generous, because a
        FEED-mode compute child pays a full interpreter + torch import
        before its first beat, but finite, because a child that dies
        during spawn would otherwise look 'starting' forever and a
        supervised job would never recover from it."""
        self.interval = float(interval)
        self.miss_budget = int(miss_budget)
        self.start_grace = float(start_grace)
        self.straggler_k = float(
            straggler_k if straggler_k is not None else self.STRAGGLER_K)
        self.straggler_beats = int(
            straggler_beats if straggler_beats is not None
            else self.STRAGGLER_BEATS)
        self.straggler_min_nodes = int(
            straggler_min_nodes if straggler_min_nodes is not None
            else self.STRAGGLER_MIN_NODES)
        self._lock = threading.Lock()
        self._nodes = {}  # executor_id -> record

    def expect(self, executor_id, job_name=None):
        """Record a node at registration time, before any beat arrives."""
        if executor_id is None:
            return
        with self._lock:
            rec = self._nodes.setdefault(executor_id, {
                "job_name": job_name, "state": None, "last": None,
                "registered": time.monotonic(), "beats": 0, "stats": None,
            })
            if job_name is not None:
                rec["job_name"] = job_name

    def beat(self, executor_id, state=None, stats=None):
        """One heartbeat: liveness timestamp, reported manager state, and
        (when the node runs the telemetry plane) its compact
        ``telemetry.node_stats()`` dict. Stats-carrying beats also feed
        the process-wide history store
        (:mod:`~tensorflowonspark_tpu_torch.telemetry_store`) when one is
        configured — the retained series behind ``/timeseries``, the
        goodput curve, and the SLO burn-rate monitor."""
        if executor_id is None:
            return
        status = None
        with self._lock:
            rec = self._nodes.setdefault(executor_id, {
                "job_name": None, "state": None, "last": None,
                "registered": time.monotonic(), "beats": 0, "stats": None,
            })
            if state is not None:
                rec["state"] = state
            # Classify BEFORE refreshing the liveness stamp: the goodput
            # accountant needs to know whether the interval this beat
            # CLOSES was spent hung/silent — post-refresh the age is ~0
            # and every beat would read "alive".
            status = self._classify_locked(rec)
            rec["last"] = time.monotonic()
            rec["beats"] += 1
            if stats is not None:
                rec["stats"] = stats
                self._update_stragglers_locked(executor_id, rec)
        if stats is not None:
            # Outside the monitor lock: the store has its own lock and
            # may fan out into SLO evaluation / incident triggers.
            store = telemetry_store.get_store()
            if store is not None:
                try:
                    store.ingest(executor_id, stats, status=status)
                except Exception:  # retention must never break liveness
                    logger.warning("history-store ingest failed",
                                   exc_info=True)

    def _update_stragglers_locked(self, executor_id, rec):
        """Re-evaluate the straggler test for ONE node against the
        cluster's last-known stats (called under ``_lock`` on each
        stats-carrying beat — heartbeats arrive asynchronously, so each
        node is judged at its own cadence against the current cluster).
        """
        stats = rec["stats"]
        counts = rec.setdefault("straggle", {})
        evidence = rec.setdefault("straggle_info", {})
        for key, lower_is_bad, abs_floor in self._STRAGGLER_STATS:
            value = stats.get(key)
            if not isinstance(value, (int, float)):
                # Stat vanished (training loop finished, producer shut
                # down): any standing flag must clear visibly, not go
                # stale in /statusz.
                self._reset_straggle_locked(executor_id, rec, key)
                continue
            peers = [
                r["stats"][key] for r in self._nodes.values()
                if r.get("stats") and isinstance(
                    r["stats"].get(key), (int, float))
                and self._classify_locked(r) in ("alive", "slow")
            ]
            if len(peers) < self.straggler_min_nodes:
                self._reset_straggle_locked(executor_id, rec, key,
                                            value=value)
                continue
            med = statistics.median(peers)
            mad = statistics.median(abs(v - med) for v in peers)
            # Noise floor: a uniform cluster has MAD ~ 0 and would flag
            # any micro-jitter; the absolute term is per-metric (see
            # _STRAGGLER_STATS).
            floor = max(mad, self.STRAGGLER_MAD_FLOOR * abs(med),
                        abs_floor)
            deviation = (med - value) if lower_is_bad else (value - med)
            if floor > 0 and deviation > self.straggler_k * floor:
                n = counts.get(key, 0) + 1
                counts[key] = n
                evidence[key] = {
                    "value": round(float(value), 4),
                    "median": round(float(med), 4),
                    "mad": round(float(mad), 4),
                    "beats": n,
                }
                if n == self.straggler_beats:
                    telemetry.event(
                        "cluster/straggler", executor_id=executor_id,
                        metric=key,
                        **{k: v for k, v in evidence[key].items()
                           if not isinstance(v, dict)})
                    logger.warning(
                        "straggler: executor %s %s=%.4f vs cluster "
                        "median %.4f (>%g MADs for %d beats)",
                        executor_id, key, value, med,
                        self.straggler_k, n)
                    self._publish_stragglers_locked()
                    if self.incident_cb is not None:
                        try:
                            self.incident_cb(
                                "straggler", executor_id=executor_id,
                                metric=key, **evidence[key])
                        except Exception:  # detector must keep running
                            logger.warning(
                                "straggler incident trigger failed",
                                exc_info=True)
                elif n > self.straggler_beats:
                    # A standing straggler's evidence (value/beats) moves
                    # every beat: keep the /statusz mirror current, not a
                    # snapshot from the moment it was first flagged.
                    self._publish_stragglers_locked()
            else:
                self._reset_straggle_locked(executor_id, rec, key,
                                            value=value)

    def _reset_straggle_locked(self, executor_id, rec, key, value=None):
        """Clear one metric's straggle state; a node that WAS flagged
        emits ``cluster/straggler_recovered`` and re-publishes the
        /statusz straggler set — every reset path (healthy value, stat
        vanished, cluster shrank below the minimum) goes through here so
        the three straggler views never disagree."""
        counts = rec["straggle"]
        was_flagged = counts.get(key, 0) >= self.straggler_beats
        counts[key] = 0
        rec["straggle_info"].pop(key, None)
        if was_flagged:
            attrs = {"executor_id": executor_id, "metric": key}
            if value is not None:
                attrs["value"] = round(float(value), 4)
            telemetry.event("cluster/straggler_recovered", **attrs)
            self._publish_stragglers_locked()

    def _stragglers_locked(self):
        out = {}
        for eid, rec in self._nodes.items():
            flagged = {
                key: dict(rec.get("straggle_info", {}).get(key) or {})
                for key, n in (rec.get("straggle") or {}).items()
                if n >= self.straggler_beats
            }
            if flagged:
                out[eid] = flagged
        return out

    def _publish_stragglers_locked(self):
        # Mirror the current straggler set into the driver process's
        # /statusz payload (telemetry._metrics_lock nests under _lock
        # here; telemetry never calls back into the monitor).
        telemetry.put_status("stragglers", self._stragglers_locked())

    def stragglers(self):
        """Currently-flagged stragglers with evidence:
        ``{executor_id: {metric: {value, median, mad, beats}}}`` for
        every node whose deviation held for ``straggler_beats``
        consecutive heartbeats."""
        with self._lock:
            return self._stragglers_locked()

    def evict(self, executor_id):
        """Forget one node entirely (elastic departure / re-registration):
        the liveness record, its last stats, and any straggler evidence go
        with it, so a returning incarnation starts from a clean ledger
        instead of inheriting its predecessor's ``crashed`` verdict or
        stale gauges. Returns True when a record was dropped."""
        with self._lock:
            rec = self._nodes.pop(executor_id, None)
            if rec is not None and any(
                    n >= self.straggler_beats
                    for n in (rec.get("straggle") or {}).values()):
                self._publish_stragglers_locked()
        return rec is not None

    def node_stats_fn(self, executor_id):
        """A zero-arg callable returning this node's latest
        heartbeat-borne stats dict (or None before the first
        stats-carrying beat) — the driver-side hook
        :class:`~tensorflowonspark_tpu_torch.serving.fleet.RemoteEngine`
        wants for ``stats_fn=``: remote serve load read off the
        heartbeat plane instead of a hand-rolled lambda over
        ``cluster_stats()``."""
        def stats():
            with self._lock:
                rec = self._nodes.get(executor_id)
                s = rec.get("stats") if rec else None
                return dict(s) if s else None
        return stats

    def age(self, executor_id):
        """Seconds since the node's last beat (None before the first)."""
        with self._lock:
            rec = self._nodes.get(executor_id)
        if rec is None or rec["last"] is None:
            return None
        return time.monotonic() - rec["last"]

    def classify(self, executor_id):
        with self._lock:
            rec = self._nodes.get(executor_id)
            return self._classify_locked(rec)

    def _classify_locked(self, rec):
        if rec is None:
            return "unknown"
        if rec["state"] == "error":
            return "crashed"
        if rec["state"] in ("finished", "stopped"):
            return "finished"
        if rec["last"] is None:
            if time.monotonic() - rec["registered"] > self.start_grace:
                return "hung"  # never came up: spawn/import death
            return "starting"
        age = time.monotonic() - rec["last"]
        if age > self.interval * self.miss_budget:
            return "hung"
        if age > self.interval * 2:
            return "slow"
        return "alive"

    def dead(self):
        """Executor ids in a dead failure domain (``hung``/``crashed``)."""
        with self._lock:
            return sorted(
                eid for eid, rec in self._nodes.items()
                if self._classify_locked(rec) in ("hung", "crashed")
            )

    def snapshot(self):
        """Per-node ``{executor_id: {job_name, state, status, age}}``."""
        out = {}
        with self._lock:
            now = time.monotonic()
            for eid, rec in self._nodes.items():
                out[eid] = {
                    "job_name": rec["job_name"],
                    "state": rec["state"],
                    "status": self._classify_locked(rec),
                    "heartbeat_age": (
                        None if rec["last"] is None else now - rec["last"]
                    ),
                    "beats": rec["beats"],
                    "stats": rec.get("stats"),
                }
        return out

    def cluster_stats(self):
        """Live per-node stats snapshot on the driver: liveness status
        merged with each node's last heartbeat-reported stats (current
        step, steps/sec, data-wait fraction, prefetch depth, last
        checkpoint step, rss — see ``telemetry.node_stats``). The
        hung-node diagnosis payload: "stuck at step N with an empty
        prefetch queue" reads straight out of this dict. Each entry
        carries ``heartbeat_age`` (staleness) beside the last stats and
        a ``stale`` flag once the beat cadence slipped — the dashboard
        greys those series instead of plotting a frozen flat line.

        When an elastic :class:`Server` owns this monitor it installs
        ``membership_fn``, and the snapshot gains a reserved
        ``"cluster"`` entry with the membership gauges (epoch,
        world_size, departures/rejoins/resizes, per-node incarnations).
        """
        out = {}
        with self._lock:
            now = time.monotonic()
            for eid, rec in self._nodes.items():
                status = self._classify_locked(rec)
                entry = {
                    "job_name": rec["job_name"],
                    "state": rec["state"],
                    "status": status,
                    "heartbeat_age": (
                        None if rec["last"] is None else
                        round(now - rec["last"], 3)
                    ),
                }
                if status in ("slow", "hung", "crashed"):
                    entry["stale"] = True
                stats = rec.get("stats")
                if stats:
                    # The bucket-count exports ride separately into the
                    # history store; this dict stays the compact human/
                    # JSON view.
                    entry.update({k: v for k, v in stats.items()
                                  if k != "hists"})
                if any(n >= self.straggler_beats
                       for n in (rec.get("straggle") or {}).values()):
                    entry["straggler"] = True
                out[eid] = entry
        membership_fn = getattr(self, "membership_fn", None)
        if membership_fn is not None:
            try:
                out["cluster"] = membership_fn()
            except Exception:  # gauges must never break the snapshot
                logger.debug("membership gauges failed", exc_info=True)
        return out

    def describe(self, executor_ids=None):
        """Human-readable per-node liveness, for timeout/teardown errors."""
        snap = self.snapshot()
        ids = sorted(snap) if executor_ids is None else executor_ids
        parts = []
        for eid in ids:
            rec = snap.get(eid)
            if rec is None:
                parts.append("executor {}: never heard from".format(eid))
                continue
            age = rec["heartbeat_age"]
            parts.append("executor {} ({}): {}, {}".format(
                eid, rec["job_name"] or "?", rec["status"],
                "no heartbeat yet" if age is None
                else "last heartbeat {:.1f}s ago".format(age),
            ))
        return "; ".join(parts) or "no nodes observed"


class MessageSocket:
    """Length-prefixed JSON framing over a stream socket.

    Layout mirrors the reference's framing (4-byte big-endian length +
    payload, ``reservation.py:63-92``) but the payload is UTF-8 JSON.
    """

    @staticmethod
    def send_msg(sock, obj):
        payload = json.dumps(obj).encode("utf-8")
        sock.sendall(_HEADER.pack(len(payload)) + payload)

    @staticmethod
    def recv_msg(sock):
        header = MessageSocket._recv_exact(sock, _HEADER.size)
        (length,) = _HEADER.unpack(header)
        if length > _MAX_FRAME:
            raise ValueError("control frame too large: {} bytes".format(length))
        return json.loads(MessageSocket._recv_exact(sock, length).decode("utf-8"))

    @staticmethod
    def _recv_exact(sock, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("control connection closed")
            buf.extend(chunk)
        return bytes(buf)


class _CaptureLedger:
    """Driver-side bookkeeping for one in-flight snapshot round.

    The reservation protocol is client-initiated, so the driver cannot
    push a request to nodes — instead the pending capture id rides every
    heartbeat *reply*, and nodes answer with a ``SNAP`` message. One
    round at a time; results keyed by capture id so a late snapshot from
    an abandoned round cannot pollute the next one.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._pending = None   # {"id": ..., "profile_secs": ...}
        self._results = {}     # capture_id -> {executor_id: snapshot}

    def pending(self):
        with self._cond:
            return dict(self._pending) if self._pending else None

    def add(self, capture_id, executor_id, snapshot):
        if capture_id is None or executor_id is None:
            return
        with self._cond:
            # Only the pending round may store: a SNAP landing after its
            # round timed out (routine — the collection budget is ~two
            # heartbeat intervals) would otherwise re-create the popped
            # results entry and pin a full ring+stacks snapshot in driver
            # memory for the server's lifetime.
            if self._pending is None or self._pending["id"] != capture_id:
                return
            self._results.setdefault(capture_id, {})[executor_id] = snapshot
            self._cond.notify_all()

    def collect(self, expected, timeout, profile_secs=0.0):
        """Open a round, wait until every ``expected`` executor answered
        (or ``timeout``), close the round, return ``{executor_id:
        snapshot}``. An empty ``expected`` returns immediately — nothing
        alive is going to answer."""
        cid = uuid.uuid4().hex[:12]
        expected = set(expected or ())
        deadline = time.monotonic() + float(timeout)
        with self._cond:
            self._pending = {"id": cid,
                             "profile_secs": float(profile_secs or 0.0)}
            try:
                while not expected <= set(self._results.get(cid, ())):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(min(0.25, remaining))
            finally:
                self._pending = None
            return dict(self._results.pop(cid, {}))


class Server(MessageSocket):
    """Driver-hosted rendezvous server.

    Lifecycle parity with reference ``reservation.py:95-190``: ``start()``
    returns the bound ``(host, port)``; ``await_reservations()`` blocks until
    every expected node registered (or raises on timeout / recorded error);
    ``STOP`` from any client flips ``done`` which ends streaming-style jobs.
    The heartbeat channel doubles as the incident-capture transport: a
    pending snapshot request rides each ``HB`` reply and nodes answer with
    ``SNAP`` (see :meth:`snapshot_round`).

    With ``elastic=True`` the server also owns **membership epochs**: a
    departure (:meth:`depart`) or a post-rendezvous (re-)registration
    bumps the epoch and publishes a *resize directive* — ``{epoch,
    world_size, members, reason, executor_id}`` — that rides every
    heartbeat reply until the member acks it by echoing the epoch on a
    later beat (the same client-initiated push the capture ledger uses:
    the driver cannot dial nodes, so directives surf the replies).
    Surviving nodes treat an unseen directive as a **resize barrier**:
    roll back to the last committed checkpoint step, rebuild the mesh at
    the new world size, continue degraded. Nothing is torn down.
    """


    def __init__(self, count, heartbeat_interval=2.0, heartbeat_miss_budget=5,
                 heartbeat_start_grace=120.0, elastic=False, min_nodes=1):
        assert count > 0, "server expects a positive node count"
        self.reservations = Reservations(count)
        self.liveness = LivenessMonitor(
            interval=heartbeat_interval, miss_budget=heartbeat_miss_budget,
            start_grace=heartbeat_start_grace,
        )
        self.capture = _CaptureLedger()
        self.done = threading.Event()
        self._listener = None
        self.elastic = bool(elastic)
        self.min_nodes = max(1, int(min_nodes))
        self._elock = threading.Lock()
        self.epoch = 0
        self._directive = None     # newest resize directive (or None)
        self._acked = {}           # executor_id -> last epoch echoed on HB
        self._incarnations = {}    # executor_id -> registration count
        self._counters = {"resizes": 0, "departures": 0, "rejoins": 0}
        if self.elastic:
            self.liveness.membership_fn = self.membership

    # -- elastic membership -------------------------------------------------

    def depart(self, executor_id, reason="node_death"):
        """Remove one member and publish a shrink directive to the
        survivors. Returns the departed node's meta (None when the id was
        not a member — e.g. a double departure race)."""
        meta = self.reservations.remove(executor_id)
        if meta is None:
            return None
        self.liveness.evict(executor_id)
        members = self.reservations.get()
        self.reservations.resize(len(members))
        with self._elock:
            self._acked.pop(executor_id, None)
            self._counters["departures"] += 1
            directive = self._publish_locked(reason, executor_id, members)
        logger.warning(
            "elastic departure: executor %s (%s) -> epoch %d, world %d",
            executor_id, reason, directive["epoch"], directive["world_size"])
        telemetry.event("cluster/resize", executor_id=executor_id,
                        reason=reason, epoch=directive["epoch"],
                        world_size=directive["world_size"])
        return meta

    def _publish_locked(self, reason, executor_id, members):
        self.epoch += 1
        self._counters["resizes"] += 1
        self._directive = {
            "epoch": self.epoch,
            "world_size": len(members),
            "members": sorted(
                m.get("executor_id") for m in members if isinstance(m, dict)
            ),
            # Serving-role directives (ISSUE 17): a member registering
            # with meta["role"]="serving" is inference capacity the
            # autoscaler grows/shrinks — survivors (and the fleet's
            # replica registry) see which plane a join/leave touched
            # without re-reading every meta. Absent role means "train".
            "roles": {
                m.get("executor_id"): m.get("role", "train")
                for m in members
                if isinstance(m, dict) and m.get("role")
            },
            "reason": reason,
            "executor_id": executor_id,
        }
        return dict(self._directive)

    def _elastic_register(self, executor_id, pre_done):
        """Membership bookkeeping for one REG (elastic mode only): every
        registration bumps the node's incarnation; one arriving after the
        initial rendezvous completed (``pre_done``: completeness BEFORE
        this add — the last node of the initial rendezvous must not read
        as a join) or after any resize publishes an expand directive."""
        if executor_id is None:
            return
        members = self.reservations.get()
        with self._elock:
            incarnation = self._incarnations.get(executor_id, 0) + 1
            self._incarnations[executor_id] = incarnation
            if not pre_done and self.epoch == 0:
                return  # initial rendezvous (incl. REG retries)
            self._counters["rejoins"] += 1
            directive = self._publish_locked("join", executor_id, members)
        self.reservations.resize(len(members))
        logger.info(
            "elastic join: executor %s (incarnation %d) -> epoch %d, "
            "world %d", executor_id, incarnation, directive["epoch"],
            directive["world_size"])
        telemetry.event("cluster/rejoin", executor_id=executor_id,
                        incarnation=incarnation, epoch=directive["epoch"],
                        world_size=directive["world_size"])

    def _resize_reply(self, executor_id, acked_epoch):
        """The directive to attach to one HB reply (None when the member
        already acked the current epoch, or no directive stands)."""
        with self._elock:
            if executor_id is not None and acked_epoch is not None:
                self._acked[executor_id] = acked_epoch
            if self._directive is None:
                return None
            if acked_epoch == self._directive["epoch"]:
                return None
            return dict(self._directive)

    def membership(self):
        """Elastic membership gauges: epoch, live world size, resize /
        departure / rejoin counters, per-node incarnations, and which
        members acked the current epoch. Merged into ``cluster_stats()``
        under the reserved ``"cluster"`` key."""
        members = self.reservations.get()
        serving = sum(1 for m in members if isinstance(m, dict)
                      and m.get("role") == "serving")
        with self._elock:
            return {
                "elastic": self.elastic,
                "epoch": self.epoch,
                "world_size": len(members),
                "serving_nodes": serving,
                "min_nodes": self.min_nodes,
                "resizes": self._counters["resizes"],
                "departures": self._counters["departures"],
                "rejoins": self._counters["rejoins"],
                "incarnations": dict(self._incarnations),
                "acked": dict(self._acked),
            }

    def snapshot_round(self, expected, timeout, profile_secs=0.0):
        """Ask every node for its black-box snapshot; block until the
        ``expected`` executors answered or ``timeout`` elapsed. Latency
        is bounded below by the heartbeat cadence — the request is
        advertised on heartbeat replies."""
        return self.capture.collect(expected, timeout,
                                    profile_secs=profile_secs)

    def start(self):
        """Bind an ephemeral port and serve on a daemon thread."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("", 0))
        self._listener.listen(64)
        host = util.get_ip_address()
        port = self._listener.getsockname()[1]
        threading.Thread(
            target=self._accept_loop, name="rendezvous-server", daemon=True
        ).start()
        logger.info("rendezvous server listening on %s:%d", host, port)
        return (host, port)

    def _accept_loop(self):
        # Serve until the listener is explicitly closed (``stop()``), NOT
        # until ``done``: STOP only *flips* done — several nodes may send
        # STOP near-simultaneously at job end, and a server that stopped
        # answering after the first one would strand the rest in the
        # kernel's accept backlog until their socket timeouts (a real
        # teardown race seen with multiple feeder partitions draining).
        while True:
            try:
                conn, addr = self._listener.accept()
            except OSError:
                break  # listener closed
            threading.Thread(
                target=self._serve_conn, args=(conn, addr), daemon=True
            ).start()

    def _serve_conn(self, conn, addr):
        try:
            while True:
                try:
                    msg = self.recv_msg(conn)
                except (ConnectionError, ValueError):
                    break
                try:
                    reply = self._dispatch(msg, addr)
                except Exception as e:  # malformed-but-framed message
                    reply = {"error": "bad control message: {!r}".format(e)}
                try:
                    self.send_msg(conn, reply)
                except OSError:  # peer vanished mid-reply
                    break
        finally:
            conn.close()

    def _dispatch(self, msg, addr):
        kind = msg.get("type")
        if kind == REG:
            pre_done = self.reservations.done()
            self.reservations.add(msg["meta"], key=msg.get("reg_id"))
            meta = msg["meta"]
            if isinstance(meta, dict):
                eid = meta.get("executor_id")
                # A re-registration replaces a terminal incarnation: the
                # stale record (crashed/finished verdict, frozen stats,
                # straggler evidence) must not outlive the node it
                # described — the new incarnation starts ``starting``.
                if eid is not None and self.liveness.classify(eid) in (
                        "crashed", "hung", "finished"):
                    self.liveness.evict(eid)
                self.liveness.expect(eid, meta.get("job_name"))
                if self.elastic:
                    self._elastic_register(eid, pre_done)
                # Driver-side half of the clock-alignment pair: the
                # node records a ``rendezvous/register`` span around
                # this exchange, the driver stamps the receive — both
                # clocks observing one event is what lets a merged
                # timeline line up across skewed hosts.
                telemetry.event("rendezvous/register_rx",
                                executor_id=meta.get("executor_id"))
            logger.debug("registered node from %s: %s", addr, meta)
            return {"ok": True}
        if kind == HEARTBEAT:
            self.liveness.beat(msg.get("executor_id"), msg.get("state"),
                               msg.get("stats"))
            # "done" rides the reply as information (a streaming node MAY
            # use it to wind down); senders keep beating regardless — a
            # node draining after STOP must not go silent mid-drain.
            reply = {"ok": True, "done": self.done.is_set()}
            # A pending incident capture rides every heartbeat reply:
            # the node sees the id, dumps its black box, and answers
            # with SNAP (node.HeartbeatSender._maybe_snapshot).
            pending = self.capture.pending()
            if pending:
                reply["capture"] = pending
            if self.elastic:
                directive = self._resize_reply(msg.get("executor_id"),
                                               msg.get("epoch"))
                if directive:
                    reply["resize"] = directive
            return reply
        if kind == SNAPSHOT:
            self.capture.add(msg.get("capture_id"), msg.get("executor_id"),
                             msg.get("snapshot"))
            return {"ok": True}
        if kind == QUERY:
            return {"done": self.reservations.done()}
        if kind == QINFO:
            return {"nodes": self.reservations.get()}
        if kind == STOP:
            logger.info("STOP received from %s", addr)
            self.done.set()
            return {"ok": True}
        return {"error": "unknown message type: {!r}".format(kind)}

    def await_reservations(self, status=None, timeout=600):
        """Block until all nodes registered; returns cluster_info.

        ``status`` is an optional shared dict whose ``'error'`` key aborts the
        wait (the reference's background-launch failure channel,
        ``TFCluster.py:272-283`` + ``reservation.py:108-123``).
        """
        abort = (lambda: status.get("error")) if status is not None else None
        with telemetry.span("rendezvous/await", role="driver",
                            expected=self.reservations._required) as sp:
            ok = self.reservations.wait(timeout=timeout, abort_check=abort)
            sp.set(complete=bool(ok))
        if not ok:
            registered = self.reservations.get()
            ids = [
                m.get("executor_id") for m in registered
                if isinstance(m, dict)
            ]
            raise TimeoutError(
                "timed out after {}s waiting for {} of {} node(s) to "
                "register; registered so far: [{}]".format(
                    timeout, self.reservations.remaining(),
                    self.reservations.remaining() + len(registered),
                    self.liveness.describe(ids),
                )
            )
        return self.reservations.get()

    def stop(self):
        self.done.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:  # pragma: no cover
                pass


class Client(MessageSocket):
    """Per-node rendezvous client (reference ``reservation.py:193-260``).

    Connection attempts retry with exponential backoff + jitter under an
    overall deadline (the reference slept ``attempt`` seconds linearly,
    ``reservation.py:201-208`` — under a thundering-herd relaunch every
    node would re-dial the driver in lockstep).
    """

    RETRIES = 5
    BACKOFF = 0.5          # first retry delay, doubles per attempt
    BACKOFF_CAP = 5.0      # per-delay ceiling
    JITTER = 0.25          # +/- fraction applied to each delay
    CONNECT_DEADLINE = 30.0  # overall budget across all attempts

    def __init__(self, server_addr, retries=None, deadline=None):
        """``retries``/``deadline`` override the class defaults — e.g. a
        feeder notifying a server that may already be gone wants a short
        budget, while a node dialing a slow-starting driver wants the
        full one."""
        self.server_addr = tuple(server_addr)
        # `is not None`, not truthiness: an explicit 0 means "minimal
        # budget" (clamped to one attempt), never "use the default".
        self.retries = (
            max(1, int(retries)) if retries is not None else self.RETRIES
        )
        self.deadline = (
            max(0.0, float(deadline)) if deadline is not None
            else self.CONNECT_DEADLINE
        )
        self._reg_id = uuid.uuid4().hex
        self._sock = self._connect()

    def _backoff_delay(self, attempt, deadline):
        delay = util.backoff_delay(
            attempt - 1, self.BACKOFF, self.BACKOFF_CAP, self.JITTER
        )
        return max(0.0, min(delay, deadline - time.monotonic()))

    def _connect(self):
        start = time.monotonic()
        deadline = start + self.deadline
        last = None
        for attempt in range(self.retries):
            if attempt:
                if time.monotonic() >= deadline:
                    break
                time.sleep(self._backoff_delay(attempt, deadline))
            try:
                budget = max(1.0, deadline - time.monotonic())
                return socket.create_connection(
                    self.server_addr, timeout=min(30.0, budget)
                )
            except OSError as e:
                last = e
        raise ConnectionError(
            "could not reach rendezvous server at {}:{} after {} attempt(s) "
            "over {:.1f}s: {}".format(
                self.server_addr[0], self.server_addr[1],
                attempt + 1, time.monotonic() - start, last,
            )
        )

    def _request(self, msg):
        deadline = time.monotonic() + self.deadline
        for attempt in range(self.retries):
            try:
                self.send_msg(self._sock, msg)
                return self.recv_msg(self._sock)
            except OSError:
                if attempt == self.retries - 1 or time.monotonic() >= deadline:
                    raise
                time.sleep(self._backoff_delay(attempt + 1, deadline))
                self._sock = self._connect()
        raise ConnectionError("unreachable")  # pragma: no cover

    def register(self, meta):
        """Register this node's metadata with the driver.

        Attaches a per-client idempotency token so a retry after a dropped
        reply cannot double-register this node.
        """
        attrs = ({"executor_id": meta.get("executor_id")}
                 if isinstance(meta, dict) else {})
        with telemetry.span("rendezvous/register", **attrs):
            return self._request(
                {"type": REG, "meta": meta, "reg_id": self._reg_id})

    def get_reservations(self):
        """Fetch the currently-known cluster membership."""
        return self._request({"type": QINFO})["nodes"]

    def heartbeat(self, executor_id, state=None, stats=None, epoch=None):
        """Report this node's liveness (manager state + optional
        ``telemetry.node_stats()`` dict) to the driver. The reply may
        carry a pending incident-capture request (``"capture"``) or, on
        an elastic cluster, a resize directive (``"resize"``); ``epoch``
        echoes the newest directive this node has applied — the ack that
        stops the server re-sending it."""
        msg = {"type": HEARTBEAT, "executor_id": executor_id, "state": state}
        if stats:
            msg["stats"] = stats
        if epoch is not None:
            msg["epoch"] = epoch
        return self._request(msg)

    def send_snapshot(self, executor_id, capture_id, snapshot):
        """Answer an incident-capture request with this node's black-box
        dump (``incident.node_snapshot()``)."""
        return self._request({
            "type": SNAPSHOT, "executor_id": executor_id,
            "capture_id": capture_id, "snapshot": snapshot,
        })

    def await_reservations(self, timeout=600, poll=1.0):
        """Poll the server until the cluster is complete; returns membership."""
        deadline = time.monotonic() + timeout
        with telemetry.span("rendezvous/await", role="node"):
            return self._await_reservations(deadline, timeout, poll)

    def _await_reservations(self, deadline, timeout, poll):
        while True:
            if self._request({"type": QUERY})["done"]:
                return self.get_reservations()
            if time.monotonic() > deadline:
                try:
                    seen = self.get_reservations()
                    detail = "; {} node(s) registered so far: {}".format(
                        len(seen),
                        sorted(
                            m.get("executor_id") for m in seen
                            if isinstance(m, dict)
                        ),
                    )
                except (OSError, ConnectionError):
                    detail = ""
                raise TimeoutError(
                    "timed out after {}s awaiting cluster completeness at "
                    "{}:{}{}".format(
                        timeout, self.server_addr[0], self.server_addr[1],
                        detail,
                    )
                )
            time.sleep(poll)

    def request_stop(self):
        """Send the out-of-band STOP signal (ends streaming jobs)."""
        return self._request({"type": STOP})

    def close(self):
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass
