"""Incident capture: the cluster black box (the port of the JAX package's
``incident.py``; the bundle layout and manifest keys are that module's, so
one reader serves both packages' bundles).

Spans, ``/metrics`` and ``cluster_stats()`` make the cluster legible
while someone is watching. This module makes it legible *after the
fact*: when a detector fires (a straggler flag, a
hung/crashed-node verdict, a supervised-attempt failure, an SLO
breach), the driver pulls evidence from every node **before** the teardown
destroys it and writes one timestamped incident directory — the bundle an
operator opens instead of re-running the failure.

Three capture paths, one bundle format:

* **Live nodes** answer a snapshot request carried on the reservation
  channel: the driver marks a capture pending, every heartbeat reply
  advertises it, and the node's :class:`~tensorflowonspark_tpu_torch
  .node.HeartbeatSender` — which runs *in the compute process*, FEED children
  included — builds :func:`node_snapshot` (flight-recorder ring,
  ``faulthandler`` all-thread stack dump, ``node_stats()``, the
  continuous sampler's folded-stack window, optionally a short
  ``torch.profiler`` window) and sends it back as a ``SNAP`` message.
* **Dead nodes** can't answer, but their *crash* snapshot survives: the
  node runtime publishes one to the per-executor manager KV while the
  failure is still unwinding (``node._run_user_fn``), and the driver's
  recorder pulls it over the manager bridge — the same hop ``node_stats``
  rides in FEED mode — so the ring and stacks of a crashed process are
  not lost with it.
* **The driver itself** contributes its own ring/stacks, the liveness
  ledger, ``cluster_stats()``, stragglers, the supervisor's restart
  history, and (when span export is configured) the merged clock-aligned
  cluster timeline.

Captures are rate-limited per incident root (one storm must not write a
thousand bundles), recorded as a ``cluster/incident`` timeline event, and
listed by the ``/incidents`` endpoint. ``scripts/torch_incident_report.py``
renders a bundle human-readable. Everything here is stdlib-only, apart
from the ``torch.profiler`` window (``train/profiler.py``).
"""

import json
import logging
import os
import threading
import time

from tensorflowonspark_tpu_torch import telemetry

logger = logging.getLogger(__name__)

# Cap on the flight-recorder slice a node ships in its snapshot: bounds
# the SNAP frame (and the KV value) while keeping minutes of context at
# normal span rates.
SNAPSHOT_RING_SPANS = 256

# Module-level rate limiter keyed by incident root: supervised relaunch
# loops create a fresh recorder per attempt, and a crash-relaunch-crash
# cycle must still be one bundle per ``min_interval``, not one per
# recorder instance.
_limiter_lock = threading.Lock()
_last_capture = {}  # root path -> monotonic time of last bundle

DEFAULT_MIN_INTERVAL = 30.0

# Allowance in a snapshot round for a node's first torch.profiler session
# to initialise before its profile window starts.
PROFILER_START_S = 5.0


def register_sigusr2():
    """Register a ``faulthandler`` all-thread stack dump on SIGUSR2.

    Called by every spawned node runtime and compute child at startup so
    a wedged process can always be diagnosed externally
    (``kill -USR2 <pid>`` → stacks on stderr), even without a capture
    round. ``chain=True`` keeps any existing handler. Returns True when
    registered; never raises (platforms without SIGUSR2 degrade to
    False)."""
    try:
        import faulthandler
        import signal

        if not hasattr(signal, "SIGUSR2"):
            return False
        faulthandler.register(signal.SIGUSR2, all_threads=True, chain=True)
        return True
    except Exception:  # exotic platform or embedding
        logger.debug("SIGUSR2 faulthandler registration failed",
                     exc_info=True)
        return False


def dump_stacks():
    """Every thread's current stack as text (``faulthandler`` format).

    faulthandler writes to a real file descriptor, so the dump goes
    through an unlinked temp file; a platform where that fails degrades
    to a ``sys._current_frames`` rendering rather than raising."""
    try:
        import faulthandler
        import tempfile

        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read()
    except Exception:
        import sys
        import traceback

        out = []
        for tid, frame in sys._current_frames().items():
            out.append("Thread 0x{:x} (fallback dump):\n{}".format(
                tid, "".join(traceback.format_stack(frame))))
        return "\n".join(out)


def _maybe_profile(secs):
    """A short on-demand ``torch.profiler`` window
    (:func:`~tensorflowonspark_tpu_torch.train.profiler.window`), when the
    process registered a profiler server (the ``profiler_port`` gauge is
    live) OR runs the continuous sampling profiler
    (telemetry/profiling.py): either means the node is armed for profile
    evidence. Returns the local trace directory, or None (not armed, or
    another profiler session is running). Blocks the capturing thread for
    ``secs``."""
    if not secs or secs <= 0:
        return None
    armed = bool(telemetry.get_gauge("profiler_port"))
    if not armed:
        try:
            from tensorflowonspark_tpu_torch.telemetry import profiling

            armed = profiling.running()
        except Exception:
            armed = False
    if not armed:
        return None
    try:
        from tensorflowonspark_tpu_torch.train import profiler

        return profiler.window(float(secs))
    except Exception:  # no torch profiler in this process
        logger.debug("incident profiler window failed", exc_info=True)
        return None


def node_snapshot(profile_secs=0.0, ring_limit=SNAPSHOT_RING_SPANS):
    """This process's black-box dump: flight-recorder ring, all-thread
    stack dump, ``node_stats()``, pid/node identity — and, when asked
    and a profiler server is registered, a short local profiler trace
    (its directory path; traces are too big to ship over the control
    channel). Pure read-side: safe to call from a heartbeat thread or an
    unwinding exception handler."""
    rec = telemetry.get_recorder()
    snap = {
        "ts": round(time.time(), 3),
        "pid": os.getpid(),
        "node": rec.node_id if rec is not None else str(os.getpid()),
        "stats": telemetry.node_stats(),
        "stacks": dump_stacks(),
        "ring": telemetry.recent_spans(last=ring_limit),
    }
    # The continuous profiler's active window: bounded
    # collapsed stacks + top-frame digests, embedded beside the one-shot
    # stack dump so every bundle says where the samples went, not just
    # where the threads were at capture time.
    try:
        from tensorflowonspark_tpu_torch.telemetry import profiling

        prof = profiling.window_export()
        if prof:
            snap["profile"] = prof
    except Exception:
        logger.debug("profile window export failed", exc_info=True)
    profile_dir = _maybe_profile(profile_secs)
    if profile_dir:
        snap["profile_dir"] = profile_dir
    return snap


def _rate_limited(root, min_interval):
    """True when a capture under ``root`` ran less than ``min_interval``
    seconds ago (and count this trigger as suppressed); otherwise claim
    the slot. The claim is tentative — a capture that then FAILS must
    call :func:`_release_slot` so a failed write (full disk) cannot
    suppress the next genuine incident in the window."""
    now = time.monotonic()
    with _limiter_lock:
        last = _last_capture.get(root)
        if last is not None and now - last < min_interval:
            telemetry.inc("incident_captures_suppressed_total")
            return True
        _last_capture[root] = now
        return False


def _release_slot(root):
    """Roll back a tentative rate-limit claim after a failed capture."""
    with _limiter_lock:
        _last_capture.pop(root, None)


def _unique_dir(root, stamp, reason):
    safe = "".join(c if (c.isalnum() or c in "-_") else "_"
                   for c in str(reason))[:40] or "incident"
    base = os.path.join(root, "incident-{}-{}".format(stamp, safe))
    path, n = base, 1
    while os.path.exists(path):
        n += 1
        path = "{}-{}".format(base, n)
    os.makedirs(path)
    return path


def _write_json(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, default=str, sort_keys=True)


class IncidentRecorder:
    """Driver-side black-box coordinator: collects per-node snapshots
    over the reservation channel (plus the manager-KV crash fallback),
    bundles them with the driver's own evidence, and writes one
    timestamped incident directory per capture.

    ``server`` is the live :class:`~tensorflowonspark_tpu_torch
    .reservation.Server` (None = driver-local capture only); ``cluster_info`` the
    rendezvoused node metadata (enables the manager-KV fallback for
    nodes that died before they could answer); ``telemetry_dir`` the
    cluster's span-export root (enables the merged clock-aligned
    timeline in the bundle).
    """

    def __init__(self, root, server=None, cluster_info=None,
                 telemetry_dir=None, min_interval=DEFAULT_MIN_INTERVAL,
                 node_timeout=None, profile_secs=0.0):
        self.root = os.path.abspath(os.fspath(root))
        self.server = server
        self.cluster_info = list(cluster_info or [])
        self.telemetry_dir = telemetry_dir
        self.min_interval = float(min_interval)
        self.profile_secs = float(profile_secs)
        # Node snapshot collection budget: two heartbeat intervals (the
        # request rides HB replies) plus dispatch slack.
        if node_timeout is None and server is not None:
            node_timeout = 2.0 * getattr(server.liveness, "interval", 2.0) \
                + 1.0
        self.node_timeout = float(node_timeout or 3.0)
        self._lock = threading.Lock()
        self.captures = []  # bundle dir paths written by this recorder
        self._triggered = []  # capture threads started by trigger()
        self._lock_triggered = threading.Lock()

    # -- triggers -----------------------------------------------------------

    def trigger(self, reason, **attrs):
        """Fire-and-forget capture on a daemon thread — the form detector
        callbacks use (the straggler test runs under the liveness lock;
        a synchronous capture there would deadlock against the very
        heartbeats it waits for). Returns the thread; :meth:`join` waits
        for every triggered capture."""
        t = threading.Thread(
            target=self._capture_guarded, args=(reason,), kwargs=attrs,
            name="incident-capture", daemon=True,
        )
        with self._lock_triggered:
            self._triggered.append(t)
        t.start()
        return t

    def join(self, timeout=None):
        """Wait until every capture :meth:`trigger` started has ended
        (each up to ``timeout`` seconds); returns the bundles written so
        far."""
        with self._lock_triggered:
            threads, self._triggered = self._triggered, []
        for t in threads:
            t.join(timeout)
        return list(self.captures)

    def _capture_guarded(self, reason, **attrs):
        try:
            self.capture(reason, **attrs)
        except Exception:  # never let a capture failure kill a detector
            logger.warning("incident capture (%s) failed", reason,
                           exc_info=True)

    # -- the capture --------------------------------------------------------

    def capture(self, reason, **attrs):
        """Synchronous capture: collect, bundle, write. Returns the
        bundle directory, or None when rate-limited. The supervisor
        calls this form *before* teardown so the evidence outlives the
        cluster."""
        if _rate_limited(self.root, self.min_interval):
            logger.info("incident capture (%s) suppressed by rate limit",
                        reason)
            return None
        try:
            with self._lock, telemetry.span("capture/incident",
                                            reason=reason):
                path = self._capture_locked(reason, attrs)
        except BaseException:
            _release_slot(self.root)  # a failed write must not suppress
            raise                     # the next real incident
        telemetry.inc("incident_captures_total")
        return path

    def _capture_locked(self, reason, attrs):
        stamp = time.strftime("%Y%m%d-%H%M%S")
        snapshots = self._collect_node_snapshots()
        missing = self._fallback_from_managers(snapshots)
        bundle = _unique_dir(self.root, stamp, reason)

        # The driver's own black box.
        driver_snap = node_snapshot()
        driver_snap["node"] = driver_snap.get("node") or "driver"

        rings_dir = os.path.join(bundle, "rings")
        stacks_dir = os.path.join(bundle, "stacks")
        nodes_dir = os.path.join(bundle, "nodes")
        profiles_dir = os.path.join(bundle, "profiles")
        for d in (rings_dir, stacks_dir, nodes_dir):
            os.makedirs(d, exist_ok=True)

        def emit(name, snap):
            ring = snap.get("ring") or []
            if ring:
                with open(os.path.join(
                        rings_dir, "{}.jsonl".format(name)), "w") as f:
                    for doc in ring:
                        f.write(json.dumps(doc, default=str) + "\n")
            if snap.get("stacks"):
                with open(os.path.join(
                        stacks_dir, "{}.txt".format(name)), "w") as f:
                    f.write(snap["stacks"])
            # Continuous-profile window: the collapsed-stack text lands as
            # profiles/<name>.folded (flamegraph.pl / speedscope
            # loadable); the compact digests stay in the node JSON.
            prof = snap.get("profile")
            if isinstance(prof, dict) and prof.get("folded"):
                os.makedirs(profiles_dir, exist_ok=True)
                with open(os.path.join(
                        profiles_dir, "{}.folded".format(name)), "w") as f:
                    f.write(prof["folded"] + "\n")
                prof = {k: v for k, v in prof.items() if k != "folded"}
            doc = {k: v for k, v in snap.items()
                   if k not in ("ring", "stacks", "profile")}
            if isinstance(prof, dict):
                doc["profile"] = prof
            _write_json(os.path.join(nodes_dir, "{}.json".format(name)),
                        doc)

        emit("driver", driver_snap)
        for eid, snap in snapshots.items():
            # File names keyed by EXECUTOR id, not the snapshot's node
            # id: ids are unique per cluster while node ids can collide
            # (in-process test harnesses, a driver-side service node).
            # The span docs inside the ring keep their own node field,
            # which is what the timeline merge rows on.
            emit("node{}".format(eid), snap)

        cluster_doc = self._cluster_evidence()
        _write_json(os.path.join(bundle, "cluster.json"), cluster_doc)

        manifest = {
            "reason": reason,
            "attrs": attrs,
            "time": round(time.time(), 3),
            "iso": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "nodes_captured": sorted(str(e) for e in snapshots),
            "nodes_missing": sorted(str(e) for e in missing),
            "driver_pid": os.getpid(),
        }
        _write_json(os.path.join(bundle, "manifest.json"), manifest)

        # The timeline marker goes out BEFORE the merge below reads the
        # export directory: event() flushes immediately, so the marker is
        # part of the very timeline the bundle embeds. Trigger attrs are
        # folded in first so a colliding key (a trigger named "captured")
        # can never shadow — or TypeError against — the marker's own.
        marker = {k: v for k, v in attrs.items()
                  if isinstance(v, (str, int, float, bool))}
        marker.update(reason=reason, dir=os.path.basename(bundle),
                      captured=len(snapshots), missing=len(missing))
        telemetry.event("cluster/incident", **marker)
        self._merge_timeline(bundle)

        self.captures.append(bundle)
        telemetry.put_status("incident_dir", self.root)
        telemetry.put_status(
            "incidents", [os.path.basename(p) for p in self.captures[-50:]])
        logger.warning("incident bundle (%s) written: %s", reason, bundle)
        return bundle

    def _collect_node_snapshots(self):
        """One snapshot round over the reservation channel: live nodes
        answer within ~a heartbeat interval; dead/partitioned ones are
        reported missing (the KV fallback may still recover them)."""
        if self.server is None:
            return {}
        liveness = self.server.liveness
        snap = liveness.snapshot()
        crashed = self.crashed()
        # A node that published its crash snapshot is dying: it cannot
        # answer, and waiting for it would hold an attempt-failure
        # capture (the error reached the driver before the node's last
        # beat) for the whole budget. The fallback collects it instead.
        responsive = [eid for eid, rec in snap.items()
                      if rec.get("status") in ("alive", "slow")
                      and str(eid) not in crashed]
        timeout = self.node_timeout
        if self.profile_secs > 0:
            # A node answers after its profile window, and a process's
            # first torch.profiler session first initialises the profiler
            # (about 2 s on a CPU host): the budget covers both on top of
            # the heartbeat-bound delivery. The round ends as soon as
            # every node answered.
            timeout += self.profile_secs + PROFILER_START_S
        try:
            return self.server.snapshot_round(
                expected=responsive, timeout=timeout,
                profile_secs=self.profile_secs)
        except Exception:
            logger.warning("snapshot round failed", exc_info=True)
            return {}

    def crashed(self):
        """Executor ids (as strings) whose manager KV holds a crash
        snapshot: the node program published it while raising, before
        its error reached any queue or beat."""
        from tensorflowonspark_tpu_torch import manager as manager_mod

        out = set()
        for meta in self.cluster_info:
            try:
                mgr = manager_mod.connect(
                    tuple(meta["addr"]), bytes.fromhex(meta["authkey"]))
                if mgr.get("crash_snapshot"):
                    out.add(str(meta.get("executor_id")))
            except Exception:  # a dead manager: the liveness status rules
                logger.debug("manager KV probe failed for %s", meta,
                             exc_info=True)
        return out

    def _fallback_from_managers(self, snapshots):
        """For nodes without a channel snapshot: pull the crash snapshot
        (or the last heartbeat-published one) over the manager KV — the
        manager process usually outlives its compute child, so a crashed
        node's ring and stacks survive there. Returns the executor ids
        still missing after the fallback."""
        missing = []
        from tensorflowonspark_tpu_torch import manager as manager_mod

        for meta in self.cluster_info:
            eid = meta.get("executor_id")
            if eid is None or eid in snapshots or str(eid) in {
                    str(k) for k in snapshots}:
                continue
            got = None
            try:
                mgr = manager_mod.connect(
                    tuple(meta["addr"]), bytes.fromhex(meta["authkey"]))
                # pop(): a crash snapshot is one launch's evidence — a
                # later incident in a relaunched job must not re-attach
                # the stale one.
                got = mgr.pop("crash_snapshot") or mgr.get("node_snapshot")
            except Exception:
                logger.debug("manager KV fallback failed for executor %s",
                             eid, exc_info=True)
            if got:
                got = dict(got)
                got.setdefault("node", "node{}".format(eid))
                got["via"] = "manager_kv"
                snapshots[eid] = got
            else:
                missing.append(eid)
        return missing

    def _cluster_evidence(self):
        doc = {"status": telemetry.get_status(),
               "driver_stats": telemetry.node_stats()}
        if self.server is not None:
            liveness = self.server.liveness
            try:
                doc["liveness"] = liveness.snapshot()
                doc["cluster_stats"] = liveness.cluster_stats()
                doc["stragglers"] = liveness.stragglers()
            except Exception:  # a torn-down server
                logger.debug("liveness evidence failed", exc_info=True)
        return doc

    def _merge_timeline(self, bundle):
        """Merged clock-aligned cluster timeline from the span-export
        directory (covers crashed nodes, whose exported spans survive on
        disk): Perfetto trace + text summary inside the bundle."""
        tdir = self.telemetry_dir
        if not tdir or not os.path.isdir(tdir):
            return
        rec = telemetry.get_recorder()
        if rec is not None:
            rec.flush()  # the cluster/incident marker must be readable
        try:
            spans = telemetry.load_spans(tdir)
            if not spans:
                return
            offsets = telemetry.estimate_clock_offsets(spans)
            telemetry.write_trace(
                spans, os.path.join(bundle, "trace.json"), offsets=offsets)
            with open(os.path.join(bundle, "timeline.txt"), "w") as f:
                f.write(telemetry.summarize(spans, offsets=offsets) + "\n")
        except Exception:
            logger.warning("timeline merge failed", exc_info=True)


def local_capture(reason, root=None, min_interval=DEFAULT_MIN_INTERVAL,
                  **attrs):
    """Driver-process-only capture for detectors with no cluster in hand
    (a check in a driver script or a benchmark): always emits the
    rate-limited ``cluster/incident`` event; writes a bundle only when an
    incident root is configured (``root`` argument or the
    ``TFOS_INCIDENT_DIR`` environment variable). Returns the bundle path
    or None."""
    root = root or os.environ.get("TFOS_INCIDENT_DIR")
    if not root:
        key = "<event-only>"
        if not _rate_limited(key, min_interval):
            telemetry.event("cluster/incident", reason=reason,
                            **{k: v for k, v in attrs.items()
                               if isinstance(v, (str, int, float, bool))})
        return None
    rec = IncidentRecorder(root, min_interval=min_interval)
    try:
        return rec.capture(reason, **attrs)
    except Exception:
        logger.warning("local incident capture (%s) failed", reason,
                       exc_info=True)
        return None
