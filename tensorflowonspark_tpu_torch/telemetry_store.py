"""Cluster history plane: heartbeat time-series store, goodput
accounting, and SLO burn-rate monitoring (stdlib-only, driver-side; the
port's copy of the JAX package's ``telemetry_store.py``).

Every earlier observability surface was point-in-time: ``cluster_stats()``
keeps only each node's *last* heartbeat stats, ``/metrics`` is a snapshot,
and the serving histograms cannot answer "what was p95 over the last five
minutes". This module retains the stream:

* :class:`TelemetryStore` — a per-(node, metric) append-only ring fed
  from ``LivenessMonitor.beat(stats=)`` on every heartbeat, with tiered
  downsampling (raw → 10 s → 1 m rollups holding count/sum/min/max/last)
  so an hours-long run fits bounded memory; window queries (``points``,
  ``window_stats``, ``rate``, ``breach_fraction``), fleet-wide histogram
  quantiles (per-node bucket counts summed via
  ``telemetry.merged_quantiles``), and a JSONL export
  (:meth:`TelemetryStore.export` / :func:`load_export`) that
  ``scripts/perf_doctor.py --live`` and ``scripts/obs_report.py`` can
  consume offline.

* :class:`GoodputAccountant` — classifies accounted cluster wall time
  into productive-step / data-wait / checkpoint / compile (bring-up) /
  restart-downtime / other, from the cumulative busy counters
  (``busy_step_s`` / ``busy_wait_s`` / ``busy_ckpt_s``) every heartbeat
  now carries plus the supervisor's downtime marks
  (:func:`downtime_start` / :func:`downtime_end`). Publishes
  ``tfos_goodput`` and the breakdown as gauges, and appends an
  instantaneous ``goodput`` series under the synthetic node
  ``"cluster"`` — a chaos drill's restart dip and recovery read off one
  curve.

* :class:`SLO` / :class:`SLOMonitor` — declarative objectives
  (``"serve_ttft_ms_p95 < 250"``) evaluated over multiple windows: an SLO
  fires only when every window's breach fraction clears its burn
  threshold. A firing emits ``cluster/slo_breach``, bumps
  ``slo_breaches_total``, and triggers the attached
  :class:`~tensorflowonspark_tpu_torch.incident.IncidentRecorder` — every
  SLO breach gets a black-box bundle with the breach marker on its merged
  timeline. Every evaluation pass hands the multi-window state to the
  policy callbacks (``add_policy_callback``) — the serving
  ``Autoscaler``'s burn signal.

The driver enables the plane with :func:`configure` (idempotent —
``cluster.run`` calls :func:`ensure` so supervised relaunches keep ONE
store across attempts); ``LivenessMonitor.beat`` feeds
:func:`get_store` when configured and stays free otherwise.
``render_dashboard`` turns the store into a self-contained HTML page
(inline-SVG sparklines, zero dependencies) served by the driver's
``MetricsServer`` at ``/dashboard``.
"""

import collections
import json
import logging
import os
import threading
import time

from tensorflowonspark_tpu_torch import telemetry

logger = logging.getLogger(__name__)

DEFAULT_RAW_POINTS = 600            # per-(node, metric) raw ring
# (bucket seconds, buckets kept): 10 s x 360 = 1 h, 60 s x 720 = 12 h.
DEFAULT_TIERS = ((10.0, 360), (60.0, 720))
MAX_SERIES = 4096                   # (node, metric) pairs; hard cap

GOODPUT_CATEGORIES = ("productive", "data_wait", "checkpoint",
                      "compile", "restart", "other")

_store = None
_store_lock = threading.Lock()


def configure(**kwargs):
    """Create (and install process-wide) a fresh :class:`TelemetryStore`.
    Replaces any existing store — see :func:`ensure` for the
    keep-if-present form the cluster launcher uses."""
    global _store
    store = TelemetryStore(**kwargs)
    with _store_lock:
        _store = store
    return store


def ensure(**kwargs):
    """The installed store, creating one when absent. ``cluster.run``
    calls this: a supervised job's relaunches must keep feeding ONE
    store, or the goodput curve would forget the history a restart dip
    is measured against."""
    global _store
    with _store_lock:
        if _store is None:
            _store = TelemetryStore(**kwargs)
        return _store


def get_store():
    return _store


def disable():
    """Drop the installed store (test isolation; heartbeats stop being
    retained)."""
    global _store
    with _store_lock:
        _store = None


def downtime_start(reason="restart", ts=None):
    """Mark the start of a cluster-wide downtime window (called by the
    supervisor at failure detection). No-op without a configured store."""
    store = _store
    if store is not None:
        store.goodput.downtime_start(reason=reason,
                                     ts=store.now() if ts is None else ts)


def downtime_end(ts=None):
    """Close the open downtime window (the supervisor calls this once
    the relaunched cluster is rendezvoused)."""
    store = _store
    if store is not None:
        store.goodput.downtime_end(
            ts=store.now() if ts is None else ts)


class _Series:
    """One (node, metric) stream: a raw ring plus per-tier rollup rings.

    A rollup bucket is ``[bucket_start_ts, count, sum, min, max, last]``
    — enough to answer avg/min/max/latest window queries at that tier
    without keeping the raw points. Appends are O(tiers); memory is
    structurally bounded by the deque maxlens.
    """

    __slots__ = ("raw", "rollups", "first_ts")

    def __init__(self, raw_points, tiers):
        self.raw = collections.deque(maxlen=int(raw_points))
        self.rollups = tuple(
            (float(res), collections.deque(maxlen=int(keep)))
            for res, keep in tiers)
        self.first_ts = None

    def append(self, ts, value):
        if self.first_ts is None:
            self.first_ts = ts
        self.raw.append((ts, value))
        for res, ring in self.rollups:
            bucket = ts - (ts % res)
            if ring and ring[-1][0] == bucket:
                b = ring[-1]
                b[1] += 1
                b[2] += value
                if value < b[3]:
                    b[3] = value
                if value > b[4]:
                    b[4] = value
                b[5] = value
            elif not ring or bucket > ring[-1][0]:
                ring.append([bucket, 1, value, value, value, value])
            # else: out-of-order point older than the live bucket — raw
            # keeps it; rollups only roll forward.

    def latest(self):
        if self.raw:
            return self.raw[-1]
        for _, ring in self.rollups:
            if ring:
                b = ring[-1]
                return (b[0], b[5])
        return None

    def points(self, since, until):
        """(ts, value) points covering ``[since, until]`` at the finest
        resolution whose retained data still reaches back to ``since``
        (or to the series' first-ever point, when the series is younger
        than the window) — raw first, then each rollup tier (rollup
        points are bucket averages stamped at the bucket start). Falls
        back to the coarsest tier when nothing covers the window."""
        sources = [[p for p in self.raw]]
        for _, ring in self.rollups:
            sources.append([(b[0], b[2] / b[1]) for b in ring])
        # A source "covers" when nothing retained anywhere is older than
        # its first point: a young series' raw ring holds the full
        # history even though it doesn't reach back to `since`.
        cutoff = max(since, self.first_ts if self.first_ts is not None
                     else until)
        chosen = None
        for pts in sources:
            if pts and pts[0][0] <= cutoff:
                chosen = pts
                break
        if chosen is None:
            # No source reaches back far enough: the longest one wins.
            chosen = max(sources, key=lambda pts:
                         (until - pts[0][0]) if pts else -1.0)
        return [(ts, v) for ts, v in chosen if since <= ts <= until]

    def size(self):
        return len(self.raw) + sum(len(r) for _, r in self.rollups)


class GoodputAccountant:
    """Classifies accounted cluster wall time into the goodput
    categories, from per-node heartbeat deltas.

    Per node, the previous sample's cumulative busy counters
    (``busy_step_s``/``busy_wait_s``/``busy_ckpt_s`` — histogram sums
    the nodes now publish in ``node_stats()``) are differenced against
    the current ones; the interval between the two beats is split:

    * overlap with a marked **downtime window** (the supervisor marks
      failure → relaunch) or a ``hung``/``crashed`` status → ``restart``;
    * no busy counters and no step rate yet → ``compile`` (bring-up:
      interpreter + imports + kernel builds before the first step);
    * otherwise ``productive``/``data_wait``/``checkpoint`` from the
      busy deltas (scaled down if they over-cover the interval — beats
      can land mid-step), the remainder ``other``.

    Restart resets histograms to zero; ``max(0, delta)`` absorbs that,
    so a relaunch cannot produce negative productive time.
    """

    def __init__(self):
        self._nodes = {}            # node -> {"ts", "busy"}
        self.totals = dict.fromkeys(GOODPUT_CATEGORIES, 0.0)
        self.wall = 0.0
        self._open_downtime = None  # (start_ts, reason)
        self._windows = collections.deque(maxlen=64)  # (start, end, reason)

    # -- downtime marks ------------------------------------------------------

    def downtime_start(self, reason="restart", ts=None):
        if self._open_downtime is None:
            self._open_downtime = (float(ts if ts is not None
                                         else time.time()), str(reason))

    def downtime_end(self, ts=None):
        if self._open_downtime is not None:
            start, reason = self._open_downtime
            end = float(ts if ts is not None else time.time())
            if end > start:
                self._windows.append((start, end, reason))
            self._open_downtime = None

    def _downtime_overlap(self, t0, t1):
        d = 0.0
        for a, b, _ in self._windows:
            d += max(0.0, min(t1, b) - max(t0, a))
        if self._open_downtime is not None:
            d += max(0.0, t1 - max(t0, self._open_downtime[0]))
        return min(d, t1 - t0)

    # -- per-beat accounting -------------------------------------------------

    def observe(self, node, stats, status, ts):
        """Account one node's heartbeat interval. Returns ``{"dt",
        "breakdown"}`` for the interval just closed, or None on the
        first beat (nothing to difference yet). Runs on every heartbeat
        (and inside the telemetry_overhead bench's 2% bar), so the body
        stays allocation-light."""
        busy = (stats.get("busy_step_s"), stats.get("busy_wait_s"),
                stats.get("busy_ckpt_s"))
        prev = self._nodes.get(node)
        self._nodes[node] = (ts, busy)
        if prev is None or ts <= prev[0]:
            return None
        prev_ts, prev_busy = prev
        dt = ts - prev_ts
        if status in ("hung", "crashed"):
            down = dt
        elif self._windows or self._open_downtime is not None:
            down = self._downtime_overlap(prev_ts, ts)
        else:
            down = 0.0
        step = wait = ckpt = compile_t = other = 0.0
        live = dt - down
        if live > 0:
            def delta(i):
                b = busy[i]
                if not isinstance(b, (int, float)):
                    return 0.0
                b = float(b)
                a = prev_busy[i]
                a = float(a) if isinstance(a, (int, float)) else 0.0
                # Counter-reset semantics (a relaunched process starts
                # its histograms at zero): a drop means the new total IS
                # the delta accrued since the restart.
                return b if b < a else b - a

            if busy[0] is None and stats.get("steps_per_sec") is None:
                compile_t = live
            else:
                step, wait, ckpt = delta(0), delta(1), delta(2)
                used = step + wait + ckpt
                if used > live:
                    scale = live / used
                    step *= scale
                    wait *= scale
                    ckpt *= scale
                    used = live
                other = live - used
        self.wall += dt
        totals = self.totals
        totals["productive"] += step
        totals["data_wait"] += wait
        totals["checkpoint"] += ckpt
        totals["compile"] += compile_t
        totals["restart"] += down
        totals["other"] += other
        return {"dt": dt, "breakdown": {
            "productive": step, "data_wait": wait, "checkpoint": ckpt,
            "compile": compile_t, "restart": down, "other": other}}

    def goodput(self):
        """Cumulative goodput: productive time over accounted wall time
        (None before any accounted interval)."""
        if self.wall <= 0:
            return None
        return self.totals["productive"] / self.wall

    def summary(self):
        g = self.goodput()
        out = {"wall_s": round(self.wall, 3),
               "goodput": None if g is None else round(g, 4),
               "breakdown_s": {c: round(v, 3)
                               for c, v in self.totals.items()}}
        if self.wall > 0:
            out["fractions"] = {c: round(v / self.wall, 4)
                                for c, v in self.totals.items()}
        return out


class SLO:
    """One declarative SLO: ``metric op threshold`` as an *objective*
    (``"serve_ttft_ms_p95 < 250"`` means the p95 SHOULD stay under 250
    ms; a sample at or past the threshold is a breach).

    ``windows`` is a sequence of ``(window_seconds, burn_fraction)``
    pairs; the monitor fires only when EVERY window's breach fraction
    is at least its burn threshold and each window holds at least
    ``min_points`` samples. ``node=None`` evaluates against every
    node's series merged.
    """

    def __init__(self, metric, op, threshold, node=None,
                 windows=((60.0, 0.5), (300.0, 0.1)), min_points=3,
                 name=None):
        if op not in ("<", ">"):
            raise ValueError("SLO op must be '<' or '>', got {!r}".format(op))
        self.metric = str(metric)
        self.op = op
        self.threshold = float(threshold)
        self.node = node
        self.windows = tuple((float(w), float(b)) for w, b in windows)
        if not self.windows:
            raise ValueError("SLO needs at least one (window, burn) pair")
        self.min_points = int(min_points)
        self.name = name or "{}{}{:g}".format(
            self.metric, self.op, self.threshold)

    @classmethod
    def parse(cls, spec, **overrides):
        """Build an SLO from a dict or a ``"metric < threshold"``
        string (the CLI / config-file form)."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**dict(spec, **overrides))
        parts = str(spec).split()
        if len(parts) != 3 or parts[1] not in ("<", ">"):
            raise ValueError(
                "SLO spec must look like 'metric < threshold', got "
                "{!r}".format(spec))
        return cls(parts[0], parts[1], float(parts[2]), **overrides)

    def breached(self, value):
        """True when ``value`` violates the objective."""
        return value >= self.threshold if self.op == "<" \
            else value <= self.threshold

    def to_dict(self):
        return {"name": self.name, "metric": self.metric, "op": self.op,
                "threshold": self.threshold, "node": self.node,
                "windows": [list(w) for w in self.windows]}


class SLOMonitor:
    """Evaluates a set of :class:`SLO` specs against the store with
    multi-window burn rates; edge-triggered events + incident capture.

    ``evaluate()`` is cheap (a few window scans per SLO) and is called
    from the store's ingest path at most once per ``interval`` seconds,
    so the heartbeat handler never pays more than one evaluation per
    window. A firing emits ``cluster/slo_breach`` (with the per-window
    breach fractions as evidence), appends a ``slo_firing`` step series
    under node ``"cluster"``, and triggers the attached
    :class:`~tensorflowonspark_tpu_torch.incident.IncidentRecorder`
    asynchronously; recovery emits ``cluster/slo_recovered``.
    """

    def __init__(self, store, slos, recorder=None, interval=1.0):
        self.store = store
        self.slos = [SLO.parse(s) for s in slos]
        self.recorder = recorder
        self.interval = float(interval)
        self._firing = {}   # slo name -> since ts
        self._last_eval = 0.0
        self._lock = threading.Lock()
        # Policy callbacks: an SLO burn is an actuation signal (the
        # serving Autoscaler's), not just an alert. Each callback sees every
        # evaluation pass (not just edges — a controller needs the
        # level, and its own hysteresis owns the debouncing).
        self.policy_callbacks = []

    def add_policy_callback(self, fn):
        """Register ``fn(state)`` to run on every evaluation pass, per
        SLO, with ``state = {"slo": SLO, "windows": evidence list,
        "firing": bool, "enough": bool, "now": ts}``. Exceptions are
        swallowed (a broken policy must not take down ingest)."""
        self.policy_callbacks.append(fn)
        return fn

    def maybe_evaluate(self, now=None):
        now = self.store.now() if now is None else float(now)
        with self._lock:
            if now - self._last_eval < self.interval:
                return []
            self._last_eval = now
        return self.evaluate(now=now)

    def evaluate(self, now=None):
        """One full evaluation pass; returns the SLOs that transitioned
        to firing on this pass (each as an evidence dict)."""
        now = self.store.now() if now is None else float(now)
        fired = []
        for slo in self.slos:
            evidence = []
            enough = True
            firing = True
            for window, burn in slo.windows:
                frac, n = self.store.breach_fraction(
                    slo.metric, slo.breached, node=slo.node,
                    window=window, now=now)
                evidence.append({"window_s": window, "burn": burn,
                                 "breach_frac": round(frac, 4), "points": n})
                if n < slo.min_points:
                    enough = False
                if frac < burn:
                    firing = False
            # Policy callbacks see the LEVEL on every pass: effective
            # firing state (held when data is insufficient), the
            # per-window evidence, and the data-sufficiency flag.
            effective = firing if enough else (slo.name in self._firing)
            for fn in self.policy_callbacks:
                try:
                    fn({"slo": slo, "windows": evidence,
                        "firing": effective, "enough": enough,
                        "now": now})
                except Exception:
                    logger.warning("slo policy callback failed",
                                   exc_info=True)
            if not enough:
                # Insufficient data is NOT evidence of health: a firing
                # SLO whose measured plane went completely silent (the
                # worst case) must HOLD, not auto-recover; a quiet SLO
                # stays quiet. State transitions need data.
                continue
            was = slo.name in self._firing
            if firing and not was:
                self._firing[slo.name] = now
                attrs = {"slo": slo.name, "metric": slo.metric,
                         "threshold": slo.threshold,
                         "breach_frac": evidence[0]["breach_frac"]}
                telemetry.event("cluster/slo_breach", **attrs)
                telemetry.inc("slo_breaches_total")
                logger.warning("SLO breach: %s (windows: %s)",
                               slo.name, evidence)
                self.store.append("cluster", "slo_firing",
                                  float(len(self._firing)), ts=now)
                if self.recorder is not None:
                    try:
                        self.recorder.trigger("slo_breach", **attrs)
                    except Exception:  # alerting must outlive capture
                        logger.warning("slo incident trigger failed",
                                       exc_info=True)
                fired.append({"slo": slo.to_dict(), "windows": evidence,
                              "since": now})
            elif was and not firing:
                del self._firing[slo.name]
                telemetry.event("cluster/slo_recovered", slo=slo.name,
                                metric=slo.metric)
                self.store.append("cluster", "slo_firing",
                                  float(len(self._firing)), ts=now)
        telemetry.set_gauge("slo_firing", float(len(self._firing)))
        return fired

    def status(self):
        """Per-SLO snapshot for ``/statusz`` / the dashboard."""
        now = self.store.now()
        out = []
        for slo in self.slos:
            windows = []
            for window, burn in slo.windows:
                frac, n = self.store.breach_fraction(
                    slo.metric, slo.breached, node=slo.node,
                    window=window, now=now)
                windows.append({"window_s": window, "burn": burn,
                                "breach_frac": round(frac, 4),
                                "points": n})
            out.append({**slo.to_dict(), "windows": windows,
                        "firing": slo.name in self._firing})
        return out


# Non-numeric heartbeat keys the store retains verbatim (latest per
# node). Whitelisted so an arbitrary structured payload can't grow the
# store; today just the disaggregated router's prefix-affinity digest.
EXTRA_STAT_KEYS = frozenset({"serve_prefix_digest"})


class TelemetryStore:
    """Driver-side time-series ring over the heartbeat stats stream."""

    def __init__(self, raw_points=DEFAULT_RAW_POINTS, tiers=DEFAULT_TIERS,
                 max_series=MAX_SERIES, clock=time.time):
        self.raw_points = int(raw_points)
        self.tiers = tuple((float(r), int(k)) for r, k in tiers)
        self.max_series = int(max_series)
        self._clock = clock
        # Plain Lock (not RLock — measurably cheaper on the per-beat
        # path); internal callees take the ``locked=True`` form.
        self._lock = threading.Lock()
        self._series = {}       # (node, metric) -> _Series
        self._last_ingest = {}  # node -> ts
        # (node, family) -> {"last": cumulative hist_export, "deltas":
        # deque[(ts, counts, sum, count)] of per-beat increments,
        # "exemplars": {le: exemplar}} — quantiles interpolate over the
        # WINDOWED deltas (a 10-hour healthy cumulative histogram would
        # otherwise bury a fresh latency regression under old mass).
        self._hists = {}
        self._hist_deltas_kept = 240
        # Per-request trace summaries: trace id -> merged
        # summary dict. Engines publish terminal summaries and the
        # fleet router its route summaries via node_stats()["traces"];
        # ingest merges them by trace id (one request's route half and
        # engine half arrive on different nodes' beats). Insertion
        # order doubles as recency for the bounded eviction.
        self._traces = collections.OrderedDict()
        self._traces_kept = 512
        # Continuous-profiling digests: node -> {"latest": digest,
        # "baseline": first-seen digest, "ts": ingest time}. The baseline
        # is the diff target for "what grew on this node since it was
        # healthy"; bounded by node count (LRU-evicted).
        self._profiles = collections.OrderedDict()
        self._profiles_kept = 64
        # Whitelisted non-numeric heartbeat extras: the
        # series store is floats-only, but the disaggregated router
        # needs the remote prefix-index digest verbatim. node -> {key:
        # (ts, value)}; bounded by the whitelist times node count.
        self._extras = {}
        self._gauges_published = 0.0
        self.goodput = GoodputAccountant()
        self.slo_monitor = None
        self.created = self.now()

    def now(self):
        return float(self._clock())

    # -- wiring --------------------------------------------------------------

    def set_slos(self, slos, recorder=None, interval=1.0):
        """Install (replacing) the SLO monitor; returns it. ``slos`` are
        :class:`SLO` objects, dicts, or ``"metric < x"`` strings."""
        self.slo_monitor = SLOMonitor(self, slos, recorder=recorder,
                                      interval=interval) if slos else None
        return self.slo_monitor


    # -- ingest --------------------------------------------------------------

    def append(self, node, metric, value, ts=None):
        """Append one point to a single series (series are created on
        first use, up to ``max_series``)."""
        ts = self.now() if ts is None else float(ts)
        with self._lock:
            self._append_locked(str(node), str(metric), ts, float(value))

    def _append_locked(self, node, metric, ts, value):
        key = (node, metric)
        series = self._series.get(key)
        if series is None:
            if len(self._series) >= self.max_series:
                return  # hard cap: never let a metric-name explosion OOM
            series = self._series[key] = _Series(self.raw_points, self.tiers)
        series.append(ts, value)

    def ingest(self, node, stats, status=None, ts=None):
        """One heartbeat's stats dict into the store: every numeric key
        becomes a point on that node's series, the histogram exports
        feed the fleet-quantile merge, the goodput accountant closes
        the node's interval, and the SLO monitor gets a (rate-limited)
        evaluation pass. This is the call ``LivenessMonitor.beat``
        makes on every stats-carrying heartbeat."""
        if not isinstance(stats, dict):
            return
        node = str(node)
        ts = self.now() if ts is None else float(ts)
        with self._lock:
            self._last_ingest[node] = ts
            hists = stats.get("hists")
            if isinstance(hists, dict):
                for fam, h in hists.items():
                    if isinstance(h, dict) and h.get("counts"):
                        self._ingest_hist_locked(node, str(fam), h, ts)
            traces = stats.get("traces")
            if isinstance(traces, list):
                for summary in traces:
                    self._ingest_trace_locked(node, summary, ts)
            prof = stats.get("profile")
            if isinstance(prof, dict):
                self._ingest_profile_locked(node, prof, ts)
            for key, value in stats.items():
                if isinstance(value, (int, float)) \
                        and not isinstance(value, bool):
                    self._append_locked(node, str(key), ts, float(value))
                elif key in EXTRA_STAT_KEYS and value is not None:
                    self._extras.setdefault(node, {})[str(key)] = (ts, value)
            interval = self.goodput.observe(node, stats, status, ts)
            if interval is not None and interval["dt"] > 0:
                bd = interval["breakdown"]
                self._append_locked(
                    "cluster", "goodput", ts,
                    bd["productive"] / interval["dt"])
                # Gauge publication is rate-limited to ~1/s: seven
                # locked registry writes per heartbeat would show up in
                # the telemetry_overhead bench's 2% bar for nothing —
                # cumulative fractions barely move between beats.
                g = self.goodput.goodput()
                if g is not None and ts - self._gauges_published >= 1.0:
                    self._gauges_published = ts
                    telemetry.set_gauge("goodput", g)
                    for cat, v in self.goodput.totals.items():
                        telemetry.set_gauge(
                            "goodput_{}_frac".format(cat),
                            v / self.goodput.wall)
            # Fleet-wide percentiles as first-class series: queryable
            # history ("p95 over the last 5 min") and the SLO monitor's
            # usual targets.
            if self._hists:
                for fam in telemetry.HB_HIST_FAMILIES:
                    if (node, fam) in self._hists:
                        qs = self.fleet_quantiles(fam, locked=True)
                        if qs:
                            base = fam.replace("_seconds", "_ms")
                            for q, v in zip(("p50", "p95", "p99"), qs):
                                self._append_locked(
                                    "cluster", "{}_{}".format(base, q),
                                    ts, v * 1e3)
        monitor = self.slo_monitor
        if monitor is not None:
            monitor.maybe_evaluate(now=ts)

    def _ingest_trace_locked(self, node, summary, ts):
        """Merge one heartbeat-delivered trace summary. A request's
        route half (fleet router) and engine half (terminal state,
        segment sums) arrive on different nodes' beats; merging by
        trace id makes ``/traces`` show the whole path."""
        if not isinstance(summary, dict):
            return
        trace = summary.get("trace")
        if not trace:
            return
        trace = str(trace)
        doc = self._traces.get(trace)
        if doc is None:
            doc = self._traces[trace] = {"trace": trace, "nodes": []}
        else:
            self._traces.move_to_end(trace)
        for key, value in summary.items():
            if key != "trace":
                doc[key] = value
        if node not in doc["nodes"]:
            doc["nodes"].append(node)
        doc["ts"] = ts
        while len(self._traces) > self._traces_kept:
            self._traces.popitem(last=False)


    # -- queries -------------------------------------------------------------


    def _ingest_profile_locked(self, node, digest, ts):
        """Retain one heartbeat-delivered profile digest: the latest
        per node plus the FIRST ever seen (the node's baseline window —
        ``/profilez?node=`` answers diffs against it)."""
        if not isinstance(digest.get("top"), list):
            return
        entry = self._profiles.get(node)
        if entry is None:
            entry = self._profiles[node] = {"baseline": digest}
        else:
            self._profiles.move_to_end(node)
        entry["latest"] = digest
        entry["ts"] = ts
        while len(self._profiles) > self._profiles_kept:
            self._profiles.popitem(last=False)

    # -- queries -------------------------------------------------------------

    def profile(self, node, which="latest"):
        """One node's retained profile digest (``latest`` or
        ``baseline``); None when the node never shipped one."""
        with self._lock:
            entry = self._profiles.get(str(node))
            if entry is None:
                return None
            doc = entry.get(which)
            return dict(doc) if isinstance(doc, dict) else None

    def profiles(self):
        """Every node's latest digest + ingest stamp, newest-ingest
        last — the ``/profilez`` fleet view and the dashboard panel."""
        with self._lock:
            return {node: {"latest": dict(e["latest"]),
                           "baseline": dict(e["baseline"]),
                           "ts": e.get("ts")}
                    for node, e in self._profiles.items()
                    if e.get("latest")}

    def trace(self, trace_id):
        """The merged summary for one trace id (None when unknown or
        already evicted)."""
        with self._lock:
            doc = self._traces.get(str(trace_id))
            return dict(doc) if doc is not None else None

    def slowest_traces(self, n=20, window=3600.0):
        """The ``n`` slowest completed requests ingested in the last
        ``window`` seconds, slowest first — the ``/traces`` API's
        top-N view. Only summaries carrying ``total_ms`` (an engine's
        terminal half) qualify; route-only summaries whose engine half
        never arrived are placement records, not latency ones."""
        cutoff = self.now() - float(window)
        with self._lock:
            docs = [dict(d) for d in self._traces.values()
                    if d.get("ts", 0) >= cutoff
                    and isinstance(d.get("total_ms"), (int, float))]
        docs.sort(key=lambda d: -d["total_ms"])
        return docs[:int(n)]

    def nodes(self):
        with self._lock:
            return sorted({n for n, _ in self._series})

    def metrics(self, node=None):
        with self._lock:
            return sorted({m for n, m in self._series
                           if node is None or n == str(node)})

    def _series_for(self, metric, node=None):
        metric = str(metric)
        if node is not None:
            s = self._series.get((str(node), metric))
            return [(str(node), s)] if s is not None else []
        return [(n, s) for (n, m), s in self._series.items() if m == metric]

    def latest(self, metric, node=None):
        """Newest (ts, value) for the metric — across all nodes when
        ``node`` is None (the newest wins). None when never recorded."""
        with self._lock:
            best = None
            for _, s in self._series_for(metric, node):
                p = s.latest()
                if p is not None and (best is None or p[0] > best[0]):
                    best = p
            return best

    def latest_extra(self, key, node):
        """Newest retained non-numeric heartbeat value for ``key`` on
        ``node`` (see ``EXTRA_STAT_KEYS``); None when never shipped."""
        with self._lock:
            entry = self._extras.get(str(node), {}).get(str(key))
            return entry[1] if entry is not None else None

    def points(self, metric, node=None, window=300.0, now=None):
        """Time-ordered (ts, value) points over the trailing ``window``
        seconds, merged across nodes when ``node`` is None."""
        now = self.now() if now is None else float(now)
        since = now - float(window)
        with self._lock:
            out = []
            for _, s in self._series_for(metric, node):
                out.extend(s.points(since, now))
        out.sort(key=lambda p: p[0])
        return out

    def node_points(self, metric, window=300.0, now=None):
        """``{node: [(ts, value), ...]}`` over the window — the
        dashboard's per-node polyline form."""
        now = self.now() if now is None else float(now)
        since = now - float(window)
        with self._lock:
            return {n: s.points(since, now)
                    for n, s in self._series_for(metric, None)}

    def window_stats(self, metric, node=None, window=300.0, now=None):
        """``{count, min, max, avg, latest}`` over the window, or None
        with no points."""
        pts = self.points(metric, node=node, window=window, now=now)
        if not pts:
            return None
        values = [v for _, v in pts]
        return {"count": len(values), "min": min(values),
                "max": max(values),
                "avg": sum(values) / len(values), "latest": values[-1]}

    def rate(self, metric, node=None, window=300.0, now=None):
        """Per-second rate of a (monotonic) counter over the window:
        ``(last - first) / (t_last - t_first)``. None without at least
        two points or with no elapsed time."""
        pts = self.points(metric, node=node, window=window, now=now)
        if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
            return None
        return (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])

    def breach_fraction(self, metric, breached, node=None, window=60.0,
                        now=None):
        """``(fraction_of_points_breaching, n_points)`` over the window
        — the SLO monitor's burn-rate primitive. ``breached`` is a
        ``value -> bool`` predicate."""
        pts = self.points(metric, node=node, window=window, now=now)
        if not pts:
            return 0.0, 0
        bad = sum(1 for _, v in pts if breached(v))
        return bad / len(pts), len(pts)

    def _ingest_hist_locked(self, node, family, h, ts):
        """Difference one node's cumulative bucket export against its
        previous one (counter-reset aware, like the goodput busy
        deltas) and retain the per-beat increment — windowed fleet
        quantiles interpolate over these, so a fresh regression is not
        buried under hours of healthy cumulative mass."""
        entry = self._hists.get((node, family))
        if entry is None:
            entry = self._hists[(node, family)] = {
                "last": None, "exemplars": {},
                "deltas": collections.deque(maxlen=self._hist_deltas_kept),
            }
        prev = entry["last"]
        counts = h.get("counts")
        if (prev is not None and prev.get("bounds") == h.get("bounds")
                and len(prev["counts"]) == len(counts)):
            d = [int(c) - int(p) for c, p in zip(counts, prev["counts"])]
            if any(v < 0 for v in d):  # relaunch reset the histograms
                d = [int(c) for c in counts]
                dn = int(h.get("count") or sum(d))
                dsum = float(h.get("sum") or 0.0)
            else:
                dn = int(h.get("count") or 0) - int(prev.get("count") or 0)
                dsum = float(h.get("sum") or 0.0) - \
                    float(prev.get("sum") or 0.0)
        else:
            d = [int(c) for c in counts]
            dn = int(h.get("count") or sum(d))
            dsum = float(h.get("sum") or 0.0)
        if dn > 0:
            entry["deltas"].append((ts, d, dsum, dn))
        entry["last"] = h
        ex = h.get("exemplars")
        if isinstance(ex, dict):
            entry["exemplars"].update(ex)

    def fleet_quantiles(self, family, qs=(0.5, 0.95, 0.99), locked=False,
                        window=300.0, now=None):
        """Cluster-wide quantiles of a histogram family over the
        trailing ``window``: per-node per-beat bucket-count DELTAS
        inside the window are summed before interpolation
        (``telemetry.merged_quantiles``) — a true recent fleet
        distribution, not an average of per-node quantiles and not
        diluted by a long process's cumulative history. Degrades to the
        cumulative exports when no windowed increments exist yet."""
        def _collect():
            now_ts = self.now() if now is None else float(now)
            since = now_ts - float(window)
            windowed = []
            cumulative = []
            for (n, f), entry in self._hists.items():
                if f != family or entry["last"] is None:
                    continue
                bounds = entry["last"].get("bounds")
                cumulative.append(entry["last"])
                summed = None
                dsum = 0.0
                dn = 0
                for t, d, s, c in entry["deltas"]:
                    if t < since:
                        continue
                    if summed is None:
                        summed = list(d)
                    else:
                        summed = [a + b for a, b in zip(summed, d)]
                    dsum += s
                    dn += c
                if summed is not None and dn > 0:
                    windowed.append({"bounds": bounds, "counts": summed,
                                     "sum": dsum, "count": dn})
            return windowed or cumulative

        if locked:
            hists = _collect()
        else:
            with self._lock:
                hists = _collect()
        return telemetry.merged_quantiles(hists, qs)

    def exemplars(self, family):
        """Merged bucket exemplars for a histogram family across every
        node's heartbeat exports: ``{le: exemplar dict}`` (newest per
        bucket wins) — how the driver's dashboard links a bad fleet
        bucket to a request trace recorded on another host."""
        with self._lock:
            out = {}
            for (n, f), entry in self._hists.items():
                if f == family:
                    for le, ex in entry["exemplars"].items():
                        out[le] = dict(ex, node=n)
            return out

    def hist_families(self):
        with self._lock:
            return sorted({f for _, f in self._hists})

    def last_ingest(self, node):
        with self._lock:
            return self._last_ingest.get(str(node))

    def stale_nodes(self, threshold=15.0, now=None):
        """Nodes whose last ingest is older than ``threshold`` seconds
        — the dashboard greys their series instead of plotting a frozen
        flat line."""
        now = self.now() if now is None else float(now)
        with self._lock:
            return sorted(n for n, ts in self._last_ingest.items()
                          if now - ts > float(threshold))

    def approx_points(self):
        """Total retained points across every series and tier — the
        number the bounded-memory test pins."""
        with self._lock:
            return sum(s.size() for s in self._series.values())

    # -- export / spill ------------------------------------------------------

    def export(self, path):
        """Spill the store to JSONL: one ``meta`` line (nodes, goodput
        summary, SLO status), then one line per (node, metric) series
        carrying the raw ring and every rollup tier. Written atomically
        (tmp + rename) so a concurrent reader never sees a torn spill.
        Consumed by :func:`load_export` / ``perf_doctor --live``."""
        path = os.fspath(path)
        # Meta evidence BEFORE taking the series lock: slo_monitor
        # .status() re-enters the store (breach_fraction -> points), and
        # the lock is deliberately non-reentrant.
        meta = {
            "type": "meta", "exported": self.now(),
            "goodput": self.goodput.summary(),
            "slo": (self.slo_monitor.status()
                    if self.slo_monitor is not None else None),
        }
        with self._lock:
            meta["nodes"] = sorted({n for n, _ in self._series})
            lines = [json.dumps(meta)]
            for (node, metric), s in sorted(self._series.items()):
                lines.append(json.dumps({
                    "type": "series", "node": node, "metric": metric,
                    "raw": [[round(t, 3), v] for t, v in s.raw],
                    "rollups": {
                        str(int(res)): [[round(b[0], 3), b[1],
                                         round(b[2], 6), b[3], b[4], b[5]]
                                        for b in ring]
                        for res, ring in s.rollups},
                }))
        tmp = "{}.tmp.{}".format(path, os.getpid())
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + "\n")
        os.replace(tmp, path)
        return path


def load_export(path):
    """Read a store spill back: ``(meta, {(node, metric): [(ts, v),
    ...]})`` — each series reconstructed at the best retained
    resolution (coarse rollups for the old history, raw for the tail),
    time-ordered and de-duplicated."""
    meta = {}
    series = {}
    with open(os.fspath(path)) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue  # torn tail of a crashed writer
            if doc.get("type") == "meta":
                meta = doc
            elif doc.get("type") == "series":
                # Finest source first (raw, then ascending rollup
                # tiers); each coarser tier contributes only the
                # history OLDER than what the finer ones retain, so
                # bucket-start stamps never interleave with raw points
                # covering the same span.
                rollups = doc.get("rollups") or {}
                levels = [(0.0, [(float(t), float(v))
                                 for t, v in doc.get("raw") or ()])]
                for res in sorted(rollups, key=float):
                    levels.append((float(res), [
                        (float(b[0]), float(b[2]) / max(1, int(b[1])))
                        for b in rollups[res]]))
                out = []
                cutoff = float("inf")
                for res, pts in levels:
                    # A rollup bucket joins only when its whole span
                    # [t, t+res) predates the finer history already
                    # kept — no double-counting at the seam.
                    kept = [(t, v) for t, v in pts if t + res <= cutoff]
                    if kept:
                        cutoff = kept[0][0]
                        out = kept + out
                series[(str(doc.get("node")), str(doc.get("metric")))] = out
    return meta, series


# ---------------------------------------------------------------------------
# Dashboard rendering (self-contained HTML + inline SVG; zero deps)
# ---------------------------------------------------------------------------

_DASH_CSS = """
body{font-family:ui-monospace,monospace;background:#111;color:#ddd;
margin:1.2em}
h1{font-size:1.1em} h2{font-size:0.95em;margin:1.2em 0 0.3em}
table{border-collapse:collapse;font-size:0.85em}
td,th{border:1px solid #333;padding:2px 8px;text-align:left}
.firing{color:#f55;font-weight:bold} .ok{color:#6c6}
.chart{display:inline-block;margin:4px 10px 4px 0;vertical-align:top}
.chart .t{font-size:0.75em;color:#aaa}
.stale{color:#666}
svg{background:#1a1a1a;border:1px solid #333}
polyline{fill:none;stroke-width:1.5}
polyline.live{stroke:#4af} polyline.stale{stroke:#555;stroke-dasharray:3 3}
polyline.good{stroke:#6c6}
"""

_SPARK_W, _SPARK_H = 240, 48
_DASH_MAX_CHARTS = 48


def _sparkline(points, css="live", lo=None, hi=None, t0=None, t1=None):
    """Inline-SVG polyline for one series (empty string with <2 pts)."""
    if len(points) < 2:
        return ""
    ts = [p[0] for p in points]
    vs = [p[1] for p in points]
    t0 = min(ts) if t0 is None else t0
    t1 = max(ts) if t1 is None else t1
    lo = min(vs) if lo is None else lo
    hi = max(vs) if hi is None else hi
    tspan = (t1 - t0) or 1.0
    vspan = (hi - lo) or 1.0
    coords = " ".join(
        "{:.1f},{:.1f}".format(
            (t - t0) / tspan * (_SPARK_W - 4) + 2,
            (_SPARK_H - 4) - (v - lo) / vspan * (_SPARK_H - 8) + 2)
        for t, v in points)
    return ('<svg width="{w}" height="{h}"><polyline class="{c}" '
            'points="{p}"/></svg>').format(
                w=_SPARK_W, h=_SPARK_H, c=css, p=coords)


def _esc(text):
    return (str(text).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def render_dashboard(store, cluster_stats=None, window=600.0,
                     stale_after=15.0, title="tfos cluster dashboard"):
    """The ``/dashboard`` page: goodput curve, SLO table, fleet
    percentiles, and one sparkline chart per (metric, node) with stale
    nodes greyed out (dashed) instead of plotting a frozen flat line.
    Self-contained HTML — inline CSS + SVG, no scripts, no external
    fetches — so it renders from an air-gapped ops box."""
    now = store.now()
    stale = set(store.stale_nodes(threshold=stale_after, now=now))
    cluster_stats = cluster_stats or {}
    for eid, entry in cluster_stats.items():
        if isinstance(entry, dict) and entry.get("status") not in (
                "alive", "slow", None):
            stale.add(str(eid))
    parts = ["<!doctype html><html><head><meta charset='utf-8'>",
             "<meta http-equiv='refresh' content='5'>",
             "<title>{}</title><style>{}</style></head><body>".format(
                 _esc(title), _DASH_CSS),
             "<h1>{}</h1>".format(_esc(title)),
             "<p class='t'>window {:.0f}s &middot; {} node(s)"
             "{}</p>".format(
                 window, len(store.nodes()),
                 " &middot; stale: {}".format(
                     _esc(", ".join(sorted(stale)))) if stale else "")]

    # Goodput.
    gsum = store.goodput.summary()
    if gsum.get("goodput") is not None:
        parts.append("<h2>goodput</h2>")
        gpts = store.points("goodput", node="cluster", window=window,
                            now=now)
        parts.append("<div class='chart'>{}<div class='t'>goodput "
                     "(now {:.2f})</div></div>".format(
                         _sparkline(gpts, css="good", lo=0.0, hi=1.0,
                                    t0=now - window, t1=now),
                         gsum["goodput"]))
        fr = gsum.get("fractions") or {}
        parts.append("<table><tr>{}</tr><tr>{}</tr></table>".format(
            "".join("<th>{}</th>".format(_esc(c))
                    for c in GOODPUT_CATEGORIES),
            "".join("<td>{:.1%}</td>".format(fr.get(c, 0.0))
                    for c in GOODPUT_CATEGORIES)))

    # SLOs.
    monitor = store.slo_monitor
    if monitor is not None and monitor.slos:
        parts.append("<h2>SLOs</h2><table><tr><th>slo</th><th>state</th>"
                     "<th>windows (breach frac / burn)</th></tr>")
        for st in monitor.status():
            wins = " &middot; ".join(
                "{:.0f}s: {:.0%}/{:.0%}".format(
                    w["window_s"], w["breach_frac"], w["burn"])
                for w in st["windows"])
            parts.append(
                "<tr><td>{}</td><td class='{}'>{}</td><td>{}</td>"
                "</tr>".format(
                    _esc(st["name"]),
                    "firing" if st["firing"] else "ok",
                    "FIRING" if st["firing"] else "ok", wins))
        parts.append("</table>")

    # Fleet-wide percentiles (merged bucket counts).
    fams = store.hist_families()
    if fams:
        parts.append("<h2>fleet percentiles (merged buckets)</h2>"
                     "<table><tr><th>family</th><th>p50</th><th>p95</th>"
                     "<th>p99</th></tr>")
        for fam in fams:
            qs = store.fleet_quantiles(fam)
            if qs:
                parts.append(
                    "<tr><td>{}</td>{}</tr>".format(
                        _esc(fam), "".join(
                            "<td>{:.1f} ms</td>".format(v * 1e3)
                            for v in qs)))
        parts.append("</table>")

    # Tail attribution: the slowest requests the heartbeat
    # plane delivered, with their segment sums — "what dominates the
    # tail" without leaving the dashboard.
    slow = store.slowest_traces(8, window=window)
    if slow:
        parts.append("<h2>slowest requests (tail attribution)</h2>"
                     "<table><tr><th>trace</th><th>engine</th>"
                     "<th>state</th><th>total</th><th>queue</th>"
                     "<th>ttft</th><th>preempts</th><th>path</th>"
                     "</tr>")
        for doc in slow:
            def _cell(key, fmt="{:.0f} ms"):
                v = doc.get(key)
                return fmt.format(v) if isinstance(
                    v, (int, float)) else "&mdash;"
            path = []
            if doc.get("failover"):
                path.append("failover")
            if doc.get("affinity"):
                path.append("affinity")
            parts.append(
                "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                "<td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                "</tr>".format(
                    _esc(str(doc.get("trace"))),
                    _esc(str(doc.get("engine", "—"))),
                    _esc(str(doc.get("state", "?"))),
                    _cell("total_ms"), _cell("queue_ms"),
                    _cell("ttft_ms"),
                    int(doc.get("preempts", 0)),
                    _esc(", ".join(path) or "direct")))
        parts.append("</table>")

    # Continuous profiling: the driver's own live flame
    # panel (inline SVG, still script-free) plus every node's
    # heartbeat-delivered top-frame digest — "which code is hot, per
    # node" without leaving the dashboard. Full folded stacks are one
    # hop away on each node's /profilez.
    try:
        from tensorflowonspark_tpu_torch.telemetry import profiling

        prof_nodes = store.profiles()
        sampler = profiling.get_sampler()
        if prof_nodes or (sampler is not None and sampler.running()):
            parts.append("<h2>continuous profile</h2>")
        if sampler is not None and sampler.running():
            win = sampler.best_window()
            svg = profiling.flame_svg(win) if win else ""
            if svg:
                parts.append(
                    "<div class='chart'>{}<div class='t'>this process "
                    "&middot; window {} &middot; {} samples &middot; "
                    "duty {:.2%}</div></div>".format(
                        svg, win["id"], win["samples"],
                        sampler.duty_cycle()))
        if prof_nodes:
            parts.append(
                "<table><tr><th>node</th><th>top frames (self% / "
                "total%)</th><th>samples</th></tr>")
            for node in sorted(prof_nodes):
                entry = prof_nodes[node]
                digest = entry["latest"]
                samples = max(1, int(digest.get("samples") or 1))
                frames = " &middot; ".join(
                    "{} {:.0%}/{:.0%}".format(
                        _esc(row[0]), row[1] / samples,
                        row[2] / samples)
                    for row in digest.get("top", ())[:5]
                    if not str(row[0]).startswith("thread:"))
                parts.append(
                    "<tr><td>{}{}</td><td>{}</td><td>{}</td>"
                    "</tr>".format(
                        _esc(node),
                        " <span class='stale'>(stale)</span>"
                        if node in stale else "",
                        frames or "&mdash;", samples))
            parts.append("</table>")
    except Exception:
        logger.debug("dashboard profile panel failed", exc_info=True)

    # Per-metric charts, one polyline chart per (metric, node).
    parts.append("<h2>series</h2>")
    charts = 0
    for metric in store.metrics():
        if charts >= _DASH_MAX_CHARTS:
            parts.append("<p class='t'>({} more metric(s) not shown; "
                         "query /timeseries)</p>".format(
                             len(store.metrics()) - charts))
            break
        by_node = store.node_points(metric, window=window, now=now)
        drawn = False
        for node in sorted(by_node):
            pts = by_node[node]
            if len(pts) < 2:
                continue
            is_stale = node in stale
            spark = _sparkline(pts, css="stale" if is_stale else "live",
                               t0=now - window, t1=now)
            if not spark:
                continue
            drawn = True
            parts.append(
                "<div class='chart'>{}<div class='t{}'>{} &middot; "
                "node {}{} &middot; last {:.4g}</div></div>".format(
                    spark, " stale" if is_stale else "", _esc(metric),
                    _esc(node), " (stale)" if is_stale else "",
                    pts[-1][1]))
        if drawn:
            charts += 1
    parts.append("</body></html>")
    return "\n".join(parts)


