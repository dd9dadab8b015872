"""Cluster-wide telemetry plane: spans, counters/gauges, node stats (the
port's copy of the JAX package's ``telemetry/__init__.py``).

The continuous sampling profiler (``telemetry/profiling.py``) is not
ported (ROADMAP A12): :func:`configure` raises when ``TFOS_PROFILING``
asks for it explicitly, and heartbeats carry no profile digest.

The reference's observability was TensorBoard spawned on the chief plus
stdout (SURVEY.md §5.1/§5.5) — nothing correlated driver-side events
(rendezvous, restarts, checkpoint commits) with per-node step timing, and
diagnosing a hung node meant SSH. This module is the shared instrumentation
substrate every layer records into:

* **Structured spans** — ``with telemetry.span("checkpoint/save", step=3):``
  records trace/span/parent ids, the wall clock at entry and a monotonic
  duration, into a bounded in-process ring buffer (the "flight recorder")
  and, when configured, a per-node JSONL file under
  ``<export_dir>/<node_id>.jsonl``. Span recording is OFF until
  :func:`configure` is called: the disabled ``span()`` returns one shared
  no-op context manager, so uninstrumented-by-choice processes pay a dict
  build and a None check per call site and nothing else (the
  ``telemetry_overhead`` bench pins this).

* **Counters/gauges** — always-on process metrics (a locked dict write per
  update). The instrumented layers publish the hot numbers here:
  ``train_step``/``train_steps_per_sec``/``train_data_wait_frac``
  (:func:`step_tick`), ``prefetch_depth`` + producer-stall counters
  (train/prefetch.py), ``feed_wait_seconds`` (feed.py),
  ``checkpoint_last_step`` (train/checkpoint.py), ``profiler_port``
  (train/profiler.py). :func:`prometheus_text` renders the registry in
  Prometheus text exposition format for ``MetricsServer``'s ``/metrics``.

* **Histograms** — :func:`observe` records latency distributions into
  fixed log-bucket histograms (``train_step_seconds``,
  ``train_data_wait_seconds``, ``feed_batch_wait_seconds``,
  ``checkpoint_save_seconds``/``_commit_seconds``,
  ``decode_token_seconds``), rendered as Prometheus
  ``_bucket``/``_sum``/``_count`` families; :func:`hist_quantiles`
  estimates p50/p95/p99 from the buckets and :func:`node_stats`
  publishes them on every heartbeat.

* **Node stats** — :func:`node_stats` folds the reserved gauges plus the
  process RSS into one compact dict. ``node.HeartbeatSender`` attaches it
  to every ``HB`` message, so the driver's ``LivenessMonitor
  .cluster_stats()`` shows "stuck at step N with an empty prefetch queue"
  without SSH-ing into an executor.

Everything here is stdlib-only and import-cheap on purpose: reservation,
node, feed, trainer, prefetch, checkpoint, and supervisor all import it at
module scope.
"""

import bisect
import collections
import itertools
import json
import logging
import os
import threading
import time
import uuid

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Span recording (flight recorder + optional JSONL export)
# ---------------------------------------------------------------------------

_recorder = None            # process-global Recorder; None = spans disabled
_recorder_lock = threading.Lock()
_tls = threading.local()    # per-thread open-span stack (parent linkage)

DEFAULT_CAPACITY = 512
DEFAULT_ROTATE_BYTES = 64 * 1024 * 1024
DEFAULT_MAX_SEGMENTS = 8


class Recorder:
    """Bounded in-process span ring + optional per-node JSONL exporter.

    The ring (``capacity`` newest completed spans) is the flight recorder
    ``/statusz`` serves; the JSONL file is the durable per-node stream
    (one JSON span per line). Export writes go
    through a buffered stream flushed every ``flush_every`` records or
    ``flush_secs`` seconds, whichever first — a write syscall per span
    would gate fast step loops (the <2% overhead bar). Rare one-off
    markers (:func:`event` — faults, restarts, resumes) flush
    immediately, a clean interpreter exit flushes the buffer, and a
    SIGKILL loses at most one flush window of the routine stream.

    Export files are size-rotated: past ``rotate_bytes`` the live
    ``<node>.jsonl`` rolls to ``<node>.jsonl.1`` (older segments shift
    to ``.2`` … up to ``max_segments``, the oldest dropped), so a
    week-long chaos/soak run is disk-bounded at
    ``(max_segments + 1) * rotate_bytes`` per node instead of filling
    the volume.
    """

    def __init__(self, node_id=None, capacity=DEFAULT_CAPACITY,
                 export_dir=None, flush_every=32, flush_secs=2.0,
                 rotate_bytes=DEFAULT_ROTATE_BYTES,
                 max_segments=DEFAULT_MAX_SEGMENTS):
        self.node_id = str(node_id if node_id is not None else os.getpid())
        self._ring = collections.deque(maxlen=max(1, int(capacity)))
        # One trace per process lifetime: a relaunched node gets a fresh
        # trace id in the same per-node file, which is exactly how the
        # merged timeline distinguishes launch N from launch N+1.
        self.trace_id = uuid.uuid4().hex[:16]
        self._ids = itertools.count(1)
        self._pid = os.getpid()
        self._flush_every = max(1, int(flush_every))
        self._flush_secs = float(flush_secs)
        self._unflushed = 0
        self._last_flush = time.monotonic()
        self._io_lock = threading.Lock()
        self._rotate_bytes = (
            max(64 * 1024, int(rotate_bytes)) if rotate_bytes else None)
        self._max_segments = max(1, int(max_segments))
        self._bytes = 0
        self.path = None
        self._f = None
        if export_dir:
            export_dir = os.fspath(export_dir)
            os.makedirs(export_dir, exist_ok=True)
            self.path = os.path.join(
                export_dir, "{}.jsonl".format(self.node_id))
            try:  # append mode: resume the size ledger of a prior launch
                self._bytes = os.path.getsize(self.path)
            except OSError:
                self._bytes = 0
            self._f = open(self.path, "a", buffering=1024 * 64)

    def next_id(self):
        return next(self._ids)

    def record(self, doc, flush=False):
        self._ring.append(doc)
        if self._f is None:
            return
        with self._io_lock:
            f = self._f
            if f is None:
                return
            try:
                # default=str: span attrs are public API and routinely
                # carry numpy/jax scalars — export must degrade them to
                # strings, never let a TypeError unwind into the
                # instrumented (training) code path.
                line = json.dumps(doc, default=str) + "\n"
                f.write(line)
                self._bytes += len(line)
                self._unflushed += 1
                now = time.monotonic()
                if flush or self._unflushed >= self._flush_every or \
                        now - self._last_flush > self._flush_secs:
                    f.flush()
                    self._unflushed = 0
                    self._last_flush = now
                if self._rotate_bytes and self._bytes >= self._rotate_bytes:
                    self._rotate_locked()
            except (OSError, TypeError, ValueError):
                pass  # full disk / closed / unserializable: ring keeps it

    def _rotate_locked(self):
        """Roll the live export file to ``.1`` (shifting older segments
        up, dropping the oldest past ``max_segments``). Caller holds
        ``_io_lock``; any failure leaves the current stream in place."""
        f, self._f = self._f, None
        try:
            f.close()
        except OSError:  # pragma: no cover
            pass
        try:
            oldest = "{}.{}".format(self.path, self._max_segments)
            if os.path.exists(oldest):
                os.unlink(oldest)
            for i in range(self._max_segments - 1, 0, -1):
                seg = "{}.{}".format(self.path, i)
                if os.path.exists(seg):
                    os.replace(seg, "{}.{}".format(self.path, i + 1))
            os.replace(self.path, self.path + ".1")
        except OSError:  # pragma: no cover - e.g. read-only dir mid-run
            logger.debug("span export rotation failed", exc_info=True)
        try:
            self._f = open(self.path, "a", buffering=1024 * 64)
        except OSError:  # pragma: no cover - export dir vanished
            self._f = None
        self._bytes = 0
        self._unflushed = 0

    def flush(self):
        with self._io_lock:
            if self._f is not None:
                try:
                    self._f.flush()
                except (OSError, ValueError):  # pragma: no cover
                    pass
                self._unflushed = 0
                self._last_flush = time.monotonic()

    def spans(self, last=None):
        """The newest completed spans, oldest first (``last=None``: all)."""
        out = list(self._ring)
        return out if last is None else out[-int(last):]

    def close(self):
        with self._io_lock:
            f, self._f = self._f, None
            if f is not None:
                try:
                    f.close()
                except OSError:  # pragma: no cover - already closed
                    pass


def configure(node_id=None, export_dir=None, capacity=DEFAULT_CAPACITY,
              rotate_bytes=DEFAULT_ROTATE_BYTES,
              max_segments=DEFAULT_MAX_SEGMENTS):
    """Enable span recording process-wide; returns the :class:`Recorder`.

    Idempotent-by-replacement: reconfiguring closes the previous
    recorder's export file. ``export_dir=None`` keeps the ring buffer only
    (``/statusz`` still works; nothing lands on disk).
    """
    global _recorder
    if os.environ.get("TFOS_PROFILING", "").lower() in (
            "1", "on", "true", "yes"):
        raise NotImplementedError(
            "continuous profiling (telemetry/profiling.py) is not ported "
            "(ROADMAP A12); unset TFOS_PROFILING")
    rec = Recorder(node_id=node_id, capacity=capacity, export_dir=export_dir,
                   rotate_bytes=rotate_bytes, max_segments=max_segments)
    with _recorder_lock:
        old, _recorder = _recorder, rec
    if old is not None:
        old.close()
    return rec


def disable():
    """Stop span recording (metrics/gauges stay live)."""
    global _recorder
    with _recorder_lock:
        old, _recorder = _recorder, None
    if old is not None:
        old.close()


def enabled():
    return _recorder is not None


def get_recorder():
    return _recorder


def recent_spans(last=50):
    rec = _recorder
    return [] if rec is None else rec.spans(last=last)


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _Span:
    """One open span (context manager). Completed — and recorded — on
    exit; an exception unwinding through it lands in the attrs."""

    __slots__ = ("name", "attrs", "_rec", "_wall", "_t0", "span_id",
                 "parent")

    def __init__(self, rec, name, attrs):
        self._rec = rec
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        """Attach attributes discovered mid-span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].span_id if stack else None
        self.span_id = self._rec.next_id()
        stack.append(self)
        self._wall = time.time()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.monotonic() - self._t0
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._rec.record(_doc(self._rec, self.name, self._wall, dur,
                              self.span_id, self.parent, self.attrs))
        return False


class _NullSpan:
    """The disabled-path singleton: enter/exit/set are no-ops."""

    __slots__ = ()

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _doc(rec, name, wall, dur, span_id, parent, attrs):
    tid = getattr(_tls, "tid", None)
    if tid is None:
        tid = _tls.tid = threading.current_thread().name
    doc = {
        "name": name,
        "trace": rec.trace_id,
        "span": span_id,
        "parent": parent,
        "node": rec.node_id,
        "pid": rec._pid,
        "tid": tid,
        "ts": round(wall, 6),
        "dur": round(dur, 6),
    }
    if attrs:
        doc["attrs"] = attrs
    return doc


def span(name, **attrs):
    """Open a structured span: ``with telemetry.span("checkpoint/save",
    step=3) as sp: ...; sp.set(saved=True)``. A shared no-op when span
    recording is not configured."""
    rec = _recorder
    if rec is None:
        return _NULL_SPAN
    return _Span(rec, name, attrs)


def event(name, **attrs):
    """Record an instantaneous marker (restart decisions, faults,
    resume points) — a zero-duration span. Markers are rare and
    load-bearing, so they flush the export stream immediately."""
    rec = _recorder
    if rec is None:
        return
    stack = getattr(_tls, "stack", None)
    parent = stack[-1].span_id if stack else None
    rec.record(_doc(rec, name, time.time(), 0.0, rec.next_id(), parent,
                    attrs), flush=True)


def record_span(name, duration, wall_start=None, **attrs):
    """Record an already-measured span (the hot-loop form: the train loop
    times with ``perf_counter`` and reports here, paying the span cost
    only when recording is on)."""
    rec = _recorder
    if rec is None:
        return
    if wall_start is None:
        wall_start = time.time() - duration
    stack = getattr(_tls, "stack", None)
    parent = stack[-1].span_id if stack else None
    rec.record(_doc(rec, name, wall_start, float(duration), rec.next_id(),
                    parent, attrs))


# ---------------------------------------------------------------------------
# Cross-process trace context
# ---------------------------------------------------------------------------
#
# A request's trace id is minted ONCE — at the first process that sees the
# request (the fleet router, or the engine for direct submits) — and every
# later hop adopts it. The wire form is a compact ``traceparent`` string in
# the ``POST /v1/generate`` body: ``"<hex trace>-<parent span id>"`` (the
# integer id of the sender's ``serve/route`` span, 0 when it recorded
# none). The receiving ``MetricsServer`` handler parses it and submits with
# ``_trace=<trace>``, so the remote engine's spans join the router's trace.

_TRACE_CHARS = frozenset("0123456789abcdef")


def make_traceparent(trace, span=None):
    """The wire form of a trace context: ``"<trace>-<parent span id>"``."""
    return "{}-{}".format(trace, int(span or 0))


def parse_traceparent(value):
    """``(trace_id, parent_span_id)`` from a ``traceparent`` string, or
    ``None`` for anything malformed — propagation degrades to a fresh
    trace, never to a failed request."""
    if not isinstance(value, str) or "-" not in value:
        return None
    trace, _, parent = value.rpartition("-")
    if not (4 <= len(trace) <= 32) or not set(trace) <= _TRACE_CHARS:
        return None
    try:
        return trace, int(parent)
    except ValueError:
        return None


# Compact per-request trace summaries awaiting heartbeat publication:
# engines append one dict at each terminal transition (and the fleet
# router one per placement), node_stats() drains up to
# ``TRACE_SUMMARIES_PER_BEAT`` per call, and the cluster driver's store
# merges them by trace id. Bounded: a burst between beats keeps the
# newest summaries.
_trace_summaries = collections.deque(maxlen=256)
TRACE_SUMMARIES_PER_BEAT = 32


def note_trace(summary):
    """Queue one compact trace summary (a small dict carrying at least
    ``trace``) for the next heartbeat — one deque append."""
    if isinstance(summary, dict) and summary.get("trace"):
        _trace_summaries.append(summary)


def take_trace_summaries(limit=TRACE_SUMMARIES_PER_BEAT):
    """Drain up to ``limit`` queued trace summaries, oldest first (the
    heartbeat's half of :func:`note_trace`)."""
    out = []
    while _trace_summaries and len(out) < int(limit):
        try:
            out.append(_trace_summaries.popleft())
        except IndexError:  # a racing drainer emptied it
            break
    return out


# ---------------------------------------------------------------------------
# Counters / gauges (always-on process metrics)
# ---------------------------------------------------------------------------

_metrics_lock = threading.Lock()
_counters = {}   # name -> {labels_tuple: float}
_gauges = {}
_histograms = {}  # name -> {labels_tuple: [counts, sum, count]}
_hist_bounds = {}  # name -> tuple of finite upper bounds (le values)
_status = {}     # free-form /statusz payload (restart history, ...)
_step_meter = {"last": None, "rate": None, "wait_frac": None}

# Fixed log-spaced buckets (1 / 2.5 / 5 per decade) covering 100 µs to
# 60 s: wide enough for decode-token latencies (~ms), train steps
# (ms–s) and checkpoint saves (s–tens of s) without per-family tuning.
# Fixed bounds keep observe() to a bisect + three adds under one lock —
# the histogram path must live inside the telemetry_overhead 2% bar.
DEFAULT_HIST_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _labels_key(labels):
    return tuple(sorted(labels.items())) if labels else ()


def inc(name, value=1.0, **labels):
    """Add ``value`` to a counter (created at 0 on first use)."""
    key = _labels_key(labels)
    with _metrics_lock:
        d = _counters.setdefault(name, {})
        d[key] = d.get(key, 0.0) + value


def set_gauge(name, value, **labels):
    key = _labels_key(labels)
    with _metrics_lock:
        _gauges.setdefault(name, {})[key] = float(value)


def get_gauge(name, default=None):
    """The unlabeled value of a gauge (None/default when never set)."""
    with _metrics_lock:
        return _gauges.get(name, {}).get((), default)


def get_counter(name, default=0.0):
    with _metrics_lock:
        return _counters.get(name, {}).get((), default)


def clear_gauge(name):
    """Drop a gauge family entirely (it disappears from /metrics and
    node_stats rather than going stale — e.g. when the producing layer
    shuts down)."""
    with _metrics_lock:
        _gauges.pop(name, None)


# Non-numeric heartbeat payloads: gauges are floats, but some per-node
# facts the fleet router needs are structured — the KV-prefix index digest
# (chain-hash prefixes) that remote prefix affinity matches against.
# Entries ride node_stats() verbatim; keep them small.
_node_extra = {}


def set_node_extra(key, value):
    """Attach a small JSON-serializable value to every later
    ``node_stats()`` under ``key`` (``None`` removes it)."""
    with _metrics_lock:
        if value is None:
            _node_extra.pop(key, None)
        else:
            _node_extra[key] = value


def observe(name, value, buckets=None, **labels):
    """Record one observation into a histogram (seconds-valued latencies:
    step time, data wait, checkpoint save, decode token).

    Stdlib fixed-bucket implementation: the family's bucket bounds are
    pinned on first use (``buckets`` override, else
    :data:`DEFAULT_HIST_BUCKETS`) and every observation is one bisect +
    three adds under the metrics lock — cheap enough for per-step use
    (the ``telemetry_overhead`` bench includes it under the 2% bar).
    Rendered by :func:`prometheus_text` as Prometheus ``_bucket`` /
    ``_sum`` / ``_count`` series; :func:`hist_quantiles` estimates
    percentiles for ``node_stats()``.

    """
    value = float(value)
    key = _labels_key(labels)
    with _metrics_lock:
        bounds = _hist_bounds.get(name)
        if bounds is None:
            bounds = _hist_bounds[name] = tuple(
                float(b) for b in (buckets or DEFAULT_HIST_BUCKETS))
        series = _histograms.setdefault(name, {})
        h = series.get(key)
        if h is None:
            # [per-bucket counts (+1 overflow), sum, count]
            h = series[key] = [[0] * (len(bounds) + 1), 0.0, 0]
        idx = bisect.bisect_left(bounds, value)
        h[0][idx] += 1
        h[1] += value
        h[2] += 1


def hist_export(names=None):
    """Compact bucket-level export of (unlabeled) histogram families:
    ``{name: {"bounds": [...], "counts": [...], "sum": s, "count": n}}``
    for every populated family in ``names`` (all families when None).

    This is the cluster-merge transport: per-node bucket *counts* can be
    summed before interpolating (:func:`merged_quantiles`) — averaging
    per-node p95s cannot produce a fleet p95 — so ``node_stats()`` ships
    a few key families on every heartbeat and the driver's history store
    answers "fleet-wide p95 TTFT" exactly."""
    out = {}
    with _metrics_lock:
        for name, series in _histograms.items():
            if names is not None and name not in names:
                continue
            h = series.get(())
            if h is None or not h[2]:
                continue
            out[name] = {
                "bounds": list(_hist_bounds[name]),
                "counts": list(h[0]),
                "sum": round(h[1], 6),
                "count": h[2],
            }
    return out


def _quantiles_from_counts(bounds, counts, total, qs):
    """Shared quantile interpolation over one bucket-count vector (the
    per-process and cluster-merged paths must use one formula)."""
    out = []
    for q in qs:
        target = max(0.0, min(1.0, float(q))) * total
        cum = 0.0
        lo = 0.0
        value = bounds[-1]
        for i, c in enumerate(counts):
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            if c and cum + c >= target:
                value = lo + (hi - lo) * ((target - cum) / c)
                break
            cum += c
            lo = hi
        out.append(value)
    return out


def merged_quantiles(hists, qs=(0.5, 0.95, 0.99)):
    """Cluster-level quantile estimate across per-node histogram exports
    (:func:`hist_export` dicts): per-node bucket counts are SUMMED before
    interpolating, so the result is the true fleet distribution's
    quantile — not an average of per-node quantiles. Exports whose
    bounds disagree with the first one seen are skipped (mixed bucket
    schemas cannot be merged). Returns a list aligned with ``qs``, or
    None when nothing merged."""
    bounds = None
    counts = None
    total = 0
    for h in hists:
        if not isinstance(h, dict):
            continue
        hb = tuple(float(b) for b in h.get("bounds") or ())
        hc = h.get("counts")
        if not hb or not isinstance(hc, (list, tuple)) \
                or len(hc) != len(hb) + 1:
            continue
        if bounds is None:
            bounds = hb
            counts = [0] * len(hc)
        elif hb != bounds:
            continue
        for i, c in enumerate(hc):
            counts[i] += int(c)
        total += int(h.get("count") or sum(hc))
    if bounds is None or not total:
        return None
    return _quantiles_from_counts(bounds, counts, total, qs)


def hist_quantiles(name, qs=(0.5, 0.95, 0.99), **labels):
    """Estimated quantiles from a histogram's bucket counts (linear
    interpolation within the containing bucket; the overflow bucket
    degrades to the top finite bound). Returns a list aligned with
    ``qs``, or None when the histogram has no observations."""
    with _metrics_lock:
        bounds = _hist_bounds.get(name)
        series = _histograms.get(name)
        h = series.get(_labels_key(labels)) if series else None
        if h is None or not h[2]:
            return None
        counts, total = list(h[0]), h[2]
    return _quantiles_from_counts(bounds, counts, total, qs)


def _flatten(store):
    out = {}
    for name, series in store.items():
        for key, value in series.items():
            label = ("" if not key else
                     "{" + ",".join("{}={}".format(k, v) for k, v in key)
                     + "}")
            out[name + label] = value
    return out


def metrics_snapshot():
    """``{"counters": {...}, "gauges": {...}, "histograms": {...}}`` with
    labels folded into the key — the /statusz rendering. Histograms are
    summarized as ``{count, sum, mean}`` (the full bucket vectors ride
    ``/metrics``, not JSON)."""
    with _metrics_lock:
        hists = {}
        for name, series in _histograms.items():
            for key, h in series.items():
                label = ("" if not key else
                         "{" + ",".join("{}={}".format(k, v)
                                        for k, v in key) + "}")
                hists[name + label] = {
                    "count": h[2], "sum": round(h[1], 6),
                    "mean": round(h[1] / h[2], 6) if h[2] else None,
                }
        return {"counters": _flatten(_counters), "gauges": _flatten(_gauges),
                "histograms": hists}


def _sanitize(name):
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def _escape_label(value):
    """Prometheus exposition label-value escaping (\\, \", newline) — one
    bad label value must not invalidate the whole scrape."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escape_help(text):
    """HELP-line escaping per the text-format spec: backslash and
    newline only (quotes are legal in HELP text)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v):
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


# ``# HELP`` text per metric family (pre-``tfos_`` name). Families
# without an entry get a generic line — the exposition format requires
# the metadata lines per family, not per-family prose quality.
METRIC_HELP = {
    "train_step": "Current optimizer step of the training loop.",
    "train_steps_per_sec": "EMA optimizer steps per second (step_tick).",
    "train_data_wait_frac":
        "EMA fraction of step wall time spent blocked on the feed plane.",
    "prefetch_depth": "Batches resident in the DevicePrefetch queue.",
    "prefetch_batches_total": "Batches placed by DevicePrefetch.",
    "prefetch_consumer_wait_seconds":
        "Seconds the training loop waited on an empty prefetch queue.",
    "prefetch_producer_stall_seconds":
        "Seconds the prefetch producer stalled on a full queue.",
    "feed_wait_seconds": "Seconds spent waiting in DataFeed.next_batch.",
    "feed_items_total": "Items consumed through DataFeed.",
    "checkpoint_last_step": "Last durably committed checkpoint step.",
    "profiler_port": "Port of the on-demand jax profiler server.",
    "xla_compiles_total": "XLA compiles observed by the introspect layer.",
    "xla_recompiles_total":
        "Retraces: the same function compiled again under a new "
        "argument signature (see xla/recompile events).",
    "xla_compiles": "XLA compiles per wrapped function.",
    "xla_flops": "Estimated FLOPs per call of a compiled function.",
    "xla_bytes": "Estimated bytes accessed per call of a compiled "
                 "function.",
    "xla_flops_per_step":
        "cost_analysis() FLOPs of the per-device train-step program.",
    "xla_bytes_accessed":
        "cost_analysis() bytes accessed by the per-device train step.",
    "hbm_peak_bytes":
        "memory_analysis() live-set peak estimate of the train step "
        "(args + outputs + temps - donated aliases).",
    "device_peak_flops": "Per-chip peak FLOP/s (device_info).",
    "train_step_seconds": "Histogram of per-step host-visible time "
                          "(dispatch + donation backpressure).",
    "train_data_wait_seconds":
        "Histogram of per-step time blocked on the feed plane.",
    "feed_batch_wait_seconds":
        "Histogram of DataFeed.next_batch input-queue wait per call.",
    "checkpoint_save_seconds": "Histogram of checkpoint save() latency.",
    "checkpoint_commit_seconds":
        "Histogram of checkpoint commit-marker write latency.",
    "decode_token_seconds":
        "Histogram of generate() decode latency per emitted token.",
    "incident_captures_total": "Incident bundles written by this process.",
    "incident_captures_suppressed_total":
        "Incident triggers dropped by the capture rate limit.",
    "goodput": "Fraction of accounted cluster wall time spent in "
               "productive training steps (telemetry_store).",
    "goodput_productive_frac": "Goodput breakdown: productive-step time.",
    "goodput_data_wait_frac": "Goodput breakdown: blocked on the feed "
                              "plane.",
    "goodput_checkpoint_frac": "Goodput breakdown: checkpoint save/commit.",
    "goodput_compile_frac": "Goodput breakdown: bring-up before the "
                            "first step (import + jit compile).",
    "goodput_restart_frac": "Goodput breakdown: restart downtime "
                            "(teardown to relaunch) and dead-node time.",
    "goodput_other_frac": "Goodput breakdown: unaccounted wall time.",
    "slo_breaches_total": "SLO burn-rate alerts fired by the monitor.",
    "slo_firing": "SLOs currently in the firing state.",
    "profiling_samples_total":
        "Stack samples taken by the continuous sampling profiler.",
    "profiling_duty_frac":
        "Fraction of wall time the continuous profiler spends walking "
        "frames (its always-on overhead; bench guard <2% combined).",
}


def _label_str(key, extra=None):
    """Render a labels tuple (plus optional ``extra`` pairs appended —
    the histogram ``le``) as a Prometheus label block."""
    pairs = ['{}="{}"'.format(_sanitize(k), _escape_label(v))
             for k, v in key]
    if extra:
        pairs += ['{}="{}"'.format(k, v) for k, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def prometheus_text():
    """The metrics registry in Prometheus text exposition format (v0.0.4),
    every metric prefixed ``tfos_``, with ``# HELP``/``# TYPE`` metadata
    per family and spec-compliant label/help escaping. Histogram families
    render the standard ``_bucket`` (cumulative, with ``le`` including
    ``+Inf``) / ``_sum`` / ``_count`` triple."""
    lines = []
    with _metrics_lock:
        for kind, store in (("counter", _counters), ("gauge", _gauges)):
            for name in sorted(store):
                pname = "tfos_" + _sanitize(name)
                help_text = METRIC_HELP.get(
                    name, "tfos {} {}".format(name, kind))
                lines.append("# HELP {} {}".format(
                    pname, _escape_help(help_text)))
                lines.append("# TYPE {} {}".format(pname, kind))
                for key, value in sorted(store[name].items()):
                    lines.append("{}{} {}".format(
                        pname, _label_str(key), _fmt_value(value)))
        for name in sorted(_histograms):
            pname = "tfos_" + _sanitize(name)
            bounds = _hist_bounds[name]
            lines.append("# HELP {} {}".format(pname, _escape_help(
                METRIC_HELP.get(name, "tfos {} histogram".format(name)))))
            lines.append("# TYPE {} histogram".format(pname))
            for key, h in sorted(_histograms[name].items()):
                counts, total_sum, count = h
                cum = 0
                for i, bound in enumerate(bounds):
                    cum += counts[i]
                    lines.append("{}_bucket{} {}".format(
                        pname,
                        _label_str(key, [("le", _fmt_value(bound))]),
                        cum))
                lines.append("{}_bucket{} {}".format(
                    pname, _label_str(key, [("le", "+Inf")]), count))
                lines.append("{}_sum{} {}".format(
                    pname, _label_str(key), _fmt_value(total_sum)))
                lines.append("{}_count{} {}".format(
                    pname, _label_str(key), count))
    return "\n".join(lines) + "\n"


def put_status(key, value):
    """Attach a free-form entry to this process's ``/statusz`` payload
    (e.g. the supervisor's restart history)."""
    with _metrics_lock:
        _status[key] = value


def get_status():
    with _metrics_lock:
        return dict(_status)


def step_tick(step, wait=0.0, alpha=0.2):
    """Per-optimizer-step bookkeeping for the live node stats.

    Updates the ``train_step`` gauge and EMA ``train_steps_per_sec`` /
    ``train_data_wait_frac`` gauges (``wait``: seconds this step spent
    blocked on data). One locked dict transaction — cheap enough for
    every step of every loop (the telemetry_overhead bench pins it).
    """
    now = time.monotonic()
    with _metrics_lock:
        _gauges.setdefault("train_step", {})[()] = float(step)
        last, _step_meter["last"] = _step_meter["last"], now
        if last is None or now <= last:
            return
        dt = now - last
        rate, frac = 1.0 / dt, min(1.0, max(0.0, wait / dt))
        r0 = _step_meter["rate"]
        f0 = _step_meter["wait_frac"]
        _step_meter["rate"] = rate if r0 is None else r0 + alpha * (rate - r0)
        _step_meter["wait_frac"] = (
            frac if f0 is None else f0 + alpha * (frac - f0))
        _gauges.setdefault("train_steps_per_sec", {})[()] = \
            _step_meter["rate"]
        _gauges.setdefault("train_data_wait_frac", {})[()] = \
            _step_meter["wait_frac"]


def _rss_mb():
    try:  # current RSS, Linux: resident pages * page size
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):
        try:  # no /proc: degrade to PEAK rss — ru_maxrss is KB on
            # Linux/BSD but BYTES on macOS.
            import resource
            import sys

            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return peak / (1e6 if sys.platform == "darwin" else 1e3)
        except Exception:  # pragma: no cover - exotic platform
            return None


# Histogram families whose bucket counts ride every heartbeat (the
# fleet-quantile merge transport — see node_stats / merged_quantiles).
HB_HIST_FAMILIES = ("train_step_seconds", "serve_ttft_seconds",
                    "serve_request_seconds",
                    # Per-round accepted-draft-token counts:
                    # the fleet merge wants the DISTRIBUTION, not just
                    # the lifetime mean the acceptance-rate gauge gives.
                    "serve_spec_accepted_tokens",
                    # Cross-engine KV-page transfer latency:
                    # the disaggregation regime call hinges on the
                    # fleet-wide transfer tail, not one node's.
                    "serve_kv_transfer_seconds")

_STAT_GAUGES = (
    ("step", "train_step"),
    ("steps_per_sec", "train_steps_per_sec"),
    ("data_wait_frac", "train_data_wait_frac"),
    ("prefetch_depth", "prefetch_depth"),
    ("last_checkpoint_step", "checkpoint_last_step"),
    ("profiler_port", "profiler_port"),
    # Host-ingest plane (data.decode_pool): live workers and tasks in
    # flight ride heartbeats so the straggler detector and /statusz see
    # a node whose decode pool is dying or starved (docs/perf.md).
    ("ingest_workers", "ingest_pool_workers"),
    ("ingest_inflight", "ingest_pool_inflight"),
    # Serving plane (serving.ServingEngine): in-flight/queued requests
    # and page-pool occupancy ride heartbeats so the driver sees a node
    # whose cache is saturated (admission backpressure) or whose queue
    # is growing (docs/serving.md).
    ("serve_active", "serve_active_requests"),
    ("serve_queued", "serve_queued_requests"),
    ("serve_pages_in_use", "serve_pages_in_use"),
    # KV-cache sharing efficiency: pages referenced by more
    # than one request, total outstanding page references, lifetime
    # copy-on-write copies, and the pool's device byte footprint (scale
    # arrays included when the pool is int8) — the dashboard's
    # "effective pages = unique pages" story rides these.
    ("serve_shared_pages", "serve_shared_pages"),
    ("serve_refcount_total", "serve_refcount_total"),
    ("serve_cow_copies", "serve_cow_copies_total"),
    ("serve_pool_bytes", "serve_pool_bytes"),
    # Fleet plane: pool geometry so a remote router can
    # normalize occupancy, preemption churn, and the routing decision
    # counts — least-loaded/affinity routing across hosts is a lookup
    # of exactly these keys (serving.fleet.RemoteEngine).
    ("serve_slots", "serve_slots"),
    ("serve_pages_total", "serve_pages_total"),
    ("serve_preemptions", "serve_preemptions"),
    ("serve_preempted_queued", "serve_preempted_queued"),
    ("serve_fleet_routed", "serve_fleet_routed"),
    ("serve_fleet_affinity_hits", "serve_fleet_affinity_hits"),
    ("serve_fleet_failovers", "serve_fleet_failovers"),
    # Circuit-breaker visibility: how many peers the router
    # currently refuses to place on, and lifetime trips — an open
    # breaker becomes a dashboard fact, not a fleet-internal one.
    ("serve_breaker_open", "serve_breaker_open"),
    ("serve_fleet_breaker_trips", "serve_fleet_breaker_trips"),
    # Speculative decoding: verify-round count and lifetime
    # draft acceptance rate ride heartbeats so the driver can see a
    # draft model that stopped paying for itself (docs/serving.md).
    ("serve_spec_rounds", "serve_spec_rounds"),
    ("serve_spec_acceptance_rate", "serve_spec_acceptance_rate"),
    # Disaggregated prefill/decode: handoff flow counters and
    # the pool page size (remote affinity needs it to compute chain-hash
    # keys that match this node's digest) ride heartbeats so the router
    # and dashboards see the prefill->decode page stream.
    ("serve_page_size", "serve_page_size"),
    ("serve_handoffs_out", "serve_handoffs_out"),
    ("serve_handoffs_in", "serve_handoffs_in"),
    ("serve_handoff_fallbacks", "serve_handoff_fallbacks"),
)


def node_stats():
    """The compact per-node stats dict that rides every heartbeat
    (``HB``): current step, steps/sec, data-wait fraction, prefetch
    depth, last committed checkpoint step, profiler port, RSS — plus,
    when the XLA introspection layer published its gauges, the
    *analytical* MFU: ``cost_analysis()`` FLOPs of the per-device step
    program times the live steps/sec, over the chip's peak FLOP/s
    (:mod:`device_info`). Keys are present only once the producing layer
    has reported — absent, never faked, on backends without estimates."""
    out = {}
    with _metrics_lock:
        for key, gauge in _STAT_GAUGES:
            series = _gauges.get(gauge)
            if series and () in series:
                out[key] = round(series[()], 4)

        def _gauge(name):
            series = _gauges.get(name)
            return series.get(()) if series else None

        flops = _gauge("xla_flops_per_step")
        rate = _gauge("train_steps_per_sec")
        peak = _gauge("device_peak_flops")
        if flops and rate and peak:
            out["mfu_analytical"] = round(flops * rate / peak, 4)

        # Cumulative busy-time counters from the histogram sums: the
        # driver-side goodput accountant (telemetry_store) classifies
        # each heartbeat interval from the DELTAS of these, which is
        # robust against missed beats in a way instantaneous fractions
        # are not. Present only once the producing histogram is.
        def _hsum(name):
            series = _histograms.get(name)
            h = series.get(()) if series else None
            return h[1] if h is not None and h[2] else None

        step_s = _hsum("train_step_seconds")
        if step_s is not None:
            out["busy_step_s"] = round(step_s, 3)
        wait_s = _hsum("train_data_wait_seconds")
        if wait_s is not None:
            out["busy_wait_s"] = round(wait_s, 3)
        ckpt_parts = [_hsum("checkpoint_save_seconds"),
                      _hsum("checkpoint_commit_seconds")]
        if any(v is not None for v in ckpt_parts):
            out["busy_ckpt_s"] = round(
                sum(v for v in ckpt_parts if v is not None), 3)
    # Latency percentiles from the histogram instruments (outside the
    # metrics lock: hist_quantiles takes it itself). Keys ride every
    # heartbeat, so only the families operators actually page on — step
    # time, decode-token latency, and host-ingest batch-decode latency —
    # and only once populated.
    for prefix, hist in (("step_ms", "train_step_seconds"),
                         ("decode_ms", "decode_token_seconds"),
                         ("ingest_ms", "ingest_decode_seconds"),
                         # Per-request serving latency: time
                         # to first token and end-to-end request time.
                         ("serve_ttft_ms", "serve_ttft_seconds"),
                         ("serve_request_ms", "serve_request_seconds"),
                         # Preemption resume latency:
                         # preempt -> decoding again (swap restore or
                         # prefill replay, queue wait included).
                         ("serve_preempt_resume_ms",
                          "serve_preempt_resume_seconds"),
                         # Cross-engine KV-page transfer:
                         # extract -> wire -> restore, the disaggregated
                         # handoff hop (serving.ServingEngine).
                         ("serve_kv_transfer_ms",
                          "serve_kv_transfer_seconds")):
        qs = hist_quantiles(hist, (0.5, 0.95, 0.99))
        if qs:
            for q, v in zip(("p50", "p95", "p99"), qs):
                out["{}_{}".format(prefix, q)] = round(v * 1e3, 3)
    # Bucket-level exports for the fleet-quantile merge: per-node
    # quantiles cannot be averaged into a fleet p95, but bucket COUNTS
    # sum exactly (telemetry.merged_quantiles). Only the families
    # operators page on ride every heartbeat; ~20 ints each.
    hx = hist_export(HB_HIST_FAMILIES)
    if hx:
        out["hists"] = hx
    # Per-request trace summaries (note_trace): each heartbeat drains a
    # bounded batch for the cluster driver's store.
    traces = take_trace_summaries()
    if traces:
        out["traces"] = traces
    # Structured per-node extras (set_node_extra), e.g. the prefix-index
    # digest remote affinity routing matches prompts against.
    with _metrics_lock:
        out.update(_node_extra)
    rss = _rss_mb()
    if rss is not None:
        out["rss_mb"] = round(rss, 1)
    return out


def _reset_for_tests():
    """Test isolation: drop all metrics/status/meter state and disable
    span recording."""
    disable()
    with _metrics_lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        _hist_bounds.clear()
        _status.clear()
        _node_extra.clear()
        _step_meter.update(last=None, rate=None, wait_frac=None)
    _trace_summaries.clear()
