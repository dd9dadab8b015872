"""Critical-path latency attribution over merged span exports (the
port's copy of the JAX package's ``telemetry/attribution.py``).

The serving plane records one ``serve/request`` envelope per request
plus the segment spans that partition it — ``serve/queue_wait``,
``serve/prefill``, ``serve/decode`` — and, when the request moved,
``serve/preempt_wait`` off-air windows and ``serve/migrate`` events.
With cross-process trace propagation the fleet router's ``serve/route``
span carries the SAME trace id, so one request's spans can live in
several nodes' export files. This module answers "where did this
request's latency go" over those merged, clock-aligned exports:

* :func:`request_profile` — one request's e2e decomposed into
  queue / route+network / prefill / preempt-offair / migration /
  decode-active segments, with the accounting check (segments must sum
  to within tolerance of the measured e2e);
* :func:`window_attribution` — a window of requests aggregated into a
  tail-attribution table: per-segment means over all requests and over
  the tail (e2e at or above the requested quantile), and which segment
  dominates the tail;
* :func:`explain` — one slow request diffed against the window median,
  naming the segment that pushed it out of line.

Segment semantics:
``queue``/``prefill``/``decode`` partition the engine-side e2e (the
existing waterfall contract); ``transfer``/``preempt``/``migration``
split the off-air ``serve/preempt_wait`` windows OUT of the raw decode
span (an off-air window with a ``serve/handoff`` event inside it was a
disaggregated prefill->decode page handoff, one whose ``serve/migrate``
event falls inside it was a drain migration, the rest were priority
preemptions), leaving ``decode`` as decode-ACTIVE time; ``route`` is
the driver-side routing span — it overlaps the engine's e2e across a
network hop, so it is reported alongside, not added to, the partition,
and ``kv_transfer_ms`` (the sender-side ``serve/kv_transfer`` span:
extract -> wire -> restore ack) is reported the same way, overlapping
the ``transfer`` off-air window it explains.

Clock alignment reuses :func:`telemetry.estimate_clock_offsets`
(NTP-style, from the rendezvous-register exchange); nodes with no
estimate are treated as offset 0 — single-host tests and
loopback fleets need no rendezvous plane.
"""

from tensorflowonspark_tpu_torch.telemetry import estimate_clock_offsets

ENVELOPE = "serve/request"

# Attribution segment keys, in waterfall order. Values in every profile
# are milliseconds under "<segment>_ms".
SEGMENTS = ("queue", "route", "prefill", "transfer", "preempt",
            "migration", "decode")

# The engine-side partition: these sum to ~e2e (route overlaps).
_PARTITION = ("queue", "prefill", "transfer", "preempt", "migration",
              "decode")


def align_spans(spans, offsets=None):
    """Spans with per-node clock offsets applied (``ts`` shifted onto
    the driver's clock). ``offsets`` defaults to
    :func:`estimate_clock_offsets` over the same spans; nodes without
    an estimate shift by 0."""
    if offsets is None:
        offsets = estimate_clock_offsets(spans)
    if not offsets:
        return list(spans)
    out = []
    for doc in spans:
        off = offsets.get(str(doc.get("node", "?")), 0.0)
        if off:
            doc = dict(doc, ts=float(doc["ts"]) + off)
        out.append(doc)
    return out


def _by_trace(spans):
    """serve/* spans and events grouped by their ``trace`` attr."""
    groups = {}
    for doc in spans:
        name = doc.get("name", "")
        if not name.startswith("serve/"):
            continue
        trace = (doc.get("attrs") or {}).get("trace")
        if trace is None:
            continue
        groups.setdefault(str(trace), []).append(doc)
    return groups


def _sum_ms(docs, name):
    return sum(float(d.get("dur", 0.0)) for d in docs
               if d["name"] == name) * 1e3


def request_profile(spans, trace, offsets=None, aligned=False):
    """One request's segment decomposition from (merged) spans.

    Returns ``None`` when the trace has no ``serve/request`` envelope
    yet (still running, or the engine's export has not landed).
    Otherwise a dict with ``trace``, ``e2e_ms``, one ``<segment>_ms``
    per :data:`SEGMENTS`, ``segments_ms`` (the engine-side partition
    sum), ``unaccounted_ms``, ``accounted_frac``, and the envelope's
    ``request``/``state`` attrs. ``accounted_frac`` within ~0.1 of 1.0
    is the green accounting check — beyond it the engine sat on the
    request outside every instrumented phase."""
    if not aligned:
        spans = align_spans(spans, offsets)
    docs = _by_trace(spans).get(str(trace), [])
    return _profile_from_docs(str(trace), docs)


def _profile_from_docs(trace, docs):
    envelope = next((d for d in docs if d["name"] == ENVELOPE), None)
    if envelope is None:
        return None
    e2e_ms = float(envelope.get("dur", 0.0)) * 1e3
    queue_ms = _sum_ms(docs, "serve/queue_wait")
    prefill_ms = _sum_ms(docs, "serve/prefill")
    decode_raw_ms = _sum_ms(docs, "serve/decode")
    route_ms = _sum_ms(docs, "serve/route")
    kv_transfer_ms = _sum_ms(docs, "serve/kv_transfer")
    # Off-air windows: serve/preempt_wait covers preempt -> re-admit.
    # A window containing a serve/handoff event for this trace was the
    # disaggregated prefill->decode page handoff; one containing a
    # serve/migrate event was a drain migration; the rest were priority
    # preemptions. Handoff is checked FIRST: a successful handoff also
    # counts as a migration (the ledger's migrated_out), so its window
    # can contain both events — the more specific label wins.
    migrate_ts = [float(d["ts"]) for d in docs
                  if d["name"] == "serve/migrate"]
    handoff_ts = [float(d["ts"]) for d in docs
                  if d["name"] == "serve/handoff"]
    preempt_ms = 0.0
    migration_ms = 0.0
    transfer_ms = 0.0
    for d in docs:
        if d["name"] != "serve/preempt_wait":
            continue
        dur = float(d.get("dur", 0.0))
        # record_span back-dates: the wait started at ts, ended ts+dur.
        t0, t1 = float(d["ts"]), float(d["ts"]) + dur
        slack = max(0.050, 0.05 * dur)
        if any(t0 - slack <= m <= t1 + slack for m in handoff_ts):
            transfer_ms += dur * 1e3
        elif any(t0 - slack <= m <= t1 + slack for m in migrate_ts):
            migration_ms += dur * 1e3
        else:
            preempt_ms += dur * 1e3
    # Decode-ACTIVE: the raw decode span covers off-air windows that
    # happened after the first token; splitting them out keeps the
    # partition a partition instead of double-counting.
    offair_in_decode = min(decode_raw_ms,
                           preempt_ms + migration_ms + transfer_ms)
    decode_ms = max(0.0, decode_raw_ms - offair_in_decode)
    profile = {
        "trace": trace,
        "e2e_ms": round(e2e_ms, 3),
        "queue_ms": round(queue_ms, 3),
        "route_ms": round(route_ms, 3),
        "prefill_ms": round(prefill_ms, 3),
        "transfer_ms": round(transfer_ms, 3),
        "preempt_ms": round(preempt_ms, 3),
        "migration_ms": round(migration_ms, 3),
        "decode_ms": round(decode_ms, 3),
        "request": (envelope.get("attrs") or {}).get("request"),
        "state": (envelope.get("attrs") or {}).get("state"),
    }
    if kv_transfer_ms > 0:
        # Sender-side wire-hop span: overlaps the transfer off-air
        # window (like route overlaps e2e), reported alongside it.
        profile["kv_transfer_ms"] = round(kv_transfer_ms, 3)
    partition = (queue_ms + prefill_ms + decode_ms
                 + preempt_ms + migration_ms + transfer_ms)
    profile["segments_ms"] = round(partition, 3)
    profile["unaccounted_ms"] = round(e2e_ms - partition, 3)
    profile["accounted_frac"] = round(
        partition / e2e_ms, 4) if e2e_ms > 0 else 1.0
    nodes = sorted({str(d.get("node", "?")) for d in docs})
    if len(nodes) > 1:
        profile["nodes"] = nodes
    return profile


def dominant_segment(profile):
    """The partition segment carrying the most time in a profile."""
    return max(_PARTITION, key=lambda s: profile.get(s + "_ms", 0.0))


def window_profiles(spans, offsets=None):
    """Profiles for every completed request in the spans, submit-order."""
    spans = align_spans(spans, offsets)
    profiles = []
    for trace, docs in _by_trace(spans).items():
        p = _profile_from_docs(trace, docs)
        if p is not None:
            profiles.append(p)
    profiles.sort(key=lambda p: p["e2e_ms"])
    return profiles


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def _median(vals):
    vals = sorted(vals)
    return _quantile(vals, 0.5)


def window_attribution(spans, quantile=0.95, offsets=None):
    """Tail-attribution table over a window of completed requests:
    what dominates the requests at or above the ``quantile`` of e2e.

    Returns ``{"requests", "tail_requests", "e2e_p<q>_ms", "segments":
    {segment: {"mean_ms", "tail_mean_ms", "tail_share"}}, "dominant"}``
    where ``tail_share`` is the segment's share of the tail requests'
    summed e2e and ``dominant`` names the largest. Empty spans give
    ``{"requests": 0}``."""
    profiles = window_profiles(spans, offsets)
    if not profiles:
        return {"requests": 0}
    e2es = [p["e2e_ms"] for p in profiles]
    cut = _quantile(e2es, quantile)
    tail = [p for p in profiles if p["e2e_ms"] >= cut] or profiles[-1:]
    tail_e2e = sum(p["e2e_ms"] for p in tail) or 1.0
    segments = {}
    for seg in SEGMENTS:
        key = seg + "_ms"
        segments[seg] = {
            "mean_ms": round(
                sum(p[key] for p in profiles) / len(profiles), 3),
            "tail_mean_ms": round(
                sum(p[key] for p in tail) / len(tail), 3),
        }
        if seg in _PARTITION:
            segments[seg]["tail_share"] = round(
                sum(p[key] for p in tail) / tail_e2e, 4)
    dominant = max(_PARTITION,
                   key=lambda s: segments[s]["tail_share"])
    return {
        "requests": len(profiles),
        "tail_requests": len(tail),
        "quantile": quantile,
        "e2e_cut_ms": round(cut, 3),
        "segments": segments,
        "dominant": dominant,
    }


def explain(spans, trace, offsets=None):
    """Why was THIS request slow: its profile diffed against the
    window median per segment. Returns ``None`` for an unknown trace;
    otherwise ``{"trace", "profile", "median_ms", "delta_ms",
    "dominant", "text"}`` where ``dominant`` is the partition segment
    with the largest positive delta over the median (the request's own
    dominant segment when nothing exceeds the median — a uniformly
    slow window) and ``text`` is a one-line human answer."""
    spans = align_spans(spans, offsets)
    groups = _by_trace(spans)
    docs = groups.get(str(trace))
    if not docs:
        return None
    profile = _profile_from_docs(str(trace), docs)
    if profile is None:
        return None
    others = [p for t, g in groups.items()
              for p in (_profile_from_docs(t, g),) if p is not None]
    median = {}
    delta = {}
    for seg in SEGMENTS:
        key = seg + "_ms"
        median[seg] = round(_median([p[key] for p in others]), 3)
        delta[seg] = round(profile[key] - median[seg], 3)
    candidates = [s for s in _PARTITION if delta[s] > 0]
    dominant = max(candidates, key=lambda s: delta[s]) \
        if candidates else dominant_segment(profile)
    text = ("trace {}: e2e {:.1f}ms ({:+.1f}ms vs window median); "
            "dominant segment: {} ({:.1f}ms, {:+.1f}ms vs median)".format(
                trace, profile["e2e_ms"],
                profile["e2e_ms"] - _median(
                    [p["e2e_ms"] for p in others]),
                dominant, profile[dominant + "_ms"], delta[dominant]))
    return {
        "trace": str(trace),
        "profile": profile,
        "median_ms": median,
        "delta_ms": delta,
        "dominant": dominant,
        "text": text,
    }
