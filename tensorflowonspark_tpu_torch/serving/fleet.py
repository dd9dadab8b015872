"""Serving fleet plane: request routing across engines (port of the JAX
package's ``serving/fleet.py``).

One :class:`~tensorflowonspark_tpu_torch.serving.engine.ServingEngine` is
one pool on one card. A deployment runs many: replicas in one process (each
with its own page pool and step loop) and engines on other hosts behind
their ``MetricsServer``. :class:`ServingFleet` places each request on ONE
engine and returns that engine's stream handle unchanged, so the caller's
contract (``submit() -> handle.stream()``) is the single-engine contract.

Placement policy, in order:

1. **Prefix affinity** — the prompt's chain keys
   (:func:`~tensorflowonspark_tpu_torch.serving.cache.prefix_keys`) are
   probed against each engine's prefix index (``PagePool.index_match_len``,
   read-only; a remote peer's heartbeat digest). The engine already
   holding the longest matched prefix gets the request (it skips that
   prefill and shares the pages copy-on-write), UNLESS its queue has grown
   past ``affinity_max_queued``.
2. **Least-loaded** — the remaining engines are ranked by a load score
   from the live ``serve_*`` occupancy numbers: queued requests dominate
   (any queue loses to any free capacity), page and slot occupancy
   fractions break ties. In-process replicas are read directly; remote
   engines report through the heartbeat plane (``stats_fn=``), with ``GET
   /v1/serving`` as the fallback probe.
3. **Failover** — a full engine (admission queue at ``max_queue``, a
   drain, or a pool this request can never fit) is skipped and the next
   one takes the request; the fleet raises ``QueueFull`` (HTTP 429) only
   when EVERY engine refused.

Disaggregated prefill/decode: fresh prompts prefer the prefill pool (a
``role="decode"`` engine ranks after every other), and the fleet installs
a ``handoff_fn`` on each local prefill-role engine that places its finished
prefills' pages on the least-loaded decode engine — in process through
``inject_handoff``, or over ``POST /v1/migrate`` to a :class:`RemoteEngine`
whose token stream is relayed back into the caller's handle.

Routing decisions are telemetry: ``serve_fleet_routed_total`` /
``serve_fleet_affinity_total`` / ``serve_fleet_failover_total`` counters
and gauges of the same counts on ``node_stats()`` heartbeats, and a
``serve/route`` span whose attributes rank every candidate.

The fleet duck-types the engine surface the HTTP plane uses
(``submit``/``stats``/``start``/``close``), so
``MetricsServer(engine=ServingFleet(...))`` serves ``POST /v1/generate``
(priority included) and a fleet-aware ``GET /v1/serving`` unchanged.
"""

import json
import logging
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np

from tensorflowonspark_tpu_torch import telemetry
from tensorflowonspark_tpu_torch.serving import cache as cache_mod
from tensorflowonspark_tpu_torch.serving import engine as engine_mod
from tensorflowonspark_tpu_torch.serving.engine import QueueFull

logger = logging.getLogger(__name__)


class EngineUnavailable(RuntimeError):
    """A peer that could not be reached at submission time (connection
    refused, reset, timeout) — failover material like
    :class:`QueueFull`, but meaning unreachable rather than
    at-capacity."""


# The scalar gauges node_stats() ships on every heartbeat for a serving
# node — everything the router's load score consumes, plus the page
# size remote prefix-affinity needs to compute matching chain-hash
# keys.
SERVE_STAT_KEYS = ("serve_queued", "serve_active", "serve_slots",
                   "serve_pages_in_use", "serve_pages_total",
                   "serve_page_size")


def heartbeat_stats_fn(liveness=None, executor_id=None, store=None,
                       node=None, max_age=15.0):
    """A :class:`RemoteEngine` ``stats_fn`` wired straight into the
    heartbeat plane — no hand-rolled lambda digging through
    ``cluster_stats()`` dicts.

    Two sources, pick one:

    * ``liveness`` + ``executor_id`` — the cluster driver's
      :class:`~tensorflowonspark_tpu_torch.reservation.LivenessMonitor`
      (``cluster.liveness``): reads the node's latest heartbeat-borne
      stats dict. The canonical in-driver wiring; a departed/evicted
      node yields None and the router falls back to its HTTP probe.
    * ``store`` (+ optional ``node`` name) — a
      :class:`~tensorflowonspark_tpu_torch.telemetry_store.TelemetryStore`
      (``cluster.history``): assembles the ``serve_*`` gauges from the
      retained series. Works even after the cluster object is gone,
      since the store outlives relaunches.

    ``max_age`` is the staleness bound in seconds: a heartbeat older
    than this yields None, so least-loaded ranking can't act on a dead
    node's last-known occupancy — the router falls back to its probe
    (and the circuit breaker stays open). Matches the liveness plane's
    default stale threshold; ``max_age=None`` disables the bound."""
    if liveness is not None:
        if executor_id is None:
            raise ValueError("liveness source needs executor_id")
        inner = liveness.node_stats_fn(executor_id)
        if max_age is None:
            return inner
        def from_liveness():
            age = liveness.age(executor_id)
            if age is None or age > max_age:
                return None
            return inner()
        return from_liveness
    if store is not None:
        def from_store():
            out = {}
            newest = None
            for key in SERVE_STAT_KEYS:
                point = store.latest(key, node=node)
                if point is not None:
                    out[key] = point[1]
                    if newest is None or point[0] > newest:
                        newest = point[0]
            if not out:
                return None
            if max_age is not None \
                    and (newest is None
                         or store.now() - newest > max_age):
                return None
            # Non-numeric extras the store retains verbatim: the
            # prefix-index digest remote affinity matches against.
            digest = store.latest_extra("serve_prefix_digest", node)
            if digest:
                out["serve_prefix_digest"] = digest
            return out
        return from_store
    raise ValueError(
        "pass liveness=<LivenessMonitor> + executor_id, or "
        "store=<TelemetryStore> (+ node=)"
    )


def _load_score(queued, active, slots, pages_in_use, pages_total):
    """One float per engine, lower = less loaded. Queue depth dominates
    (an engine that would make the request WAIT loses to any engine
    with free capacity); slot and page occupancy fractions (each in
    [0, 1], jointly < 1 weighted) order the engines that would admit
    immediately."""
    return (float(queued)
            + 0.5 * float(active) / max(1.0, float(slots))
            + 0.5 * float(pages_in_use) / max(1.0, float(pages_total)))


class LocalEngine:
    """In-process replica: the router reads its scheduler/pool ledgers
    directly and submits straight into its queue."""

    remote = False

    def __init__(self, engine, name=None):
        self.engine = engine
        self.name = str(name) if name is not None else \
            "engine{}".format(id(engine) % 10000)

    @property
    def role(self):
        """The engine's disaggregation role: "prefill",
        "decode" or "both" — the router's pool assignment."""
        return getattr(self.engine, "role", "both")

    def load(self):
        sched = self.engine.scheduler
        pool = self.engine.pool
        with sched._lock:
            queued = len(sched.waiting)
            active = sum(1 for s in sched.slots if s is not None)
        return _load_score(queued, active, self.engine.max_slots,
                           pool.pages_in_use, pool.capacity)

    def match_tokens(self, prompt, keys_by_ps=None):
        """Tokens of this prompt already resident in the engine's
        prefix index (full-page granularity), via a read-only probe.
        ``keys_by_ps`` shares the sha1 chain pass across the replicas
        of one routing decision: replicas with one page size (the
        normal fleet) hash the prompt once, not once per engine."""
        if not self.engine.scheduler.prefix_share:
            return 0
        ps = self.engine.pool.page_size
        keys = None if keys_by_ps is None else keys_by_ps.get(ps)
        if keys is None:
            keys = cache_mod.prefix_keys(prompt, ps)
            if keys_by_ps is not None:
                keys_by_ps[ps] = keys
        return self.engine.pool.index_match_len(keys) * ps

    def queued(self):
        return self.engine.scheduler.queued()

    def available(self):
        return True

    def draining(self):
        """A draining engine (graceful scale-down) refuses
        new admissions — the router excludes it up front instead of
        discovering the QueueFull on every submit."""
        return bool(getattr(self.engine, "draining", False))

    def note_unavailable(self):
        pass

    def note_success(self):
        pass

    def submit(self, prompt, max_new_tokens, **kw):
        return self.engine.submit(prompt, max_new_tokens, **kw)

    def stats(self):
        return self.engine.stats()


class RemoteHandle(engine_mod.StreamConsumer):
    """Stream handle for a request routed to a remote engine: a daemon
    thread reads the NDJSON token stream and produces onto the shared
    :class:`~tensorflowonspark_tpu_torch.serving.engine.StreamConsumer`
    state machine, so ``stream()``/``result()`` behave exactly like a
    local :class:`~tensorflowonspark_tpu_torch.serving.engine.RequestHandle`.
    """

    def __init__(self, resp):
        super().__init__()
        self._resp = resp
        self.tail = None            # the terminal summary line
        self._thread = threading.Thread(
            target=self._read, name="fleet-remote-stream", daemon=True)
        self._thread.start()

    def _read(self):
        try:
            for line in self._resp:
                if not line.strip():
                    continue
                doc = json.loads(line.decode("utf-8"))
                if "token" in doc:
                    self._events.put(("token", int(doc["token"])))
                elif doc.get("done"):
                    self.tail = doc
                    if doc.get("error"):
                        self._events.put(("error", doc["error"]))
                    else:
                        self._events.put(("done", doc.get("state")))
                    return
            self._events.put(("error", "remote stream ended without a "
                                       "terminal line"))
        except Exception as e:
            self._events.put(("error", "{}: {}".format(
                type(e).__name__, e)))
        finally:
            try:
                self._resp.close()
            except Exception:
                pass

    @property
    def state(self):
        return (self.tail or {}).get("state")

    def cancel(self):
        """Close the connection — the remote engine cancels a request
        whose client disconnects mid-stream."""
        try:
            self._resp.close()
        except Exception:
            pass


class _HandoffRelay:
    """Sender-side pump for a remote handoff: reads the
    decode peer's ``/v1/migrate`` NDJSON token stream and produces onto
    the request's ORIGINAL handle, so the caller's
    ``stream()``/``result()`` contract survives the hop unchanged. It
    also stands in as ``handle._engine``: ``cancel()`` flags the
    request and closes the connection — the decode server's
    client-disconnect path then cancels its side, so pages free on
    BOTH engines."""

    def __init__(self, req, resp):
        self._req = req
        self._resp = resp
        if req.handle is not None:
            req.handle._engine = self
        self._thread = threading.Thread(
            target=self._read, name="fleet-handoff-relay", daemon=True)
        self._thread.start()

    def _cancel(self, req):
        req.cancel_requested = True
        try:
            self._resp.close()
        except Exception:
            pass

    def _finalize(self, state, error=None):
        req = self._req
        req.state = state
        req.t_done = time.perf_counter()
        if req.handle is not None:
            if error is not None:
                req.handle._events.put(("error", error))
            else:
                req.handle._events.put(("done", state))

    def _read(self):
        req = self._req
        try:
            # A cancel that landed between the ack and this thread's
            # start would otherwise be lost: close now and let the
            # disconnect path below settle both sides.
            if req.cancel_requested:
                self._cancel(req)
            for line in self._resp:
                if not line.strip():
                    continue
                doc = json.loads(line.decode("utf-8"))
                if "token" in doc:
                    tok = int(doc["token"])
                    req.generated.append(tok)
                    if req.handle is not None:
                        req.handle._events.put(("token", tok))
                elif doc.get("done"):
                    self._finalize(doc.get("state") or engine_mod.FINISHED,
                                   error=doc.get("error"))
                    return
            raise RuntimeError(
                "remote handoff stream ended without a terminal line")
        except Exception as e:
            if req.cancel_requested:
                self._finalize(engine_mod.CANCELLED)
            else:
                self._finalize(engine_mod.FAILED, error="{}: {}".format(
                    type(e).__name__, e))
        finally:
            try:
                self._resp.close()
            except Exception:
                pass


class RemoteEngine:
    """An engine on another host, behind its node's ``MetricsServer``.

    Load comes from the heartbeat plane when ``stats_fn`` is given — a
    callable returning that node's latest stats dict (the ``serve_*``
    keys ``node_stats()`` ships: e.g. ``lambda:
    cluster.cluster_stats()["nodes"][nid]["stats"]`` or a
    ``TelemetryStore`` latest-value lookup) — falling back to ``GET
    /v1/serving``. Submission is ``POST /v1/generate`` (streamed);
    prefix affinity is local-only (the chain-hash index lives in the
    remote pool; probing it per routing decision would cost a round
    trip per request — the heartbeat gauges deliberately stay scalar).
    """

    remote = True

    probe_ttl = 2.0     # seconds a fallback GET /v1/serving score lives
    failure_threshold = 3   # consecutive EngineUnavailable -> breaker opens
    breaker_reset = 5.0     # seconds before a half-open probe is allowed

    def __init__(self, url, name=None, stats_fn=None, timeout=300.0,
                 role="both"):
        self.url = url.rstrip("/")
        self.name = str(name) if name is not None else self.url
        self.stats_fn = stats_fn
        self.timeout = float(timeout)
        # Disaggregation role: the constructor value is a
        # hint; a successful /v1/serving probe adopts the peer's own
        # reported role (engine.stats() ships it).
        self.role = str(role or "both")
        self._probe = None          # (monotonic stamp, cached load score)
        self._stats_cache = None    # (stamp, payload dict | Exception)
        # Circuit breaker: `failure_threshold` consecutive
        # EngineUnavailable failovers open it — the router stops
        # ranking this peer entirely instead of paying the probe-TTL
        # connect timeout on every submit wave. A fresh heartbeat
        # through stats_fn closes it immediately (the staleness bound
        # in heartbeat_stats_fn makes "fresh" mean alive NOW); without
        # a heartbeat source, one probe submission is allowed through
        # every `breaker_reset` seconds (half-open).
        self._fail_streak = 0
        self._broken_at = None
        self.breaker_trips = 0

    def note_unavailable(self):
        """The fleet failed over past this peer on EngineUnavailable."""
        self._fail_streak += 1
        if self._fail_streak >= self.failure_threshold \
                and self._broken_at is None:
            self._broken_at = time.monotonic()
            self.breaker_trips += 1
            telemetry.inc("serve_fleet_breaker_trips_total")
            telemetry.event("serve/breaker_open", engine=self.name,
                            failures=self._fail_streak)

    def note_success(self):
        """A submission landed — streak over, breaker closed."""
        if self._broken_at is not None:
            telemetry.event("serve/breaker_close", engine=self.name)
        self._fail_streak = 0
        self._broken_at = None

    def available(self):
        """False while the breaker is open. Reopens on a fresh
        heartbeat, or (heartbeat-less peers) lets one half-open probe
        wave through per ``breaker_reset`` window."""
        if self._fail_streak < self.failure_threshold:
            return True
        if self._hb_stats() is not None:
            # The node is heartbeating again — close the breaker
            # without waiting for a successful submit.
            self.note_success()
            return True
        if self._broken_at is not None and \
                time.monotonic() - self._broken_at >= self.breaker_reset:
            self._broken_at = time.monotonic()   # re-arm the window
            return True
        return False

    def draining(self):
        return False

    @classmethod
    def from_heartbeats(cls, url, liveness=None, executor_id=None,
                        store=None, node=None, name=None, timeout=300.0):
        """A remote engine whose load scores come from the heartbeat
        plane (:func:`heartbeat_stats_fn`): pass the cluster's
        ``liveness`` monitor + the serving node's ``executor_id``, or the
        ``store`` (``cluster.history``) + node name."""
        return cls(url, name=name, timeout=timeout,
                   stats_fn=heartbeat_stats_fn(
                       liveness=liveness, executor_id=executor_id,
                       store=store, node=node))

    def _hb_stats(self):
        if self.stats_fn is None:
            return None
        try:
            return self.stats_fn() or None
        except Exception:
            logger.debug("fleet: stats_fn for %s failed", self.name,
                         exc_info=True)
            return None

    def load(self):
        hb = self._hb_stats()
        if hb is not None:
            return _load_score(
                hb.get("serve_queued", 0), hb.get("serve_active", 0),
                hb.get("serve_slots", 1),
                hb.get("serve_pages_in_use", 0),
                hb.get("serve_pages_total", 1))
        # Fallback probe, cached for probe_ttl (heartbeat cadence):
        # without it every submit would pay one blocking GET per remote
        # peer — and a full connect timeout per DEAD peer — inside the
        # routing decision.
        if self._probe is not None \
                and time.monotonic() - self._probe[0] < self.probe_ttl:
            return self._probe[1]
        try:
            st = self.stats()
            score = _load_score(st.get("queued", 0), st.get("active", 0),
                                st.get("slots", 1), st.get("in_use", 0),
                                st.get("capacity", 1))
        except Exception:
            # An unreachable engine sorts last; submission would fail
            # over anyway, but not re-probing it for a TTL saves the
            # repeated connect timeout.
            score = float("inf")
        self._probe = (time.monotonic(), score)
        return score

    def match_tokens(self, prompt, keys_by_ps=None):
        """Prefix affinity for a REMOTE pool: the peer's
        heartbeat ships a truncated chain-key digest of its prefix
        index (``serve_prefix_digest`` + ``serve_page_size``, via
        ``node_stats()``); matching the prompt's chain against it
        scores warm tokens without a round trip. Heartbeat-less peers
        keep scoring 0 — the digest never rides the ``/v1/serving``
        fallback probe, and affinity is an optimization, never a
        correctness input (the owning engine's admission matches full
        keys)."""
        hb = self._hb_stats()
        if not hb:
            return 0
        digest = hb.get("serve_prefix_digest")
        ps = int(hb.get("serve_page_size") or 0)
        if not digest or ps <= 0:
            return 0
        keys = None if keys_by_ps is None else keys_by_ps.get(ps)
        if keys is None:
            keys = cache_mod.prefix_keys(
                np.asarray(prompt, np.int32).reshape(-1), ps)
            if keys_by_ps is not None:
                keys_by_ps[ps] = keys
        have = {str(k) for k in digest}
        width = len(next(iter(have)))
        n = 0
        for key in keys:
            if key.hex()[:width] not in have:
                break
            n += 1
        return n * ps

    def submit_handoff(self, req, payload):
        """POST an encoded handoff to the peer's ``/v1/migrate`` and
        relay its token stream back into the request's ORIGINAL handle
        — the caller's ``stream()`` never notices the hop. Returns True
        once the peer acked admission (the relay thread then runs
        detached); raises :class:`QueueFull` / ValueError /
        :class:`EngineUnavailable` as failover material for the
        sender's colocated fallback."""
        http_req = urllib.request.Request(
            self.url + "/v1/migrate", data=payload,
            headers={"Content-Type": "application/octet-stream"},
            method="POST")
        try:
            resp = urllib.request.urlopen(http_req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = e.read().decode("utf-8", "replace").strip()
            except Exception:
                pass
            if e.code == 429:
                raise QueueFull("{}: {}".format(self.name, detail))
            raise ValueError("{}: HTTP {} {}".format(
                self.name, e.code, detail))
        except OSError as e:
            raise EngineUnavailable("{}: {}".format(self.name, e))
        line = resp.readline()
        try:
            ack = json.loads(line.decode("utf-8")) if line.strip() \
                else {}
        except ValueError:
            ack = {}
        if not ack.get("accepted"):
            try:
                resp.close()
            except Exception:
                pass
            raise ValueError("{}: migrate not acked: {!r}".format(
                self.name, bytes(line)[:200]))
        _HandoffRelay(req, resp)
        return True

    def queued(self):
        hb = self._hb_stats()
        if hb is not None:
            return int(hb.get("serve_queued", 0))
        return 0

    def submit(self, prompt, max_new_tokens, temperature=0.0,
               eos_token=None, top_k=0, top_p=0.0, priority=0,
               traceparent=None):
        payload = {
            "prompt": np.asarray(prompt, np.int32).reshape(-1).tolist(),
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "eos_token": eos_token, "top_k": int(top_k),
            "top_p": float(top_p), "priority": int(priority),
            "stream": True,
        }
        # Cross-process trace propagation: the router's
        # trace context rides the request body; the remote handler
        # adopts the trace id instead of minting one, so the remote
        # engine's spans and this hop's serve/route span merge into one
        # waterfall (scripts/request_trace.py --fleet).
        if traceparent:
            payload["traceparent"] = traceparent
        body = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            self.url + "/v1/generate", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = e.read().decode("utf-8", "replace").strip()
            except Exception:
                pass
            if e.code == 429:
                raise QueueFull("{}: {}".format(self.name, detail))
            raise ValueError("{}: HTTP {} {}".format(
                self.name, e.code, detail))
        except OSError as e:
            # URLError (connection refused/reset) and socket timeouts
            # both land here: the node died since its last heartbeat.
            # Surface it as failover material so the router tries the
            # next engine instead of failing the request.
            raise EngineUnavailable("{}: {}".format(self.name, e))
        handle = RemoteHandle(resp)
        parsed = telemetry.parse_traceparent(traceparent or "")
        if parsed:
            # Pre-tail trace visibility: _handle_summary and callers
            # can name the trace before the terminal NDJSON line lands.
            handle.trace = parsed[0]
        return handle

    def stats(self):
        """The peer's ``/v1/serving`` payload, cached for ``probe_ttl``
        (errors included — a blackholed peer must not stall every
        fleet ``stats()``/dashboard poll for the full socket timeout)."""
        now = time.monotonic()
        if self._stats_cache is not None \
                and now - self._stats_cache[0] < self.probe_ttl:
            cached = self._stats_cache[1]
            if isinstance(cached, Exception):
                raise cached
            return cached
        try:
            with urllib.request.urlopen(self.url + "/v1/serving",
                                        timeout=10.0) as r:
                doc = json.loads(r.read())
        except Exception as e:
            self._stats_cache = (now, e)
            raise
        self._stats_cache = (now, doc)
        if isinstance(doc, dict) and doc.get("role"):
            # Adopt the peer's self-reported disaggregation role: the
            # ctor hint can't go stale against a reconfigured peer.
            self.role = str(doc["role"])
        return doc


class ServingFleet:
    """Least-loaded + prefix-affinity router over N engines (see the
    module docstring for the policy). ``engines`` mixes raw
    :class:`ServingEngine` instances (wrapped as :class:`LocalEngine`),
    :class:`LocalEngine` and :class:`RemoteEngine`."""

    def __init__(self, engines, prefix_affinity=True,
                 affinity_max_queued=2):
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        self.engines = []
        for i, eng in enumerate(engines):
            if hasattr(eng, "load") and hasattr(eng, "submit"):
                self.engines.append(eng)
            else:
                self.engines.append(LocalEngine(
                    eng, name="engine{}".format(i)))
        names = [c.name for c in self.engines]
        if len(set(names)) != len(names):
            raise ValueError("engine names must be unique: {}"
                             .format(names))
        self.prefix_affinity = bool(prefix_affinity)
        # Affinity yields to load past this queue depth: a warm prefix
        # saves its prefill, but not a whole queue wait when an idle
        # replica could re-prefill immediately.
        self.affinity_max_queued = int(affinity_max_queued)
        self.routed = 0
        self.affinity_hits = 0
        self.failovers = 0
        self.per_engine = {c.name: 0 for c in self.engines}
        self._lock = threading.Lock()
        self._wire_handoffs()
        telemetry.set_gauge("serve_fleet_engines",
                            float(len(self.engines)))

    # -- membership (the registry follows the autoscaler) --------------------

    def add_engine(self, engine, name=None):
        """Register a replica at runtime (autoscaler scale-up). Accepts
        a raw ServingEngine (wrapped as :class:`LocalEngine`) or any
        engine client; returns the registered client."""
        if hasattr(engine, "load") and hasattr(engine, "submit") \
                and hasattr(engine, "name"):
            client = engine
        else:
            client = LocalEngine(engine, name=name)
        with self._lock:
            if any(c.name == client.name for c in self.engines):
                raise ValueError(
                    "engine name already registered: {}".format(
                        client.name))
            # Copy-on-write: submit/_rank iterate a snapshot, so the
            # registry can grow/shrink under live traffic without a
            # lock inside the routing hot path.
            self.engines = self.engines + [client]
            self.per_engine.setdefault(client.name, 0)
            n = len(self.engines)
        self._wire_handoffs()
        telemetry.set_gauge("serve_fleet_engines", float(n))
        telemetry.event("serve/fleet_add", engine=client.name, engines=n)
        return client

    def remove_engine(self, name):
        """Deregister a replica (autoscaler scale-down, after its drain
        completed). ``name`` may be the client name, the client, or the
        wrapped ServingEngine. Returns the removed client, or None.
        Does NOT close the engine — the drain owner does that."""
        with self._lock:
            victim = None
            for c in self.engines:
                if c is name or c.name == name \
                        or getattr(c, "engine", None) is name:
                    victim = c
                    break
            if victim is None:
                return None
            self.engines = [c for c in self.engines if c is not victim]
            n = len(self.engines)
        telemetry.set_gauge("serve_fleet_engines", float(n))
        telemetry.event("serve/fleet_remove", engine=victim.name,
                        engines=n)
        return victim

    # -- disaggregated handoff routing ---------------------------------------

    def _wire_handoffs(self):
        """Install the fleet's page-migration hop on every local
        prefill-role engine that doesn't already carry one: its
        finished prefills stream their KV pages to the least-loaded
        decode-pool engine. An engine with a user-supplied handoff_fn
        keeps it."""
        for c in list(self.engines):
            if getattr(c, "remote", False):
                continue
            # Duck-typed engine stands-ins (tests, adapters) may not
            # wrap a real ServingEngine — no .engine means no prefill
            # role to wire, not an error.
            eng = getattr(c, "engine", None)
            if eng is not None \
                    and getattr(eng, "role", "both") == "prefill" \
                    and getattr(eng, "handoff_fn", None) is None:
                eng.handoff_fn = self._make_handoff_fn(c)

    def _make_handoff_fn(self, src_client):
        def handoff(req, payload):
            return self._route_handoff(src_client, req, payload)
        return handoff

    def _route_handoff(self, src, req, payload):
        """Place a finished prefill's KV pages on a decode engine:
        decode-role preferred ("both" is the fallback tier), never the
        source, least-loaded first within a tier. Local engines adopt
        the live Request (and its handle) through ``inject_handoff``;
        remote engines take the payload over ``POST /v1/migrate`` and
        stream tokens back into the original handle. Returns False when
        every candidate refused — the source engine replays the request
        colocated."""
        cands = []
        for c in self._eligible():
            if c is src:
                continue
            role = getattr(c, "role", "both")
            if role == "prefill":
                continue
            if not getattr(c, "remote", False) \
                    and getattr(c, "engine", None) is None:
                continue   # duck-typed stand-in: no pool to inject into
            try:
                load = c.load()
            except Exception:
                load = float("inf")
            cands.append((role != "decode", load, c.name, c))
        cands.sort(key=lambda t: t[:3])
        for _, _, _, c in cands:
            try:
                if getattr(c, "remote", False):
                    ok = c.submit_handoff(req, payload)
                else:
                    c.engine.inject_handoff(payload, req=req)
                    ok = True
            except EngineUnavailable as e:
                logger.warning("fleet: handoff: %s", e)
                if hasattr(c, "note_unavailable"):
                    c.note_unavailable()
                telemetry.event(
                    "serve/handoff_attempt", trace=req.trace,
                    engine=c.name, outcome="unavailable")
                continue
            except (QueueFull, ValueError, OSError) as e:
                logger.warning("fleet: handoff to %s refused: %s",
                               c.name, e)
                telemetry.event(
                    "serve/handoff_attempt", trace=req.trace,
                    engine=c.name, outcome="refused")
                continue
            if ok:
                if hasattr(c, "note_success"):
                    c.note_success()
                telemetry.event(
                    "serve/handoff_attempt", trace=req.trace,
                    engine=c.name, outcome="accepted")
                return True
        return False

    # -- placement -----------------------------------------------------------

    def _eligible(self):
        """Engines the router may rank: drops open-breaker remotes and
        draining locals. Falls back to the full set when the filter
        would leave nothing — a request must surface a real refusal,
        not a silent empty ranking."""
        engines = list(self.engines)
        elig = []
        for c in engines:
            try:
                if not getattr(c, "available", lambda: True)():
                    continue
                if getattr(c, "draining", lambda: False)():
                    continue
            except Exception:
                pass
            elig.append(c)
        return elig or engines

    def _rank(self, prompt):
        """Engines in submission order, whether the head was an
        affinity choice, the probe's chain keys per page size (so the
        winning engine's admission reuses them instead of re-hashing
        the prompt), and a compact per-candidate ranking table (load
        score, affinity match length, eligibility) — the ``serve/route``
        span's attrs, so a trace shows WHY a request landed where it
        did."""
        keys_by_ps = {}
        engines = self._eligible()
        # Role-aware placement: fresh prompts prefer the
        # prefill pool — a decode-role engine ranks strictly after
        # every prefill/"both" engine regardless of load, so it only
        # takes a prompt when the prefill pool is empty, full, or
        # refusing (failover keeps working when a whole pool dies).
        scored = [(getattr(c, "role", "both") == "decode", c.load(), i, c)
                  for i, c in enumerate(engines)]
        scored.sort(key=lambda t: (t[0], t[1], t[2]))
        ranked = [c for _, _, _, c in scored]
        match_by_name = {}
        affinity = False
        if self.prefix_affinity and len(ranked) > 1:
            best, best_tokens = None, 0
            for c in engines:
                if getattr(c, "role", "both") == "decode":
                    # A warm prefix on a decode-role engine must not
                    # pull fresh prompts into the decode pool.
                    continue
                try:
                    m = c.match_tokens(prompt, keys_by_ps)
                except Exception:
                    m = 0
                match_by_name[c.name] = m
                if m > best_tokens:
                    best, best_tokens = c, m
            if best is not None \
                    and best.queued() <= self.affinity_max_queued:
                ranked.remove(best)
                ranked.insert(0, best)
                affinity = True
        ranking = []
        score_by_name = {c.name: s for _, s, _, c in scored}
        for c in ranked:
            entry = {"engine": c.name,
                     "score": round(score_by_name.get(c.name, 0.0), 4)}
            m = match_by_name.get(c.name, 0)
            if m:
                entry["match_tokens"] = int(m)
            ranking.append(entry)
        # Candidates the eligibility filter dropped (open breaker,
        # draining) still show up in the span — marked, not hidden.
        for c in self.engines:
            if c not in engines:
                ranking.append({
                    "engine": c.name,
                    "breaker_open": not getattr(
                        c, "available", lambda: True)(),
                    "draining": bool(getattr(
                        c, "draining", lambda: False)())})
        return ranked, affinity, keys_by_ps, ranking

    def submit(self, prompt, max_new_tokens, temperature=0.0,
               eos_token=None, top_k=0, top_p=0.0, priority=0,
               _trace=None):
        """Place the request and return the owning engine's handle.
        Raises :class:`QueueFull` only when every engine refused (the
        failover exhausted), :class:`EngineUnavailable` when engines
        were only lost to connection failures, a ValueError when no
        engine could EVER serve it. ``_trace`` (internal — a fleet
        behind another router's ``MetricsServer``) adopts an upstream
        trace id; otherwise the fleet mints the request's trace here,
        BEFORE placement, so the routing decision itself is the
        trace's first span (``serve/route``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        # Engine-INDEPENDENT validation up front (mirrors
        # engine.submit): a malformed request is invalid on every
        # engine, and letting it ride the failover loop would post the
        # full body to every remote peer before surfacing the 400.
        # Engine-DEPENDENT rejections (max_model_len, CacheFull
        # never-fits) stay failover material — a bigger replica may
        # genuinely take those.
        if prompt.size == 0:
            raise ValueError("prompt must contain at least one token")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if int(top_k or 0) < 0:
            raise ValueError("top_k must be >= 0")
        tp = float(top_p or 0.0)
        if tp and not 0.0 < tp <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        trace = _trace or uuid.uuid4().hex[:12]
        with telemetry.span("serve/route", trace=trace,
                            priority=int(priority)) as route_sp:
            ranked, affinity, keys_by_ps, ranking = self._rank(prompt)
            route_sp.set(candidates=ranking)
            queue_full = None
            last_err = None
            for i, client in enumerate(ranked):
                kw = {}
                if not getattr(client, "remote", False):
                    keys = keys_by_ps.get(client.engine.pool.page_size)
                    if keys is not None:
                        kw["_prefix_keys"] = keys
                    # In-process hop: the engine adopts the trace
                    # directly — no wire format needed.
                    kw["_trace"] = trace
                else:
                    # Cross-process hop: the trace context rides the
                    # POST body; the remote handler adopts it.
                    kw["traceparent"] = telemetry.make_traceparent(
                        trace, getattr(route_sp, "span_id", 0))
                try:
                    handle = client.submit(
                        prompt, max_new_tokens, temperature=temperature,
                        eos_token=eos_token, top_k=top_k, top_p=top_p,
                        priority=priority, **kw)
                except QueueFull as e:
                    queue_full = e
                    last_err = e
                    telemetry.event("serve/route_attempt", trace=trace,
                                    engine=client.name, attempt=i,
                                    outcome="queue_full")
                    continue
                except EngineUnavailable as e:
                    # Unreachable peer (died since its last heartbeat):
                    # skip it like a full one; it only surfaces when no
                    # engine at all took the request. Consecutive misses
                    # trip the peer's circuit breaker.
                    logger.warning("fleet: %s", e)
                    if hasattr(client, "note_unavailable"):
                        client.note_unavailable()
                    last_err = e
                    telemetry.event("serve/route_attempt", trace=trace,
                                    engine=client.name, attempt=i,
                                    outcome="unavailable")
                    continue
                except ValueError as e:
                    # CacheFull (never fits THIS pool) and validation
                    # errors both land here; a bigger replica may still
                    # take it, and if none does the last error surfaces.
                    last_err = e
                    telemetry.event("serve/route_attempt", trace=trace,
                                    engine=client.name, attempt=i,
                                    outcome="rejected")
                    continue
                if hasattr(client, "note_success"):
                    client.note_success()
                with self._lock:
                    self.routed += 1
                    self.per_engine.setdefault(client.name, 0)
                    self.per_engine[client.name] += 1
                    failover = i > 0 or queue_full is not None
                    if failover:
                        self.failovers += 1
                        telemetry.inc("serve_fleet_failover_total")
                    hit = affinity and i == 0
                    if hit:
                        self.affinity_hits += 1
                        telemetry.inc("serve_fleet_affinity_total")
                telemetry.inc("serve_fleet_routed_total")
                route_sp.set(
                    engine=client.name, affinity=hit, failover=failover,
                    attempts=i + 1,
                    request=handle.id if hasattr(handle, "id") else None)
                # Route summary for the cluster driver's /traces API: the
                # engine-side terminal summary merges with this by
                # trace id in TelemetryStore.
                telemetry.note_trace({
                    "trace": trace, "engine": client.name,
                    "affinity": hit, "failover": failover,
                    "priority": int(priority)})
                self._publish()
                return handle
            route_sp.set(engine=None, attempts=len(ranked))
        if queue_full is not None:
            raise QueueFull(
                "all {} engines at capacity (last: {})".format(
                    len(ranked), queue_full))
        raise last_err if last_err is not None else QueueFull(
            "no engines accepted the request")

    def _publish(self):
        with self._lock:
            telemetry.set_gauge("serve_fleet_routed", float(self.routed))
            telemetry.set_gauge("serve_fleet_affinity_hits",
                                float(self.affinity_hits))
            telemetry.set_gauge("serve_fleet_failovers",
                                float(self.failovers))
        # Circuit-breaker visibility: per-peer open/closed
        # as a labeled gauge, plus the fleet-wide open count and
        # lifetime trips as scalars that ride node_stats() heartbeats —
        # an open breaker is a dashboard fact, not a fleet internal.
        open_count = 0
        trips = 0
        for c in list(self.engines):
            if not getattr(c, "remote", False):
                continue
            # Side-effect-free read: available() would consume the
            # half-open probe window / close on a fresh heartbeat.
            is_open = getattr(c, "_broken_at", None) is not None
            open_count += int(is_open)
            trips += getattr(c, "breaker_trips", 0)
            telemetry.set_gauge("serve_breaker_open_peer",
                                float(is_open), engine=c.name)
        telemetry.set_gauge("serve_breaker_open", float(open_count))
        telemetry.set_gauge("serve_fleet_breaker_trips", float(trips))

    # -- engine-surface pass-throughs ----------------------------------------

    def start(self):
        """Start every local engine's background step loop."""
        for c in self.engines:
            if not getattr(c, "remote", False):
                c.engine.start()
        return self

    def close(self, timeout=5.0):
        for c in self.engines:
            if not getattr(c, "remote", False):
                c.engine.close(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def run_until_idle(self, timeout=300.0):
        """Drive every local engine inline, interleaved (tests, drills;
        a server uses ``start()``), until none has work or a handoff in
        flight."""
        deadline = time.monotonic() + timeout
        locals_ = [c.engine for c in self.engines
                   if not getattr(c, "remote", False)]
        while any(e.busy() for e in locals_):
            if not any([e.step() for e in locals_]):
                time.sleep(0.001)  # only handoff threads are working
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "fleet did not drain in {}s".format(timeout))

    def stats(self):
        """The fleet-aware ``/v1/serving`` payload: routing counters,
        per-engine stats, and fleet aggregates (per-priority queue
        depths merged across engines — starvation is a fleet-level
        question)."""
        engines = {}
        agg = {"queued": 0, "active": 0, "slots": 0, "in_use": 0,
               "capacity": 0, "finished": 0, "cancelled": 0,
               "failed": 0, "tokens_generated": 0, "prefix_hits": 0,
               "preemptions": 0, "preempted_waiting": 0}
        by_priority = {}
        for c in self.engines:
            try:
                st = c.stats()
            except Exception as e:
                st = {"error": "{}: {}".format(type(e).__name__, e)}
            engines[c.name] = st
            for key in agg:
                if isinstance(st.get(key), (int, float)):
                    agg[key] += st[key]
            for prio, depth in (st.get("queued_by_priority")
                                or {}).items():
                # Local engines report int classes; remote stats come
                # through JSON, which stringifies dict keys. Normalize
                # so one class never splits into two rows.
                try:
                    prio = int(prio)
                except (TypeError, ValueError):
                    pass
                by_priority[prio] = by_priority.get(prio, 0) + depth
        with self._lock:
            routing = {
                "routed": self.routed,
                "affinity_hits": self.affinity_hits,
                "failovers": self.failovers,
                "per_engine": dict(self.per_engine),
            }
        return {
            "fleet": True,
            "engines_total": len(self.engines),
            "queued_by_priority": dict(sorted(
                by_priority.items(),
                key=lambda kv: (isinstance(kv[0], str), kv[0]))),
            **agg,
            "routing": routing,
            "engines": engines,
        }
