"""The port's ``ServingFleet``: routing over local and HTTP replicas.

``_load_score`` equals the JAX router's over a grid of inputs, and the
same fake loads, roles, prefix matches and eligibility give the same rank
order, affinity choice and ranking table in both fleets. On real engines
(the toy fp32 geometry of ``tests/torch_serving_common.py``): least-loaded
spreading as the JAX fleet spreads, prefix affinity sending a shared-prompt
burst to the page holder, the prefill pool preferred with failover to
decode, failover with ``QueueFull`` only when every engine is full, a
remote engine routed over ``POST /v1/generate`` with heartbeat loads, an
unreachable peer skipped, and the HTTP surface (priority, the fleet-aware
``GET /v1/serving``, 503 when every peer is unreachable, ``/v1/migrate``
refusals). Streams equal the port's and the JAX package's solo
``generate``. Also the remote circuit breaker, the heartbeat staleness
bound, runtime membership and the process gauges summed over live
engines.
"""

import gc
import json
import socket
import types
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu.serving import fleet as jax_fleet
from tensorflowonspark_tpu_torch import reservation, serving, telemetry
from tensorflowonspark_tpu_torch.serving import engine as engine_mod
from tensorflowonspark_tpu_torch.serving import fleet as fleet_mod
from tensorflowonspark_tpu_torch.telemetry_store import TelemetryStore
from tensorflowonspark_tpu_torch.train.metrics import (
    MetricsServer, _handle_summary,
)
from torch_serving_common import (
    assert_drained, engine, jax_engine, jax_solo, models, prompt, solo,
)
from torch_serving_common import one_torch_thread  # noqa: F401

B_KW = dict(max_slots=2, num_pages=24)


def _post(url, doc, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode("utf-8"),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _dead_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()                      # nothing listens there any more
    return port


# -- the ranking, against the JAX router --------------------------------------


def test_load_score_equals_jax_over_a_grid():
    for queued in (0, 1, 3):
        for active in (0, 2, 4):
            for slots in (0, 1, 4):
                for used in (0, 5, 31):
                    for total in (0, 1, 31):
                        args = (queued, active, slots, used, total)
                        assert fleet_mod._load_score(*args) == \
                            jax_fleet._load_score(*args), args


class _FakeClient:
    """A duck-typed replica: load, role, prefix match, queue, eligibility."""

    remote = False

    def __init__(self, name, load=0.0, role="both", match=0, queued=0,
                 draining=False, available=True):
        self.name = name
        self.role = role
        self._load = load
        self._match = match
        self._queued = queued
        self._draining = draining
        self._available = available

    def load(self):
        return self._load

    def match_tokens(self, prompt, keys_by_ps=None):
        return self._match

    def queued(self):
        return self._queued

    def draining(self):
        return self._draining

    def available(self):
        return self._available

    def submit(self, *a, **kw):
        raise AssertionError("ranking only")


RANK_CASES = {
    "least_loaded": [dict(name="a", load=0.5), dict(name="b", load=0.1),
                     dict(name="c", load=0.3)],
    "ties_keep_order": [dict(name="a", load=0.2), dict(name="b", load=0.2)],
    "prefill_before_decode": [dict(name="d", load=0.0, role="decode"),
                              dict(name="p", load=0.9, role="prefill")],
    "affinity": [dict(name="a", load=0.1), dict(name="b", load=0.6,
                                                match=32, queued=1)],
    "affinity_past_queue_cap": [dict(name="a", load=0.1),
                                dict(name="b", load=3.6, match=32,
                                     queued=3)],
    "no_affinity_to_decode": [dict(name="p", load=0.4, role="prefill"),
                              dict(name="d", load=0.1, role="decode",
                                   match=64)],
    "ineligible_marked": [dict(name="a", load=0.4),
                          dict(name="b", load=0.0, draining=True),
                          dict(name="c", load=0.1, available=False)],
    "all_ineligible": [dict(name="a", load=0.4, draining=True),
                       dict(name="b", load=0.3, available=False)],
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_rank_order_equals_jax(case):
    p = prompt(40, seed=3)
    out = []
    for mod in (serving, jax_serving):
        clients = [_FakeClient(**kw) for kw in RANK_CASES[case]]
        fleet = mod.ServingFleet(clients)
        ranked, affinity, _, ranking = fleet._rank(p)
        out.append(([c.name for c in ranked], affinity, ranking))
    assert out[0] == out[1]


# -- real engines -------------------------------------------------------------


@pytest.mark.watchdog_timeout(120)
def test_least_loaded_spreads_as_the_jax_fleet():
    prompts = [prompt(12, seed=130 + i) for i in range(4)]
    got = {}
    for name, a, b in (("port", engine(), engine(**B_KW)),
                       ("jax", jax_engine(), jax_engine(**B_KW))):
        mod = serving if name == "port" else jax_serving
        fleet = mod.ServingFleet([a, b])
        handles = [fleet.submit(p, 6) for p in prompts]
        fleet.run_until_idle()
        st = fleet.stats()
        assert st["fleet"] and st["engines_total"] == 2
        assert st["routing"]["routed"] == 4
        # Queue depth dominates the score: with nothing stepped between
        # submissions the four requests alternate engines.
        assert all(n == 2 for n in st["routing"]["per_engine"].values())
        assert all(e["in_use"] == 0 for e in st["engines"].values())
        got[name] = [h.result(timeout=5) for h in handles]
    assert got["port"] == got["jax"] == [solo(p, 6) for p in prompts]


def _shared_prefix_prompts(seed, n, prefix_len=32, tail_len=3):
    rs = np.random.RandomState(seed)
    prefix = rs.randint(1, 64, size=prefix_len)
    return [np.concatenate([prefix, rs.randint(1, 64, size=tail_len)])
            .astype(np.int32) for _ in range(n)]


@pytest.mark.watchdog_timeout(120)
def test_prefix_affinity_routes_a_burst_to_the_page_holder():
    e1, e2 = engine(), engine(**B_KW)
    fleet = serving.ServingFleet([e1, e2])
    prompts = _shared_prefix_prompts(140, 4)
    first = fleet.submit(prompts[0], 4)
    fleet.run_until_idle()
    hits0 = (e1.prefix_hits, e2.prefix_hits)
    handles = [fleet.submit(p, 4) for p in prompts[1:]]
    fleet.run_until_idle()
    for p, h in zip(prompts, [first] + handles):
        assert h.result(timeout=5) == solo(p, 4) == jax_solo(p, 4)
    assert fleet.affinity_hits == 3
    gained = (e1.prefix_hits - hits0[0], e2.prefix_hits - hits0[1])
    assert sorted(gained) == [0, 3], gained
    assert_drained(e1)
    assert_drained(e2)
    fleet.close()


@pytest.mark.watchdog_timeout(120)
def test_router_prefers_the_prefill_pool_and_fails_over_to_decode():
    pre, dec = engine(role="prefill"), engine(role="decode")
    fleet = serving.ServingFleet([pre, dec])
    p = prompt(18, seed=60)
    h = fleet.submit(p, 5)
    fleet.run_until_idle()
    assert h.result(timeout=5) == solo(p, 5) == jax_solo(p, 5)
    assert pre.stats()["accepted"] == 1 and dec.stats()["accepted"] == 0
    assert dec.stats()["handoffs_in"] == 1
    pre.begin_drain()                  # the prefill pool refuses prompts
    h2 = fleet.submit(p, 5)
    fleet.run_until_idle()
    assert h2.result(timeout=5) == solo(p, 5)
    assert dec.stats()["accepted"] == 1 and fleet.failovers == 0
    pre.end_drain()
    assert_drained(pre)
    assert_drained(dec)
    fleet.close()


def test_failover_absorbs_and_queue_full_only_when_all_are_full():
    """One engine's queue at ``max_queue`` is a routing event, not a 429:
    the next engine absorbs; ``QueueFull`` surfaces only when EVERY
    engine refused. The JAX fleet over the same engines does the same."""
    m = models()
    counts = []
    for mod in (serving, jax_serving):
        kw = dict(max_slots=1, page_size=16, num_pages=3, decode_horizon=1)
        if mod is serving:
            e1 = mod.ServingEngine(m["tm"], None, max_queue=1,
                                   device="cpu", **kw)
            e2 = mod.ServingEngine(m["tm"], None, max_queue=2,
                                   device="cpu", **kw)
        else:
            e1 = mod.ServingEngine(m["jm"], m["variables"], max_queue=1,
                                   **kw)
            e2 = mod.ServingEngine(m["jm"], m["variables"], max_queue=2,
                                   **kw)
        fleet = mod.ServingFleet([e1, e2], prefix_affinity=False)
        handles = [fleet.submit(prompt(8, seed=150 + i), 4)
                   for i in range(3)]
        with pytest.raises(mod.QueueFull):
            for i in range(3):
                handles.append(fleet.submit(prompt(8, seed=160 + i), 4))
        counts.append((fleet.failovers, dict(fleet.per_engine)))
        for h in handles:
            h.cancel()
        e1.step()
        e2.step()
        for e in (e1, e2):
            assert e.pool.pages_in_use == 0 and e.scheduler.queued() == 0
        e1.close()
        e2.close()
    assert counts[0] == counts[1] and counts[0][0] >= 1


@pytest.mark.watchdog_timeout(120)
def test_remote_engine_routes_over_http_with_heartbeat_loads():
    local = engine()
    remote_eng = engine(**B_KW).start()
    server = MetricsServer(engine=remote_eng)
    server.start()
    try:
        liveness = reservation.LivenessMonitor(interval=0.5)
        liveness.expect(1, "worker")
        liveness.beat(1, state="running",
                      stats={"serve_queued": 0, "serve_active": 0,
                             "serve_slots": 2, "serve_pages_in_use": 0,
                             "serve_pages_total": 23})
        remote = serving.RemoteEngine.from_heartbeats(
            "http://127.0.0.1:{}".format(server.port), name="nodeB",
            liveness=liveness, executor_id=1)
        assert remote.load() < 1.0
        fleet = serving.ServingFleet(
            [serving.LocalEngine(local, name="local"), remote],
            prefix_affinity=False)
        # Two requests queued straight into the local engine: least-loaded
        # must place the fleet's request on the idle remote.
        busy = [local.submit(prompt(30, seed=171 + i), 8) for i in range(2)]
        p = prompt(10, seed=170)
        h = fleet.submit(p, 5)
        assert fleet.per_engine["nodeB"] == 1
        assert h.result(timeout=60) == solo(p, 5)
        assert h.state == serving.FINISHED and h.tail["done"]
        local.run_until_idle()
        assert [len(b.result(timeout=5)) for b in busy] == [8, 8]
    finally:
        server.stop()
        remote_eng.close()
    local.close()


def test_an_unreachable_remote_is_skipped():
    dead = serving.RemoteEngine(
        "http://127.0.0.1:{}".format(_dead_port()), name="dead",
        # A stale but rosy heartbeat ranks the dead peer FIRST.
        stats_fn=lambda: {"serve_queued": 0, "serve_active": 0,
                          "serve_slots": 8, "serve_pages_in_use": 0,
                          "serve_pages_total": 99})
    with pytest.raises(serving.EngineUnavailable):
        dead.submit(prompt(8, seed=190), 2)
    local = engine()
    fleet = serving.ServingFleet(
        [dead, serving.LocalEngine(local, name="local")],
        prefix_affinity=False)
    h = fleet.submit(prompt(8, seed=190), 3)
    local.run_until_idle()
    assert h.result(timeout=5) == solo(prompt(8, seed=190), 3)
    assert fleet.per_engine["local"] == 1 and fleet.failovers == 1
    local.close()


# -- the HTTP surface ---------------------------------------------------------


@pytest.mark.watchdog_timeout(120)
def test_http_priority_and_the_fleet_aware_serving_endpoint():
    fleet = serving.ServingFleet([engine(), engine(**B_KW)]).start()
    server = MetricsServer(engine=fleet)
    server.start()
    base = "http://127.0.0.1:{}".format(server.port)
    try:
        p = prompt(9, seed=180)
        with _post(base + "/v1/generate",
                   {"prompt": p.tolist(), "max_new_tokens": 5,
                    "priority": 3, "traceparent": "abc123def456-7"}) as r:
            lines = [json.loads(x) for x in r.read().splitlines() if x]
        assert [x["token"] for x in lines[:-1]] == solo(p, 5)
        assert lines[-1]["state"] == "FINISHED"
        assert lines[-1]["trace"] == "abc123def456"
        with urllib.request.urlopen(base + "/v1/serving", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["fleet"] and stats["engines_total"] == 2
        assert "queued_by_priority" in stats
        assert stats["routing"]["routed"] == 1
        for est in stats["engines"].values():
            assert "preemptions" in est and "queued_by_priority" in est
            assert "role" in est and "handoffs_out" in est
        # A fleet gateway holds no pool: /v1/migrate is refused at once.
        req = urllib.request.Request(base + "/v1/migrate", data=b"x",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 503
    finally:
        server.stop()
        fleet.close()


def test_http_503_when_every_fleet_peer_is_unreachable():
    fleet = serving.ServingFleet(
        [serving.RemoteEngine("http://127.0.0.1:{}".format(_dead_port()),
                              name="dead")],
        prefix_affinity=False)
    server = MetricsServer(engine=fleet)
    server.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post("http://127.0.0.1:{}/v1/generate".format(server.port),
                  {"prompt": [1], "max_new_tokens": 1}, timeout=10)
        assert err.value.code == 503
        assert "trace" in json.loads(err.value.read())
    finally:
        server.stop()


def test_migrate_endpoint_refusals():
    """``POST /v1/migrate``: a malformed payload is a 400, a draining
    engine a 429, and ``set_engine`` swaps the engine behind it."""
    eng = engine(role="decode")
    server = MetricsServer()
    server.start()
    url = "http://127.0.0.1:{}/v1/migrate".format(server.port)

    def post(data):
        req = urllib.request.Request(url, data=data, method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        return err.value.code

    try:
        assert post(b"junk") == 503            # nothing attached yet
        server.set_engine(eng)
        assert post(b"junk") == 400
        blobs = []
        pre = engine(role="prefill",
                     handoff_fn=lambda req, payload: blobs.append(payload))
        pre.submit(prompt(20, seed=3), 4)
        pre.run_until_idle()                   # refused: replayed here
        assert pre.stats()["handoff_fallbacks"] == 1
        payload = blobs[0]
        eng.begin_drain()
        assert post(payload) == 429
        pre.close()
    finally:
        server.stop()
        eng.close()


def test_fleet_stats_merges_remote_string_priority_keys():
    class _Peer(_FakeClient):
        def __init__(self, name, by_prio):
            super().__init__(name)
            self._by_prio = by_prio

        def stats(self):
            return {"queued": sum(self._by_prio.values()),
                    "queued_by_priority": dict(self._by_prio)}

    fleet = serving.ServingFleet(
        [_Peer("local", {0: 2, 1: 1}),
         _Peer("remote", {"0": 3, "1": 1, "bulk": 1})])
    depths = fleet.stats()["queued_by_priority"]
    assert depths == {0: 5, 1: 2, "bulk": 1}
    assert list(depths)[:2] == [0, 1]      # int classes sort first


def test_handle_summary_covers_remote_handles():
    class _Remoteish:
        state = "FINISHED"
        tail = {"request": "req-9", "trace": "tr-9", "state": "FINISHED",
                "ttft_ms": 12.5, "total_ms": 80.0}

    assert _handle_summary(_Remoteish()) == {
        "request": "req-9", "trace": "tr-9", "state": "FINISHED",
        "ttft_ms": 12.5, "total_ms": 80.0}

    class _Localish:
        id = "req-1"
        trace = "tr-1"
        state = "FINISHED"
        ttft = 0.010
        e2e = 0.050

    assert _handle_summary(_Localish()) == {
        "request": "req-1", "trace": "tr-1", "state": "FINISHED",
        "ttft_ms": 10.0, "total_ms": 50.0}


# -- membership, breaker, heartbeats, gauges ----------------------------------


def test_eligibility_excludes_draining_and_unavailable():
    a, b, c = _FakeClient("a"), _FakeClient("b"), _FakeClient("c")
    fl = serving.ServingFleet([a, b, c])
    assert fl._eligible() == [a, b, c]
    b._draining = True
    c._available = False
    assert fl._eligible() == [a]
    # Never an empty ranking: a request must meet a real refusal.
    a._draining = True
    assert fl._eligible() == [a, b, c]


def test_runtime_membership():
    a, b = _FakeClient("a"), _FakeClient("b")
    fl = serving.ServingFleet([a])
    assert fl.add_engine(b) is b
    assert [c.name for c in fl.engines] == ["a", "b"]
    with pytest.raises(ValueError):
        fl.add_engine(_FakeClient("b"))        # duplicate name
    assert fl.remove_engine("b") is b
    assert fl.remove_engine("b") is None       # idempotent
    assert fl.remove_engine(a) is a
    eng = engine()
    fl2 = serving.ServingFleet([eng])
    assert fl2.remove_engine(eng).engine is eng
    eng.close()


def test_remote_circuit_breaker_opens_and_half_opens(monkeypatch):
    eng = serving.RemoteEngine("http://127.0.0.1:9", name="r")
    eng.note_unavailable()
    eng.note_unavailable()
    assert eng.available()                     # under the threshold
    eng.note_unavailable()
    assert not eng.available() and eng.breaker_trips == 1
    eng.note_success()
    assert eng.available() and eng._fail_streak == 0
    monkeypatch.setattr(eng, "breaker_reset", 0.0)
    for _ in range(3):
        eng.note_unavailable()
    assert eng.available()                     # reset elapsed: one probe
    monkeypatch.setattr(eng, "breaker_reset", 60.0)
    assert not eng.available()                 # the window re-armed


def test_remote_breaker_closes_on_a_fresh_heartbeat():
    beat = {"on": False}
    eng = serving.RemoteEngine(
        "http://127.0.0.1:9", name="r",
        stats_fn=lambda: {"serve_queued": 0} if beat["on"] else None)
    for _ in range(3):
        eng.note_unavailable()
    assert not eng.available()
    beat["on"] = True
    assert eng.available() and eng._fail_streak == 0


def test_heartbeat_stats_fn_staleness_bound():
    t = [100.0]
    store = TelemetryStore(clock=lambda: t[0])
    store.ingest("serve3", {"serve_queued": 2.0, "serve_active": 1.0})
    fn = serving.heartbeat_stats_fn(store=store, node="serve3", max_age=15.0)
    assert fn() == {"serve_queued": 2.0, "serve_active": 1.0}
    t[0] = 114.0
    assert fn() is not None
    t[0] = 116.0
    assert fn() is None                        # older than max_age
    store.ingest("serve3", {"serve_queued": 0.0}, ts=t[0])
    assert fn() == {"serve_queued": 0.0, "serve_active": 1.0}
    t[0] = 1e6
    assert serving.heartbeat_stats_fn(store=store, node="serve3",
                                      max_age=None)() is not None
    stats = {"serve_queued": 1.0}
    age = [0.5]
    liveness = types.SimpleNamespace(
        node_stats_fn=lambda eid: (lambda: dict(stats)),
        age=lambda eid: age[0])
    fn = serving.heartbeat_stats_fn(liveness=liveness, executor_id=3)
    assert fn() == {"serve_queued": 1.0}
    age[0] = 16.0
    assert fn() is None
    age[0] = None                              # never heartbeated
    assert fn() is None
    with pytest.raises(ValueError):
        serving.heartbeat_stats_fn(liveness=liveness)
    with pytest.raises(ValueError):
        serving.heartbeat_stats_fn()


def test_serve_gauges_sum_over_live_engines():
    """In-process replicas share the process gauges: values are sums over
    live engines, one engine's ``close()`` leaves a sibling's numbers,
    and an engine dropped without ``close()`` leaves the registry."""
    gc.collect()
    engine_mod._publish_gauges()
    base = telemetry.get_gauge("serve_pages_total")
    extra = engine(max_slots=1, num_pages=7)
    cap = extra.pool.capacity
    assert telemetry.get_gauge("serve_pages_total") == base + cap
    sibling = engine()
    sibling._publish()
    assert telemetry.get_gauge("serve_pages_total") == \
        base + cap + sibling.pool.capacity
    extra.close()
    sibling.close()
    assert telemetry.get_gauge("serve_pages_total") == base
    dropped = engine(max_slots=1, num_pages=7)
    ref = weakref.ref(dropped)
    del dropped
    gc.collect()
    assert ref() is None
    engine_mod._publish_gauges()
    assert telemetry.get_gauge("serve_pages_total") == base
