"""The port's SLO monitor, autoscaler and graceful drain, against JAX.

Policy: the JAX and the port ``Autoscaler`` run over the same fake fleet
and clock (``evaluate(now=)``/``step(now=)``) and must make the same
sequence of decisions with the same reasons (the ``cluster/*`` events and
their attributes): queue pressure, priority weights, burn rate delivered
by each side's own ``SLOMonitor`` through ``add_policy_callback``,
cooldowns, min/max bounds, a fast-window breach or a busy load blocking
scale-down, the drain lifecycle through ``retire_fn``. The monitors' burn
states equal on one series.

Drains, on real engines stepped inline (never raced against a sleep):
admission refused, a cancel completing a drain, a migrated stream bitwise
solo-equal and equal to the JAX package's own migration drill, recompute
across page sizes, queued and mid-prefill requests moving with fresh
semantics, every ledger balanced; and the autoscaler taking real engines
from 1 replica to 2 under queue pressure and back to 1 through a drain
with migration, its per-drain ledger audit holding.
"""

import types

import numpy as np
import pytest

from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu import telemetry_store as jax_store
from tensorflowonspark_tpu.serving import autoscaler as jax_autoscaler
from tensorflowonspark_tpu_torch import serving, telemetry_store
from tensorflowonspark_tpu_torch.serving import autoscaler as autoscaler_mod
from torch_serving_common import (
    ENGINE_KW, assert_drained, engine, jax_solo, models, prompt, solo,
)
from torch_serving_common import one_torch_thread  # noqa: F401

SIDES = {"port": (autoscaler_mod, telemetry_store),
         "jax": (jax_autoscaler, jax_store)}


# -- fakes the policy loop drives ---------------------------------------------


class FakeEngine:
    """The drain surface the autoscaler drives on a victim."""

    def __init__(self):
        self.draining = False
        self.drained = False
        self.closed = False
        self.migrations = 0
        self.requests_accepted = 0
        self.requests_finished = 0
        self.requests_cancelled = 0
        self.requests_failed = 0
        self.migrated_in = 0
        self.migrated_out = 0

    def begin_drain(self):
        self.draining = True

    def is_drained(self):
        return self.draining and self.drained

    def migrate_requests(self, dest):
        self.migrations += 1
        self.drained = True
        return ["moved"]

    def close(self, timeout=None):
        self.closed = True


class FakeClient:
    remote = False

    def __init__(self, name, engine=None, load=0.0):
        self.name = name
        self.engine = engine or FakeEngine()
        self._load = load

    def load(self):
        return self._load

    def draining(self):
        return self.engine.draining


class FakeFleet:
    def __init__(self, clients):
        self.engines = list(clients)
        self.queued_by_priority = {}

    def stats(self):
        return {"queued_by_priority": dict(self.queued_by_priority)}

    def add_engine(self, engine, name=None):
        client = FakeClient(name, engine=engine)
        self.engines = self.engines + [client]
        return client

    def remove_engine(self, client):
        self.engines = [c for c in self.engines if c is not client]
        return client


class _Events:
    """Stands in for an autoscaler module's ``telemetry``: keeps the
    events, drops the gauges."""

    def __init__(self):
        self.log = []

    def event(self, name, **attrs):
        self.log.append((name, attrs))

    def set_gauge(self, *a, **kw):
        pass

    def take(self):
        out, self.log = self.log, []
        return out


class _Run:
    """One side's autoscaler over a fake fleet of ``n`` replicas."""

    def __init__(self, side, monkeypatch, policy_kw, n=1):
        mod, store_mod = SIDES[side]
        self.events = _Events()
        monkeypatch.setattr(mod, "telemetry", self.events)
        self.t = [0.0]
        self.fleet = FakeFleet([FakeClient("e{}".format(i))
                                for i in range(n)])
        self.spawned, self.retired = [], []
        self.store_mod = store_mod

        def spawn(name):
            self.spawned.append(name)
            return FakeEngine()

        self.scaler = mod.Autoscaler(
            self.fleet, store=None, policy=mod.AutoscalePolicy(**policy_kw),
            spawn_fn=spawn, retire_fn=self.retired.append,
            clock=lambda: self.t[0])
        self.trace = []

    def at(self, t):
        self.t[0] = float(t)

    def decide(self):
        d = self.scaler.evaluate()
        self.trace.append(("evaluate", self.t[0], d, self.events.take()))
        return d

    def poll(self, now):
        done = self.scaler.poll_drains(now=now)
        self.trace.append(("poll", now, [x.client.name for x in done],
                           self.events.take()))
        return done


def _burn_state(firing, fast_frac, metric="serve_ttft_ms_p95"):
    return {
        "slo": types.SimpleNamespace(metric=metric),
        "windows": [
            {"window_s": 15.0, "burn": 0.5, "breach_frac": fast_frac,
             "points": 30},
            {"window_s": 60.0, "burn": 0.1,
             "breach_frac": 1.0 if firing else 0.0, "points": 120},
        ],
        "firing": firing, "enough": True, "now": 0.0,
    }


def _queue_pressure(r):
    r.fleet.queued_by_priority = {0: 8}
    r.decide()                                  # up
    r.decide()                                  # cooldown holds
    r.at(6.0)
    r.decide()                                  # up again
    r.at(12.0)
    r.decide()                                  # max_replicas holds
    assert r.spawned == ["auto1", "auto2"]


def _priority_weights(r):
    r.fleet.queued_by_priority = {0: 2}         # weighs 2.0 < 2.9
    r.decide()
    r.fleet.queued_by_priority = {1: 2}         # 2 x 1.5 = 3.0 >= 2.9
    r.decide()
    assert r.spawned == ["auto1"]


def _burn_through_the_monitor(r):
    """The burn level reaches the autoscaler through each side's own
    ``SLOMonitor`` policy callback, fed the same TTFT series."""
    store = r.store_mod.TelemetryStore(clock=lambda: r.t[0])
    monitor = store.set_slos([r.store_mod.SLO(
        "serve_ttft_ms_p95", "<", 250.0,
        windows=((15.0, 0.5), (60.0, 0.1)), min_points=3)])
    r.scaler.attach(monitor)
    for i in range(20):
        store.append("cluster", "serve_ttft_ms_p95",
                     100.0 if i < 12 else 900.0, ts=float(i))
        r.at(float(i))
        monitor.evaluate(now=float(i))
        r.decide()
    assert r.spawned


def _other_metric_ignored(r):
    r.scaler.on_slo_state(_burn_state(True, 1.0, metric="other_metric"))
    r.decide()
    assert not r.spawned


def _scale_down_lifecycle(r):
    r.scaler.on_slo_state(_burn_state(firing=False, fast_frac=0.0))
    r.decide()                                  # quiet clock starts
    r.at(2.0)
    r.decide()                                  # 2 s < stable_down_s
    r.at(4.5)
    r.decide()                                  # down: drain begins
    victim = r.scaler.drains[0]
    r.at(20.0)
    r.decide()                                  # one drain at a time
    r.poll(5.0)                                 # inside the grace
    r.poll(8.0)                                 # migrate, finalize
    r.at(60.0)
    r.decide()                                  # min_replicas floor
    assert victim.engine.closed and r.retired == [victim.client]
    audit = r.scaler.drain_audits[0] if hasattr(
        r.scaler, "drain_audits") else None
    if audit is not None:
        assert audit["ok"] and audit["migrated"] == 1


def _fast_window_blocks(r):
    r.scaler.on_slo_state(_burn_state(firing=True, fast_frac=1.0))
    r.decide()
    r.at(10.0)
    r.decide()                                  # still breaching
    r.scaler.on_slo_state(_burn_state(firing=True, fast_frac=0.0))
    r.at(11.0)
    r.decide()                                  # quiet starts now
    r.at(15.0)
    r.decide()                                  # down


def _busy_blocks(r):
    for c in r.fleet.engines:
        c._load = 0.9
    r.decide()
    r.at(5.0)
    r.decide()                                  # quiet, stable, busy
    for c in r.fleet.engines:
        c._load = 0.1
    r.at(10.0)
    r.decide()                                  # down


SCENARIOS = {
    "queue_pressure_cooldown_max": (
        _queue_pressure, dict(queue_high=2.0, max_replicas=3,
                              cooldown_up_s=5.0, priority_weight=0.5), 1),
    "priority_weights": (
        _priority_weights, dict(queue_high=2.9, priority_weight=0.5), 1),
    "burn_through_the_monitor": (_burn_through_the_monitor, {}, 1),
    "other_metric_ignored": (_other_metric_ignored, {}, 1),
    "scale_down_lifecycle_min_bound": (
        _scale_down_lifecycle, dict(
            queue_high=2.0, busy_load=0.75, min_replicas=1, max_replicas=3,
            cooldown_up_s=1.0, cooldown_down_s=5.0, stable_down_s=4.0,
            drain_grace_s=2.0), 2),
    "fast_window_blocks_quiescence": (
        _fast_window_blocks, dict(queue_high=2.0, max_replicas=2,
                                  cooldown_up_s=100.0, cooldown_down_s=1.0,
                                  stable_down_s=3.0), 2),
    "busy_load_blocks_scale_down": (
        _busy_blocks, dict(queue_high=5.0, busy_load=0.5,
                           cooldown_down_s=1.0, stable_down_s=1.0), 2),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_and_reasons_equal_jax(name, monkeypatch):
    script, policy_kw, n = SCENARIOS[name]
    traces = {}
    for side in SIDES:
        r = _Run(side, monkeypatch, policy_kw, n=n)
        script(r)
        traces[side] = r.trace
    assert traces["port"] == traces["jax"]


def test_policy_bounds_validation():
    for mod in (autoscaler_mod, jax_autoscaler):
        with pytest.raises(ValueError):
            mod.AutoscalePolicy(min_replicas=0)
        with pytest.raises(ValueError):
            mod.AutoscalePolicy(min_replicas=3, max_replicas=2)


def test_slo_monitor_burn_states_equal_jax():
    """Both monitors over one series: the same per-pass states (window
    evidence, firing level, data sufficiency), edges and status."""
    series = ([120.0] * 10 + [400.0] * 25 + [90.0] * 40)
    out = {}
    for side, (_, store_mod) in SIDES.items():
        t = [0.0]
        store = store_mod.TelemetryStore(clock=lambda: t[0])
        monitor = store.set_slos(
            ["serve_ttft_ms_p95 < 250",
             {"metric": "serve_ttft_ms_p95", "op": "<", "threshold": 300.0,
              "windows": [[10.0, 0.5], [40.0, 0.2]], "name": "tight"}])
        states = []
        monitor.add_policy_callback(lambda st: states.append(
            dict(st, slo=st["slo"].to_dict())))
        fired = []
        for i, v in enumerate(series):
            t[0] = float(i * 2)
            store.append("cluster", "serve_ttft_ms_p95", v, ts=t[0])
            fired.append([f["slo"]["name"] for f in
                          monitor.evaluate(now=t[0])])
        out[side] = (states, fired, monitor.status())
    assert out["port"] == out["jax"]
    assert any(out["port"][1]) and any(s["firing"] for s in out["port"][0])


# -- graceful drain on real engines -------------------------------------------


def _ledger(eng):
    s = eng.stats()
    return (s["accepted"] + s["migrated_in"]
            == s["finished"] + s["cancelled"] + s["failed"]
            + s["migrated_out"])


def _until_decoding(eng, *handles):
    """Step until every handle is RUNNING with at least one token."""
    for _ in range(50):
        if all(h.state == serving.RUNNING and h._req.generated
               for h in handles):
            return
        eng.step()
    raise AssertionError("requests never started decoding")


def test_drain_refuses_admission_and_a_zero_resident_drain():
    eng = engine()
    eng.begin_drain()
    assert eng.draining and eng.stats()["draining"]
    with pytest.raises(serving.QueueFull):
        eng.submit(prompt(8), 4)
    assert eng.is_drained()              # nothing resident: done at once
    eng.end_drain()
    h = eng.submit(prompt(8), 4)
    eng.run_until_idle()
    assert h.result(timeout=5) == solo(prompt(8), 4)
    assert eng.requests_accepted == 1
    eng.close()


def test_a_cancel_during_a_drain_completes_it():
    eng = engine()
    h = eng.submit(prompt(10, seed=1), 96)
    _until_decoding(eng, h)
    eng.begin_drain()
    assert not eng.is_drained()          # one resident stream
    h.cancel()
    eng.step()
    assert h.state == serving.CANCELLED and eng.is_drained()
    st = eng.stats()
    assert st["accepted"] == 1 and st["cancelled"] == 1
    assert st["in_use"] == 0 and _ledger(eng)
    eng.close()


def _migration_drill(src, dst, p, n):
    h = src.submit(p, n)
    _until_decoding(src, h)
    src.begin_drain()
    moved = src.migrate_requests(dst)
    assert len(moved) == 1 and src.is_drained()
    dst.run_until_idle()
    assert h.state == serving.FINISHED
    return h.result(timeout=5)


@pytest.mark.watchdog_timeout(120)
def test_drain_migration_resumes_bitwise_and_equals_the_jax_drill():
    p = prompt(12, seed=2)
    src, dst = engine(), engine()
    got = _migration_drill(src, dst, p, 24)
    m = models()
    jsrc = jax_serving.ServingEngine(m["jm"], m["variables"], **ENGINE_KW)
    jdst = jax_serving.ServingEngine(m["jm"], m["variables"], **ENGINE_KW)
    assert got == solo(p, 24) == _migration_drill(jsrc, jdst, p, 24)
    s_src, s_dst = src.stats(), dst.stats()
    assert s_src["accepted"] == 1 and s_src["migrated_out"] == 1
    assert s_src["finished"] == 0 and s_src["failed"] == 0
    assert s_dst["migrated_in"] == 1 and s_dst["finished"] == 1
    assert s_dst["preempt_recomputes"] == 0      # the pages travelled
    assert _ledger(src) and _ledger(dst)
    assert_drained(src)
    assert_drained(dst)
    src.close()
    dst.close()


@pytest.mark.watchdog_timeout(120)
def test_migration_across_page_sizes_replays_by_recompute():
    p = prompt(20, seed=4)
    src, dst = engine(), engine(page_size=8, num_pages=64)
    assert _migration_drill(src, dst, p, 16) == solo(p, 16) == \
        jax_solo(p, 16)
    assert dst.scheduler.prefix_share and dst.prefix_hits == 0
    assert _ledger(src) and _ledger(dst)
    assert_drained(dst)
    src.close()
    dst.close()


@pytest.mark.watchdog_timeout(120)
def test_queued_and_prefilling_requests_move_with_fresh_semantics():
    """A request mid-prefill (its 40-token prompt prefills in 16-token
    chunks) and two queued behind a full slot set move; a request with a
    cancel pending stays behind and is cancelled here."""
    src = engine(max_slots=1, prefill_chunk=16, prefill_floor=16)
    dst = engine()
    a = src.submit(prompt(40, seed=5), 6)
    b = src.submit(prompt(9, seed=6), 5)
    c = src.submit(prompt(11, seed=7), 5)
    d = src.submit(prompt(7, seed=8), 5)
    src.step()                                # a: first chunk
    assert a.state == serving.PREFILL
    d.cancel()
    src.begin_drain()
    moved = src.migrate_requests(dst)
    assert [r.id for r in moved] == [a.id, b.id, c.id]
    src.step()                                # d's cancel settles here
    assert d.state == serving.CANCELLED and src.is_drained()
    dst.run_until_idle()
    for h, (n, seed, new) in zip((a, b, c), ((40, 5, 6), (9, 6, 5),
                                            (11, 7, 5))):
        assert h.result(timeout=5) == solo(prompt(n, seed), new)
    s = src.stats()
    assert s["migrated_out"] == 3 and s["cancelled"] == 1
    assert _ledger(src) and _ledger(dst)
    assert_drained(src)
    assert_drained(dst)
    src.close()
    dst.close()


@pytest.mark.watchdog_timeout(120)
def test_autoscaler_scales_real_engines_up_and_down_through_a_drain():
    """Queue pressure takes a one-replica fleet to two (``spawn_fn``
    builds and warms an engine); quiet load takes it back to one through
    a drain whose residents migrate with their pages; the ledger audit
    holds with nothing failed or cancelled, and every stream equals solo
    ``generate``."""
    t = [0.0]
    first = engine()
    fleet = serving.ServingFleet([first])
    built = []

    def spawn(name):
        eng = engine()
        h = eng.submit(prompt(5, seed=99), 2)          # warm
        eng.run_until_idle()
        h.result(timeout=5)
        built.append(eng)
        return eng

    policy = serving.AutoscalePolicy(
        queue_high=2.0, busy_load=0.75, min_replicas=1, max_replicas=2,
        cooldown_up_s=1.0, cooldown_down_s=5.0, stable_down_s=2.0,
        drain_grace_s=1.0)
    scaler = serving.Autoscaler(fleet, store=None, policy=policy,
                                spawn_fn=spawn, clock=lambda: t[0])
    load = [(prompt(10 + i, seed=200 + i), 12) for i in range(6)]
    handles = [fleet.submit(p, n) for p, n in load]
    assert scaler.step(now=0.0) == "scale_up"
    assert scaler.stats()["replicas"] == 2 and len(built) == 1
    fleet.run_until_idle()                    # the first wave, one replica
    # A second wave spreads over both replicas and starts decoding.
    wave = [(prompt(14 + i, seed=300 + i), 20) for i in range(4)]
    handles += [fleet.submit(p, n) for p, n in wave]
    for eng in (first, built[0]):
        eng.step()
        eng.step()
    assert all(e.scheduler.active() for e in (first, built[0]))
    assert scaler.step(now=10.0) is None      # quiet clock starts
    assert scaler.step(now=13.0) == "scale_down"
    victim = scaler.drains[0]
    assert scaler.step(now=13.5) is None and victim.engine.draining
    scaler.step(now=14.5)                     # past the grace: migrate
    assert not scaler.drains and victim.migrated >= 1
    assert scaler.stats()["replicas"] == 1 and len(fleet.engines) == 1
    (audit,) = scaler.stats()["drain_audits"]
    assert audit["ok"] and audit["balanced"] and audit["dropped"] == 0
    fleet.run_until_idle()
    for h, (p, n) in zip(handles, load + wave):
        assert h.state == serving.FINISHED
        assert h.result(timeout=5) == solo(p, n)
    survivor = fleet.engines[0].engine
    assert survivor.stats()["migrated_in"] == victim.migrated
    assert survivor.stats()["preempt_recomputes"] == 0
    assert_drained(survivor)
    fleet.close()
    np.testing.assert_equal(scaler.stats()["scale_ups"], 1)
    np.testing.assert_equal(scaler.stats()["scale_downs"], 1)
