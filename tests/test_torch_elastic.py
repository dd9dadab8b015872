"""The port's elastic membership (``elastic.py``, the reservation server's
elastic mode, the node's resize directives) against the JAX package's.

* Wire parity: the port's ``Client`` heartbeats to a JAX elastic
  ``Server`` and the JAX ``Client`` to the port's. In both directions a
  departure, its acknowledgement and a rejoin give the same directives,
  incarnations, completeness bar and membership gauges (also merged into
  ``cluster_stats()`` under ``"cluster"``): the cases of
  ``tests/test_elastic.py`` but its compile-cache ones (ROADMAP A12).
* ``ElasticConfig.normalize`` and ``NodeContext.poll_resize`` (one-shot
  per epoch) as in the JAX package, and the heartbeat sender's
  ``_apply_resize`` publishing a directive once and acking its epoch.
* The drill on the port: three ``LocalBackend`` executors train
  ``testing.programs.elastic_linreg_fun`` (device ``"cpu"``) under
  ``elastic=dict(min_nodes=2, rejoin_delay=1.0)``; the node that reaches
  step 3 first is preempted (notice, then SIGTERM); the survivors reshape,
  a replacement rejoins from its committed step, the cluster re-expands to
  three, and the supervisor's restart count stays 0 — the assertions of
  ``tests/test_elastic.py``'s drill. The controller's policy departures
  (``retire_replica``/``spawn_replica``) on a two-node cluster.
"""

import os
import time

import numpy as np
import pytest

from tensorflowonspark_tpu import reservation as jax_res
from tensorflowonspark_tpu_torch import backend, cluster, node, reservation
from tensorflowonspark_tpu_torch.elastic import ElasticConfig
from tensorflowonspark_tpu_torch.supervisor import RestartPolicy
from tensorflowonspark_tpu_torch.testing import faults, programs

pytestmark = pytest.mark.watchdog_timeout(120)

TRUE_W = (1.5, -2.0)
BIAS = 0.25
HEARTBEAT = dict(heartbeat_interval=0.25, heartbeat_miss_budget=10)

PAIRS = [(jax_res.Server, reservation.Client),
         (reservation.Server, jax_res.Client),
         (reservation.Server, reservation.Client)]
IDS = ["jax-server-port-client", "port-server-jax-client", "port-port"]


def test_elastic_config_normalize():
    assert ElasticConfig.normalize(None) is None
    assert ElasticConfig.normalize(False) is None
    cfg = ElasticConfig.normalize(True)
    assert isinstance(cfg, ElasticConfig) and cfg.min_nodes == 1
    cfg = ElasticConfig.normalize({"min_nodes": 2, "rejoin": False})
    assert cfg.min_nodes == 2 and cfg.rejoin is False
    same = ElasticConfig(min_nodes=3)
    assert ElasticConfig.normalize(same) is same
    with pytest.raises(TypeError, match="elastic="):
        ElasticConfig.normalize("yes")
    assert ElasticConfig(min_nodes=0).min_nodes == 1


@pytest.mark.parametrize("server_cls,client_cls", PAIRS, ids=IDS)
def test_depart_publishes_resize_directive_and_ack_stops_resend(
        server_cls, client_cls):
    server = server_cls(3, elastic=True, min_nodes=1, **HEARTBEAT)
    addr = server.start()
    c = client_cls(addr)
    try:
        for eid in range(3):
            c.register({"executor_id": eid, "port": 4000 + eid,
                        "addr": ("127.0.0.1", 4000 + eid), "authkey": "00"})
        assert server.reservations.done()
        assert server.membership()["epoch"] == 0
        assert "resize" not in c.heartbeat(0, state="running")

        meta = server.depart(1, reason="crashed")
        assert meta["executor_id"] == 1
        assert server.depart(1) is None  # a double departure is a no-op
        m = server.membership()
        assert m["epoch"] == 1 and m["world_size"] == 2
        assert m["departures"] == 1 and m["resizes"] == 1

        reply = c.heartbeat(0, state="running")
        directive = reply.get("resize")
        assert directive == {"epoch": 1, "world_size": 2, "members": [0, 2],
                             "roles": {}, "reason": "crashed",
                             "executor_id": 1}
        # Echoing the epoch acks it: the server stops re-sending.
        reply = c.heartbeat(0, state="running", epoch=1)
        assert "resize" not in reply
        assert server.membership()["acked"][0] == 1
        # Not acked by executor 2 yet: it still gets the directive.
        assert c.heartbeat(2, state="running")["resize"]["epoch"] == 1
        assert server.reservations.done()
    finally:
        c.close()
        server.stop()


@pytest.mark.parametrize("server_cls,client_cls", PAIRS, ids=IDS)
def test_rejoin_after_departure_expands_and_bumps_incarnation(
        server_cls, client_cls):
    server = server_cls(3, elastic=True, min_nodes=1, **HEARTBEAT)
    addr = server.start()
    c = client_cls(addr)
    try:
        for eid in range(3):
            c.register({"executor_id": eid, "port": 4000 + eid})
        assert server.membership()["incarnations"] == {0: 1, 1: 1, 2: 1}
        server.depart(2, reason="preempted")
        c.heartbeat(0, state="running", epoch=1)

        rejoined = client_cls(addr)
        rejoined.register({"executor_id": 2, "port": 5002})
        m = server.membership()
        assert m["epoch"] == 2 and m["world_size"] == 3
        assert m["rejoins"] == 1 and m["incarnations"][2] == 2
        directive = c.heartbeat(0, state="running").get("resize")
        assert directive["epoch"] == 2 and directive["world_size"] == 3
        assert directive["reason"] == "join" and directive["executor_id"] == 2
        assert sorted(directive["members"]) == [0, 1, 2]
        ports = {n["executor_id"]: n["port"]
                 for n in server.reservations.get()}
        assert ports[2] == 5002
        rejoined.close()
    finally:
        c.close()
        server.stop()


@pytest.mark.parametrize("server_cls,client_cls", PAIRS, ids=IDS)
def test_membership_gauges_ride_cluster_stats(server_cls, client_cls):
    server = server_cls(2, elastic=True, min_nodes=1, **HEARTBEAT)
    addr = server.start()
    c = client_cls(addr)
    try:
        for eid in range(2):
            c.register({"executor_id": eid, "port": 4000 + eid})
        c.heartbeat(0, state="running", stats={"step": 7})
        stats = server.liveness.cluster_stats()
        assert stats["cluster"]["elastic"] is True
        assert stats["cluster"]["world_size"] == 2
        assert stats[0]["step"] == 7
        server.depart(1, reason="crashed")
        stats = server.liveness.cluster_stats()
        assert stats["cluster"]["epoch"] == 1
        assert stats["cluster"]["departures"] == 1
        assert stats["cluster"]["world_size"] == 1
        m = server.membership()
        assert m["world_size"] - 1 < m["min_nodes"]  # escalation bar
    finally:
        c.close()
        server.stop()


def test_the_two_servers_keep_the_same_books():
    """One scripted session against each package's server, replayed by the
    same client: every reply and every gauge reading agrees."""
    logs = []
    for server_cls in (jax_res.Server, reservation.Server):
        server = server_cls(3, elastic=True, min_nodes=2, **HEARTBEAT)
        addr = server.start()
        c = reservation.Client(addr)
        log = []
        try:
            for eid in range(3):
                log.append(c.register({"executor_id": eid, "port": eid}))
            log.append(c.heartbeat(1, state="running"))
            log.append(server.depart(0, reason="hung")["executor_id"])
            log.append(c.heartbeat(1, state="running"))
            log.append(c.heartbeat(1, state="running", epoch=1))
            log.append(c.register({"executor_id": 0, "port": 9}))
            log.append(c.heartbeat(2, state="running", epoch=1))
            log.append(c.heartbeat(2, state="running", epoch=2))
            log.append(c.get_reservations())
            log.append(server.membership())
            log.append(server.reservations.remaining())
        finally:
            c.close()
            server.stop()
        logs.append(log)
    assert logs[0] == logs[1]


def test_poll_resize_is_one_shot_per_epoch():
    class FakeMgr:
        def __init__(self):
            self.kv = {}

        def get(self, key):
            return self.kv.get(key)

    mgr = FakeMgr()
    ctx = node.NodeContext(0, "worker", 0, {}, "file://", ".", mgr)
    assert ctx.poll_resize() is None
    mgr.kv["resize"] = {"epoch": 1, "world_size": 2, "members": [0, 2]}
    assert ctx.poll_resize()["world_size"] == 2
    assert ctx.poll_resize() is None
    mgr.kv["resize"] = {"epoch": 2, "world_size": 3, "members": [0, 1, 2]}
    assert ctx.poll_resize()["epoch"] == 2


def test_heartbeat_sender_applies_a_directive_once_and_acks_it():
    server = reservation.Server(2, elastic=True, **HEARTBEAT)
    addr = server.start()

    class FakeMgr:
        def __init__(self):
            self.kv = {"state": "running"}
            self.sets = 0

        def get(self, key):
            return self.kv.get(key)

        def set(self, key, value):
            self.kv[key] = value
            self.sets += key == "resize"

    mgr = FakeMgr()
    c = reservation.Client(addr)
    sender = node.HeartbeatSender(addr, 0, mgr, interval=0.05)
    try:
        for eid in range(2):
            c.register({"executor_id": eid, "port": eid})
        sender.start()
        server.depart(1, reason="crashed")
        deadline = time.monotonic() + 10
        while server.membership()["acked"].get(0) != 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert mgr.kv["resize"]["epoch"] == 1 and mgr.sets == 1
    finally:
        sender.stop()
        c.close()
        server.stop()


# -- policy departures and the drill --------------------------------------------


def test_retire_and_spawn_a_replica_by_policy(tmp_path):
    """``retire_replica`` departs a live node with no failure counted and
    keeps the supervisor off its silence; ``spawn_replica`` brings it back
    at once, and the rejoined node trains from its committed step."""
    log_dir = str(tmp_path / "logs")
    os.makedirs(log_dir)
    pool = backend.LocalBackend(2, base_dir=str(tmp_path / "exec"))
    c = None
    try:
        c = cluster.run(
            pool, programs.elastic_linreg_fun,
            {"model_dir": str(tmp_path / "model"),
             "plan_dir": str(tmp_path / "faults"), "log_dir": log_dir,
             "device": "cpu"},
            num_executors=2, input_mode=cluster.InputMode.FEED,
            elastic=dict(min_nodes=1, rejoin=False), **HEARTBEAT)
        ctl = c.controller
        c.train(backend.Partitioned.from_items(_make_dataset(64), 2),
                timeout=60)
        meta = ctl.retire_replica(1)
        assert meta["executor_id"] == 1 and ctl.scaled_down == {1}
        m = c.membership()
        assert (m["world_size"], m["departures"], m["epoch"]) == (1, 1, 1)
        assert ctl.retire_replica(1) is None  # no longer a member
        assert ctl.spawn_replica(1) is not None and ctl.scaled_down == set()
        deadline = time.monotonic() + 60
        while c.membership()["world_size"] < 2:
            assert time.monotonic() < deadline, c.membership()
            time.sleep(0.1)
        c.train(backend.Partitioned.from_items(_make_dataset(64), 2),
                timeout=60)
        m = c.membership()
        assert (m["rejoins"], m["epoch"], m["incarnations"][1]) == (1, 2, 2)
        assert not ctl.escalated and ctl.replacements == 0
    finally:
        if c is not None:
            c.shutdown(timeout=60)
        pool.stop()
    resumes = [int(line.split()[1]) for line in
               _node_logs(log_dir)["node1.log"] if line.startswith("resume")]
    assert len(resumes) == 2 and resumes[1] > 0


# -- the drill ------------------------------------------------------------------


def _make_dataset(n=768, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    y = (x @ np.asarray(TRUE_W) + BIAS).astype(np.float32)
    return [(x[i].tolist(), float(y[i])) for i in range(n)]


def _node_logs(log_dir):
    out = {}
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name)) as f:
            out[name] = f.read().splitlines()
    return out


def test_elastic_drill_preempt_one_of_three(tmp_path):
    model_dir = str(tmp_path / "model")
    log_dir = str(tmp_path / "logs")
    os.makedirs(log_dir, exist_ok=True)
    plan = faults.FaultPlan(str(tmp_path / "faults"))
    plan.preempt_node(3, grace=0.6)
    data = backend.Partitioned.from_items(_make_dataset(), 12)
    pool = backend.LocalBackend(3, base_dir=str(tmp_path / "exec"))
    try:
        sup = cluster.run(
            pool, programs.elastic_linreg_fun,
            {"model_dir": model_dir, "plan_dir": plan.plan_dir,
             "log_dir": log_dir, "step_sleep": 0.05, "device": "cpu"},
            num_executors=3, input_mode=cluster.InputMode.FEED,
            restart_policy=RestartPolicy(max_restarts=2, backoff=0.2),
            checkpoint_dir=model_dir,
            elastic=dict(min_nodes=2, rejoin_delay=1.0), **HEARTBEAT)
        report = sup.train(data, num_epochs=2, timeout=100)
    finally:
        pool.stop()

    assert plan.fired(faults.PREEMPT) == 1
    assert report["restarts"] == 0
    membership = report["membership"]
    assert membership["departures"] >= 1
    assert membership["rejoins"] >= 1
    assert membership["epoch"] >= 2
    assert membership["world_size"] == 3
    assert membership["replacements"] >= 1

    logs = _node_logs(log_dir)
    assert len(logs) == 3
    resumed = [[int(line.split()[1]) for line in lines
                if line.startswith("resume")] for lines in logs.values()]
    rejoined = [r for r in resumed if len(r) >= 2]
    assert rejoined, "no node rejoined: {}".format(resumed)
    assert any(r[1] > 0 for r in rejoined)
    reshapes = [line for lines in logs.values() for line in lines
                if line.startswith("reshape")]
    assert reshapes, "no reshape barrier observed"

    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    target = float(sum(TRUE_W) + BIAS)
    preds = []
    for eid in range(3):
        tr = Trainer(factory.get_model("linear_regression", device="cpu",
                                       seed=1),
                     optimizer=trainer.sgd(0.5), device="cpu")
        node_dir = os.path.join(model_dir, "node{}".format(eid))
        restored = CheckpointManager(node_dir).restore(tr.init())
        assert restored.step > 0
        pred = tr.predict(restored, np.array([[1.0, 1.0]], np.float32))
        preds.append(float(pred[0, 0]))
    assert min(abs(p - target) for p in preds) < 1e-1, preds
