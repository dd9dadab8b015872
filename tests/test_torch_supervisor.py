"""The port's supervision layer (``supervisor.py``) against the JAX
package's.

* ``RestartPolicy``: for seeded failure sequences the port's ``delay``
  (jitter 0, and jitter under a seeded ``random``), ``exhausted``,
  ``relevant`` and ``stuck_step`` decide exactly as the JAX policy does,
  over the cases of ``tests/test_chaos_supervisor.py``.
* ``cluster.run``'s argument checks: ``checkpoint_dir`` without a policy,
  elastic outside FEED mode or with ps nodes raise ``ValueError``;
  ``incident_dir`` arms an incident recorder (straggler flags fire it)
  and ``slos`` an SLO monitor reporting to it, on a plain cluster and
  through a supervised one's relaunch arguments; a launch-time config
  error fails on the first attempt without burning the budget.
* The supervised matrix on the CPU: ``LocalBackend(1)`` and the port's
  ``testing.programs.supervised_linreg_fun`` (device ``"cpu"``) under
  crash, hang (with dropped heartbeats) and corrupt, held to the
  assertions of the JAX matrix (``tests/test_chaos.py``): within the
  budget, resumed from the committed step, an unbroken step line, and
  converged like the fault-free run, on the JAX matrix's data and
  epochs. A fault armed past the budget surfaces as ``PermanentFailure``
  carrying the injected remote traceback.
* Two ranks over gloo: rank 1 crashes (or hangs silently) after step 2
  commits while rank 0 goes on into its next collective. The teardown
  kills rank 0's compute child too, instead of waiting out the process
  group's 300 s timeout; both ranks relaunch from step 2 and end with
  bitwise-equal replicas.
* The incident reason of a failure whose exception reaches the attempt
  before the liveness watcher sees the death: the attempt path captures
  once, under ``node_death``/``node_hung`` naming the node the liveness
  ledger (or its manager KV's crash snapshot) shows dead, and under
  ``attempt_failure`` only when every node is alive.
"""

import os
import random
import time
import types

import numpy as np
import pytest
import torch

import torch_cluster_programs as progs
from tensorflowonspark_tpu import supervisor as jax_sup
from tensorflowonspark_tpu_torch import backend, cluster, supervisor
from tensorflowonspark_tpu_torch.supervisor import (FailureRecord,
                                                    PermanentFailure,
                                                    RestartPolicy)
from tensorflowonspark_tpu_torch.testing import faults, programs

pytestmark = pytest.mark.watchdog_timeout(120)

TRUE_W = (1.5, -2.0)
BIAS = 0.25
# Beats every 0.3 s. A hang is detected after 15 missed beats (4.5 s); a
# crash reports its error state at once, so the other cases allow 40 (a
# loaded host must not make a slow node look hung).
HEARTBEAT = dict(heartbeat_interval=0.3, heartbeat_miss_budget=40)
HANG_HEARTBEAT = dict(HEARTBEAT, heartbeat_miss_budget=15)
EPOCHS = 4


def _make_dataset(n=256, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    y = (x @ np.asarray(TRUE_W) + BIAS).astype(np.float32)
    return [(x[i].tolist(), float(y[i])) for i in range(n)]


# -- RestartPolicy parity ---------------------------------------------------

POLICIES = [
    dict(max_restarts=5, backoff=1.0, backoff_cap=8.0, jitter=0.25),
    dict(backoff=0.5, jitter=0.0),
    dict(max_restarts=2, window=10.0),
    dict(max_restarts=2),
    dict(same_step_limit=2),
    dict(max_restarts=0, backoff=2.0, backoff_cap=3.0, jitter=0.5,
         window=5.0, same_step_limit=1),
]


def _sequences(seed, n=40):
    """Seeded failure histories: kinds, committed steps (some unknown) and
    ages around the windows."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = int(rng.randint(0, 6))
        seq = []
        for a in range(length):
            seq.append(dict(
                attempt=a + 1,
                kind=str(rng.choice(["crashed", "hung", "failed"],
                                    p=[0.7, 0.2, 0.1])),
                step=None if rng.rand() < 0.15 else int(rng.randint(1, 4)),
                age=float(rng.choice([0.5, 3.0, 9.0, 50.0]))))
        out.append(seq)
    return out


@pytest.mark.parametrize("kw", POLICIES, ids=lambda kw: ",".join(
    "{}={}".format(k, v) for k, v in kw.items()))
def test_restart_policy_decides_as_the_jax_policy(kw):
    mine, theirs = RestartPolicy(**kw), jax_sup.RestartPolicy(**kw)
    now = 1000.0
    for seed in range(3):
        for seq in _sequences(seed):
            a = [FailureRecord(f["attempt"], f["kind"], f["step"], "boom",
                               when=now - f["age"]) for f in seq]
            b = [jax_sup.FailureRecord(f["attempt"], f["kind"], f["step"],
                                       "boom", when=now - f["age"])
                 for f in seq]
            assert mine.exhausted(a, now=now) == theirs.exhausted(b, now=now)
            assert [f.attempt for f in mine.relevant(a, now=now)] == \
                [f.attempt for f in theirs.relevant(b, now=now)]
            assert mine.stuck_step(a) == theirs.stuck_step(b)
            assert [f.to_dict() for f in a] == [f.to_dict() for f in b]
    for seed in range(5):
        random.seed(seed)
        want = [theirs.delay(i) for i in range(8)]
        random.seed(seed)
        got = [mine.delay(i) for i in range(8)]
        assert got == want


def test_restart_policy_cases_of_the_jax_suite():
    p = RestartPolicy(max_restarts=5, backoff=1.0, backoff_cap=8.0,
                      jitter=0.25)
    for i, base in enumerate([1.0, 2.0, 4.0, 8.0, 8.0]):
        for _ in range(20):
            assert base * 0.75 <= p.delay(i) <= base * 1.25
    assert [RestartPolicy(backoff=0.5, jitter=0.0).delay(i)
            for i in range(3)] == [0.5, 1.0, 2.0]

    def fail(attempt, step=None, kind="crashed", when=None):
        return FailureRecord(attempt, kind, step, "boom", when=when)

    p = RestartPolicy(max_restarts=2, window=10.0)
    now = time.monotonic()
    old = [fail(1, when=now - 100), fail(2, when=now - 50)]
    recent = [fail(3, when=now - 1), fail(4, when=now - 1),
              fail(5, when=now - 1)]
    assert not p.exhausted(old + recent[:2], now=now)
    assert p.exhausted(old + recent, now=now)
    assert RestartPolicy(max_restarts=2).exhausted(old + recent[:1], now=now)
    p = RestartPolicy(same_step_limit=2)
    assert p.stuck_step([fail(1, 3)]) is None
    assert p.stuck_step([fail(1, 3), fail(2, 3)]) == 3
    assert p.stuck_step([fail(1, 3), fail(2, 4)]) is None
    assert p.stuck_step([fail(1, 3), fail(2, 3, kind="hung")]) is None
    assert p.stuck_step([fail(1, None), fail(2, None)]) is None
    assert RestartPolicy().stuck_step([fail(1, 3), fail(2, 3)]) is None
    with pytest.raises(ValueError):
        RestartPolicy(max_restarts=-1)
    e = PermanentFailure("boom", [fail(1, 3)])
    assert isinstance(e, RuntimeError) and e.failures[0].committed_step == 3


# -- cluster.run's argument checks ------------------------------------------


class _RegisteringBackend:
    """A backend whose "executors" only register with the rendezvous
    server: ``cluster.run`` returns a cluster without any process."""

    num_executors = 1

    def foreach_partition(self, partitions, fn, block=True, **kw):
        from tensorflowonspark_tpu_torch import reservation

        for part in partitions:
            client = reservation.Client(tuple(fn.cluster_meta["server_addr"]))
            client.register({"executor_id": part[0], "host": "127.0.0.1",
                             "job_name": "worker", "task_index": 0})
            client.close()


def test_run_argument_checks(tmp_path):
    fake = type("B", (object,), {"num_executors": 1})()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        cluster.run(fake, progs.square_feed, checkpoint_dir="/nowhere")
    with pytest.raises(ValueError, match="FEED"):
        cluster.run(fake, progs.square_feed, elastic=True,
                    input_mode=cluster.InputMode.FILES)
    with pytest.raises(ValueError, match="ps"):
        cluster.run(fake, progs.square_feed, elastic=True, num_ps=1,
                    input_mode=cluster.InputMode.FEED)
    incidents = str(tmp_path / "incidents")
    c = cluster.run(_RegisteringBackend(), progs.square_feed,
                    input_mode=cluster.InputMode.FEED, reservation_timeout=30,
                    incident_dir=incidents, slos=["x > 1"])
    try:
        from tensorflowonspark_tpu_torch import incident

        assert isinstance(c.incidents, incident.IncidentRecorder)
        assert c.incidents.root == incidents
        assert c.server.liveness.incident_cb == c.incidents.trigger
        monitor = c.history.slo_monitor
        assert monitor.recorder is c.incidents
        assert [s.metric for s in monitor.slos] == ["x"]
    finally:
        c.server.stop()
        c.history.set_slos(None)
    plain = cluster.run(_RegisteringBackend(), progs.square_feed,
                        input_mode=cluster.InputMode.FEED,
                        reservation_timeout=30)
    plain.server.stop()
    assert plain.incidents is None and plain.capture_incident() is None
    sup = cluster.run(fake, progs.square_feed, restart_policy=RestartPolicy(),
                      checkpoint_dir="/nowhere", incident_dir=incidents,
                      slos=["x > 1"])
    assert isinstance(sup, supervisor.SupervisedCluster)
    # Every attempt's cluster.run gets them: each attempt arms its own.
    assert sup._run_kwargs["incident_dir"] == incidents
    assert sup._run_kwargs["slos"] == ["x > 1"]
    assert sup.report() is None
    sup.shutdown()


def test_launch_config_errors_fail_fast_without_retries():
    fake = type("B", (object,), {"num_executors": 1})()
    sup = supervisor.JobSupervisor(
        fake, lambda a, c: None,
        restart_policy=RestartPolicy(max_restarts=3, backoff=10.0),
        run_kwargs=dict(num_executors=1, num_ps=1))  # ps-only: no workers
    with pytest.raises(ValueError, match="no worker nodes"):
        sup.run(lambda c: None)
    assert sup.attempts == 1 and sup.failures == []


# -- the supervised matrix ---------------------------------------------------


def _parse_log(path):
    """-> (resume steps per launch, [(step, loss), ...] in order)."""
    resumes, steps = [], []
    with open(path) as f:
        for line in f:
            kind, rest = line.split(" ", 1)
            if kind == "resume":
                resumes.append(int(rest))
            else:
                step, loss = rest.split()
                steps.append((int(step), float(loss)))
    return resumes, steps


def _run_supervised(tmp_path, fault, policy=None, times=1):
    workdir = tmp_path / fault
    model_dir = str(workdir / "model")
    log = str(workdir / "train.log")
    plan = faults.FaultPlan(str(workdir / "faults"))
    if fault == "crash":
        plan.crash_at_step(3, times=times)
    elif fault == "hang":
        plan.hang_at_step(2)
        plan.drop_heartbeats_after(2)
    elif fault == "corrupt":
        plan.corrupt_latest_checkpoint(4)
    data = backend.Partitioned.from_items(_make_dataset(), 2)
    pool = backend.LocalBackend(1, base_dir=str(workdir / "exec"))
    try:
        sup = cluster.run(
            pool, programs.supervised_linreg_fun,
            {"model_dir": model_dir, "plan_dir": plan.plan_dir, "log": log,
             "device": "cpu"},
            num_executors=1, input_mode=cluster.InputMode.FEED,
            restart_policy=policy or RestartPolicy(max_restarts=2,
                                                   backoff=0.2),
            checkpoint_dir=model_dir,
            **(HANG_HEARTBEAT if fault == "hang" else HEARTBEAT))
        report = sup.train(data, num_epochs=EPOCHS, timeout=90)
    finally:
        pool.stop()
    return report, plan, log, model_dir, sup


def _final_prediction(model_dir):
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    tr = Trainer(factory.get_model("linear_regression", device="cpu",
                                   seed=1),
                 optimizer=trainer.sgd(0.5), device="cpu")
    restored = CheckpointManager(model_dir).restore(tr.init())
    pred = tr.predict(restored, np.array([[1.0, 1.0]], np.float32))
    return restored.step, float(pred[0, 0])


@pytest.fixture(scope="module")
def faultfree_final_loss(tmp_path_factory):
    """Final training loss of a fault-free supervised run — the
    convergence bar the faulted runs must match."""
    report, _, log, _, _ = _run_supervised(
        tmp_path_factory.mktemp("faultfree"), "none")
    assert report["restarts"] == 0
    _, steps = _parse_log(log)
    return steps[-1][1]


@pytest.mark.parametrize("fault", ["crash", "hang", "corrupt"])
def test_supervised_recovery_matrix(tmp_path, fault, faultfree_final_loss):
    policy = RestartPolicy(max_restarts=2, backoff=0.2)
    report, plan, log, model_dir, _ = _run_supervised(tmp_path, fault,
                                                      policy=policy)
    assert report["restarts"] >= 1, "the fault never fired"
    assert report["restarts"] <= policy.max_restarts
    kind_armed = {"crash": faults.CRASH, "hang": faults.HANG,
                  "corrupt": faults.CORRUPT}[fault]
    assert plan.fired(kind_armed) == 1  # relaunches ran clean

    resumes, steps = _parse_log(log)
    assert len(resumes) == 1 + report["restarts"]
    assert resumes[0] == 0
    fail_records = report["failures"]
    for record, resume in zip(fail_records, resumes[1:]):
        assert resume == record["committed_step"]
        assert resume > 0
    if fault == "crash":
        trained = [s for s, _ in steps]
        assert trained == sorted(set(trained))
        assert resumes[1] >= 3
    if fault == "hang":
        assert fail_records[0]["kind"] == "hung"
        assert resumes[1] == 2
    if fault == "corrupt":
        assert resumes[1] == 3
        trained = [s for s, _ in steps]
        assert trained.count(4) == 2
        assert all(trained.count(s) == 1 for s in set(trained) if s != 4)

    final_step, pred = _final_prediction(model_dir)
    assert final_step > max(resumes)
    assert abs(pred - (sum(TRUE_W) + BIAS)) < 1e-1
    assert steps[-1][1] <= faultfree_final_loss + 1e-2


def test_permanent_failure_surfaces_original_traceback(tmp_path):
    with pytest.raises(PermanentFailure) as err:
        _run_supervised(tmp_path, "crash",
                        policy=RestartPolicy(max_restarts=1, backoff=0.2),
                        times=10)
    assert "injected failure at step" in str(err.value)
    assert "InjectedFault" in str(err.value)
    assert len(err.value.failures) == 2
    assert [f.kind for f in err.value.failures] == ["crashed", "crashed"]


# -- two ranks over gloo ------------------------------------------------------


@pytest.mark.parametrize("fault", ["crash", "hang"])
def test_two_rank_job_relaunches_past_a_rank_dead_in_a_collective(
        tmp_path, fault):
    from tensorflowonspark_tpu_torch.parallel import multihost

    plan_dir = str(tmp_path / "faults")
    log_dir = str(tmp_path / "logs")
    model_dir = str(tmp_path / "model")
    os.makedirs(log_dir)
    rank1 = faults.FaultPlan(os.path.join(plan_dir, "rank1"))
    if fault == "crash":
        rank1.crash_at_step(2)
    else:
        rank1.hang_at_step(2)
        rank1.drop_heartbeats_after(2)
    faults.FaultPlan(os.path.join(plan_dir, "rank0"))  # nothing armed
    data = backend.Partitioned.from_items(_make_dataset(96), 2)
    pool = backend.LocalBackend(2, base_dir=str(tmp_path / "exec"))
    t0 = time.monotonic()
    try:
        sup = cluster.run(
            pool, progs.dp_linreg_supervised,
            {"model_dir": model_dir, "plan_dir": plan_dir,
             "log_dir": log_dir},
            num_executors=2, input_mode=cluster.InputMode.FEED,
            restart_policy=RestartPolicy(max_restarts=1, backoff=0.2),
            checkpoint_dir=model_dir,
            **(HANG_HEARTBEAT if fault == "hang" else HEARTBEAT))
        report = sup.train(data, timeout=90)
    finally:
        pool.stop()
    took = time.monotonic() - t0
    assert took < multihost.DEFAULT_TIMEOUT / 3, took
    assert report["restarts"] == 1
    assert report["failures"][0]["committed_step"] == 2
    if fault == "hang":
        # The liveness snapshot taken at detection names the hung rank.
        # The record's kind may read "crashed": once the teardown kills
        # rank 1, rank 0's collective can raise before its own kill lands,
        # and the JAX classification ranks any traceback over a hang.
        assert "executor 1: hung" in report["failures"][0]["error"]
    logs = {}
    for r in (0, 1):
        logs[r] = _parse_log(os.path.join(log_dir, "rank{}.log".format(r)))
        assert logs[r][0] == [0, 2], logs[r][0]  # both relaunch from 2
    assert logs[0][1] == logs[1][1]  # the same steps and losses
    p0, p1 = (torch.load(os.path.join(log_dir, "rank{}_params.pt".format(r)),
                         weights_only=True) for r in (0, 1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_reap_waits_for_the_killed_child_to_exit():
    """The reap's wait: a compute child this executor spawned is joined
    after its SIGKILL (its CUDA context and memory go with the exit)."""
    import multiprocessing
    import signal

    from tensorflowonspark_tpu_torch import node

    p = multiprocessing.get_context("spawn").Process(target=time.sleep,
                                                     args=(60,))
    p.start()
    node._compute_procs[p.pid] = p
    os.kill(p.pid, signal.SIGKILL)
    assert node._wait_exited(p.pid, timeout=30)
    assert p.exitcode == -signal.SIGKILL and p.pid not in node._compute_procs
    assert node._wait_exited(p.pid, timeout=30)  # not ours any more


# -- the attempt path's incident reason --------------------------------------


class _Ledger:
    """Node 0's liveness status (None: alive)."""

    def __init__(self, status):
        self.status = status

    def dead(self):
        return [0] if self.status in ("crashed", "hung") else []

    def snapshot(self):
        return {0: {"status": self.status or "alive"}}


class _FailedCluster:
    def __init__(self, status, kv_crash):
        self.server = types.SimpleNamespace(liveness=_Ledger(status))
        self.incidents = types.SimpleNamespace(
            crashed=lambda: {"0"} if kv_crash else set())
        self.captures = []

    def capture_incident(self, reason, **attrs):
        self.captures.append((reason, attrs))


class _BlindWatcher(supervisor._LivenessWatcher):
    """A watcher that never polls: the attempt's exception is always the
    first to see the failure."""

    def run(self):
        return


@pytest.mark.parametrize("status,kv_crash,reason,nodes", [
    ("crashed", False, "node_death", "0"),
    (None, True, "node_death", "0"),
    ("hung", False, "node_hung", "0"),
    (None, False, "attempt_failure", None),
], ids=["ledger_crashed", "kv_crash_snapshot", "ledger_hung", "all_alive"])
def test_attempt_path_first_captures_the_cause_once(monkeypatch, status,
                                                    kv_crash, reason, nodes):
    failed = _FailedCluster(status, kv_crash)
    monkeypatch.setattr(cluster, "run", lambda *a, **kw: failed)
    monkeypatch.setattr(supervisor, "_LivenessWatcher", _BlindWatcher)
    monkeypatch.setattr(supervisor, "_teardown", lambda c, grace=5.0: [])
    sup = supervisor.JobSupervisor(object(), progs.square_feed,
                                   restart_policy=RestartPolicy())

    def job(c):
        raise RuntimeError("node 0 failed")

    ok, _, record = sup._attempt(job, 5.0)
    assert not ok and "node 0 failed" in record.error
    assert len(failed.captures) == 1
    got, attrs = failed.captures[0]
    assert got == reason and attrs.get("nodes") == nodes
