"""The port's cross-host executor backend (``backend_remote.py``) and its
agent CLI (``tools/agent.py``), with agents as real subprocesses dialing
the driver over TCP with an authkey: the cases of
``tests/test_backend_remote.py``.

Tasks run across agents in separate processes; a ``RetryTask`` moves to
another agent; a remote error carries its traceback; ``block=True``
returns the results list as ``LocalBackend`` does; the port's cluster
runs FEED inference over agents; a SIGKILLed agent fails its job within
seconds; and an agent under ``--restart --task_timeout`` that wedges
exits, reconnects and has its slot reclaimed, and the pool serves again.
The agents import only the port: task functions live in the jax-free
``torch_cluster_programs``.

Also here, as the remote backend is what needs it: ``util.get_ip_address``
agrees with the JAX package's (the routable address) when
``TPU_FRAMEWORK_HOST`` is unset, and the variable wins when set.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

import torch_cluster_programs as progs
from tensorflowonspark_tpu import util as jax_util
from tensorflowonspark_tpu_torch import backend, backend_remote, cluster, util

pytestmark = pytest.mark.watchdog_timeout(120)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _agent_env(pool):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TPU_FRAMEWORK_AGENT_KEY"] = pool.authkey.hex()
    # Like Spark's --py-files: the tasks' module must be importable on
    # the agents (cloudpickle ships importable functions by reference).
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.dirname(__file__)])
    return env


def _spawn_agents(pool, n, tmp_path, *extra):
    target = "127.0.0.1:{}".format(pool.address[1])
    return [subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.tools.agent",
         "--driver", target, "--base_dir", str(tmp_path / "agents")]
        + list(extra), env=_agent_env(pool)) for _ in range(n)]


def _reap(procs, timeout=15):
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=timeout)


@pytest.fixture()
def remote_pool(tmp_path):
    pool = backend_remote.RemoteBackend(2, listen=("127.0.0.1", 0))
    procs = _spawn_agents(pool, 2, tmp_path)
    try:
        pool.wait_for_agents(timeout=60)
        yield pool
    finally:
        pool.stop()
        _reap(procs)


def test_map_partitions_across_agents(remote_pool):
    parts = backend.Partitioned.from_items(list(range(20)), 4)
    out = remote_pool.map_partitions(parts, progs.square_partition)
    assert sorted(x for part in out for x in part) == \
        sorted(i * i for i in range(20))


def test_tasks_run_in_separate_processes(remote_pool):
    (idx_a, pid_a), (idx_b, pid_b) = remote_pool.map_partitions(
        [[0], [0]], progs.whoami, assign=lambda idx: idx)
    assert {idx_a, idx_b} == {0, 1}
    assert pid_a != pid_b
    assert os.getpid() not in (pid_a, pid_b)
    assert sorted(remote_pool.agent_pids) == sorted([pid_a, pid_b])


def test_retry_task_moves_to_other_agent(remote_pool):
    assert remote_pool.map_partitions(
        [[0]], progs.retry_if_first, assign=lambda idx: 0) == [["ran"]]


def test_remote_error_carries_traceback(remote_pool):
    def boom(iterator):
        raise ValueError("kapow")

    with pytest.raises(RuntimeError, match="kapow") as err:
        remote_pool.map_partitions([[0]], boom)
    assert "Traceback" in str(err.value)


def test_blocking_submit_returns_results_like_local(remote_pool):
    out = remote_pool.foreach_partition(
        [[1, 2], [3]], progs.square_partition, block=True, timeout=60)
    assert sorted(x for r in out for x in r) == [1, 4, 9]


def test_full_cluster_over_remote_backend(remote_pool, tmp_path):
    """The reference's distributed-squares flow with the executor pool
    behind a real network boundary; the agents' compute children load
    nothing of JAX."""
    c = cluster.run(remote_pool, progs.square_feed,
                    {"outdir": str(tmp_path)}, num_executors=2,
                    input_mode=cluster.InputMode.FEED)
    data = backend.Partitioned.from_items([float(i) for i in range(100)], 4)
    results = c.inference(data, timeout=60)
    c.shutdown(timeout=60)
    assert sorted(x for part in results for x in part) == \
        sorted(float(i) ** 2 for i in range(100))


def test_killed_agent_fails_job_fast(tmp_path):
    pool = backend_remote.RemoteBackend(2, listen=("127.0.0.1", 0))
    procs = _spawn_agents(pool, 2, tmp_path)
    try:
        pool.wait_for_agents(timeout=60)
        job = pool.foreach_partition([[5]], progs.sleep_forever, block=False)
        time.sleep(1.0)  # let the task land on the agent
        victim = next(p for p in procs if p.pid == pool.agent_pids[0])
        victim.send_signal(signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="disconnected"):
            job.wait(timeout=30)
        assert time.monotonic() - t0 < 10
    finally:
        pool.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
        _reap(procs)


def test_wedged_agent_self_heals_with_restart(tmp_path):
    pool = backend_remote.RemoteBackend(2, listen=("127.0.0.1", 0))
    procs = _spawn_agents(pool, 2, tmp_path, "--task_timeout", "3",
                          "--restart")
    try:
        pool.wait_for_agents(timeout=60)
        first_pids = list(pool.agent_pids)
        job = pool.foreach_partition([[5]], progs.sleep_forever, block=False)
        with pytest.raises((RuntimeError, TimeoutError)):
            job.wait(timeout=30)
        deadline = time.monotonic() + 60
        while True:
            with pool._job_lock:
                healed = not pool._dead
            if healed and pool.agent_pids != first_pids:
                break
            assert time.monotonic() < deadline, (pool._dead, pool.agent_pids)
            time.sleep(0.5)
        out = pool.map_partitions(
            backend.Partitioned.from_items(list(range(8)), 2),
            progs.square_partition, timeout=60)
        assert sorted(x for part in out for x in part) == \
            sorted(i * i for i in range(8))
    finally:
        pool.stop()
        _reap(procs)


def test_get_ip_address_agrees_with_the_jax_package(monkeypatch):
    monkeypatch.delenv(util.HOST_ENV, raising=False)
    assert util.get_ip_address() == jax_util.get_ip_address()
    monkeypatch.setenv(util.HOST_ENV, "10.1.2.3")
    assert util.get_ip_address() == "10.1.2.3"
