"""The port's ``LocalBackend``: persistent spawned executors that run
pickled partition tasks, as the JAX package's backend does (ordered
results, remote tracebacks, ``RetryTask`` rescheduling, closures), and
whose processes load nothing of JAX or of the JAX package."""

import os

import pytest

import torch_cluster_programs as progs
from tensorflowonspark_tpu_torch import backend

pytestmark = pytest.mark.watchdog_timeout(120)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    b = backend.LocalBackend(
        2, base_dir=str(tmp_path_factory.mktemp("exec")))
    yield b
    b.stop()


def _pid_and_dir(it):
    return [(os.getpid(), os.path.basename(os.getcwd()),
             os.environ["TPU_FRAMEWORK_EXECUTOR_IDX"], list(it))]


def _boom(it):
    raise ValueError("kaboom")


def _retry_once(it):
    items = list(it)
    if os.environ["TPU_FRAMEWORK_EXECUTOR_IDX"] == "0":
        raise backend.RetryTask("not here")
    return items


def _forbidden(it):
    list(it)
    return progs.forbidden_modules()


def test_partitioned_roundrobin_union_and_repeat():
    p = backend.Partitioned.from_items(range(7), 3)
    assert p.partitions == [[0, 3, 6], [1, 4], [2, 5]]
    assert p.union(p).num_partitions == 6
    assert list(p.repeat(2))[3] == [0, 3, 6]


def test_tasks_run_in_separate_ordered_executors(pool):
    out = pool.map_partitions(backend.Partitioned([[1], [2], [3], [4]]),
                              _pid_and_dir, timeout=60)
    assert [r[0][3] for r in out] == [[1], [2], [3], [4]]
    assert [r[0][1] for r in out] == ["executor_0", "executor_1"] * 2
    assert [r[0][2] for r in out] == ["0", "1", "0", "1"]
    pids = {r[0][0] for r in out}
    assert len(pids) == 2 and os.getpid() not in pids


def test_errors_carry_the_remote_traceback(pool):
    with pytest.raises(RuntimeError, match="kaboom") as err:
        pool.map_partitions([[0]], _boom, timeout=60)
    assert "Traceback" in str(err.value)


def test_retry_task_moves_to_another_executor_and_closures_run(pool):
    assert pool.map_partitions([[5, 6]], _retry_once, timeout=60) == [[5, 6]]
    scale = 3
    got = pool.map_partitions([[1, 2], [3]],
                              lambda it: [scale * x for x in it], timeout=60)
    assert got == [[3, 6], [9]]


def test_executors_load_nothing_of_jax(pool):
    assert pool.map_partitions([[0], [1]], _forbidden, timeout=60) == [[], []]
