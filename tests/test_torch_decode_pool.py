"""The port's decode pool: ordered fan-out over worker processes started by
forkserver (never fork), error provenance, the worker-death drill of
``testing/faults.py`` (no unit duplicated or dropped, the killed pid
returned), the shared-memory transport (no segment left after a close, a
worker's SIGKILL or an abandoned stream), a closure refused with a
``TypeError`` when the pool starts, workers that exit when their owner
dies, and the ``ingest_*`` telemetry.

The JAX package's pool forks, so no test here starts it: the streams are
held against known results, and the pipeline drill against the JAX
``InputPipeline`` run inline. Every test ends with no live child of its
own (the forkserver and the resource tracker outlive a pool by design) and
no segment of this process in ``/dev/shm``.
"""

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_data_programs as progs
from tensorflowonspark_tpu.data import dfutil as jax_dfutil
from tensorflowonspark_tpu.data.input_pipeline import (
    InputPipeline as JaxPipeline,
)
from tensorflowonspark_tpu_torch import telemetry
from tensorflowonspark_tpu_torch.data import decode_pool
from tensorflowonspark_tpu_torch.data.input_pipeline import InputPipeline
from tensorflowonspark_tpu_torch.testing import faults

pytestmark = pytest.mark.watchdog_timeout(120)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _nothing_left():
    before = progs.live_children()
    yield
    assert progs.wait_no_new_children(before) == set()
    assert progs.shm_segments() == []


def test_imap_preserves_order_and_completeness():
    with decode_pool.DecodePool(progs.square, workers=2) as pool:
        got = list(pool.imap([[i, i + 1] for i in range(20)]))
        assert progs.start_method(pool) == "forkserver"
    assert got == [[i * i, (i + 1) * (i + 1)] for i in range(20)]


def test_imap_multiple_streams_share_one_pool():
    with decode_pool.DecodePool(progs.square, workers=2) as pool:
        assert list(pool.imap([[1], [2]])) == [[1], [4]]
        pids = pool.worker_pids()
        assert list(pool.imap([[3]])) == [[9]]
        assert pool.worker_pids() == pids
        assert pool.stats()["submitted"] == 3
        assert pool.stats()["yielded"] == 3


def test_workers_are_not_forked_from_the_owner():
    """Each worker's parent is the forkserver, a process started by exec,
    not the pool's owner."""
    import psutil

    with decode_pool.DecodePool(progs.square, workers=2) as pool:
        pids = pool.worker_pids()
        server = psutil.Process(pids[0]).ppid()
        assert server != os.getpid()
        assert {psutil.Process(p).ppid() for p in pids} == {server}
        assert psutil.Process(server).ppid() == os.getpid()
        assert psutil.Process(server).cmdline() != psutil.Process().cmdline()


def test_closure_raises_type_error_when_the_pool_starts():
    scale = 3
    pool = decode_pool.DecodePool(lambda p: p * scale, workers=2)
    t0 = time.monotonic()
    with pytest.raises(TypeError, match="closure or lambda"):
        list(pool.imap([1, 2]))
    assert time.monotonic() - t0 < 5
    assert pool.stats()["workers"] == 0
    pool.close()
    # A partial or a callable object of module-level code pickles.
    with decode_pool.DecodePool(functools.partial(np.multiply, 3),
                                workers=2) as pool:
        assert list(pool.imap([1, 2])) == [3, 6]


def test_worker_error_carries_context_and_traceback():
    with decode_pool.DecodePool(progs.explode_on_seven, workers=2) as pool:
        with pytest.raises(decode_pool.DecodeError) as err:
            list(pool.imap(
                [[i] for i in range(10)],
                context_fn=lambda i, p: {"file": "shard-%d" % i}))
    msg = str(err.value)
    assert "shard-7" in msg
    assert "record seven is cursed" in msg
    assert err.value.context == {"file": "shard-7"}


def test_killed_worker_tasks_are_recovered_exactly_once(tmp_path):
    plan = faults.FaultPlan(str(tmp_path / "plan"))
    plan.kill_decode_worker(after_batches=3)
    with decode_pool.DecodePool(progs.square, workers=2) as pool:
        got, killed = [], []
        for i, out in enumerate(pool.imap([[i] for i in range(24)])):
            got.append(out)
            pid = plan.on_pool_batch(i, pool)
            if pid:
                killed.append((pid, sorted(pool.worker_pids())))
        stats = pool.stats()
    assert got == [[i * i] for i in range(24)]
    assert len(killed) == 1 and plan.fired(faults.KILL_DECODE_WORKER) == 1
    assert stats["worker_deaths"] >= 1
    assert stats["workers"] == 2
    assert killed[0][0] not in pool.worker_pids()


def test_decode_fn_crash_vs_worker_death_are_distinct():
    with decode_pool.DecodePool(progs.explode_on_seven, workers=2) as pool:
        with pytest.raises(decode_pool.DecodeError):
            list(pool.imap([[7]]))
        assert pool.stats()["worker_deaths"] == 0
        assert pool.stats()["requeued"] == 0


def test_pool_telemetry_rides_node_stats():
    telemetry._reset_for_tests()
    try:
        with decode_pool.DecodePool(progs.square, workers=2) as pool:
            assert list(pool.imap([[i] for i in range(4)]))
            assert telemetry.get_gauge("ingest_pool_workers") == 2.0
        stats = telemetry.node_stats()
        assert "ingest_workers" in stats
        assert "ingest_ms_p50" in stats and "ingest_ms_p99" in stats
        assert telemetry.get_counter("ingest_batches_total") == 4.0
        assert telemetry.get_gauge("ingest_pool_workers") == 0.0
        assert telemetry.get_gauge("ingest_pool_inflight") == 0.0
    finally:
        telemetry._reset_for_tests()


def test_payloads_can_be_numpy():
    arrs = [np.full((4,), i, np.int32) for i in range(6)]
    with decode_pool.DecodePool(progs.double, workers=2) as pool:
        got = list(pool.imap(arrs))
    for i, a in enumerate(got):
        np.testing.assert_array_equal(a, np.full((4,), 2 * i, np.int32))


def _check_columnar(got, n):
    assert len(got) == n
    for i, batch in enumerate(got):
        np.testing.assert_array_equal(
            batch["image"], np.full((8, 16, 16, 3), i, np.float32))
        np.testing.assert_array_equal(
            batch["label"], np.arange(8, dtype=np.int64) + i)
        assert batch["names"] == ["rec-%d-%d" % (i, j) for j in range(8)]
        np.testing.assert_array_equal(batch["nested"]["mask"],
                                      np.ones((8,), bool))


@pytest.mark.parametrize("shared_memory", [True, False])
def test_transport_roundtrip_ordered_and_equal(shared_memory):
    with decode_pool.DecodePool(progs.decode_columnar, workers=2,
                                shared_memory=shared_memory,
                                shm_min_bytes=1) as pool:
        assert pool.stats()["shared_memory"] is shared_memory
        got = list(pool.imap([[i] for i in range(12)]))
    _check_columnar(got, 12)


def test_shared_memory_survives_worker_kill(tmp_path):
    plan = faults.FaultPlan(str(tmp_path / "plan"))
    plan.kill_decode_worker(after_batches=3)
    with decode_pool.DecodePool(progs.decode_columnar, workers=2,
                                shared_memory=True,
                                shm_min_bytes=1) as pool:
        got = []
        for i, out in enumerate(pool.imap([[i] for i in range(16)])):
            got.append(out)
            plan.on_pool_batch(i, pool)
        stats = pool.stats()
    assert stats["worker_deaths"] >= 1
    _check_columnar(got, 16)


def test_abandoned_stream_unlinks_its_segments():
    """A consumer that stops early: results in flight (exported to
    segments, queued or mid-decode) are reaped by name at close."""
    with decode_pool.DecodePool(progs.decode_columnar, workers=2,
                                shared_memory=True, shm_min_bytes=1,
                                window=6) as pool:
        it = pool.imap([[i] for i in range(40)])
        _check_columnar([next(it) for _ in range(3)], 3)
        time.sleep(0.3)  # let the workers export their lookahead
        it.close()


def test_workers_exit_when_their_owner_dies(tmp_path):
    out = str(tmp_path / "pids")
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import "
            "torch_data_programs as p; p.owner_dies_with_a_pool({!r})"
            .format(ROOT, os.path.join(ROOT, "tests"), out))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)
    with open(out) as f:
        pids = [int(p) for p in f.read().split()]
    assert len(pids) == 2
    deadline = time.monotonic() + 10
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = [p for p in pids if decode_pool._alive(p)]
        time.sleep(0.05)
    assert alive == []


def test_input_pipeline_survives_worker_kill_mid_epoch(tmp_path):
    """A FILES-mode pipeline with a pool loses a worker mid-epoch; its
    stream equals the JAX pipeline's inline stream bitwise."""
    rows = [{"v": [float(i)], "label": i} for i in range(60)]
    data = str(tmp_path / "data")
    jax_dfutil.save_as_tfrecords(
        rows, data,
        schema={"v": jax_dfutil.ARRAY_FLOAT, "label": jax_dfutil.INT64},
        num_shards=4)
    columns = {"v": ("float", 1), "label": ("int64", 1)}
    plan = faults.FaultPlan(str(tmp_path / "plan"))
    plan.kill_decode_worker(after_batches=2)
    pipe = InputPipeline(data, columns, batch_size=8, decode_workers=2)
    got, killed = [], []
    for i, batch in enumerate(pipe):
        got.append(batch)
        if pipe._pool is not None:
            pid = plan.on_pool_batch(i, pipe._pool)
            if pid:
                killed.append(pid)
    want = list(JaxPipeline(data, columns, batch_size=8))
    assert len(killed) == 1 and plan.fired(faults.KILL_DECODE_WORKER) == 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
