"""The port's fault-injection harness (``testing/faults.py``) against the
JAX package's.

* One plan directory, two packages: a fault armed by either package's
  ``FaultPlan`` fires exactly once across both, since both claim the same
  ``<kind>.fired.<n>`` markers.
* The JAX suite's harness cases on the port: the per-plan budget across
  launches, ``reset``, the process-local heartbeat drop, the feed-item
  fault, a spot preemption's SIGTERM raising ``Preempted``.
* ``corrupt_step`` damages the port's step layout (``torch.save`` files
  under ``<dir>/<step>/default/``), in both modes, and the port's
  ``CheckpointManager.restore`` skips the torn newest step through marker
  validation: commit steps 1-4, damage 4, and the restore lands on 3 with
  step 4's directory discarded.
* ``kill_decode_worker`` SIGKILLs the lowest-pid worker of a live decode
  pool once and returns its pid; the pool's stream finishes bitwise.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.testing import faults as jax_faults
from tensorflowonspark_tpu_torch.testing import faults

pytestmark = pytest.mark.watchdog_timeout(120)


@pytest.mark.parametrize("armer,firer", [(jax_faults, faults),
                                         (faults, jax_faults)],
                         ids=["jax-armed", "port-armed"])
def test_plan_armed_by_one_package_fires_once_in_the_other(
        tmp_path, armer, firer):
    d = str(tmp_path / "plan")
    armer.FaultPlan(d).crash_at_step(3)
    plan = firer.FaultPlan(d)
    plan.on_step(2)  # below threshold: silent
    with pytest.raises(firer.InjectedFault, match="injected failure at step 3"):
        plan.on_step(3)
    # The budget is spent for both packages.
    armer.FaultPlan(d).on_step(5)
    firer.FaultPlan(d).on_step(5)
    assert armer.FaultPlan(d).fired(armer.CRASH) == 1
    assert plan.fired(faults.CRASH) == 1
    assert sorted(os.listdir(d)) == ["crash_at_step.fired.0",
                                     "crash_at_step.json"]


def test_spec_files_are_byte_equal_across_packages(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for pkg, d in ((jax_faults, a), (faults, b)):
        p = pkg.FaultPlan(d)
        p.crash_at_step(3, times=2)
        p.hang_at_step(2, duration=7.5)
        p.drop_heartbeats_after(4)
        p.corrupt_latest_checkpoint(5, mode="delete")
        p.kill_feed_queue(50)
        p.kill_decode_worker(6)
        p.preempt_node(3, grace=1.25)
    for name in sorted(os.listdir(a)):
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


def test_fault_plan_times_budget_spans_launches(tmp_path):
    d = str(tmp_path / "p")
    faults.FaultPlan(d).crash_at_step(1, times=3)
    for _ in range(3):
        with pytest.raises(faults.InjectedFault):
            faults.FaultPlan(d).on_step(1)
    faults.FaultPlan(d).on_step(1)  # 4th launch: budget spent
    assert faults.FaultPlan(d).fired(faults.CRASH) == 3
    assert jax_faults.FaultPlan(d).fired(jax_faults.CRASH) == 3


def test_fault_plan_reset_disarms(tmp_path):
    plan = faults.FaultPlan(str(tmp_path / "p"))
    plan.crash_at_step(1)
    with pytest.raises(faults.InjectedFault):
        plan.on_step(1)
    plan.reset()
    plan.on_step(1)  # disarmed
    assert plan.fired(faults.CRASH) == 0


def test_drop_heartbeats_is_process_local(tmp_path, monkeypatch):
    monkeypatch.setattr(faults, "_heartbeats_dropped", False)
    plan = faults.FaultPlan(str(tmp_path / "p"))
    plan.drop_heartbeats_after(2)
    plan.on_step(1)
    assert not faults.heartbeats_dropped()
    plan.on_step(2)
    assert faults.heartbeats_dropped()
    # The flag is not a filesystem flag: the JAX package's process-local
    # switch (and a relaunched process's) stays clear.
    assert not jax_faults.heartbeats_dropped()
    assert plan.fired(faults.DROP_HEARTBEATS) == 1


def test_kill_feed_queue_fires_on_item_count(tmp_path):
    plan = faults.FaultPlan(str(tmp_path / "p"))
    plan.kill_feed_queue(after_items=50)
    plan.on_feed_item(49)
    with pytest.raises(faults.InjectedFault, match="feed-consumer death"):
        plan.on_feed_item(50)
    plan.on_feed_item(51)  # spent


def test_hang_sleeps_then_raises(tmp_path):
    plan = faults.FaultPlan(str(tmp_path / "p"))
    plan.hang_at_step(2, duration=0.2)
    t0 = time.monotonic()
    with pytest.raises(faults.InjectedFault, match="hang at step 2 elapsed"):
        plan.on_step(2)
    assert time.monotonic() - t0 >= 0.2


def test_preemption_notice_then_sigterm_raises_preempted(tmp_path):
    """The notice arms a SIGTERM handler on the main thread; the SIGTERM
    after the grace raises ``Preempted`` there."""
    plan = faults.FaultPlan(str(tmp_path / "p"))
    plan.preempt_node(3, grace=0.2)
    before = signal.getsignal(signal.SIGTERM)
    try:
        plan.on_step(2)
        assert signal.getsignal(signal.SIGTERM) is before  # not yet
        plan.on_step(3)
        with pytest.raises(faults.Preempted, match="fired at step 3"):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                time.sleep(0.01)
        assert isinstance(faults.Preempted("x"), faults.InjectedFault)
        plan.on_step(4)  # spent: no second notice
        assert plan.fired(faults.PREEMPT) == 1
    finally:
        signal.signal(signal.SIGTERM, before)


def test_kill_decode_worker_raises_while_armed(tmp_path):
    """The decode-worker drill (the name is the one it had while the pool
    was not ported and the armed fault raised): unarmed it is a no-op;
    armed, it SIGKILLs the pool's lowest-pid live worker once, after
    ``after_batches``, and returns that pid; the stream finishes bitwise
    equal and the pool replaces the worker."""
    import torch_data_programs as progs
    from tensorflowonspark_tpu_torch.data import decode_pool

    plan = faults.FaultPlan(str(tmp_path / "p"))
    assert plan.on_pool_batch(5, pool=None) is None  # not armed
    plan.kill_decode_worker(after_batches=3)
    before = progs.live_children()
    with decode_pool.DecodePool(progs.decode_columnar, workers=2) as pool:
        got, fired = [], []
        for i, out in enumerate(pool.imap([[i] for i in range(10)])):
            got.append(out)
            pids = sorted(pool.worker_pids())
            pid = plan.on_pool_batch(i, pool)
            if pid is not None:
                fired.append((i, pid, pids[0]))
        stats = pool.stats()
    assert [(i, pid) for i, pid, _ in fired] == [(3, fired[0][2])]
    assert plan.fired(faults.KILL_DECODE_WORKER) == 1
    assert stats["worker_deaths"] == 1 and stats["workers"] == 2
    for i, batch in enumerate(got):
        want = progs.decode_columnar([i])
        np.testing.assert_array_equal(batch["image"], want["image"])
        np.testing.assert_array_equal(batch["label"], want["label"])
        assert batch["names"] == want["names"]
    assert progs.wait_no_new_children(before) == set()


def test_corrupt_step_damages_newest_step(tmp_path):
    root = tmp_path / "ckpt"
    for step in (1, 2):
        d = root / str(step) / "default"
        d.mkdir(parents=True)
        (d / "params.pt").write_bytes(b"x" * 100)
    assert faults.corrupt_step(str(root)) == 2
    assert (root / "2" / "default" / "params.pt").stat().st_size == 50
    assert (root / "1" / "default" / "params.pt").stat().st_size == 100
    assert faults.corrupt_step(str(tmp_path / "none")) is None


def _linreg_state():
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train.losses import mse

    tr = Trainer(factory.get_model("linear_regression", device="cpu"),
                 optimizer=trainer.sgd(0.5),
                 loss_fn=lambda out, b: mse(out, b["y"]), device="cpu")
    return tr, tr.init()


@pytest.mark.parametrize("mode", ["truncate", "delete"])
def test_corrupt_step_on_a_port_checkpoint_restores_the_step_before(
        tmp_path, mode):
    from tensorflowonspark_tpu.train import checkpoint as jax_ckpt
    from tensorflowonspark_tpu_torch.train.checkpoint import (
        CheckpointManager, latest_committed_step)

    root = str(tmp_path / "ckpt")
    tr, state = _linreg_state()
    rng = np.random.RandomState(0)
    mgr = CheckpointManager(root, max_to_keep=50)
    params = {}
    for _ in range(4):
        x = rng.rand(8, 2).astype(np.float32)
        state, _ = tr.train_step(state, {"x": x, "y": x.sum(1, keepdims=True)})
        mgr.save(state, force=True)
        params[state.step] = {k: v.detach().clone()
                              for k, v in state.params.items()}
    mgr.close()
    assert latest_committed_step(root) == 4
    names = sorted(os.listdir(os.path.join(root, "4", "default")))
    assert names == ["model_state.pt", "opt_state.pt", "params.pt"]

    assert faults.corrupt_step(root, mode=mode) == 4
    left = sorted(os.listdir(os.path.join(root, "4", "default")))
    if mode == "delete":
        assert left == ["opt_state.pt"]
    else:
        assert left == names
    # Marker validation sees the damage, in either package.
    assert latest_committed_step(root) == 3
    assert jax_ckpt.latest_committed_step(root) == 3

    tr2, fresh = _linreg_state()
    restored = CheckpointManager(root, max_to_keep=50).restore(fresh)
    assert restored.step == 3
    for k, v in restored.params.items():
        assert torch.equal(v, params[3][k])
    assert not os.path.exists(os.path.join(root, "4"))  # torn step gone
