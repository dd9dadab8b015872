"""The port's cluster runtime end to end: ``cluster.run`` -> ``train`` /
``inference`` -> ``shutdown`` over ``LocalBackend`` executors, the
reference ``test_TFCluster`` flows and a data-parallel training run held
against the JAX ``Trainer``.

* The squares flow: FEED inference returns one result per item grouped by
  partition, FEED training reaches every item, FILES mode runs the node
  program inline, an error in the node program surfaces with its remote
  traceback, and consecutive clusters reuse the same executors. The chief
  serves ``/metrics`` and ``/statusz`` under ``tensorboard=True``.
* Data parallel: two gloo ranks train a toy ``TransformerLM`` (2 layers,
  width 64, fp32, ``attention_impl="pallas"``, whose flash wrappers run
  their plain versions on the CPU) with ``trainer.adamw(3e-4)`` through
  ``Trainer.fit`` over ``sync_batches``, from weights made by the JAX
  trainer's ``init`` and carried by ``convert.params_from_flax``. Each rank
  records every batch it trained on; the JAX ``Trainer`` (Pallas in
  interpret mode, ``optax.adamw(3e-4)``) takes the ranks' batches
  concatenated as its global batches. Once with even partitions, once with
  a short one, so that one rank trains on lockstep zero batches (mask 0).
  Losses agree to 1e-5. Each parameter element lies within 1e-5 of the
  JAX one, relative to its magnitude, with an absolute floor of 1e-5 below
  magnitude 1 (measured: at most 5.2e-7 of a tensor's largest magnitude).
  The ranks sum their own rows' gradients and the JAX step sums the
  global batch at once, so gradients differ in their last bits; where a
  step-1 gradient lies within ~10x of Adam's eps (1e-8) of zero, Adam's
  normalised update reads that difference as one of order lr (measured:
  2.1e-5 at a gradient of 5.8e-9), so those elements are held to
  steps x lr, as in ``tests/test_torch_trainer.py``. The replicas are
  bitwise equal, the collective checkpoint
  restores to the trained parameters on the driver, the heartbeats carry
  the step count to ``cluster_stats()``, and the compute children load
  nothing of JAX or of the JAX package.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

import torch_cluster_programs as progs
from tensorflowonspark_tpu_torch import (backend, cluster, convert, manager,
                                         supervisor)
from tensorflowonspark_tpu_torch.train import checkpoint as ckpt_lib

pytestmark = pytest.mark.watchdog_timeout(120)

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=64,
             mlp_dim=128, max_seq_len=32, remat=False)
B, S, LR = 2, 16, 3e-4
REL_TOL = 1e-5
ADAM_NEAR_EPS = 1e-7  # |step-1 gradient| within ~10 x Adam's eps of zero
_JAX = {}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    b = backend.LocalBackend(
        2, base_dir=str(tmp_path_factory.mktemp("exec")))
    yield b
    b.stop()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_squares_flow_inference_training_and_consecutive_clusters(
        pool, tmp_path):
    out = str(tmp_path)
    c = cluster.run(pool, progs.square_feed, {"outdir": out},
                    num_executors=2, input_mode=cluster.InputMode.FEED,
                    tensorboard=True, reservation_timeout=60)
    try:
        data = backend.Partitioned.from_items(range(100), 4)
        results = c.inference(data, timeout=60)
        assert [len(p) for p in results] == [25] * 4
        for part, got in zip(data.partitions, results):
            assert got == [float(x) ** 2 for x in part]
        body = urllib.request.urlopen(c.metrics_url() + "/metrics",
                                      timeout=10).read().decode()
        assert "tfos_up 1" in body
        status = json.loads(urllib.request.urlopen(
            c.metrics_url() + "/statusz", timeout=10).read())
        assert status["state"] == "running"
    finally:
        c.shutdown(timeout=60)
    pids = {_read(os.path.join(out, "feed_{}.json".format(i)))["pid"]
            for i in (0, 1)}
    assert len(pids) == 2
    for i in (0, 1):
        assert _read(os.path.join(out, "feed_{}.json".format(i)))[
            "forbidden"] == []
    # A second cluster on the same executors: FEED training.
    c = cluster.run(pool, progs.sum_train_feed, {"outdir": out},
                    num_executors=2, input_mode=cluster.InputMode.FEED,
                    reservation_timeout=60)
    c.train(backend.Partitioned.from_items(range(50), 3), num_epochs=2,
            timeout=60)
    c.shutdown(timeout=60)
    docs = [_read(os.path.join(out, "sum_{}.json".format(i)))
            for i in (0, 1)]
    assert sum(d["count"] for d in docs) == 100
    assert sum(d["sum"] for d in docs) == 2 * sum(range(50))
    assert all(d["count"] for d in docs)


def test_files_mode_and_remote_errors(pool, tmp_path):
    out = str(tmp_path)
    c = cluster.run(pool, progs.write_square_files, {"outdir": out},
                    num_executors=2, input_mode=cluster.InputMode.FILES,
                    reservation_timeout=60)
    c.shutdown(timeout=60)
    docs = [_read(os.path.join(out, "node_{}.json".format(i)))
            for i in (0, 1)]
    assert [d["value"] for d in docs] == [4.0, 9.0]
    assert [d["forbidden"] for d in docs] == [[], []]
    c = cluster.run(pool, progs.fail_feed, {}, num_executors=2,
                    input_mode=cluster.InputMode.FEED,
                    reservation_timeout=60,
                    incident_dir=os.path.join(out, "incidents"),
                    slos=["serve_ttft_ms_p95 < 1e9"])
    try:
        with pytest.raises(RuntimeError, match="boom from node") as err:
            c.inference(backend.Partitioned.from_items(range(8), 2),
                        timeout=60)
        assert "Traceback" in str(err.value)
        # incident_dir and slos are ported: the recorder is armed (the
        # straggler flag fires it) and the SLO monitor reports to it; the
        # crashed nodes' snapshots come from their manager KV.
        assert c.server.liveness.incident_cb == c.incidents.trigger
        assert c.history.slo_monitor.recorder is c.incidents
        # Both node programs have raised (their crash snapshots precede
        # the error state) before the capture.
        deadline = time.monotonic() + 30.0
        for meta in c.cluster_info:
            mgr = manager.connect(tuple(meta["addr"]),
                                  bytes.fromhex(meta["authkey"]))
            while mgr.get("state") != "error" and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
        bundle = c.capture_incident("manual")
        with open(os.path.join(bundle, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["nodes_captured"] == ["0", "1"]
        for eid in (0, 1):
            with open(os.path.join(bundle, "nodes",
                                   "node{}.json".format(eid))) as f:
                snap = json.load(f)
            assert snap["via"] == "manager_kv"
            assert "boom from node {}".format(eid) in snap["error"]
    finally:
        c.server.stop()
        c.history.set_slos(None)
    # Supervision and elastic membership are ported: a policy returns the
    # supervised cluster (nothing launches until a job), and elastic
    # membership keeps the JAX package's FEED-only check.
    sup = cluster.run(pool, progs.fail_feed, {},
                      restart_policy=supervisor.RestartPolicy())
    assert isinstance(sup, supervisor.SupervisedCluster)
    with pytest.raises(ValueError, match="FEED"):
        cluster.run(pool, progs.fail_feed, {}, elastic=True)


# -- data-parallel training against the JAX Trainer --------------------------


def _jax_trainer():
    """The JAX trainer (one compile per module) and its initial state."""
    if not _JAX:
        import jax
        import jax.numpy as jnp
        import optax

        from tensorflowonspark_tpu.models import factory as jax_factory
        from tensorflowonspark_tpu.parallel import MeshConfig
        from tensorflowonspark_tpu.train import Trainer as JaxTrainer

        model = jax_factory.get_model("transformer", dtype=jnp.float32,
                                      attention_impl="pallas", **LM_KW)
        # A pass-through stage that keeps the step's gradients as its
        # state, chained before AdamW: the updates are AdamW's.
        keep = optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))
        tr = JaxTrainer(model, optimizer=optax.chain(keep, optax.adamw(LR)),
                        donate=False,
                        mesh=MeshConfig(data=1).build(jax.devices()[:1]))
        sample = {"x": np.zeros((2 * B, S), np.int32),
                  "y": np.zeros((2 * B, S), np.int32),
                  "mask": np.ones((2 * B, S), np.float32)}
        _JAX["trainer"] = tr
        _JAX["state"] = tr.init(jax.random.PRNGKey(0), sample)
    return _JAX["trainer"], _JAX["state"]


def _flat_numpy(tree):
    import flax.linen as nn
    import jax

    flat = convert._flat(jax.device_get(nn.meta.unbox(tree)))
    return {k.replace("/", "."): np.asarray(v) for k, v in flat.items()}


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, LM_KW["vocab_size"], size=S + 1).tolist()
            for _ in range(n)]


def _recorded(outdir, rank, steps):
    z = np.load(os.path.join(outdir, "rank{}_batches.npz".format(rank)))
    return [{k: z["{}_{}".format(k, i)] for k in ("x", "y", "mask")}
            for i in range(steps)]


@pytest.mark.parametrize("sizes", [[2, 2, 2, 2, 2, 2], [2, 2, 2, 2, 2]],
                         ids=["even", "one_rank_short"])
def test_data_parallel_training_matches_the_jax_trainer(pool, tmp_path,
                                                        sizes):
    from tensorflowonspark_tpu_torch.models import factory

    jax_tr, jax_state0 = _jax_trainer()
    cfg = factory.get_model("transformer", device="cpu",
                            dtype=torch.float32, attention_impl="pallas",
                            **LM_KW).cfg
    init = str(tmp_path / "init.pt")
    torch.save(convert.params_from_flax(_jax_tree(jax_state0.params), cfg),
               init)
    out, ckpt_dir = str(tmp_path), str(tmp_path / "ckpt")
    args = {"lm": LM_KW, "lr": LR, "init": init, "outdir": out,
            "batch_size": B, "seq": S, "ckpt_dir": ckpt_dir}
    c = cluster.run(pool, progs.train_lm_data_parallel, args,
                    num_executors=2, input_mode=cluster.InputMode.FEED,
                    heartbeat_interval=0.5, reservation_timeout=60)
    rows = _rows(sum(sizes), seed=len(sizes))
    parts, at = [], 0
    for n in sizes:
        parts.append(rows[at:at + n])
        at += n
    c.train(backend.Partitioned(parts), timeout=90)
    c.shutdown(timeout=90)
    docs = [_read(os.path.join(out, "rank{}.json".format(r))) for r in (0, 1)]
    steps = docs[0]["steps"]
    assert docs[1]["steps"] == steps >= 3
    assert docs[0]["losses"] == docs[1]["losses"]
    assert [d["backend"] for d in docs] == ["gloo", "gloo"]
    assert [d["forbidden"] for d in docs] == [[], []]
    per_rank = [_recorded(out, r, steps) for r in (0, 1)]
    trained = sum(float(b["mask"].sum()) for r in per_rank for b in r)
    assert trained == len(rows) * S  # every row once, nothing twice
    if len(sizes) == 5:
        assert any(b["mask"].sum() == 0 for r in per_rank for b in r)
    # The JAX step on the concatenated global batches.
    state = jax_state0
    want_losses = []
    for b0, b1 in zip(*per_rank):
        glob = {k: np.concatenate([b0[k], b1[k]]) for k in b0}
        glob["x"] = glob["x"].astype(np.int32)
        glob["y"] = glob["y"].astype(np.int32)
        state, m = jax_tr.train_step(state, glob)
        want_losses.append(float(m["loss"]))
        if len(want_losses) == 1:
            grads1 = _flat_numpy(state.opt_state[0])
    np.testing.assert_allclose(docs[0]["losses"], want_losses, rtol=0,
                               atol=1e-5)
    want = _flat_numpy(state.params)
    p0, p1 = (torch.load(os.path.join(out, "rank{}_params.pt".format(r)),
                         weights_only=True) for r in (0, 1))
    assert set(p0) == set(want)
    for name, t in p0.items():
        assert torch.equal(t, p1[name]), name
        ref = want[name]
        err = np.abs(t.numpy() - ref)
        near = np.abs(grads1[name]) < ADAM_NEAR_EPS
        assert (err[~near] <= REL_TOL * np.maximum(np.abs(ref[~near]), 1.0)
                ).all(), (name, err[~near].max())
        assert (err[near] <= steps * LR).all(), name
    # The collective checkpoint, restored on the driver.
    mgr = ckpt_lib.CheckpointManager(ckpt_dir)
    assert mgr.latest_committed_step() == steps
    restored = mgr.restore_variables()
    for name, t in p0.items():
        assert torch.equal(restored[name], t), name
    mgr.close()
    # The heartbeats carried each rank's progress to the driver.
    stats = c.cluster_stats()
    for eid in (0, 1):
        assert stats[eid]["status"] == "finished"
        assert stats[eid]["step"] == steps
        assert stats[eid]["last_checkpoint_step"] == steps
        assert stats[eid]["steps_per_sec"] > 0


def _jax_tree(tree):
    import flax.linen as nn
    import jax

    return jax.device_get(nn.meta.unbox(tree))
