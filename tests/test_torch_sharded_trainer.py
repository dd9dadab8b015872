"""The port's sharded ``Trainer`` held against the JAX ``Trainer`` on the
same mesh.

One group of four gloo ranks (``torch_shard_programs.trainer_cases``, run
once per session) trains the fp32 toy LM (2 layers, 4 heads, embed 32,
vocab 64) for three AdamW (1e-3) steps on each mesh: (data 2, fsdp 2) and
(data 2, tensor 2) on the dense route, (fsdp 2, tensor 2) on the flash
route, (seq 4) ``ring_flash`` zigzag and (seq 2, tensor 2) Ulysses,
(data 2, tensor 2) again with ``grad_accum=2`` and ``remat=True``,
whose trained state also runs ``eval_step`` and ``predict``, and (data
2, tensor 2) with GQA (4 query heads on 2 KV heads: the split q/kv
projections under tensor parallelism). The
batches are global, numpy-seeded packed rows with a padded tail; a rank
trains on its rows and cuts its sequence chunk, and the zigzag case lays
tokens, targets, segment ids and positions out with ``zigzag_layout``
first. Both sides start from the JAX trainer's init (identical on every
mesh), carried across by ``convert.params_from_flax``. The JAX trainer
runs on ``MeshConfig(...).build(jax.devices()[:4])`` with a pass-through
optax stage that keeps step 1's gradients.

Tolerances as ``tests/test_torch_trainer.py``'s three-step test: losses
and the gathered final parameters to 1e-5 (``rtol=0``); where step 1's JAX
gradient is below 1e-7, Adam's normalised first update can read a
gradient difference of a few 1e-9 as one of order lr, so those elements
are held to 3 lr, the most three updates can move a parameter apart.

Checkpoints: a step saved under (fsdp 2, tensor 2) restores bitwise in
one process under data 1, and a step saved in one process restores into
(fsdp 2, tensor 2) shards bitwise. The cluster case trains under (data 1,
tensor 2) inside a ``cluster.run`` node program over the feed.
"""

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_cluster_programs as cluster_progs
import torch_shard_programs as progs
from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.ops import attention as jax_attention
from tensorflowonspark_tpu.parallel import MeshConfig as JaxMeshConfig
from tensorflowonspark_tpu.train import Trainer as JaxTrainer
from tensorflowonspark_tpu_torch import backend, cluster, convert
from tensorflowonspark_tpu_torch.models import factory
from tensorflowonspark_tpu_torch.train import checkpoint as ckpt_lib
from tensorflowonspark_tpu_torch.train import trainer

pytestmark = pytest.mark.watchdog_timeout(120)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TOL = 1e-5
ADAM_NEAR_EPS = 1e-7


def _flat_numpy(tree):
    flat = convert._flat(jax.device_get(nn.meta.unbox(tree)))
    return {k.replace("/", "."): np.asarray(v) for k, v in flat.items()}


def _zigzag(x, n):
    return np.asarray(jax_attention.zigzag_layout(jnp.asarray(x), n))


def _capture_grads():
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_trainer(case, devices=4):
    mesh_kw, impl_kw = progs.TRAIN_CASES[case]
    jm = jax_factory.get_model("transformer", dtype=jnp.float32,
                               **progs.LM_KW, **impl_kw)
    return JaxTrainer(jm, optimizer=optax.chain(
        _capture_grads(), optax.adamw(progs.TRAIN_LR)), donate=False,
        mesh=JaxMeshConfig(**mesh_kw).build(jax.devices()[:devices]),
        **progs.TRAIN_OPTIONS.get(case, {}))


def _jax_init(case):
    tr = _jax_trainer(case)
    batch = progs.lm_batches(case, _zigzag, steps=1)[0]
    return tr, tr.init(jax.random.PRNGKey(0), batch)


def _prepare(outdir):
    """The JAX inits (MHA and GQA) as the port's state_dicts, and a step
    saved by one process under data 1 (one step on the first batch)."""
    paths = {}
    for key, case in (("params_gqa", "data2_tensor2_gqa"),
                      ("params", "data2_fsdp2")):
        _, state = _jax_init(case)
        params = convert.params_from_flax(
            jax.device_get(nn.meta.unbox(state.params)),
            _port_cfg(**progs.TRAIN_CASES[case][1]))
        paths[key] = os.path.join(outdir, key + ".pt")
        torch.save(params, paths[key])
    tr = trainer.Trainer(progs._lm({}, params),
                         optimizer=trainer.adamw(progs.TRAIN_LR),
                         device="cpu")
    st = tr.init()
    st, _ = tr.train_step(st, progs.lm_batches("data2_fsdp2")[0])
    ckpt = os.path.join(outdir, "ckpt_data1")
    mgr = ckpt_lib.CheckpointManager(ckpt)
    mgr.save(st)
    mgr.close()
    return dict(paths, ckpt_data1=ckpt)


def _port_cfg(**kw):
    from tensorflowonspark_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    kw.pop("attention_impl", None)
    return TransformerConfig(dtype=torch.float32, **progs.LM_KW, **kw)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return progs.cached_group(tmp_path_factory, "sharded_trainer",
                              progs.TRAIN_WORLD, "trainer_cases",
                              prepare=_prepare)


@pytest.fixture(scope="module", params=sorted(progs.TRAIN_CASES))
def jax_run(request, group):
    """``(case, losses, step-1 gradients, final parameters)`` of the JAX
    trainer on the case's mesh, once a module for each case."""
    case = request.param
    tr, state = _jax_init(case)
    init = torch.load(group["args"][progs.init_key(case)],
                      weights_only=True)
    for name, arr in _flat_numpy(state.params).items():
        assert np.array_equal(init[name].numpy(), arr), name
    losses, grads1 = [], None
    for batch in progs.lm_batches(case, _zigzag):
        state, m = tr.train_step(state, batch)
        losses.append(float(m["loss"]))
        if grads1 is None:
            grads1 = _flat_numpy(state.opt_state[0])
    evals = None
    if case == progs.EVAL_CASE:
        batch = progs.lm_batches(case, steps=1)[0]
        ev = tr.eval_step(state, batch)
        evals = (float(ev["loss"]), np.asarray(ev["outputs"]),
                 np.asarray(tr.predict(state, batch["x"])))
    return case, losses, grads1, _flat_numpy(state.params), evals


def test_three_adamw_steps_match_jax_trainer_on_the_mesh(group, jax_run):
    case, want_losses, grads1, want, evals = jax_run
    got = progs.case_result(group["ranks"], case)
    np.testing.assert_allclose(got[0]["losses"], want_losses, rtol=0,
                               atol=TOL, err_msg=case)
    lr = progs.TRAIN_LR
    for r in got:
        assert r["losses"] == got[0]["losses"]
        assert set(r["params"]) == set(want)
        for name, ref in want.items():
            t = r["params"][name]
            # Every rank rebuilds the same full tensor from the shards.
            np.testing.assert_array_equal(t, got[0]["params"][name])
            err = np.abs(t - ref)
            near = np.abs(grads1[name]) < ADAM_NEAR_EPS
            assert (err[~near] <= TOL).all(), (case, name,
                                               err[~near].max())
            assert (err[near] <= progs.TRAIN_STEPS * lr).all(), (case, name)
    if evals is None:
        return
    # eval_step's global-batch loss, and each rank's rows of the outputs
    # over the whole vocabulary, against JAX's global arrays.
    loss, outputs, predicted = evals
    b = progs.TRAIN_B // 2
    for rank, r in enumerate(got):
        rows = slice((rank // 2) * b, (rank // 2 + 1) * b)
        assert abs(r["eval_loss"] - loss) <= TOL
        np.testing.assert_allclose(r["eval_outputs"], outputs[rows], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(r["predict"], predicted[rows], rtol=0,
                                   atol=TOL)


def test_export_under_fsdp_and_tensor_writes_the_full_tree(group):
    """``export_saved_model`` called by every rank of the fsdp=2 x tensor=2
    group: the shards are gathered, rank 0 writes the full tree, which
    loads and serves in one process."""
    from tensorflowonspark_tpu_torch import export

    got = progs.case_result(group["ranks"], "fsdp2_tensor2")
    d = os.path.join(group["args"]["outdir"], "export_sharded")
    loaded = export.load_saved_model(d, device="cpu")
    assert set(loaded.variables) == set(got[0]["params"])
    for name, t in got[0]["params"].items():
        np.testing.assert_array_equal(loaded.variables[name].numpy(), t)
    tokens = progs.lm_batches("fsdp2_tensor2", steps=1)[0]["x"]
    assert np.isfinite(loaded.predict(tokens)["out"]).all()


def test_fsdp_and_tensor_hold_a_share_of_the_parameters(group):
    """Bytes of parameters a rank holds: (fsdp 2, tensor 2) keeps about a
    quarter of the replicated model, (data 2, fsdp 2) and (data 2,
    tensor 2) about half (layer norms stay whole everywhere)."""
    full = sum(v.numel() * 4 for v in torch.load(
        group["args"]["params"], weights_only=True).values())
    held = {case: {r["local_bytes"] for r in
                   progs.case_result(group["ranks"], case)}
            for case in progs.TRAIN_CASES}
    assert held["seq4_ring_flash_zigzag"] == {full}
    (quarter,) = held["fsdp2_tensor2"]
    assert 0.25 * full <= quarter < 0.35 * full
    for case in ("data2_fsdp2", "data2_tensor2", "seq2_tensor2_ulysses"):
        (half,) = held[case]
        assert 0.5 * full <= half < 0.6 * full, case


def test_step_saved_sharded_restores_bitwise_under_data1(group):
    ranks = progs.case_result(group["ranks"], "fsdp2_tensor2")
    params = torch.load(group["args"]["params"], weights_only=True)
    tr = trainer.Trainer(progs._lm({}, params),
                         optimizer=trainer.adamw(progs.TRAIN_LR),
                         device="cpu")
    state = tr.init()
    mgr = ckpt_lib.CheckpointManager(os.path.join(group["args"]["outdir"],
                                                  "ckpt_sharded"))
    assert mgr.latest_committed_step() == progs.TRAIN_STEPS
    state = mgr.restore(state)
    served = mgr.restore_variables()
    mgr.close()
    assert state.step == progs.TRAIN_STEPS
    for name, p in state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      ranks[0]["params"][name])
        assert torch.equal(served[name], p.detach())
    # The next step from the restored state is the sharded run's next
    # step's reference: a full, finite optimizer state of every moment.
    moments = state.optimizer.state_dict()["state"]
    assert len(moments) == len(state.params)
    for per, p in zip(moments.values(), state.params.values()):
        assert per["exp_avg"].shape == p.shape
        assert torch.isfinite(per["exp_avg_sq"]).all()


def test_step_saved_under_data1_restores_into_shards(group):
    ranks = progs.case_result(group["ranks"], "fsdp2_tensor2")
    mgr = ckpt_lib.CheckpointManager(group["args"]["ckpt_data1"])
    step = mgr.latest_committed_step()
    params = mgr._load(step, ckpt_lib.PARAMS, "cpu")
    opt = mgr._load(step, ckpt_lib.OPT_STATE, "cpu")
    mgr.close()
    names = list(params)
    for r in ranks:
        assert r["restored_step"] == step == 1
        for name, t in params.items():
            np.testing.assert_array_equal(r["restored"][name], t.numpy())
        for idx, per in opt["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(
                    r["restored_moments"][idx][key], per[key].numpy(),
                    err_msg="{} {}".format(names[idx], key))


S, B = 16, 2


def test_cluster_node_trains_tensor_parallel(tmp_path):
    """A ``cluster.run`` node program under (data 1, tensor 2) over gloo:
    both ranks train on the same rows (the pair's fed rows concatenated)
    and their losses equal the port's one-process trainer's on those
    rows."""
    lm = dict(progs.LM_KW, max_seq_len=S)
    model = factory.get_model("transformer", device="cpu",
                              dtype=torch.float32, attention_impl="pallas",
                              seed=5, **lm)
    init = str(tmp_path / "init.pt")
    torch.save({k: v.clone() for k, v in model.state_dict().items()}, init)
    rs = np.random.RandomState(9)
    rows = [rs.randint(1, lm["vocab_size"], size=S + 1).tolist()
            for _ in range(12)]
    out = str(tmp_path)
    pool = backend.LocalBackend(2, base_dir=str(tmp_path / "exec"))
    try:
        c = cluster.run(pool, cluster_progs.train_lm_tensor_parallel,
                        {"lm": lm, "lr": 1e-3, "init": init, "outdir": out,
                         "batch_size": B, "seq": S,
                         "mesh": {"data": 1, "tensor": 2}},
                        num_executors=2, input_mode=cluster.InputMode.FEED,
                        reservation_timeout=60)
        c.train(backend.Partitioned([rows[:6], rows[6:]]), timeout=90)
        c.shutdown(timeout=90)
    finally:
        pool.stop()
    docs = [json.load(open(os.path.join(out, "rank{}.json".format(r))))
            for r in (0, 1)]
    steps = docs[0]["steps"]
    assert docs[1]["steps"] == steps >= 3
    assert docs[0]["losses"] == docs[1]["losses"]
    assert [d["forbidden"] for d in docs] == [[], []]
    z = [np.load(os.path.join(out, "rank{}_batches.npz".format(r)))
         for r in (0, 1)]
    for key in z[0].files:
        np.testing.assert_array_equal(z[0][key], z[1][key])
    trained = sum(float(z[0]["mask_{}".format(i)].sum())
                  for i in range(steps))
    assert trained == len(rows) * S
    tr = trainer.Trainer(model, optimizer=trainer.adamw(1e-3), device="cpu")
    state = tr.init(params=torch.load(init, weights_only=True))
    want = []
    for i in range(steps):
        batch = {k: z[0]["{}_{}".format(k, i)] for k in ("x", "y", "mask")}
        state, m = tr.train_step(state, batch)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(docs[0]["losses"], want, rtol=0, atol=TOL)
