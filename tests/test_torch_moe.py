"""The port's MoE LM (``models/moe.py``) and expert parallelism held
against the JAX package's.

Routing: ``_top_k_routing`` on the same f32 probabilities, with ample
capacity, with overflow (``tests/test_moe.py``'s case: every token wants
expert 0, capacity 3) and with k=1: dispatch bitwise, combine to 1e-6;
given picks (teacher-forced routing) route as those picks do.
The LM (2 layers, layer 1 MoE with 4 experts, embed 32, f32): the forward
of the JAX init and its sown load-balance loss; three AdamW (1e-3) steps
in one process and under (data 2, expert 2) on four gloo ranks
(``torch_shard_programs.moe_cases``, once per session) against the JAX
``Trainer`` on the same mesh, ``metrics["aux_loss"]`` included, to the
sharded-trainer file's rules (1e-5; 3 lr where step 1's JAX gradient is
below 1e-7); eval leaves the aux term out; greedy ``generate`` emits
exactly JAX's tokens, and the port's engine streams equal solo
``generate`` bitwise.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_shard_programs as progs
from tensorflowonspark_tpu.models import decoding as jax_decoding
from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.models import moe as jax_moe
from tensorflowonspark_tpu.parallel import MeshConfig as JaxMeshConfig
from tensorflowonspark_tpu.train import Trainer as JaxTrainer
from tensorflowonspark_tpu_torch import convert, serving
from tensorflowonspark_tpu_torch.models import decoding, factory, moe
from tensorflowonspark_tpu_torch.train import checkpoint as ckpt_lib
from tensorflowonspark_tpu_torch.train import trainer

pytestmark = pytest.mark.watchdog_timeout(120)

TOL = 1e-5
ADAM_NEAR_EPS = 1e-7
_STATE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _capture_grads():
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _flat_numpy(tree):
    flat = convert._flat(jax.device_get(nn.meta.unbox(tree)))
    return {k.replace("/", "."): np.asarray(v) for k, v in flat.items()}


def _cfg(**kw):
    return moe.MoEConfig(dtype=torch.float32, **dict(progs.MOE_LM_KW, **kw))


def _jax_trainer(mesh_kw=None, devices=None):
    jm = jax_factory.get_model("moe_transformer", dtype=jnp.float32,
                               **progs.MOE_LM_KW)
    mesh = None if mesh_kw is None else JaxMeshConfig(**mesh_kw).build(
        jax.devices()[:devices])
    tr = JaxTrainer(jm, optimizer=optax.chain(
        _capture_grads(), optax.adamw(progs.TRAIN_LR)), donate=False,
        mesh=mesh)
    return tr, tr.init(jax.random.PRNGKey(0), progs.moe_batches(1)[0])


def _init():
    """The JAX init (one process) as flax params and the port's
    ``state_dict``."""
    if not _STATE:
        _, state = _jax_trainer()
        params = jax.device_get(nn.meta.unbox(state.params))
        _STATE.update(params=params,
                      sd=convert.params_from_flax(params, _cfg()))
    return _STATE["params"], _STATE["sd"]


def _prepare(outdir):
    _, sd = _init()
    path = os.path.join(outdir, "params.pt")
    torch.save(sd, path)
    return {"params": path}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return progs.cached_group(tmp_path_factory, "moe", progs.MOE_WORLD,
                              "moe_cases", prepare=_prepare)


def _jax_run(mesh_kw=None, devices=None):
    tr, state = _jax_trainer(mesh_kw, devices)
    init = _flat_numpy(state.params)
    for name, arr in _flat_numpy(_init()[0]).items():
        np.testing.assert_array_equal(init[name], arr)
    losses, aux, grads1 = [], [], None
    for batch in progs.moe_batches():
        state, m = tr.train_step(state, batch)
        losses.append(float(m["loss"]))
        aux.append(float(m["aux_loss"]))
        if grads1 is None:
            grads1 = _flat_numpy(state.opt_state[0])
    return losses, aux, grads1, _flat_numpy(state.params)


def _check_trained(got, want, case):
    want_losses, want_aux, grads1, params = want
    lr = progs.TRAIN_LR
    for r in got:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=0,
                                   atol=TOL, err_msg=case)
        np.testing.assert_allclose(r["aux"], want_aux, rtol=0, atol=TOL,
                                   err_msg=case)
        assert set(r["params"]) == set(params)
        for name, ref in params.items():
            err = np.abs(r["params"][name] - ref)
            near = np.abs(grads1[name]) < ADAM_NEAR_EPS
            assert (err[~near] <= TOL).all(), (case, name, err[~near].max())
            assert (err[near] <= progs.TRAIN_STEPS * lr).all(), (case, name)


# -- routing ----------------------------------------------------------------------


def _probs(case):
    rs = np.random.RandomState(0)
    if case == "overflow":
        # Every token prefers expert 0; capacity 3 keeps the first three.
        return np.tile(np.asarray([[0.9, 0.1]], np.float32), (8, 1))[None], \
            1, 3
    logits = rs.randn(2, 16, 4).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits)))
    return probs, (1 if case == "top1" else 2), 16


@pytest.mark.parametrize("case", ["ample", "overflow", "top1"])
def test_top_k_routing_matches_jax(case):
    probs, k, capacity = _probs(case)
    want_d, want_c = jax_moe._top_k_routing(jnp.asarray(probs), k, capacity)
    got_d, got_c = moe._top_k_routing(torch.tensor(probs), k, capacity)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-6)
    if case == "overflow":
        assert got_d[:, :3].sum() == 3 and got_d[:, 3:].sum() == 0


def _argmax_picks(probs, k):
    remaining, picks = probs, []
    for _ in range(k):
        idx = remaining.argmax(-1)
        picks.append(idx)
        remaining = remaining.scatter(-1, idx[..., None], 0.0)
    return picks


@pytest.mark.parametrize("case", ["ample", "overflow", "top1"])
def test_routing_follows_given_picks(case):
    """Teacher-forced routing: the argmax's own picks change nothing, and
    another forward's picks route as that forward did, gated by these
    probabilities."""
    probs, k, capacity = _probs(case)
    probs = torch.tensor(probs)
    plain = moe._top_k_routing(probs, k, capacity)
    pinned = moe._top_k_routing(probs, k, capacity,
                                picks=_argmax_picks(probs, k))
    for a, b in zip(plain, pinned):
        assert torch.equal(a, b)
    other = probs.flip(-1)
    want_d, _ = jax_moe._top_k_routing(jnp.asarray(other.numpy()), k,
                                       capacity)
    got_d, got_c = moe._top_k_routing(probs, k, capacity,
                                      picks=_argmax_picks(other, k))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    gates = (got_d.sum(-1) * probs).numpy()            # (B, S, E) kept
    if k > 1:
        gates = gates / np.maximum(gates.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(got_c.sum(-1).numpy(), gates, rtol=0,
                               atol=1e-6)


def test_routing_ties_take_the_first_expert():
    probs = np.full((1, 4, 4), 0.25, np.float32)
    want_d, _ = jax_moe._top_k_routing(jnp.asarray(probs), 2, 4)
    got_d, _ = moe._top_k_routing(torch.tensor(probs), 2, 4)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert got_d[0, :, :2].sum() == 8 and got_d[0, :, 2:].sum() == 0


# -- the model ----------------------------------------------------------------------


def _port_model(**kw):
    _, sd = _init()
    return progs.moe_lm(sd, **kw)


def test_forward_and_sown_aux_loss_match_jax():
    params, _ = _init()
    jm = jax_factory.get_model("moe_transformer", dtype=jnp.float32,
                               **progs.MOE_LM_KW)
    x = progs.moe_batches(1)[0]["x"]
    out, sown = jm.apply({"params": params}, jnp.asarray(x),
                         mutable=["losses"])
    (want_aux,) = jax.tree_util.tree_leaves(sown["losses"])
    model = _port_model()
    model.train()
    with torch.enable_grad():
        got = model(torch.tensor(x))
    (aux,) = model.pop_aux_losses()
    assert model.pop_aux_losses() == []
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=TOL)
    assert abs(float(aux.detach()) - float(want_aux)) <= 1e-7
    model.eval()
    np.testing.assert_allclose(model(torch.tensor(x)).numpy(),
                               np.asarray(jm.apply({"params": params},
                                                   jnp.asarray(x))),
                               rtol=0, atol=TOL)
    assert model.pop_aux_losses() == []


def test_expert_initializer_counts_the_expert_axis():
    model = factory.get_model("moe_transformer", device="cpu",
                              dtype=torch.float32, **dict(
                                  progs.MOE_LM_KW, num_experts=8,
                                  embed_dim=64, mlp_dim=128))
    w_up, w_down = model.block_1.moe.w_up, model.block_1.moe.w_down
    for w, fan_in in ((w_up, 8 * 64), (w_down, 8 * 128)):
        want = (2.0 / fan_in) ** 0.5
        assert abs(float(w.detach().std()) / want - 1) < 0.05
    assert abs(float(model.block_1.moe.router.kernel.detach().std())
               / 0.02 - 1) < 0.1


def test_three_adamw_steps_in_one_process_match_jax_trainer():
    want = _jax_run()
    tr = trainer.Trainer(_port_model(), optimizer=trainer.adamw(
        progs.TRAIN_LR), device="cpu")
    state = tr.init()
    losses, aux = [], []
    for batch in progs.moe_batches():
        state, m = tr.train_step(state, batch)
        losses.append(float(m["loss"]))
        aux.append(float(m["aux_loss"]))
    got = {"losses": losses, "aux": aux,
           "params": {k: p.detach().numpy() for k, p in
                      state.params.items()}}
    _check_trained([got], want, "one process")
    assert all(a > 0 for a in aux)
    assert not any("loss" in k for k in state.model_state)


def test_data2_expert2_trains_as_jax_trainer(group):
    (case,) = progs.MOE_CASES
    want = _jax_run(progs.MOE_CASES[case], 4)
    got = progs.case_result(group["ranks"], case)
    _check_trained(got, want, case)
    full = got[0]["params"]
    for r in got:
        for name, arr in full.items():
            np.testing.assert_array_equal(r["params"][name], arr)
            held = r["held"][name]
            if name.endswith(("moe.w_up", "moe.w_down")):
                assert held * 2 == arr.nbytes, name
            else:
                assert held == arr.nbytes, name


def test_eval_leaves_the_aux_term_out():
    tr = trainer.Trainer(_port_model(), optimizer=trainer.adamw(
        progs.TRAIN_LR), device="cpu")
    state = tr.init()
    batch = progs.moe_batches(1)[0]
    before = float(tr.eval_step(state, batch)["loss"])
    jtr, jstate = _jax_trainer()
    assert abs(before - float(jtr.eval_step(jstate, batch)["loss"])) <= TOL
    _, m = tr.train_step(state, batch)
    assert float(m["aux_loss"]) > 0
    assert abs(float(m["loss"]) - float(m["aux_loss"]) - before) <= TOL


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(
        1, progs.MOE_LM_KW["vocab_size"], size=n).astype(np.int32)


@pytest.mark.parametrize("shape,n_new,seed", [((1, 6), 8, 0),
                                              ((2, 5), 6, 1)])
def test_greedy_generate_matches_jax(shape, n_new, seed):
    params, sd = _init()
    jm = jax_factory.get_model("moe_transformer", dtype=jnp.float32,
                               **progs.MOE_LM_KW)
    prompt = np.random.RandomState(seed).randint(
        1, progs.MOE_LM_KW["vocab_size"], size=shape).astype(np.int32)
    ref = np.asarray(jax_decoding.generate(jm, {"params": params}, prompt,
                                           n_new, auto_cache=True))
    got = decoding.generate(progs.moe_lm(sd), None, prompt, n_new,
                            auto_cache=True)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_engine_streams_equal_solo_generate():
    model = _port_model()
    eng = serving.ServingEngine(model, None, max_slots=4, page_size=16,
                                num_pages=32, decode_horizon=4,
                                prefix_share=False, preempt="off",
                                device="cpu")
    try:
        prompts = [_prompt(n, s) for n, s in ((7, 3), (12, 4), (5, 5))]
        handles = [eng.submit(p, 9) for p in prompts]
        eng.run_until_idle()
        for p, h in zip(prompts, handles):
            solo = decoding.generate(model, None, p[None], 9,
                                     auto_cache=True)[0, len(p):].tolist()
            assert h.result(timeout=5) == solo
    finally:
        eng.close()


def test_step_saved_under_expert2_restores_and_serves(group):
    """The (data 2, expert 2) run's checkpoint holds the full experts: it
    restores bitwise into one process, and ``restore_variables`` serves
    greedy tokens equal to the restored model's ``generate``."""
    (case,) = progs.MOE_CASES
    ranks = progs.case_result(group["ranks"], case)
    mgr = ckpt_lib.CheckpointManager(os.path.join(group["args"]["outdir"],
                                                  "ckpt_" + case))
    tr = trainer.Trainer(_port_model(), optimizer=trainer.adamw(
        progs.TRAIN_LR), device="cpu")
    state = mgr.restore(tr.init())
    variables = mgr.restore_variables()
    mgr.close()
    assert state.step == progs.TRAIN_STEPS
    for name, p in state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      ranks[0]["params"][name])
    prompt = _prompt(6, 7)
    live = decoding.generate(tr.model, None, prompt[None], 6,
                             auto_cache=True)
    served = _port_model()
    eng = serving.ServingEngine(served, variables, max_slots=2,
                                page_size=16, num_pages=8, decode_horizon=2,
                                prefix_share=False, preempt="off",
                                device="cpu")
    try:
        h = eng.submit(prompt, 6)
        eng.run_until_idle()
        assert h.result(timeout=5) == live[0, len(prompt):].tolist()
    finally:
        eng.close()
