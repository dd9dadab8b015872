"""The port's pipeline parallelism (``parallel/pipeline.py``) and
pipelined LM (``models/pipelined.py``) held against the JAX package's.

``pipeline()``: a group of four gloo ranks (``torch_shard_programs.
pipeline_cases``, once per session) runs GPipe on a pipe of 4 and of 2
(four stages grouped two a rank), and the interleaved schedule on a pipe
of 2 with two rounds and 2 or 4 microbatches (whole factored parameters,
and each rank's shard of them), on the JAX pipeline tests' tanh stages
(``tests/test_pipeline_parallel.py``). JAX runs ``pp.pipeline`` on a pipe
mesh of the same size. Outputs, the input's gradient and the stage
parameters' gradients (a rank's rows of them, summed over the pipe group)
to 1e-5 in f32. The group also trips the JAX ``ValueError``s, and the
sequential path (no pipe axis) runs in one process.

The pipelined LM: the forward of the JAX init with no mesh (1e-4, as
``tests/test_pipeline_parallel.py``), and three AdamW (1e-3) steps under
(data 2, pipe 2) GPipe in the four-rank group and under (pipe 2) with two
rounds in a group of two, against the JAX ``Trainer`` on the same mesh,
to the sharded-trainer file's rules (1e-5; 3 lr where step 1's JAX
gradient is below 1e-7). The interleaved run's checkpoint restores in one
process as it is: the stage layout is the same for every pipe degree.
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
from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.models import pipelined as jax_pipelined
from tensorflowonspark_tpu.parallel import MeshConfig as JaxMeshConfig
from tensorflowonspark_tpu.parallel import pipeline as jax_pp
from tensorflowonspark_tpu.train import Trainer as JaxTrainer
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import factory, pipelined
from tensorflowonspark_tpu_torch.parallel import pipeline as pp
from tensorflowonspark_tpu_torch.train import checkpoint as ckpt_lib
from tensorflowonspark_tpu_torch.train import trainer

pytestmark = pytest.mark.watchdog_timeout(120)

TOL = 1e-5
LM_TOL = 1e-4
ADAM_NEAR_EPS = 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_stacked(stages):
    params, x = progs.pipeline_inputs(stages)
    return jax_pp.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in params]), x


def _jax_pipeline(case):
    """JAX ``pp.pipeline`` of a case on a pipe mesh of its size: output,
    and the gradients of ``sum(out ** 2)`` in the case's layout."""
    pipe, stages, rounds, mb, layout = progs.PIPELINE_CASES[case]
    stacked, x = _jax_stacked(stages)
    factored = layout != "stacked"
    if factored:
        stacked = jax_pp.factor_stage_params(stacked, rounds, pipe)
    mesh = JaxMeshConfig(data=1, pipe=pipe).build(jax.devices()[:pipe])

    def loss(p, x):
        out = jax_pp.pipeline(_jax_stage_fn, p, x, mb, num_rounds=rounds,
                              factored=factored)
        return jnp.sum(out ** 2), out

    with jax.set_mesh(mesh):
        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(x))
    return (np.asarray(out), np.asarray(gx),
            jax.tree_util.tree_map(np.asarray, gp))


def _pp_lm_jax(mesh_kw, model_kw, devices):
    jm = jax_factory.get_model("pipelined_transformer", dtype=jnp.float32,
                               **progs.PP_LM_KW, **model_kw)
    tr = JaxTrainer(jm, optimizer=optax.chain(
        _capture_grads(), optax.adamw(progs.TRAIN_LR)), donate=False,
        mesh=JaxMeshConfig(**mesh_kw).build(jax.devices()[:devices]))
    state = tr.init(jax.random.PRNGKey(0), progs.pp_lm_batches(1)[0])
    return tr, state


def _capture_grads():
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _port_numpy(tree, model_kw):
    params = convert.params_from_flax(jax.device_get(nn.meta.unbox(tree)),
                                      _port_cfg(model_kw))
    return {k: v.numpy() for k, v in params.items()}


def _port_cfg(model_kw):
    return pipelined.PipelinedConfig(dtype=torch.float32, **progs.PP_LM_KW,
                                     **model_kw)


def _prepare_for(cases):
    def prepare(outdir):
        (case,) = cases
        mesh_kw, model_kw = cases[case]
        _, state = _pp_lm_jax(mesh_kw, model_kw,
                              mesh_kw.get("data", 1) * mesh_kw["pipe"])
        params = convert.params_from_flax(
            jax.device_get(nn.meta.unbox(state.params)), _port_cfg(model_kw))
        path = os.path.join(outdir, "params.pt")
        torch.save(params, path)
        return {"params": path}
    return prepare


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return progs.cached_group(tmp_path_factory, "pipeline",
                              progs.PIPELINE_WORLD, "pipeline_cases",
                              prepare=_prepare_for(progs.PP_TRAIN_CASES))


@pytest.fixture(scope="module")
def interleaved_group(tmp_path_factory):
    return progs.cached_group(tmp_path_factory, "pipeline_interleaved",
                              progs.PP_INTERLEAVED_WORLD,
                              "interleaved_cases",
                              prepare=_prepare_for(
                                  progs.PP_INTERLEAVED_CASES))


# -- pipeline() -------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(progs.PIPELINE_CASES))
def test_pipeline_matches_jax_outputs_and_gradients(group, case):
    pipe, _, rounds, _, layout = progs.PIPELINE_CASES[case]
    out, gx, gp = _jax_pipeline(case)
    got = progs.case_result(group["ranks"], case)
    summed = {k: 0 for k in gp}
    for r in got:
        np.testing.assert_allclose(r["out"], out, rtol=0, atol=TOL)
        np.testing.assert_allclose(r["dx"], gx, rtol=0, atol=TOL)
        d = r["pipe_index"]
        for k, ref in gp.items():
            if layout == "shard":
                np.testing.assert_allclose(r["grads"][k], ref[:, d:d + 1],
                                           rtol=0, atol=TOL)
            else:
                summed[k] = summed[k] + r["grads"][k]
    if layout != "shard":
        replicas = len(got) // pipe
        for k, ref in gp.items():
            np.testing.assert_allclose(summed[k] / replicas, ref, rtol=0,
                                       atol=TOL)


@pytest.mark.parametrize("name,match", [
    ("not_multiple", "multiple of"), ("interleaved_stacked", "factored"),
    ("too_few_microbatches", "num_microbatches"),
    ("indivisible", "not divisible"), ("factored_lead", "leading axes")])
def test_pipeline_raises_the_jax_value_errors(group, name, match):
    for r in progs.case_result(group["ranks"], name):
        assert r["message"] is not None and match in r["message"], r


def test_pipeline_rejects_zero_rounds():
    params, x = progs.pipeline_inputs(2)
    stacked = pp.stack_stage_params(
        [{k: torch.tensor(v) for k, v in p.items()} for p in params])
    with pytest.raises(ValueError, match="num_rounds must be >= 1"):
        pp.pipeline(progs.pp_stage_fn, stacked, torch.tensor(x), 4,
                    num_rounds=0)


@pytest.mark.parametrize("factored", [False, True])
def test_sequential_path_without_pipe_axis_matches_jax(factored):
    stacked, x = _jax_stacked(progs.PP_S)
    if factored:
        stacked = jax_pp.factor_stage_params(stacked, 2, 2)

    def loss(p, x):
        out = jax_pp.pipeline(_jax_stage_fn, p, x, 4, num_rounds=2,
                              factored=factored)
        return jnp.sum(out ** 2), out

    with jax.set_mesh(JaxMeshConfig(data=1).build(jax.devices()[:1])):
        (_, out), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(stacked, jnp.asarray(x))
    leaves = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in stacked.items()}
    xt = torch.tensor(x, requires_grad=True)
    got = pp.pipeline(progs.pp_stage_fn, leaves, xt, 4, num_rounds=2,
                      factored=factored)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=0, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0, atol=TOL)
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), gp[k], rtol=0, atol=TOL)


@pytest.mark.parametrize("stages,rounds,pipe", [(4, 2, 2), (8, 2, 2),
                                                (12, 3, 2), (8, 1, 4)])
def test_factor_and_unfactor_round_trip_as_jax(stages, rounds, pipe):
    params, _ = progs.pipeline_inputs(stages)
    stacked = pp.stack_stage_params(
        [{k: torch.tensor(v) for k, v in p.items()} for p in params])
    jax_stacked = jax_pp.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in params])
    got = pp.factor_stage_params(stacked, rounds, pipe)
    want = jax_pp.factor_stage_params(jax_stacked, rounds, pipe)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert torch.equal(pp.unfactor_stage_params(got)[k], stacked[k])
    with pytest.raises(ValueError, match="multiple of"):
        pp.factor_stage_params(stacked, rounds, pipe + 3)


# -- the pipelined LM -------------------------------------------------------------


def test_pipelined_lm_forward_matches_jax_without_mesh():
    kw = dict(progs.PP_LM_KW, num_stages=2, num_microbatches=4)
    jm = jax_factory.get_model("pipelined_transformer", dtype=jnp.float32,
                               **kw)
    tokens = np.random.RandomState(2).randint(0, 64, size=(8, 16)).astype(
        np.int32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    ref = np.asarray(jm.apply(variables, jnp.asarray(tokens)))
    params = jax.device_get(nn.meta.unbox(variables["params"]))
    cfg = pipelined.PipelinedConfig(dtype=torch.float32, **kw)
    model = factory.get_model("pipelined_transformer", device="cpu",
                              dtype=torch.float32, **kw)
    model.load_state_dict(convert.params_from_flax(params, cfg))
    assert tuple(model.qkv.shape[:3]) == (1, 2, 2)
    got = model(torch.tensor(tokens)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LM_TOL)
    # A JAX tree made under pipe=2 loads into the same port layout.
    moved = pipelined.convert_stage_layout(
        {k: torch.tensor(np.asarray(params[k]))
         for k in pipelined.STAGE_PARAM_KEYS}, 1, 2)
    want = jax_pipelined.convert_stage_layout(params, 1, 2)
    for k, v in moved.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    from_pipe2 = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, want), cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(from_pipe2[k], v), k


def test_pipelined_lm_initializer_counts_stacked_fan_in():
    """flax's he_normal on the stacked shapes: fan-in is every axis but the
    last (``num_layers * embed * 3 * heads`` for ``qkv``)."""
    model = factory.get_model("pipelined_transformer", device="cpu",
                              dtype=torch.float32, vocab_size=64,
                              num_layers=8, num_heads=4, embed_dim=64,
                              mlp_dim=128, max_seq_len=16, num_stages=4)
    for key in ("qkv", "attn_out", "up", "down"):
        p = getattr(model, key)
        want = (2.0 * p.shape[-1] / p.numel()) ** 0.5
        assert abs(float(p.detach().std()) / want - 1) < 0.05, key
    for kw in (dict(decode=True), dict(segment_ids=torch.ones(1, 4))):
        with pytest.raises(NotImplementedError):
            model(torch.zeros(1, 4, dtype=torch.long), **kw)


def _jax_run(mesh_kw, model_kw, devices):
    """The JAX Trainer's losses, step-1 gradients and final parameters,
    the trees in the port's layout."""
    tr, state = _pp_lm_jax(mesh_kw, model_kw, devices)
    losses, grads1 = [], None
    for batch in progs.pp_lm_batches():
        state, m = tr.train_step(state, batch)
        losses.append(float(m["loss"]))
        if grads1 is None:
            grads1 = _port_numpy(state.opt_state[0], model_kw)
    return losses, grads1, _port_numpy(state.params, model_kw)


def _check_trained(got, want_losses, grads1, want, case):
    np.testing.assert_allclose(got[0]["losses"], want_losses, rtol=0,
                               atol=TOL, err_msg=case)
    lr = progs.TRAIN_LR
    for r in got:
        assert r["losses"] == got[0]["losses"]
        assert set(r["params"]) == set(want)
        for name, ref in want.items():
            t = r["params"][name]
            np.testing.assert_array_equal(t, got[0]["params"][name])
            err = np.abs(t - ref)
            near = np.abs(grads1[name]) < ADAM_NEAR_EPS
            assert (err[~near] <= TOL).all(), (case, name, err[~near].max())
            assert (err[near] <= progs.TRAIN_STEPS * lr).all(), (case, name)


def _stage_bytes_halved(r, full):
    """A pipe-2 rank holds exactly half of every stage parameter's bytes
    and the whole embedding."""
    for key in pipelined.STAGE_PARAM_KEYS:
        assert r["held"][key] * 2 == full[key].nbytes, key
    assert r["held"]["embed.embedding"] == full["embed.embedding"].nbytes


def test_gpipe_data2_pipe2_trains_as_jax_trainer(group):
    (case,) = progs.PP_TRAIN_CASES
    mesh_kw, model_kw = progs.PP_TRAIN_CASES[case]
    want_losses, grads1, want = _jax_run(mesh_kw, model_kw, 4)
    got = progs.case_result(group["ranks"], case)
    _check_trained(got, want_losses, grads1, want, case)
    for r in got:
        _stage_bytes_halved(r, got[0]["params"])


def test_interleaved_pipe2_trains_as_jax_trainer(interleaved_group):
    (case,) = progs.PP_INTERLEAVED_CASES
    mesh_kw, model_kw = progs.PP_INTERLEAVED_CASES[case]
    want_losses, grads1, want = _jax_run(mesh_kw, model_kw, 2)
    got = progs.case_result(interleaved_group["ranks"], case)
    _check_trained(got, want_losses, grads1, want, case)
    for r in got:
        _stage_bytes_halved(r, got[0]["params"])


def test_interleaved_step_saved_under_pipe2_restores_in_one_process(
        interleaved_group):
    (case,) = progs.PP_INTERLEAVED_CASES
    _, model_kw = progs.PP_INTERLEAVED_CASES[case]
    ranks = progs.case_result(interleaved_group["ranks"], case)
    params = torch.load(interleaved_group["args"]["params"],
                        weights_only=True)
    tr = trainer.Trainer(progs._pp_lm(model_kw, params),
                         optimizer=trainer.adamw(progs.TRAIN_LR),
                         device="cpu")
    state = tr.init()
    assert tuple(state.params["qkv"].shape[:3]) == (2, 2, 1)
    mgr = ckpt_lib.CheckpointManager(os.path.join(
        interleaved_group["args"]["outdir"], "ckpt_" + case))
    state = mgr.restore(state)
    mgr.close()
    assert state.step == progs.TRAIN_STEPS
    for name, p in state.params.items():
        want = ranks[0]["params"][name]
        np.testing.assert_array_equal(p.detach().numpy(), want)
    moments = state.optimizer.state_dict()["state"]
    for per, p in zip(moments.values(), state.params.values()):
        assert per["exp_avg"].shape == p.shape
    # The restored state steps on (its moments in the one-process layout).
    state, m = tr.train_step(state, progs.pp_lm_batches(1)[0])
    assert np.isfinite(float(m["loss"]))
