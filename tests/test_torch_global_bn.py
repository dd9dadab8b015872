"""Global-batch BatchNorm of the port under ``data > 1``.

Two gloo ranks (``torch_shard_programs.bn_cases``, once per session)
train the port's ResNet-18 (width 8, f32, 10 classes) for one SGD (0.1)
step under ``MeshConfig(data=2)``, each on its two rows of one
numpy-seeded batch of four 64x64 images. The JAX ``Trainer`` takes the
same step with ``data=2`` over two CPU devices (flax's BatchNorm then
normalises over the global batch), and the port's one-process trainer
takes it on the whole batch. Both start from the JAX init, carried across
by ``convert.resnet_params_from_flax``.

Tolerances, as ``tests/test_torch_resnet_trainer.py``'s: the loss to 1e-5;
every parameter and running statistic after the step to 1e-4 of its
tensor's largest value (BatchNorm's gradient is a difference of nearly
equal terms, so f32 summation order shows most in the norms' scales and
biases); every gradient likewise, with a floor of 1e-6 (and lr x 1e-6 for
the parameters it moves) for tensors whose gradients are all small (the bias of a branch's last norm, whose scale
starts at zero: largest gradient 1.4e-3, one element 2.4e-7 from JAX's).
The running statistics are bitwise equal on both ranks.
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
from tensorflowonspark_tpu.parallel import MeshConfig as JaxMeshConfig
from tensorflowonspark_tpu.train import Trainer as JaxTrainer
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.train import trainer

pytestmark = pytest.mark.watchdog_timeout(120)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

LOSS_TOL = 1e-5
RTOL = 1e-4


def _capture_grads():
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_trainer():
    jm = jax_factory.get_model("resnet18",
                               **dict(progs.BN_KW, dtype=np.float32))
    return JaxTrainer(
        jm, optimizer=optax.chain(_capture_grads(), optax.sgd(progs.BN_LR)),
        donate=False, mesh=JaxMeshConfig(data=progs.BN_WORLD).build(
            jax.devices()[:progs.BN_WORLD]))


def _variables(params, stats):
    return {"params": jax.device_get(nn.meta.unbox(params)),
            "batch_stats": jax.device_get(stats)}


def _prepare(outdir):
    tr = _jax_trainer()
    state = tr.init(jax.random.PRNGKey(0), progs.bn_batch())
    model = _port_model()
    path = os.path.join(outdir, "variables.pt")
    torch.save(convert.resnet_params_from_flax(
        _variables(state.params, state.model_state["batch_stats"]), model),
        path)
    return {"variables": path}


def _port_model():
    from tensorflowonspark_tpu_torch.models import factory

    return factory.get_model("resnet18", device="cpu", dtype=torch.float32,
                             **progs.BN_KW)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return progs.cached_group(tmp_path_factory, "global_bn", progs.BN_WORLD,
                              "bn_cases", prepare=_prepare)


@pytest.fixture(scope="module")
def jax_step(group):
    tr = _jax_trainer()
    state = tr.init(jax.random.PRNGKey(0), progs.bn_batch())
    state, m = tr.train_step(state, progs.bn_batch())
    model = _port_model()
    grads = convert.resnet_params_from_flax(
        _variables(state.opt_state[0], state.model_state["batch_stats"]),
        model)
    after = convert.resnet_params_from_flax(
        _variables(state.params, state.model_state["batch_stats"]), model)
    return float(m["loss"]), grads, after


@pytest.fixture(scope="module")
def port_step(group):
    variables = torch.load(group["args"]["variables"], weights_only=True)
    tr = trainer.Trainer(progs.bn_model(variables),
                         optimizer=trainer.sgd(progs.BN_LR), device="cpu")
    state = tr.init()
    state, m = tr.train_step(state, progs.bn_batch())
    grads = {k: p.grad.clone() for k, p in state.params.items()}
    after = dict(tr.model.state_dict())
    return float(m["loss"]), grads, after


GRAD_FLOOR = 1e-6


def _close(got, want, what, floor=0.0):
    for name, ref in want.items():
        if name not in got:
            continue
        ref = torch.as_tensor(ref)
        val = torch.as_tensor(got[name])
        atol = max(RTOL * max(float(ref.abs().max()), 1e-6), floor)
        torch.testing.assert_close(val, ref, rtol=0, atol=atol,
                                   msg=lambda m, n=name: "{} {}: {}".format(
                                       what, n, m))


@pytest.mark.parametrize("reference", ["jax_data2", "port_whole_batch"])
def test_one_sgd_step_with_global_batch_norm(group, reference, request):
    loss, grads, after = request.getfixturevalue(
        "jax_step" if reference == "jax_data2" else "port_step")
    ranks = progs.case_result(group["ranks"], "data2")
    for r in ranks:
        assert abs(r["loss"] - loss) <= LOSS_TOL
        _close(r["grads"], grads, "gradient", GRAD_FLOOR)
        # One SGD step moves a parameter by lr x its gradient.
        _close(r["params"], after, "parameter", progs.BN_LR * GRAD_FLOOR)
        _close(r["stats"], after, "running statistic")


def test_running_statistics_equal_on_every_rank(group):
    ranks = progs.case_result(group["ranks"], "data2")
    assert ranks[0]["loss"] == ranks[1]["loss"]
    for name, stat in ranks[0]["stats"].items():
        np.testing.assert_array_equal(stat, ranks[1]["stats"][name])
    for name, p in ranks[0]["params"].items():
        np.testing.assert_array_equal(p, ranks[1]["params"][name])
