"""The port's ``MLP`` and ``LinearRegression`` (``models/mlp.py``) held
against the flax modules, with weights carried by
``convert.dense_params_from_flax``; and the trainer the supervised and
elastic node programs build (``LinearRegression``, ``trainer.sgd(0.5)``,
masked MSE) against the JAX ``Trainer`` with ``optax.sgd(0.5)`` over the
same batches.

Tolerances: linear regression, its SGD losses and weights 1e-6 relative
(outputs read 0); the f32 MLP 1e-5 (read 1.3e-7 of the largest logit);
the bf16 MLP two bf16 ulps, 8e-3 of the largest logit (read 9.0e-8: both
round each layer's product to bf16, one flipped rounding would show as
one ulp). The port's initializers are flax's families, drawn from a torch
generator: their moments, not their values, are compared.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.parallel import MeshConfig as JaxMeshConfig
from tensorflowonspark_tpu.train import Trainer as JaxTrainer
from tensorflowonspark_tpu.train.losses import mse as jax_mse
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import factory
from tensorflowonspark_tpu_torch.testing import programs

pytestmark = pytest.mark.watchdog_timeout(120)

F32_RTOL = 1e-6
BF16_TOL = 8e-3


def _flax_params(model, x):
    variables = model.init(jax.random.PRNGKey(0), x)
    return jax.device_get(variables["params"])


def test_linear_regression_matches_flax():
    x = np.random.RandomState(0).rand(16, 2).astype(np.float32)
    flax_model = jax_factory.get_model("linear_regression")
    params = _flax_params(flax_model, x)
    want = np.asarray(flax_model.apply({"params": params}, x))
    port = factory.get_model("linear_regression", device="cpu")
    port.load_state_dict(convert.dense_params_from_flax(params, port))
    got = port(x).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_matches_flax(dtype):
    import jax.numpy as jnp

    x = np.random.RandomState(1).rand(8, 6, 5).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    flax_model = jax_factory.get_model("mlp", features=(32, 16),
                                       num_classes=10, dtype=jdt)
    params = _flax_params(flax_model, x)
    want = np.asarray(flax_model.apply({"params": params}, x), np.float32)
    port = factory.get_model("mlp", device="cpu", in_features=30,
                             features=(32, 16), num_classes=10, dtype=tdt)
    port.load_state_dict(convert.dense_params_from_flax(params, port))
    got = port(x).detach().float().numpy()
    assert got.shape == want.shape == (8, 10)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def test_convert_checks_names_and_shapes():
    x = np.zeros((2, 3), np.float32)
    params = _flax_params(jax_factory.get_model("linear_regression"), x)
    port = factory.get_model("linear_regression", device="cpu")  # 2 inputs
    with pytest.raises(ValueError, match="shape"):
        convert.dense_params_from_flax(params, port)
    with pytest.raises(ValueError, match="missing"):
        convert.dense_params_from_flax({}, port)


def test_initializers_are_flax_families():
    port = factory.get_model("mlp", device="cpu", in_features=400,
                             features=(300,), num_classes=200, seed=3)
    hidden, head = port.Dense_0.kernel, port.Dense_1.kernel
    # he_normal (variance 2/fan_in) and lecun_normal (1/fan_in), cut at 2
    # std: every value within the cut, variance within 5%.
    for w, var in ((hidden, 2.0 / 400), (head, 1.0 / 300)):
        std = (var ** 0.5) / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * std
        assert abs(float(w.var()) / var - 1) < 0.05
    assert float(port.Dense_0.bias.abs().sum()) == 0.0
    again = factory.get_model("mlp", device="cpu", in_features=400,
                              features=(300,), num_classes=200, seed=3)
    assert torch.equal(again.Dense_0.kernel, hidden)


def test_program_trainer_steps_as_the_jax_trainer():
    """The node programs' trainer: masked MSE, SGD 0.5, four steps on the
    same batches (the last one padded with mask 0 rows)."""
    rng = np.random.RandomState(2)
    batches = []
    for i in range(4):
        x = rng.rand(16, 2).astype(np.float32)
        y = (x @ np.asarray([1.5, -2.0], np.float32) + 0.25).reshape(-1, 1)
        mask = np.ones((16,), np.float32)
        if i == 3:
            mask[11:] = 0.0
        batches.append({"x": x, "y": y, "mask": mask})
    jtr = JaxTrainer(jax_factory.get_model("linear_regression"),
                     optimizer=optax.sgd(0.5),
                     mesh=JaxMeshConfig(data=-1).build(),
                     loss_fn=lambda out, b: jax_mse(out, b["y"],
                                                    b.get("mask")))
    jstate = jtr.init(jax.random.PRNGKey(0), {"x": batches[0]["x"]})
    threads = torch.get_num_threads()
    try:
        tr = programs._linreg_trainer("cpu")  # sets one thread
    finally:
        torch.set_num_threads(threads)
    state = tr.init(params=convert.dense_params_from_flax(
        jax.device_get(jstate.params), tr.model))
    for b in batches:
        jstate, jm = jtr.train_step(jstate, b)
        state, m = tr.train_step(state, b)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=F32_RTOL)
    want = convert.dense_params_from_flax(jax.device_get(jstate.params),
                                          tr.model)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=F32_RTOL, atol=1e-7)
