"""The port's ``Trainer`` training the port's ResNet-18 against the JAX
``Trainer`` training the flax one: ``sgd``, BatchNorm state, ``grad_accum``,
``eval_step`` and the whole-forward ``remat``.

Both start from the JAX trainer's init (carried across by
``convert.resnet_params_from_flax``) at ``width=8`` in f32, and take the
same numpy-seeded batches: 4 images of 64x64. At 32 px the last stage is
1x1 and a ``grad_accum`` microbatch of two images would normalise two
values per channel — outputs of +-1 whatever the input, whose gradient is
float noise. JAX runs on a one-device mesh; each JAX run is made once per
module, and only when a test needs it.

Tolerances, each with its reading: losses 1e-5 (read 2.9e-6 over three
steps; equal with ``grad_accum=2``); every parameter and running statistic
after the steps 1e-4 of its tensor's largest value (read 2.5e-5 after three
steps, 2.1e-5 after the ``grad_accum=2`` step: BatchNorm's gradient is a
difference of nearly equal terms, so its f32 error shows most in the norms'
scales and biases); ``eval_step`` loss 1e-5 (read 2.4e-7) and logits 2e-5
of their largest (read 1.9e-7); ``sgd`` against ``optax.sgd`` 1e-6;
``remat`` against a plain step: bitwise.
"""

import flax.linen as nn
import jax
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.parallel import MeshConfig
from tensorflowonspark_tpu.train import Trainer as JaxTrainer
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import factory
from tensorflowonspark_tpu_torch.train import Trainer, trainer

KW = dict(num_classes=10, width=8)
B, HW = 4, 64
LOSS_TOL = 1e-5
RTOL = 1e-4
EVAL_RTOL = 2e-5
_JAX = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed):
    x = np.random.RandomState(seed).rand(B, HW, HW, 3).astype(np.float32)
    y = (np.arange(B, dtype=np.int32) * 3 + seed) % KW["num_classes"]
    return {"x": x, "y": y}


def _variables(state):
    return {"params": jax.device_get(nn.meta.unbox(state.params)),
            "batch_stats": jax.device_get(state.model_state["batch_stats"])}


def _jax(key):
    """The JAX runs, each once: ``init`` (trainer and initial state),
    ``steps`` (three steps on batches 0-2: losses, final variables),
    ``accum`` (one ``grad_accum=2`` step on batch 0) and ``eval``
    (``eval_step`` on batch 3 from the initial state)."""
    if key in _JAX:
        return _JAX[key]

    def make(grad_accum):
        jm = jax_factory.get_model("resnet18", **dict(KW, dtype=np.float32))
        return JaxTrainer(jm, optimizer=optax.sgd(0.1, momentum=0.9),
                          donate=False, grad_accum=grad_accum,
                          mesh=MeshConfig(data=1).build(jax.devices()[:1]))

    if key == "init":
        tr = make(1)
        state = tr.init(jax.random.PRNGKey(0), _batch(0))
        _JAX[key] = (tr, state, _variables(state))
    elif key == "steps":
        tr, state, _ = _jax("init")
        losses = []
        for i in range(3):
            state, m = tr.train_step(state, _batch(i))
            losses.append(float(m["loss"]))
        _JAX[key] = (losses, _variables(state))
    elif key == "accum":
        _, state, _ = _jax("init")
        state, m = make(2).train_step(state, _batch(0))
        _JAX[key] = (float(m["loss"]), _variables(state))
    elif key == "eval":
        tr, state, _ = _jax("init")
        out = tr.eval_step(state, _batch(3))
        _JAX[key] = (float(out["loss"]), np.asarray(out["outputs"]))
    return _JAX[key]


def _port_trainer(**kw):
    model = factory.get_model("resnet18", dtype=torch.float32, device="cpu",
                              **KW)
    tr = Trainer(model, optimizer=trainer.sgd(0.1, momentum=0.9),
                 device="cpu", **kw)
    state = tr.init(params=convert.resnet_params_from_flax(_jax("init")[2],
                                                           model))
    return tr, state


def _check_variables(model, variables):
    want = convert.resnet_params_from_flax(variables, model)
    for name, val in model.state_dict().items():
        ref = want[name]
        atol = RTOL * max(float(ref.abs().max()), 1e-6)
        torch.testing.assert_close(val, ref, rtol=0, atol=atol,
                                   msg=lambda m, n=name: "{}: {}".format(n, m))


def test_sgd_matches_optax():
    """``trainer.sgd`` against ``optax.sgd`` on one quadratic: plain,
    momentum and nesterov, three steps."""
    target = np.linspace(-1.0, 1.0, 6).astype(np.float32)
    for kw in (dict(), dict(momentum=0.9), dict(momentum=0.9,
                                                nesterov=True)):
        tx = optax.sgd(0.1, **kw)
        p = np.zeros(6, np.float32)
        st = tx.init(p)
        w = torch.zeros(6, requires_grad=True)
        opt = trainer.sgd(0.1, **kw)([w])
        for _ in range(3):
            upd, st = tx.update(2.0 * (p - target) * target, st, p)
            p = np.asarray(optax.apply_updates(p, upd))
            opt.zero_grad()
            (((w - torch.from_numpy(target)) ** 2)
             * torch.from_numpy(target)).sum().backward()
            opt.step()
        np.testing.assert_allclose(w.detach().numpy(), p, rtol=0, atol=1e-6)


def test_model_state_names_the_buffers():
    tr, state = _port_trainer()
    assert set(state.model_state) == {n for n, _ in
                                      tr.model.named_buffers()}
    assert state.model_state["stem_norm.mean"] is tr.model.stem_norm.mean
    lm = factory.get_model("transformer", device="cpu", vocab_size=16,
                           num_layers=1, num_heads=2, embed_dim=8,
                           mlp_dim=16, max_seq_len=8)
    assert Trainer(lm, device="cpu").init().model_state == {}


def test_trainer_sgd_steps_match_jax():
    losses, variables = _jax("steps")
    tr, state = _port_trainer()
    for i in range(3):
        state, m = tr.train_step(state, _batch(i))
        assert abs(float(m["loss"]) - losses[i]) <= LOSS_TOL
    assert state.step == 3 and not tr.model.training
    _check_variables(tr.model, variables)


def test_trainer_grad_accum_matches_jax():
    """The running statistics thread through the two microbatches in
    order, as the JAX scan carries ``model_state``."""
    loss, variables = _jax("accum")
    tr, state = _port_trainer(grad_accum=2)
    state, m = tr.train_step(state, _batch(0))
    assert abs(float(m["loss"]) - loss) <= LOSS_TOL
    _check_variables(tr.model, variables)


def test_trainer_eval_step_matches_jax():
    """``eval_step`` and ``predict`` use the running statistics and leave
    them as they were."""
    loss, logits = _jax("eval")
    tr, state = _port_trainer()
    before = {n: b.clone() for n, b in state.model_state.items()}
    out = tr.eval_step(state, _batch(3))
    assert abs(float(out["loss"]) - loss) <= LOSS_TOL
    np.testing.assert_allclose(out["outputs"].numpy(), logits, rtol=0,
                               atol=EVAL_RTOL * np.abs(logits).max())
    np.testing.assert_array_equal(tr.predict(state, _batch(3)["x"]).numpy(),
                                  out["outputs"].numpy())
    for name, buf in state.model_state.items():
        assert torch.equal(buf, before[name]), name


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_remat_moves_running_stats_once(grad_accum):
    """``remat=True`` on a model without ``cfg.remat`` checkpoints the
    whole forward; the backward's recompute must not move the running
    statistics again."""
    def step(**kw):
        model = factory.get_model("resnet18", dtype=torch.float32,
                                  device="cpu", seed=3, **KW)
        tr = Trainer(model, optimizer=trainer.sgd(0.1, momentum=0.9),
                     device="cpu", grad_accum=grad_accum, **kw)
        state, m = tr.train_step(tr.init(), _batch(0))
        return tr, state, float(m["loss"])

    _, plain, loss = step()
    rtr, remat, rloss = step(remat=True)
    assert rtr._whole_forward_remat and rloss == loss
    for name, buf in plain.model_state.items():
        assert torch.equal(remat.model_state[name], buf), name
    for name, p in plain.params.items():
        assert torch.equal(remat.params[name].grad, p.grad), name
