"""The port's ``Trainer`` training zoo models against the JAX ``Trainer``:
wide & deep (a tuple input ``(categorical, numeric)``, Adam, with and
without ``grad_accum=2``) and Inception-v1 (BatchNorm, dropout 0, SGD with
momentum); and dropout masks fixed by ``(seed, step)``.

Both trainers start from the JAX trainer's init, carried across by
``convert.zoo_params_from_flax``, in f32, and take the same numpy-seeded
batches. The JAX wide & deep is wrapped in the adapter the JAX example uses
(the JAX ``Trainer`` hands the model one input; the port's model takes the
tuple itself). JAX runs on a one-device mesh; each JAX run is made once per
module, when a test first needs it.

Inception-v1 trains in f64 (both models compute in f64, under
``jax.enable_x64`` on the JAX side; parameters stay f32, flax's
``param_dtype``). A deep BatchNorm net without residual connections has a
chaotic gradient at init: in f32, multiplying the input by ``1 + 1e-6``
moves JAX's own step-1 gradient by 4.9% of a tensor's largest entry, and
the port's f32 gradient reads 34% from JAX's (the forward loss agrees to
1.5e-6). In f64 the rounding those steps amplify is 1e-16, and the three
steps agree to the tolerance below (read: losses 4e-7 relative, parameters
and statistics 2.5e-6). It runs at 64 px, batch 8, where its last stage is
2x2: at 32 px and batch 4 BatchNorm normalises four values a channel there,
and the f32 parameters' last-bit rounding, amplified, moves step 3's loss
by 6e-4 even in f64.

Tolerances: losses 1e-5 relative; every parameter and running statistic
after three steps 1e-5 of its tensor's largest value.
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
from tensorflowonspark_tpu_torch.train import Trainer, checkpoint, trainer

pytestmark = pytest.mark.watchdog_timeout(120)

LOSS_RTOL = 1e-5
RTOL = 1e-5
STEPS = 3
WD_KW = dict(vocab_sizes=(7, 11, 5, 13), embed_dim=8, deep_features=(16, 8),
             wide_hash_buckets=512, num_classes=2)
WD_NUMERIC = 3
WD_BATCH = 16
INC_BATCH, INC_HW = 8, 64
_JAX = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Packed(nn.Module):
    """The JAX wide & deep example's adapter: one input, a tuple."""

    inner: nn.Module

    @nn.compact
    def __call__(self, packed, train=True):
        return self.inner(packed[0], packed[1], train=train)


def _wd_batch(seed):
    rng = np.random.RandomState(seed)
    cat = np.stack([rng.randint(0, v + 3, size=WD_BATCH)
                    for v in WD_KW["vocab_sizes"]], axis=1).astype(np.int32)
    cat[:3] = rng.randint(-2 ** 31, 2 ** 31 - 1, size=(3, cat.shape[1]))
    num = rng.rand(WD_BATCH, WD_NUMERIC).astype(np.float32)
    y = rng.randint(0, 2, size=WD_BATCH).astype(np.int32)
    return {"x": (cat, num), "y": y}


def _inc_batch(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(INC_BATCH, INC_HW, INC_HW, 3).astype(np.float32),
            "y": (np.arange(INC_BATCH, dtype=np.int32) * 3 + seed) % 10}


def _variables(state, inner=False):
    params = jax.device_get(nn.meta.unbox(state.params))
    out = {"params": params["inner"] if inner else params}
    stats = state.model_state.get("batch_stats")
    if stats is not None:
        out["batch_stats"] = jax.device_get(stats)
    return out


CASES = {
    "wide_deep": dict(
        jax_model=lambda: _Packed(jax_factory.get_model(
            "wide_deep", dtype=np.float32, **WD_KW)),
        port_kw=dict(WD_KW, num_numeric=WD_NUMERIC, dtype=torch.float32),
        jax_opt=lambda: optax.adam(1e-2), port_opt=lambda: trainer.adam(1e-2),
        batch=_wd_batch, inner=True, x64=False),
    "inception_v1": dict(
        jax_model=lambda: jax_factory.get_model(
            "inception_v1", num_classes=10, dropout_rate=0.0,
            dtype=np.float64),
        port_kw=dict(num_classes=10, dropout_rate=0.0, image_size=INC_HW,
                     dtype=torch.float64),
        jax_opt=lambda: optax.sgd(0.01, momentum=0.9),
        port_opt=lambda: trainer.sgd(0.01, momentum=0.9),
        batch=_inc_batch, inner=False, x64=True),
}


def _jax(name, grad_accum):
    """The JAX trainer's init and ``STEPS`` steps on batches 0-2 (losses,
    final variables), made once per (model, grad_accum)."""
    key = (name, grad_accum)
    if key not in _JAX:
        case = CASES[name]
        with jax.enable_x64(case["x64"]):
            _JAX[key] = _jax_steps(case, grad_accum)
    return _JAX[key]


def _jax_steps(case, grad_accum):
    tr = JaxTrainer(case["jax_model"](), optimizer=case["jax_opt"](),
                    donate=False, grad_accum=grad_accum,
                    mesh=MeshConfig(data=1).build(jax.devices()[:1]))
    state = tr.init(jax.random.PRNGKey(0), case["batch"](0))
    initial = _variables(state, case["inner"])
    losses = []
    for i in range(STEPS):
        state, m = tr.train_step(state, case["batch"](i))
        losses.append(float(m["loss"]))
    return initial, losses, _variables(state, case["inner"])


def _port_trainer(name, initial, grad_accum=1, **kw):
    case = CASES[name]
    model = factory.get_model(name, device="cpu", **case["port_kw"])
    tr = Trainer(model, optimizer=case["port_opt"](), device="cpu",
                 grad_accum=grad_accum, **kw)
    state = tr.init(params=convert.zoo_params_from_flax(initial, model))
    return tr, state


@pytest.mark.parametrize("name,grad_accum", [
    ("wide_deep", 1), ("wide_deep", 2), ("inception_v1", 1)])
def test_trainer_steps_match_jax(name, grad_accum):
    initial, losses, final = _jax(name, grad_accum)
    tr, state = _port_trainer(name, initial, grad_accum)
    for i in range(STEPS):
        state, m = tr.train_step(state, CASES[name]["batch"](i))
        assert abs(float(m["loss"]) - losses[i]) <= LOSS_RTOL * abs(
            losses[i]), (i, m, losses)
    want = convert.zoo_params_from_flax(final, tr.model)
    for n, val in tr.model.state_dict().items():
        torch.testing.assert_close(
            val, want[n].to(val.dtype), rtol=0,
            atol=RTOL * max(float(want[n].abs().max()), 1e-6),
            msg=lambda m, n=n: "{}: {}".format(n, m))


def test_tuple_inputs_predict_and_eval():
    """``predict`` and ``eval_step`` take the tuple as ``train_step`` does;
    a tuple whose leaves do not divide ``grad_accum`` is refused."""
    initial = _jax("wide_deep", 1)[0]
    tr, state = _port_trainer("wide_deep", initial)
    batch = _wd_batch(7)
    out = tr.eval_step(state, batch)["outputs"]
    with torch.no_grad():
        want = tr.model(batch["x"])
    assert torch.equal(out, want)
    assert torch.equal(tr.predict(state, batch["x"]), want)
    tr3, state3 = _port_trainer("wide_deep", initial, grad_accum=3)
    with pytest.raises(ValueError, match="grad_accum=3"):
        tr3.train_step(state3, batch)


def _alexnet_trainer(seed):
    model = factory.get_model("alexnet", num_classes=10, image_size=67,
                              dtype=torch.float32, device="cpu", seed=11)
    tr = Trainer(model, optimizer=trainer.sgd(0.01), device="cpu")
    return tr, tr.init(seed=seed)


def _alex_batch(step):
    rng = np.random.RandomState(100 + step)
    return {"x": rng.rand(4, 67, 67, 3).astype(np.float32),
            "y": rng.randint(0, 10, size=4).astype(np.int32)}


def test_dropout_masks_are_fixed_by_seed_and_step(tmp_path):
    """AlexNet (dropout 0.5 after both hidden layers): three steps in one
    run equal two steps, a checkpoint, and the third step in a fresh trainer
    restored from it, bitwise; another dropout seed on the same weights
    draws other masks at step 0."""
    tr, state = _alexnet_trainer(5)
    losses = []
    for i in range(STEPS):
        state, m = tr.train_step(state, _alex_batch(i))
        losses.append(float(m["loss"]))
    whole = {n: t.clone() for n, t in tr.model.state_dict().items()}

    tr2, state2 = _alexnet_trainer(5)
    for i in range(2):
        state2, m = tr2.train_step(state2, _alex_batch(i))
        assert float(m["loss"]) == losses[i]
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state2, force=True)
    mgr.close()

    tr3, state3 = _alexnet_trainer(5)
    state3 = checkpoint.CheckpointManager(str(tmp_path / "ckpt")).restore(
        state3)
    assert state3.step == 2
    state3, m = tr3.train_step(state3, _alex_batch(2))
    assert float(m["loss"]) == losses[2]
    for n, t in tr3.model.state_dict().items():
        assert torch.equal(t, whole[n]), n

    other, ostate = _alexnet_trainer(5)
    other.dropout_seed = 6
    _, m = other.train_step(ostate, _alex_batch(0))
    assert float(m["loss"]) != losses[0]
    assert not other.model.training


def test_remat_recomputes_the_same_dropout_masks():
    """The whole-forward ``remat`` runs the forward again in the backward:
    its dropout masks must be the first forward's, so the step equals a
    plain one bitwise."""
    steps = {}
    for remat in (False, True):
        model = factory.get_model("alexnet", num_classes=10, image_size=67,
                                  dtype=torch.float32, device="cpu", seed=11)
        tr = Trainer(model, optimizer=trainer.sgd(0.01), device="cpu",
                     remat=remat)
        state, m = tr.train_step(tr.init(seed=5), _alex_batch(0))
        steps[remat] = (tr, float(m["loss"]))
    (plain, loss), (rtr, rloss) = steps[False], steps[True]
    assert rtr._whole_forward_remat and rloss == loss
    for (name, p), q in zip(plain.model.named_parameters(),
                            rtr.model.parameters()):
        assert torch.equal(p.grad, q.grad), name
