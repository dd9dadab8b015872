"""The port's ``Trainer`` held against the JAX package's ``Trainer``.

Both train the fp32 toy LM of ``tests/test_torch_model.py`` (``LM_KW``)
with ``attention_impl="pallas"`` — Pallas in interpret mode on the JAX side,
the flash kernels' plain versions on the port's — from the same weights
(the JAX trainer's init, converted by ``convert.params_from_flax``) on the
same numpy batches: packed rows with a padded tail, the loss mask defaulted
from ``segment_ids`` on both sides. The JAX trainer runs once per module
and model under ``optax.adam(1e-3)`` with a pass-through stage before it
that keeps each step's gradients, so one compiled step gives the losses,
step 1's gradients and the weights; a test that only starts from the
initial weights takes them from the JAX trainer's ``init`` alone.

Tolerances, each with its reading: losses agree to 1e-5 (measured at most
9.5e-7); step-1 gradients to 1e-6 per element (measured 1.8e-7); the
logits of ``eval_step``/``predict`` to 2e-6 (measured 3.6e-7); parameters
after three Adam steps to 1e-5 (measured 5.3e-6: Adam's normalised update
magnifies the gradients' last-bit differences where a gradient is near
zero). ``grad_accum=2`` against one full batch: 5e-7 (measured: loss
equal, gradients 1.2e-7); ``remat`` recomputes the same values (measured
bitwise).

The same holds for GQA (4/2) on the flash and dense routes and for head
width 32 (measured: losses 0, 0 and 1.7e-6; step-1 gradients 1.7e-7,
1.9e-7 and 4.8e-7; parameters 1.8e-6, 9.2e-7 and, away from the next
case, at most 4.8e-6). Where step 1's gradient is within Adam's eps
(1e-8) of zero, Adam's first update lr g / (|g| + eps) reads a gradient
difference of a few 1e-9 as one of order lr: at head width 32 one
V-projection element (gradient 3.5e-9 against JAX's 7.4e-9; 0.016% of
that kernel's gradients lie below 1e-7) ends 1.6e-4 apart. Elements whose
step-1 gradient lies below 1e-7 are held to 3 lr, the most three updates
can move a parameter apart.
"""

import inspect

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.parallel import MeshConfig
from tensorflowonspark_tpu.train import Trainer as JaxTrainer
from tensorflowonspark_tpu.train import losses as jax_losses
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.parallel import MeshConfig as PortMeshConfig
from tensorflowonspark_tpu_torch.models import factory
from tensorflowonspark_tpu_torch.train import (
    Trainer,
    TrainState,
    losses,
    trainer,
)

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
# Attention layouts on top of LM_KW: the MHA model every test below uses,
# GQA (4 query heads over 2 K/V heads) on the flash and dense routes, and
# head width 32 (2 heads of an embed 64), which the port's kernels build.
VARIANTS = {
    "mha": {},
    "gqa_pallas": dict(num_kv_heads=2),
    "gqa_dense": dict(num_kv_heads=2, attention_impl="dense"),
    "d32_pallas": dict(embed_dim=64, num_heads=2),
}
B, S = 4, 32
TOL = 1e-5
GRAD_TOL = 1e-6
LOGIT_TOL = 2e-6
ADAM_LR = 1e-3
ADAM_NEAR_EPS = 1e-7   # |step-1 gradient| within ~10 x Adam's eps of zero
_JAX = {}        # variant -> _jax_run(variant)
_JAX_INIT = {}   # variant -> _jax_init(variant), where no run was made
_JAX_EVAL = []   # _jax_eval()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed=0, packed=True):
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, LM_KW["vocab_size"], size=(B, S + 1))
    batch = {"x": toks[:, :-1].astype(np.int32),
             "y": toks[:, 1:].astype(np.int32)}
    if packed:
        seg = np.ones((B, S), np.int32)
        seg[:, S // 2:] = 2
        seg[:, -S // 8:] = 0
        seg[1, 10:] = 0
        batch["segment_ids"] = seg
    return batch


def _jax_trainer(optimizer, **kw):
    jm = jax_factory.get_model("transformer", dtype=jnp.float32,
                               **{**LM_KW, "attention_impl": "pallas", **kw})
    # donate=False: the initial state is reused after the first step.
    return JaxTrainer(jm, optimizer=optimizer, donate=False,
                      mesh=MeshConfig(data=1).build(jax.devices()[:1]))


def _capture_grads():
    """An optax stage that passes the gradients on unchanged and keeps them
    as its state: chained before ``optax.adam`` it leaves Adam's updates as
    they were and lets the test read the step's gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _numpy(tree):
    return _flat_jax(jax.device_get(nn.meta.unbox(tree)))


def _jax_run(variant="mha"):
    """Three steps of the JAX trainer on the ``variant`` model under
    ``optax.adam(1e-3)`` on the packed batch, which carries no mask (the
    trainer defaults it from the segments): the initial params, each step's
    loss, step 1's gradients and the final params. Computed once per
    variant."""
    if variant not in _JAX:
        run = {}
        tr = _jax_trainer(optax.chain(_capture_grads(), optax.adam(1e-3)),
                          **VARIANTS[variant])
        state = tr.init(jax.random.PRNGKey(0), _batch())
        run["params0"] = jax.device_get(nn.meta.unbox(state.params))
        run["losses"] = []
        for step in range(3):
            state, m = tr.train_step(state, _batch())
            run["losses"].append(float(m["loss"]))
            if step == 0:
                run["grads1"] = _numpy(state.opt_state[0])
        run["params3"] = _numpy(state.params)
        _JAX[variant] = run
    return _JAX[variant]


def _jax_init(variant="mha"):
    """The JAX trainer's initial params (unboxed numpy), once per variant:
    those of ``_jax_run`` where it has run, else from ``init`` alone, so a
    test that only starts from them does not pay for the JAX steps."""
    if variant in _JAX:
        return _JAX[variant]["params0"]
    if variant not in _JAX_INIT:
        tr = _jax_trainer(optax.adam(1e-3), **VARIANTS[variant])
        state = tr.init(jax.random.PRNGKey(0), _batch())
        _JAX_INIT[variant] = jax.device_get(nn.meta.unbox(state.params))
    return _JAX_INIT[variant]


def _jax_eval():
    """One forward of the JAX MHA model from the initial params: the packed
    batch's loss and logits, and the logits of its tokens without segments.
    Computed once."""
    if not _JAX_EVAL:
        model = _jax_trainer(optax.adam(1e-3)).model
        b = _batch()
        mask = jnp.asarray((b["segment_ids"] != 0).astype(np.float32))

        @jax.jit
        def forward(p):
            logits = model.apply({"params": p}, jnp.asarray(b["x"]),
                                 segment_ids=jnp.asarray(b["segment_ids"]))
            loss = jax_losses.softmax_cross_entropy(
                logits, jnp.asarray(b["y"]), mask)
            return loss, logits, model.apply({"params": p},
                                             jnp.asarray(b["x"]))

        _JAX_EVAL.extend(np.asarray(x) for x in forward(_jax_init()))
    return _JAX_EVAL


def _port_model(**kw):
    return factory.get_model("transformer", device="cpu",
                             dtype=torch.float32,
                             **{**LM_KW, "attention_impl": "pallas", **kw})


def _port_trainer(optimizer=None, variant="mha", **kw):
    model = _port_model(**VARIANTS[variant])
    tr = Trainer(model, optimizer=optimizer, device="cpu", **kw)
    state = tr.init(params=convert.params_from_flax(_jax_init(variant),
                                                    model.cfg))
    return tr, state


def _flat_jax(tree):
    return {k.replace("/", "."): np.asarray(v) for k, v in
            convert._flat(tree).items()}


def _port_trajectory(optimizer, steps=3):
    tr, state = _port_trainer(optimizer)
    losses = []
    for _ in range(steps):
        state, m = tr.train_step(state, _batch())
        losses.append(float(m["loss"]))
    return losses, state


def test_step1_loss_and_gradients_match_jax():
    run = _jax_run()
    want_loss, want_grads = run["losses"][0], run["grads1"]
    tr, state = _port_trainer()
    state, m = tr.train_step(state, _batch())
    assert state.step == 1
    assert abs(float(m["loss"]) - float(want_loss)) <= TOL
    assert float(m["aux_loss"]) == 0.0
    assert set(want_grads) == set(state.params)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name], rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


def test_three_adam_steps_match_jax_trainer():
    """The loss trajectory and the final weights under ``optax.adam(1e-3)``
    and the port's default, ``torch.optim.Adam`` at 1e-3; the batch carries
    no mask, so both trainers default it from ``segment_ids``."""
    run = _jax_run()
    want_losses, want_params = run["losses"], run["params3"]
    losses, state = _port_trajectory(None)
    assert isinstance(state.optimizer, torch.optim.Adam)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=TOL)
    assert losses[2] < losses[0]
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                                   rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("variant", ["gqa_pallas", "gqa_dense",
                                     "d32_pallas"])
def test_three_adam_steps_match_jax_across_attention_layouts(variant):
    """GQA 4/2 on the flash and the dense route, and head width 32 on the
    flash route: step 1's gradients, the three steps' losses and the final
    weights against the JAX ``Trainer`` on the same model, to the MHA
    trajectory's tolerances."""
    run = _jax_run(variant)
    tr, state = _port_trainer(variant=variant)
    assert (state.params.keys() == run["grads1"].keys()
            == run["params3"].keys())
    losses = []
    for step in range(3):
        state, m = tr.train_step(state, _batch())
        losses.append(float(m["loss"]))
        if step == 0:
            for name, p in state.params.items():
                np.testing.assert_allclose(p.grad.numpy(),
                                           run["grads1"][name], rtol=0,
                                           atol=GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(losses, run["losses"], rtol=0, atol=TOL)
    for name, p in state.params.items():
        # Where step 1's gradient lies within Adam's eps of zero, the first
        # update lr g / (|g| + eps) turns a gradient difference far below
        # GRAD_TOL into one of up to lr: those elements are held to 3 lr.
        near_eps = np.abs(run["grads1"][name]) < ADAM_NEAR_EPS
        err = np.abs(p.detach().numpy() - run["params3"][name])
        assert err[~near_eps].max(initial=0.0) <= TOL, name
        assert err[near_eps].max(initial=0.0) <= 3 * ADAM_LR, name


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_factories_take_optax_defaults(name):
    """``trainer.adam``/``adamw`` against ``optax.adam``/``adamw`` at their
    defaults, on one weight vector over five steps of seeded gradients.
    The trap: ``optax.adamw`` decays by 1e-4 by default,
    ``torch.optim.AdamW`` by 1e-2; the port's ``adamw`` takes optax's.
    The two apply the decoupled decay in another order (torch scales the
    weight first), which rounds differently: limit 2e-6 relative, measured
    5.2e-7."""
    lr = 3e-4
    if name == "adamw":
        optax_default = inspect.signature(optax.adamw).parameters[
            "weight_decay"].default
        assert optax_default == 1e-4
        assert inspect.signature(torch.optim.AdamW).parameters[
            "weight_decay"].default == 1e-2
    rng = np.random.RandomState(8)
    w0 = rng.randn(64).astype(np.float32)
    grads = rng.randn(5, 64).astype(np.float32)
    tx = getattr(optax, name)(lr)
    w, opt_state = jnp.asarray(w0), None
    opt_state = tx.init(w)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, w)
        w = optax.apply_updates(w, updates)
    p = torch.nn.Parameter(torch.tensor(w0))
    opt = getattr(trainer, name)(lr)([p])
    if name == "adamw":
        assert isinstance(opt, torch.optim.AdamW)
        assert opt.param_groups[0]["weight_decay"] == optax_default
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=2e-6,
                               atol=0)


def _grads(state):
    return {n: p.grad.clone() for n, p in state.params.items()}


def test_grad_accum_matches_one_batch_on_masked_padded_rows():
    """Two microbatches with uneven mask sums weight their gradients by
    those sums, so the update equals the full batch's masked mean."""
    b = _batch(seed=3)
    mask = (b["segment_ids"] != 0).astype(np.float32)
    mask[2:] = 0.0
    mask[2, :3] = 1.0
    b["mask"] = mask
    tr1, s1 = _port_trainer(grad_accum=1)
    tr2, s2 = _port_trainer(grad_accum=2)
    s1, m1 = tr1.train_step(s1, b)
    s2, m2 = tr2.train_step(s2, b)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 5e-7
    g1, g2 = _grads(s1), _grads(s2)
    for name in g1:
        torch.testing.assert_close(g2[name], g1[name], rtol=0, atol=5e-7)
    with pytest.raises(ValueError, match="grad_accum"):
        tr2.train_step(s2, {k: v[:3] for k, v in b.items()})


@pytest.mark.parametrize("flags", [dict(remat=True), dict(mlp_remat=True)],
                         ids=["remat", "mlp_remat"])
def test_remat_recomputes_the_same_step(flags):
    b = _batch(seed=4)
    base_tr, base = _port_trainer()
    base, m0 = base_tr.train_step(base, b)
    model = _port_model(mlp_remat=flags.get("mlp_remat", False))
    tr = Trainer(model, device="cpu", remat=flags.get("remat", False))
    assert model.cfg.remat == flags.get("remat", False)
    state = tr.init(params=convert.params_from_flax(_jax_init(), model.cfg))
    state, m1 = tr.train_step(state, b)
    assert float(m1["loss"]) == float(m0["loss"])
    g0, g1 = _grads(base), _grads(state)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=0)


def test_packed_rows_default_their_mask():
    b = _batch(seed=5)
    tr, state = _port_trainer()
    out = tr.eval_step(state, b)
    b["mask"] = (b["segment_ids"] != 0).astype(np.float32)
    assert float(tr.eval_step(state, b)["loss"]) == float(out["loss"])
    del b["segment_ids"]
    assert float(tr.eval_step(state, b)["loss"]) != float(out["loss"])


def test_eval_step_and_predict_match_jax():
    """``eval_step`` (loss with the defaulted mask, and logits) and
    ``predict`` (logits of the inputs alone) from the initial weights,
    against the JAX model's forward on the same batch."""
    want_loss, want_logits, want_plain = _jax_eval()
    tr, state = _port_trainer()
    out = tr.eval_step(state, _batch())
    assert abs(float(out["loss"]) - float(want_loss)) <= TOL
    np.testing.assert_allclose(out["outputs"].numpy(), want_logits,
                               atol=LOGIT_TOL)
    pred = tr.predict(state, _batch()["x"])
    np.testing.assert_allclose(pred.numpy(), want_plain, atol=LOGIT_TOL)
    assert not tr.model.training and not pred.requires_grad


def test_keys_input_fn_model_kwargs_and_custom_loss():
    """``input_key``/``label_key``, an ``input_fn`` applied before the
    model, ``model_kwargs`` passed to it (explicit positions, equal to the
    default ones) and a custom ``loss_fn`` give the default trainer's
    step."""
    b = _batch(seed=9, packed=False)
    tr0, s0 = _port_trainer()
    s0, m0 = tr0.train_step(s0, b)
    seen = []

    def input_fn(x):
        seen.append(x.dtype)
        return x.long()

    model = _port_model()
    tr = Trainer(model, device="cpu", input_key="tokens", label_key="labels",
                 input_fn=input_fn,
                 model_kwargs={"positions": torch.arange(S).expand(B, S)},
                 loss_fn=lambda out, batch: losses.softmax_cross_entropy(
                     out, batch["labels"]))
    state = tr.init(params=convert.params_from_flax(_jax_init(), model.cfg))
    state, m = tr.train_step(state, {"tokens": b["x"], "labels": b["y"]})
    assert seen == [torch.int32]
    assert float(m["loss"]) == float(m0["loss"])
    pred = tr.predict(state, b["x"])
    assert pred.shape == (B, S, LM_KW["vocab_size"]) and len(seen) == 2


def test_losses_match_jax():
    rng = np.random.RandomState(10)
    logits = rng.randn(3, 5, 7).astype(np.float32)
    labels = rng.randint(0, 7, size=(3, 5)).astype(np.int32)
    preds, targets = rng.randn(3, 4, 2), rng.randn(3, 4, 2)
    for mask in (None, np.array([1.0, 0.0, 1.0], np.float32)):
        tok_mask = None if mask is None else np.repeat(mask[:, None], 5, 1)
        jm = lambda m: None if m is None else jnp.asarray(m)  # noqa: E731
        tm = lambda m: None if m is None else torch.tensor(m)  # noqa: E731
        pairs = [
            (jax_losses.softmax_cross_entropy(jnp.asarray(logits),
                                              jnp.asarray(labels),
                                              jm(tok_mask)),
             losses.softmax_cross_entropy(torch.tensor(logits),
                                          torch.tensor(labels),
                                          tm(tok_mask))),
            (jax_losses.mse(jnp.asarray(preds), jnp.asarray(targets),
                            jm(mask)),
             losses.mse(torch.tensor(preds), torch.tensor(targets),
                        tm(mask))),
            (jax_losses.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                 jm(tok_mask)),
             losses.accuracy(torch.tensor(logits), torch.tensor(labels),
                             tm(tok_mask))),
        ]
        for want, got in pairs:
            # f32 reductions in other orders: measured 2.4e-7.
            assert abs(float(got) - float(want)) <= 1e-6
    zero = np.zeros(3, np.float32)
    assert float(losses.mse(torch.tensor(preds), torch.tensor(targets),
                            torch.tensor(zero))) == 0.0


def test_unported_arguments_raise_and_the_card_is_the_default():
    model = _port_model()
    with pytest.raises(TypeError, match="MeshConfig"):
        Trainer(model, mesh=object(), device="cpu")
    # pipe and expert compose with data only so far.
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        Trainer(model, mesh=PortMeshConfig(data=1, pipe=2, tensor=2),
                device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        Trainer(model, mesh=PortMeshConfig(data=1, expert=2, seq=2),
                device="cpu")
    rules = dict(trainer.mesh_lib.DEFAULT_RULES, mlp=None)
    assert Trainer(model, rules=rules, device="cpu").rules is rules
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        Trainer(model, compile_cache="cache", device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        Trainer(model, grad_accum=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model)
    tr = Trainer(model, device="cpu")
    state = tr.init(seed=7)
    assert isinstance(state, TrainState) and state.step == 0
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert state.optimizer.param_groups[0]["lr"] == 1e-3
    with pytest.raises(ValueError, match="seed or params"):
        tr.init(seed=1, params={})
