"""The port's ResNet family (``models/resnet.py``) held against the flax
models (``tests/test_torch_resnet_trainer.py`` trains it against the JAX
``Trainer``).

Weights are flax-shaped numpy draws (he-scaled kernels, non-identity
norms and running statistics, so that every residual branch counts),
carried across by ``convert.resnet_params_from_flax``; images and labels
are numpy-seeded. The models run at ``width=8`` on 32x32 images, batch 4,
in f32 unless a case says bf16; JAX runs on a one-device mesh.

Tolerances, as a share of the largest value compared, each with its
reading (largest over two input seeds):
* logits: resnet18 1e-4 (read 1.4e-5 in train mode, 1.2e-6 in eval);
  resnet50 and resnet50_v2 5e-3 (read 1.7e-3 and 1.5e-3 in train mode,
  1.1e-4 and 7.6e-5 in eval). Both frameworks take BatchNorm's variance as
  E[x^2] - E[x]^2, which turns f32 rounding in another sum order into
  errors of a few 1e-6 at the first block; through 16 random blocks they
  grow about 1.4x a block, most at the last stage, which is 1x1 at 32 px
  (four values per channel);
* running statistics: resnet18 2e-5 (read 1.7e-6), the deeper two 3e-3
  (read 6.7e-4 and 1.2e-3);
* bf16 (resnet18): relative RMS 0.25 against flax in bf16 (read 0.12);
  the bf16 rounding moves either framework's logits that far from its own
  f32 logits (flax 0.067, the port 0.10), so the bar is set by that;
* padding: SAME convs equal flax's to 1e-6 (read 4.8e-7), the max pool
  exactly;
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import factory
from tensorflowonspark_tpu_torch.models import resnet

KW = dict(num_classes=10, width=8)
B, HW = 4, 32
LOGIT_RTOL = {"resnet18": 1e-4, "resnet50": 5e-3, "resnet50_v2": 5e-3}
STAT_RTOL = {"resnet18": 2e-5, "resnet50": 3e-3, "resnet50_v2": 3e-3}
BF16_RMS = 0.25
PAD_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _images(seed, b=B, hw=HW):
    return np.random.RandomState(seed).rand(b, hw, hw, 3).astype(np.float32)


def _random_variables(shapes, seed):
    """Flax-shaped variables drawn with numpy: he-scaled kernels and
    non-identity norms and running statistics, so that every residual
    branch is load-bearing (the flax init zeroes the last norm's scale,
    which would leave each v1 branch's output at zero)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
                    ).astype(np.float32)
        if name in ("scale", "var"):
            return (1.0 + 0.2 * np.abs(rng.randn(*shape))).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _flax(name, dtype=jnp.float32):
    """Random flax-shaped variables and jitted ``train`` (logits, updated
    ``batch_stats``) and ``eval`` applies of the flax model."""
    jm = jax_factory.get_model(name, dtype=dtype, **KW)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, HW, HW, 3)),
                                            train=False))
    variables = _random_variables(nn.meta.unbox(shapes), seed=len(name))
    train = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                          mutable=["batch_stats"]))
    evaluate = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    return variables, train, evaluate


def _port(name, variables, dtype=torch.float32):
    model = factory.get_model(name, dtype=dtype, device="cpu", seed=1, **KW)
    model.load_state_dict(convert.resnet_params_from_flax(variables, model))
    return model


def _close(got, want, rtol):
    """``got`` within ``rtol`` of the largest ``|want|``."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _rms(got, want):
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def _check_stats(model, variables, rtol):
    """The model's running statistics against flax's ``batch_stats``."""
    want = convert.resnet_params_from_flax(variables, model)
    stats = [n for n in want if n.endswith((".mean", ".var"))]
    scale = max(float(want[n].abs().max()) for n in stats)
    have = model.state_dict()
    for name in stats:
        torch.testing.assert_close(have[name], want[name], rtol=0,
                                   atol=rtol * scale)


# -- the models against flax ---------------------------------------------------


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "resnet50_v2"])
def test_resnet_matches_flax(name):
    """Train-mode logits and the updated running statistics, then eval-mode
    logits with those statistics."""
    variables, train, evaluate = _flax(name)
    model = _port(name, variables)
    x = _images(1)
    want, upd = train(variables, x)
    model.train()
    got = model(x)
    assert got.dtype == torch.float32 and got.shape == (B, 10)
    _close(got.detach().numpy(), want, LOGIT_RTOL[name])
    new = {"params": variables["params"],
           "batch_stats": jax.device_get(upd["batch_stats"])}
    _check_stats(model, new, STAT_RTOL[name])
    model.eval()
    with torch.no_grad():
        got_eval = model(x)
    _close(got_eval.numpy(), evaluate(new, x), LOGIT_RTOL[name])


def test_resnet_bf16_matches_flax():
    variables, train, _ = _flax("resnet18", jnp.bfloat16)
    model = _port("resnet18", variables, torch.bfloat16)
    x = _images(2)
    want, _ = train(variables, x)
    model.train()
    got = model(x).detach()
    assert got.dtype == torch.float32
    assert _rms(got.numpy(), np.asarray(want, np.float32)) <= BF16_RMS
    # The stem runs in bf16: its kernel is cast, its output is bf16.
    assert model.stem(model._input(x)).dtype == torch.bfloat16


def _bordered(seed, hw=16, c=3):
    """An image whose one-pixel border is far from its interior: a window
    shifted by one pixel reads other values."""
    x = np.random.RandomState(seed).rand(2, hw, hw, c).astype(np.float32)
    x[:, 0, :] += 5.0
    x[:, -1, :] -= 5.0
    x[:, :, 0] += 3.0
    x[:, :, -1] -= 3.0
    return x


@pytest.mark.parametrize("k", [7, 3, 1])
def test_stride2_conv_pads_like_flax(k):
    """SAME for a stride-2 conv on an even input pads one pixel more at the
    bottom and right ((2, 3) for 7x7, (0, 1) for 3x3); torch's symmetric
    padding would shift every window."""
    x = _bordered(k)
    conv = nn.Conv(4, (k, k), strides=(2, 2), use_bias=False,
                   dtype=jnp.float32)
    v = jax.device_get(conv.init(jax.random.PRNGKey(k), x))
    want = np.asarray(conv.apply(v, x))
    port = resnet.Conv(3, 4, k, 2, torch.float32)
    with torch.no_grad():
        port.kernel.copy_(torch.from_numpy(
            np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = port(xt).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=PAD_TOL)
        if k > 1:
            sym = F.conv2d(xt, port.kernel, stride=2,
                           padding=k // 2).permute(0, 2, 3, 1).numpy()
            assert sym.shape == want.shape
            assert np.abs(sym - want).max() > 1.0


def test_max_pool_pads_like_flax():
    """A ramp (10 per row, 1 per column): each window's max is its
    bottom-right pixel, so a window shifted by one pixel reads 10 or 1
    off."""
    ramp = 10.0 * np.arange(16)[:, None] + np.arange(16)[None, :] - 500.0
    x = np.broadcast_to(ramp[None, :, :, None], (2, 16, 16, 3)).astype(
        np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                  padding="SAME"))
    xt = torch.from_numpy(x.copy()).permute(0, 3, 1, 2)
    got = resnet._ResNetBase._max_pool(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    sym = F.max_pool2d(xt, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
    assert np.abs(sym - want).max() >= 10.0


def test_resnet_with_bordered_input_matches_flax():
    variables, _, evaluate = _flax("resnet18")
    model = _port("resnet18", variables)
    x = np.concatenate([_bordered(3, hw=32)] * 2)
    with torch.no_grad():
        got = model(x).numpy()
    _close(got, evaluate(variables, x), LOGIT_RTOL["resnet18"])


def _flax_count(name, hw, **kw):
    jm = jax_factory.get_model(name, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, hw, hw, 3)),
                                            train=False))
    return sum(int(np.prod(leaf.shape)) for leaf in
               jax.tree_util.tree_leaves(nn.meta.unbox(shapes["params"])))


@pytest.mark.parametrize("name", ["resnet50", "resnet50_v2"])
def test_parameter_count_equals_flax_at_224(name):
    model = factory.get_model(name, device="cpu")
    count = sum(p.numel() for p in model.parameters())
    assert count == _flax_count(name, 224)
    assert model.dtype == torch.bfloat16 and not model.training


@pytest.mark.parametrize("name", [
    "resnet18", "resnet34", "resnet101", "resnet152", "resnet101_v2",
    "resnet152_v2"])
def test_every_registered_resnet_has_flax_shapes(name):
    """Each of the eight registry names builds the flax model's parameter
    tree: the conversion's name and shape checks pass on a flax-shaped tree
    of zeros."""
    kw = dict(num_classes=3, width=4)
    model = factory.get_model(name, device="cpu", dtype=torch.float32, **kw)
    jm = jax_factory.get_model(name, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 3)),
                                            train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   nn.meta.unbox(shapes))
    state = convert.resnet_params_from_flax(zeros, model)
    assert set(state) == set(model.state_dict())


def test_resnet_params_from_flax_rejects_another_geometry():
    variables = _flax("resnet18")[0]
    wide = factory.get_model("resnet18", device="cpu", num_classes=10,
                             width=16)
    with pytest.raises(ValueError, match="shape"):
        convert.resnet_params_from_flax(variables, wide)
    deep = factory.get_model("resnet34", device="cpu", **KW)
    with pytest.raises(ValueError, match="missing"):
        convert.resnet_params_from_flax(variables, deep)


def test_zero_init_and_shortcuts_follow_flax():
    model = factory.get_model("resnet50", device="cpu", **KW)
    b0, b1 = model.BottleneckBlock_0, model.BottleneckBlock_1
    assert float(b0.BatchNorm_2.scale.abs().sum()) == 0.0
    assert float(b0.BatchNorm_0.scale.sum()) == 8
    assert hasattr(b0, "shortcut") and hasattr(b0, "shortcut_norm")
    assert not hasattr(b1, "shortcut")
    names = list(dict(model.named_buffers()))
    assert "stem_norm.mean" in names and "BottleneckBlock_0.BatchNorm_2.var" \
        in names
