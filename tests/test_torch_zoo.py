"""The rest of the port's model zoo — ``models/cnn.py`` (LeNet, CifarNet,
AlexNet, OverFeat), ``models/vgg.py`` (VGG16/19), ``models/inception.py``
(v1-v4, Inception-ResNet-v2) and ``models/wide_deep.py`` — held against the
flax models, with the flax layers of ``models/layers.py`` they stand on.

Weights are flax-shaped numpy draws (he-scaled kernels, non-identity norms
and running statistics, a non-zero wide table) carried across by
``convert.zoo_params_from_flax``; inputs are numpy-seeded. Each image model
runs at the smallest input its JAX model accepts (Inception-v3 with its aux
head: 107 px, where the head's pool leaves 1x1; v4 and Inception-ResNet-v2:
75 px; AlexNet 67, OverFeat 71, VGG 32; v1/v2 at 32, where their last
stage is 1x1), 10 classes, batch 4, f32. Dropout is off in the train-mode
forward: rate 0 on the port, flax's ``Dropout`` intercepted to the
identity (VGG's rate is fixed at 0.5 in the JAX module).

Tolerances, as a share of the largest value compared: eval logits 1e-4;
train-mode logits and running statistics 1e-4 (the deepest,
Inception-ResNet-v2 and v4, read the most); wide & deep 1e-5 (no norm).
The wide hash is held exactly, on ids that wrap int32 and on a row whose
mix is INT32_MIN.
"""

import inspect

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.models import inception as jax_inception
from tensorflowonspark_tpu_torch import convert, export
from tensorflowonspark_tpu_torch.models import factory, layers, wide_deep
from test_models import PARAM_SPECS

pytestmark = pytest.mark.watchdog_timeout(120)

B = 4
NUM_CLASSES = 10
# name -> (input side, extra constructor keywords of both packages)
IMAGE_CASES = {
    "lenet": (28, {}),
    "cifarnet": (24, {}),
    "alexnet": (67, {}),
    "overfeat": (71, {}),
    "vgg16": (32, {}),
    "vgg19": (32, {}),
    "inception_v1": (32, {}),
    "inception_v2": (32, {}),
    "inception_v3": (107, {"aux_logits": True}),
    "inception_v4": (75, {}),
    "inception_resnet_v2": (75, {}),
}
ZOO = sorted(IMAGE_CASES) + ["wide_deep"]
WD_KW = dict(vocab_sizes=(7, 11, 5, 13), embed_dim=8, deep_features=(16, 8),
             wide_hash_buckets=4096)
WD_NUMERIC = 3
# Canonical inputs of the parameter counts (tests/test_models.py's table
# and the slim zoo's): LeNet/CifarNet/VGG19 are not in the table.
CANONICAL = {"lenet": 28, "cifarnet": 24, "alexnet": 224, "overfeat": 231,
             "vgg16": 224, "vgg19": 224, "inception_v1": 224,
             "inception_v2": 224, "inception_v3": 299, "inception_v4": 299,
             "inception_resnet_v2": 299}
LOGIT_RTOL = 1e-4
WD_RTOL = 1e-5
UNIT_RTOL = 1e-4
# Whole-model train-mode logits of the Inceptions: BatchNorm on batch
# statistics subtracts a per-channel offset that grows against the
# sample-to-sample spread with depth, so each block multiplies the f32
# rounding of the other summation order (at the test's input the last
# stage is 1x1: four values a channel). Readings: v1 3.9e-4, v2 9.4e-4,
# v3 1.2e-3 (aux 6.8e-4), Inception-ResNet-v2 3.8e-3; v4's 16 blocks read
# 0.23, so v4 is held unit by unit only (0: no whole-model bound).
TRAIN_RTOL = {"inception_v1": 2e-3, "inception_v2": 3e-3,
              "inception_v3": 3e-3, "inception_resnet_v2": 1e-2,
              "inception_v4": 0}
_FLAX = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _draw(shapes, seed):
    """Flax-shaped numpy variables: he-scaled kernels, non-identity norms
    and running statistics, small normal biases and embeddings."""
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


def _wd_inputs(seed, b=B):
    """Ids (b, 4) int32: rows 0-1 random over the whole int32 range (the
    hash wraps), row 2 zeros but a last id of INT32_MIN (its mix is
    INT32_MIN, which ``abs`` leaves negative), the rest in range."""
    rng = np.random.RandomState(seed)
    n = len(WD_KW["vocab_sizes"])
    cat = rng.randint(0, 13, size=(b, n)).astype(np.int32)
    cat[:2] = rng.randint(-2 ** 31, 2 ** 31 - 1, size=(2, n))
    cat[2] = 0
    cat[2, -1] = -2 ** 31
    num = rng.rand(b, WD_NUMERIC).astype(np.float32)
    return cat, num


def _jax_model(name):
    if name == "wide_deep":
        return jax_factory.get_model(name, num_classes=NUM_CLASSES,
                                     dtype=jnp.float32, **WD_KW)
    return jax_factory.get_model(name, num_classes=NUM_CLASSES,
                                 dtype=jnp.float32, **IMAGE_CASES[name][1])


def _inputs(name, seed):
    if name == "wide_deep":
        return _wd_inputs(seed)
    hw = IMAGE_CASES[name][0]
    return (np.random.RandomState(seed).rand(B, hw, hw, 3)
            .astype(np.float32),)


def _mode(jm, train):
    """The ``train=`` keyword where the flax module takes one (LeNet and
    CifarNet have neither norm statistics nor dropout, and no mode)."""
    return {"train": train} if "train" in inspect.signature(
        type(jm).__call__).parameters else {}


def _flax(name):
    """Random variables, then flax's train-mode forward — its outputs, the
    updated ``batch_stats``, and each ``ConvBN`` unit's input and output by
    module path — and its eval-mode outputs with the updated statistics:
    made once per model, when a test first asks."""
    if name in _FLAX:
        return _FLAX[name]
    jm = _jax_model(name)
    x = _inputs(name, 1)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *x,
                                            **_mode(jm, False)))
    variables = _draw(nn.meta.unbox(shapes), seed=len(name))

    def train(v, *a):
        units = {}

        def record(next_fun, args, kwargs, context):
            if isinstance(context.module, nn.Dropout):
                return args[0]
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, jax_inception.ConvBN):
                units[".".join(context.module.path)] = (args[0], out)
            return out

        with nn.intercept_methods(record):
            out, upd = jm.apply(v, *a, mutable=["batch_stats"],
                                **_mode(jm, True))
        return out, upd, units

    out, upd, units = jax.device_get(jax.jit(train)(variables, *x))
    new = dict(variables, batch_stats=upd.get("batch_stats", {}))
    evaluated = jax.jit(lambda v, *a: jm.apply(v, *a, **_mode(jm, False)))(
        new, *x)
    _FLAX[name] = (variables, out, new, jax.device_get(evaluated), x, units)
    return _FLAX[name]


def _port(name, variables, **kw):
    if name == "wide_deep":
        kw = dict(WD_KW, num_numeric=WD_NUMERIC, **kw)
    else:
        kw = dict(IMAGE_CASES[name][1], image_size=IMAGE_CASES[name][0],
                  **kw)
    model = factory.get_model(name, num_classes=NUM_CLASSES,
                              dtype=torch.float32, device="cpu", seed=1, **kw)
    model.load_state_dict(convert.zoo_params_from_flax(variables, model))
    for m in model.modules():
        if isinstance(m, layers.Dropout):
            m.rate = 0.0
    return model


def _close(got, want, rtol):
    """Each output within ``rtol`` of its largest ``|want|``."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=rtol * np.abs(w).max())


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# -- the models against flax --------------------------------------------------


@pytest.mark.parametrize("name", ZOO)
def test_zoo_matches_flax(name):
    """Eval-mode outputs with flax's running statistics; then one
    train-mode forward (dropout off): its outputs, and every ``ConvBN``
    unit on the input flax's unit saw — its output and the running
    statistics it moves. Inception-v3's outputs are ``(logits,
    aux_logits)``; wide & deep's ids wrap the int32 hash."""
    variables, train_out, updated, eval_out, x, units = _flax(name)
    model = _port(name, updated)
    rtol = WD_RTOL if name == "wide_deep" else LOGIT_RTOL
    with torch.no_grad():
        _close(model(*x), eval_out, rtol)
    model = _port(name, variables)
    model.train()
    if TRAIN_RTOL.get(name, rtol):
        _close(model(*x), train_out, TRAIN_RTOL.get(name, rtol))
    model = _port(name, variables)
    model.train()
    want = convert.zoo_params_from_flax(updated, model)
    for path, (inp, out) in units.items():
        unit = model.get_submodule(path)
        got = unit(_nchw(inp))
        np.testing.assert_allclose(_nhwc(got), out, rtol=0,
                                   atol=UNIT_RTOL * np.abs(out).max(),
                                   err_msg=path)
        for stat in ("mean", "var"):
            key = "{}.norm_stat".format(path).replace(
                "norm_stat", "BatchNorm_0." + stat)
            torch.testing.assert_close(
                getattr(unit.norm, stat), want[key], rtol=0,
                atol=UNIT_RTOL * float(want[key].abs().max()),
                msg=lambda m, k=key: "{}: {}".format(k, m))
    assert bool(units) == name.startswith("inception")


def test_wide_hash_wraps_in_int32_as_jax():
    cat, _ = _wd_inputs(3, b=64)
    mix = jnp.zeros_like(jnp.asarray(cat)[:, 0])
    for i in range(cat.shape[1]):
        mix = mix * jnp.uint32(1000003).astype(mix.dtype) + cat[:, i]
    want = np.asarray(jnp.abs(mix) % 4096)
    got = wide_deep.wide_hash(torch.from_numpy(cat), 4096).numpy()
    np.testing.assert_array_equal(got, want)
    # int64 ids give the same answer: they are taken as int32 first. An
    # int64 hash (torch's default integer) lands elsewhere.
    np.testing.assert_array_equal(wide_deep.wide_hash(
        torch.from_numpy(cat.astype(np.int64)), 4096).numpy(), want)
    wide = torch.zeros(64, dtype=torch.int64)
    for i in range(cat.shape[1]):
        wide = wide * 1000003 + torch.from_numpy(cat[:, i].astype(np.int64))
    assert (torch.remainder(wide.abs(), 4096).numpy() != want).any()
    assert int(mix[2]) == -2 ** 31 and 0 <= want[2] < 4096


def test_v3_aux_head_is_sized_from_the_image():
    """At 299 px the aux conv's kernel is 5x5 as flax's; another size is
    refused with the size the model was built for, never resized."""
    with torch.device("meta"):
        model = factory.get_model("inception_v3", aux_logits=True,
                                  device="meta")
    assert tuple(model.state_dict()["ConvBN_6.Conv_0.kernel"].shape) == (
        768, 128, 5, 5)
    small = factory.get_model("inception_v3", aux_logits=True,
                              image_size=107, num_classes=3, device="cpu",
                              dtype=torch.float32)
    with pytest.raises(ValueError, match="built for 107x107"):
        small(np.zeros((1, 115, 115, 3), np.float32))
    with pytest.raises(ValueError, match="aux head"):
        factory.get_model("inception_v3", aux_logits=True, image_size=99,
                          device="cpu")
    plain = factory.get_model("cifarnet", device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="image_size=32"):
        plain(np.zeros((1, 32, 32, 3), np.float32))


# -- parameter counts ---------------------------------------------------------


def _meta(name, **kw):
    with torch.device("meta"):
        return factory.get_model(name, device="meta", **kw)


def _count(model):
    return sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name", sorted(set(PARAM_SPECS) & set(CANONICAL)))
def test_param_counts_match_the_published(name):
    """tests/test_models.py's published sizes, within its 2%, without
    allocating a weight."""
    hw, want_m = PARAM_SPECS[name]
    model = _meta(name, image_size=hw)
    assert all(p.device.type == "meta" for p in model.parameters())
    assert abs(_count(model) / 1e6 - want_m) / want_m < 0.02


@pytest.mark.parametrize("name", sorted(CANONICAL) + ["wide_deep"])
def test_param_shapes_equal_flax_at_the_canonical_input(name):
    """Every parameter and running statistic, by flax path and shape, at
    the canonical input with 1000 classes (wide & deep: Criteo's 26 fields
    of 100,000 ids and 13 numeric features at the JAX defaults)."""
    if name == "wide_deep":
        kw = dict(vocab_sizes=(100000,) * 26)
        args = (jnp.zeros((1, 26), jnp.int32), jnp.zeros((1, 13)))
        model = _meta(name, num_numeric=13, **kw)
    else:
        hw = CANONICAL[name]
        kw = {}
        args = (jnp.zeros((1, hw, hw, 3)),)
        model = _meta(name, image_size=hw)
    jm = jax_factory.get_model(name, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                            **_mode(jm, False)))
    flat = {}
    for coll in ("params", "batch_stats"):
        for key, leaf in convert._flat(nn.meta.unbox(
                shapes.get(coll, {}))).items():
            flat[key.replace("/", ".")] = tuple(leaf.shape)
    have = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    for n, shape in have.items():
        if len(shape) == 4:
            have[n] = shape[2:] + (shape[1], shape[0])   # OIHW -> HWIO
    assert have == flat


def test_factory_serves_the_jax_registry():
    assert factory.available() == jax_factory.available()


# -- the flax layers ----------------------------------------------------------


@pytest.mark.parametrize("kernel,strides,padding", [
    ((1, 7), (1, 1), "SAME"), ((7, 1), (2, 2), "SAME"), ((3, 3), (2, 2),
                                                         "VALID"),
    ((5, 5), (1, 1), "SAME"), ((11, 11), (4, 4), "VALID"),
])
def test_conv_pads_like_flax(kernel, strides, padding):
    """Rectangular kernels, strides and VALID, with a bias (flax
    ``nn.Conv``'s default)."""
    x = np.random.RandomState(0).rand(2, 17, 16, 3).astype(np.float32)
    conv = nn.Conv(5, kernel, strides=strides, padding=padding,
                   dtype=jnp.float32)
    v = _draw(jax.eval_shape(conv.init, jax.random.PRNGKey(0), x), 4)
    want = np.asarray(conv.apply(v, x))
    port = layers.Conv(3, 5, kernel, strides, torch.float32, padding,
                       bias=True)
    port.load_state_dict({
        "kernel": torch.from_numpy(np.asarray(v["params"]["kernel"])
                                   .transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(np.asarray(v["params"]["bias"]))})
    got = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,k,s,padding", [
    ("max", 3, 2, "SAME"), ("max", 3, 1, "SAME"), ("max", 2, 2, "VALID"),
    ("avg", 3, 1, "SAME"), ("avg", 3, 2, "SAME"), ("avg", 5, 3, "VALID"),
])
def test_pools_pad_like_flax(kind, k, s, padding):
    """Max pools pad with -inf, average pools count the zero padding."""
    x = np.random.RandomState(1).randn(2, 15, 16, 4).astype(np.float32)
    fn = nn.max_pool if kind == "max" else nn.avg_pool
    want = np.asarray(fn(jnp.asarray(x), (k, k), strides=(s, s),
                         padding=padding))
    port = layers.max_pool if kind == "max" else layers.avg_pool
    got = _nhwc(port(_nchw(x), k, s, padding))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_group_norm_is_flax_not_torch():
    """Eight groups, epsilon 1e-6, ``E[x^2] - E[x]^2``: flax's, which
    ``F.group_norm`` (epsilon 1e-5) is not."""
    x = (np.random.RandomState(2).randn(2, 6, 5, 16) * 0.01
         ).astype(np.float32)
    gn = nn.GroupNorm(num_groups=8, dtype=jnp.float32)
    v = _draw(jax.eval_shape(gn.init, jax.random.PRNGKey(0), x), 5)
    want = np.asarray(gn.apply(v, x))
    port = layers.GroupNorm(16, torch.float32)
    port.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in
                          v["params"].items()})
    got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    torch_gn = _nhwc(F.group_norm(_nchw(x), 8, port.scale, port.bias))
    assert np.abs(torch_gn - want).max() > 1e-2


def test_dense_and_embed_dtypes():
    """A bf16 ``Dense`` computes in bf16; the f32 head promotes a bf16
    input; ``Embed`` casts its f32 rows."""
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    hidden = layers.Dense(8, 4, torch.bfloat16)
    head = layers.Dense(8, 4)
    for d in (hidden, head):
        torch.nn.init.normal_(d.kernel, generator=torch.Generator()
                              .manual_seed(1))
    assert hidden(x).dtype == torch.bfloat16
    out = head(x.to(torch.bfloat16))
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x.to(torch.bfloat16).float()
                               @ head.kernel + head.bias)
    emb = layers.Embed(5, 3, torch.bfloat16)
    torch.nn.init.normal_(emb.embedding)
    got = emb(torch.tensor([4, 0], dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, emb.embedding[[4, 0]].to(torch.bfloat16))


def test_dropout_draws_from_its_seed():
    """Flax's inverted dropout from a generator seeded by ``seed_dropout``:
    the same seed draws the same masks (a recomputed forward too), another
    seed others, two layers of one model different ones; eval mode and
    rate 0 are the identity; train mode unseeded refuses rather than touch
    torch's global generator, which no draw moves."""
    model = torch.nn.Sequential(layers.Dropout(0.5), layers.Dropout(0.5))
    x = torch.ones(64, 32)
    model.train()
    with pytest.raises(RuntimeError, match="seed"):
        model(x)
    state = torch.get_rng_state()
    assert layers.seed_dropout(model, 7) == 2
    a = model(x)
    assert torch.equal(model(x), a)
    layers.seed_dropout(model, 8)
    assert not torch.equal(model(x), a)
    assert torch.equal(torch.get_rng_state(), state)
    one = model[0](x)
    assert set(torch.unique(one).tolist()) <= {0.0, 2.0}
    assert 0.4 < float((one > 0).float().mean()) < 0.6
    assert not torch.equal(one, model[1](x))
    model[1].rate = 0.0
    assert torch.equal(model[1](x), x)
    model.eval()
    assert torch.equal(model(x), x)
    assert layers.seed_dropout(torch.nn.Linear(2, 2), 0) == 0


# -- export -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cifarnet", "inception_v3"])
def test_zoo_export_serves_bitwise(name, tmp_path):
    """``export_saved_model(example_inputs=)`` then ``load_serving_model``
    by the registry name: the artifact's outputs equal the model's bitwise
    at batches 1 and 3 (cifarnet's flatten and SAME pools, v3's VALID stem
    and aux branch meet the symbolic batch). ``load_saved_model`` rebuilds
    the same."""
    hw, kw = IMAGE_CASES[name]
    kw = dict(kw, image_size=hw, num_classes=NUM_CLASSES, dtype=torch.float32)
    model = factory.get_model(name, device="cpu", seed=3, **kw)
    sigs = {"serving_default": {"inputs": {"x": "x"},
                                "outputs": {"out": 0, "aux": 1}
                                if kw.get("aux_logits") else {"out": None}}}
    out_dir = str(tmp_path / "export")
    export.export_saved_model(
        out_dir, name, params=dict(model.named_parameters()),
        model_state=dict(model.named_buffers()), model_kwargs=kw,
        signatures=sigs, example_inputs=np.zeros((2, hw, hw, 3), np.float32))
    served = export.load_serving_model(out_dir, device="cpu")
    rebuilt = export.load_saved_model(out_dir, prefer_aot=False,
                                      device="cpu")
    for b in (1, 3):
        x = np.random.RandomState(b).rand(b, hw, hw, 3).astype(np.float32)
        with torch.no_grad():
            want = model(x)
        want = want if isinstance(want, tuple) else (want,)
        for loaded in (served, rebuilt):
            got = loaded.predict({"x": x})
            assert [k for k in sorted(got)] == sorted(sigs[
                "serving_default"]["outputs"])
            np.testing.assert_array_equal(got["out"], want[0].numpy())
            if "aux" in got:
                np.testing.assert_array_equal(got["aux"], want[1].numpy())


def test_wide_deep_tuple_input_loads_from_an_export(tmp_path):
    """Wide & deep takes ``(categorical, numeric)``: ``load_saved_model``
    rebuilds it from the registry and predicts on the tuple."""
    kw = dict(WD_KW, num_numeric=WD_NUMERIC, num_classes=2,
              dtype=torch.float32)
    model = factory.get_model("wide_deep", device="cpu", seed=4, **kw)
    with torch.no_grad():
        model.wide_table.embedding.normal_(
            generator=torch.Generator().manual_seed(0))
    out_dir = str(tmp_path / "wd")
    export.export_saved_model(out_dir, "wide_deep",
                              params=dict(model.named_parameters()),
                              model_kwargs=kw)
    loaded = export.load_saved_model(out_dir, device="cpu")
    cat, num = _wd_inputs(5)
    got = loaded.predict((cat, num))["out"]
    with torch.no_grad():
        np.testing.assert_array_equal(got, model((cat, num)).numpy())
