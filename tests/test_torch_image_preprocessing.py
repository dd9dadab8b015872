"""The port's image preprocessing against the JAX package's.

Every host function returns the same uint8 image for the same input and
the same ``rng`` (``np.random.Generator`` and ``RandomState``):
JPEG encode/decode, resize, the crops, flip and colour distortion, the
inception, vgg, cifarnet and lenet chains, ``preprocess_one`` and
``preprocessing_factory``. ``batch_transform`` is a callable object that
pickles; on the inline, thread and process pools (the port's process pool
starts by forkserver) and in an ``InputPipeline`` on a two-worker decode
pool, its batches equal the JAX transform's inline. ``input_normalizer``
is a torch function whose values equal the JAX normalizer's (f32: the
inception, vgg and lenet styles bitwise, cifarnet's per-image
standardization within 2e-6; bf16 within one bf16 step).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_data_programs as progs
from tensorflowonspark_tpu.data import dfutil as jax_dfutil
from tensorflowonspark_tpu.data import image_preprocessing as jip
from tensorflowonspark_tpu.data.input_pipeline import (
    InputPipeline as JaxPipeline,
)
from tensorflowonspark_tpu_torch.data import image_preprocessing as pip_
from tensorflowonspark_tpu_torch.data.input_pipeline import InputPipeline

pytestmark = pytest.mark.watchdog_timeout(120)

RNGS = {"generator": np.random.default_rng,
        "randomstate": np.random.RandomState}


@pytest.fixture(autouse=True)
def _nothing_left():
    before = progs.live_children()
    yield
    assert progs.wait_no_new_children(before) == set()


def _img(h=48, w=64, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    noise = np.random.RandomState(seed).randint(0, 40, size=(h, w, 3))
    base = np.stack([yy * 5, xx * 4, (yy + xx) * 2], axis=-1)
    return ((base + noise) % 256).astype(np.uint8)


def _jpeg(h=48, w=64, seed=0):
    return jip.encode_jpeg(_img(h, w, seed))


def test_jpeg_codec_equal():
    img = _img()
    raw = pip_.encode_jpeg(img, quality=87)
    assert raw == jip.encode_jpeg(img, quality=87)
    np.testing.assert_array_equal(pip_.decode_jpeg(raw), jip.decode_jpeg(raw))
    np.testing.assert_array_equal(pip_.resize(img, 20), jip.resize(img, 20))
    np.testing.assert_array_equal(pip_.central_crop(img, 0.6),
                                  jip.central_crop(img, 0.6))
    for side in (32, 50):
        np.testing.assert_array_equal(
            pip_.aspect_preserving_resize(img, side),
            jip.aspect_preserving_resize(img, side))
        np.testing.assert_array_equal(pip_.crop_or_pad(img, side, 70),
                                      jip.crop_or_pad(img, side, 70))


RANDOM_OPS = {
    "random_crop": lambda m, img, rng: m.random_crop(img, rng),
    "random_flip": lambda m, img, rng: np.ascontiguousarray(
        m.random_flip(img, rng)),
    "distort_color": lambda m, img, rng: m.distort_color(img, rng),
    "brightness_contrast": lambda m, img, rng:
        m._random_brightness_contrast(img, rng),
}


@pytest.mark.parametrize("rng_kind", sorted(RNGS))
@pytest.mark.parametrize("op", sorted(RANDOM_OPS))
def test_random_ops_equal_for_the_same_rng(op, rng_kind):
    img = _img()
    for seed in range(6):
        got = RANDOM_OPS[op](pip_, img, RNGS[rng_kind](seed))
        want = RANDOM_OPS[op](jip, img, RNGS[rng_kind](seed))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("style", ["inception", "vgg", "cifarnet", "lenet"])
def test_style_chains_equal(style, train):
    size = {"inception": 24, "vgg": 24, "cifarnet": 32, "lenet": 28}[style]
    for seed in range(3):
        data = _jpeg(40 + 8 * seed, 56, seed)
        kw = {"rng": np.random.default_rng(seed)} if train else {}
        got = pip_.preprocess_one(data, size, style, train, **kw)
        kw = {"rng": np.random.default_rng(seed)} if train else {}
        want = jip.preprocess_one(data, size, style, train, **kw)
        assert got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)


def test_factory_and_errors_match_jax():
    for name in ("vgg_16", "resnet_v1_50", "ResNet50", "cifarnet", "lenet",
                 "mnist", "inception_v3", "mobilenet_v1"):
        assert pip_.preprocessing_factory(name) == \
            jip.preprocessing_factory(name)
    data = _jpeg()
    for call in (lambda m: m.preprocess_one(data, 8, style="alexnet"),
                 lambda m: m.preprocess_one(data, 8, train=True),
                 lambda m: m.batch_transform(8, style="alexnet"),
                 lambda m: m.batch_transform(8, pool="gpu"),
                 lambda m: m.input_normalizer("alexnet")):
        with pytest.raises(ValueError) as want:
            call(jip)
        with pytest.raises(ValueError) as got:
            call(pip_)
        assert str(got.value) == str(want.value)


def _image_batch(n=6, live=5):
    images = np.empty(n, object)
    images[:] = [_jpeg(36 + 4 * i, 48, i) for i in range(n)]
    mask = np.arange(n) < live
    return {"image": images, "label": np.arange(n, dtype=np.int64),
            "mask": mask}


@pytest.mark.parametrize("pool", ["inline", "thread", "process"])
@pytest.mark.parametrize("train", [True, False])
def test_batch_transform_equal_to_jax_inline(pool, train):
    kw = dict(size=16, train=train, seed=5, style="inception")
    port = pip_.batch_transform(pool=pool, workers=2, **kw)
    assert isinstance(port, pip_.BatchTransform) and port.wants_base_index
    port = pickle.loads(pickle.dumps(port))
    want_t = jip.batch_transform(pool="inline", **kw)
    try:
        for _ in range(2):  # the counter carries on across calls
            got, want = port(_image_batch()), want_t(_image_batch())
            assert got.keys() == want.keys() == {"x", "y", "mask"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        b = dict(_image_batch(), _base_index=40)
        got = port(dict(b))
        want = want_t(dict(b))
        np.testing.assert_array_equal(got["x"], want["x"])
    finally:
        if pool == "process":
            pip_._POOLS.pop(("process", 2)).shutdown(wait=True)


def test_pipeline_with_decode_pool_equals_jax_inline(tmp_path):
    rows = [{"image": _jpeg(40 + (i % 3) * 8, 52, i), "label": i}
            for i in range(22)]
    data = str(tmp_path / "jpeg")
    jax_dfutil.save_as_tfrecords(
        rows, data, schema={"image": jax_dfutil.BINARY,
                            "label": jax_dfutil.INT64}, num_shards=3)
    columns = {"image": ("bytes", 1), "label": ("int64", 1)}
    kw = dict(batch_size=8, epochs=2, shuffle_buffer=4, seed=1)
    got = list(InputPipeline(
        data, columns, decode_workers=2,
        transform=pip_.batch_transform(20, seed=3, pool="inline"), **kw))
    want = list(JaxPipeline(
        data, columns,
        transform=jip.batch_transform(20, seed=3, pool="inline"), **kw))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("style", ["inception", "vgg", "cifarnet", "lenet"])
def test_input_normalizer_values_equal_to_jax(style):
    x = np.random.RandomState(2).randint(0, 256, size=(3, 8, 8, 3),
                                         dtype=np.uint8)
    got = pip_.input_normalizer(style, torch.float32)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = np.asarray(jip.input_normalizer(style, jnp.float32)(jnp.asarray(x)))
    if style == "cifarnet":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    got = pip_.input_normalizer(style)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jip.input_normalizer(style)(jnp.asarray(x)),
                      np.float32)
    step = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got.float().numpy() - want) <= step)
