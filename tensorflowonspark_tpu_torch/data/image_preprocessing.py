"""Host-side image decode + augmentation for the input pipeline (the port's
copy of the JAX package's ``data/image_preprocessing.py``; the images are
equal for the same ``rng``).

The fill for the reference's image preprocessing tier —
``examples/slim/preprocessing/inception_preprocessing.py`` (distorted
bounding-box crop, random flip, resize, value scaling) and
``examples/imagenet/inception/image_processing.py`` (parallel decode of
``image/encoded`` JPEG features out of TFRecord shards). The split:
*decode and geometric augmentation on the host* (CPU, riding the
InputPipeline producer thread or its decode pool via ``transform=``),
*numeric normalization on the card* (the Trainer's ``input_fn``, a torch
function of the uint8 batch, so the wire carries compact uint8).

Pure numpy + PIL; every random op takes an explicit ``rng``
(``np.random.Generator`` or ``RandomState``) so augmentation is
per-host seedable — the reference seeded per-thread
(``image_processing.py`` thread_id) for the same reason.
"""

import io
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def decode_jpeg(data):
    """JPEG/PNG bytes -> (h, w, 3) uint8 RGB."""
    from PIL import Image

    img = Image.open(io.BytesIO(bytes(data)))
    return np.asarray(img.convert("RGB"), np.uint8)


def encode_jpeg(arr, quality=90):
    """(h, w, 3) uint8 RGB -> JPEG bytes (the ``image/encoded`` feature
    the reference's shards store)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr, np.uint8), "RGB").save(
        buf, "JPEG", quality=quality)
    return buf.getvalue()


def resize(img, size):
    """Bilinear resize to (size, size) — uint8 in, uint8 out."""
    from PIL import Image

    return np.asarray(
        Image.fromarray(img).resize((size, size), Image.BILINEAR), np.uint8)


def central_crop(img, fraction=0.875):
    """The eval-path crop (inception_preprocessing.py: central 87.5%)."""
    h, w = img.shape[:2]
    ch, cw = int(h * fraction), int(w * fraction)
    top, left = (h - ch) // 2, (w - cw) // 2
    return img[top:top + ch, left:left + cw]


def random_crop(img, rng, area_range=(0.67, 1.0), aspect_range=(0.75, 1.33),
                attempts=10):
    """Distorted-bounding-box crop (the train-path geometry of
    ``inception_preprocessing.distorted_bounding_box_crop``): sample a
    region by area fraction and aspect ratio; fall back to the full
    image when no sample fits."""
    h, w = img.shape[:2]
    randint = rng.integers if hasattr(rng, "integers") else rng.randint
    for _ in range(attempts):
        area = rng.uniform(*area_range) * h * w
        aspect = rng.uniform(*aspect_range)
        cw = int(round(np.sqrt(area * aspect)))
        ch = int(round(np.sqrt(area / aspect)))
        if cw <= w and ch <= h and cw > 0 and ch > 0:
            top = int(randint(0, h - ch + 1))
            left = int(randint(0, w - cw + 1))
            return img[top:top + ch, left:left + cw]
    return img


def random_flip(img, rng):
    return img[:, ::-1] if rng.random() < 0.5 else img


def distort_color(img, rng, max_brightness=32.0,
                  saturation_range=(0.5, 1.5)):
    """The inception train path's fast-mode color distortion
    (``inception_preprocessing.py:64-70``): random brightness
    (±32/255 in the reference's [0,1] domain = ±32 here) and random
    saturation (0.5–1.5), applied in the order a fresh draw picks (the
    reference alternated order per preprocessing thread). Saturation
    uses Rec.601 luminance interpolation — the standard PIL-style
    approximation of TF's HSV S-scaling — and the uint8 wire clips
    where the reference's float tensor ran free."""
    x = img.astype(np.float32)

    def bright(x):
        return x + np.float32(rng.uniform(-max_brightness, max_brightness))

    def sat(x):
        gray = (0.299 * x[..., :1] + 0.587 * x[..., 1:2]
                + 0.114 * x[..., 2:])
        return gray + (x - gray) * np.float32(
            rng.uniform(*saturation_range))

    ops = (bright, sat) if rng.random() < 0.5 else (sat, bright)
    for op in ops:
        x = op(x)
    return np.clip(x, 0, 255).astype(np.uint8)


def preprocess_train(data, size, rng, color_distort=True):
    """Train-path: decode -> distorted crop -> resize -> random flip ->
    color distortion (the reference's full inception train chain).
    Returns (size, size, 3) uint8 (device-side ``input_fn`` normalizes)."""
    img = decode_jpeg(data)
    img = random_crop(img, rng)
    img = resize(img, size)
    img = np.ascontiguousarray(random_flip(img, rng))
    return distort_color(img, rng) if color_distort else img


def preprocess_eval(data, size):
    """Eval-path: decode -> central crop -> resize (deterministic)."""
    img = decode_jpeg(data)
    img = central_crop(img)
    return resize(img, size)


# -- vgg-style preprocessing -------------------------------------------------
# The reference's second image family (vgg_preprocessing.py, selected for
# vgg/resnet_v1/resnet_v2 by preprocessing_factory.py:47-57): geometry is
# aspect-PRESERVING resize (random smaller side in [256, 512] for train,
# fixed 256 for eval) + exact output-size crop + flip; numerics are
# per-channel ImageNet mean subtraction with NO rescaling
# (vgg_preprocessing.py:41-46). Geometry lives here (host, uint8);
# the mean subtraction is the device half — :func:`input_normalizer`.

VGG_RESIZE_SIDE_MIN = 256
VGG_RESIZE_SIDE_MAX = 512
VGG_MEANS_RGB = (123.68, 116.78, 103.94)


def aspect_preserving_resize(img, smaller_side):
    """Resize so the SMALLER side equals ``smaller_side``, keeping the
    aspect ratio (the vgg family's resize; inception's distorted crop
    makes square output directly instead)."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = smaller_side / min(h, w)
    if h <= w:
        nh, nw = smaller_side, max(int(round(w * scale)), smaller_side)
    else:
        nh, nw = max(int(round(h * scale)), smaller_side), smaller_side
    return np.asarray(
        Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.uint8)


def _crop_exact(img, size, top, left):
    return np.ascontiguousarray(img[top:top + size, left:left + size])


def vgg_preprocess_train(data, size, rng,
                         resize_side_min=VGG_RESIZE_SIDE_MIN,
                         resize_side_max=VGG_RESIZE_SIDE_MAX):
    """vgg train geometry: aspect-preserving resize to a RANDOM smaller
    side in [min, max], random (size, size) crop, random flip. Returns
    uint8; pair with ``input_normalizer("vgg")`` on device."""
    img = decode_jpeg(data)
    randint = rng.integers if hasattr(rng, "integers") else rng.randint
    side = int(randint(resize_side_min, resize_side_max + 1))
    img = aspect_preserving_resize(img, max(side, size))
    h, w = img.shape[:2]
    top = int(randint(0, h - size + 1))
    left = int(randint(0, w - size + 1))
    return np.ascontiguousarray(
        random_flip(_crop_exact(img, size, top, left), rng))


def vgg_preprocess_eval(data, size, resize_side=VGG_RESIZE_SIDE_MIN):
    """vgg eval geometry: aspect-preserving resize to the fixed side,
    exact central (size, size) crop. Deterministic."""
    img = decode_jpeg(data)
    img = aspect_preserving_resize(img, max(resize_side, size))
    h, w = img.shape[:2]
    return _crop_exact(img, size, (h - size) // 2, (w - size) // 2)


# -- cifarnet / lenet styles -------------------------------------------------
# The reference factory's remaining two families
# (preprocessing_factory.py:47-57). cifarnet
# (cifarnet_preprocessing.py): train = 4-px zero pad, random crop, flip,
# random brightness (±63) + contrast (0.2–1.8), then per-image
# standardization; eval = central crop-or-pad + standardization. lenet
# (lenet_preprocessing.py): crop-or-pad + (x-128)/128, train == eval.
# Host/device split as everywhere here: geometry + value distortion on
# the host (quantized back to the uint8 wire — a documented
# approximation of the reference's float-domain distortion; the
# standardization that follows is scale/shift-tolerant), per-image
# standardization / affine on device via :func:`input_normalizer`.

CIFARNET_PADDING = 4


def crop_or_pad(img, h, w):
    """Center crop-or-zero-pad to exactly (h, w) — the
    ``resize_image_with_crop_or_pad`` geometry."""
    ih, iw = img.shape[:2]
    top = max((ih - h) // 2, 0)
    left = max((iw - w) // 2, 0)
    img = img[top:top + h, left:left + w]
    ph, pw = h - img.shape[0], w - img.shape[1]
    if ph > 0 or pw > 0:
        img = np.pad(img, ((ph // 2, ph - ph // 2),
                           (pw // 2, pw - pw // 2), (0, 0)))
    return np.ascontiguousarray(img)


def _random_brightness_contrast(img, rng, max_delta=63.0,
                                contrast_range=(0.2, 1.8)):
    """The cifarnet value distortion, float domain, quantized back to
    uint8 (clipping where the reference's float tensor ran free — the
    per-image standardization downstream removes most of the affine)."""
    x = img.astype(np.float32)
    x = x + rng.uniform(-max_delta, max_delta)
    mean = x.mean(axis=(0, 1), keepdims=True)
    x = (x - mean) * rng.uniform(*contrast_range) + mean
    return np.clip(x, 0, 255).astype(np.uint8)


def cifarnet_preprocess_train(data, size, rng, padding=CIFARNET_PADDING):
    img = decode_jpeg(data)
    img = np.pad(img, ((padding, padding), (padding, padding), (0, 0)))
    if img.shape[0] < size or img.shape[1] < size:
        img = crop_or_pad(img, max(img.shape[0], size),
                          max(img.shape[1], size))
    h, w = img.shape[:2]
    randint = rng.integers if hasattr(rng, "integers") else rng.randint
    top = int(randint(0, h - size + 1))
    left = int(randint(0, w - size + 1))
    # Exact window at the sampled offset (tf.random_crop): routing the
    # remainder through a CENTER crop-or-pad halved the reachable offset
    # range and skewed it.
    img = _crop_exact(img, size, top, left)
    return _random_brightness_contrast(random_flip(img, rng), rng)


def cifarnet_preprocess_eval(data, size):
    return crop_or_pad(decode_jpeg(data), size, size)


def lenet_preprocess(data, size):
    """Deterministic; train == eval (lenet_preprocessing.py)."""
    return crop_or_pad(decode_jpeg(data), size, size)


_STYLES = ("inception", "vgg", "cifarnet", "lenet")


def preprocessing_factory(model_name):
    """Per-model preprocessing style — the reference's
    ``preprocessing_factory.get_preprocessing`` mapping
    (``preprocessing_factory.py:47-57``): vgg/resnet families use the
    vgg style, cifarnet its own, lenet/mnist the lenet style, the rest
    (inception/mobilenet/cnn zoo) the inception style. Returns the
    style NAME; feed it to :func:`batch_transform(style=...)`,
    :func:`preprocess_one`, and :func:`input_normalizer`."""
    base = model_name.lower()
    if base.startswith(("vgg", "resnet")):
        return "vgg"
    if base.startswith("cifarnet"):
        return "cifarnet"
    if base.startswith(("lenet", "mnist")):
        return "lenet"
    return "inception"


_TRAIN_FNS = {"inception": preprocess_train, "vgg": vgg_preprocess_train,
              "cifarnet": cifarnet_preprocess_train}
_EVAL_FNS = {"inception": preprocess_eval, "vgg": vgg_preprocess_eval,
             "cifarnet": cifarnet_preprocess_eval}


def preprocess_one(data, size, style="inception", train=False, rng=None):
    """Single-image dispatch over the style families (the factory's
    returned-callable shape, pre-batch)."""
    if style not in _STYLES:
        raise ValueError("unknown preprocessing style {!r}".format(style))
    if style == "lenet":
        return lenet_preprocess(data, size)
    if train:
        if rng is None:
            raise ValueError("train preprocessing needs an rng")
        return _TRAIN_FNS[style](data, size, rng)
    return _EVAL_FNS[style](data, size)


def input_normalizer(style, dtype=None):
    """The DEVICE half of a preprocessing style: a function of a uint8
    ``(n, h, w, 3)`` torch tensor, run where the tensor lies (on the card
    as the Trainer's ``input_fn``). Inception scales uint8 to [0, 1] (the
    slim trainer's established numeric); vgg subtracts the per-channel
    ImageNet means with no rescaling (``vgg_preprocessing.py:41-43``);
    cifarnet applies per-image standardization with TF's adjusted-stddev
    floor; lenet maps to ``(x - 128) / 128``. ``dtype`` defaults to
    ``torch.bfloat16``. The JAX package's normalizer computes the same
    values in ``jax.numpy``."""
    import torch

    if style not in _STYLES:
        raise ValueError("unknown preprocessing style {!r}".format(style))
    dt = dtype or torch.bfloat16

    if style == "inception":
        return lambda x: x.to(dt) / 255
    if style == "lenet":
        return lambda x: ((x.to(torch.float32) - 128.0) / 128.0).to(dt)
    if style == "cifarnet":
        def standardize(x):
            xf = x.to(torch.float32)
            n = xf.shape[1] * xf.shape[2] * xf.shape[3]
            mean = xf.mean(dim=(1, 2, 3), keepdim=True)
            std = xf.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
            floor = float(np.float32(1.0) / np.sqrt(np.float32(n)))
            return ((xf - mean) / torch.clamp(std, min=floor)).to(dt)

        return standardize
    means = torch.tensor(VGG_MEANS_RGB, dtype=torch.float32)

    def normalize(x):
        return x.to(dt) - means.to(device=x.device).to(dt)

    return normalize


_POOLS = {}

# The port's pools never fork, but a caller's own code may: a forked
# child would inherit this registry's executors as husks (their threads
# and processes do not survive a fork) and deadlock on their locks.
# Children start clean and build their own pools on first use.
os.register_at_fork(after_in_child=_POOLS.clear)


def _decode_pool(kind="thread", workers=None):
    """One process-wide decode pool per (kind, workers), created lazily:
    transform factories are rebuilt on pipeline restarts in long-lived
    executors, and a pool per factory call would pile up cpu_count idle
    threads each time. ``kind="process"`` gives real OS processes, started
    by forkserver like the decode pool's (never fork) — decode scaling
    that does not rest on PIL's GIL-release behavior."""
    key = (kind, workers)
    pool = _POOLS.get(key)
    if pool is None:
        n = workers or max(2, (os.cpu_count() or 1))
        if kind == "process":
            from concurrent.futures import ProcessPoolExecutor

            from tensorflowonspark_tpu_torch.data import decode_pool

            pool = ProcessPoolExecutor(max_workers=n,
                                       mp_context=decode_pool.mp_context())
        elif kind == "thread":
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="jpeg-decode")
        else:
            raise ValueError(
                "pool must be 'thread' or 'process', got {!r}".format(kind))
        _POOLS[key] = pool
    return pool


def _decode_task(args):
    """Top-level decode task (picklable — the process pool's unit):
    returns the decoded (size, size, 3) uint8 image."""
    data, size, style, train, seed_tuple = args
    if train:
        rng = np.random.default_rng(seed_tuple)
        return preprocess_one(data, size, style=style, train=True, rng=rng)
    return preprocess_one(data, size, style=style)


def batch_transform(size, train=True, seed=0, image_key="image",
                    out_key="x", label_key="label", label_out="y",
                    style="inception", pool="thread", workers=None):
    """An ``InputPipeline(transform=...)`` factory: decodes a batch's
    ``image/encoded`` bytes column into a stacked (n, size, size, 3)
    uint8 array (train: distorted crop + flip; eval: central crop).

    Decode runs on a pool — the role of the reference's
    ``num_preprocess_threads`` readers (``image_processing.py``); the
    producer thread only assembles. ``pool="thread"`` (default) shares
    memory and relies on PIL releasing the GIL during decode;
    ``pool="process"`` uses real OS processes (decoded images return
    over IPC) so multi-core scaling does not depend on GIL-release
    behavior at all. ``pool="inline"`` decodes serially in the calling
    process — the right mode inside an ``InputPipeline(decode_workers=N)``
    decode pool, where each worker process is already one parallel unit
    and a nested per-worker pool would oversubscribe the host. ``workers``
    caps the pool size (default: cpu_count).

    Determinism: augmentation is drawn from per-image rngs seeded as
    ``(seed, image_index_in_this_transform)``, so a REBUILT transform
    (fresh ``batch_transform(...)`` call, e.g. a restarted pipeline)
    replays the same stream; reusing one transform object across two
    iterations continues the index sequence instead of replaying.
    When the batch carries a ``"_base_index"`` hint (InputPipeline adds
    one — the global index of the batch's first record), it replaces the
    process-local counter, so augmentation is seeded by *record* index
    and identical no matter which decode-pool worker handles the batch.

    Returns a :class:`BatchTransform`, a callable object: it pickles to a
    decode-pool worker, where the JAX package's closure rides ``fork``.
    ``style`` selects the geometry family (:func:`preprocessing_factory`);
    pair with the matching :func:`input_normalizer` on the card.
    """
    if style not in _STYLES:
        raise ValueError("unknown preprocessing style {!r}".format(style))
    if pool not in ("thread", "process", "inline"):
        raise ValueError(
            "pool must be 'thread', 'process' or 'inline', "
            "got {!r}".format(pool))
    return BatchTransform(size, train, seed, image_key, out_key, label_key,
                          label_out, style, pool, workers)


class BatchTransform:
    """:func:`batch_transform`'s transform."""

    # Opt-in marker: InputPipeline injects the "_base_index" hint only
    # for transforms that declare they consume it.
    wants_base_index = True

    def __init__(self, size, train, seed, image_key, out_key, label_key,
                 label_out, style, pool, workers):
        self.size = size
        self.train = train
        self.seed = seed
        self.image_key = image_key
        self.out_key = out_key
        self.label_key = label_key
        self.label_out = label_out
        self.style = style
        self.pool = pool
        self.workers = workers
        self.counter = 0

    def _task(self, data, index):
        return (data, self.size, self.style, self.train, (self.seed, index))

    def __call__(self, batch):
        images = batch[self.image_key]
        mask = batch.get("mask")
        size = self.size
        out = np.zeros((len(images), size, size, 3), np.uint8)
        base = batch.pop("_base_index", None)
        if base is None:
            base = self.counter
            self.counter += len(images)
        live = [i for i in range(len(images))
                if mask is None or mask[i]]  # padded slots stay zero

        if self.pool == "inline":
            for i in live:
                out[i] = _decode_task(self._task(images[i], base + i))
        elif self.pool == "process":
            tasks = [self._task(images[i], base + i) for i in live]
            n_workers = self.workers or max(2, (os.cpu_count() or 1))
            chunk = max(1, len(tasks) // (4 * n_workers))
            decoded = _decode_pool("process", self.workers).map(
                _decode_task, tasks, chunksize=chunk)
            for i, img in zip(live, decoded):
                out[i] = img
        else:
            def decode_one(i):
                out[i] = _decode_task(self._task(images[i], base + i))

            list(_decode_pool("thread", self.workers).map(decode_one, live))
        result = {self.out_key: out}
        if self.label_key in batch:
            result[self.label_out] = batch[self.label_key].astype(np.int32)
        if "mask" in batch:
            result["mask"] = batch["mask"].astype(np.float32)
        return result
