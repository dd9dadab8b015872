"""flax's layers as the port's convolutional models need them: the ResNets
(``models/resnet.py``), the plain CNNs (``models/cnn.py``), VGG
(``models/vgg.py``), the Inception family (``models/inception.py``) and
Wide & Deep (``models/wide_deep.py``).

Activations are NCHW-indexed views (the models take NHWC and permute);
parameters are f32 and each layer casts its operands to the compute
``dtype`` (flax's ``dtype=bf16, param_dtype=f32``). Parameter names are
flax's (``kernel``, ``bias``, ``scale``, ``embedding``; BatchNorm's
running ``mean`` and ``var``), conv kernels stored OIHW
(:func:`tensorflowonspark_tpu_torch.convert.zoo_params_from_flax`
transposes flax's HWIO).

What flax does that torch's own layers do not, and these do:

* SAME padding. Flax pads ``(total // 2, total - total // 2)`` in each
  spatial dimension: for a stride-2 window on an even input that is one
  pixel more at the bottom and right than at the top and left — (2, 3)
  for the 7x7 stem on 224 px, (0, 1) for a stride-2 3x3 conv and for the
  3x3/2 max pool. Torch's symmetric ``padding=`` gives the same output size
  but shifts every window by a pixel, so uneven padding goes in explicitly
  with ``F.pad``; a max pool pads with -inf, an average pool with zeros
  that it counts (flax's ``count_include_pad=True``). ``"VALID"`` pads
  nothing. Kernels and strides may be rectangular (Inception's 1x7 and
  7x1), each dimension padded on its own.
* :class:`BatchNorm` is flax's ``BatchNorm(momentum=0.9, epsilon=eps)``,
  not ``nn.BatchNorm2d``: batch statistics in f32 (f64 for an f64
  model, as flax's at-least-f32 rule) as ``E[x]`` and the
  biased ``E[x^2] - E[x]^2`` clipped at 0, for normalising and for the
  running variance alike (torch keeps an unbiased running variance);
  ``running = 0.9 * running + 0.1 * batch``; scale and bias f32; the
  output cast to the model dtype. Under a mesh whose batch axes (``data x
  fsdp``) exceed 1 the statistics are the global batch's, as the JAX
  package's are (its batch is one global array): each rank sums ``x`` and
  ``x^2`` over its rows, the sums and the row count go through one
  all-reduce over the batch group whose backward is the all-reduce of the
  cotangents, and every rank moves the running statistics by the same
  global values.
* :class:`GroupNorm` is flax's ``GroupNorm(num_groups=8)``: epsilon 1e-6
  and the same f32 ``E[x^2] - E[x]^2`` over each sample's group, not
  ``F.group_norm`` (epsilon 1e-5, its own variance).
* :class:`Dense` keeps flax's ``(in, out)`` kernel; with ``dtype=f32`` (the
  zoo's heads) it promotes bf16 activations to f32.
* :class:`Dropout` is flax's inverted dropout (``where(keep, x / p, 0)``),
  its masks drawn from an explicit ``torch.Generator`` seeded by
  :func:`seed_dropout` — never from torch's global generator.
  ``train.Trainer`` reseeds the model's dropout from ``(seed, step)``
  before each step, as the JAX trainer folds the step into its dropout
  key.

Modes. ``model.train()`` normalises with the batch statistics and moves the
running ones once per forward, and applies dropout; ``model.eval()`` uses
the running statistics and no dropout. That takes the place of the JAX
``train=`` argument.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch.initializers import truncated_normal_
from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def same_pads(size, k, stride):
    """Flax/XLA SAME padding of one spatial dim: ``(lo, hi)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x, k, stride, value=0.0):
    """``x`` (N, C, H, W) padded SAME for a ``k`` window (an int or
    ``(kh, kw)``) at ``stride`` (likewise); returns ``(x, symmetric padding
    left to the op)``."""
    (kh, kw), (sh, sw) = _pair(k), _pair(stride)
    ph = same_pads(x.shape[2], kh, sh)
    pw = same_pads(x.shape[3], kw, sw)
    if ph[0] == ph[1] and pw[0] == pw[1] and value == 0.0:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), 0


def out_size(size, k, stride, padding):
    """One spatial dim of a window's output under flax's padding."""
    if padding == "SAME":
        return -(-size // stride)
    return (size - k) // stride + 1


def max_pool(x, k, stride, padding="VALID"):
    """flax ``nn.max_pool``: VALID by default, SAME pads with -inf."""
    if padding == "SAME":
        x, _ = pad_same(x, k, stride, value=-math.inf)
    return F.max_pool2d(x, k, stride)


def avg_pool(x, k, stride, padding="VALID"):
    """flax ``nn.avg_pool``: the window's sum over its full size, the zero
    padding of SAME counted."""
    if padding == "SAME":
        x, pad = pad_same(x, k, stride)
        if pad:
            return F.avg_pool2d(x, k, stride, padding=pad,
                                count_include_pad=True)
    return F.avg_pool2d(x, k, stride)


def _stat_dtype(x):
    """flax's statistics dtype: at least f32 (f64 stays f64)."""
    return torch.promote_types(x.dtype, torch.float32)


def spatial_mean(x, dtype):
    """``jnp.mean(x, axis=(1, 2))`` of NHWC ``dtype`` activations: summed in
    at least f32 and rounded back to ``dtype``."""
    return x.to(_stat_dtype(x)).mean(dim=(2, 3)).to(dtype)


def nhwc_flatten(x):
    """The JAX ``x.reshape((n, -1))`` of NHWC activations: (H, W, C)
    order, so that the first ``Dense`` meets its flax kernel's rows."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class Conv(nn.Module):
    """flax ``nn.Conv``: ``kernel`` (O, I, kh, kw) f32, operands cast to
    ``dtype``, output in ``dtype``; ``padding`` ``"SAME"`` or ``"VALID"``;
    with ``bias``, the f32 bias cast to ``dtype`` and added after the conv
    (flax's rounding). ``fan_scale`` is the initializer's variance factor:
    2 for he-normal, 1 for flax's default lecun-normal."""

    def __init__(self, cin, cout, k, stride=1, dtype=torch.float32,
                 padding="SAME", bias=False, fan_scale=2.0):
        super().__init__()
        self.k, self.stride = _pair(k), _pair(stride)
        self.dtype, self.padding, self.fan_scale = dtype, padding, fan_scale
        self.kernel = nn.Parameter(torch.empty(cout, cin, *self.k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        x, pad = x.to(self.dtype), 0
        if self.padding == "SAME":
            x, pad = pad_same(x, self.k, self.stride)
        y = F.conv2d(x, self.kernel.to(self.dtype), stride=self.stride,
                     padding=pad)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=eps, param_dtype=f32)`` over
    the channel axis 1 (see the module docstring). ``scale_init`` is the
    initial scale (0 for the last norm of a residual branch)."""

    momentum = 0.9

    def __init__(self, features, dtype, scale_init=1.0, eps=1e-5):
        super().__init__()
        self.dtype, self.scale_init, self.eps = dtype, scale_init, eps
        self.scale = nn.Parameter(torch.full((features,), scale_init))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        xf = x.to(_stat_dtype(x))
        group = _batch_group() if self.training else None
        if group is not None:
            mean, var = _global_stats(xf, group)
        elif self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                                  0.0)
        if self.training:
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean
                                + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var
                               + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


def _batch_group():
    """The ambient mesh's batch group (None without a mesh or at size 1)."""
    mesh = mesh_lib.current_mesh()
    if mesh is None:
        return None
    (entry,) = mesh_lib.resolve_spec(mesh.shape, ("batch",),
                                     mesh_lib.active_rules())
    return mesh.group(*mesh_lib.spec_axes(entry))


def _global_stats(xf, group):
    """Global-batch ``E[x]`` and biased ``E[x^2] - E[x]^2`` (clipped at 0)
    per channel: the rank's sums and element count, summed over
    ``group`` by one differentiable all-reduce."""
    c = xf.shape[1]
    count = torch.full((1,), float(xf.numel() // c), dtype=xf.dtype,
                       device=xf.device)
    sums = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                      count])
    sums = coll.all_reduce(sums, group)
    n = sums[-1]
    mean = sums[:c] / n
    return mean, torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)


class GroupNorm(nn.Module):
    """flax ``GroupNorm(num_groups=groups, epsilon=eps)`` over the channel
    axis 1: each sample's group statistics in f32, ``E[x^2] - E[x]^2``
    clipped at 0; f32 scale and bias; the output in ``dtype``."""

    def __init__(self, features, dtype, groups=8, eps=1e-6):
        super().__init__()
        if features % groups:
            raise ValueError("{} groups do not divide {} channels".format(
                groups, features))
        self.dtype, self.groups, self.eps = dtype, groups, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        n, c = x.shape[:2]
        xf = x.to(_stat_dtype(x))
        g = xf.reshape(n, self.groups, -1)
        mean = g.mean(dim=2)
        var = torch.clamp_min((g * g).mean(dim=2) - mean * mean, 0.0)
        mean = mean.repeat_interleave(c // self.groups, dim=1)
        var = var.repeat_interleave(c // self.groups, dim=1)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, :, None, None]) * mul[:, :, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense`` with its compute dtype: input and kernel (``(in,
    out)``) are cast to ``dtype`` for the product, the bias after it; the
    parameters stay f32. ``fan_scale``: 2 for he-normal, 1 for the default
    lecun-normal."""

    def __init__(self, in_features, out_features, dtype=torch.float32,
                 fan_scale=1.0):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype
        self.fan_scale = fan_scale

    def forward(self, x):
        x = x.to(self.dtype)
        return x @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: an f32 ``embedding`` (num, features), rows looked
    up and cast to ``dtype``. ``init_std`` is the normal initializer's std
    (0: zeros)."""

    def __init__(self, num, features, dtype, init_std=0.01):
        super().__init__()
        self.dtype, self.init_std = dtype, init_std
        self.embedding = nn.Parameter(torch.empty(num, features))

    def forward(self, ids):
        return F.embedding(ids, self.embedding).to(self.dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode each element is kept with
    probability ``1 - rate`` and scaled by its inverse, the mask drawn from
    a ``torch.Generator`` on the input's device seeded with ``self.seed``
    (see :func:`seed_dropout`) — so a recomputed forward (the Trainer's
    whole-forward ``remat``) draws the same mask; in eval mode, or at rate
    0, the identity."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)
        self.seed = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.seed is None:
            raise RuntimeError("dropout in train mode needs a seed: "
                               "layers.seed_dropout(model, seed)")
        keep = 1.0 - self.rate
        gen = torch.Generator(device=x.device).manual_seed(self.seed)
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def seed_dropout(model, seed):
    """Seed every :class:`Dropout` of ``model`` from ``seed``: layer ``i``
    (in module order) with ``seed + i``. Returns how many there are."""
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    for i, m in enumerate(drops):
        m.seed = (int(seed) + i) % (1 << 64)
    return len(drops)


def step_seed(seed, step):
    """The dropout seed of step ``step`` of a run seeded with ``seed``: one
    64-bit value a ``(seed, step)`` pair, so a relaunch at a step draws
    that step's masks again."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) % (1 << 64)


class Scope(nn.Module):
    """A module whose children are named as flax's compact modules name
    theirs: ``<Class>_<n>``, numbered per class in the order they are
    constructed — which, for ``unit(a)(unit(b)(x))``, is the outer unit
    first. The port's ``state_dict`` names are then the flax paths."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def __setattr__(self, name, value):
        # An attribute naming a child that sub() registered stays a plain
        # reference: each child is registered once, under its flax name.
        if isinstance(value, nn.Module) and any(
                value is m for m in self.__dict__.get("_modules", {})
                .values()):
            object.__setattr__(self, name, value)
        else:
            super().__setattr__(name, value)

    def sub(self, module, name=None):
        if name is None:
            kind = type(module).__name__
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            name = "{}_{}".format(kind, n)
        self.add_module(name, module)
        return module


class ZooModel(Scope):
    """The zoo's common build: weights from flax's initializer families
    drawn from a seeded ``torch.Generator``, moved to ``device``, dropout
    seeded, eval mode. ``device="meta"`` (built inside ``with
    torch.device("meta")``) keeps shapes only: no draw, no device."""

    def _finish(self, device, seed):
        if str(device) != "meta":
            self.reset_parameters(seed)
            self.to(device_info.resolve_device(device))
            seed_dropout(self, seed)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, seed):
        """Conv and Dense kernels truncated-normal with variance
        ``fan_scale / fan_in``, biases zero; norms to identity, running
        statistics to mean 0 and variance 1; embeddings normal with their
        ``init_std`` (or zero)."""
        gen = torch.Generator().manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, Conv):
                truncated_normal_(module.kernel,
                                  module.fan_scale / module.kernel[0].numel(),
                                  gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, Dense):
                truncated_normal_(module.kernel,
                                  module.fan_scale / module.kernel.shape[0],
                                  gen)
                module.bias.zero_()
            elif isinstance(module, (BatchNorm, GroupNorm)):
                module.scale.fill_(getattr(module, "scale_init", 1.0))
                module.bias.zero_()
                if isinstance(module, BatchNorm):
                    module.mean.zero_()
                    module.var.fill_(1.0)
            elif isinstance(module, Embed):
                if module.init_std:
                    module.embedding.normal_(0.0, module.init_std,
                                             generator=gen)
                else:
                    module.embedding.zero_()

    @property
    def device(self):
        return next(self.parameters()).device

    def _input(self, x):
        """NHWC in; an NCHW-indexed view of the channels-last bytes in
        ``dtype`` inside."""
        return torch.as_tensor(x, device=self.device).to(
            self.dtype).contiguous().permute(0, 3, 1, 2)

    def _check_size(self, x):
        """``x`` (N, C, H, W) must be the size the weights were shaped
        for."""
        if tuple(x.shape[2:]) != (self.image_size, self.image_size):
            raise ValueError(
                "{} was built for {}x{} images (image_size={}); got {}x{}: "
                "build it with image_size={}".format(
                    type(self).__name__, self.image_size, self.image_size,
                    self.image_size, x.shape[2], x.shape[3], x.shape[2]))
