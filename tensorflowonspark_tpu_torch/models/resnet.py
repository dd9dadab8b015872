"""ResNet v1 (18/34/50/101/152) and v2 (50/101/152) (port of
``models/resnet.py``).

The JAX models' structure, names and rounding points. Input is NHWC, as
there; inside, activations run as NCHW-indexed views of channels-last
memory, so every conv reads the NHWC bytes as they are. Parameters are
f32 and each conv casts its kernel to the compute ``dtype`` (flax's
``dtype=bf16, param_dtype=f32``). ``state_dict`` names mirror the flax
paths (``BottleneckBlock_3.Conv_1.kernel``, ``stem_norm.mean``), conv
kernels stored OIHW (:func:`tensorflowonspark_tpu_torch.convert.
resnet_params_from_flax` transposes flax's HWIO).

What flax does that torch's own layers do not, and this module does:

* SAME padding. Flax pads ``(total // 2, total - total // 2)``: for a
  stride-2 conv on an even input that is one pixel more at the bottom and
  right than at the top and left — (2, 3) for the 7x7 stem on 224 px,
  (0, 1) for a stride-2 3x3 conv and for the 3x3/2 max pool. Torch's
  symmetric ``padding=`` gives the same output size but shifts every
  window by a pixel, so uneven padding goes in explicitly with ``F.pad``;
  the max pool pads with -inf.
* :class:`BatchNorm` is flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``,
  not ``nn.BatchNorm2d``: batch statistics in f32 as ``E[x]`` and the
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
* Initial values: he-normal conv kernels and lecun-normal head (both
  truncated normals, as ``jax.nn.initializers``), the last norm of each v1
  residual branch with scale zero, the shortcut conv and norm only where
  the block changes shape.

Modes. ``model.train()`` normalises with the batch statistics and moves
the running ones once per forward; ``model.eval()`` uses the running ones.
That takes the place of the JAX ``train=`` argument. Like the port's
``TransformerLM`` the model is built in eval mode; ``train.Trainer`` sets
train mode around a step. The fused bottleneck kernels
(``ops/fused_resnet_block.py``) are not wired in: the JAX model runs flax
convs too.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.initializers import truncated_normal_


def _same_pads(size, k, stride):
    """Flax/XLA SAME padding of one spatial dim: ``(lo, hi)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, stride, value=0.0):
    """``x`` (N, C, H, W) padded SAME for a k x k window at ``stride``;
    returns ``(x, symmetric padding left to the op)``."""
    ph = _same_pads(x.shape[2], k, stride)
    pw = _same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] == pw[0] == pw[1] and value == 0.0:
        return x, ph[0]
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), 0


class Conv(nn.Module):
    """``nn.Conv(use_bias=False)`` with SAME padding: ``kernel`` (O, I, k,
    k) f32, operands cast to ``dtype``, output in ``dtype``."""

    def __init__(self, cin, cout, k, stride, dtype):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x):
        x, pad = _pad_same(x.to(self.dtype), self.k, self.stride)
        return F.conv2d(x, self.kernel.to(self.dtype), stride=self.stride,
                        padding=pad)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5, param_dtype=f32)`` over
    the channel axis 1 (see the module docstring). ``scale_init`` is the
    initial scale (0 for the last norm of a residual branch)."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, features, dtype, scale_init=1.0):
        super().__init__()
        self.dtype, self.scale_init = dtype, scale_init
        self.scale = nn.Parameter(torch.full((features,), scale_init))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        xf = x.float()
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
    count = torch.full((1,), float(xf.numel() // c), dtype=torch.float32,
                       device=xf.device)
    sums = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                      count])
    sums = coll.all_reduce(sums, group)
    n = sums[-1]
    mean = sums[:c] / n
    return mean, torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)


class Dense(nn.Module):
    """f32 ``nn.Dense``: ``kernel`` (in, out) and ``bias``; the input is
    promoted to f32."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return x.float() @ self.kernel + self.bias


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 x4, post-activation; a projection
    shortcut where the shape changes."""

    expansion = 4

    def __init__(self, cin, filters, stride, dtype):
        super().__init__()
        cout = filters * 4
        self.Conv_0 = Conv(cin, filters, 1, 1, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, cout, 1, 1, dtype)
        self.BatchNorm_2 = BatchNorm(cout, dtype, scale_init=0.0)
        if stride != 1 or cin != cout:
            self.shortcut = Conv(cin, cout, 1, stride, dtype)
            self.shortcut_norm = BatchNorm(cout, dtype)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if hasattr(self, "shortcut"):
            residual = self.shortcut_norm(self.shortcut(x))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 (strided) -> 3x3, post-activation."""

    expansion = 1

    def __init__(self, cin, filters, stride, dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, stride, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype, scale_init=0.0)
        if stride != 1 or cin != filters:
            self.shortcut = Conv(cin, filters, 1, stride, dtype)
            self.shortcut_norm = BatchNorm(filters, dtype)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x
        if hasattr(self, "shortcut"):
            residual = self.shortcut_norm(self.shortcut(x))
        return F.relu(residual + y)


class PreActBottleneckBlock(nn.Module):
    """Pre-activation bottleneck (ResNet v2): norm-relu precede each conv;
    the projection shortcut reads the pre-activated input."""

    expansion = 4

    def __init__(self, cin, filters, stride, dtype):
        super().__init__()
        cout = filters * 4
        self.BatchNorm_0 = BatchNorm(cin, dtype)
        self.Conv_0 = Conv(cin, filters, 1, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype)
        self.BatchNorm_2 = BatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, cout, 1, 1, dtype)
        if stride != 1 or cin != cout:
            self.shortcut = Conv(cin, cout, 1, stride, dtype)

    def forward(self, x):
        preact = F.relu(self.BatchNorm_0(x))
        y = self.Conv_0(preact)
        y = self.Conv_1(F.relu(self.BatchNorm_1(y)))
        y = self.Conv_2(F.relu(self.BatchNorm_2(y)))
        residual = self.shortcut(preact) if hasattr(self, "shortcut") else x
        return residual + y


class _ResNetBase(nn.Module):
    """Shared build, init and head of :class:`ResNet` and
    :class:`ResNetV2`."""

    def __init__(self, stage_sizes, block_cls, num_classes, width, dtype,
                 in_channels, device, seed):
        super().__init__()
        dev = device_info.resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes, self.width, self.dtype = num_classes, width, dtype
        self.stem = Conv(in_channels, width, 7, 2, dtype)
        self._build_stem_norm()
        cin, i = width, 0
        for stage, size in enumerate(self.stage_sizes):
            for block in range(size):
                stride = 2 if stage > 0 and block == 0 else 1
                filters = width * 2 ** stage
                self.add_module("{}_{}".format(block_cls.__name__, i),
                                block_cls(cin, filters, stride, dtype))
                cin = filters * block_cls.expansion
                i += 1
        self._build_final_norm(cin)
        self.Dense_0 = Dense(cin, num_classes)
        self.reset_parameters(seed)
        self.to(dev)
        self.eval()

    def _build_stem_norm(self):
        pass

    def _build_final_norm(self, features):
        pass

    @torch.no_grad()
    def reset_parameters(self, seed):
        """Weights drawn from a ``torch.Generator`` seeded with ``seed`` with
        the JAX initializer families; norms back to identity, running
        statistics to mean 0 and variance 1."""
        gen = torch.Generator().manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, Conv):
                fan_in = module.kernel[0].numel()     # I * k * k
                truncated_normal_(module.kernel, 2.0 / fan_in, gen)
            elif isinstance(module, BatchNorm):
                module.scale.fill_(module.scale_init)
                module.bias.zero_()
                module.mean.zero_()
                module.var.fill_(1.0)
            elif isinstance(module, Dense):
                truncated_normal_(module.kernel, 1.0 / module.kernel.shape[0],
                                  gen)
                module.bias.zero_()

    @property
    def device(self):
        return self.stem.kernel.device

    def blocks(self):
        return [m for name, m in self.named_children() if "Block_" in name]

    def _head(self, x):
        # The f32 head on the spatial mean of the dtype activations (jnp.mean
        # of bf16 sums in f32 and rounds the mean back to bf16).
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.Dense_0(x)

    @staticmethod
    def _max_pool(x):
        x, _ = _pad_same(x, 3, 2, value=-math.inf)
        return F.max_pool2d(x, 3, 2)

    def _input(self, x):
        # NHWC in; an NCHW-indexed view of the channels-last bytes inside.
        return torch.as_tensor(x, device=self.device).to(
            self.dtype).contiguous().permute(0, 3, 1, 2)


class ResNet(_ResNetBase):
    """ResNet v1 with post-activation blocks. ``x`` (B, H, W, C) -> f32
    logits (B, num_classes)."""

    def __init__(self, stage_sizes, block_cls=BottleneckBlock,
                 num_classes=1000, width=64, dtype=torch.bfloat16,
                 in_channels=3, *, device="cuda", seed=0):
        super().__init__(stage_sizes, block_cls, num_classes, width, dtype,
                         in_channels, device, seed)

    def _build_stem_norm(self):
        self.stem_norm = BatchNorm(self.width, self.dtype)

    def forward(self, x):
        x = self._input(x)
        x = F.relu(self.stem_norm(self.stem(x)))
        x = self._max_pool(x)
        for block in self.blocks():
            x = block(x)
        return self._head(x)


class ResNetV2(_ResNetBase):
    """ResNet v2 with pre-activation blocks and a final norm."""

    def __init__(self, stage_sizes, num_classes=1000, width=64,
                 dtype=torch.bfloat16, in_channels=3, *, device="cuda",
                 seed=0):
        super().__init__(stage_sizes, PreActBottleneckBlock, num_classes,
                         width, dtype, in_channels, device, seed)

    def _build_final_norm(self, features):
        self.final_norm = BatchNorm(features, self.dtype)

    def forward(self, x):
        x = self._max_pool(self.stem(self._input(x)))
        for block in self.blocks():
            x = block(x)
        return self._head(F.relu(self.final_norm(x)))


def ResNet18(**kw):
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, **kw)


def ResNet34(**kw):
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock, **kw)


def ResNet50(**kw):
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def ResNet101(**kw):
    return ResNet(stage_sizes=(3, 4, 23, 3), **kw)


def ResNet152(**kw):
    return ResNet(stage_sizes=(3, 8, 36, 3), **kw)


def ResNet50V2(**kw):
    return ResNetV2(stage_sizes=(3, 4, 6, 3), **kw)


def ResNet101V2(**kw):
    return ResNetV2(stage_sizes=(3, 4, 23, 3), **kw)


def ResNet152V2(**kw):
    return ResNetV2(stage_sizes=(3, 8, 36, 3), **kw)
