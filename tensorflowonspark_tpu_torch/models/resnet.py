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

The flax layers (SAME padding, ``BatchNorm`` with global-batch statistics
under a mesh, the f32 ``Dense`` head) are ``models/layers.py``'s. Initial
values: he-normal conv kernels and lecun-normal head (both truncated
normals, as ``jax.nn.initializers``), the last norm of each v1 residual
branch with scale zero, the shortcut conv and norm only where the block
changes shape.

Modes. ``model.train()`` normalises with the batch statistics and moves
the running ones once per forward; ``model.eval()`` uses the running ones.
That takes the place of the JAX ``train=`` argument. Like the port's
``TransformerLM`` the model is built in eval mode; ``train.Trainer`` sets
train mode around a step. The fused bottleneck kernels
(``ops/fused_resnet_block.py``) are not wired in: the JAX model runs flax
convs too.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch.initializers import truncated_normal_
from tensorflowonspark_tpu_torch.models import layers
from tensorflowonspark_tpu_torch.models.layers import BatchNorm, Conv, Dense


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
        return self.Dense_0(layers.spatial_mean(x, self.dtype))

    @staticmethod
    def _max_pool(x):
        return layers.max_pool(x, 3, 2, "SAME")

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
