"""Plain (non-residual) convolutional nets: LeNet, the CIFAR-10 CNN,
AlexNet and OverFeat (port of ``models/cnn.py``).

The JAX modules' layers, names (``Conv_<i>``, ``GroupNorm_<i>``,
``Dense_<i>``) and rounding points, on ``models/layers.py``'s flax layers:
convs with a bias and lecun-normal kernels (flax ``nn.Conv``'s defaults),
hidden layers in ``dtype`` (bf16 by default), the head in f32. Input is
NHWC, as there.

The flatten before the first ``Dense`` is in NHWC order, as the JAX
``x.reshape((n, -1))`` of NHWC activations: the port permutes its NCHW view
back to (N, H, W, C) first (``layers.nhwc_flatten``), so a flax kernel's
rows meet the same features and ``convert.zoo_params_from_flax`` carries
the kernel unchanged. The first ``Dense``'s width depends on the image
size, which flax reads at ``init``; a PyTorch module owns its weights from
construction, so each model takes ``image_size`` (default: its canonical
input) and refuses another size with an error that names both.
"""

import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.models import layers
from tensorflowonspark_tpu_torch.models.layers import (Conv, Dense, Dropout,
                                                       GroupNorm)


def _conv(cin, cout, k, dtype, stride=1, padding="SAME"):
    return Conv(cin, cout, k, stride, dtype, padding, bias=True,
                fan_scale=1.0)


class _PlainNet(layers.ZooModel):
    """A conv stack, the NHWC flatten and a dense tower (``self.tower``:
    ReLU dense layers, each with its dropout where the model has one, and
    the f32 head last). Subclasses build ``self.body``, the stack in
    order: convs (each followed by a ReLU), norms, and max pools as ``(k,
    stride, padding)``; they return the spatial size and channels it
    leaves."""

    def __init__(self, num_classes, dtype, image_size, in_channels,
                 widths, dropout_rate, device, seed):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.image_size = image_size
        self.dropout_rate = dropout_rate
        side, channels = self._build_body(in_channels, image_size)
        width = side * side * channels
        self.tower = []
        for out in widths:
            self.tower.append(self.sub(Dense(width, out, dtype)))
            if dropout_rate is not None:
                self.tower.append(self.sub(Dropout(dropout_rate)))
            width = out
        self.tower.append(self.sub(Dense(width, num_classes, torch.float32)))
        self._finish(device, seed)

    def forward(self, x):
        x = self._input(x)
        self._check_size(x)
        for layer in self.body:
            if isinstance(layer, tuple):
                x = layers.max_pool(x, *layer)
            elif isinstance(layer, Conv):
                x = F.relu(layer(x))
            else:
                x = layer(x)
        x = layers.nhwc_flatten(x)
        for layer in self.tower[:-1]:
            x = layer(x)
            if isinstance(layer, Dense):
                x = F.relu(x)
        return self.tower[-1](x)


class LeNet(_PlainNet):
    """LeNet-5-style conv net (reference ``examples/slim/nets/lenet.py``):
    28 px by default."""

    def __init__(self, num_classes=10, dtype=torch.bfloat16, image_size=28,
                 in_channels=3, *, device="cuda", seed=0):
        super().__init__(num_classes, dtype, image_size, in_channels,
                         (1024,), None, device, seed)

    def _build_body(self, cin, s):
        pool = (2, 2, "VALID")
        self.body = [self.sub(_conv(cin, 32, 5, self.dtype)), pool,
                     self.sub(_conv(32, 64, 5, self.dtype)), pool]
        for _ in range(2):
            s = layers.out_size(s, 2, 2, "VALID")
        return s, 64


class CifarNet(_PlainNet):
    """CIFAR-10 CNN: 2 conv blocks (GroupNorm in place of the 2015
    tutorial's LRN, as in JAX) + 2 dense layers + the head; 24 px by
    default."""

    def __init__(self, num_classes=10, dtype=torch.bfloat16, image_size=24,
                 in_channels=3, *, device="cuda", seed=0):
        super().__init__(num_classes, dtype, image_size, in_channels,
                         (384, 192), None, device, seed)

    def _build_body(self, cin, s):
        pool = (3, 2, "SAME")
        self.body = [self.sub(_conv(cin, 64, 5, self.dtype)), pool,
                     self.sub(GroupNorm(64, self.dtype)),
                     self.sub(_conv(64, 64, 5, self.dtype)),
                     self.sub(GroupNorm(64, self.dtype)), pool]
        for _ in range(2):
            s = layers.out_size(s, 3, 2, "SAME")
        return s, 64


class AlexNet(_PlainNet):
    """AlexNet (reference ``alexnet_v2``: 224x224 canonical input, 5 conv +
    3 dense, dropout after each hidden dense layer)."""

    def __init__(self, num_classes=1000, dropout_rate=0.5,
                 dtype=torch.bfloat16, image_size=224, in_channels=3, *,
                 device="cuda", seed=0):
        super().__init__(num_classes, dtype, image_size, in_channels,
                         (4096, 4096), dropout_rate, device, seed)

    def _build_body(self, cin, s):
        d = self.dtype
        convs = [self.sub(_conv(cin, 64, 11, d, 4, "VALID")),
                 self.sub(_conv(64, 192, 5, d)),
                 self.sub(_conv(192, 384, 3, d)),
                 self.sub(_conv(384, 384, 3, d)),
                 self.sub(_conv(384, 256, 3, d))]
        pool = (3, 2, "VALID")
        self.body = convs[:1] + [pool, convs[1], pool] + convs[2:] + [pool]
        s = layers.out_size(s, 11, 4, "VALID")
        for _ in range(3):
            s = layers.out_size(s, 3, 2, "VALID")
        return s, 256


class OverFeat(_PlainNet):
    """OverFeat (reference ``overfeat``: 231x231 canonical input, the
    accurate model's filter widths)."""

    def __init__(self, num_classes=1000, dropout_rate=0.5,
                 dtype=torch.bfloat16, image_size=231, in_channels=3, *,
                 device="cuda", seed=0):
        super().__init__(num_classes, dtype, image_size, in_channels,
                         (3072, 4096), dropout_rate, device, seed)

    def _build_body(self, cin, s):
        d = self.dtype
        convs = [self.sub(_conv(cin, 64, 11, d, 4, "VALID")),
                 self.sub(_conv(64, 256, 5, d, 1, "VALID")),
                 self.sub(_conv(256, 512, 3, d)),
                 self.sub(_conv(512, 1024, 3, d)),
                 self.sub(_conv(1024, 1024, 3, d))]
        pool = (2, 2, "VALID")
        self.body = convs[:1] + [pool, convs[1], pool] + convs[2:] + [pool]
        s = layers.out_size(s, 11, 4, "VALID")
        s = layers.out_size(s, 2, 2, "VALID")
        s = layers.out_size(s, 5, 1, "VALID")
        for _ in range(2):
            s = layers.out_size(s, 2, 2, "VALID")
        return s, 1024
