"""The Inception family: v1 (GoogLeNet), v2, v3, v4 and Inception-ResNet-v2
(port of ``models/inception.py``).

The JAX modules' blocks, in the same order and under the same names, on
``models/layers.py``'s flax layers. The unit is ``ConvBN``: a bias-free
he-normal conv, BatchNorm with epsilon 1e-3 (slim's) and a ReLU.
Inception-ResNet's residual blocks project with a linear 1x1 conv that has
a bias. Input is NHWC, as there; the head is the f32 ``Dense`` on the
spatial mean, after dropout.

Names. A flax compact module numbers its children per class in the order
they are constructed, and ``unit(a)(unit(b)(x))`` constructs the outer
unit ``a`` first: ``ConvBN_0`` is ``a`` though ``b`` runs first.
:meth:`_Block.chain` takes a branch's units outer to inner, as the JAX code
reads, so the port's ``state_dict`` names are the flax paths
(``InceptionB_2.ConvBN_4.Conv_0.kernel``) and
``convert.zoo_params_from_flax`` needs no table of names.

Inception-v3's auxiliary head (``aux_logits=True``) sizes its second conv's
kernel from the spatial shape of the activation it reads, which flax sees
at ``init``. A PyTorch module owns its weights from construction, so the
port works that shape out from ``image_size`` (default 299, the canonical
input: a 5x5 kernel) and refuses an input of another size with an error
that names both; it never resizes. With ``aux_logits=True`` the forward
returns ``(logits, aux_logits)`` in train and eval mode alike, and the loss
function owns the aux term, as in JAX.
"""

import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.models import layers
from tensorflowonspark_tpu_torch.models.layers import (BatchNorm, Conv,
                                                       Dense, Dropout)


class ConvBN(layers.Scope):
    """Conv + BN + ReLU, the inception building unit (slim ``conv2d``)."""

    def __init__(self, cin, features, kernel, strides=1, padding="SAME",
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv = self.sub(Conv(cin, features, kernel, strides, dtype,
                                  padding))
        self.norm = self.sub(BatchNorm(features, dtype, eps=1e-3))

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


def _run(units, x):
    for unit in units:
        x = unit(x)
    return x


class _Block(layers.Scope):
    """A scope of ``ConvBN`` units in ``dtype``."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def unit(self, cin, features, kernel, strides=1, padding="SAME"):
        return self.sub(ConvBN(cin, features, kernel, strides, padding,
                               self.dtype))

    def chain(self, cin, *specs):
        """The units of one branch, ``specs`` (``(features, kernel[,
        strides[, padding]])``) listed outer to inner as the JAX code nests
        them; constructed in that order, returned in the order they run."""
        cins, c = [], cin
        for spec in reversed(specs):
            cins.insert(0, c)
            c = spec[0]
        return [self.unit(ci, *spec) for ci, spec in zip(cins, specs)][::-1]


class InceptionV1Block(_Block):
    """The GoogLeNet mixed block: 1x1 | 1x1->3x3 | 1x1->5x5 | pool->1x1."""

    def __init__(self, cin, f1, f3r, f3, f5r, f5, fp, dtype):
        super().__init__(dtype)
        self.b0 = self.chain(cin, (f1, 1))
        self.b1 = self.chain(cin, (f3, 3), (f3r, 1))
        self.b2 = self.chain(cin, (f5, 5), (f5r, 1))
        self.b3 = self.chain(cin, (fp, 1))
        self.out_features = f1 + f3 + f5 + fp

    def forward(self, x):
        p = layers.max_pool(x, 3, 1, "SAME")
        return torch.cat([_run(self.b0, x), _run(self.b1, x),
                          _run(self.b2, x), _run(self.b3, p)], dim=1)


class InceptionA(_Block):
    def __init__(self, cin, pool_features, dtype):
        super().__init__(dtype)
        self.b0 = self.chain(cin, (64, 1))
        self.b1 = self.chain(cin, (64, 5), (48, 1))
        self.b2 = self.chain(cin, (96, 3), (96, 3), (64, 1))
        self.b3 = self.chain(cin, (pool_features, 1))
        self.out_features = 224 + pool_features

    def forward(self, x):
        p = layers.avg_pool(x, 3, 1, "SAME")
        return torch.cat([_run(self.b0, x), _run(self.b1, x),
                          _run(self.b2, x), _run(self.b3, p)], dim=1)


class ReductionA(_Block):
    def __init__(self, cin, dtype):
        super().__init__(dtype)
        self.b0 = self.chain(cin, (384, 3, 2, "VALID"))
        self.b1 = self.chain(cin, (96, 3, 2, "VALID"), (96, 3), (64, 1))
        self.out_features = 480 + cin

    def forward(self, x):
        return torch.cat([_run(self.b0, x), _run(self.b1, x),
                          layers.max_pool(x, 3, 2)], dim=1)


class InceptionB(_Block):
    def __init__(self, cin, c, dtype):
        super().__init__(dtype)
        self.b0 = self.chain(cin, (192, 1))
        self.b1 = self.chain(cin, (192, (7, 1)), (c, (1, 7)), (c, 1))
        self.b2 = self.chain(cin, (192, (1, 7)), (c, (7, 1)), (c, (1, 7)),
                             (c, (7, 1)), (c, 1))
        self.b3 = self.chain(cin, (192, 1))
        self.out_features = 768

    def forward(self, x):
        p = layers.avg_pool(x, 3, 1, "SAME")
        return torch.cat([_run(self.b0, x), _run(self.b1, x),
                          _run(self.b2, x), _run(self.b3, p)], dim=1)


class ReductionB(_Block):
    def __init__(self, cin, dtype):
        super().__init__(dtype)
        self.b0 = self.chain(cin, (320, 3, 2, "VALID"), (192, 1))
        self.b1 = self.chain(cin, (192, 3, 2, "VALID"), (192, (7, 1)),
                             (192, (1, 7)), (192, 1))
        self.out_features = 512 + cin

    def forward(self, x):
        return torch.cat([_run(self.b0, x), _run(self.b1, x),
                          layers.max_pool(x, 3, 2)], dim=1)


class _SplitBlock(_Block):
    """The 8x8 blocks' shape: 1x1 | stem1 -> (1x3, 3x1) | stem2 -> (1x3,
    3x1) | avg pool -> 1x1, each split pair constructed 1x3 first."""

    def _split(self, cin, features):
        return [self.unit(cin, features, (1, 3)),
                self.unit(cin, features, (3, 1))]

    def forward(self, x):
        h1, h2 = _run(self.b1h, x), _run(self.b2h, x)
        p = layers.avg_pool(x, 3, 1, "SAME")
        return torch.cat([_run(self.b0, x)]
                         + [u(h1) for u in self.b1] + [u(h2) for u in self.b2]
                         + [_run(self.b3, p)], dim=1)


class InceptionC(_SplitBlock):
    def __init__(self, cin, dtype):
        super().__init__(dtype)
        self.b0 = self.chain(cin, (320, 1))
        self.b1h = self.chain(cin, (384, 1))
        self.b1 = self._split(384, 384)
        self.b2h = self.chain(cin, (384, 3), (448, 1))
        self.b2 = self._split(384, 384)
        self.b3 = self.chain(cin, (192, 1))
        self.out_features = 2048


class _Net(layers.ZooModel):
    """The zoo model around a family's blocks: its own ``ConvBN`` units,
    the blocks, and the head (spatial mean, dropout, f32 ``Dense_0``)."""

    def __init__(self, num_classes, dropout_rate, dtype, image_size):
        super().__init__()
        self.num_classes, self.dropout_rate = num_classes, dropout_rate
        self.dtype, self.image_size = dtype, image_size

    unit = _Block.unit
    chain = _Block.chain

    def block(self, cls, cin, *args):
        return self.sub(cls(cin, *args, dtype=self.dtype))

    def _build_head(self, features):
        self.head_dropout = self.sub(Dropout(self.dropout_rate))
        self.head_dense = self.sub(Dense(features, self.num_classes,
                                         torch.float32))

    def _head(self, x):
        return self.head_dense(self.head_dropout(
            layers.spatial_mean(x, self.dtype)))


class InceptionV1(_Net):
    """GoogLeNet with batch norm (slim ``inception_v1``)."""

    _BLOCKS = [(64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64), "pool",
               (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
               (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
               (256, 160, 320, 32, 128, 128), "pool2",
               (256, 160, 320, 32, 128, 128), (384, 192, 384, 48, 128, 128)]

    def __init__(self, num_classes=1000, dropout_rate=0.2,
                 dtype=torch.bfloat16, image_size=224, in_channels=3, *,
                 device="cuda", seed=0):
        super().__init__(num_classes, dropout_rate, dtype, image_size)
        self.stem = [self.unit(in_channels, 64, 7, 2), (3, 2),
                     self.unit(64, 64, 1), self.unit(64, 192, 3), (3, 2)]
        self.blocks, c = [], 192
        for spec in self._BLOCKS:
            if spec == "pool":
                self.blocks.append((3, 2))
            elif spec == "pool2":
                self.blocks.append((2, 2))
            else:
                self.blocks.append(self.block(InceptionV1Block, c, *spec))
                c = self.blocks[-1].out_features
        self._build_head(c)
        self._finish(device, seed)

    def forward(self, x):
        x = self._input(x)
        for layer in self.stem + self.blocks:
            x = (layers.max_pool(x, *layer, "SAME")
                 if isinstance(layer, tuple) else layer(x))
        return self._head(x)


class InceptionV2Block(_Block):
    """v2 mixed block: 1x1 | 1x1->3x3 | 1x1->3x3->3x3 | pool->1x1; ``f1 ==
    0`` drops the 1x1 branch and ``fp == 0`` the pool projection (the
    strided reduction blocks)."""

    def __init__(self, cin, f1, f3r, f3, d3r, d3, fp, strides=1, pool="avg",
                 dtype=torch.bfloat16):
        super().__init__(dtype)
        self.strides, self.pool = strides, pool
        self.b0 = self.chain(cin, (f1, 1)) if f1 else []
        self.b1 = self.chain(cin, (f3, 3, strides), (f3r, 1))
        self.b2 = self.chain(cin, (d3, 3, strides), (d3, 3), (d3r, 1))
        self.b3 = self.chain(cin, (fp, 1)) if fp else []
        self.out_features = f1 + f3 + d3 + (fp or cin)

    def forward(self, x):
        pool = layers.avg_pool if self.pool == "avg" else layers.max_pool
        p = pool(x, 3, self.strides, "SAME")
        outs = [_run(self.b0, x)] if self.b0 else []
        outs += [_run(self.b1, x), _run(self.b2, x), _run(self.b3, p)]
        return torch.cat(outs, dim=1)


class InceptionV2(_Net):
    """Inception-v2 / BN-Inception (slim ``inception_v2``; 224x224 input;
    the slim separable 7x7 stem is a dense 7x7, as in JAX)."""

    _BLOCKS = [((64, 64, 64, 64, 96, 32), {}),
               ((64, 64, 96, 64, 96, 64), {}),
               ((0, 128, 160, 64, 96, 0), dict(strides=2, pool="max")),
               ((224, 64, 96, 96, 128, 128), {}),
               ((192, 96, 128, 96, 128, 128), {}),
               ((160, 128, 160, 128, 160, 96), {}),
               ((96, 128, 192, 160, 192, 96), {}),
               ((0, 128, 192, 192, 256, 0), dict(strides=2, pool="max")),
               ((352, 192, 320, 160, 224, 128), {}),
               ((352, 192, 320, 192, 224, 128), dict(pool="max"))]

    def __init__(self, num_classes=1000, dropout_rate=0.2,
                 dtype=torch.bfloat16, image_size=224, in_channels=3, *,
                 device="cuda", seed=0):
        super().__init__(num_classes, dropout_rate, dtype, image_size)
        self.stem = [self.unit(in_channels, 64, 7, 2), (3, 2),
                     self.unit(64, 64, 1), self.unit(64, 192, 3), (3, 2)]
        self.blocks, c = [], 192
        for args, kw in self._BLOCKS:
            self.blocks.append(self.sub(InceptionV2Block(
                c, *args, dtype=self.dtype, **kw)))
            c = self.blocks[-1].out_features
        self._build_head(c)
        self._finish(device, seed)

    def forward(self, x):
        x = self._input(x)
        for layer in self.stem:
            x = (layers.max_pool(x, *layer, "SAME")
                 if isinstance(layer, tuple) else layer(x))
        for block in self.blocks:
            x = block(x)
        return self._head(x)


def _v3_stem(net, cin, s):
    """The v3 / Inception-ResNet-v2 stem (299 -> 35x35x192): its units
    (``ConvBN_0``-``4``) and max pools in order, and the side it leaves."""
    stem = [net.unit(cin, 32, 3, 2, "VALID"), net.unit(32, 32, 3, 1, "VALID"),
            net.unit(32, 64, 3), (3, 2), net.unit(64, 80, 1, 1, "VALID"),
            net.unit(80, 192, 3, 1, "VALID"), (3, 2)]
    for k, st, pad in ((3, 2, "VALID"), (3, 1, "VALID"), (3, 1, "SAME"),
                       (3, 2, "VALID"), (1, 1, "VALID"), (3, 1, "VALID"),
                       (3, 2, "VALID")):
        s = layers.out_size(s, k, st, pad)
    return stem, s


def _run_stem(stem, x):
    for layer in stem:
        x = layers.max_pool(x, *layer) if isinstance(layer, tuple) \
            else layer(x)
    return x


class InceptionV3(_Net):
    """Inception-v3 (slim ``inception_v3``; 299x299 canonical input)."""

    def __init__(self, num_classes=1000, dropout_rate=0.2, aux_logits=False,
                 dtype=torch.bfloat16, image_size=299, in_channels=3, *,
                 device="cuda", seed=0):
        super().__init__(num_classes, dropout_rate, dtype, image_size)
        self.aux_logits = aux_logits
        self.stem, s = _v3_stem(self, in_channels, image_size)
        self.mixed_a = []
        c = 192
        for pool_features in (32, 64, 64):
            self.mixed_a.append(self.block(InceptionA, c, pool_features))
            c = self.mixed_a[-1].out_features
        self.mixed_a.append(self.block(ReductionA, c))
        c = self.mixed_a[-1].out_features
        s = layers.out_size(s, 3, 2, "VALID")
        self.mixed_b = []
        for channels in (128, 160, 160, 192):
            self.mixed_b.append(self.block(InceptionB, c, channels))
        c = 768
        if aux_logits:
            side = layers.out_size(s, 5, 3, "VALID")
            if side < 1:
                raise ValueError(
                    "aux_logits: a {}x{} input leaves {}x{} at the aux head, "
                    "under its 5x5 pool".format(image_size, image_size, s, s))
            self.aux = [self.unit(c, 128, 1), self.unit(128, 768, side, 1,
                                                        "VALID")]
            self.aux_dense = self.sub(Dense(768, num_classes, torch.float32),
                                      name="aux_head")
        self.mixed_c = [self.block(ReductionB, c)]
        c = self.mixed_c[-1].out_features
        for _ in range(2):
            self.mixed_c.append(self.block(InceptionC, c))
            c = 2048
        self._build_head(c)
        self._finish(device, seed)

    def forward(self, x):
        x = self._input(x)
        if self.aux_logits:
            self._check_size(x)
        x = _run_stem(self.stem, x)
        for block in self.mixed_a + self.mixed_b:
            x = block(x)
        aux = None
        if self.aux_logits:
            aux = _run(self.aux, layers.avg_pool(x, 5, 3))
            aux = self.aux_dense(layers.spatial_mean(aux, self.dtype))
        for block in self.mixed_c:
            x = block(x)
        logits = self._head(x)
        return (logits, aux) if self.aux_logits else logits


class InceptionV4A(_Block):
    def __init__(self, cin, dtype):
        super().__init__(dtype)
        self.b0 = self.chain(cin, (96, 1))
        self.b1 = self.chain(cin, (96, 3), (64, 1))
        self.b2 = self.chain(cin, (96, 3), (96, 3), (64, 1))
        self.b3 = self.chain(cin, (96, 1))
        self.out_features = 384

    forward = InceptionA.forward


class InceptionV4ReductionA(_Block):
    """The A-reduction parameterized (k, l, m, n) as in the paper: v4 uses
    (192, 224, 256, 384), Inception-ResNet-v2 (256, 256, 384, 384)."""

    def __init__(self, cin, k, l, m, n, dtype):  # noqa: E741
        super().__init__(dtype)
        self.b0 = self.chain(cin, (n, 3, 2, "VALID"))
        self.b1 = self.chain(cin, (m, 3, 2, "VALID"), (l, 3), (k, 1))
        self.out_features = n + m + cin

    forward = ReductionA.forward


class InceptionV4B(_Block):
    def __init__(self, cin, dtype):
        super().__init__(dtype)
        self.b0 = self.chain(cin, (384, 1))
        self.b1 = self.chain(cin, (256, (7, 1)), (224, (1, 7)), (192, 1))
        self.b2 = self.chain(cin, (256, (1, 7)), (224, (7, 1)),
                             (224, (1, 7)), (192, (7, 1)), (192, 1))
        self.b3 = self.chain(cin, (128, 1))
        self.out_features = 1024

    forward = InceptionB.forward


class InceptionV4ReductionB(_Block):
    def __init__(self, cin, dtype):
        super().__init__(dtype)
        self.b0 = self.chain(cin, (192, 3, 2, "VALID"), (192, 1))
        self.b1 = self.chain(cin, (320, 3, 2, "VALID"), (320, (7, 1)),
                             (256, (1, 7)), (256, 1))
        self.out_features = 512 + cin

    forward = ReductionB.forward


class InceptionV4C(_SplitBlock):
    def __init__(self, cin, dtype):
        super().__init__(dtype)
        self.b0 = self.chain(cin, (256, 1))
        self.b1h = self.chain(cin, (384, 1))
        self.b1 = self._split(384, 256)
        self.b2h = self.chain(cin, (512, (1, 3)), (448, (3, 1)), (384, 1))
        self.b2 = self._split(512, 256)
        self.b3 = self.chain(cin, (256, 1))
        self.out_features = 1536


class InceptionV4(_Net):
    """Inception-v4 (slim ``inception_v4``; 299x299 canonical input)."""

    def __init__(self, num_classes=1000, dropout_rate=0.2,
                 dtype=torch.bfloat16, image_size=299, in_channels=3, *,
                 device="cuda", seed=0):
        super().__init__(num_classes, dropout_rate, dtype, image_size)
        self.stem = [self.unit(in_channels, 32, 3, 2, "VALID"),
                     self.unit(32, 32, 3, 1, "VALID"), self.unit(32, 64, 3)]
        self.mixed_3a = self.unit(64, 96, 3, 2, "VALID")
        self.mixed_4a = [self.chain(160, (96, 3, 1, "VALID"), (64, 1)),
                         self.chain(160, (96, 3, 1, "VALID"), (64, (7, 1)),
                                    (64, (1, 7)), (64, 1))]
        self.mixed_5a = self.unit(192, 192, 3, 2, "VALID")
        self.blocks, c = [], 384
        for _ in range(4):
            self.blocks.append(self.block(InceptionV4A, c))
            c = 384
        self.blocks.append(self.block(InceptionV4ReductionA, c, 192, 224,
                                      256, 384))
        c = self.blocks[-1].out_features
        for _ in range(7):
            self.blocks.append(self.block(InceptionV4B, c))
            c = 1024
        self.blocks.append(self.block(InceptionV4ReductionB, c))
        c = self.blocks[-1].out_features
        for _ in range(3):
            self.blocks.append(self.block(InceptionV4C, c))
            c = 1536
        self._build_head(c)
        self._finish(device, seed)

    def forward(self, x):
        x = _run(self.stem, self._input(x))
        x = torch.cat([layers.max_pool(x, 3, 2), self.mixed_3a(x)], dim=1)
        x = torch.cat([_run(b, x) for b in self.mixed_4a], dim=1)
        x = torch.cat([self.mixed_5a(x), layers.max_pool(x, 3, 2)], dim=1)
        for block in self.blocks:
            x = block(x)
        return self._head(x)


class _ResidualBlock(_Block):
    """Inception-ResNet residual block: branches concatenated, a linear 1x1
    projection with a bias back to the input width (``Conv_0``), ``x +
    scale * up``, then a ReLU unless ``activate`` is off."""

    def _project(self, up, cin):
        self.proj = self.sub(Conv(up, cin, 1, 1, self.dtype, bias=True))

    def forward(self, x):
        up = torch.cat([_run(b, x) for b in self.branches], dim=1)
        x = x + self.scale * self.proj(up)
        return F.relu(x) if self.activate else x


class ResNetBlock35(_ResidualBlock):
    """The 35x35 residual block (``block35``, scale 0.17)."""

    def __init__(self, cin, dtype, scale=0.17):
        super().__init__(dtype)
        self.scale, self.activate = scale, True
        self.branches = [self.chain(cin, (32, 1)),
                         self.chain(cin, (32, 3), (32, 1)),
                         self.chain(cin, (64, 3), (48, 3), (32, 1))]
        self._project(128, cin)


class ResNetBlock17(_ResidualBlock):
    """The 17x17 residual block (``block17``, scale 0.10)."""

    def __init__(self, cin, dtype, scale=0.10):
        super().__init__(dtype)
        self.scale, self.activate = scale, True
        self.branches = [self.chain(cin, (192, 1)),
                         self.chain(cin, (192, (7, 1)), (160, (1, 7)),
                                    (128, 1))]
        self._project(384, cin)


class ResNetBlock8(_ResidualBlock):
    """The 8x8 residual block (``block8``, scale 0.20)."""

    def __init__(self, cin, dtype, scale=0.20, activate=True):
        super().__init__(dtype)
        self.scale, self.activate = scale, activate
        self.branches = [self.chain(cin, (192, 1)),
                         self.chain(cin, (256, (3, 1)), (224, (1, 3)),
                                    (192, 1))]
        self._project(448, cin)


class InceptionResNetV2(_Net):
    """Inception-ResNet-v2 (slim ``inception_resnet_v2``; 299x299 input):
    residual scaling 0.17/0.10/0.20, linear projections with a bias."""

    def __init__(self, num_classes=1000, dropout_rate=0.2,
                 dtype=torch.bfloat16, image_size=299, in_channels=3, *,
                 device="cuda", seed=0):
        super().__init__(num_classes, dropout_rate, dtype, image_size)
        self.stem, _ = _v3_stem(self, in_channels, image_size)
        self.mixed_5b = [self.chain(192, (96, 1)),
                         self.chain(192, (64, 5), (48, 1)),
                         self.chain(192, (96, 3), (96, 3), (64, 1)),
                         self.chain(192, (64, 1))]
        self.blocks = [self.block(ResNetBlock35, 320) for _ in range(10)]
        self.blocks.append(self.block(InceptionV4ReductionA, 320, 256, 256,
                                      384, 384))
        self.blocks += [self.block(ResNetBlock17, 1088) for _ in range(20)]
        self.mixed_7a = [self.chain(1088, (384, 3, 2, "VALID"), (256, 1)),
                         self.chain(1088, (288, 3, 2, "VALID"), (256, 1)),
                         self.chain(1088, (320, 3, 2, "VALID"), (288, 3),
                                    (256, 1))]
        self.blocks_8 = [self.block(ResNetBlock8, 2080) for _ in range(9)]
        self.blocks_8.append(self.sub(ResNetBlock8(
            2080, self.dtype, scale=1.0, activate=False)))
        self.final = self.unit(2080, 1536, 1)
        self._build_head(1536)
        self._finish(device, seed)

    def forward(self, x):
        x = _run_stem(self.stem, self._input(x))
        p = layers.avg_pool(x, 3, 1, "SAME")
        b = self.mixed_5b
        x = torch.cat([_run(b[0], x), _run(b[1], x), _run(b[2], x),
                       _run(b[3], p)], dim=1)
        for block in self.blocks:
            x = block(x)
        x = torch.cat([_run(b, x) for b in self.mixed_7a]
                      + [layers.max_pool(x, 3, 2)], dim=1)
        for block in self.blocks_8:
            x = block(x)
        return self._head(self.final(x))
