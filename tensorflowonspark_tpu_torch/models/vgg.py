"""VGG 16/19 (port of ``models/vgg.py``; reference zoo
``examples/slim/nets/vgg.py``).

Thirteen (sixteen) SAME 3x3 convs with a bias in five stages, each stage
closed by a 2x2 max pool, then the NHWC flatten (as in ``models/cnn.py``)
and 4096-4096 ReLU dense layers with dropout 0.5 before the f32 head. The
names are flax's (``Conv_<i>``, ``Dense_<i>``). The flatten's width
depends on the image size, so the model takes ``image_size`` (default 224).
"""

import torch

from tensorflowonspark_tpu_torch.models import cnn, layers

_CFG = {
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
WIDTHS = (64, 128, 256, 512, 512)


class VGG(cnn._PlainNet):
    def __init__(self, depth=16, num_classes=1000, dtype=torch.bfloat16,
                 image_size=224, in_channels=3, *, device="cuda", seed=0):
        self.depth = depth
        super().__init__(num_classes, dtype, image_size, in_channels,
                         (4096, 4096), 0.5, device, seed)

    def _build_body(self, cin, s):
        self.body = []
        for width, reps in zip(WIDTHS, _CFG[self.depth]):
            for _ in range(reps):
                self.body.append(self.sub(cnn._conv(cin, width, 3,
                                                    self.dtype)))
                cin = width
            self.body.append((2, 2, "VALID"))
            s = layers.out_size(s, 2, 2, "VALID")
        return s, cin


def VGG16(**kw):
    return VGG(depth=16, **kw)


def VGG19(**kw):
    return VGG(depth=19, **kw)
