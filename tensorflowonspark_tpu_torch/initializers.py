"""flax's truncated-normal weight initializers, for the models and for the
ops that draw their own weights (``ops.fused_resnet_block.init_params``).

flax's ``he_normal`` (variance 2/fan_in) and ``lecun_normal`` (1/fan_in)
draw a normal cut at +-2 std whose std is widened by the truncated unit
normal's std, so that the drawn values keep the variance.
"""

import math

import torch

TRUNC_STD = 0.87962566103423978


def truncated_normal_(param, variance, gen):
    """Fill ``param`` in place from ``gen`` (a CPU ``torch.Generator``)."""
    std = math.sqrt(variance) / TRUNC_STD
    torch.nn.init.trunc_normal_(param, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=gen)
    return param
