"""MLP and linear regression (port of ``models/mlp.py``).

The JAX modules infer their input width at ``init``; a PyTorch module owns
its weights from construction, so the port's take ``in_features``. Layers
are named and laid out as flax's: ``Dense_<i>.kernel`` (in, out) and
``Dense_<i>.bias``, so ``convert.dense_params_from_flax`` is a renaming.
Weights are drawn with flax's initializers (``he_normal`` for the hidden
layers, ``lecun_normal`` for the head, zero biases) from a
``torch.Generator`` seeded with ``seed``.
"""

import torch
from torch import nn

from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch.initializers import truncated_normal_
from tensorflowonspark_tpu_torch.models.layers import Dense


class _DenseStack(nn.Module):
    def _finish(self, device, seed):
        """Draw the weights, move to ``device``, and start in eval mode (as
        the port's other models do)."""
        self.reset_parameters(seed)
        self.to(device_info.resolve_device(device))
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, seed):
        """Kernels from flax's initializers, biases zero."""
        gen = torch.Generator().manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, Dense):
                truncated_normal_(module.kernel,
                                  module.fan_scale / module.kernel.shape[0],
                                  gen)
                module.bias.zero_()

    @property
    def device(self):
        return self.Dense_0.kernel.device


class MLP(_DenseStack):
    """Hidden ReLU layers in ``dtype`` (bf16 by default) and an f32 head:
    ``x`` (B, ...) flattened to (B, in_features) -> logits (B,
    num_classes)."""

    def __init__(self, in_features=784, features=(128,), num_classes=10,
                 dtype=torch.bfloat16, *, device="cuda", seed=0):
        super().__init__()
        self.features = tuple(features)
        self.num_classes = num_classes
        self.dtype = dtype
        width = in_features
        for i, out in enumerate(self.features):
            self.add_module("Dense_{}".format(i),
                            Dense(width, out, dtype, fan_scale=2.0))
            width = out
        self.add_module("Dense_{}".format(len(self.features)),
                        Dense(width, num_classes, torch.float32))
        self._finish(device, seed)

    def forward(self, x):
        x = torch.as_tensor(x, device=self.device)
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(len(self.features)):
            x = torch.relu(getattr(self, "Dense_{}".format(i))(x))
        return getattr(self, "Dense_{}".format(len(self.features)))(x)


class LinearRegression(_DenseStack):
    """``y = xW + b`` in f32: (B, in_features) -> (B, 1)."""

    def __init__(self, in_features=2, *, device="cuda", seed=0):
        super().__init__()
        self.Dense_0 = Dense(in_features, 1, torch.float32)
        self._finish(device, seed)

    def forward(self, x):
        return self.Dense_0(torch.as_tensor(x, device=self.device))
