"""Loss functions (port of ``train/losses.py``): f32 accumulation whatever
the activation dtype; an optional validity ``mask`` weights each example,
and the masked mean divides by ``max(mask.sum(), 1)``."""

import torch
import torch.nn.functional as F


def _mean(values, mask):
    if mask is not None:
        mask = mask.to(values.dtype)
        return (values * mask).sum() / torch.clamp_min(mask.sum(), 1)
    return values.mean()


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean cross-entropy of f32 ``logits`` (..., classes) against integer
    ``labels`` (...)."""
    logits = logits.float()
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             labels.reshape(-1).long(), reduction="none")
    return _mean(losses.reshape(labels.shape), mask)


def mse(preds, targets, mask=None):
    """Per-example mean squared error, then the (masked) mean over the
    leading axis."""
    errors = torch.square(preds.float() - targets.float())
    return _mean(errors.reshape(errors.shape[0], -1).mean(dim=-1), mask)


def accuracy(logits, labels, mask=None):
    hits = (logits.argmax(dim=-1) == labels).float()
    return _mean(hits, mask)
