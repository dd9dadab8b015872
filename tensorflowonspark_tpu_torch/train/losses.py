"""Loss functions (port of ``train/losses.py``): f32 accumulation whatever
the activation dtype; an optional validity ``mask`` weights each example,
and the masked mean divides by ``max(mask.sum(), 1)``.

Sharded training adds :func:`vocab_parallel_cross_entropy`, the
cross-entropy of logits whose vocabulary is split over a tensor group
(the weight-tied head's slabs), and :func:`global_masked_mean`, the masked
mean over every rank's examples."""

import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.parallel import collectives as coll


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


def vocab_parallel_cross_entropy(logits, labels, group, vocab_start,
                                 mask=None):
    """:func:`softmax_cross_entropy` of logits split over ``group`` along
    the vocabulary: this rank holds columns ``[vocab_start, vocab_start +
    logits.shape[-1])``. The row maximum and the sum of exponentials are
    reduced over the group (max, then sum; the maximum carries no
    gradient), and so is the label's logit, which lives on one rank. The
    sums' backward is the identity: every rank of a tensor group computes
    the same loss, and the gradient of its own columns comes out as
    ``softmax - onehot`` there. Never materializes the full logits."""
    logits = logits.float()
    local_max = logits.amax(dim=-1).detach()
    row_max = coll.max_(local_max.clone(), group)
    shifted = logits - row_max[..., None]
    sum_exp = coll.reduce_from_group(shifted.exp().sum(dim=-1), group)
    local = labels.long() - vocab_start
    here = (local >= 0) & (local < logits.shape[-1])
    picked = shifted.gather(-1, local.clamp(0, logits.shape[-1] - 1)
                            [..., None])[..., 0]
    label_logit = coll.reduce_from_group(picked * here, group)
    return _mean(torch.log(sum_exp) - label_logit, mask)


def global_masked_mean(local_sum, local_weight, group):
    """``(sum over group of local_sum) / max(sum of local_weight, 1)``:
    the masked mean over every rank's examples, from each rank's masked
    sum and mask sum (plain sums; no gradient)."""
    both = torch.stack([local_sum.detach().float(),
                        local_weight.detach().float()])
    coll.sum_(both, group)
    return both[0] / torch.clamp_min(both[1], 1.0)
