"""Causal attention: dense, and the dispatcher over implementations (port
of ``ops/attention.py``'s dense subset and ``causal_attention``).

All shapes are ``(batch, seq, heads, head_dim)``, as in the JAX package.
``segment_ids``: int32 ``(batch, seq)``; ``0`` marks padding, and a query
attends only to keys of its own nonzero segment. GQA/MQA: ``k``/``v`` may
carry fewer heads than ``q``, each K/V head serving a contiguous group of
query heads. ``impl="pallas"`` routes to the port's flash kernels
(:mod:`.flash_attention`); the ring, ring-flash and Ulysses sequence-
parallel implementations are ROADMAP A10.
"""

import math

import torch

from tensorflowonspark_tpu_torch.ops import flash_attention

_NEG_INF = -1e30
_SEQUENCE_PARALLEL = ("ring", "ring_flash", "ulysses")


def check_impl(impl, ring_layout="contiguous"):
    """Raise unless ``impl``/``ring_layout`` name a ported route: the JAX
    package's ``ring_layout`` validation, then ``NotImplementedError`` for
    the sequence-parallel implementations and the zigzag layout (ROADMAP
    A10), ``ValueError`` for an unknown name."""
    if ring_layout not in ("contiguous", "zigzag"):
        raise ValueError(
            "ring_layout must be 'contiguous' or 'zigzag', got {!r}".format(
                ring_layout))
    if ring_layout == "zigzag" and impl != "ring_flash":
        raise ValueError(
            "ring_layout='zigzag' is a ring_flash schedule; impl {!r} "
            "does not consume it".format(impl))
    if impl in _SEQUENCE_PARALLEL or ring_layout == "zigzag":
        raise NotImplementedError(
            "attention impl {!r} (ring_layout {!r}) is sequence parallelism, "
            "not ported yet (ROADMAP A10)".format(impl, ring_layout))
    if impl not in ("dense", "pallas"):
        raise ValueError("unknown attention impl: {!r}".format(impl))


def causal_attention(q, k, v, impl="dense", segment_ids=None,
                     ring_layout="contiguous"):
    """Dispatch on implementation: ``"dense"`` (the full score matrix) or
    ``"pallas"`` (the flash kernels B1-B3, under the JAX package's name for
    its kernel route). The sequence-parallel implementations and the zigzag
    layout raise ``NotImplementedError`` (ROADMAP A10); the JAX package's
    ``ring_layout`` validation is kept."""
    check_impl(impl, ring_layout)
    if impl == "dense":
        return dense_causal_attention(q, k, v, segment_ids=segment_ids)
    return flash_attention.flash_causal_attention(
        q, k, v, segment_ids=segment_ids)


def _expand_kv(q, k, v):
    """GQA: broadcast ``h_kv`` K/V heads to ``h`` query heads (each K/V
    head repeated for its contiguous group, ``jnp.repeat`` order)."""
    h, h_kv = q.shape[2], k.shape[2]
    if h_kv == h:
        return k, v
    if h % h_kv:
        raise ValueError(
            "GQA needs query heads ({}) divisible by kv heads ({})".format(
                h, h_kv))
    reps = h // h_kv
    return (torch.repeat_interleave(k, reps, dim=2),
            torch.repeat_interleave(v, reps, dim=2))


def _segment_mask(q_seg, k_seg):
    """``(b, 1, s_q, s_k)`` bool: same nonzero segment."""
    same = q_seg[:, :, None] == k_seg[:, None, :]
    valid = (q_seg != 0)[:, :, None]
    return (same & valid)[:, None]


def dense_causal_attention(q, k, v, segment_ids=None):
    """Full (S, S) score matrix, f32 softmax.

    Scores are computed in the operand dtype and then upcast, masked with
    an explicit ``where`` at ``-1e30``; probabilities are cast back to the
    operand dtype for the PV product — the JAX reference's rounding points.
    """
    k, v = _expand_kv(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s_q, s_k = logits.shape[-2], logits.shape[-1]
    mask = torch.ones((s_q, s_k), dtype=torch.bool,
                      device=q.device).tril()[None, None]
    if segment_ids is not None:
        mask = mask & _segment_mask(segment_ids, segment_ids)
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if segment_ids is not None:
        # Padding queries: all-masked softmax rows are uniform noise; zero
        # them so padded positions contribute exact zeros downstream.
        out = out * (segment_ids != 0)[:, :, None, None].to(out.dtype)
    return out
