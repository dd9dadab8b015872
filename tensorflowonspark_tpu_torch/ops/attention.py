"""Dense causal attention (port of ``ops/attention.py``'s dense subset).

All shapes are ``(batch, seq, heads, head_dim)``, as in the JAX package.
``segment_ids``: int32 ``(batch, seq)``; ``0`` marks padding, and a query
attends only to keys of its own nonzero segment. GQA/MQA: ``k``/``v`` may
carry fewer heads than ``q``, each K/V head serving a contiguous group of
query heads. The ring, Ulysses and flash variants belong to later slices.
"""

import math

import torch

_NEG_INF = -1e30


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
