"""Causal attention: dense, the sequence-parallel implementations, and
the dispatcher over them (port of ``ops/attention.py``).

All shapes are ``(batch, seq, heads, head_dim)``, as in the JAX package.
``segment_ids``: int32 ``(batch, seq)``; ``0`` marks padding, and a query
attends only to keys of its own nonzero segment. GQA/MQA: ``k``/``v`` may
carry fewer heads than ``q``, each K/V head serving a contiguous group of
query heads. ``impl="pallas"`` routes to the port's flash kernels
(:mod:`.flash_attention`).

Sequence parallelism runs over the ``seq`` process group of the mesh
(:mod:`tensorflowonspark_tpu_torch.parallel.mesh`); each rank holds its
own chunk of the sequence, as each device of the JAX ``shard_map`` does:

* ``ring`` (:func:`ring_causal_attention`): K/V blocks travel the ring
  through the differentiable ``ppermute`` and fold into an online softmax
  in f32, dense, one block a step; a future block is skipped;
* ``ulysses`` (:func:`ulysses_causal_attention`): two all-to-alls trade
  the sequence sharding for a head sharding around dense local attention;
* ``ring_flash`` (:func:`ring_flash_attention`): the ring with the flash
  kernels B1-B3 as the per-block engine — step 0 causal over the local
  chunk, later steps non-causal over the visible blocks, merged by their
  logsumexps (:func:`_lse_combine`); ``layout="zigzag"`` is the balanced
  schedule over :func:`zigzag_layout`'s stripes.

The backward of each is autograd through the collectives' transposes and
the flash kernels' ``(out, lse)`` backward, as in JAX; no ring-level VJP.
A ring anchors its last received blocks in the output
(:func:`~tensorflowonspark_tpu_torch.parallel.collectives.anchor`), so
every rank runs every ring step's backward exchange, also where its fold
skipped a block. A seq group of size 1 (or none) falls back to dense
attention, as the JAX dispatcher does.

``dense`` and ``pallas`` under a seq group of size ``n > 1``
(:func:`gathered_causal_attention`) attend over the whole row, as XLA's
partitioner runs the JAX package's dense and flash routes under a seq
axis: dense gathers K and V and masks causally from the chunk's start;
the flash route gathers Q, K and V, runs B1-B3 over the whole row and
keeps the rank's rows (each rank computes the whole row: ``n``-fold work).
"""

import math

import torch

from tensorflowonspark_tpu_torch.ops import flash_attention
from tensorflowonspark_tpu_torch.parallel import collectives as coll

_NEG_INF = -1e30
_SEQUENCE_PARALLEL = ("ring", "ring_flash", "ulysses")


def check_impl(impl, ring_layout="contiguous"):
    """Raise unless ``impl``/``ring_layout`` name a ported route: the JAX
    package's ``ring_layout`` validation, ``ValueError`` for an unknown
    name."""
    if ring_layout not in ("contiguous", "zigzag"):
        raise ValueError(
            "ring_layout must be 'contiguous' or 'zigzag', got {!r}".format(
                ring_layout))
    if ring_layout == "zigzag" and impl != "ring_flash":
        raise ValueError(
            "ring_layout='zigzag' is a ring_flash schedule; impl {!r} "
            "does not consume it".format(impl))
    if impl not in ("dense", "pallas") + _SEQUENCE_PARALLEL:
        raise ValueError("unknown attention impl: {!r}".format(impl))


def seq_group(mesh=None):
    """The process group of the mesh's sequence axes (the ambient mesh
    when ``mesh`` is None); None without one or at size 1."""
    from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh or mesh_lib.current_mesh()
    if mesh is None:
        return None
    (entry,) = mesh_lib.resolve_spec(mesh.shape, ("sequence",),
                                     mesh_lib.active_rules())
    return mesh.group(*mesh_lib.spec_axes(entry))


def seq_axis_size(mesh=None):
    """The ring size :func:`causal_attention` runs with: the size of the
    ambient mesh's seq group (1 without one, the dense-fallback regime).
    The model applies the matching :func:`zigzag_layout` to positions."""
    return coll.size(seq_group(mesh))


def causal_attention(q, k, v, impl="dense", segment_ids=None,
                     ring_layout="contiguous", group=None):
    """Dispatch on implementation: ``"dense"``, ``"pallas"`` (the flash
    kernels B1-B3), or the sequence-parallel ``"ring"``, ``"ring_flash"``
    and ``"ulysses"`` over ``group`` (default: the ambient mesh's seq
    group). With no seq group, or one of size 1, the sequence-parallel
    routes fall back to dense, as the JAX dispatcher does; a one-rank
    zigzag permutation is the identity. Under a larger seq group
    ``"dense"`` and ``"pallas"`` attend over the whole row
    (:func:`gathered_causal_attention`)."""
    check_impl(impl, ring_layout)
    group = group if group is not None else seq_group()
    if coll.size(group) > 1 and impl in ("dense", "pallas"):
        return gathered_causal_attention(q, k, v, group, impl, segment_ids)
    if impl == "pallas":
        return flash_attention.flash_causal_attention(
            q, k, v, segment_ids=segment_ids)
    if impl == "dense" or coll.size(group) == 1:
        return dense_causal_attention(q, k, v, segment_ids=segment_ids)
    if impl == "ring":
        return ring_causal_attention(q, k, v, group, segment_ids)
    if impl == "ulysses":
        return ulysses_causal_attention(q, k, v, group, segment_ids)
    return ring_flash_attention(q, k, v, group, segment_ids,
                                layout=ring_layout)


def head_major_attention(q, k, v, segment_ids=None, group=None):
    """The flash route on head-major operands (``q`` (b, h, s, d),
    ``k``/``v`` (b, h_kv, s, d), the projections' zero-relayout layout),
    over the whole row under a seq group (default the ambient mesh's) of
    size > 1."""
    group = group if group is not None else seq_group()
    if coll.size(group) > 1:
        return gathered_causal_attention(q, k, v, group, "pallas",
                                         segment_ids, head_major=True)
    return flash_attention.flash_attention_head_major(
        q, k, v, segment_ids=segment_ids)


def gathered_causal_attention(q, k, v, group, impl="dense",
                              segment_ids=None, head_major=False):
    """Causal attention over the whole row from this rank's chunk of it,
    for the routes that ride no ring: ``impl="dense"`` gathers K and V
    along the sequence over ``group`` (:func:`~.collectives.all_gather`,
    whose backward reduce-scatters the cotangents) and the segment ids,
    and attends from the local queries with the causal mask offset by the
    chunk's start. ``impl="pallas"``: B1-B3 take no query offset, so Q is
    gathered too, the kernels run over the whole row, and the rank keeps
    its rows; every rank of the group computes the whole row's attention.
    ``head_major``: (b, h, s, d) operands (the flash route only)."""
    idx = coll.rank(group)
    dim = 2 if head_major else 1
    s_local = q.shape[dim]
    row_segments = (None if segment_ids is None
                    else coll.gather_cat(segment_ids.contiguous(), group, 1))
    k_row = coll.all_gather(k, group, dim)
    v_row = coll.all_gather(v, group, dim)
    if impl == "dense":
        return dense_causal_attention(q, k_row, v_row, segment_ids,
                                      kv_segment_ids=row_segments,
                                      q_offset=idx * s_local)
    q_row = coll.all_gather(q, group, dim)
    if head_major:
        out = flash_attention.flash_attention_head_major(
            q_row, k_row, v_row, segment_ids=row_segments)
    else:
        out = flash_attention.flash_causal_attention(
            q_row, k_row, v_row, segment_ids=row_segments)
    return out.narrow(dim, idx * s_local, s_local)


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


def dense_causal_attention(q, k, v, segment_ids=None, kv_segment_ids=None,
                           q_offset=0):
    """Full (S, S) score matrix, f32 softmax.

    Scores are computed in the operand dtype and then upcast, masked with
    an explicit ``where`` at ``-1e30``; probabilities are cast back to the
    operand dtype for the PV product — the JAX reference's rounding points.
    ``q_offset``: the queries' position in the keys' row (a sequence
    chunk's start), with the keys' own segment ids in ``kv_segment_ids``.
    """
    k, v = _expand_kv(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s_q, s_k = logits.shape[-2], logits.shape[-1]
    mask = torch.ones((s_q, s_k), dtype=torch.bool,
                      device=q.device).tril(q_offset)[None, None]
    if segment_ids is not None:
        mask = mask & _segment_mask(
            segment_ids,
            segment_ids if kv_segment_ids is None else kv_segment_ids)
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if segment_ids is not None:
        # Padding queries: all-masked softmax rows are uniform noise; zero
        # them so padded positions contribute exact zeros downstream.
        out = out * (segment_ids != 0)[:, :, None, None].to(out.dtype)
    return out


def ulysses_causal_attention(q, k, v, group, segment_ids=None):
    """All-to-all head-scattering sequence parallelism (the JAX
    ``ulysses_causal_attention``). ``q``/``k``/``v`` are this rank's chunk
    ``(b, S/n, h, d)``; the first all-to-all gives each rank the full
    sequence for ``h/n`` heads, dense attention runs on them, and the
    second all-to-all restores the sequence sharding. Q heads, and under
    GQA K/V heads, must divide the group's size. ``segment_ids`` (this
    chunk's) are all-gathered: every rank needs the full row."""
    n = coll.size(group)
    if n == 1:
        return dense_causal_attention(q, k, v, segment_ids=segment_ids)
    h, h_kv = q.shape[2], k.shape[2]
    if h % n or (h_kv != h and h_kv % n):
        raise ValueError(
            "ulysses attention needs heads ({}/{}) divisible by the {} axis "
            "({})".format(h, h_kv, "seq", n))
    full_segments = (None if segment_ids is None
                     else coll.gather_cat(segment_ids.contiguous(), group, 1))
    out = dense_causal_attention(
        coll.all_to_all(q, group, 2, 1), coll.all_to_all(k, group, 2, 1),
        coll.all_to_all(v, group, 2, 1), segment_ids=full_segments)
    return coll.all_to_all(out, group, 1, 2)


def ring_causal_attention(q, k, v, group, segment_ids=None):
    """Blockwise causal attention over the ring of ``group`` (the JAX
    ``ring_causal_attention``): this rank's chunk of Q stays, K/V (and the
    K-side segment ids) make a full trip around the ring in ``n - 1``
    ``ppermute`` steps, and each held block folds into f32 online-softmax
    accumulators unless it is a future chunk. GQA blocks travel at their
    narrow width and expand per fold."""
    n, idx = coll.size(group), coll.rank(group)
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            "GQA needs query heads ({}) divisible by kv heads ({})".format(
                q.shape[2], k.shape[2]))
    reps = q.shape[2] // k.shape[2]
    b, s_q, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    q32 = q.float()
    m = torch.full((b, h, s_q), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s_q), dtype=torch.float32, device=dev)
    o = torch.zeros((b, h, s_q, d), dtype=torch.float32, device=dev)
    q_pos = idx * s_q + torch.arange(s_q, device=dev)
    q_seg = segment_ids
    k_blk, v_blk, k_seg = k, v, q_seg
    for i in range(n):
        if i:
            k_blk, v_blk = coll.ppermute([k_blk, v_blk], group)
            if k_seg is not None:
                (k_seg,) = coll.shift([k_seg], group)
        src = (idx - i) % n
        if src > idx:
            # A future chunk: fully causally masked, skipped.
            continue
        kb, vb = k_blk, v_blk
        if reps > 1:
            kb = torch.repeat_interleave(kb, reps, dim=2)
            vb = torch.repeat_interleave(vb, reps, dim=2)
        k_pos = src * kb.shape[1] + torch.arange(kb.shape[1], device=dev)
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, kb.float()) * scale
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        if q_seg is not None:
            mask = mask & _segment_mask(q_seg, k_seg)
        logits = torch.where(mask, logits, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               vb.float())
        m = m_new
    out = o / torch.clamp_min(l[..., None], 1e-30)
    out = coll.anchor(out.transpose(1, 2).to(q.dtype), k_blk, v_blk)
    if q_seg is not None:
        out = out * (q_seg != 0)[:, :, None, None].to(out.dtype)
    return out


def _zigzag_order(n):
    """Stripe order of the zigzag layout: rank d's chunk is stripes
    (d, 2n-1-d). One definition serves layout and restore."""
    order = []
    for d in range(n):
        order.extend([d, 2 * n - 1 - d])
    return order


def zigzag_layout(x, num_devices, axis=1):
    """Reorder a GLOBAL sequence axis into the zigzag layout: with ``2n``
    equal stripes, rank ``d``'s contiguous chunk holds stripes ``d`` and
    ``2n-1-d``, so every ring step carries the same visible work on every
    rank. Apply to tokens, targets, segment ids and masks before they are
    cut into chunks; :func:`zigzag_restore` inverts. Works on tensors and
    numpy arrays."""
    n = int(num_devices)
    s = x.shape[axis]
    if s % (2 * n):
        raise ValueError(
            "sequence length {} must be divisible by 2 x num_devices "
            "({})".format(s, 2 * n))
    return _stripes(x, axis, 2 * n, _zigzag_order(n))


def zigzag_restore(x, num_devices, axis=1):
    """Inverse of :func:`zigzag_layout`."""
    n = int(num_devices)
    order = _zigzag_order(n)
    inverse = [0] * (2 * n)
    for pos, stripe in enumerate(order):
        inverse[stripe] = pos
    return _stripes(x, axis, 2 * n, inverse)


def _stripes(x, axis, count, order):
    size = x.shape[axis] // count
    parts = []
    for i in order:
        index = [slice(None)] * x.ndim
        index[axis] = slice(i * size, (i + 1) * size)
        parts.append(x[tuple(index)])
    if isinstance(x, torch.Tensor):
        return torch.cat(parts, dim=axis)
    import numpy as np

    return np.concatenate(parts, axis=axis)


def _lse_combine(out_acc, lse_acc, out_i, lse_i):
    """Exact merge of two normalized partial attentions over disjoint KV
    sets via their logsumexps; ``out`` (b, s, h, d), ``lse`` (b, h, s)."""
    lse_new = torch.logaddexp(lse_acc, lse_i)
    w_acc = torch.exp(lse_acc - lse_new)
    w_i = torch.exp(lse_i - lse_new)
    out_new = (out_acc * w_acc.transpose(1, 2)[..., None]
               + out_i.float() * w_i.transpose(1, 2)[..., None])
    return out_new, lse_new


def ring_flash_attention(q, k, v, group, segment_ids=None, block_q=None,
                         block_k=None, layout="contiguous"):
    """Ring attention with the flash kernels as the per-block engine (the
    JAX ``ring_flash_attention``): step 0 runs the causal kernel on the
    local chunk; after ``i`` ring steps the held block came from rank
    ``idx - i`` and is folded with the non-causal kernel, with the K
    segment ids beside it, when ``idx >= i`` (an earlier chunk) and
    skipped otherwise. Partial outputs merge through their logsumexps.
    Each fold is one :func:`~.flash_attention.flash_attention_with_lse`
    call: B1 forward, B2 and B3 in its backward. ``layout="zigzag"``
    takes chunks laid out by :func:`zigzag_layout`."""
    if layout == "zigzag":
        return _ring_flash_zigzag(q, k, v, group, segment_ids, block_q,
                                  block_k)
    if layout != "contiguous":
        raise ValueError("layout must be 'contiguous' or 'zigzag'")
    fa = flash_attention.flash_attention_with_lse
    n, idx = coll.size(group), coll.rank(group)
    q_seg = segment_ids
    out, lse = fa(q, k, v, segment_ids=q_seg, block_q=block_q,
                  block_k=block_k, causal=True)
    out = out.float()
    k_blk, v_blk, k_seg = k, v, q_seg
    for i in range(1, n):
        k_blk, v_blk = coll.ppermute([k_blk, v_blk], group)
        if k_seg is not None:
            (k_seg,) = coll.shift([k_seg], group)
        if idx >= i:
            out_i, lse_i = fa(q, k_blk, v_blk, segment_ids=q_seg,
                              kv_segment_ids=k_seg, block_q=block_q,
                              block_k=block_k, causal=False)
            out, lse = _lse_combine(out, lse, out_i, lse_i)
    out = coll.anchor(out.to(q.dtype), k_blk, v_blk)
    if q_seg is not None:
        out = out * (q_seg != 0)[:, :, None, None].to(out.dtype)
    return out


def _ring_flash_zigzag(q, k, v, group, segment_ids, block_q, block_k):
    """Zigzag-layout ring flash attention (the JAX ``_ring_flash_zigzag``).

    The local chunk is ``[stripe_lo, stripe_hi]``, global stripes ``(idx,
    2n-1-idx)``. Step 0: ``q_lo`` causal over ``k_lo``, ``q_hi`` causal over
    ``k_hi`` and full over ``k_lo``. After ``i`` steps the held pair came
    from ``src = (idx - i) mod n``: when ``src < idx`` its low stripe is
    visible to both local stripes (``q_lo x k_lo``, ``q_hi x k_lo``), else
    the whole pair is visible to the high stripe only (``q_hi x k_lo``,
    ``q_hi x k_hi``). Two stripe-sized kernel calls a step on every rank."""
    fa = flash_attention.flash_attention_with_lse
    n, idx = coll.size(group), coll.rank(group)
    s_local = q.shape[1]
    if s_local % 2:
        raise ValueError("zigzag chunks hold two stripes; got odd length")
    c = s_local // 2
    q_seg = segment_ids

    def half(x, lo):
        if x is None:
            return None
        return x[:, :c] if lo else x[:, c:]

    def call(q_lo, k_src, v_src, k_seg_src, k_lo, causal):
        return fa(half(q, q_lo), half(k_src, k_lo), half(v_src, k_lo),
                  segment_ids=half(q_seg, q_lo),
                  kv_segment_ids=None if causal else half(k_seg_src, k_lo),
                  block_q=block_q, block_k=block_k, causal=causal)

    out_lo, lse_lo = call(True, k, v, q_seg, True, True)
    out_hi_a, lse_hi_a = call(False, k, v, q_seg, False, True)
    out_hi_b, lse_hi_b = call(False, k, v, q_seg, True, False)
    out_hi, lse_hi = _lse_combine(out_hi_a.float(), lse_hi_a, out_hi_b,
                                  lse_hi_b)
    out = torch.cat([out_lo.float(), out_hi], dim=1)
    lse = torch.cat([lse_lo, lse_hi], dim=2)
    k_blk, v_blk, k_seg = k, v, q_seg
    for i in range(1, n):
        k_blk, v_blk = coll.ppermute([k_blk, v_blk], group)
        if k_seg is not None:
            (k_seg,) = coll.shift([k_seg], group)
        src = (idx - i) % n
        if src < idx:
            out_a, lse_a = call(True, k_blk, v_blk, k_seg, True, False)
            out_b, lse_b = call(False, k_blk, v_blk, k_seg, True, False)
            lo_out, lo_lse = _lse_combine(out[:, :c], lse[:, :, :c], out_a,
                                          lse_a)
            hi_out, hi_lse = _lse_combine(out[:, c:], lse[:, :, c:], out_b,
                                          lse_b)
        else:
            out_a, lse_a = call(False, k_blk, v_blk, k_seg, True, False)
            out_b, lse_b = call(False, k_blk, v_blk, k_seg, False, False)
            hi_out, hi_lse = _lse_combine(out[:, c:], lse[:, :, c:], out_a,
                                          lse_a)
            hi_out, hi_lse = _lse_combine(hi_out, hi_lse, out_b, lse_b)
            lo_out, lo_lse = out[:, :c], lse[:, :, :c]
        out = torch.cat([lo_out, hi_out], dim=1)
        lse = torch.cat([lo_lse, hi_lse], dim=2)
    out = coll.anchor(out.to(q.dtype), k_blk, v_blk)
    if q_seg is not None:
        out = out * (q_seg != 0)[:, :, None, None].to(out.dtype)
    return out


def ring_flash_launches(n, layout="contiguous"):
    """B1 launches of one ``ring_flash`` call a rank, by rank index: the
    schedule above (contiguous: 1 + the earlier chunks; zigzag: 3 + 2 a
    later step on every rank). B2 and B3 launch as often in the
    backward."""
    if layout == "zigzag":
        return [3 + 2 * (n - 1)] * n
    return [1 + idx for idx in range(n)]
