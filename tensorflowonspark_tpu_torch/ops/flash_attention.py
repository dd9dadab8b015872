"""Flash attention, forward and backward: CUDA kernel wrappers, their plain
versions, and the differentiable entry points (port of
``ops/flash_attention.py``).

Three hand-written CUDA kernels in ``csrc/flash_attention.cu`` replace the
three Pallas kernels of the JAX package:

* ``flash_forward`` — B1, ``_flash_fwd_kernel``
  (``tensorflowonspark_tpu/ops/flash_attention.py:127``): blockwise
  online-softmax attention, causal or full, with segment masks, padded-block
  skipping and GQA; emits ``out`` and the f32 row logsumexp ``lse``;
* ``flash_bwd_dq`` — B2, ``_flash_bwd_dq_kernel`` (``:195``):
  ``dQ = scale * (P * (dO V^T - delta)) K`` with ``P`` recomputed from
  ``lse``;
* ``flash_bwd_dkv`` — B3, ``_flash_bwd_dkv_kernel`` (``:256``):
  ``dV = sum P^T dO`` and ``dK = scale * sum dS^T Q`` over the Q blocks at
  or after each K block, summed over the GQA group in f32.

``delta = rowsum(dO * O)`` (minus the lse cotangent) is one plain reduction
outside the kernels, as in the JAX package (``:530-538``).

Bound. At the training shapes (s 1024, d 64, bf16, causal) each call's
least work sits near the H100's ridge point: 250-300 FLOP per byte moved
against the card's 295, so the bytes bound B1 and B3 (whose f32 dK/dV
writes double its output) and the bf16 tensor-core rate bounds B2 — some
0.015-0.03 ms each. In bf16, all three keep their products in registers
(``mma.sync``) and stream tiles through a two-stage ``cp.async`` ring; the
f32 kernels stage tiles in shared memory and multiply with plain f32 FMAs
(``csrc/flash_attention.cu`` says more).

Lengths. Each kernel bounds its loops by ``q_len``/``k_len``, the tokens
through each row's last non-padding one. One attention call computes them
once (:func:`_lengths`) and its backward reuses them; a wrapper called
alone computes its own.

Layout. The kernels take head-major tensors: ``q``/``out`` ``(b, h, s, d)``
and ``k``/``v`` ``(b, h_kv, s, d)``, contiguous, ``d`` innermost. The JAX
package streams K/V in a transposed ``(b*h_kv, d, s)`` layout
(``flash_attention_folded``) only because the TPU's DMA engine needs
lane-dimension slices aligned to its 128 tiling (module docstring there,
``:16-20``); a CUDA block loads ``d``-contiguous rows with 16-byte loads, so
that layout is not carried over. The model calls
:func:`flash_attention_head_major`; :func:`flash_causal_attention` and
:func:`flash_attention_with_lse` keep the JAX package's ``(batch, seq,
heads, head_dim)`` signatures and transpose around the same core.

Numerics follow the Pallas kernels: score products accumulate in f32 from
the operand dtype and the scale multiplies in f32 (unlike the paged decode
step, scores are not rounded to the model dtype); masking is an explicit
``where`` at ``-1e30``; ``P`` and ``dS`` are cast to the operand dtype
before their products; ``l`` is floored at ``1e-30``, so a fully padded
query row gives ``out = 0``, ``lse = -1e30 + log(1e-30)`` and zero
gradients. ``segment_ids``: int32 ``(b, s)``, 0 = padding; a query attends
to keys of its own nonzero segment.

Routes. Each wrapper runs its plain version (``*_reference``, the same
blockwise arithmetic in PyTorch) only for tensors that lie on the CPU; for
CUDA tensors it launches its kernel or raises. The kernels tile 64 x 64
and take ``head_dim`` 32, 64 or 128 (:data:`KERNEL_HEAD_DIMS`) in f32 or
bf16; the plain versions take any block sizes and head width. The plain
versions walk every K (or Q) block under the masks, where the kernels skip
blocks outside the causal and valid ranges: a fully masked block leaves
``m``, ``l`` and the accumulators exactly as they were, so both give the
same values.
"""

import ctypes
import math

import numpy as np
import torch

_NEG_INF = -1e30

# The kernels' tile: BLOCK query rows by BLOCK key rows, and the head
# widths they are built for. The plain versions default to the same tile,
# so on the same inputs both chunk the online softmax identically.
BLOCK = 64
KERNEL_HEAD_DIMS = (32, 64, 128)

# Kernel launches since the last reset, per kernel — the counts a caller
# reads to show that a path really went through the kernels.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _scale(d):
    # The JAX kernels' ``1.0 / math.sqrt(d)``, applied to f32 scores.
    return float(np.float32(1.0 / math.sqrt(d)))


def _valid_len(seg):
    """(b,) int32: tokens through each row's last non-padding token (the
    JAX ``_valid_blocks`` before the division)."""
    pos = torch.arange(1, seg.shape[1] + 1, dtype=torch.int32,
                       device=seg.device)
    return torch.where(seg != 0, pos, 0).amax(dim=1).to(torch.int32)


def _lengths(q_seg, k_seg):
    """``(q_len, k_len)`` for the kernels: :func:`_valid_len` of each side,
    once when both sides share one segment tensor."""
    q_len = _valid_len(q_seg)
    return q_len, (q_len if k_seg is q_seg else _valid_len(k_seg))


def _group_view(x, h_kv):
    """(b, h, s, d) -> (b, h_kv, grp, s, d): query heads by K/V head (the
    contiguous groups of ``jnp.repeat`` order)."""
    b, h, s, d = x.shape
    return x.reshape(b, h_kv, h // h_kv, s, d)


def _mask(q_pos, k_pos, q_seg, k_seg, causal):
    """(b, 1, 1, s_q, s_k) bool: same nonzero segment, and causal if set.
    ``q_pos``/``k_pos`` are position vectors, ``q_seg``/``k_seg`` (b, s)."""
    mask = (q_seg[:, :, None] == k_seg[:, None, :]) & (q_seg != 0)[:, :, None]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    return mask[:, None, None]


def flash_forward_reference(q, k, v, q_seg, k_seg, *, causal=True,
                            block_k=BLOCK):
    """Plain version of B1: the online-softmax walk over K blocks of
    ``block_k`` keys. Returns ``(out (b, h, s_q, d) in q's dtype, lse
    (b, h, s_q) f32)``."""
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    scale = _scale(d)
    qf = _group_view(q, h_kv).float()
    m = torch.full(qf.shape[:-1], _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    q_pos = torch.arange(s_q, device=q.device)
    for k0 in range(0, s_k, block_k):
        k1 = min(k0 + block_k, s_k)
        kb = k[:, :, None, k0:k1].float()
        vb = v[:, :, None, k0:k1]
        mask = _mask(q_pos, torch.arange(k0, k1, device=q.device), q_seg,
                     k_seg[:, k0:k1], causal)
        scores = torch.where(mask, (qf @ kb.transpose(-1, -2)) * scale,
                             _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = p.to(v.dtype).float() @ vb.float()
        acc = acc * corr[..., None] + pv
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = (acc / l_safe[..., None]).to(q.dtype).reshape(b, h, s_q, d)
    lse = (m + torch.log(l_safe)).reshape(b, h, s_q)
    return out, lse


def flash_bwd_dq_reference(q, k, v, do, lse, delta, q_seg, k_seg, *,
                           causal=True, block_k=BLOCK):
    """Plain version of B2: dQ accumulated in f32 over K blocks, in q's
    dtype."""
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    scale = _scale(d)
    qf = _group_view(q, h_kv).float()
    dof = _group_view(do, h_kv).float()
    lse5 = lse.reshape(b, h_kv, h // h_kv, s_q, 1)
    delta5 = delta.reshape(b, h_kv, h // h_kv, s_q, 1)
    acc = torch.zeros_like(qf)
    q_pos = torch.arange(s_q, device=q.device)
    for k0 in range(0, s_k, block_k):
        k1 = min(k0 + block_k, s_k)
        kb = k[:, :, None, k0:k1].float()
        vb = v[:, :, None, k0:k1].float()
        mask = _mask(q_pos, torch.arange(k0, k1, device=q.device), q_seg,
                     k_seg[:, k0:k1], causal)
        scores = (qf @ kb.transpose(-1, -2)) * scale
        p = torch.where(mask, torch.exp(scores - lse5), 0.0)
        dp = dof @ vb.transpose(-1, -2)
        ds = p * (dp - delta5)
        acc = acc + ds.to(k.dtype).float() @ kb
    return (acc * scale).to(q.dtype).reshape(b, h, s_q, d)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, q_seg, k_seg, *,
                            causal=True, block_q=BLOCK):
    """Plain version of B3: per query head, dK and dV accumulated in f32
    over Q blocks of ``block_q`` rows (in K-major, transposed space); then
    the group's members summed in order. Returns f32 ``(dk, dv)``, each
    (b, h_kv, s_k, d)."""
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    grp = h // h_kv
    scale = _scale(d)
    qg, dog = _group_view(q, h_kv), _group_view(do, h_kv)
    lse4 = lse.reshape(b, h_kv, grp, s_q)
    delta4 = delta.reshape(b, h_kv, grp, s_q)
    kf = k[:, :, None].float()
    vf = v[:, :, None].float()
    dk = torch.zeros((b, h_kv, grp, s_k, d), dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)
    k_pos = torch.arange(s_k, device=q.device)
    for q0 in range(0, s_q, block_q):
        q1 = min(q0 + block_q, s_q)
        qb, dob = qg[..., q0:q1, :], dog[..., q0:q1, :]
        # (b, 1, 1, s_k, bq): the forward mask, transposed.
        mask = _mask(torch.arange(q0, q1, device=q.device), k_pos,
                     q_seg[:, q0:q1], k_seg, causal).transpose(-1, -2)
        scores_t = (kf @ qb.float().transpose(-1, -2)) * scale
        p_t = torch.where(mask, torch.exp(scores_t - lse4[..., None, q0:q1]),
                          0.0)
        dv = dv + p_t.to(do.dtype).float() @ dob.float()
        dp_t = vf @ dob.float().transpose(-1, -2)
        ds_t = p_t * (dp_t - delta4[..., None, q0:q1])
        dk = dk + ds_t.to(q.dtype).float() @ qb.float()
    dk_sum, dv_sum = dk[:, :, 0] * scale, dv[:, :, 0]
    for g in range(1, grp):
        dk_sum = dk_sum + dk[:, :, g] * scale
        dv_sum = dv_sum + dv[:, :, g]
    return dk_sum, dv_sum


# -- wrappers ------------------------------------------------------------------


def _check_shapes(q, k, v, q_seg, k_seg, causal, do=None, lse=None,
                  delta=None):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (b, h, s, d) and k/v one (b, h_kv, s, d) "
                         "shape")
    b, h, s_q, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("q {} and k {} disagree on batch or head_dim".format(
            tuple(q.shape), tuple(k.shape)))
    if h % k.shape[1]:
        raise ValueError(
            "GQA needs query heads ({}) divisible by kv heads ({})".format(
                h, k.shape[1]))
    if causal and k.shape[2] != s_q:
        raise ValueError(
            "causal attention needs matching q/k lengths (got {} vs {}); "
            "rectangular attention is non-causal".format(s_q, k.shape[2]))
    if q_seg.shape != (b, s_q) or k_seg.shape != (b, k.shape[2]):
        raise ValueError("segment ids must be (b, s_q) and (b, s_k)")
    if do is not None and (do.shape != q.shape or lse.shape != (b, h, s_q)
                           or delta.shape != (b, h, s_q)):
        raise ValueError("do must be shaped like q, and lse and delta (b, "
                         "h, s_q)")


def _check_kernel(name, tensors, float_tensors, seg_tensors, block_q,
                  block_k):
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError("{} runs on CPU tensors (plain version) or CUDA "
                         "tensors (the kernel); got {}".format(name, q.device))
    if q.dtype not in _DTYPE_CODES:
        raise ValueError("{} kernel takes f32 or bf16; got {}".format(
            name, q.dtype))
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError("{} kernel is built for head_dim {}; got {}".format(
            name, " or ".join(map(str, KERNEL_HEAD_DIMS)), q.shape[-1]))
    for blk in (block_q, block_k):
        if blk is not None and blk != BLOCK:
            raise ValueError("{} kernel tiles {} x {}; got block size "
                             "{}".format(name, BLOCK, BLOCK, blk))
    for t in tensors + float_tensors + seg_tensors:
        if t.device != q.device:
            raise ValueError("{} operands must share one device; got {} and "
                             "{}".format(name, t.device, q.device))
        if not t.is_contiguous():
            raise ValueError("{} takes contiguous tensors".format(name))
    for t in tensors:
        if t.dtype != q.dtype:
            raise ValueError("{} operands must share q's dtype {}; got "
                             "{}".format(name, q.dtype, t.dtype))
        # The kernels stage rows with 16-byte loads.
        if t.data_ptr() % 16:
            raise ValueError("{} operands must start on a 16-byte "
                             "boundary".format(name))
    for t in float_tensors:
        if t.dtype != torch.float32:
            raise ValueError("{}: lse and delta must be f32".format(name))
    for t in seg_tensors:
        if t.dtype != torch.int32:
            raise ValueError("{}: segment ids must be int32".format(name))


# Pointer arguments of each C entry point in ``csrc/flash_attention.cu``;
# all three then take b, h, h_kv, s_q, s_k, d (int), scale (float), causal,
# dtype (int) and the stream.
_POINTERS = {"flash_fwd": 9, "flash_bwd_dq": 11, "flash_bwd_dkv": 12}


def _argtypes(name):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return [vp] * _POINTERS[name] + [ci] * 6 + [ctypes.c_float, ci, ci, vp]


def _kernel_fn(name):
    from tensorflowonspark_tpu_torch.ops import _build

    fn = getattr(_build.load_library("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _argtypes(name)
        fn.restype = ctypes.c_int
    return fn


def _dims(q, k, causal):
    b, h, s_q, d = q.shape
    return [b, h, k.shape[1], s_q, k.shape[2], d, _scale(d), int(causal),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream]


def _raise_on(name, err):
    if err:
        raise RuntimeError("{} launch failed: CUDA error {}".format(name, err))


def flash_forward(q, k, v, q_seg, k_seg, *, causal=True, block_q=None,
                  block_k=None):
    """B1. ``q`` (b, h, s_q, d), ``k``/``v`` (b, h_kv, s_k, d) head-major;
    ``q_seg``/``k_seg`` int32 (b, s_q)/(b, s_k), 0 = padding. Returns
    ``(out (b, h, s_q, d), lse (b, h, s_q) f32)``."""
    return _forward(q, k, v, q_seg, k_seg, None, causal, block_q, block_k)


def flash_bwd_dq(q, k, v, do, lse, delta, q_seg, k_seg, *, causal=True,
                 block_q=None, block_k=None):
    """B2. ``do`` like ``q``; ``lse``/``delta`` f32 (b, h, s_q). Returns dQ
    in q's dtype."""
    return _bwd_dq(q, k, v, do, lse, delta, q_seg, k_seg, None, causal,
                   block_q, block_k)


def flash_bwd_dkv(q, k, v, do, lse, delta, q_seg, k_seg, *, causal=True,
                  block_q=None, block_k=None):
    """B3. Returns f32 ``(dk, dv)``, each (b, h_kv, s_k, d): the GQA
    group's sum, which the caller casts down."""
    return _bwd_dkv(q, k, v, do, lse, delta, q_seg, k_seg, None, causal,
                    block_q, block_k)


# The wrappers' bodies. ``lens`` is ``(q_len, k_len)`` from :func:`_lengths`
# when the caller has them (one attention call's forward and backward), or
# None. The plain versions need no lengths.


def _forward(q, k, v, q_seg, k_seg, lens, causal, block_q, block_k):
    _check_shapes(q, k, v, q_seg, k_seg, causal)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, q_seg, k_seg, causal=causal,
                                       block_k=block_k or BLOCK)
    q_len, k_len = lens or _lengths(q_seg, k_seg)
    _check_kernel("flash_forward", [q, k, v], [],
                  [q_seg, k_seg, q_len, k_len], block_q, block_k)
    b, h, s_q, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    err = _kernel_fn("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
        k_seg.data_ptr(), q_len.data_ptr(), k_len.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_dims(q, k, causal))
    _raise_on("flash_fwd", err)
    launches["flash_fwd"] += 1
    return out, lse


def _bwd_dq(q, k, v, do, lse, delta, q_seg, k_seg, lens, causal, block_q,
            block_k):
    _check_shapes(q, k, v, q_seg, k_seg, causal, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, q_seg, k_seg,
                                      causal=causal,
                                      block_k=block_k or BLOCK)
    q_len, k_len = lens or _lengths(q_seg, k_seg)
    _check_kernel("flash_bwd_dq", [q, k, v, do], [lse, delta],
                  [q_seg, k_seg, q_len, k_len], block_q, block_k)
    dq = torch.empty_like(q)
    err = _kernel_fn("flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), q_seg.data_ptr(), k_seg.data_ptr(),
        q_len.data_ptr(), k_len.data_ptr(), dq.data_ptr(),
        *_dims(q, k, causal))
    _raise_on("flash_bwd_dq", err)
    launches["flash_bwd_dq"] += 1
    return dq


def _bwd_dkv(q, k, v, do, lse, delta, q_seg, k_seg, lens, causal, block_q,
             block_k):
    _check_shapes(q, k, v, q_seg, k_seg, causal, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, q_seg, k_seg,
                                       causal=causal,
                                       block_q=block_q or BLOCK)
    q_len, k_len = lens or _lengths(q_seg, k_seg)
    _check_kernel("flash_bwd_dkv", [q, k, v, do], [lse, delta],
                  [q_seg, k_seg, q_len, k_len], block_q, block_k)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    err = _kernel_fn("flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), q_seg.data_ptr(), k_seg.data_ptr(),
        q_len.data_ptr(), k_len.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k, causal))
    _raise_on("flash_bwd_dkv", err)
    launches["flash_bwd_dkv"] += 1
    return dk, dv


# -- differentiable entry points -----------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Head-major flash attention: B1 forward; B2 and B3 backward. Both
    outputs are differentiable; the lse cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, q_len, k_len, causal, block_q,
                block_k):
        ctx.opts = (causal, block_q, block_k)
        out, lse = _forward(q, k, v, q_seg, k_seg, (q_len, k_len),
                            *ctx.opts)
        ctx.save_for_backward(q, k, v, q_seg, k_seg, q_len, k_len, out, lse)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, q_seg, k_seg, q_len, k_len, out, lse = ctx.saved_tensors
        do = (torch.zeros_like(out) if g_out is None
              else g_out.to(out.dtype).contiguous())
        # delta_i = rowsum(dO_i * O_i); the lse cotangent adds g_lse * p to
        # dL/dscores, i.e. ds = p * (dp - (delta - g_lse)).
        delta = (out.float() * do.float()).sum(dim=-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        lens = (q_len, k_len)
        dq = _bwd_dq(q, k, v, do, lse, delta, q_seg, k_seg, lens, *ctx.opts)
        dk, dv = _bwd_dkv(q, k, v, do, lse, delta, q_seg, k_seg, lens,
                          *ctx.opts)
        return (dq, dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 7


def _segments(segment_ids, kv_segment_ids, b, s_q, s_k, device):
    """(q_seg, k_seg) int32 on ``device``; the K side is ``kv_segment_ids``,
    or the query's when the geometry is square (the JAX ``_kv_segments``
    rule: rectangular packing must name the K segments)."""
    if segment_ids is None:
        q_seg = torch.ones((b, s_q), dtype=torch.int32, device=device)
    else:
        q_seg = torch.as_tensor(segment_ids, device=device).to(
            torch.int32).contiguous()
    if kv_segment_ids is not None:
        k_seg = torch.as_tensor(kv_segment_ids, device=device).to(
            torch.int32).contiguous()
    elif segment_ids is None:
        k_seg = q_seg if s_k == s_q else torch.ones(
            (b, s_k), dtype=torch.int32, device=device)
    elif s_k != s_q:
        raise ValueError(
            "rectangular attention (s_q={} != s_k={}) with segment_ids "
            "needs explicit kv_segment_ids".format(s_q, s_k))
    else:
        k_seg = q_seg
    return q_seg, k_seg


def _attention(q, k, v, segment_ids, kv_segment_ids, block_q, block_k,
               causal):
    """Head-major core: ``q`` (b, h, s_q, d), ``k``/``v`` (b, h_kv, s_k,
    d). Returns ``(out (b, h, s_q, d), lse (b, h, s_q))``, both
    differentiable."""
    b, _, s_q, _ = q.shape
    q_seg, k_seg = _segments(segment_ids, kv_segment_ids, b, s_q,
                             k.shape[2], q.device)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), q_seg, k_seg,
                                 *_lengths(q_seg, k_seg), causal, block_q,
                                 block_k)


def flash_attention_head_major(q, k, v, segment_ids=None, block_q=None,
                               block_k=None):
    """Causal flash attention on head-major operands — the model's entry
    point: ``q`` (b, h, s, d), ``k``/``v`` (b, h_kv, s, d), as the
    projections emit them; returns (b, h, s, d) for the output projection.
    It takes the place of the JAX package's ``flash_attention_folded``,
    whose K/V ride transposed for the TPU's DMA."""
    return _attention(q, k, v, segment_ids, None, block_q, block_k,
                      True)[0]


def flash_attention_with_lse(q, k, v, segment_ids=None, kv_segment_ids=None,
                             block_q=None, block_k=None, causal=True):
    """Flash attention returning ``(out, lse)``; ``q`` (b, s_q, h, d),
    ``k``/``v`` (b, s_k, h_kv, d), ``out`` like ``q``, ``lse`` (b, h, s_q)
    f32 — the per-row logsumexp of the masked, scaled scores.
    Differentiable in ``out`` and ``lse``. ``causal=False`` computes full
    (bidirectional) attention, and then ``s_k`` may differ from ``s_q``."""
    out, lse = _attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), segment_ids, kv_segment_ids,
                          block_q, block_k, causal)
    return out.transpose(1, 2), lse


def flash_causal_attention(q, k, v, segment_ids=None, block_q=None,
                           block_k=None):
    """Causal flash attention; shapes ``(batch, seq, heads, head_dim)``,
    ``k``/``v`` with the same or fewer (GQA) heads. ``segment_ids``: int32
    ``(batch, seq)``, 0 = padding."""
    return flash_attention_with_lse(q, k, v, segment_ids, None, block_q,
                                    block_k)[0]
