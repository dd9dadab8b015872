"""Paged-attention decode step: CUDA kernel wrapper and its plain version.

``paged_attention`` replaces the Pallas kernel ``_paged_decode_kernel``
(``tensorflowonspark_tpu/ops/paged_attention.py:65``) with the hand-written
CUDA kernel in ``csrc/paged_attention.cu``.

Bound: the step reads the visible K/V pages (plus their f32 scales when the
pool is int8), q and the table, and writes out — a few FLOPs per byte, so
its least time is those bytes over the card's memory rate (3.35 TB/s on an
H100 SXM), reached only with most SMs loading at once. The first design
(one block per (row, KV head) walking the row's pages one after another,
one page in flight, one warp a query head in the softmax) kept 96 blocks
busy at 8 rows x 12 heads and ran at 5% of that rate.

The kernel splits the walk across the card: one block per (row, KV head,
page), every page's K and V loads in flight at once, the products spread
over all warps. It keeps the sequential walk's roundings: each block takes
the running max m_c as the max over its own and the earlier pages' maxima
(published in flagged words), computes its page's p, sum and rounded PV
partial against m_c, and the last block of a (row, KV head) runs the walk's
sequential combine. One kernel launch a call; the wrapper allocates one f32
scratch (m_c, sums, PV partials) and keeps a zero-initialised state buffer
per device and stream (ticket, counts, flags), which every call leaves
zero.

``paged_attention_window`` is the speculative verify's route through the
same kernel: a window of W queries a row becomes W virtual rows of one
launch, row (r, j) reading row r's table up to position ``seq_lens[r] +
j``. A row's output depends only on its query, table and length, so each
window position gets the bits a one-token call at that position gives.

``paged_attention_reference`` is the PyTorch rendition of the JAX
package's ``_paged_cache_attention`` single-token walk (gather, dequantize,
repeat over the group, online softmax page by page). The wrapper runs it
only for tensors that lie on the CPU; for CUDA tensors it launches the
kernel or raises.
"""

import ctypes
import threading

import numpy as np
import torch

_NEG_INF = -1e30

# Kernel launches since the last reset — the count a caller reads to show
# that a path really went through the kernel. Engines of one process may
# decode from their own threads (a fleet's replicas), so the increment
# takes a lock.
launches = 0
_launches_lock = threading.Lock()

# The kernel's state words per (device index, stream): zero before a call
# and after it (the kernel resets them); grown, never shrunk.
_state = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    global launches
    launches = 0


def _scale(d):
    # The JAX walk's ``1.0 / jnp.sqrt(jnp.float32(d))``, in f32.
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _check(q, k_pages, v_pages, page_table, seq_lens, page_size, k_scales,
           v_scales):
    b, s_step, h, d = q.shape
    if s_step != 1:
        raise ValueError(
            "paged_attention is the single-token decode step; got {} "
            "tokens per row".format(s_step))
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages/v_pages must share one (num_pages, "
                         "page_size, h_kv, d) shape")
    n_pages, ps, h_kv, d_kv = k_pages.shape
    if ps != page_size:
        raise ValueError("page_size {} does not match k_pages page dim "
                         "{}".format(page_size, ps))
    if d_kv != d:
        raise ValueError("head dim of q ({}) and pages ({}) differ".format(
            d, d_kv))
    if h % h_kv:
        raise ValueError(
            "GQA needs query heads ({}) divisible by kv heads ({})".format(
                h, h_kv))
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if k_scales is not None:
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise ValueError("scaled pages must be int8")
        for s in (k_scales, v_scales):
            if s.shape != (n_pages, ps, h_kv) or s.dtype != torch.float32:
                raise ValueError("scales must be f32 (num_pages, page_size, "
                                 "h_kv)")
    elif k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("unscaled pages must be in q's dtype")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError("page_table must be (batch, table_width)")
    if seq_lens.shape != (b,):
        raise ValueError("seq_lens must be (batch,)")


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                    page_size, k_scales=None, v_scales=None):
    """Single-token paged-attention decode step.

    ``q``: (b, 1, h, d); ``k_pages``/``v_pages``: (num_pages, page_size,
    h_kv, d) in q's dtype, or int8 with ``k_scales``/``v_scales``
    ((num_pages, page_size, h_kv) f32); ``page_table``: int32 (b,
    table_width); ``seq_lens``: int32 (b,), each row's token count before
    this step — the new token's position, whose K/V must already sit in
    the pool. Returns (b, 1, h, d) in q's dtype.

    CPU tensors take :func:`paged_attention_reference`; CUDA tensors
    launch the kernel (f32 or bf16 q; pages in q's dtype or int8).
    """
    _check(q, k_pages, v_pages, page_table, seq_lens, page_size, k_scales,
           v_scales)
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, page_table, seq_lens, page_size=page_size,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError("paged_attention runs on CPU tensors (plain "
                         "version) or CUDA tensors (the kernel); got "
                         "{}".format(q.device))
    return _launch(q, k_pages, v_pages, page_table, seq_lens, page_size,
                   k_scales, v_scales)


def paged_attention_window(q, k_pages, v_pages, page_table, seq_lens, *,
                           page_size, k_scales=None, v_scales=None):
    """Causal-window paged attention: ``q`` (b, W, h, d) holds W queries a
    row, row r's j-th at position ``seq_lens[r] + j``, whose K/V (the
    whole window's) must already sit in the pool. Query j sees positions
    ``0 .. seq_lens[r] + j``: the pool's earlier tokens and window slots
    ``i <= j``, the JAX package's causal window. One
    :func:`paged_attention` call over ``b * W`` virtual rows (each row's
    table repeated W times, lengths ``seq_lens[r] + j``), so the CPU takes
    the plain version and the card one kernel launch. Returns (b, W, h,
    d) in q's dtype."""
    b, w, h, d = q.shape
    if seq_lens.shape != (b,):
        raise ValueError("seq_lens must be (batch,)")
    steps = torch.arange(w, dtype=seq_lens.dtype, device=seq_lens.device)
    out = paged_attention(
        q.reshape(b * w, 1, h, d), k_pages, v_pages,
        page_table.repeat_interleave(w, dim=0),
        (seq_lens[:, None] + steps[None, :]).reshape(b * w),
        page_size=page_size, k_scales=k_scales, v_scales=v_scales)
    return out.reshape(b, w, h, d)


def _launch(q, k_pages, v_pages, page_table, seq_lens, page_size, k_scales,
            v_scales):
    global launches
    from tensorflowonspark_tpu_torch.ops import _build

    quant = k_scales is not None
    operands = [q, k_pages, v_pages, page_table, seq_lens]
    if quant:
        operands += [k_scales, v_scales]
    for t in operands:
        if t.device != q.device:
            raise ValueError("paged_attention operands must share one "
                             "device; got {} and {}".format(t.device,
                                                            q.device))
        if not t.is_contiguous():
            raise ValueError("paged_attention takes contiguous tensors")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError("paged_attention kernel takes f32 or bf16 q; got "
                         "{}".format(q.dtype))
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("page_table and seq_lens must be int32")
    for t in (k_pages, v_pages):
        # The kernel stages rows with 16-byte loads.
        if t.data_ptr() % 16:
            raise ValueError("pages must start on a 16-byte boundary")
    b, _, h, d = q.shape
    n_pages, ps, h_kv, _ = k_pages.shape
    tw = page_table.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    scratch = torch.empty(b * h * tw * (d + 2), dtype=torch.float32,
                          device=q.device)
    state = _state_words(q.device, stream, 2 * b * h_kv + b * h * tw)
    lib = _build.load_library("paged_attention")
    fn = lib.paged_decode
    if fn.argtypes is None:
        fn.argtypes = _argtypes()
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scales.data_ptr() if quant else None,
             v_scales.data_ptr() if quant else None,
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), state.data_ptr(), b, h, h_kv, d, ps, tw,
             n_pages, _scale(d), _DTYPE_CODES[q.dtype], int(quant), stream)
    if err:
        raise RuntimeError("paged_decode launch failed: CUDA error "
                           "{}".format(err))
    with _launches_lock:
        launches += 1
    return out


def _argtypes():
    """``paged_decode``'s C parameters: ten pointers (q, pages, scales,
    table, lengths, out, scratch, state), seven ints, the scale, dtype and
    quant codes, the stream."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return [vp] * 10 + [ci] * 7 + [ctypes.c_float, ci, ci, vp]


def _state_words(device, stream, n):
    """At least ``n`` zeroed 64-bit state words for launches on ``stream``
    (a buffer is zeroed once, when it is made or grown)."""
    key = (device.index, stream)
    buf = _state.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel() if buf is not None else 0)
        buf = _state[key] = torch.zeros(size, dtype=torch.int64,
                                        device=device)
    return buf


def _kv_dequantize(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens, *,
                              page_size, k_scales=None, v_scales=None):
    """Plain PyTorch version of the decode step: the JAX package's
    ``_paged_cache_attention`` non-window walk, page by page, over the
    longest row's extent (shorter rows' extra pages are fully masked, an
    exact no-op of the recurrence)."""
    b, s_step, h, d = q.shape
    h_kv = k_pages.shape[2]
    reps = h // h_kv
    scale = _scale(d)
    tw = page_table.shape[1]
    n_chunks = (int(seq_lens.max()) + s_step + page_size - 1) // page_size
    lens = seq_lens.long()
    m = torch.full((b, h, s_step), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_step), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_step, d), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        # Table slots past the width clamp to the last one, as the JAX
        # walk's dynamic_slice does.
        page_ids = page_table[:, min(c, tw - 1)].long()
        k_c = k_pages[page_ids]
        v_c = v_pages[page_ids]
        if k_scales is not None:
            k_c = _kv_dequantize(k_c, k_scales[page_ids], q.dtype)
            v_c = _kv_dequantize(v_c, v_scales[page_ids], q.dtype)
        if reps > 1:
            k_c = torch.repeat_interleave(k_c, reps, dim=2)
            v_c = torch.repeat_interleave(v_c, reps, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_c).float() * scale
        k_pos = c * page_size + torch.arange(page_size, device=q.device)
        visible = (k_pos[None, :] <= lens[:, None])[:, None, None, :]
        scores = torch.where(visible, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(visible, torch.exp(scores - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v_c.dtype), v_c)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
