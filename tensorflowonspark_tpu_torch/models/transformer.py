"""Decoder-only Transformer LM (port of ``models/transformer.py``).

Train, eval and decode modes of the JAX ``TransformerLM``: the same
parameter tree (``state_dict`` keys mirror the flax paths, kernels keep
the flax ``(in, ..., out)`` layout, so
:mod:`tensorflowonspark_tpu_torch.convert` is a renaming) and the same
rounding points — projections and scores in
the model dtype, f32 softmax and layer-norm statistics, tanh GELU,
layer-norm epsilon 1e-6, ``-1e30`` masks applied with an explicit
``where``, ``scale = 1/sqrt(f32(d))``.

Decode state is explicit. A contiguous cache (``models.decoding.
init_cache``) is a dict ``{"position": int, "block_<i>": {"cached_key",
"cached_value", "cache_index"}}``; a paged pool (``serving.runner``) is a
dict ``{"block_<i>": {"k_pages", "v_pages"[, "k_scales", "v_scales"]}}``.
Both are updated IN PLACE — where the JAX model returns a new ``cache``
collection, the port writes the tensors it was given.

Autograd. The model is built in eval mode, where its forward runs without
autograd, as inference callers expect. In train mode (``model.train()``,
which ``train.Trainer`` sets around a step) the full forward records the
graph; with ``remat`` each block, or with ``mlp_remat`` only its MLP, runs
under ``torch.utils.checkpoint`` and recomputes its activations in the
backward pass. Decode never records a graph and never remats: it writes
the caches in place.

Train-mode attention with ``attention_impl="pallas"`` is the JAX package's
zero-relayout path (``transformer.py:554-577``): the projections emit
head-major ``(b, h, s, d)`` q/k/v, the flash kernels (B1 forward, B2/B3
backward) take them as they are, and the output projection contracts the
head-major result.

Sharded (``parallel.sharding.ModelSharding.shard_model``, which the
``Trainer`` applies under a mesh): :meth:`TransformerLM.param_axes` gives
the JAX model's logical axes. Parameters over ``fsdp`` are gathered before
each use; over ``tensor`` the attention and MLP blocks are Megatron's
column/row-parallel pair on ``h / tensor`` heads and ``mlp / tensor``
columns (the input's gradient summed over the tensor group, the output
summed forward), and the embedding is vocab-parallel: the lookup sums the
rank's rows over the tensor group, and the weight-tied head emits this
rank's vocab slab of the logits, for ``train.losses``' vocab-parallel
cross-entropy. Tensor-group sums run in f32. Under a ``seq`` axis each rank
holds its chunk of the sequence: positions are offset by the chunk's start
(or ride ``ring_layout="zigzag"``'s permutation), packed positions are
derived from the whole row's segment ids, and attention runs the
sequence-parallel route the config names (``dense`` and ``pallas`` over
the whole row, gathered: ``ops.attention.gathered_causal_attention``).
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch.initializers import truncated_normal_
from tensorflowonspark_tpu_torch.ops import attention as attention_ops
from tensorflowonspark_tpu_torch.ops import paged_attention as pa_ops
from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel.sharding import weight
# Re-exported beside _kv_quantize, where the JAX package keeps both; the
# plain paged walk in ops owns it so that ops never imports models.
from tensorflowonspark_tpu_torch.ops.paged_attention import (  # noqa: F401
    _kv_dequantize,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and validation as the JAX ``TransformerConfig``;
    ``dtype`` is a torch dtype. The port runs every ``attention_impl``:
    ``"dense"``, ``"pallas"`` (the flash kernels), and the
    sequence-parallel ``"ring"``, ``"ring_flash"`` (the flash kernels on
    every ring step) and ``"ulysses"``, with ``ring_layout`` ``"contiguous"``
    or ``"zigzag"``; ``decode_attention`` ``"dense"`` and ``"chunked"``.
    ``paged_attention_impl`` takes only ``"pallas"``, the kernel route: the
    paged step always launches the ``ops.paged_attention`` kernel, and the
    lax composition the JAX package also offers is not ported — the port
    writes the pool in place, so it needs no deferred-write window, and
    the kernel stays the only paged route on the card. The pool geometry
    (``page_size``, ``num_pages``, ``kv_quant``) is read from the pool
    tensors a call passes, so a model serves any pool without a clone."""
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 0          # 0 = MHA; fewer than num_heads = GQA/MQA
    embed_dim: int = 768
    mlp_dim: int = 3072
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "dense"
    ring_layout: str = "contiguous"
    remat: bool = True
    decode_cache_len: int = 0
    decode_attention: str = "dense"
    page_size: int = 0
    num_pages: int = 0
    kv_quant: str = ""
    paged_attention_impl: str = "pallas"
    mlp_remat: bool = False
    upcast_logits: bool = True

    def __post_init__(self):
        if not 0 <= self.decode_cache_len <= self.max_seq_len:
            raise ValueError(
                "decode_cache_len must be in [0, max_seq_len={}]; got "
                "{}".format(self.max_seq_len, self.decode_cache_len))
        if self.decode_attention not in ("dense", "chunked"):
            raise ValueError(
                "decode_attention must be 'dense' or 'chunked', got "
                "{!r}".format(self.decode_attention))
        if self.page_size < 0 or self.num_pages < 0:
            raise ValueError("page_size/num_pages must be >= 0")
        if (self.page_size > 0) != (self.num_pages > 0):
            raise ValueError(
                "page_size and num_pages enable paged decode together; "
                "got page_size={} num_pages={}".format(
                    self.page_size, self.num_pages))
        if self.page_size and self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "trash page)")
        if self.kv_quant not in ("", "int8"):
            raise ValueError(
                "kv_quant must be '' or 'int8', got {!r}".format(
                    self.kv_quant))
        if self.kv_quant and not self.page_size:
            raise ValueError(
                "kv_quant applies to the paged pool; set page_size/"
                "num_pages (the contiguous cache stays unquantized)")
        if self.paged_attention_impl != "pallas":
            raise ValueError(
                "paged_attention_impl must be 'pallas' (the kernel; the "
                "lax composition is not ported), got {!r}".format(
                    self.paged_attention_impl))
        if not isinstance(self.dtype, torch.dtype):
            raise ValueError("dtype must be a torch dtype, got {!r}".format(
                self.dtype))

    @property
    def head_dim(self):
        return self.embed_dim // self.num_heads

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads


_NEG_INF = -1e30


def _kv_quantize(x):
    """Symmetric int8 quantization of K/V rows: one f32 scale per
    ``(..., d)`` vector (per cached token per KV head), ``amax/127`` with a
    tiny floor so an all-zero row dequantizes to exact zeros. Returns
    ``(int8 values, f32 scales)``."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-30)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def _chunked_cache_attention(q, k_all, v_all, i, cache_len, chunk=128):
    """Decode attention that walks the contiguous cache in ``chunk``-slot
    pieces up to the valid prefix (the JAX package's
    ``_chunked_cache_attention``): ``ceil((i + s_step) / chunk)`` pieces
    combined with the online-softmax recurrence, a GQA cache expanded per
    piece. A cache of at most one chunk takes the dense formulation (plain
    softmax, probs cast, probs @ V), as the JAX function does, so short
    caches equal the dense path bitwise.

    ``q``: (b, s_step, h, d); ``k_all``/``v_all``: (b, cache_len, h_kv,
    d); ``i``: the cache index of the call's first token. Returns (b,
    s_step, h, d) in q's dtype."""
    b, s_step, h, d = q.shape
    dev = q.device
    scale = pa_ops._scale(d)
    q_pos = i + torch.arange(s_step, device=dev)[:, None]
    if cache_len <= chunk:
        k_c, v_c = attention_ops._expand_kv(q, k_all, v_all)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k_c).float() * scale
        visible = torch.arange(cache_len, device=dev)[None, :] <= q_pos
        logits = torch.where(visible[None, None], logits, _NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v_c)
    m = torch.full((b, h, s_step), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, s_step), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s_step, d), dtype=torch.float32, device=dev)
    for c in range(-(-(i + s_step) // chunk)):
        # A cache_len that is no chunk multiple clamps the last chunk's
        # start back; the re-covered overlap is masked below so nothing
        # counts twice in the sums.
        start = min(c * chunk, cache_len - chunk)
        k_c, v_c = attention_ops._expand_kv(
            q, k_all[:, start:start + chunk], v_all[:, start:start + chunk])
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_c).float() * scale
        k_pos = start + torch.arange(chunk, device=dev)[None, :]
        visible = ((k_pos <= q_pos) & (k_pos >= c * chunk))[None, None]
        scores = torch.where(visible, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        # Explicit where: a fully masked row has m_new == _NEG_INF, where
        # exp(scores - m_new) would read 1.
        p = torch.where(visible, torch.exp(scores - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v_c.dtype), v_c)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _packed_positions(segment_ids):
    """Per-document 0-based positions of contiguously packed
    ``segment_ids`` rows (``data.packing``'s layout)."""
    s = segment_ids.shape[1]
    idx = torch.arange(s, dtype=torch.int64,
                       device=segment_ids.device).expand(segment_ids.shape)
    prev = F.pad(segment_ids[:, :-1], (1, 0), value=-1)
    starts = torch.cummax(torch.where(segment_ids != prev, idx, 0),
                          dim=1).values
    return idx - starts


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` as the JAX model runs it: statistics in f32
    (mean, and E[x^2] - mean^2 clipped at 0), epsilon 1e-6, scale and bias
    applied in f32, the result cast to the model dtype."""

    def __init__(self, dim, dtype, eps=1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mu * mu,
                              0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((xf - mu) * mul + self.bias.float()).to(self.dtype)


class Dense(nn.Module):
    """``nn.DenseGeneral`` without bias: ``kernel`` (in, out), operands cast
    to the model dtype, output in the model dtype."""

    def __init__(self, in_features, out_features, dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))

    def forward(self, x):
        return x.to(self.dtype) @ weight(self, "kernel").to(self.dtype)


def _tp_sum(y, group):
    """Row-parallel output: the tensor group's partial products summed in
    f32 forward (identity backward), in the model dtype."""
    if group is None:
        return y
    return coll.reduce_from_group(y.float(), group).to(y.dtype)


class QKVProj(nn.Module):
    """Fused QKV projection, ``kernel`` (embed, 3, h, d); natural (b, s, h,
    d) outputs, or with ``head_major`` contiguous (b, h, s, d) ones."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.kernel = nn.Parameter(torch.empty(
            cfg.embed_dim, 3, cfg.num_heads, cfg.head_dim))

    def forward(self, x, head_major=False):
        cfg = self.cfg
        b, s, _ = x.shape
        w = weight(self, "kernel").to(cfg.dtype)
        h = w.shape[2]
        w = w.reshape(cfg.embed_dim, -1)
        qkv = (x.to(cfg.dtype) @ w).view(b, s, 3, h, cfg.head_dim)
        if head_major:
            return qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


class QProj(nn.Module):
    """GQA query projection, ``kernel`` (embed, h, d)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.kernel = nn.Parameter(torch.empty(
            cfg.embed_dim, cfg.num_heads, cfg.head_dim))

    def forward(self, x, head_major=False):
        cfg = self.cfg
        b, s, _ = x.shape
        w = weight(self, "kernel").to(cfg.dtype)
        h = w.shape[1]
        w = w.reshape(cfg.embed_dim, -1)
        q = (x.to(cfg.dtype) @ w).view(b, s, h, cfg.head_dim)
        return q.transpose(1, 2).contiguous() if head_major else q


class KVProj(nn.Module):
    """GQA fused K/V projection, ``kernel`` (embed, 2, h_kv, d)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.kernel = nn.Parameter(torch.empty(
            cfg.embed_dim, 2, cfg.kv_heads, cfg.head_dim))

    def forward(self, x, head_major=False):
        cfg = self.cfg
        b, s, _ = x.shape
        w = weight(self, "kernel").to(cfg.dtype)
        h_kv = w.shape[2]
        w = w.reshape(cfg.embed_dim, -1)
        kv = (x.to(cfg.dtype) @ w).view(b, s, 2, h_kv, cfg.head_dim)
        if head_major:
            return kv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        return kv[:, :, 0], kv[:, :, 1]


class OutProj(nn.Module):
    """Attention output projection, ``kernel`` (embed, embed); takes the
    natural (b, s, embed) attention output or, with ``head_major``, the (b,
    h, s, d) one. Row-parallel under tensor parallelism: this rank's heads'
    rows, the partial products summed over the tensor group."""

    tp_group = None

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.kernel = nn.Parameter(torch.empty(cfg.embed_dim, cfg.embed_dim))

    def forward(self, out, head_major=False):
        if head_major:
            b, h, s, d = out.shape
            out = out.transpose(1, 2).reshape(b, s, h * d)
        y = out.to(self.cfg.dtype) @ weight(self, "kernel").to(self.cfg.dtype)
        return _tp_sum(y, self.tp_group)


class Attention(nn.Module):

    # The tensor group under tensor parallelism (None: all heads here).
    tp_group = None

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        if cfg.kv_heads == cfg.num_heads:
            self.qkv = QKVProj(cfg)
        else:
            self.q = QProj(cfg)
            self.kv = KVProj(cfg)
        self.out = OutProj(cfg)

    def forward(self, x, segment_ids=None, decode=False, pages=None,
                seq_lens=None, cache=None, verify=False):
        cfg = self.cfg
        attention_ops.check_impl(cfg.attention_impl, cfg.ring_layout)
        if self.tp_group is not None:
            # Column-parallel projections: x's gradient sums over the group.
            x = coll.copy_to_group(x, self.tp_group)
        # The flash route's zero-relayout path: head-major projections in,
        # head-major attention output into the output projection.
        head_major = cfg.attention_impl == "pallas" and not decode
        if cfg.kv_heads == cfg.num_heads:
            q, k, v = self.qkv(x, head_major=head_major)
        else:
            q = self.q(x, head_major=head_major)
            k, v = self.kv(x, head_major=head_major)
        if decode:
            if segment_ids is not None:
                raise NotImplementedError(
                    "decode mode does not support segment_ids")
            out = self._decode_step(q, k, v, cache, pages, seq_lens, verify)
        elif head_major:
            out = attention_ops.head_major_attention(
                q, k, v, segment_ids=segment_ids)
            return self.out(out, head_major=True)
        else:
            out = attention_ops.causal_attention(
                q, k, v, impl=cfg.attention_impl, segment_ids=segment_ids,
                ring_layout=cfg.ring_layout)
        out = out.reshape(out.shape[:2] + (-1,))
        return self.out(out)

    def _decode_step(self, q, k, v, cache, pages, seq_lens, verify=False):
        """Append this call's K/V to the layer's cache and attend over the
        visible prefix.

        With ``pages``/``seq_lens`` the cache is the layer's slice of the
        shared page pool: one token per row, row r's token landing at
        position ``seq_lens[r]`` — page ``pages[r, seq_lens[r] //
        page_size]``, slot ``seq_lens[r] % page_size`` (inactive rows
        carry an all-trash table and write page 0) — then the
        ``ops.paged_attention`` kernel walks the pages. With ``verify``
        (the speculative verify) a row carries W tokens, token j at
        position ``seq_lens[r] + j``: all W land in the pool first, then
        ``paged_attention_window`` runs the kernel once over the ``b * W``
        query rows, query j seeing positions up to its own — the JAX
        package's causal window, each position's attention the bits of a
        one-token step there. Table slots past the row's width clamp to
        its last entry, as the JAX flush does. Without them the
        cache is a private contiguous one: the call's tokens (one decode
        step or a whole prompt chunk) land at ``cache_index`` and every
        query j attends to slots ``<= cache_index + j`` (walked in
        128-slot chunks with ``decode_attention="chunked"``)."""
        cfg = self.cfg
        if cache is None:
            raise ValueError("decode mode needs a cache")
        b, s_step, h_kv, d = k.shape
        if pages is not None:
            if seq_lens is None:
                raise ValueError("paged decode needs seq_lens")
            if s_step != 1 and not verify:
                raise ValueError(
                    "paged decode carries one token per row; got "
                    "{}".format(s_step))
            k_pages, v_pages = cache["k_pages"], cache["v_pages"]
            n_pages, ps = k_pages.shape[:2]
            pos = (seq_lens[:, None].long()
                   + torch.arange(s_step, device=seq_lens.device)[None, :])
            slot = torch.clamp_max(pos // ps, pages.shape[1] - 1)
            dest = (pages.gather(1, slot).long() * ps + pos % ps).reshape(-1)
            k_new = k.reshape(b * s_step, h_kv, d)
            v_new = v.reshape(b * s_step, h_kv, d)
            k_scales = cache.get("k_scales")
            v_scales = cache.get("v_scales")
            # In place, where the JAX step returns an updated pool: the
            # pool is the engine's long-lived state and a functional
            # update would copy all of it on every step.
            if k_scales is not None:
                k_new, k_s = _kv_quantize(k_new)
                v_new, v_s = _kv_quantize(v_new)
                k_scales.view(n_pages * ps, h_kv).index_put_((dest,), k_s)
                v_scales.view(n_pages * ps, h_kv).index_put_((dest,), v_s)
            k_pages.view(n_pages * ps, h_kv, d).index_put_(
                (dest,), k_new.to(k_pages.dtype))
            v_pages.view(n_pages * ps, h_kv, d).index_put_(
                (dest,), v_new.to(v_pages.dtype))
            attend = (pa_ops.paged_attention_window if verify
                      else pa_ops.paged_attention)
            return attend(q.contiguous(), k_pages, v_pages, pages, seq_lens,
                          page_size=ps, k_scales=k_scales, v_scales=v_scales)
        cached_k, cached_v = cache["cached_key"], cache["cached_value"]
        cache_len = cached_k.shape[1]
        i = cache["cache_index"]
        if i + s_step > cache_len:
            raise ValueError(
                "decode call carries {} tokens at index {} past cache "
                "length {}".format(s_step, i, cache_len))
        cached_k[:, i:i + s_step] = k
        cached_v[:, i:i + s_step] = v
        cache["cache_index"] = i + s_step
        if cfg.decode_attention == "chunked":
            return _chunked_cache_attention(q, cached_k, cached_v, i,
                                            cache_len)
        k_all, v_all = attention_ops._expand_kv(q, cached_k, cached_v)
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k_all).float()
                  * pa_ops._scale(d))
        visible = (torch.arange(cache_len, device=q.device)[None, :]
                   <= i + torch.arange(s_step, device=q.device)[:, None])
        logits = torch.where(visible[None, None], logits, _NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v_all)


class MLPBlock(nn.Module):

    # The tensor group under tensor parallelism (None: all columns here).
    tp_group = None

    def __init__(self, cfg):
        super().__init__()
        self.up = Dense(cfg.embed_dim, cfg.mlp_dim, cfg.dtype)
        self.down = Dense(cfg.mlp_dim, cfg.embed_dim, cfg.dtype)

    def forward(self, x):
        if self.tp_group is not None:
            x = coll.copy_to_group(x, self.tp_group)
        # flax nn.gelu defaults to the tanh approximation.
        y = self.down(F.gelu(self.up(x), approximate="tanh"))
        return _tp_sum(y, self.tp_group)


class Block(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.embed_dim, cfg.dtype)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(cfg.embed_dim, cfg.dtype)
        self.mlp = MLPBlock(cfg)

    def forward(self, x, segment_ids=None, decode=False, pages=None,
                seq_lens=None, cache=None, verify=False):
        x = x + self.attn(self.ln1(x), segment_ids, decode, pages=pages,
                          seq_lens=seq_lens, cache=cache, verify=verify)
        cfg = self.cfg
        if (cfg.mlp_remat and not cfg.remat and not decode
                and torch.is_grad_enabled()):
            # Only the MLP recomputes: its (b*s, mlp_dim) activations are
            # the block's largest. Under full-block remat this would
            # recompute the MLP twice for no saving.
            return x + checkpoint(self.mlp, self.ln2(x), use_reentrant=False)
        return x + self.mlp(self.ln2(x))


class Embed(nn.Module):
    """``nn.Embed``: ``embedding`` (vocab, embed); lookups and the tied
    head (:meth:`attend`) run in the model dtype. Vocab-parallel under
    tensor parallelism: this rank holds rows ``[vocab_start, vocab_start +
    rows)`` of the table, a lookup sums the group's rows (each token's row
    lives on one rank), and :meth:`attend` emits that slab of the logits."""

    tp_group = None
    vocab_start = 0

    def __init__(self, cfg):
        super().__init__()
        self.dtype = cfg.dtype
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size,
                                                  cfg.embed_dim))

    def forward(self, tokens):
        table = weight(self, "embedding")
        if self.tp_group is None:
            # Gather, then cast: the same values as flax's
            # cast-then-gather, without casting the whole table per call.
            return table[tokens].to(self.dtype)
        local = tokens.long() - self.vocab_start
        rows = table.shape[0]
        valid = (local >= 0) & (local < rows)
        picked = table[local.clamp(0, rows - 1)] * valid[..., None]
        return coll.reduce_from_group(picked.float(),
                                      self.tp_group).to(self.dtype)

    def attend(self, x):
        if self.tp_group is not None:
            x = coll.copy_to_group(x, self.tp_group)
        return x.to(self.dtype) @ weight(self, "embedding").to(self.dtype).t()


class TransformerLM(nn.Module):
    """The decoder-only LM. Built on ``device`` (default the card; raises
    when none is present unless ``device="cpu"``), its weights drawn from
    a ``torch.Generator`` seeded with ``seed`` with the JAX model's
    initializer families (he-normal kernels, N(0, 0.02) embeddings)."""

    def __init__(self, cfg, *, device="cuda", seed=0):
        super().__init__()
        dev = device_info.resolve_device(device)
        self.cfg = cfg
        self.embed = Embed(cfg)
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_seq_len,
                                                  cfg.embed_dim))
        self.build_blocks()
        self.ln_f = LayerNorm(cfg.embed_dim, cfg.dtype)
        self.reset_parameters(seed)
        self.to(dev)
        self.eval()

    def block_for_layer(self, i):
        """The block class of layer ``i``: the hook the MoE LM overrides
        to mix block types without duplicating the scaffold (the JAX
        ``block_for_layer``)."""
        return Block

    def build_blocks(self):
        """Make the block stack (``block_<i>``); schedule variants (the
        pipelined LM) override it with their own parameters."""
        for i in range(self.cfg.num_layers):
            self.add_module("block_{}".format(i),
                            self.block_for_layer(i)(self.cfg))

    @torch.no_grad()
    def reset_parameters(self, seed):
        gen = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("embedding") or name == "pos_embed":
                nn.init.normal_(p, 0.0, 0.02, generator=gen)
            elif name.endswith("kernel"):
                truncated_normal_(p, 2.0 / p.shape[0], gen)
            elif name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()

    @property
    def device(self):
        return self.pos_embed.device

    def param_axes(self):
        """The JAX model's logical axes of every sharded parameter
        (``transformer.py``'s ``with_logical_partitioning`` annotations);
        layer norms are replicated."""
        axes = {"embed.embedding": ("vocab", None),
                "pos_embed": (None, "embed")}
        for i in range(self.cfg.num_layers):
            p = "block_{}.".format(i)
            if self.cfg.kv_heads == self.cfg.num_heads:
                axes[p + "attn.qkv.kernel"] = ("embed", None, "heads",
                                               "head_dim")
            else:
                axes[p + "attn.q.kernel"] = ("embed", "heads", "head_dim")
                axes[p + "attn.kv.kernel"] = ("embed", None, "heads",
                                              "head_dim")
            axes[p + "attn.out.kernel"] = ("heads", "embed")
            axes[p + "mlp.up.kernel"] = ("embed", "mlp")
            axes[p + "mlp.down.kernel"] = ("mlp", "embed")
        return axes

    # The dimension each tensor-parallel parameter may shard over tensor.
    _TENSOR_DIMS = {"embed.embedding": 0, "attn.qkv.kernel": 2,
                    "attn.q.kernel": 1, "attn.kv.kernel": 2,
                    "attn.out.kernel": 0, "mlp.up.kernel": 1,
                    "mlp.down.kernel": 0}

    def apply_sharding(self, sharding):
        """Point the modules at ``sharding`` (a ``ModelSharding`` whose
        shards this model now holds), or back to full parameters (None):
        fsdp gathers per parameter, the tensor group of the attention and
        MLP blocks, the embedding's vocab slab."""
        modules = dict(self.named_modules())
        for module in modules.values():
            for attr in ("_gathers", "tp_group", "vocab_start"):
                module.__dict__.pop(attr, None)
        self._sharding = sharding
        self._mesh = None if sharding is None else sharding.mesh
        if sharding is None:
            return
        cfg = self.cfg
        tensor = sharding.mesh.shape["tensor"]
        for name in sharding.layouts:
            path, _, attr = name.rpartition(".")
            module = modules[path]
            if sharding.fsdp_sharded(name):
                gathers = module.__dict__.setdefault("_gathers", {})
                gathers[attr] = (lambda p, n=name: sharding.gather(n, p))
            dims = sharding.tensor_dims(name)
            if not dims:
                continue
            key = name.split(".", 1)[1] if name.startswith("block_") \
                else name
            if dims != [self._TENSOR_DIMS.get(key, -1)]:
                raise NotImplementedError(
                    "{}: tensor parallelism over dims {} (rules {}); the "
                    "port's TransformerLM shards heads, mlp and vocab "
                    "only".format(name, dims, sharding.rules))
        for i, block in enumerate(self.blocks()):
            attn = block.attn
            attn_kernel = "block_{}.attn.{}.kernel".format(
                i, "qkv" if cfg.kv_heads == cfg.num_heads else "q")
            if sharding.tensor_dims(attn_kernel):
                for h in (cfg.num_heads, cfg.kv_heads):
                    if h % tensor:
                        raise ValueError(
                            "tensor={} does not divide the {} attention "
                            "heads".format(tensor, h))
                attn.tp_group = attn.out.tp_group = sharding.tensor_group
            up = "block_{}.mlp.up.kernel".format(i)
            if up in sharding.layouts and sharding.tensor_dims(up):
                if cfg.mlp_dim % tensor:
                    raise ValueError("tensor={} does not divide mlp_dim "
                                     "{}".format(tensor, cfg.mlp_dim))
                block.mlp.tp_group = sharding.tensor_group
        if sharding.tensor_dims("embed.embedding"):
            self.embed.tp_group = sharding.tensor_group
            self.embed.vocab_start = sharding.tensor_slab(
                "embed.embedding", 0)[0]

    def apply_blocks(self, x, segment_ids=None, decode=False, pages=None,
                     seq_lens=None, cache=None, verify=False):
        """Run the block stack: the hook schedule variants (pipeline
        parallelism) override, as in the JAX model."""
        remat = self.cfg.remat and not decode and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks()):
            if remat:
                # Every rank recomputes the whole block, collectives
                # included, in one order: no early stop.
                with torch.utils.checkpoint.set_checkpoint_early_stop(
                        False):
                    x = checkpoint(block, x, segment_ids,
                                   use_reentrant=False)
                continue
            layer_cache = None if cache is None else cache[
                "block_{}".format(i)]
            x = block(x, segment_ids, decode, pages=pages, seq_lens=seq_lens,
                      cache=layer_cache, verify=verify)
        return x

    def vocab_slab(self):
        """``(tensor group, start)`` of the logits this model emits: the
        group is None when they span the whole vocabulary."""
        return self.embed.tp_group, self.embed.vocab_start

    def blocks(self):
        return [getattr(self, "block_{}".format(i))
                for i in range(self.cfg.num_layers)]

    def forward(self, tokens, segment_ids=None, decode=False,
                positions=None, pages=None, seq_lens=None, cache=None,
                verify=False):
        """``tokens``: int (batch, seq). Without ``decode`` this runs the
        full causal forward, with optional packed ``segment_ids``/
        ``positions``; in train mode it records the autograd graph (see the
        module docstring). ``decode=True`` runs against ``cache``: a
        contiguous cache (position = tokens the cache has absorbed, one step
        or a prompt chunk per call), or with ``pages``/``seq_lens`` the paged
        pool — one token per row, row r at position ``seq_lens[r]``; with
        ``verify`` as well (the speculative verify, the JAX model's
        ``window={"causal": True, ...}``) a row carries W tokens at
        positions ``seq_lens[r] .. seq_lens[r] + W - 1``, all written into
        the pool. Returns f32 logits (model-dtype logits with
        ``upcast_logits=False``)."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.training
                                    and not decode):
            return self._forward(tokens, segment_ids, decode, positions,
                                 pages, seq_lens, cache, verify)

    def _forward(self, tokens, segment_ids, decode, positions, pages,
                 seq_lens, cache, verify=False):
        mesh = getattr(self, "_mesh", None)
        if mesh is None:
            return self._forward_local(tokens, segment_ids, decode,
                                       positions, pages, seq_lens, cache,
                                       verify)
        if decode:
            raise NotImplementedError(
                "decode on a sharded model: serve the full parameters "
                "(CheckpointManager.restore_variables)")
        with mesh_lib.use_mesh(mesh):
            return self._forward_local(tokens, segment_ids, decode,
                                       positions, pages, seq_lens, cache,
                                       verify)

    def _seq_positions(self, seq_len, segment_ids, positions):
        """Positions of this rank's chunk under a seq axis, or None
        (without one, or when ``positions`` came with the batch)."""
        cfg = self.cfg
        group = attention_ops.seq_group()
        n = coll.size(group)
        if n == 1 or positions is not None:
            return positions
        full = seq_len * n
        if full > cfg.max_seq_len:
            raise ValueError(
                "sequence length {} exceeds max_seq_len {}".format(
                    full, cfg.max_seq_len))
        idx = coll.rank(group)
        chunk = slice(idx * seq_len, (idx + 1) * seq_len)
        if segment_ids is not None:
            if cfg.ring_layout == "zigzag":
                raise ValueError(
                    "packed zigzag rows need explicit positions: the "
                    "zigzag permutation applies to them too "
                    "(ops.attention.zigzag_layout on data.packing's "
                    "positions)")
            row = coll.gather_cat(segment_ids.contiguous(), group, 1)
            return _packed_positions(row)[:, chunk]
        pos = torch.arange(full, device=segment_ids.device
                           if segment_ids is not None else self.device)
        if cfg.ring_layout == "zigzag":
            pos = attention_ops.zigzag_layout(pos, n, axis=0)
        return pos[chunk][None]

    def _forward_local(self, tokens, segment_ids, decode, positions, pages,
                       seq_lens, cache, verify=False):
        cfg = self.cfg
        if decode and cfg.ring_layout == "zigzag":
            raise NotImplementedError(
                "decode mode requires ring_layout='contiguous'")
        seq_len = tokens.shape[1]
        if not decode:
            positions = self._seq_positions(seq_len, segment_ids, positions)
        x = self.embed(tokens)
        pos_embed = weight(self, "pos_embed")
        if decode:
            if positions is not None:
                raise NotImplementedError(
                    "decode mode derives positions from the cache")
            if cache is None:
                raise ValueError("decode mode needs a cache")
        if verify and (not decode or pages is None):
            raise ValueError("verify runs in paged decode (decode=True with "
                             "pages/seq_lens)")
        if decode and pages is not None:
            if seq_lens is None:
                raise ValueError("paged decode needs seq_lens")
            if seq_len != 1 and not verify:
                raise ValueError(
                    "paged decode carries one token per row; got "
                    "{}".format(seq_len))
            # Row r's token j sits at position seq_lens[r] + j. Positions
            # past the table clamp, as the JAX gather does: only junk steps
            # past a row's budget reach them (a horizon's, or a verify round
            # straddling the budget's end), and their outputs are never
            # emitted.
            pos = torch.clamp_max(
                seq_lens[:, None].long()
                + torch.arange(seq_len, device=seq_lens.device)[None, :],
                cfg.max_seq_len - 1)
            x = x + pos_embed[pos].to(cfg.dtype)
        elif decode:
            pos = cache["position"]
            if pos + seq_len > cfg.max_seq_len:
                raise ValueError(
                    "decode position {} + {} tokens exceeds max_seq_len "
                    "{}".format(pos, seq_len, cfg.max_seq_len))
            x = x + pos_embed[pos:pos + seq_len][None].to(cfg.dtype)
            cache["position"] = pos + seq_len
        else:
            if seq_len > cfg.max_seq_len:
                raise ValueError(
                    "sequence length {} exceeds max_seq_len {}".format(
                        seq_len, cfg.max_seq_len))
            if positions is None and segment_ids is not None:
                if cfg.ring_layout == "zigzag":
                    raise ValueError(
                        "packed zigzag rows need explicit positions: the "
                        "zigzag permutation applies to them too "
                        "(ops.attention.zigzag_layout on data.packing's "
                        "positions)")
                positions = _packed_positions(segment_ids)
            if positions is None:
                # A one-rank zigzag permutation is the identity.
                x = x + pos_embed[:seq_len][None].to(cfg.dtype)
            else:
                x = x + pos_embed[positions.long()].to(cfg.dtype)
        x = self.apply_blocks(x, segment_ids, decode, pages=pages,
                              seq_lens=seq_lens, cache=cache, verify=verify)
        x = self.ln_f(x)
        # Weight-tied head in the model dtype; logits upcast after.
        logits = self.embed.attend(x)
        return logits.float() if cfg.upcast_logits else logits
