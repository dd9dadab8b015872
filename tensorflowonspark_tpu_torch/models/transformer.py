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
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch.initializers import truncated_normal_
from tensorflowonspark_tpu_torch.ops import attention as attention_ops
from tensorflowonspark_tpu_torch.ops import flash_attention
from tensorflowonspark_tpu_torch.ops import paged_attention as pa_ops
# Re-exported beside _kv_quantize, where the JAX package keeps both; the
# plain paged walk in ops owns it so that ops never imports models.
from tensorflowonspark_tpu_torch.ops.paged_attention import (  # noqa: F401
    _kv_dequantize,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and validation as the JAX ``TransformerConfig``;
    ``dtype`` is a torch dtype. The port runs ``attention_impl`` ``"dense"``
    and ``"pallas"`` (the flash kernels), ``decode_attention="dense"`` and
    ``ring_layout="contiguous"``; the sequence-parallel implementations are
    ROADMAP A10. ``paged_attention_impl`` takes only
    ``"pallas"``, the kernel route: the paged step always launches the
    ``ops.paged_attention`` kernel, and the lax composition the JAX
    package also offers is not ported. The pool geometry (``page_size``,
    ``num_pages``, ``kv_quant``) is read from the pool tensors a call
    passes, so a model serves any pool without a clone."""
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
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


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
        w = self.kernel.to(cfg.dtype).reshape(cfg.embed_dim, -1)
        qkv = (x.to(cfg.dtype) @ w).view(b, s, 3, cfg.num_heads,
                                         cfg.head_dim)
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
        w = self.kernel.to(cfg.dtype).reshape(cfg.embed_dim, -1)
        q = (x.to(cfg.dtype) @ w).view(b, s, cfg.num_heads, cfg.head_dim)
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
        w = self.kernel.to(cfg.dtype).reshape(cfg.embed_dim, -1)
        kv = (x.to(cfg.dtype) @ w).view(b, s, 2, cfg.kv_heads, cfg.head_dim)
        if head_major:
            return kv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        return kv[:, :, 0], kv[:, :, 1]


class OutProj(nn.Module):
    """Attention output projection, ``kernel`` (embed, embed); takes the
    natural (b, s, embed) attention output or, with ``head_major``, the (b,
    h, s, d) one."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.kernel = nn.Parameter(torch.empty(cfg.embed_dim, cfg.embed_dim))

    def forward(self, out, head_major=False):
        if head_major:
            b, _, s, _ = out.shape
            out = out.transpose(1, 2).reshape(b, s, self.cfg.embed_dim)
        return out.to(self.cfg.dtype) @ self.kernel.to(self.cfg.dtype)


class Attention(nn.Module):

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
                seq_lens=None, cache=None):
        cfg = self.cfg
        attention_ops.check_impl(cfg.attention_impl, cfg.ring_layout)
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
            out = self._decode_step(q, k, v, cache, pages, seq_lens)
        elif head_major:
            out = flash_attention.flash_attention_head_major(
                q, k, v, segment_ids=segment_ids)
            return self.out(out, head_major=True)
        else:
            out = attention_ops.causal_attention(
                q, k, v, impl=cfg.attention_impl, segment_ids=segment_ids,
                ring_layout=cfg.ring_layout)
        out = out.reshape(out.shape[:2] + (cfg.embed_dim,))
        return self.out(out)

    def _decode_step(self, q, k, v, cache, pages, seq_lens):
        """Append this call's K/V to the layer's cache and attend over the
        visible prefix.

        With ``pages``/``seq_lens`` the cache is the layer's slice of the
        shared page pool: one token per row, row r's token landing at
        position ``seq_lens[r]`` — page ``pages[r, seq_lens[r] //
        page_size]``, slot ``seq_lens[r] % page_size`` (inactive rows
        carry an all-trash table and write page 0) — then the
        ``ops.paged_attention`` kernel walks the pages. Without them the
        cache is a private contiguous one: the call's tokens (one decode
        step or a whole prompt chunk) land at ``cache_index`` and every
        query j attends to slots ``<= cache_index + j``."""
        cfg = self.cfg
        if cache is None:
            raise ValueError("decode mode needs a cache")
        b, s_step, h_kv, d = k.shape
        if pages is not None:
            if seq_lens is None:
                raise ValueError("paged decode needs seq_lens")
            if s_step != 1:
                raise ValueError(
                    "paged decode carries one token per row; got "
                    "{}".format(s_step))
            k_pages, v_pages = cache["k_pages"], cache["v_pages"]
            n_pages, ps = k_pages.shape[:2]
            page_ids = pages.gather(1, (seq_lens // ps)[:, None].long())[:, 0]
            dest = (page_ids * ps + seq_lens % ps).long()
            k_new, v_new = k[:, 0], v[:, 0]
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
            return pa_ops.paged_attention(
                q.contiguous(), k_pages, v_pages, pages, seq_lens,
                page_size=ps, k_scales=k_scales, v_scales=v_scales)
        if cfg.decode_attention != "dense":
            raise NotImplementedError(
                "decode_attention={!r} is not ported yet (ROADMAP "
                "A7b)".format(cfg.decode_attention))
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
        k_all, v_all = attention_ops._expand_kv(q, cached_k, cached_v)
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k_all).float()
                  * pa_ops._scale(d))
        visible = (torch.arange(cache_len, device=q.device)[None, :]
                   <= i + torch.arange(s_step, device=q.device)[:, None])
        logits = torch.where(visible[None, None], logits, _NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v_all)


class MLPBlock(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.up = Dense(cfg.embed_dim, cfg.mlp_dim, cfg.dtype)
        self.down = Dense(cfg.mlp_dim, cfg.embed_dim, cfg.dtype)

    def forward(self, x):
        # flax nn.gelu defaults to the tanh approximation.
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class Block(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.embed_dim, cfg.dtype)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(cfg.embed_dim, cfg.dtype)
        self.mlp = MLPBlock(cfg)

    def forward(self, x, segment_ids=None, decode=False, pages=None,
                seq_lens=None, cache=None):
        x = x + self.attn(self.ln1(x), segment_ids, decode, pages=pages,
                          seq_lens=seq_lens, cache=cache)
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
    head (:meth:`attend`) run in the model dtype."""

    def __init__(self, cfg):
        super().__init__()
        self.dtype = cfg.dtype
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size,
                                                  cfg.embed_dim))

    def forward(self, tokens):
        # Gather, then cast: the same values as flax's cast-then-gather,
        # without casting the whole table per call.
        return self.embedding[tokens].to(self.dtype)

    def attend(self, x):
        return x.to(self.dtype) @ self.embedding.to(self.dtype).t()


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
        for i in range(cfg.num_layers):
            self.add_module("block_{}".format(i), Block(cfg))
        self.ln_f = LayerNorm(cfg.embed_dim, cfg.dtype)
        self.reset_parameters(seed)
        self.to(dev)
        self.eval()

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

    def blocks(self):
        return [getattr(self, "block_{}".format(i))
                for i in range(self.cfg.num_layers)]

    def forward(self, tokens, segment_ids=None, decode=False,
                positions=None, pages=None, seq_lens=None, cache=None):
        """``tokens``: int (batch, seq). Without ``decode`` this runs the
        full causal forward, with optional packed ``segment_ids``/
        ``positions``; in train mode it records the autograd graph (see the
        module docstring). ``decode=True`` runs against ``cache``: a
        contiguous cache (position = tokens the cache has absorbed, one step
        or a prompt chunk per call), or with ``pages``/``seq_lens`` the paged
        pool — one token per row, row r at position ``seq_lens[r]``. Returns
        f32 logits (model-dtype logits with ``upcast_logits=False``)."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.training
                                    and not decode):
            return self._forward(tokens, segment_ids, decode, positions,
                                 pages, seq_lens, cache)

    def _forward(self, tokens, segment_ids, decode, positions, pages,
                 seq_lens, cache):
        cfg = self.cfg
        if cfg.ring_layout != "contiguous":
            raise NotImplementedError(
                "ring_layout={!r} is not ported yet (ROADMAP A10)".format(
                    cfg.ring_layout))
        seq_len = tokens.shape[1]
        x = self.embed(tokens)
        if decode:
            if positions is not None:
                raise NotImplementedError(
                    "decode mode derives positions from the cache")
            if cache is None:
                raise ValueError("decode mode needs a cache")
        if decode and pages is not None:
            if seq_lens is None:
                raise ValueError("paged decode needs seq_lens")
            if seq_len != 1:
                raise ValueError(
                    "paged decode carries one token per row; got "
                    "{}".format(seq_len))
            x = x + self.pos_embed[seq_lens.long()][:, None, :].to(cfg.dtype)
        elif decode:
            pos = cache["position"]
            if pos + seq_len > cfg.max_seq_len:
                raise ValueError(
                    "decode position {} + {} tokens exceeds max_seq_len "
                    "{}".format(pos, seq_len, cfg.max_seq_len))
            x = x + self.pos_embed[pos:pos + seq_len][None].to(cfg.dtype)
            cache["position"] = pos + seq_len
        else:
            if seq_len > cfg.max_seq_len:
                raise ValueError(
                    "sequence length {} exceeds max_seq_len {}".format(
                        seq_len, cfg.max_seq_len))
            if positions is None and segment_ids is not None:
                positions = _packed_positions(segment_ids)
            if positions is None:
                x = x + self.pos_embed[:seq_len][None].to(cfg.dtype)
            else:
                x = x + self.pos_embed[positions.long()].to(cfg.dtype)
        remat = cfg.remat and not decode and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks()):
            if remat:
                x = checkpoint(block, x, segment_ids, use_reentrant=False)
                continue
            layer_cache = None if cache is None else cache[
                "block_{}".format(i)]
            x = block(x, segment_ids, decode, pages=pages, seq_lens=seq_lens,
                      cache=layer_cache)
        x = self.ln_f(x)
        # Weight-tied head in the model dtype; logits upcast after.
        logits = self.embed.attend(x)
        return logits.float() if cfg.upcast_logits else logits
