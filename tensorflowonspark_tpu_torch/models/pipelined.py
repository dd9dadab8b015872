"""Pipeline-parallel transformer LM (port of ``models/pipelined.py``).

The blocks live in stacked stage parameters: every block parameter is one
tensor with leading axes ``(num_rounds, num_stages / num_rounds,
layers_per_stage)`` (logical axes ``("round", "stage", "layers")``),
canonical depth order, run through the GPipe or interleaved schedule of
:mod:`..parallel.pipeline`. ``stage``, axis 1, shards over the mesh
``pipe`` axis in contiguous chunks: pipe rank ``d`` of ``n`` holds rows
``[d*g, (d+1)*g)`` of every round (``g = num_stages / (num_rounds * n)``),
which is the JAX package's factored ``(v, n, g, l, ...)`` layout
(``parallel.pipeline.factor_stage_params``) with its ``n`` and ``g`` axes
merged. So each pipe rank holds exactly its schedule chunks and a step
moves no parameter, and the full shape does not depend on the pipe
degree: a checkpoint restores under any degree as it is, and
:func:`convert_stage_layout` matters only for JAX trees, whose layout
does. The block is functional (:func:`_block_apply`), as in JAX: the
schedule applies one stage's parameter slice at a time.

The embedding, positions, final norm and tied head are
:class:`~.transformer.TransformerLM`'s; only :meth:`apply_blocks` differs.
Decode, GQA and ``segment_ids`` raise, as they do in JAX.

Initializers follow flax's ``he_normal(in_axis=-2, out_axis=-1)`` on the
stacked shapes, which counts every leading axis into the fan-in: a block
kernel's fan-in is its element count over its last dimension (``qkv``
``(v, s/v, l, d, 3, h, hd)``: ``num_layers * d * 3 * h``), not the dense
LM's ``embed``.
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch.initializers import truncated_normal_
from tensorflowonspark_tpu_torch.models import transformer as transformer_lib
from tensorflowonspark_tpu_torch.ops import attention as attention_ops
from tensorflowonspark_tpu_torch.ops import flash_attention
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel import pipeline as pp


@dataclasses.dataclass(frozen=True)
class PipelinedConfig(transformer_lib.TransformerConfig):
    num_stages: int = 2
    num_microbatches: int = 4
    num_rounds: int = 1  # >1 = interleaved schedule (v-fold smaller bubble)


STAGE_PARAM_KEYS = ("ln1_scale", "ln1_bias", "qkv", "attn_out",
                    "ln2_scale", "ln2_bias", "up", "down")


def _layer_norm(x, scale, bias, eps=1e-6):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _block_apply(p, x, cfg):
    """One transformer block, functional (the JAX ``_block_apply``)."""
    dt = cfg.dtype
    b, s, m = x.shape
    h = p["qkv"].shape[-2]
    y = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    qkv = (y @ p["qkv"].to(dt).reshape(m, -1)).view(b, s, 3, h, -1)
    if cfg.attention_impl == "pallas":
        # The flash route's head-major layout, as the dense LM's.
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        out = flash_attention.flash_attention_head_major(q, k, v)
        out = out.transpose(1, 2)
    else:
        out = attention_ops.causal_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
            impl=cfg.attention_impl)
    x = x + out.reshape(b, s, -1) @ p["attn_out"].to(dt).reshape(-1, m)
    y = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    hid = F.gelu(y @ p["up"].to(dt), approximate="tanh")
    return x + hid @ p["down"].to(dt)


def _stage_shapes(cfg):
    d, h = cfg.embed_dim, cfg.num_heads
    hd = d // h
    return {"ln1_scale": (d,), "ln1_bias": (d,), "qkv": (d, 3, h, hd),
            "attn_out": (h, hd, d), "ln2_scale": (d,), "ln2_bias": (d,),
            "up": (d, cfg.mlp_dim), "down": (cfg.mlp_dim, d)}


_STAGE_AXES = {"ln1_scale": ("embed",), "ln1_bias": ("embed",),
               "qkv": ("embed", None, "heads", "head_dim"),
               "attn_out": ("heads", "head_dim", "embed"),
               "ln2_scale": ("embed",), "ln2_bias": ("embed",),
               "up": ("embed", "mlp"), "down": ("mlp", "embed")}


def _stage_lead(cfg):
    """The stage parameters' leading axes ``(v, s/v, l)``."""
    s, v = cfg.num_stages, cfg.num_rounds
    if cfg.num_layers % s:
        raise ValueError("num_layers must divide into num_stages")
    if s % v:
        raise ValueError("num_stages={} must be a multiple of num_rounds "
                         "({})".format(s, v))
    return (v, s // v, cfg.num_layers // s)


def _pipe_degree(cfg, mesh):
    """The ``pipe`` size of ``mesh``, checked against the config (the JAX
    model's error at init under its mesh)."""
    n = mesh.shape.get("pipe", 1) if mesh is not None else 1
    s, v = cfg.num_stages, cfg.num_rounds
    if s % (n * v):
        raise ValueError(
            "num_stages={} must be a multiple of pipe ({}) x num_rounds "
            "({})".format(s, n, v))
    return n


class PipelinedTransformerLM(transformer_lib.TransformerLM):
    """The pipelined LM; its block parameters are the module's own
    ``ln1_scale``, ``ln1_bias``, ``qkv``, ``attn_out``, ``ln2_scale``,
    ``ln2_bias``, ``up`` and ``down`` (the JAX tree's top-level names)."""

    def build_blocks(self):
        lead = _stage_lead(self.cfg)
        for key, shape in _stage_shapes(self.cfg).items():
            self.register_parameter(key, nn.Parameter(torch.empty(
                lead + shape)))

    def blocks(self):
        return []

    @torch.no_grad()
    def reset_parameters(self, seed):
        gen = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("embedding") or name == "pos_embed":
                nn.init.normal_(p, 0.0, 0.02, generator=gen)
            elif name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                # flax's fan-in: every axis but the last.
                truncated_normal_(p, 2.0 * p.shape[-1] / p.numel(), gen)

    def param_axes(self):
        axes = {"embed.embedding": ("vocab", None),
                "pos_embed": (None, "embed")}
        for key, logical in _STAGE_AXES.items():
            axes[key] = ("round", "stage", "layers") + logical
        return axes

    def apply_sharding(self, sharding):
        self._sharding = sharding
        self._mesh = None if sharding is None else sharding.mesh
        if sharding is None:
            return
        _pipe_degree(self.cfg, sharding.mesh)
        for name in sharding.sharded_names:
            axes = {a for spec in sharding.layouts[name].spec for a in spec}
            if axes - {"pipe"}:
                raise NotImplementedError(
                    "{}: the pipelined LM shards its stages over pipe "
                    "only, not {} (ROADMAP A10c)".format(name,
                                                         sorted(axes)))

    def _forward(self, tokens, segment_ids, decode, *args):
        cfg = self.cfg
        if decode:
            raise NotImplementedError(
                "PipelinedTransformerLM does not support decode mode")
        if cfg.num_kv_heads and cfg.num_kv_heads != cfg.num_heads:
            raise NotImplementedError(
                "PipelinedTransformerLM does not support GQA "
                "(num_kv_heads) yet")
        if segment_ids is not None:
            raise NotImplementedError(
                "PipelinedTransformerLM does not support segment_ids yet")
        return super()._forward(tokens, segment_ids, decode, *args)

    def apply_blocks(self, x, segment_ids=None, decode=False, pages=None,
                     seq_lens=None, cache=None, verify=False):
        cfg = self.cfg
        layers = cfg.num_layers // cfg.num_stages
        remat = cfg.remat and torch.is_grad_enabled()

        def stage_fn(params, x):
            for i in range(layers):
                p_i = {k: a[i] for k, a in params.items()}
                if remat:
                    x = checkpoint(_block_apply, p_i, x, cfg,
                                   use_reentrant=False)
                else:
                    x = _block_apply(p_i, x, cfg)
            return x

        # This model's rows as the factored (v, n, g, ...) layout, or the
        # rank's (v, 1, g, ...) shard of it when axis 1 is sharded.
        g = cfg.num_stages // (
            cfg.num_rounds * _pipe_degree(cfg, mesh_lib.current_mesh()))
        stage_params = {k: getattr(self, k).unflatten(1, (-1, g))
                        for k in STAGE_PARAM_KEYS}
        return pp.pipeline(stage_fn, stage_params, x, cfg.num_microbatches,
                           num_rounds=cfg.num_rounds, factored=True)


def convert_stage_layout(params, num_rounds, pipe_n):
    """The JAX pipelined LM's stage parameters reshaped to the factored
    layout of another pipe degree (``(v, n, g, l, ...)`` leading axes;
    pure reshapes, canonical depth order kept), as the JAX function does;
    other entries pass through. The port's own layout is ``pipe_n=1``'s
    without its unit axis (``convert.params_from_flax``)."""
    v, n = int(num_rounds), int(pipe_n)

    def reshape(a):
        lead = a.shape[0] * a.shape[1] * a.shape[2]
        if lead % (v * n):
            raise ValueError(
                "cannot factor {} stages into num_rounds={} x pipe={}"
                .format(lead, v, n))
        return a.reshape((v, n, lead // (v * n)) + tuple(a.shape[3:]))

    out = dict(params)
    for key in STAGE_PARAM_KEYS:
        if key in out:
            out[key] = reshape(out[key])
    return out
