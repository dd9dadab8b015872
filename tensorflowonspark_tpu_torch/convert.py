"""Weights of the JAX package's ``TransformerLM`` as the port's
``state_dict``.

``params_from_flax(params, cfg)`` takes the flax ``params`` tree (nested
dicts of numpy arrays — ``jax.device_get`` of the unboxed
``variables["params"]``) and
returns ``{name: torch.Tensor}`` for
:class:`~tensorflowonspark_tpu_torch.models.transformer.TransformerLM`.
The port keeps flax's kernel layouts, so the conversion is a renaming
plus shape checks: a tree from another geometry fails loudly instead of
loading half a model.
"""

from collections.abc import Mapping

import numpy as np
import torch


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = "{}{}".format(prefix, key)
        if isinstance(val, Mapping):
            out.update(_flat(val, name + "/"))
        else:
            out[name] = val
    return out


def _expected(cfg):
    e, h, d, h_kv = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.kv_heads
    shapes = {
        "embed/embedding": (cfg.vocab_size, e),
        "pos_embed": (cfg.max_seq_len, e),
        "ln_f/scale": (e,),
        "ln_f/bias": (e,),
    }
    for i in range(cfg.num_layers):
        b = "block_{}/".format(i)
        for ln in ("ln1", "ln2"):
            shapes[b + ln + "/scale"] = (e,)
            shapes[b + ln + "/bias"] = (e,)
        if h_kv == h:
            shapes[b + "attn/qkv/kernel"] = (e, 3, h, d)
        else:
            shapes[b + "attn/q/kernel"] = (e, h, d)
            shapes[b + "attn/kv/kernel"] = (e, 2, h_kv, d)
        shapes[b + "attn/out/kernel"] = (e, e)
        shapes[b + "mlp/up/kernel"] = (e, cfg.mlp_dim)
        shapes[b + "mlp/down/kernel"] = (cfg.mlp_dim, e)
    return shapes


def params_from_flax(params, cfg):
    """The port's ``state_dict`` (f32 CPU tensors) for the flax ``params``
    tree of a ``TransformerLM`` with config ``cfg`` (the port's
    :class:`TransformerConfig`)."""
    flat = _flat(params)
    expected = _expected(cfg)
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise ValueError("flax params do not match the config: missing {}, "
                         "unexpected {}".format(missing, extra))
    out = {}
    for name, shape in expected.items():
        arr = np.asarray(flat[name])
        if arr.shape != shape:
            raise ValueError("{} has shape {}, config wants {}".format(
                name, arr.shape, shape))
        out[name.replace("/", ".")] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
    return out
