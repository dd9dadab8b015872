"""Weights of the JAX package's models as the port's ``state_dict``.

Each function takes flax trees as nested dicts of numpy arrays
(``jax.device_get`` of the unboxed variables) and returns ``{name:
torch.Tensor}``:

* ``params_from_flax(params, cfg)`` for
  :class:`~tensorflowonspark_tpu_torch.models.transformer.TransformerLM`,
  whose kernels keep flax's layouts: a renaming; ``params_for_mesh``
  converts them full and keeps this rank's shards over a mesh;
* ``resnet_params_from_flax(variables, model)`` for the port's ResNets:
  ``params`` and ``batch_stats`` together, conv kernels HWIO -> OIHW;
* ``fused_block_params_from_jax(params)`` for
  ``ops.fused_resnet_block``'s parameter dict, dtype and layout kept;
* ``dense_params_from_flax(params, model)`` for the port's ``MLP`` and
  ``LinearRegression``, whose ``Dense_<i>`` layers keep flax's names and
  layouts: a renaming.

All check names and shapes: a tree of another depth or width fails
loudly instead of loading half a model.
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
    _check_names(flat, expected, "flax params and the config")
    out = {}
    for name, shape in expected.items():
        arr = np.asarray(flat[name])
        if arr.shape != shape:
            raise ValueError("{} has shape {}, config wants {}".format(
                name, arr.shape, shape))
        out[name.replace("/", ".")] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
    return out


def params_for_mesh(params, model, mesh, rules=None):
    """The flax ``params`` of a ``TransformerLM`` laid out for ``mesh``:
    converted full (:func:`params_from_flax`), then cut to this rank's
    shard of each parameter as ``Trainer.init`` lays them out
    (``parallel.sharding.ModelSharding``). ``model`` is the port's model
    with full parameters; it names the layout and is left as it is."""
    from tensorflowonspark_tpu_torch.parallel import sharding

    full = params_from_flax(params, model.cfg)
    return sharding.ModelSharding(model, mesh, rules).local_state_dict(full)


def _check_names(have, want, what):
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    if missing or extra:
        raise ValueError("{} do not match: missing {}, unexpected {}".format(
            what, missing, extra))


def _tensor(arr):
    """A CPU tensor of ``arr``'s dtype; bf16 numpy arrays (which
    ``torch.from_numpy`` does not take) pass through their bits."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def resnet_params_from_flax(variables, model):
    """The port's ``state_dict`` (f32 CPU tensors, running statistics
    included) for a flax ResNet's ``{"params": ..., "batch_stats": ...}``;
    ``model`` is the port's ResNet of the same depth and width. Conv
    kernels go from flax's HWIO to the port's OIHW."""
    flat = {"params/" + k: v for k, v in _flat(variables["params"]).items()}
    flat.update({"batch_stats/" + k: v for k, v in
                 _flat(variables.get("batch_stats", {})).items()})
    want = {}
    for name, t in model.state_dict().items():
        coll = "batch_stats" if name.endswith((".mean", ".var")) else "params"
        want["{}/{}".format(coll, name.replace(".", "/"))] = (name, t.shape)
    _check_names(flat, want, "flax ResNet variables and the model")
    out = {}
    for key, (name, shape) in want.items():
        arr = np.asarray(flat[key], dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)           # HWIO -> OIHW
        if arr.shape != tuple(shape):
            raise ValueError("{} has shape {}, the model wants {}".format(
                key, arr.shape, tuple(shape)))
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def fused_block_params_from_jax(params):
    """``ops.fused_resnet_block``'s parameter dict from the JAX one (the
    same keys and layouts: ``w1`` (C, F), ``w2`` (3, 3, F, F), ``w3`` (F,
    C), ``gamma*``/``beta*``), each leaf a CPU tensor of its own dtype."""
    want = ("w1", "w2", "w3", "gamma1", "beta1", "gamma2", "beta2", "gamma3",
            "beta3")
    _check_names(params, want, "fused-block params")
    c, f = np.shape(params["w1"])
    shapes = {"w1": (c, f), "w2": (3, 3, f, f), "w3": (f, c),
              "gamma1": (f,), "beta1": (f,), "gamma2": (f,), "beta2": (f,),
              "gamma3": (c,), "beta3": (c,)}
    out = {}
    for name, shape in shapes.items():
        if tuple(np.shape(params[name])) != shape:
            raise ValueError("{} has shape {}, want {}".format(
                name, tuple(np.shape(params[name])), shape))
        out[name] = _tensor(params[name])
    return out


def dense_params_from_flax(params, model):
    """The port's ``state_dict`` (f32 CPU tensors) for the flax ``params``
    of an ``MLP`` or ``LinearRegression``; ``model`` is the port's module
    of the same widths."""
    flat = _flat(params)
    want = {name.replace(".", "/"): (name, tuple(t.shape))
            for name, t in model.state_dict().items()}
    _check_names(flat, want, "flax Dense params and the model")
    out = {}
    for key, (name, shape) in want.items():
        arr = np.array(flat[key], dtype=np.float32, order="C")
        if arr.shape != shape:
            raise ValueError("{} has shape {}, the model wants {}".format(
                key, arr.shape, shape))
        out[name] = torch.from_numpy(arr)
    return out
