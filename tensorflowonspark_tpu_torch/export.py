"""Model export and import (port of ``export.py``): the SavedModel analog.

:func:`export_saved_model` writes a self-describing export directory — the
variables plus a JSON manifest naming the registry model and its
signatures — from which :func:`load_saved_model` rebuilds the forward
without the training program; :func:`load_from_checkpoint` does the same
from a training checkpoint. The manifest's keys (``format_version``,
``model``, ``model_kwargs``, ``signatures``, ``tag_set``) are the JAX
package's, field for field; ``model_kwargs`` hold JSON values only, a
torch dtype written by name (``"bfloat16"``), and never ``device`` or
``seed``: the device is the loader's.

Export directory layout::

    export_dir/
      saved_model.json           manifest: model name/kwargs, signatures, tags
      variables.pt               torch.save({"params": state_dict,
                                             "model_state": buffers})
      torch_export/<key>.pt2     (with ``example_inputs``) one torch.export
                                 program per signature: the AOT serving
                                 artifact

The variables file is the port's own: the JAX package's
``variables.msgpack`` (flax serialization) is refused with an error that
names it. It is read back with ``torch.load(weights_only=True)``.

The ``torch_export/`` programs are the port's counterpart of the JAX
package's StableHLO artifacts: :func:`load_serving_model` runs them without
the model's registry code (no module of ``models/`` is imported). Each is a
function of ``(variables, x)`` traced through ``torch.func.functional_call``,
so the program holds no weights — the loader reads the variables file, as
the JAX loader does — and one symbolic batch dimension covers every
input's leading axis. As in JAX, the artifact runs dense attention: the
export forces ``attention_impl="dense"`` (and ``ring_layout=
"contiguous"``), so no kernel lives inside it and it serves on a CPU host
and on the card alike. The loader moves the program to its device
(``torch.export.passes.move_to_device_pass``); a program written on a CPU
host therefore serves on the card, and a device the program cannot move to
is an error at load, never a fallback to the CPU.

Signatures mirror the reference's simplified signature dict:
``{key: {"inputs": {alias: selector}, "outputs": {alias: selector}}}``
where an input selector names the feed column bound to that alias and an
output selector picks from the model output (``None`` — the whole output;
a string — a dict key; an int — a tuple index).

Not ported: ``tf_saved_model=True`` (a TensorFlow SavedModel for the
TF-C-API runners ``cpp/serving.cc``/``cpp/inference.cc``) raises
``NotImplementedError`` naming ROADMAP A13; JAX's ``compile_log``
(``introspect.py``) has no counterpart on this path.
"""

import copy
import json
import logging

import numpy as np
import torch

from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch import fs as fs_lib
from tensorflowonspark_tpu_torch.parallel import multihost

logger = logging.getLogger(__name__)

MANIFEST = "saved_model.json"
VARIABLES = "variables.pt"
JAX_VARIABLES = "variables.msgpack"
TORCH_EXPORT_DIR = "torch_export"
# The dtype each artifact's inputs were traced with ({key: {alias: name}}):
# the loader casts a feed to it, as JAX's artifact takes float64 and int64
# arrays at float32 and int32.
INPUT_DTYPES = "torch_export_input_dtypes"

DEFAULT_SIGNATURE_KEY = "serving_default"
DEFAULT_TAG = "serve"

# Constructor keywords that belong to the process, not to the model.
_RUNTIME_KWARGS = ("device", "seed")


def default_signatures(input_alias="x", output_alias="out"):
    """The one-input one-output signature most models need."""
    return {
        DEFAULT_SIGNATURE_KEY: {
            "inputs": {input_alias: input_alias},
            "outputs": {output_alias: None},
        }
    }


def export_saved_model(export_dir, model_name, state=None, params=None,
                       model_state=None, model_kwargs=None, signatures=None,
                       tag_set=(DEFAULT_TAG,), example_inputs=None,
                       tf_saved_model=False):
    """Write an export directory for a registry model.

    ``state`` may be a :class:`~tensorflowonspark_tpu_torch.train.trainer.
    TrainState` (its parameters and buffers are written), or pass
    ``params`` (and optionally ``model_state``) as ``state_dict``s.

    Under a multi-process runtime every rank must reach this call: a state
    whose parameters are sharded over a mesh is gathered to full tensors
    (``train.checkpoint.full_params``, the checkpoint's gather), and rank 0
    alone writes.

    With ``example_inputs`` (one example batch: an array, or ``{alias:
    array}`` for multi-input signatures; only shapes and dtypes matter, the
    leading batch dimension becomes symbolic) the export also writes a
    ``torch.export`` serving program per signature, traced on the device
    the parameters lie on, which :func:`load_serving_model` runs without
    this model's Python code.

    ``tf_saved_model=True`` raises ``NotImplementedError``: the TensorFlow
    SavedModel and its C runners are ROADMAP A13.
    """
    if tf_saved_model:
        raise NotImplementedError(
            "tf_saved_model: the TensorFlow SavedModel export and its "
            "TF-C-API runners (cpp/serving.cc, cpp/inference.cc) are not "
            "ported (ROADMAP A13); export with example_inputs for the "
            "torch.export serving artifact")
    if state is not None:
        from tensorflowonspark_tpu_torch.train import checkpoint

        params = checkpoint.full_params(state)
        model_state = state.model_state
    if params is None:
        raise ValueError("export requires a state or params")
    if isinstance(tag_set, str):
        tag_set = [tag_set]
    kwargs = _jsonable(model_kwargs or {})
    if multihost.is_multiprocess() and multihost.process_index() != 0:
        return export_dir

    fs_lib.makedirs(export_dir)
    tree = {"params": _host(params), "model_state": _host(model_state or {})}
    with fs_lib.open(fs_lib.join(export_dir, VARIABLES), "wb") as f:
        torch.save(tree, f)

    manifest = {
        "format_version": 1,
        "model": model_name,
        "model_kwargs": kwargs,
        "signatures": signatures or default_signatures(),
        "tag_set": sorted(tag_set),
    }
    if example_inputs is not None:
        manifest[TORCH_EXPORT_DIR], manifest[INPUT_DTYPES] = \
            _export_programs(
                export_dir, model_name, _dekey(kwargs),
                {**params, **(model_state or {})}, manifest["signatures"],
                example_inputs,
            )
    with fs_lib.open(fs_lib.join(export_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    logger.info("exported model %r to %s (signatures: %s)",
                model_name, export_dir, sorted(manifest["signatures"]))
    return export_dir


class _Forward(torch.nn.Module):
    """``(variables, x) -> model(x)`` with ``variables`` substituted for the
    model's parameters and buffers. The model is held outside the module
    tree, so the exported program lifts no weights of its own."""

    def __init__(self, model):
        super().__init__()
        self.__dict__["_model"] = model

    def forward(self, variables, x):
        return torch.func.functional_call(self._model, variables, (x,))


def _serving_kwargs(model_kwargs):
    """The AOT coercions of the JAX package: dense attention and the
    contiguous layout, so that no kernel lives inside the program."""
    model_kwargs = dict(model_kwargs)
    if model_kwargs.get("attention_impl", "dense") != "dense":
        logger.info(
            "AOT export: forcing attention_impl='dense' (was %r) — the "
            "serving artifact carries no kernel, so that it serves on a CPU "
            "host and on the card", model_kwargs["attention_impl"],
        )
        model_kwargs["attention_impl"] = "dense"
    if model_kwargs.get("ring_layout", "contiguous") != "contiguous":
        model_kwargs["ring_layout"] = "contiguous"
    return model_kwargs


def _example(a, device):
    """A zero tensor shaped like example input ``a``, traced at a batch of
    at least 2: a batch of 1 would specialise the symbolic batch to 1."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    if t.dim() == 0:
        raise ValueError("example inputs must be batched (got a scalar)")
    return torch.zeros((max(2, t.shape[0]),) + tuple(t.shape[1:]),
                       dtype=t.dtype, device=device)


def _export_programs(export_dir, model_name, model_kwargs, variables,
                     signatures, example_inputs):
    """Write one program per signature; returns the manifest entries
    ``{signature_key: relative_path}`` and ``{signature_key: {alias:
    dtype name}}``."""
    from tensorflowonspark_tpu_torch.models import factory

    variables = {k: v.detach() for k, v in variables.items()}
    device = next(iter(variables.values())).device
    model = factory.get_model(model_name, device=str(device),
                              **_serving_kwargs(model_kwargs))
    forward = _Forward(model)
    # One shared symbolic batch: every input's leading axis scales
    # together, so serving may use any batch size.
    batch = torch.export.Dim("batch", min=1)
    var_dims = {k: None for k in variables}

    entries, dtypes = {}, {}
    fs_lib.makedirs(fs_lib.join(export_dir, TORCH_EXPORT_DIR))
    for key, signature in signatures.items():
        aliases = sorted(signature["inputs"])
        if isinstance(example_inputs, dict):
            missing = [a for a in aliases if a not in example_inputs]
            if missing:
                raise ValueError(
                    "example_inputs missing aliases {} for signature "
                    "{!r}".format(missing, key)
                )
            if len(aliases) == 1:
                x = _example(example_inputs[aliases[0]], device)
                x_dims = {0: batch}
            else:
                x = {a: _example(example_inputs[a], device) for a in aliases}
                x_dims = {a: {0: batch} for a in aliases}
        else:
            if len(aliases) != 1:
                raise ValueError(
                    "signature {!r} has {} inputs; example_inputs must be "
                    "a dict".format(key, len(aliases))
                )
            x = _example(example_inputs, device)
            x_dims = {0: batch}
        dtypes[key] = {a: _dtype_name((x[a] if isinstance(x, dict) else x)
                                      .dtype) for a in aliases}
        # Traced without autograd: the model's grad-mode switch would
        # otherwise enter the graph as a higher-order op.
        with torch.no_grad():
            program = torch.export.export(
                forward, (variables, x), dynamic_shapes=(var_dims, x_dims),
                strict=False)
        # The example arguments would carry the traced variables into the
        # archive: the weights, a second time.
        program.example_inputs = None
        rel = "{}/{}.pt2".format(TORCH_EXPORT_DIR, key)
        with fs_lib.open(fs_lib.join(export_dir, rel), "wb") as f:
            torch.export.save(program, f)
        entries[key] = rel
        logger.info("wrote AOT serving artifact %s (traced on %s)", rel,
                    device)
    return entries, dtypes


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _host(tree):
    return {k: v.detach().to("cpu") for k, v in tree.items()}


def _to_numpy(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()  # exact; numpy has no bfloat16
        return t.cpu().numpy()
    return np.asarray(t)


class LoadedModel:
    """A rebuilt inference model: forward + signature bindings.

    The analog of the reference's cached SavedModel session: construct
    once per process, call :meth:`predict` per batch. ``model`` is the
    registry model holding ``variables`` (a flat ``state_dict`` on
    ``device``), or None for the AOT program, which ``forward(x)`` runs.
    """

    def __init__(self, model, variables, signature, model_name=None,
                 forward=None, device=None):
        self.model = model
        self.variables = variables
        self.signature = signature
        self.model_name = model_name
        if forward is None:
            forward = model
            device = model.device
        self._forward = forward
        self.device = torch.device(device)

    @property
    def input_aliases(self):
        return sorted(self.signature["inputs"])

    @property
    def output_aliases(self):
        return sorted(self.signature["outputs"])

    def predict(self, feed):
        """Run one batch.

        ``feed`` is ``{input_alias: array}`` — entries may equivalently be
        keyed by the alias's bound feed column (the signature's input
        selector), so callers holding column-named data need no renaming. A
        bare array is accepted for single-input signatures. Returns
        ``{output_alias: np.ndarray}`` (bfloat16 outputs as float32).
        """
        inputs = self.signature["inputs"]
        if not isinstance(feed, dict):
            if len(inputs) != 1:
                raise ValueError(
                    "signature has {} inputs; feed must be a dict".format(
                        len(inputs)
                    )
                )
            feed = {next(iter(inputs)): feed}

        def lookup(alias):
            if alias in feed:
                return feed[alias]
            column = inputs[alias]
            if column is not None and column in feed:
                return feed[column]
            raise KeyError(
                "feed is missing input {!r} (bound column {!r}); feed has "
                "{}".format(alias, column, sorted(feed))
            )

        def as_input(v):
            # A tuple input (wide & deep's (categorical, numeric)) goes to
            # the forward as a tuple of tensors.
            if isinstance(v, (tuple, list)):
                return tuple(as_input(e) for e in v)
            # Already on the device (a DevicePrefetch-ed feed): passed
            # straight into the forward, no round trip through the host.
            if isinstance(v, torch.Tensor):
                return v if v.device == self.device else v.to(self.device)
            return torch.as_tensor(np.asarray(v), device=self.device)

        if len(inputs) == 1:
            x = as_input(lookup(next(iter(inputs))))
        else:
            # Multi-input signatures feed a dict straight through.
            x = {a: as_input(lookup(a)) for a in inputs}
        with torch.no_grad():
            out = self._forward(x)
        return {alias: _to_numpy(_select(out, selector))
                for alias, selector in self.signature["outputs"].items()}

    def _registry_model(self, what):
        if self.model is None:
            raise ValueError(
                "{} needs the registry model — load with "
                "load_saved_model(prefer_aot=False) or "
                "load_from_checkpoint".format(what)
            )
        return self.model

    def generate(self, prompt, max_new_tokens, **kwargs):
        """Autoregressive generation for LM exports (KV-cache decoding;
        see :func:`tensorflowonspark_tpu_torch.models.decoding.generate`).

        Needs the rebuilt registry model: AOT serving artifacts are
        fixed-shape forward programs with no cache plumbing."""
        model = self._registry_model("generation")
        from tensorflowonspark_tpu_torch.models import decoding

        return decoding.generate(
            model, self.variables, prompt, max_new_tokens, **kwargs
        )

    def serving_engine(self, **kwargs):
        """A continuous-batching :class:`~tensorflowonspark_tpu_torch.
        serving.ServingEngine` over this export's model and weights, the
        weights cast to the serving dtype once
        (``decoding.serving_variables``). Same registry-model requirement
        as :meth:`generate`. The engine adopts its weights into a copy of
        the model that shares the module structure and none of its
        parameter slots, so :meth:`predict` keeps this export's weights."""
        model = self._registry_model("serving")
        from tensorflowonspark_tpu_torch import serving
        from tensorflowonspark_tpu_torch.models import decoding

        shared = {id(t): t for t in model.state_dict(keep_vars=True)
                  .values()}
        engine_model = copy.deepcopy(model, memo=shared)
        kwargs.setdefault("device", str(self.device))
        return serving.ServingEngine(
            engine_model, decoding.serving_variables(self.variables),
            **kwargs)


def _select(out, selector):
    if selector is None:
        if isinstance(out, dict):
            if len(out) == 1:
                return next(iter(out.values()))
            raise ValueError(
                "output selector None is ambiguous for dict output with "
                "keys {}".format(sorted(out))
            )
        return out
    if isinstance(selector, int) or (
        isinstance(selector, str) and selector.isdigit()
    ):
        return out[int(selector)]
    return out[selector]


def read_manifest(export_dir):
    with fs_lib.open(fs_lib.join(export_dir, MANIFEST), "r") as f:
        return json.load(f)


def _check_tags(manifest, tag_set):
    if tag_set:
        wanted = set([tag_set] if isinstance(tag_set, str) else tag_set)
        if not wanted.issubset(manifest["tag_set"]):
            raise ValueError(
                "tag_set {} not in export tags {}".format(
                    sorted(wanted), manifest["tag_set"]
                )
            )


def _device(device):
    """The loader's device, a card's index made explicit."""
    dev = device_info.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _read_variables(export_dir, device):
    """The export's flat ``state_dict`` on ``device``."""
    path = fs_lib.join(export_dir, VARIABLES)
    if not fs_lib.exists(path) and fs_lib.exists(
            fs_lib.join(export_dir, JAX_VARIABLES)):
        raise ValueError(
            "export at {} holds {} (the JAX package's flax serialization); "
            "the port reads {} written by its own export_saved_model — "
            "re-export the weights with the port".format(
                export_dir, JAX_VARIABLES, VARIABLES))
    with fs_lib.open(path, "rb") as f:
        tree = torch.load(f, map_location=device, weights_only=True)
    return {**tree["params"], **tree.get("model_state", {})}


def load_saved_model(export_dir, signature_def_key=None, tag_set=None,
                     prefer_aot=True, device="cuda"):
    """Rebuild a :class:`LoadedModel` from an export directory on
    ``device`` (the card unless ``"cpu"`` is asked for).

    When the export carries an AOT serving artifact for the requested
    signature, that program is used (no model code executes); pass
    ``prefer_aot=False``, or let an unusable artifact fall back, to rebuild
    the model from the registry on the same device.
    """
    manifest = read_manifest(export_dir)
    key = signature_def_key or DEFAULT_SIGNATURE_KEY
    if prefer_aot and key in manifest.get(TORCH_EXPORT_DIR, {}):
        try:
            return load_serving_model(
                export_dir, signature_def_key=signature_def_key,
                tag_set=tag_set, device=device,
            )
        except Exception as e:
            logger.warning(
                "AOT serving artifact unusable (%s); rebuilding %r from "
                "the model registry", e, manifest.get("model"),
            )
    _check_tags(manifest, tag_set)
    if key not in manifest["signatures"]:
        raise ValueError(
            "signature {!r} not in export (has: {})".format(
                key, sorted(manifest["signatures"])
            )
        )
    from tensorflowonspark_tpu_torch.models import decoding, factory

    dev = _device(device)
    variables = _read_variables(export_dir, dev)
    model = factory.get_model(manifest["model"], device=str(dev),
                              **_dekey(manifest["model_kwargs"]))
    decoding.load_variables(model, variables)
    logger.info("loaded exported model %r from %s (signature %r)",
                manifest["model"], export_dir, key)
    return LoadedModel(model, variables, manifest["signatures"][key],
                       manifest["model"])


def load_serving_model(export_dir, signature_def_key=None, tag_set=None,
                       device="cuda"):
    """Rebuild a :class:`LoadedModel` from the export's ``torch.export``
    artifact on ``device`` — no registry or model code is imported or
    executed; only the serialized program and the variables file are read.
    The program is moved to ``device``; one it cannot move to raises here,
    at load, not at the first predict."""
    manifest = read_manifest(export_dir)
    if TORCH_EXPORT_DIR not in manifest:
        raise ValueError(
            "export at {} has no AOT serving artifact (re-export with "
            "example_inputs)".format(export_dir)
        )
    _check_tags(manifest, tag_set)
    key = signature_def_key or DEFAULT_SIGNATURE_KEY
    if key not in manifest[TORCH_EXPORT_DIR]:
        raise ValueError(
            "signature {!r} has no serving artifact (has: {})".format(
                key, sorted(manifest[TORCH_EXPORT_DIR])
            )
        )
    from torch.export.passes import move_to_device_pass

    dev = _device(device)
    path = fs_lib.join(export_dir, manifest[TORCH_EXPORT_DIR][key])
    with fs_lib.open(path, "rb") as f:
        program = torch.export.load(f)
    try:
        program = move_to_device_pass(program, dev)
    except Exception as e:
        raise ValueError("serving artifact {} cannot move to {}: {}".format(
            path, dev, e)) from e
    variables = _read_variables(export_dir, dev)
    module = program.module()
    dtypes = {a: getattr(torch, name) for a, name in
              manifest.get(INPUT_DTYPES, {}).get(key, {}).items()}

    def forward(x):
        if isinstance(x, dict):
            x = {a: t.to(dtypes.get(a, t.dtype)) for a, t in x.items()}
        elif dtypes:
            x = x.to(next(iter(dtypes.values())))
        return module(variables, x)

    logger.info("loaded AOT serving model from %s (signature %r) on %s",
                export_dir, key, dev)
    return LoadedModel(
        None, variables, manifest["signatures"][key], manifest.get("model"),
        forward=forward, device=dev,
    )


def load_from_checkpoint(model_dir, model_name, model_kwargs=None,
                         signatures=None, signature_def_key=None,
                         device="cuda"):
    """Rebuild a :class:`LoadedModel` from a training checkpoint directory
    (``train.checkpoint.CheckpointManager``'s latest committed step) on
    ``device``. Needs the registry model name: checkpoints hold tensors,
    not programs. A directory that does not exist raises
    ``FileNotFoundError`` (and is not created)."""
    from tensorflowonspark_tpu_torch.models import decoding, factory
    from tensorflowonspark_tpu_torch.train import checkpoint as ckpt_lib

    if fs_lib.is_local(model_dir) and not fs_lib.isdir(model_dir):
        raise FileNotFoundError("no checkpoint under {}".format(model_dir))
    dev = _device(device)
    model = factory.get_model(model_name, device=str(dev),
                              **_dekey(_jsonable(model_kwargs or {})))
    mgr = ckpt_lib.CheckpointManager(model_dir)
    try:
        variables = mgr.restore_variables()
    finally:
        mgr.close()
    variables = {k: v.to(dev) for k, v in variables.items()}
    decoding.load_variables(model, variables)
    sigs = signatures or default_signatures()
    key = signature_def_key or DEFAULT_SIGNATURE_KEY
    logger.info("restored %r from checkpoint dir %s", model_name, model_dir)
    return LoadedModel(model, variables, sigs[key], model_name)


def _jsonable(kwargs):
    """Model kwargs as the manifest holds them: ``device`` and ``seed``
    dropped, torch dtypes by name, every value JSON."""
    out = {}
    for k, v in kwargs.items():
        if k in _RUNTIME_KWARGS:
            continue
        if isinstance(v, torch.dtype):
            v = _dtype_name(v)
        try:
            json.dumps(v)
        except TypeError:
            raise TypeError(
                "model_kwargs[{!r}] = {!r} is not a JSON value".format(k, v))
        out[str(k)] = v
    return out


def _dekey(kwargs):
    """JSON round-trips tuples to lists and dtypes to names: lists come
    back as tuples (frozen config fields) and a ``dtype`` (or ``*_dtype``)
    name as the torch dtype."""
    out = {}
    for k, v in (kwargs or {}).items():
        k = str(k)
        if isinstance(v, list):
            v = tuple(v)
        elif isinstance(v, str) and (k == "dtype" or k.endswith("_dtype")):
            dt = getattr(torch, v, None)
            if not isinstance(dt, torch.dtype):
                raise ValueError("model_kwargs[{!r}]: {!r} names no torch "
                                 "dtype".format(k, v))
            v = dt
        out[k] = v
    return out
