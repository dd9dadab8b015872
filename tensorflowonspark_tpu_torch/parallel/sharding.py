"""Parameters laid out over a :class:`~.mesh.ProcessMesh` (the port of the
JAX Trainer's ``state_sharding``: logical axes resolved through the rules
to ``NamedSharding``\\ s).

A model names each parameter's logical axes (``model.param_axes()``:
``{state_dict name: ("embed", "mlp")}``; a name it leaves out is
replicated). :class:`ModelSharding` resolves them against the mesh and the
rules (:func:`~.mesh.resolve_spec`) and keeps, for every parameter, the
rank's shard: along each dimension whose spec entry names mesh axes
``(a, b, ...)`` (outermost first) the dimension of size ``n`` splits into
``k = prod(sizes)`` chunks of ``ceil(n / k)`` rows, as XLA splits it, and
the rank holds chunk ``mesh.index((a, b, ...))``, zero-padded to the chunk
size at the end of the dimension.

How a shard is used:

* ``fsdp`` (always the innermost axis of an entry): the module gathers
  the dimension over the fsdp group before each use
  (:meth:`ModelSharding.gather`, an autograd all-gather whose backward is
  the reduce-scatter), so the optimizer holds and updates only the shard
  — ZeRO-3, as the JAX package's embed-axis sharding behaves;
* ``tensor``: the module computes on its slab (Megatron's column- and
  row-parallel layers, the vocab-parallel embedding and head); the model
  decides which dimension that may be (:meth:`tensor_slab`);
* ``pipe`` and ``expert``: the module computes with the rank's shard as
  it is — a pipe rank's stage chunks (``parallel/pipeline.py``), an
  expert rank's experts (``models/moe.py``).

:meth:`ModelSharding.full` rebuilds a full tensor from every rank's shard
(checkpoints), :meth:`ModelSharding.local` cuts the rank's shard out of a
full one (init, restore, ``convert``).
"""

import torch

from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib


# The mesh axes a parameter may shard over.
_PARAM_AXES = ("fsdp", "pipe", "expert", "tensor")


class _Layout:
    """One parameter's full shape, spec and chunk sizes."""

    def __init__(self, mesh, shape, spec):
        self.shape = tuple(shape)
        self.spec = tuple(mesh_lib.spec_axes(e) for e in spec)
        self.chunk = []
        for n, axes in zip(self.shape, self.spec):
            k = mesh.axis_size(*axes) if axes else 1
            self.chunk.append(-(-n // k))
        self.sharded = any(self.spec)


def _bounds(n, chunk, i):
    start = min(i * chunk, n)
    return start, min(start + chunk, n)


class ModelSharding:
    """The layout of ``model``'s parameters over ``mesh`` under ``rules``.

    Parameters named in ``model.param_axes()`` with a mesh axis above 1
    are sharded; the rest are replicated. ``fsdp``, ``tensor``, ``pipe``
    and ``expert`` may shard a parameter, ``fsdp`` innermost in its
    entry."""

    def __init__(self, model, mesh, rules=None):
        self.mesh = mesh
        self.rules = rules or mesh_lib.DEFAULT_RULES
        axes_of = (model.param_axes() if hasattr(model, "param_axes")
                   else {})
        self.layouts = {}
        for name, p in model.named_parameters():
            logical = axes_of.get(name)
            spec = (mesh_lib.resolve_spec(mesh.shape, logical, self.rules)
                    if logical is not None else (None,) * p.dim())
            if len(spec) != p.dim():
                raise ValueError("{}: logical axes {} for a {}-d "
                                 "parameter".format(name, logical, p.dim()))
            layout = _Layout(mesh, p.shape, spec)
            for axes in layout.spec:
                bad = [a for a in axes if a not in _PARAM_AXES]
                if bad:
                    raise NotImplementedError(
                        "{}: parameters shard over {} only, not {} (rules "
                        "{})".format(name, _PARAM_AXES, bad, logical))
                if "fsdp" in axes and axes[-1] != "fsdp":
                    raise NotImplementedError(
                        "{}: fsdp must be the innermost axis of a spec "
                        "entry, got {}".format(name, axes))
            self.layouts[name] = layout
        self.fsdp_group = mesh.group("fsdp")
        self.tensor_group = mesh.group("tensor")

    # -- queries ------------------------------------------------------------

    @property
    def sharded_names(self):
        return [n for n, lay in self.layouts.items() if lay.sharded]

    def fsdp_sharded(self, name):
        return any("fsdp" in axes for axes in self.layouts[name].spec)

    def tensor_dims(self, name):
        return [d for d, axes in enumerate(self.layouts[name].spec)
                if "tensor" in axes]

    def tensor_slab(self, name, dim):
        """``(start, length)`` of this rank's tensor slab of dimension
        ``dim`` of the full parameter: the rows its tensor coordinate
        holds once the fsdp chunks inside it are gathered."""
        lay = self.layouts[name]
        axes = lay.spec[dim]
        n = lay.shape[dim]
        if "tensor" not in axes:
            return 0, n
        inner = self.mesh.axis_size(*axes[axes.index("tensor") + 1:])
        outer = axes[:axes.index("tensor") + 1]
        i = self.mesh.index(outer)
        start, stop = _bounds(n, lay.chunk[dim] * inner, i)
        if stop <= start:
            raise ValueError("{}: tensor slab {} of dim {} ({}) is "
                             "empty".format(name, i, dim, n))
        return start, stop - start

    # -- layout -------------------------------------------------------------

    def local(self, name, full, rank=None):
        """The shard of ``full`` a rank (default this one) holds,
        zero-padded to the chunk size."""
        lay = self.layouts[name]
        if not lay.sharded:
            return full
        out = full
        for dim, axes in enumerate(lay.spec):
            if not axes:
                continue
            n, c = lay.shape[dim], lay.chunk[dim]
            start, stop = _bounds(n, c, self.mesh.index(axes, rank))
            part = out.narrow(dim, start, stop - start)
            if stop - start < c:
                pad = list(part.shape)
                pad[dim] = c - (stop - start)
                part = torch.cat([part, part.new_zeros(pad)], dim=dim)
            out = part
        return out.contiguous()

    def full(self, name, shard):
        """The full tensor from every rank's shard of it. Collective over
        the whole group: every rank calls it for the same names in the
        same order."""
        lay = self.layouts[name]
        if not lay.sharded:
            return shard
        parts = coll.gather_world(shard.contiguous())
        padded = [c * (self.mesh.axis_size(*axes) if axes else 1)
                  for c, axes in zip(lay.chunk, lay.spec)]
        out = shard.new_zeros(padded)
        for r, part in enumerate(parts):
            index = []
            for dim, axes in enumerate(lay.spec):
                c = lay.chunk[dim]
                i = self.mesh.index(axes, r) if axes else 0
                index.append(slice(i * c, (i + 1) * c) if axes
                             else slice(None))
            out[tuple(index)] = part.to(out.device)
        return out[tuple(slice(0, n) for n in lay.shape)].contiguous()

    def gather(self, name, shard):
        """The tensor a module computes with: the fsdp dimensions of the
        shard gathered over the fsdp group (autograd all-gather) and
        trimmed to the rank's tensor slab (the full dimension when no
        tensor axis shares it)."""
        lay = self.layouts[name]
        out = shard
        for dim, axes in enumerate(lay.spec):
            if "fsdp" not in axes:
                continue
            out = coll.all_gather(out, self.fsdp_group, dim)
            _, length = self.tensor_slab(name, dim)
            if out.shape[dim] != length:
                out = out.narrow(dim, 0, length)
        return out

    # -- the model ------------------------------------------------------------

    def shard_model(self, model):
        """Replace each sharded parameter of ``model`` with this rank's
        shard and tell the model (``model.apply_sharding(self)``, when it
        has one) which of its modules gather or compute on slabs."""
        with torch.no_grad():
            for name in self.sharded_names:
                module, attr = _owner(model, name)
                p = getattr(module, attr)
                setattr(module, attr, torch.nn.Parameter(
                    self.local(name, p.detach()).clone()))
        if hasattr(model, "apply_sharding"):
            model.apply_sharding(self)
        return model

    def unshard_model(self, model):
        """The inverse of :meth:`shard_model` (collective)."""
        with torch.no_grad():
            for name in self.sharded_names:
                module, attr = _owner(model, name)
                p = getattr(module, attr)
                setattr(module, attr, torch.nn.Parameter(
                    self.full(name, p.detach())))
        if hasattr(model, "apply_sharding"):
            model.apply_sharding(None)
        return model

    def full_state_dict(self, params):
        """``{name: full tensor}`` of a ``{name: shard}`` dict
        (collective)."""
        return {name: self.full(name, t) if name in self.layouts else t
                for name, t in params.items()}

    def local_state_dict(self, params):
        return {name: self.local(name, t) if name in self.layouts else t
                for name, t in params.items()}


def _owner(model, name):
    path, _, attr = name.rpartition(".")
    module = model.get_submodule(path) if path else model
    return module, attr


def weight(module, name):
    """The tensor ``module`` computes with for its parameter ``name``: the
    parameter itself, or its fsdp gather when the module is sharded."""
    p = getattr(module, name)
    gathers = module.__dict__.get("_gathers")
    if gathers and name in gathers:
        return gathers[name](p)
    return p
