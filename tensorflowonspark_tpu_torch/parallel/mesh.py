"""The device mesh of the port (``parallel/mesh.py``): mesh axes over the
process group, logical-axis rules and batch placement.

The JAX package lays one ``jax.sharding.Mesh`` over every device of every
process, and a mesh axis spans devices. The port runs one process per
device under ``torch.distributed``, so a mesh axis spans *processes*:
:meth:`MeshConfig.build` returns a :class:`ProcessMesh` over the process
group. Rank ``r`` sits at the coordinate that ``np.arange(world).reshape(
sizes)`` gives ``r`` in the JAX axis order :data:`AXES`, the order in which
the JAX mesh places device ``r`` (``np.asarray(devices).reshape(sizes)``),
so rank ``r`` of the port holds what device ``r`` of the JAX mesh holds.

The mesh keeps one ``torch.distributed`` sub-group per family of axes a
collective runs over (:data:`GROUP_AXES`): each axis alone, the batch
group ``data x fsdp``, the gradient groups ``data x fsdp x seq`` and
``data x seq``, and ``seq x tensor``. Families whose size is 1 have no
group; collectives over them are no-ops.

Every axis may exceed 1. ``pipe`` carries pipeline parallelism
(:mod:`.pipeline`, ``models/pipelined.py``) and ``expert`` the MoE LM's
experts (``models/moe.py``). Compositions the port does not yet hold
against the JAX package raise ``NotImplementedError`` naming their ROADMAP
item (:data:`UNCHECKED_COMPOSITIONS`, :data:`PIPE_MODEL_AXES`):
``expert`` composes with ``data`` and ``pipe`` only, and ``pipe`` with
``data`` and at most one of ``fsdp``, ``seq``, ``tensor`` and ``expert``.
Each fsdp, seq or tensor group then lies inside one pipe stage: its ranks
share the pipe coordinate, and so the pipeline's steps. The logical-axis
rules (:data:`DEFAULT_RULES`, :func:`use_rules`, :func:`active_rules`)
and their resolution (:func:`resolve_spec`, size-1 axes dropped) are the
JAX package's; where JAX turns a spec into a ``NamedSharding``, the port
slices each parameter to the rank's shard (:mod:`.sharding`).
"""

import contextlib
import dataclasses
import itertools
import logging
import math
import threading

import numpy as np

from tensorflowonspark_tpu_torch.parallel import multihost

logger = logging.getLogger(__name__)

AXES = ("data", "fsdp", "pipe", "expert", "seq", "tensor")

# Logical axis -> mesh axis (or tuple of mesh axes); None = replicated. The
# JAX package's DEFAULT_RULES (``parallel/mesh.py:111-131``).
DEFAULT_RULES = {
    "batch": ("data", "fsdp"),
    "embed": "fsdp",
    "mlp": "tensor",
    "heads": "tensor",
    "kv": None,
    "qkv": "tensor",
    "vocab": ("tensor", "fsdp"),
    "sequence": "seq",
    "expert": "expert",
    "layers": None,
    "stage": "pipe",
    None: None,
}

# The axis families the mesh makes a process group for, in AXES order.
GROUP_AXES = (
    ("data",), ("fsdp",), ("pipe",), ("expert",), ("seq",), ("tensor",),
    ("data", "fsdp"), ("data", "seq"), ("data", "fsdp", "seq"),
    ("seq", "tensor"),
)

# Axis pairs that build in the JAX package but that the port has not held
# against it: each raises, naming the ROADMAP item that would.
UNCHECKED_COMPOSITIONS = {
    ("fsdp", "expert"): "A11c", ("expert", "seq"): "A11c",
    ("expert", "tensor"): "A11c",
}
# ``pipe`` composes with one of these at a time (each pair is held against
# the JAX package); beside two or more it raises, naming ROADMAP A10d.
PIPE_MODEL_AXES = ("fsdp", "expert", "seq", "tensor")

_ambient = threading.local()


@contextlib.contextmanager
def use_rules(rules):
    """Make ``rules`` the ambient logical-axis rules (the JAX
    ``use_rules``): :func:`constrain` and the models resolve against them."""
    prev = getattr(_ambient, "rules", None)
    _ambient.rules = rules
    try:
        yield
    finally:
        _ambient.rules = prev


def active_rules():
    """The ambient rules (:func:`use_rules`), or :data:`DEFAULT_RULES`."""
    return getattr(_ambient, "rules", None) or DEFAULT_RULES


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh (the counterpart of
    ``jax.set_mesh``): sequence-parallel attention and global-batch
    BatchNorm find their process groups through it."""
    prev = getattr(_ambient, "mesh", None)
    _ambient.mesh = mesh
    try:
        yield
    finally:
        _ambient.mesh = prev


def current_mesh():
    """The ambient mesh (:func:`use_mesh`), or None."""
    return getattr(_ambient, "mesh", None)


def resolve_spec(mesh_shape, logical_axes, rules=None):
    """The partition spec of ``logical_axes`` against a mesh's axis sizes:
    one entry per logical axis, None (replicated), a mesh axis name, or a
    tuple of them (outermost first). Mesh axes of size 1 are dropped, as
    the JAX ``_resolve_spec`` drops them."""
    rules = rules or DEFAULT_RULES
    spec = []
    for ax in logical_axes:
        mesh_ax = rules.get(ax, None)
        if isinstance(mesh_ax, str):
            mesh_ax = (mesh_ax,)
        live = tuple(a for a in (mesh_ax or ()) if mesh_shape.get(a, 1) > 1)
        spec.append(live if len(live) > 1 else (live[0] if live else None))
    return tuple(spec)


def spec_axes(entry):
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def constrain(x, logical_axes, rules=None):
    """The JAX ``constrain`` is a sharding constraint for XLA's
    partitioner. The port places no arrays behind the model's back: each
    rank already holds its own rows and sequence chunk, so this is the
    identity. It checks only that ``x`` has one dimension per logical
    axis."""
    if x.dim() != len(logical_axes):
        raise ValueError("constrain: {}-d tensor against logical axes "
                         "{}".format(x.dim(), logical_axes))
    return x


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each parallelism axis; ``-1`` on one axis absorbs all
    remaining processes (like a reshape wildcard)."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def sizes(self, num_devices):
        sizes = [self.data, self.fsdp, self.pipe, self.expert, self.seq,
                 self.tensor]
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if num_devices % fixed:
                raise ValueError("cannot fit mesh {} onto {} devices".format(
                    self, num_devices))
            sizes[wild[0]] = num_devices // fixed
        elif fixed != num_devices:
            raise ValueError("mesh {} needs {} devices, have {}".format(
                self, fixed, num_devices))
        return tuple(sizes)

    def build(self, devices=None):
        """The :class:`ProcessMesh` over this process group, one device a
        process (``devices``, accepted for the JAX signature, must be
        None). Collective: every rank builds the mesh at the same point,
        since each process group is made by all ranks together."""
        if devices is not None:
            raise ValueError("the port's mesh spans the process group; "
                             "pass no device list")
        declared = (self.data, self.fsdp, self.pipe, self.expert, self.seq,
                    self.tensor)
        _check_compositions(declared)
        sizes = self.sizes(multihost.process_count())
        _check_compositions(sizes)
        mesh = ProcessMesh(sizes, multihost.process_index())
        logger.info("mesh: %s over %d process(es)", mesh.shape, mesh.size)
        return mesh


def _check_compositions(sizes):
    live = {a for a, n in zip(AXES, sizes) if n > 1}
    beside = [a for a in PIPE_MODEL_AXES if a in live]
    if "pipe" in live and len(beside) > 1:
        raise NotImplementedError(
            "mesh axis pipe={} beside {}: pipe composes with one of {} at "
            "a time; more is not held against the JAX package yet (ROADMAP "
            "A10d)".format(sizes[AXES.index("pipe")], ", ".join(
                "{}={}".format(a, sizes[AXES.index(a)]) for a in beside),
                "/".join(PIPE_MODEL_AXES)))
    for (a, b), item in UNCHECKED_COMPOSITIONS.items():
        if a in live and b in live:
            raise NotImplementedError(
                "mesh axes {}={} with {}={}: this composition is not held "
                "against the JAX package yet (ROADMAP {})".format(
                    a, sizes[AXES.index(a)], b, sizes[AXES.index(b)], item))


class ProcessMesh:
    """Mesh axes over the ``torch.distributed`` process group: one device
    a process, rank ``r`` at ``np.unravel_index(r, sizes)``.

    ``shape`` is ``{axis: size}`` as ``jax.sharding.Mesh.shape``;
    :meth:`group` gives the process group of an axis family (None for a
    family of size 1). Without a process group (one process) every axis
    is 1 and no group exists."""

    def __init__(self, sizes, rank):
        self.sizes = tuple(int(s) for s in sizes)
        self.rank = int(rank)
        self._coords = self.coords_of(self.rank)
        self._groups = {}
        for axes in GROUP_AXES:
            self._make_family(axes)

    # -- geometry -----------------------------------------------------------

    @property
    def shape(self):
        return dict(zip(AXES, self.sizes))

    @property
    def size(self):
        return math.prod(self.sizes)

    @property
    def data(self):
        """The data axis's size (the data-only mesh's one number)."""
        return self.shape["data"]

    @property
    def coords(self):
        """This rank's ``{axis: index}``."""
        return dict(self._coords)

    def coords_of(self, rank):
        idx = np.unravel_index(int(rank), self.sizes)
        return {a: int(i) for a, i in zip(AXES, idx)}

    def axis_size(self, *axes):
        shape = self.shape
        return math.prod(shape[a] for a in axes)

    def index(self, axes, rank=None):
        """The mixed-radix index over ``axes`` (outermost first) of
        ``rank`` (default this rank): the shard a spec entry ``axes``
        gives that rank, as a JAX ``PartitionSpec`` entry orders them."""
        coords = self._coords if rank is None else self.coords_of(rank)
        shape = self.shape
        i = 0
        for a in axes:
            i = i * shape[a] + coords[a]
        return i

    def ranks_with(self, axes, rank=None):
        """The ranks that differ from ``rank`` (default this rank) only in
        the coordinates of ``axes``, in rank order."""
        coords = self._coords if rank is None else self.coords_of(rank)
        return [r for r in range(self.size)
                if all(self.coords_of(r)[a] == coords[a]
                       for a in AXES if a not in axes)]

    # -- process groups -----------------------------------------------------

    def _make_family(self, axes):
        key = tuple(a for a in AXES if a in axes)
        if key in self._groups:
            return
        if self.axis_size(*key) == 1 or not multihost.is_multiprocess():
            self._groups[key] = None
            return
        import torch.distributed as dist

        # new_group is collective over the default group: every rank makes
        # every group of the family, in one order, and keeps its own.
        mine = None
        others = [a for a in AXES if a not in key]
        shape = self.shape
        for fixed in itertools.product(*(range(shape[a]) for a in others)):
            ranks = [r for r in range(self.size)
                     if all(self.coords_of(r)[a] == f
                            for a, f in zip(others, fixed))]
            group = dist.new_group(ranks=ranks)
            if self.rank in ranks:
                mine = group
        self._groups[key] = mine

    def group(self, *axes):
        """The process group of ``axes`` holding this rank (None when the
        family's size is 1). A family outside :data:`GROUP_AXES` is made
        on first use, which every rank must reach at the same point."""
        key = tuple(a for a in AXES if a in axes)
        if key not in self._groups:
            self._make_family(key)
        return self._groups[key]

    def __repr__(self):
        return "ProcessMesh({}, rank={})".format(self.shape, self.rank)


# The data-only mesh of earlier releases is a ProcessMesh whose only axis
# above 1 is data.
DataMesh = ProcessMesh


def _cut(x, axis, sl):
    if isinstance(x, np.ndarray) or hasattr(x, "narrow"):
        index = [slice(None)] * x.ndim
        index[axis] = sl
        return x[tuple(index)]
    return x


class BatchPlacer:
    """Which rows and which sequence chunk this rank holds, and their
    placement on its device (the counterpart of the JAX ``BatchPlacer``).

    The batch axis shards over the mesh axes of ``rules["batch"]`` (data
    and fsdp by default) and the sequence axis over those of
    ``rules["sequence"]`` (seq). Ranks that differ only in the other
    coordinates (tensor, and seq for the rows) hold the same rows.

    ``placer(batch)`` takes this rank's rows at the full sequence length
    (what the feed hands a rank, after ``DataFeed.sync_batches`` has made
    the rows of a ``tensor x seq`` group one), cuts the rank's sequence
    chunk out of every leaf of two or more dimensions, and places the
    leaves on the device. The result is a :class:`PlacedBatch`, which a
    second placement passes through. :meth:`local` cuts a *global* batch
    down to the rank's rows and chunk without placing it."""

    def __init__(self, mesh, rules=None, device="cpu"):
        from tensorflowonspark_tpu_torch.train import prefetch

        self.mesh = mesh
        self.rules = rules or DEFAULT_RULES
        shape = mesh.shape
        (batch,) = resolve_spec(shape, ("batch",), self.rules)
        (seq,) = resolve_spec(shape, ("sequence",), self.rules)
        self.batch_axes = spec_axes(batch)
        self.seq_axes = spec_axes(seq)
        self.degree = mesh.axis_size(*self.batch_axes)
        self.row_index = mesh.index(self.batch_axes)
        self.seq_degree = mesh.axis_size(*self.seq_axes)
        self.seq_index = mesh.index(self.seq_axes)
        self._device = prefetch.BatchPlacer(device)
        self.device = self._device.device

    def rows(self, n):
        """The slice of a global batch of ``n`` rows this rank holds."""
        if n % self.degree:
            raise ValueError("global batch {} does not divide the batch "
                             "sharding degree {}".format(n, self.degree))
        per = n // self.degree
        return slice(self.row_index * per, (self.row_index + 1) * per)

    def chunk(self, s):
        """The slice of a sequence of ``s`` tokens this rank holds."""
        if s % self.seq_degree:
            raise ValueError("sequence length {} does not divide the seq "
                             "axis {}".format(s, self.seq_degree))
        per = s // self.seq_degree
        return slice(self.seq_index * per, (self.seq_index + 1) * per)

    def _chunk_leaf(self, x):
        if self.seq_degree == 1 or getattr(x, "ndim", 0) < 2:
            return x
        return _cut(x, 1, self.chunk(x.shape[1]))

    def local(self, batch):
        """This rank's rows and chunk of a global batch (a dict of arrays
        or tensors, or one array)."""
        def leaf(x):
            if getattr(x, "ndim", 0) < 1:
                return x
            return self._chunk_leaf(_cut(x, 0, self.rows(x.shape[0])))

        if isinstance(batch, dict):
            return {k: leaf(v) for k, v in batch.items()}
        return leaf(batch)

    def __call__(self, batch):
        if isinstance(batch, PlacedBatch):
            return batch
        if isinstance(batch, dict):
            return PlacedBatch(self._device(
                {k: self._chunk_leaf(v) for k, v in batch.items()}))
        return self._device(self._chunk_leaf(batch))


class PlacedBatch(dict):
    """A batch a :class:`BatchPlacer` has placed: its sequence chunk is
    cut and its tensors lie on the device."""


def shard_batch(mesh, batch, rules=None, device="cpu"):
    """Place this rank's rows (full sequence length) on ``device`` with
    its sequence chunk cut; hot paths hold a :class:`BatchPlacer`."""
    return BatchPlacer(mesh, rules, device)(batch)
