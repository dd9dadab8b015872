"""Multi-process utilities over ``torch.distributed`` (the port of
``parallel/multihost.py``).

The JAX package joins one XLA runtime (``jax.distributed``) and issues
control all-reduces as tiny jitted programs. The port joins one
``torch.distributed`` process group, one process per device, and keeps a
second group on **gloo over the CPU** for control decisions: the
end-of-feed agreement (:func:`agree_sum`) and the checkpoint barriers
never wait behind the card's stream, whatever backend the training
collectives use.

* :func:`initialize` joins the group against the chief's coordinator
  address and makes the control group;
* :func:`agree_sum` sums a small vector across processes;
* :func:`lockstep` keeps uneven local batch streams in step;
* :func:`process_batch_size` is this process's share of a global batch.
"""

import datetime
import logging

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT = 300.0

_control = {"group": None}


def is_multiprocess():
    """True when this process belongs to a process group of more than one
    process."""
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def process_count():
    """Processes in the group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index():
    """This process's rank (0 without a group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def initialize(coordinator, num_processes, process_id, backend):
    """Join the default process group at ``tcp://<coordinator>`` and make
    the CPU control group. Rank 0 binds the coordinator port (its
    ``TCPStore``); :data:`DEFAULT_TIMEOUT` bounds the rendezvous and every
    collective after it. A failed initialisation raises; nothing falls
    back to another backend."""
    delta = datetime.timedelta(seconds=DEFAULT_TIMEOUT)
    dist.init_process_group(
        backend=backend, init_method="tcp://{}".format(coordinator),
        world_size=int(num_processes), rank=int(process_id), timeout=delta)
    # new_group is collective: every rank makes it here, at one point.
    _control["group"] = (None if backend == "gloo" else
                         dist.new_group(backend="gloo", timeout=delta))
    logger.info("joined process group: rank %d/%d, backend %s, via %s",
                int(process_id), int(num_processes), backend, coordinator)


def control_group():
    """The gloo group control collectives run on (None: the default group,
    when that is gloo itself)."""
    return _control["group"]


def shutdown():
    """Leave the process group (no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        if _control["group"] is not None:
            dist.destroy_process_group(_control["group"])
        dist.destroy_process_group()
    _control["group"] = None


def barrier():
    """Block until every process arrives (on the CPU control group)."""
    if is_multiprocess():
        dist.barrier(group=control_group())


def agree_sum(values, mesh=None):
    """Sum a small vector of floats across all processes.

    Every process must call this with a vector of the same length (it is
    an all-reduce); returns the summed numpy float32 vector. Used for the
    end-of-feed agreement ``agree_sum([have_data, done])``. ``mesh`` is
    accepted for the JAX signature and unused: the sum runs over every
    process of the group."""
    vals = np.asarray(values, np.float32).reshape(-1)
    if not is_multiprocess():
        return vals
    t = torch.from_numpy(vals.copy())
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=control_group())
    return t.numpy()


_END = object()


def lockstep(batches, zero=None):
    """Iterate local batches in lockstep across processes.

    Every process must step the same number of times; when local inputs
    are uneven (FILES-mode striding, ``files[task_index::num_workers]``) a
    process that runs out early would leave its peers waiting inside a
    collective. This wraps a local batch iterator so that exhausted
    processes keep yielding *zero batches* (all-zero copies of the last
    real batch, or of ``zero``) until every process agrees it is done.
    Single-process: a plain passthrough. The agreement runs over every
    process: all ranks of any mesh step together.
    """
    if not is_multiprocess():
        for b in batches:
            yield b
        return

    it = iter(batches)
    struct = None  # {name: (shape, dtype)}; zeros built lazily when needed

    def _struct(b):
        if isinstance(b, dict):
            return {k: (np.asarray(v).shape, np.asarray(v).dtype)
                    for k, v in b.items()}
        b = np.asarray(b)
        return (b.shape, b.dtype)

    def _zeros(s):
        if isinstance(s, dict):
            return {k: np.zeros(shape, dtype)
                    for k, (shape, dtype) in s.items()}
        shape, dtype = s
        return np.zeros(shape, dtype)

    while True:
        item = next(it, _END)
        (have,) = agree_sum([0.0 if item is _END else 1.0])
        if have == 0.0:
            return
        if item is _END:
            if struct is None and zero is None:
                raise RuntimeError(
                    "lockstep needs `zero` when a worker exhausts its input "
                    "before producing any batch")
            s = struct if struct is not None else _struct(zero)
            # A zero "mask" column keeps pad steps out of the gradient;
            # without one the zero batches train as real data. Only this
            # (exhausted) worker would carry a synthesized key, and every
            # process's batch structure must stay the same, so warn.
            if not (isinstance(s, dict) and "mask" in s):
                logger.warning(
                    "lockstep is zero-padding a batch struct with no 'mask' "
                    "entry — pad batches will contribute to gradients; add "
                    "a mask column to exclude them")
            yield _zeros(s)
        else:
            struct = _struct(item)
            yield item


def process_batch_size(global_batch_size, mesh=None):
    """The rows this process is fed of a global batch: ``global /
    processes``, as in the JAX package, whatever the mesh. Over a mesh
    with ``tensor`` or ``seq`` above 1, ``DataFeed.sync_batches(...,
    mesh=)`` concatenates the fed rows of each ``seq x tensor`` group, so
    that a rank holds ``global / (data x fsdp)`` rows and the ranks'
    rows make the global batch, in rank order."""
    procs = process_count()
    if global_batch_size % procs:
        raise ValueError(
            "global batch {} does not divide {} processes".format(
                global_batch_size, procs))
    return global_batch_size // procs
