"""The device mesh of the port (``parallel/mesh.py``), data axis only.

The JAX package lays a ``jax.sharding.Mesh`` over every device of every
process, with six named axes. The port runs one process per device under
``torch.distributed``, so its mesh is the process group itself:
``MeshConfig(data=-1).build()`` is a :class:`DataMesh` whose data axis
spans every process, and ``Trainer(mesh=...)`` replicates the model over
it and all-reduces the gradients. Any other axis (``fsdp``, ``pipe``,
``expert``, ``seq``, ``tensor``) at a size other than 1 raises: FSDP2,
tensor, sequence and pipeline parallelism are the later part of ROADMAP
A10.
"""

import dataclasses
import logging
import math

from tensorflowonspark_tpu_torch.parallel import multihost

logger = logging.getLogger(__name__)

AXES = ("data", "fsdp", "pipe", "expert", "seq", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each parallelism axis; ``-1`` on one axis absorbs all
    remaining devices (like a reshape wildcard). The port builds meshes
    whose only axis above 1 is ``data``."""

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
        """The :class:`DataMesh` over this process group: one device per
        process, so ``devices`` (accepted for the JAX signature) must be
        None."""
        if devices is not None:
            raise ValueError("the port's mesh spans the process group; "
                             "pass no device list")
        other = {k: getattr(self, k) for k in AXES
                 if k != "data" and getattr(self, k) != 1}
        if other:
            raise NotImplementedError(
                "mesh axes {} are not ported: FSDP2, tensor, sequence, "
                "expert and pipeline parallelism are the later part of "
                "ROADMAP A10; the port's mesh has a data axis "
                "only".format(other))
        mesh = DataMesh(self.sizes(multihost.process_count())[0])
        logger.info("mesh: data=%d over %d process(es)", mesh.data,
                    multihost.process_count())
        return mesh


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A data-parallel mesh over the default process group: ``data``
    replicas, one a process."""

    data: int

    @property
    def shape(self):
        return {axis: (self.data if axis == "data" else 1) for axis in AXES}

    @property
    def size(self):
        return self.data
