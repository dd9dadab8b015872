"""Parallelism of the port: the process-group utilities
(:mod:`.multihost`) and the data-parallel mesh (:mod:`.mesh`)."""

from tensorflowonspark_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    MeshConfig,
)
