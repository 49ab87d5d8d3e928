"""Multi-GPU training: the process group, the data-parallel mesh and the
sharded trainer (counterpart of ``dronerl_tpu/parallel``)."""

from dronerl_tpu_torch.parallel.distributed import DistributedTrainer
from dronerl_tpu_torch.parallel.mesh import (
    EnvMesh, initialize_distributed, make_env_mesh)

__all__ = ["DistributedTrainer", "EnvMesh", "initialize_distributed",
           "make_env_mesh"]
