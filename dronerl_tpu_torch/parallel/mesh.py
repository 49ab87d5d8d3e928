"""Process-group bring-up and the 1-D data-parallel mesh (counterpart of
``dronerl_tpu/parallel/mesh.py``).

One process drives one device. Environments are sharded over the ranks;
the learner is replicated, and its gradients ride one all-reduce a
trained tick (``agents.dqn.all_reduce_mean``). The JAX package shards
over every local chip of one process; here a multi-GPU run starts one
process per card (torchrun, or the CLI's ``--coordinator_address`` /
``--num_processes`` / ``--process_id``), and a run without them is a mesh
of one rank, as JAX's mesh on one chip.

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``. A
caller may ask for gloo on the card (``backend="gloo"``), which stages
CUDA tensors through the host and so lets two ranks share one card.
"""

import dataclasses
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """This rank's place in the data-parallel mesh: its rank and the
    mesh's world size, the device it drives, and the process group of the
    mesh's ranks (the collectives' ``group``)."""

    rank: int
    world_size: int
    device: torch.device
    group: object


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device a rank drives: the CPU, or ``cuda:<LOCAL_RANK>`` (as
    torchrun sets it), else ``cuda:<rank % device_count>``."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else (
        rank % max(torch.cuda.device_count(), 1))
    return torch.device("cuda", index)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda",
                           backend: Optional[str] = None) -> bool:
    """Join a process group of several processes; returns whether one was
    joined.

    With ``num_processes`` > 1 (or a ``coordinator_address``) the group
    meets at ``tcp://<coordinator_address>`` (host:port of process 0's
    store) with this process as rank ``process_id``. Without the flags it
    reads torchrun's ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` /
    ``MASTER_PORT``, as JAX detects a pod's. Without either it does
    nothing: a single process. ``backend`` defaults to NCCL for ``cuda``
    and gloo for ``cpu``. A CUDA rank selects its card
    (:func:`rank_device`) before the group starts.
    """
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    device_type = torch.device(device).type
    backend = backend or default_backend(device_type)
    flags = (num_processes or 0) > 1 or coordinator_address is not None
    if flags:
        if coordinator_address is None or process_id is None:
            raise ValueError(
                "multi-process runs need --coordinator_address host:port, "
                "--num_processes and --process_id")
        world, rank = num_processes or 1, int(process_id)
        if not 0 <= rank < world:
            raise ValueError(f"--process_id {rank} is outside [0, {world})")
        init = f"tcp://{coordinator_address}"
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init = "env://"
    else:
        logger.info("process 0/1 on %s", rank_device(device_type, 0))
        return False
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(device_type, rank))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    logger.info("process %d/%d on %s (%s)", rank, world,
                rank_device(device_type, rank), backend)
    return True


def make_env_mesh(num_devices: Optional[int] = None,
                  device: str = "cuda") -> Optional[EnvMesh]:
    """The 1-D mesh over (a prefix of) the ranks, each driving one
    ``device``-type device.

    Without a process group it starts one of a single rank (in-process
    store; NCCL for ``cuda``, gloo for ``cpu``), so that the learner's
    all-reduce runs as it does across ranks. ``num_devices`` takes ranks
    ``0 .. num_devices - 1`` into a new group (every rank must call this,
    as ``new_group`` requires); a rank outside the prefix gets None.
    Raises where more ranks are asked for than there are. The mesh's
    first collective runs here: NCCL makes its communicator then (about a
    second), which must not land in a trainer's first timed tick.
    """
    device_type = torch.device(device).type
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(rank_device(device_type, 0))
        dist.init_process_group(default_backend(device_type),
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    group = dist.group.WORLD
    if num_devices is not None:
        if num_devices > world:
            raise ValueError(f"requested {num_devices} devices, have {world}")
        if num_devices < world:
            group = dist.new_group(list(range(num_devices)))
            if rank >= num_devices:
                return None
        world = num_devices
    mesh = EnvMesh(rank=rank, world_size=world,
                   device=rank_device(device_type, rank), group=group)
    dist.all_reduce(torch.zeros(1, device=mesh.device), group=group)
    return mesh

