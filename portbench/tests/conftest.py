"""Shared helpers of the benchmark's tests: cells cut to a size the CPU
runs in seconds (the port's plain versions stand in for its kernels)."""

import pytest
import torch

from portbench import run

# Envs and replay transitions a cut cell keeps for each engine: the ring
# engine at two env-batches, the full engine at sixteen.
TINY = {"ring": (128, 256), "full": (128, 2048)}


def tiny_cell(workload: str):
    cell = run.load_cell(workload)
    envs, memory = TINY[cell.traffic["engine"]]
    cell.flags.update(num_envs=envs, memory_size=memory)
    cell.traffic.update(chunk_ticks=4)
    cell.warmup_chunks = cell.host_chunks = cell.trace_chunks = 1
    return cell


@pytest.fixture
def card():
    """The CUDA card, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
