"""Profiling hooks: trace capture, timing, device memory (counterpart of
``dronerl_tpu/utils/profiling.py``).

:func:`trace` records ``torch.profiler`` (host and, where CUDA is
available, device activity) for everything inside the block and writes a
Chrome trace; :class:`Stopwatch` times host work and synchronises the
device before it stops; :func:`device_memory_stats` reads
``torch.cuda.memory_stats``.
"""

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch
import torch.distributed

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block; writes ``log_dir/trace.json`` (Chrome trace
    format, viewable in Perfetto or ``chrome://tracing``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


class Stopwatch:
    """Wall-clock timer whose :meth:`stop` waits for the device."""

    def __init__(self):
        self.start = None
        self.elapsed = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def stop(self, *block_on) -> float:
        """Synchronise the devices of the tensors ``block_on`` (every
        CUDA device when none is given and CUDA is available), then
        stop."""
        devices = {t.device for t in block_on
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
        if not block_on and torch.cuda.is_available():
            devices = {None}
        for device in devices:
            torch.cuda.synchronize(device)
        self.elapsed = time.perf_counter() - self.start
        return self.elapsed

    def __exit__(self, *exc):
        if self.elapsed == 0.0:
            self.elapsed = time.perf_counter() - self.start


def current_device() -> torch.device:
    """The CUDA device this process launches on (``torch.cuda.
    set_device``'s: a rank's own card)."""
    return torch.device("cuda", torch.cuda.current_device())


def device_memory_stats(device: Optional[torch.device] = None) -> dict:
    """Live and peak device memory of one CUDA device (empty without
    CUDA): ``bytes_in_use``, ``peak_bytes_in_use`` (the caching
    allocator's allocated bytes) and ``bytes_limit`` (the card's memory),
    as the JAX package names them. ``device`` defaults to the current
    device, and ``"cuda"`` without an index means it too."""
    if not torch.cuda.is_available():
        return {}
    device = current_device() if device is None else torch.device(device)
    if device.index is None:
        device = current_device()
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }


def log_device_memory(prefix: str = "") -> None:
    """Log every card's memory, or under a process group (one rank a
    card) this rank's card alone."""
    if not torch.cuda.is_available():
        return
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        devices = [current_device()]
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    for device in devices:
        stats = device_memory_stats(device)
        logger.info("%s%s: %.1f MiB in use (peak %.1f / limit %.1f)",
                    prefix, device, stats["bytes_in_use"] / 2**20,
                    stats["peak_bytes_in_use"] / 2**20,
                    stats["bytes_limit"] / 2**20)
