"""Run a function in several ranks on this machine.

:func:`spawn` starts ``world_size`` processes with ``torch.
multiprocessing.start_processes``, joins them into one process group over
``tcp://127.0.0.1:<a free port>`` (:func:`mesh.initialize_distributed`),
calls ``fn(*args)`` in each and returns what each rank returned. What it
adds to ``start_processes``: the results, which come back through
``torch.save`` files in a temporary directory, and a deadline, past
which every rank is killed. A rank that raises stops its peers, as
``start_processes`` does, and its traceback is raised in the caller: no
rank is left waiting on a dead peer.

``fn`` must be importable by name (a module-level function).
"""

import os
import shutil
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from dronerl_tpu_torch.parallel import mesh


def free_port() -> int:
    """A TCP port the OS reports free on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world_size: int, port: int, device: str,
               backend: Optional[str], num_threads: Optional[int],
               fn: Callable, args: Sequence[Any], out_dir: str) -> None:
    if num_threads is not None:
        torch.set_num_threads(num_threads)
    mesh.initialize_distributed(f"127.0.0.1:{port}", world_size, rank,
                                device=device, backend=backend)
    result = fn(*args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence[Any] = (), *,
          device: str = "cuda", backend: Optional[str] = None,
          num_threads: Optional[int] = None,
          timeout: float = 600.0) -> List[Any]:
    """``[fn(*args) in rank r for r in range(world_size)]``, each rank a
    process in one group on ``device`` (the card unless the caller asks
    for ``"cpu"``; ``backend`` as :func:`mesh.initialize_distributed`
    chooses it, or given); ``num_threads`` caps each rank's intra-op
    threads."""
    out_dir = tempfile.mkdtemp(prefix="dronerl_ranks_")
    context = mp.start_processes(
        _rank_main, args=(world_size, free_port(), device, backend,
                          num_threads, fn, tuple(args), out_dir),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=max(deadline - time.monotonic(), 0),
                               grace_period=1):
            if time.monotonic() >= deadline:
                alive = [r for r, p in enumerate(context.processes)
                         if p.is_alive()]
                raise RuntimeError(f"rank(s) {alive} still running after "
                                   f"{timeout:.0f} s")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as err:
        raise RuntimeError(f"rank {err.error_index} failed: {err}") from None
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
        shutil.rmtree(out_dir, ignore_errors=True)
