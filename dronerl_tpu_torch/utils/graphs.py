"""``scan``: a loop of a fixed-shape tick, as one CUDA graph on the card.

The plain PyTorch env core takes a few thousand small operations a tick
(most of them the int64 threefry hashes), and on the card each is a
kernel launch whose host cost dwarfs its work. The JAX package compiles
such loops into one program (``jax.lax.scan`` under ``jit``); here the
tick is captured once into a CUDA graph and the graph is replayed, so a
tick costs one launch from the host. The kernels are those the tick
launches eagerly, so the results are the eager loop's. On the CPU the
loop runs eagerly.

A tick must keep its shapes and dtypes from one call to the next and
must not read a tensor's value on the host (a capture raises where it
does, and the error is not caught).

:class:`GraphSet` holds several graphs of one step function, one a static
signature (the host values that fix the step's launches), over one set of
static tensors that all of them read and write: an engine's chunk
(``train.Chunk``) replays one of them a tick.
"""

from typing import Callable, Dict, Hashable, Sequence, Tuple

import torch

Carry = Tuple[torch.Tensor, ...]


_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def side_stream(device) -> "torch.cuda.Stream":
    """The one stream of ``device`` that every graph's eager warm-up runs
    on: each stream a cuBLAS call runs on keeps a workspace of its own, so
    a fresh stream a capture would keep one more every time."""
    device = torch.device(device)
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def upload(values: Sequence, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` as a 1-d tensor on ``device``: on a card through pinned
    memory without blocking the host (an eager caller's copy; a CUDA graph
    never holds one), on the CPU as they are."""
    out = torch.tensor(list(values), dtype=dtype)
    if torch.device(device).type != "cuda":
        return out
    return out.pin_memory().to(device, non_blocking=True)


class Graphed:
    """``tick`` captured into a CUDA graph from ``carry`` (a tuple of
    tensors on one CUDA device):
    :meth:`replay` runs it and returns its outputs (the graph's own
    buffers, which may alias ``carry``), :meth:`advance` then copies its
    new carry into the graph's input carry ``carry``."""

    def __init__(self, tick: Callable[[Carry], Tuple[Carry, Carry]],
                 carry: Carry):
        device = carry[0].device
        self.carry = tuple(t.clone() for t in carry)
        # Lazy initialisations (cuBLAS handles and the like) happen in an
        # eager tick on a side stream, as graph capture requires.
        side = side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            tick(tuple(t.clone() for t in self.carry))
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._new_carry, self.outs = tick(self.carry)

    def replay(self) -> Carry:
        self.graph.replay()
        return self.outs

    def advance(self) -> None:
        for s, n in zip(self.carry, self._new_carry):
            s.copy_(n)


def scan(tick: Callable[[Carry], Tuple[Carry, Carry]], carry: Carry,
         length: int) -> Tuple[Carry, Carry]:
    """``length`` ticks ``carry, outs = tick(carry)`` from ``carry`` (a
    tuple of tensors on one device): returns the last carry and each
    output stacked over the ticks, (length, ...)."""
    device = carry[0].device
    if device.type != "cuda":
        steps = []
        for _ in range(length):
            carry, outs = tick(carry)
            steps.append(outs)
        return carry, tuple(torch.stack(o) for o in zip(*steps))
    graphed = Graphed(tick, carry)
    stacked = tuple(torch.empty((length, *o.shape), dtype=o.dtype,
                                device=device) for o in graphed.outs)
    for i in range(length):
        for buf, o in zip(stacked, graphed.replay()):
            buf[i].copy_(o)
        graphed.advance()
    return graphed.carry, stacked


class GraphSet:
    """CUDA graphs of one step, captured on first use, one for each key
    (the step's static signature), sharing one memory pool.

    Every graph reads and writes the same static tensors, which the
    caller owns (nothing is cloned per graph), and leaves nothing in the
    pool that a later replay reads: a graph's results go into static
    tensors inside the graph. So the graphs may replay in any order.

    :meth:`capture` first runs the step once eagerly on a side stream
    (``warm_up``: on a copy of the state, so that lazy set-up such as a
    kernel's shared-memory opt-in happens outside the capture), then
    records ``step`` in ``mode`` (``torch.cuda.graph``'s
    ``capture_error_mode``). A capture that fails raises; nothing falls
    back to the eager step.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Hashable, torch.cuda.CUDAGraph] = {}

    def __contains__(self, key) -> bool:
        return key in self.graphs

    def __len__(self) -> int:
        return len(self.graphs)

    def capture(self, key: Hashable, step: Callable[[], None],
                warm_up: Callable[[], None], mode: str = "global") -> None:
        side = side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            warm_up()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode=mode):
            step()
        self.graphs[key] = graph
        torch.cuda.synchronize(self.device)

    def replay(self, key: Hashable) -> None:
        self.graphs[key].replay()
