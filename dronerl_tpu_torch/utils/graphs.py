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
"""

from typing import Callable, Tuple

import torch

Carry = Tuple[torch.Tensor, ...]


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
        side = torch.cuda.Stream(device)
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
