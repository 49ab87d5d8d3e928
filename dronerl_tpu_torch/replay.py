"""Device-resident feature-major replay: the single-stream ring.

Counterpart of ``dronerl_tpu/replay.py``'s feature-major storage
(``ReplayState``, ``init_t``, ``push_many_t``) and ``StreamReplay``, with
the same semantics: ring writes at a rolling cursor, uniform sampling with
replacement, slots on the last axis (a per-slot leaf of shape (D,) is
stored as (D, capacity)).

Two differences of form, none of result:

* ``cursor`` and ``size`` are host ``int``s, as the ring engine keeps its
  step on the host: the trainer's control flow (whether a push wraps,
  whether the buffer can be sampled) then needs no read from the device.
* The JAX package is functional; here a push writes the storage tensors in
  place and returns a ``ReplayState`` holding the same tensors.
"""

from dataclasses import dataclass
from typing import Any, Dict

import torch

from dronerl_tpu_torch import rng


@dataclass
class ReplayState:
    """Ring storage plus the host cursor and size."""

    storage: Dict[str, torch.Tensor]  # name -> (*field_shape, capacity)
    cursor: int  # next write position
    size: int    # number of valid slots (<= capacity)


def init_t(template: Dict[str, torch.Tensor], capacity: int,
           device=None) -> ReplayState:
    """Zero storage shaped like ``template``'s per-slot leaves with the
    slots on the last axis, on ``device`` (default: each leaf's)."""
    storage = {
        name: torch.zeros((*leaf.shape, capacity), dtype=leaf.dtype,
                          device=leaf.device if device is None else device)
        for name, leaf in template.items()}
    return ReplayState(storage=storage, cursor=0, size=0)


def push_many_t(state: ReplayState, batch: Dict[str, Any],
                capacity: int) -> ReplayState:
    """Write a last-axis batch of slots at the cursor, wrapping around the
    ring (in place; each item cast to its storage's dtype)."""
    n = next(iter(batch.values())).shape[-1]
    cursor = state.cursor
    if cursor + n <= capacity:
        for name, buf in state.storage.items():
            buf[..., cursor:cursor + n] = batch[name]
    else:
        slots = (cursor + torch.arange(n)) % capacity
        for name, buf in state.storage.items():
            buf[..., slots.to(buf.device)] = batch[name].to(buf.dtype)
    return ReplayState(storage=state.storage, cursor=(cursor + n) % capacity,
                       size=min(state.size + n, capacity))


class StreamReplay:
    """Single-stream feature-major replay: next_obs by ring offset.

    Stores each observation once. With contiguous pushes of ``stride``
    slots (one per env) each tick, the successor of slot p is slot
    ``p + stride`` in ring order, so ``next_obs`` needs no storage.
    Sampling is uniform over every stored transition whose successor has
    been pushed: everything but the newest ``stride`` slots.

    The JAX package's approximation at periodic resets is kept as it is:
    a transition recorded on the tick a trainer resets its envs pairs
    with the post-reset observation (``done`` stays False), 1 in
    ``reset_env_every`` stored transitions (see
    ``dronerl_tpu/replay.py::StreamReplay``).

    Capacity must be a multiple of ``stride`` (every push contiguous, the
    successor offset exact across the wrap).
    """

    def __init__(self, capacity: int, batch_size: int, stride: int):
        if capacity % stride != 0:
            raise ValueError("capacity must be a multiple of stride")
        if capacity < 2 * stride:
            raise ValueError("capacity must hold at least two steps")
        self.capacity = capacity
        self.batch_size = batch_size
        self.stride = stride

    def init(self, template: Dict[str, torch.Tensor],
             device=None) -> ReplayState:
        """template: 'obs' (D,) plus scalar leaves (actions, rewards,
        dones); no 'next_obs' entry."""
        return init_t(template, self.capacity, device)

    def push_many(self, state: ReplayState,
                  batch: Dict[str, Any]) -> ReplayState:
        n = next(iter(batch.values())).shape[-1]
        if n != self.stride:
            raise ValueError(
                f"StreamReplay pushes must be stride-sized ({self.stride}); "
                f"got {n}: the successor-offset arithmetic depends on it")
        return push_many_t(state, batch, self.capacity)

    def sample(self, key: torch.Tensor,
               state: ReplayState) -> Dict[str, torch.Tensor]:
        """Uniform with-replacement over slots with a stored successor,
        drawn on the host from ``key`` (``jax.random.randint``). Safe on a
        cold buffer (clamped index range); callers gate its use on
        :meth:`can_sample`. obs and next_obs are column slices of one
        gathered (D, 2B) tensor."""
        valid = max(state.size - self.stride, 1)
        raw = rng.randint(key, (self.batch_size,), 0, valid)
        # When full, the oldest slot sits at the cursor; otherwise slot 0.
        base = state.cursor if state.size == self.capacity else 0
        phys = (base + raw.to(torch.int64)) % self.capacity
        nxt = (phys + self.stride) % self.capacity
        obs = state.storage["obs"]
        idx = torch.cat([phys, nxt]).to(obs.device, non_blocking=True)
        both = obs[..., idx]
        phys = idx[:self.batch_size]
        batch = {name: buf[..., phys] for name, buf in state.storage.items()
                 if name != "obs"}
        batch["obs"] = both[..., :self.batch_size]
        batch["next_obs"] = both[..., self.batch_size:]
        return batch

    def can_sample(self, state: ReplayState) -> bool:
        return state.size - self.stride >= self.batch_size
