"""Device-resident replay: the row-major ring and the single-stream
feature-major ring.

Counterpart of ``dronerl_tpu/replay.py``'s row-major buffer (``init``,
``push``, ``push_many``, ``sample``, ``can_sample`` and the
``ReplayBuffer`` facade: slots on the leading axis, each experience
stored whole, ``next_obs`` included), its feature-major storage
(``init_t``, ``push_many_t``: slots on the last axis, a per-slot leaf of
shape (D,) stored as (D, capacity)) and ``StreamReplay``, with the same
semantics: ring writes at a rolling cursor, uniform sampling with
replacement.

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

    storage: Dict[str, torch.Tensor]  # name -> (capacity, *field_shape)
    #                                     or (*field_shape, capacity)
    cursor: int  # next write position
    size: int    # number of valid slots (<= capacity)


# --- row-major: slots on the leading axis ------------------------------------

def init(template: Dict[str, torch.Tensor], capacity: int,
         device=None) -> ReplayState:
    """Zero storage shaped like ``template``'s per-slot leaves with a
    leading capacity axis, on ``device`` (default: each leaf's)."""
    storage = {
        name: torch.zeros((capacity, *leaf.shape), dtype=leaf.dtype,
                          device=leaf.device if device is None else device)
        for name, leaf in template.items()}
    return ReplayState(storage=storage, cursor=0, size=0)


def push(state: ReplayState, experience: Dict[str, Any],
         capacity: int) -> ReplayState:
    """Write one experience at the cursor (in place)."""
    for name, buf in state.storage.items():
        buf[state.cursor] = experience[name]
    return ReplayState(storage=state.storage,
                       cursor=(state.cursor + 1) % capacity,
                       size=min(state.size + 1, capacity))


def push_many(state: ReplayState, batch: Dict[str, Any], capacity: int,
              aligned: bool = False) -> ReplayState:
    """Write a leading-axis batch of experiences at the cursor, wrapping
    around the ring (in place; each item cast to its storage's dtype).

    ``aligned`` is the caller's promise that every push has this size and
    that it divides the capacity, so that no write wraps; the JAX package
    then writes with ``dynamic_update_slice``, which would clamp a start
    past ``capacity - n``, and so does this function."""
    n = next(iter(batch.values())).shape[0]
    cursor = state.cursor
    if aligned and capacity % n == 0:
        start = min(cursor, capacity - n)
        for name, buf in state.storage.items():
            buf[start:start + n] = batch[name]
    elif cursor + n <= capacity:
        for name, buf in state.storage.items():
            buf[cursor:cursor + n] = batch[name]
    else:
        slots = (cursor + torch.arange(n)) % capacity
        for name, buf in state.storage.items():
            buf[slots.to(buf.device)] = batch[name].to(buf.dtype)
    return ReplayState(storage=state.storage, cursor=(cursor + n) % capacity,
                       size=min(state.size + n, capacity))


def sample(key: torch.Tensor, state: ReplayState,
           batch_size: int) -> Dict[str, torch.Tensor]:
    """Uniform sample with replacement over the valid prefix: the slots of
    ``jax.random.randint(key, (batch_size,), 0, size)``, drawn on the
    host."""
    idx = rng.randint(key, (batch_size,), 0, state.size).to(torch.int64)
    return {name: buf[idx.to(buf.device, non_blocking=True)]
            for name, buf in state.storage.items()}


def can_sample(state: ReplayState, batch_size: int) -> bool:
    return state.size >= batch_size


class ReplayBuffer:
    """Row-major replay: the static geometry bound to the functions above
    (``dronerl_tpu/replay.py::ReplayBuffer``)."""

    def __init__(self, capacity: int = 10_000, batch_size: int = 64,
                 uniform_pushes: bool = False):
        self.capacity = capacity
        self.batch_size = batch_size
        self.uniform_pushes = uniform_pushes

    def init(self, template: Dict[str, torch.Tensor],
             device=None) -> ReplayState:
        return init(template, self.capacity, device)

    def push(self, state: ReplayState,
             experience: Dict[str, Any]) -> ReplayState:
        return push(state, experience, self.capacity)

    def push_many(self, state: ReplayState,
                  batch: Dict[str, Any]) -> ReplayState:
        return push_many(state, batch, self.capacity,
                         aligned=self.uniform_pushes)

    def sample(self, key: torch.Tensor,
               state: ReplayState) -> Dict[str, torch.Tensor]:
        return sample(key, state, self.batch_size)

    def can_sample(self, state: ReplayState) -> bool:
        return can_sample(state, self.batch_size)


# --- feature-major: slots on the last axis -----------------------------------

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
