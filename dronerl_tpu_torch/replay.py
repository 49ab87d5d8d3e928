"""Device-resident replay: the row-major ring and the single-stream
feature-major ring.

Counterpart of ``dronerl_tpu/replay.py``'s row-major buffer (``init``,
``push``, ``push_many``, ``sample``, ``can_sample`` and the
``ReplayBuffer`` facade: slots on the leading axis, each experience
stored whole, ``next_obs`` included), its feature-major storage
(``init_t``, ``push_many_t``, ``sample_t`` and ``FeatureMajorReplay``:
slots on the last axis, a per-slot leaf of shape (D,) stored as (D,
capacity)), ``StreamReplay`` and ``inspect_memory``, with the same
semantics: ring writes at a rolling cursor, uniform sampling with
replacement.

Two differences of form, none of result:

* ``cursor`` and ``size`` are host ``int``s, as the ring engine keeps its
  step on the host: the trainer's control flow (whether a push wraps,
  whether the buffer can be sampled) then needs no read from the device.
  They are exact on the host because every push of a trainer has one
  size, so they are also a chunk's per-tick words (:class:`PushWords`:
  the push's start slot, the sample's bound and base), which the device
  path of a push or a sample reads as 0-d tensors instead
  (``start=``, ``bound=``, ``base=``): a CUDA graph's tick reads them from
  device memory, and its host ints stay as the capture left them until
  the chunk (``train.Chunk``) sets ``cursor`` and ``size`` at its exit.
* The JAX package is functional; here a push writes the storage tensors in
  place and returns a ``ReplayState`` holding the same tensors.

The trainers sample through ``sample_batch`` (``ReplayBuffer``,
``StreamReplay``): the sample with the dones as f32, as the trainers
cast them. On CUDA storage that is one launch of the sample kernel
(``ops/draws.py``: ``buffer_sample``, ``stream_sample``), which draws the
slots from a key on the storage's device (a chunk's row) or reads the
offsets a host key drew on the host (an eager tick's); on CPU storage its
plain version (``sample_batch_plain``: ``sample`` and the cast, the tensor
path that ``dronerl_tpu/replay.py``'s ``sample`` is held to).
"""

import collections
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.ops import draws


@dataclass
class ReplayState:
    """Ring storage plus the host cursor and size."""

    storage: Dict[str, torch.Tensor]  # name -> (capacity, *field_shape)
    #                                     or (*field_shape, capacity)
    cursor: int  # next write position
    size: int    # number of valid slots (<= capacity)


class PushWords(NamedTuple):
    """A push's words, worked out on the host from the cursor and size
    before it: the slot the push starts at, the sample's upper bound and
    its first slot after it (0 where the replay samples from slot 0), and
    the cursor and size after it."""

    start: int
    bound: int
    base: int
    cursor: int
    size: int


def push_start(cursor: int, n: int, capacity: int,
               aligned: bool = False) -> int:
    """The first slot a push of ``n`` writes: the cursor, or with
    ``aligned`` pushes that divide the capacity ``min(cursor, capacity -
    n)``, the clamp of the JAX package's ``dynamic_update_slice``."""
    if aligned and capacity % n == 0:
        return min(cursor, capacity - n)
    return cursor


def _device_slots(start: torch.Tensor, n: int, capacity: int,
                  device) -> torch.Tensor:
    """The slots ``(start + arange(n)) % capacity`` on ``device`` for a
    0-d start word there."""
    return (start.to(torch.int64) + torch.arange(n, device=device)) % capacity


def _write(storage: Dict[str, torch.Tensor], batch: Dict[str, Any],
           start, n: int, capacity: int, dim: int) -> None:
    """Write ``batch`` into ``storage`` at the slots ``start .. start + n
    - 1`` modulo ``capacity`` on axis ``dim`` (0 or -1), in place, each
    item cast to its storage's dtype: a slice where an int start does not
    wrap, else the slots as one index tensor (worked out on the device
    for a 0-d tensor start)."""
    if isinstance(start, torch.Tensor):
        slots = _device_slots(start, n, capacity, start.device)
    elif start + n <= capacity:
        for name, buf in storage.items():
            if dim == 0:
                buf[start:start + n] = batch[name]
            else:
                buf[..., start:start + n] = batch[name]
        return
    else:
        device = next(iter(storage.values())).device
        slots = ((start + torch.arange(n)) % capacity).to(device)
    for name, buf in storage.items():
        buf.index_copy_(dim % buf.dim(), slots, batch[name].to(buf.dtype))


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
              aligned: bool = False, start=None) -> ReplayState:
    """Write a leading-axis batch of experiences at the cursor, wrapping
    around the ring (in place; each item cast to its storage's dtype).

    ``aligned`` is the caller's promise that every push has this size and
    that it divides the capacity, so that no write wraps; the JAX package
    then writes with ``dynamic_update_slice``, which would clamp a start
    past ``capacity - n``, and so does this function (:func:`push_start`).
    ``start``: that first slot given, an int (a row's word on the host) or
    a 0-d integer tensor on the storage's device (a row's word there,
    written at ``(start + arange(n)) % capacity`` without reading the host
    cursor)."""
    n = next(iter(batch.values())).shape[0]
    if start is None:
        start = push_start(state.cursor, n, capacity, aligned)
    _write(state.storage, batch, start, n, capacity, 0)
    return ReplayState(storage=state.storage,
                       cursor=(state.cursor + n) % capacity,
                       size=min(state.size + n, capacity))


def sample(key: torch.Tensor, state: ReplayState, batch_size: int,
           bound=None) -> Dict[str, torch.Tensor]:
    """Uniform sample with replacement over the valid prefix: the slots of
    ``jax.random.randint(key, (batch_size,), 0, size)``, drawn where the
    key lies (a host key on the host). ``bound``: ``size`` as an int or a
    0-d integer tensor on the key's device (a row's word)."""
    idx = rng.randint(key, (batch_size,), 0,
                      state.size if bound is None else bound).to(torch.int64)
    return {name: buf[idx.to(buf.device, non_blocking=True)]
            for name, buf in state.storage.items()}


def can_sample(state: ReplayState, batch_size: int) -> bool:
    return state.size >= batch_size


def _host_offsets(key: torch.Tensor, batch_size: int, bound, device):
    """The sample kernel's offsets where ``key`` is a host key (an eager
    tick's): ``randint(key, (batch_size,), 0, bound)`` drawn on the host
    and copied to ``device``; None for a key there, which the kernel
    draws from."""
    if key.device == device:
        return None
    return rng.randint(key, (batch_size,), 0, bound).to(
        device, non_blocking=True)


def _float_dones(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    batch["dones"] = batch["dones"].to(torch.float32)
    return batch


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

    def push_many(self, state: ReplayState, batch: Dict[str, Any],
                  start=None) -> ReplayState:
        return push_many(state, batch, self.capacity,
                         aligned=self.uniform_pushes, start=start)

    def sample(self, key: torch.Tensor, state: ReplayState,
               bound=None) -> Dict[str, torch.Tensor]:
        return sample(key, state, self.batch_size, bound)

    def can_sample(self, state: ReplayState) -> bool:
        return can_sample(state, self.batch_size)

    def sample_batch(self, key: torch.Tensor, state: ReplayState,
                     bound=None, feature_major: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """A trainer's batch of whole transitions (storage obs and
        next_obs (capacity, D) f32, actions int32, rewards f32, dones
        bool): :meth:`sample` with the dones as f32 and, with
        ``feature_major``, obs and next_obs as (D, B), the learner
        kernel's layout. On CUDA storage one launch of the sample kernel
        (``draws.buffer_sample``), else :meth:`sample_batch_plain`."""
        obs = state.storage["obs"]
        if not obs.is_cuda:
            return self.sample_batch_plain(key, state, bound, feature_major)
        bound = state.size if bound is None else bound
        return draws.buffer_sample(
            key, state.storage, bound, batch_size=self.batch_size,
            feature_major=feature_major,
            offsets=_host_offsets(key, self.batch_size, bound, obs.device))

    @rng.plain_draws()
    def sample_batch_plain(self, key: torch.Tensor, state: ReplayState,
                           bound=None, feature_major: bool = False
                           ) -> Dict[str, torch.Tensor]:
        """:meth:`sample_batch` in plain PyTorch, on any device."""
        batch = _float_dones(self.sample(key, state, bound))
        if feature_major:
            for name in ("obs", "next_obs"):
                batch[name] = batch[name].t().contiguous()
        return batch

    def push_words(self, cursor: int, size: int, n: int) -> PushWords:
        """The words of a push of ``n`` from ``cursor`` and ``size``: its
        start slot (:func:`push_start`), the sample's bound ``size`` after
        it, base 0."""
        size = min(size + n, self.capacity)
        return PushWords(
            push_start(cursor, n, self.capacity, self.uniform_pushes), size,
            0, (cursor + n) % self.capacity, size)


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
                capacity: int, aligned: bool = False,
                start=None) -> ReplayState:
    """Write a last-axis batch of slots at the cursor, wrapping around the
    ring (in place; each item cast to its storage's dtype). ``aligned`` and
    ``start`` as :func:`push_many`'s: the start clamps to ``capacity -
    n``, and a given start writes at its slots."""
    n = next(iter(batch.values())).shape[-1]
    if start is None:
        start = push_start(state.cursor, n, capacity, aligned)
    _write(state.storage, batch, start, n, capacity, -1)
    return ReplayState(storage=state.storage,
                       cursor=(state.cursor + n) % capacity,
                       size=min(state.size + n, capacity))


def sample_t(key: torch.Tensor, state: ReplayState, batch_size: int,
             bound=None) -> Dict[str, torch.Tensor]:
    """Uniform with-replacement sample of slot columns (feature-major): the
    slots of ``jax.random.randint(key, (batch_size,), 0, size)``, drawn
    where the key lies; ``bound`` as :func:`sample`'s."""
    idx = rng.randint(key, (batch_size,), 0,
                      state.size if bound is None else bound).to(torch.int64)
    return {name: buf[..., idx.to(buf.device, non_blocking=True)]
            for name, buf in state.storage.items()}


class FeatureMajorReplay:
    """Ring replay with the slots on the last axis: :class:`ReplayBuffer`'s
    semantics (ring writes, uniform sampling with replacement) in the
    feature-major layout of the tick kernels."""

    def __init__(self, capacity: int = 10_000, batch_size: int = 64,
                 uniform_pushes: bool = False):
        self.capacity = capacity
        self.batch_size = batch_size
        self.uniform_pushes = uniform_pushes

    def init(self, template: Dict[str, torch.Tensor],
             device=None) -> ReplayState:
        return init_t(template, self.capacity, device)

    def push_many(self, state: ReplayState, batch: Dict[str, Any],
                  start=None) -> ReplayState:
        return push_many_t(state, batch, self.capacity,
                           aligned=self.uniform_pushes, start=start)

    def sample(self, key: torch.Tensor, state: ReplayState,
               bound=None) -> Dict[str, torch.Tensor]:
        return sample_t(key, state, self.batch_size, bound)

    def can_sample(self, state: ReplayState) -> bool:
        return can_sample(state, self.batch_size)


def stream_push_batch(obs_t: torch.Tensor, actions_t: torch.Tensor,
                      rewards_t: torch.Tensor, dones_t: torch.Tensor,
                      k: int) -> Dict[str, torch.Tensor]:
    """A StreamReplay engine's push of one tick: the first k drones'
    input observations, ``obs_t`` (k · obs_dim, E) with the drones' row
    groups side by side, drone-major (obs_dim, k · E), and their actions,
    rewards and dones ((N, E) each) in the same column order."""
    num_envs = obs_t.shape[-1]
    obs = obs_t if k == 1 else obs_t.reshape(k, -1, num_envs).permute(
        1, 0, 2).reshape(-1, k * num_envs)
    return {"obs": obs, "actions": actions_t[:k].reshape(-1),
            "rewards": rewards_t[:k].reshape(-1),
            "dones": dones_t[:k].reshape(-1)}


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

    def push_many(self, state: ReplayState, batch: Dict[str, Any],
                  start=None) -> ReplayState:
        """A stride-sized push at the cursor (``start``: as
        :func:`push_many_t`'s)."""
        n = next(iter(batch.values())).shape[-1]
        if n != self.stride:
            raise ValueError(
                f"StreamReplay pushes must be stride-sized ({self.stride}); "
                f"got {n}: the successor-offset arithmetic depends on it")
        return push_many_t(state, batch, self.capacity, start=start)

    def sample(self, key: torch.Tensor, state: ReplayState, bound=None,
               base=None) -> Dict[str, torch.Tensor]:
        """Uniform with-replacement over slots with a stored successor,
        drawn from ``key`` where it lies (``jax.random.randint``). Safe on
        a cold buffer (clamped index range); callers gate its use on
        :meth:`can_sample`. obs and next_obs are column slices of one
        gathered (D, 2B) tensor. ``bound`` and ``base``: the draw's upper
        bound and the first slot (:meth:`push_words`), ints or 0-d integer
        tensors on the key's device (a row's words), in place of the ones
        worked out from the host ints."""
        if bound is None:
            bound = max(state.size - self.stride, 1)
        raw = rng.randint(key, (self.batch_size,), 0, bound)
        if base is None:
            # When full, the oldest slot sits at the cursor; otherwise 0.
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

    def sample_batch(self, key: torch.Tensor, state: ReplayState,
                     bound=None, base=None) -> Dict[str, torch.Tensor]:
        """A trainer's batch: :meth:`sample` with the dones as f32. On
        CUDA storage one launch of the sample kernel
        (``draws.stream_sample``), else :meth:`sample_batch_plain`."""
        obs = state.storage["obs"]
        if not obs.is_cuda:
            return self.sample_batch_plain(key, state, bound, base)
        if bound is None:
            bound = max(state.size - self.stride, 1)
        if base is None:
            base = state.cursor if state.size == self.capacity else 0
        return draws.stream_sample(
            key, state.storage, bound, base, stride=self.stride,
            batch_size=self.batch_size,
            offsets=_host_offsets(key, self.batch_size, bound, obs.device))

    @rng.plain_draws()
    def sample_batch_plain(self, key: torch.Tensor, state: ReplayState,
                           bound=None, base=None) -> Dict[str, torch.Tensor]:
        """:meth:`sample_batch` in plain PyTorch, on any device."""
        return _float_dones(self.sample(key, state, bound, base))

    def can_sample(self, state: ReplayState) -> bool:
        return state.size - self.stride >= self.batch_size

    def push_words(self, cursor: int, size: int, n: int) -> PushWords:
        """The words of a push of ``n`` (the stride) from ``cursor`` and
        ``size``: it starts at the cursor; after it the sample draws below
        ``max(size - stride, 1)`` from the cursor when full, else from
        slot 0."""
        if n != self.stride:
            raise ValueError(f"StreamReplay pushes must be stride-sized "
                             f"({self.stride}); got {n}")
        after = (cursor + self.stride) % self.capacity
        size = min(size + self.stride, self.capacity)
        return PushWords(cursor, max(size - self.stride, 1),
                         after if size == self.capacity else 0, after, size)


# --- diagnostics ----------------------------------------------------------------

def inspect_memory(state: ReplayState, top_n: int = 10, max_col: int = 80,
                   plot: bool = False, printer: Callable = print,
                   slot_axis: Optional[int] = None) -> dict:
    """Buffer introspection (``dronerl_tpu/replay.py::inspect_memory``):
    fetches the valid slots to the host once and reports the action and
    reward counters, the done proportion and the ``top_n`` most frequent
    (next_)observations, with the JAX package's printed lines.

    Works on row-major (slots leading) and feature-major (slots last)
    storage: pass ``slot_axis`` (0 for ``ReplayBuffer``, -1 for
    ``StreamReplay`` and ``FeatureMajorReplay``); when omitted it is the
    one axis whose length is the slot count, and a shape with several
    such axes raises. ``plot=True`` draws the reward and action bar
    charts with matplotlib (imported here). Returns the counters."""
    storage = {name: buf.detach().cpu().numpy()
               for name, buf in state.storage.items()}
    size = int(state.size)
    actions = storage["actions"].reshape(-1)
    slots = actions.shape[0]

    def valid(arr):
        if arr.ndim == 1:
            return arr[:size]
        if slot_axis is not None:
            axis = slot_axis % arr.ndim
        else:
            candidates = [i for i, s in enumerate(arr.shape) if s == slots]
            if not candidates:
                raise ValueError(
                    f"no axis of shape {arr.shape} matches the slot count "
                    f"{slots}; pass slot_axis= explicitly")
            if len(candidates) > 1:
                raise ValueError(
                    f"slot axis of shape {arr.shape} is ambiguous (several "
                    f"axes have length {slots}); pass slot_axis= explicitly "
                    f"(0 for ReplayBuffer, -1 for StreamReplay)")
            axis = candidates[0]
        return np.moveaxis(arr, axis, 0)[:size]

    counters = collections.defaultdict(collections.Counter)
    counters["action"].update(valid(actions).tolist())
    counters["reward"].update(
        np.round(valid(storage["rewards"]), 6).tolist())
    counters["done"].update(valid(storage["dones"]).astype(bool).tolist())
    for field, key in (("obs", "state"), ("next_obs", "next_state")):
        if field in storage:
            rows = valid(storage[field])
            counters[key].update(
                tuple(np.round(row, 6).tolist()) for row in rows)

    def top_states(counter):
        for i, (obs, count) in enumerate(counter.most_common(top_n), 1):
            label = str(np.asarray(obs)).replace("\n", " ")
            if len(label) > max_col:
                label = label[:max_col] + ".."
            printer(f"{i:>2}) Count: {count} state: {label}")

    printer(f"Replay memory: {size}/{slots} slots filled")
    printer(f"Actions: {dict(counters['action'].most_common())}")
    printer(f"Rewards: {dict(counters['reward'].most_common(top_n))}")
    if "state" in counters:
        printer("Top state:")
        top_states(counters["state"])
        printer("Top next_state:")
        top_states(counters["next_state"])
    done_frac = counters["done"][True] / max(1, size)
    printer(f"Proportion of done: {100 * done_frac:.2f}%")

    if plot:
        import matplotlib.pyplot as plt

        fig, (ax1, ax2) = plt.subplots(nrows=1, ncols=2, figsize=(12, 4))
        for counter, ax, label in ((counters["reward"], ax1, "rewards"),
                                   (counters["action"], ax2, "actions")):
            pairs = counter.most_common()
            total = sum(c for _, c in pairs) or 1
            ax.bar(range(len(pairs)), [c / total for _, c in pairs])
            ax.set_xticks(range(len(pairs)))
            ax.set_xticklabels([str(k) for k, _ in pairs])
            ax.set_ylabel("proportion")
            ax.set_xlabel(label)
            ax.set_title("Replay Memory")
        plt.show()

    return dict(counters)
