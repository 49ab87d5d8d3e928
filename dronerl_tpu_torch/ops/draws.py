"""The tick's ``jax.random`` draws and the replay engines' samples, one
launch each (``csrc/draws.cu``).

No Pallas kernel stands behind these: in the JAX package the draws are
``jax.random`` calls outside the kernels, which XLA fuses into one kernel
each under ``jit``. Their plain versions are ``rng``'s (``split_plain``,
``random_bits_plain``, ``uniform_plain``, ``randint_plain``), int64 tensor
ops, ~150 launches a hash on a card, and ``fused_tick.
ring_gather_batch_plain``. ``rng.split`` / ``random_bits`` / ``uniform`` /
``randint`` call :func:`draw` for a CUDA key and ``fused_tick.
ring_gather_batch`` calls :func:`ring_sample` for a CUDA ring. The
replays' samples are modes of the ring sample's kernel: ``replay.
StreamReplay.sample_batch`` calls :func:`stream_sample` and ``replay.
ReplayBuffer.sample_batch`` :func:`buffer_sample` on CUDA storage (their
plain versions are the replays' tensor paths, ``sample`` with the dones
as f32, the counterparts of ``dronerl_tpu/replay.py:258`` and ``:399``
with the trainers' cast). Each counts its launches (``draw.launches``,
``ring_sample.launches``, ...). A CUDA tensor never falls back to the
plain version: a failed build or launch raises.
"""

import ctypes
from typing import Dict, Optional

import torch

from dronerl_tpu_torch.ops import _build

MODES = ("split", "bits", "uniform", "randint")
_OUT_DTYPES = {"split": torch.int64, "bits": torch.int64,
               "uniform": torch.float32, "randint": torch.int32}


class _DrawArgs(ctypes.Structure):
    """Mirror of ``DrawArgs`` in csrc/draws.cu (field order matters)."""

    _fields_ = [("key", ctypes.c_void_p), ("bound", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("num_keys", ctypes.c_int64),
                ("count", ctypes.c_int64), ("key_stride", ctypes.c_int64),
                ("mode", ctypes.c_int32), ("rounds", ctypes.c_int32),
                ("bound_i64", ctypes.c_int32), ("minval", ctypes.c_int32),
                ("span", ctypes.c_uint32)]


class _RingSampleArgs(ctypes.Structure):
    """Mirror of ``RingSampleArgs`` in csrc/draws.cu (field order
    matters)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "ring", "a_ring", "r_ring", "d_ring", "key", "offsets", "both",
        "actions", "rewards", "dones")] + [
        (name, ctypes.c_int64) for name in (
            "ring_ld", "scalar_ld", "capacity", "base_slot", "num_envs")] + [
        ("obs_dim", ctypes.c_int32), ("batch", ctypes.c_int32),
        ("collect", ctypes.c_int32), ("span", ctypes.c_uint32),
        ("ring_bf16", ctypes.c_int32), ("bound", ctypes.c_void_p),
        ("base", ctypes.c_void_p), ("next_rows", ctypes.c_void_p),
        ("rows_in", ctypes.c_int32), ("rows_out", ctypes.c_int32)]


def _launch(entry: str, args, device) -> None:
    lib = _build.load(_build.draw_config())
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, entry)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: " + _build.error_string(lib, err))


def _key_rows(key: torch.Tensor) -> torch.Tensor:
    """A CUDA key (..., 2) as (K, 2) rows with unit word stride (a view
    where the leading dims flatten into one stride, else a copy)."""
    if not key.is_cuda:
        raise ValueError(f"the draw kernel takes a CUDA key, not {key.device}")
    if key.dtype != torch.int64 or key.dim() < 1 or key.shape[-1] != 2:
        raise ValueError(f"a key is an int64 (..., 2) tensor, got "
                         f"{key.dtype} {tuple(key.shape)}")
    rows = key.reshape(-1, 2)
    return rows if rows.stride(1) == 1 else rows.contiguous()


def _draw_args(key: torch.Tensor, count: int, mode: str, rounds: int = 20,
               minval: int = 0, span: int = 1,
               bound: Optional[torch.Tensor] = None):
    """Check the inputs, allocate the output and fill the launch's
    argument block. Returns ``(args, out, operands)``: ``operands`` holds
    the tensors the block points at, to keep alive while it is launched."""
    if mode not in _OUT_DTYPES:
        raise ValueError(f"draw mode {mode!r}: one of {MODES}")
    rows = _key_rows(key)
    lead = tuple(key.shape[:-1])
    shape = lead + ((count, 2) if mode == "split" else (count,))
    out = torch.empty(shape, dtype=_OUT_DTYPES[mode], device=key.device)
    a = _DrawArgs()
    a.key, a.out = rows.data_ptr(), out.data_ptr()
    a.num_keys, a.count, a.key_stride = rows.shape[0], count, rows.stride(0)
    a.mode, a.rounds = MODES.index(mode), rounds
    a.minval, a.span = minval, span
    if bound is not None:
        if bound.device != key.device or bound.dim() != 0:
            raise ValueError("a tensor bound must be a 0-d integer tensor on "
                             "the key's device")
        if bound.dtype not in (torch.int32, torch.int64):
            bound = bound.to(torch.int64)
        a.bound, a.bound_i64 = bound.data_ptr(), int(
            bound.dtype == torch.int64)
    return a, out, (rows, bound)


def draw(key: torch.Tensor, count: int, mode: str, rounds: int = 20,
         minval: int = 0, span: int = 1,
         bound: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``count`` counters of every key of ``key`` (..., 2), one launch:
    ``split`` (..., count, 2) int64 words, ``bits`` (..., count) int64,
    ``uniform`` (..., count) f32, ``randint`` (..., count) int32 in
    ``[minval, minval + span)`` (``jax.random.randint``'s arithmetic;
    ``bound``, a 0-d integer tensor on the key's device, replaces the
    span by ``bound - minval`` where it exceeds ``minval``, else 1). The
    caller has checked ``rounds`` and the bounds (``rng``)."""
    args, out, _operands = _draw_args(key, count, mode, rounds, minval,
                                      span, bound)
    if out.numel() == 0:
        return out
    _launch("draw_launch", args, key.device)
    draw.launches += 1
    return out


# Launches of the draw kernel: one a call, and one a replay of each launch
# that a captured CUDA graph holds (added by the graph's owner).
draw.launches = 0


def _ring_sample_args(sample_key, ring: torch.Tensor, a_ring: torch.Tensor,
                      r_ring: torch.Tensor, d_ring: torch.Tensor, span: int,
                      base_slot: int, *, num_envs: int, capacity: int,
                      batch_size: int, collect: int = 1,
                      obs_dim: Optional[int] = None,
                      offsets: Optional[torch.Tensor] = None):
    """Check the inputs, allocate the batch and fill the launch's argument
    block. Returns ``(args, batch, operands)`` (as :func:`_draw_args`)."""
    device = ring.device
    k = collect
    obs_dim = ring.shape[0] // k if obs_dim is None else obs_dim
    if not ring.is_cuda:
        raise ValueError("the ring sample kernel takes a CUDA ring")
    if ring.dtype not in (torch.float32, torch.bfloat16) or ring.dim() != 2 \
            or ring.stride(1) != 1 or ring.shape[0] < k * obs_dim \
            or ring.shape[1] < capacity:
        raise ValueError(f"the ring must be an f32 or bf16 (rows, capacity) "
                         f"array with unit column stride, got {ring.dtype} "
                         f"{tuple(ring.shape)} strides {ring.stride()}")
    scalar_shape = (capacity,) if k == 1 else (k, capacity)
    for name, t, dt in (("a_ring", a_ring, torch.int32),
                        ("r_ring", r_ring, torch.float32),
                        ("d_ring", d_ring, torch.int8)):
        if (t.device != device or t.dtype != dt
                or tuple(t.shape) != scalar_shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} "
                             f"{scalar_shape} array on {device}")
    if batch_size % k or not 1 <= span < 1 << 31:
        raise ValueError(f"batch {batch_size} over {k} drones, span {span}")
    a = _RingSampleArgs()
    operands = _sample_source(a, sample_key, offsets, batch_size, device)
    batch = _sample_batch(a, obs_dim, batch_size, device)
    a.ring, a.a_ring, a.r_ring, a.d_ring = (
        t.data_ptr() for t in (ring, a_ring, r_ring, d_ring))
    a.ring_ld, a.scalar_ld = ring.stride(0), capacity
    a.capacity, a.base_slot, a.num_envs = capacity, base_slot, num_envs
    a.obs_dim, a.batch, a.collect, a.span = obs_dim, batch_size, k, span
    a.ring_bf16 = int(ring.dtype == torch.bfloat16)
    return a, batch, operands


def _sample_source(a: _RingSampleArgs, sample_key, offsets, batch_size: int,
                   device):
    """Point a sample's block at ``offsets`` ((batch_size,) int32, drawn on
    the host) where they are given, else at ``sample_key`` (an int64 (2,)
    key on ``device``, which the kernel draws from). Returns the tensors
    the block points at."""
    if offsets is not None:
        if (offsets.device != device or offsets.dtype != torch.int32
                or tuple(offsets.shape) != (batch_size,)):
            raise ValueError(f"offsets must be ({batch_size},) int32 on "
                             f"{device}")
        offsets = offsets.contiguous()
        a.offsets = offsets.data_ptr()
    else:
        if (sample_key.device != device or tuple(sample_key.shape) != (2,)
                or sample_key.dtype != torch.int64):
            raise ValueError(f"the sample key must be an int64 (2,) key on "
                             f"{device}")
        sample_key = sample_key.contiguous()
        a.key = sample_key.data_ptr()
    return sample_key, offsets


def _sample_batch(a: _RingSampleArgs, obs_dim: int, batch_size: int, device,
                  rows_out: bool = False) -> Dict[str, torch.Tensor]:
    """A sample's batch, the block pointed at it: obs and next_obs
    (obs_dim, B) column slices of one f32 (obs_dim, 2B) array, or with
    ``rows_out`` (B, obs_dim) row slices of one (2B, obs_dim) array;
    actions, rewards and dones (B,), dones f32."""
    both = torch.empty((2 * batch_size, obs_dim) if rows_out
                       else (obs_dim, 2 * batch_size),
                       dtype=torch.float32, device=device)
    batch = ({"obs": both[:batch_size], "next_obs": both[batch_size:]}
             if rows_out else
             {"obs": both[:, :batch_size], "next_obs": both[:, batch_size:]})
    for name, dt in (("actions", torch.int32), ("rewards", torch.float32),
                     ("dones", torch.float32)):
        batch[name] = torch.empty((batch_size,), dtype=dt, device=device)
    a.both = both.data_ptr()
    a.actions, a.rewards, a.dones = (
        batch[n].data_ptr() for n in ("actions", "rewards", "dones"))
    return batch


def _word(value, name: str, device):
    """A sample's bound or base slot: a host int, or a 0-d int32 word on
    ``device`` that the kernel reads by pointer (a chunk's row). Returns
    ``(int or None, tensor or None)``."""
    if isinstance(value, torch.Tensor):
        if value.device != device or value.dim() != 0 \
                or value.dtype != torch.int32:
            raise ValueError(f"a tensor {name} must be a 0-d int32 word on "
                             f"{device}, got {value.dtype} "
                             f"{tuple(value.shape)} on {value.device}")
        return None, value
    return int(value), None


def _replay_sample_args(sample_key, obs: torch.Tensor, scalars, bound, base,
                        *, batch_size: int, stride: int = 0,
                        next_rows: Optional[torch.Tensor] = None,
                        rows_out: bool = False,
                        offsets: Optional[torch.Tensor] = None):
    """The argument block of the replays' modes of the ring sample kernel:
    a StreamReplay's f32 (obs_dim, capacity) columns with the successor
    ``stride`` slots on, or (``next_rows`` given) a ReplayBuffer's f32
    (capacity, obs_dim) rows of obs and next_obs; ``scalars`` the actions,
    rewards and dones (capacity,). Returns ``(args, batch, operands)`` (as
    :func:`_draw_args`)."""
    rows_in = next_rows is not None
    capacity, obs_dim = obs.shape if rows_in else obs.shape[::-1]
    device = obs.device
    if not obs.is_cuda:
        raise ValueError("the replay sample kernel takes CUDA storage")
    for name, t in (("obs", obs),) + ((("next_obs", next_rows),)
                                      if rows_in else ()):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.stride(1) != 1
                or t.device != device or tuple(t.shape) != tuple(obs.shape)):
            raise ValueError(f"{name} must be an f32 {tuple(obs.shape)} "
                             f"array with unit inner stride on {device}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for (name, dt), t in zip((("actions", torch.int32),
                              ("rewards", torch.float32),
                              ("dones", torch.bool)), scalars):
        if (t.device != device or t.dtype != dt
                or tuple(t.shape) != (capacity,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} "
                             f"({capacity},) array on {device}")
    span, bound_t = _word(bound, "bound", device)
    base_slot, base_t = _word(base, "base", device)
    a = _RingSampleArgs()
    operands = _sample_source(a, sample_key, offsets, batch_size, device)
    batch = _sample_batch(a, obs_dim, batch_size, device, rows_out)
    a.ring, a.a_ring, a.r_ring, a.d_ring = (
        t.data_ptr() for t in (obs, *scalars))
    a.ring_ld, a.scalar_ld = obs.stride(0), capacity
    a.capacity, a.num_envs = capacity, stride
    a.base_slot = base_slot or 0
    a.obs_dim, a.batch, a.collect = obs_dim, batch_size, 1
    # randint's span: the bound, 1 where it is not above 0 (the kernel
    # reads the bound's word where it is one).
    a.span = max(span, 1) if span is not None else 1
    if bound_t is not None:
        a.bound = bound_t.data_ptr()
    if base_t is not None:
        a.base = base_t.data_ptr()
    if rows_in:
        a.next_rows, a.rows_in, a.rows_out = (next_rows.data_ptr(), 1,
                                              int(rows_out))
    return a, batch, (*operands, bound_t, base_t)


def stream_sample(sample_key, storage: Dict[str, torch.Tensor], bound, base,
                  *, stride: int, batch_size: int,
                  offsets: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """A StreamReplay's sample in one launch (``replay.StreamReplay.
    sample_batch``'s function): offsets in ``[0, max(bound, 1))`` drawn
    from ``sample_key`` (2,) on the storage's device, or ``offsets``
    (batch_size,) int32 drawn on the host; slot ``(base + offset) %
    capacity``, its successor ``stride`` slots on. ``bound`` and ``base``
    are host ints or 0-d int32 words on the device (a chunk's row), read
    by pointer. ``storage``: obs (obs_dim, capacity) f32, actions,
    rewards, dones (capacity,). Returns obs / next_obs (obs_dim, B) column
    slices of one f32 (obs_dim, 2B) array, actions, rewards and dones (B,)
    (dones f32)."""
    args, batch, _operands = _replay_sample_args(
        sample_key, storage["obs"], [storage[n] for n in (
            "actions", "rewards", "dones")], bound, base,
        batch_size=batch_size, stride=stride, offsets=offsets)
    _launch("ring_sample_launch", args, storage["obs"].device)
    stream_sample.launches += 1
    return batch


stream_sample.launches = 0


def buffer_sample(sample_key, storage: Dict[str, torch.Tensor], bound, *,
                  batch_size: int, feature_major: bool,
                  offsets: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """A row-major ReplayBuffer's sample in one launch (``replay.
    ReplayBuffer.sample_batch``'s function): the slots ``randint(key,
    (batch_size,), 0, bound)`` (or ``offsets``, as :func:`stream_sample`)
    of whole transitions, obs and next_obs (capacity, obs_dim) f32,
    actions, rewards, dones (capacity,). Writes obs / next_obs
    ``feature_major`` (obs_dim, B) column slices of one (obs_dim, 2B)
    array, the learner kernel's layout, else (B, obs_dim) row slices of
    one (2B, obs_dim) array; dones as f32."""
    args, batch, _operands = _replay_sample_args(
        sample_key, storage["obs"], [storage[n] for n in (
            "actions", "rewards", "dones")], bound, 0,
        batch_size=batch_size, next_rows=storage["next_obs"],
        rows_out=not feature_major, offsets=offsets)
    _launch("ring_sample_launch", args, storage["obs"].device)
    buffer_sample.launches += 1
    return batch


buffer_sample.launches = 0


def ring_sample(sample_key, ring: torch.Tensor, a_ring: torch.Tensor,
                r_ring: torch.Tensor, d_ring: torch.Tensor, span: int,
                base_slot: int, *, num_envs: int, capacity: int,
                batch_size: int, collect: int = 1,
                obs_dim: Optional[int] = None,
                offsets: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """The ring engine's replay sample in one launch, the function of
    ``fused_tick.ring_gather_batch_plain``: the kernel draws the offsets
    in ``[0, span)`` from ``sample_key`` (2,) on the ring's device
    (``jax.random.randint``), or reads ``offsets``, (batch_size,) int32
    drawn on the host and copied over (an eager tick's), in place of the
    key. Column c is ``(base_slot + offset_c) % capacity``, its next
    observation ``num_envs`` columns on. Returns the batch dict (obs /
    next_obs (obs_dim, B) column slices of one f32 (obs_dim, 2B) array;
    actions, rewards, dones (B,))."""
    args, batch, _operands = _ring_sample_args(
        sample_key, ring, a_ring, r_ring, d_ring, span, base_slot,
        num_envs=num_envs, capacity=capacity, batch_size=batch_size,
        collect=collect, obs_dim=obs_dim, offsets=offsets)
    _launch("ring_sample_launch", args, ring.device)
    ring_sample.launches += 1
    return batch


ring_sample.launches = 0

