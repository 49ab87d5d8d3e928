"""The subset of ``jax.random`` the training tick consumes, bit-exact.

Keys are int64 tensors of shape (..., 2) holding the two uint32 key words
(the JAX key's data, ``jax.random.key_data``). All arithmetic runs on int64
masked to 32 bits: torch's uint32 tensors do not support ``+``, ``<<`` or
``>>`` on every backend, and int64 holds every intermediate exactly.

Layout follows jax's *partitionable* threefry (``jax_threefry_partitionable``,
the default since jax 0.5): a counter array over the flattened output
index i is hashed as the word pair (hi32(i), lo32(i)) = (0, i), ``split``
returns the two output words per counter, and random bits are
``b1 ^ b2``.
"""

import functools
import math

import torch

MASK32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & MASK32


def _threefry(k1, k2, x0, x1):
    """The 20 rounds on Python ints or int64 tensors alike (every value
    held in [0, 2**32))."""
    ks0, ks1 = k1, k2
    ks2 = k1 ^ k2 ^ 0x1BD11BDA
    x0 = (x0 + ks0) & MASK32
    x1 = (x1 + ks1) & MASK32
    schedule = ((_ROT0, ks1, ks2, 1), (_ROT1, ks2, ks0, 2),
                (_ROT0, ks0, ks1, 3), (_ROT1, ks1, ks2, 4),
                (_ROT0, ks2, ks0, 5))
    for rots, inj0, inj1, i in schedule:
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = (x0 + inj0) & MASK32
        x1 = (x1 + inj1 + i) & MASK32
    return x0, x1


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds, elementwise over broadcast int64 args.

    Same rotations and key injections as jax's lowering and as
    ``dronerl_tpu/ops/step_kernel.py::threefry2x32``.
    """
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    as64 = functools.partial(torch.as_tensor, dtype=torch.int64,
                             device=k1.device)
    return _threefry(k1, as64(k2), as64(x0), as64(x1))


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


# A single host key hashing few counters (the trainer's per-tick chain)
# runs on Python ints: a tensor op per round costs far more than the hash.
_HOST_COUNTS = 64


def _hash_counts(key: torch.Tensor, n: int):
    """Threefry words (b1, b2) of counters 0..n-1 under key (..., 2)."""
    if key.device.type == "cpu" and key.dim() == 1 and n <= _HOST_COUNTS:
        k1, k2 = (int(v) for v in key.tolist())
        words = [_threefry(k1, k2, 0, i) for i in range(n)]
        return (torch.tensor([w[0] for w in words], dtype=torch.int64),
                torch.tensor([w[1] for w in words], dtype=torch.int64))
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], 0, counts)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key (..., 2) -> (..., num, 2)."""
    b1, b2 = _hash_counts(key, num)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit random words for key (..., 2) -> (..., *shape) int64."""
    shape = tuple(shape)
    b1, b2 = _hash_counts(key, math.prod(shape))
    return (b1 ^ b2).reshape(*key.shape[:-1], *shape)


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """bitcast((bits >> 9) | 0x3f800000) - 1: a float32 in [0, 1)."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    return bits_to_unit_float(random_bits(key, shape))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 output.

    Follows jax's ``_randint``: two 32-bit draws from ``split(key)`` are
    combined as ``(hi % span) * (2**32 % span) + lo % span``, all in
    wrapping uint32 arithmetic. ``minval``/``maxval`` are Python ints in
    the int32 range.
    """
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not -(1 << 31) <= v < (1 << 31):
            raise ValueError(f"bound {v} is outside the int32 range")
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = 1 if maxval <= minval else (maxval - minval) & MASK32
    multiplier = (1 << 16) % span
    multiplier = (multiplier * multiplier & MASK32) % span
    offset = ((higher % span) * multiplier & MASK32) + (lower % span)
    offset = (offset & MASK32) % span
    out = (minval + offset) & MASK32
    # uint32 -> int32 two's complement
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(torch.int32)
