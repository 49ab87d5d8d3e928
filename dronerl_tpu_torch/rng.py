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

import hashlib
import math

import torch

MASK32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & MASK32


def _threefry(k1, k2, x0, x1, rounds=20):
    """``rounds`` rounds (a multiple of 4 in [4, 20]) on Python ints or
    int64 tensors alike (every value held in [0, 2**32)): each group of
    four rotations is followed by its key injection, as JAX's schedule."""
    ks0, ks1 = k1, k2
    ks2 = k1 ^ k2 ^ 0x1BD11BDA
    x0 = (x0 + ks0) & MASK32
    x1 = (x1 + ks1) & MASK32
    schedule = ((_ROT0, ks1, ks2, 1), (_ROT1, ks2, ks0, 2),
                (_ROT0, ks0, ks1, 3), (_ROT1, ks1, ks2, 4),
                (_ROT0, ks2, ks0, 5))
    for rots, inj0, inj1, i in schedule[:rounds // 4]:
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = (x0 + inj0) & MASK32
        x1 = (x1 + inj1 + i) & MASK32
    return x0, x1


# The round counts of Threefry-2x32-R that the JAX package's
# ``threefry2x32`` takes: a multiple of 4 in [4, 20].
ROUNDS = (4, 8, 12, 16, 20)


def check_rounds(rounds: int) -> int:
    """``rounds`` if it is one of :data:`ROUNDS`, else ValueError."""
    if rounds not in ROUNDS:
        raise ValueError(f"threefry rounds {rounds}: a multiple of 4 in "
                         "[4, 20]")
    return rounds


def threefry2x32(k1, k2, x0, x1, rounds: int = 20):
    """Threefry-2x32, elementwise over broadcast int64 args.

    Same rotations and key injections as jax's lowering and as
    ``dronerl_tpu/ops/step_kernel.py::threefry2x32``: 20 rounds are
    ``jax.random``'s, fewer (``rounds``, a multiple of 4) the
    reduced-round Threefry-2x32-R of the fast-RNG mode.
    """
    check_rounds(rounds)
    k1 = torch.as_tensor(k1, dtype=torch.int64)

    def word(x):
        # A Python int stays one: a tensor made from it on the card would
        # be a host-to-device copy, which a CUDA graph cannot capture.
        return x if isinstance(x, int) else torch.as_tensor(
            x, dtype=torch.int64, device=k1.device)

    return _threefry(k1, word(k2), word(x0), word(x1), rounds)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


# A single host key hashing few counters (the trainer's per-tick chain)
# runs on Python ints: a tensor op per round costs far more than the hash.
_HOST_COUNTS = 64


def _hash_counts(key: torch.Tensor, n: int, rounds: int = 20):
    """Threefry words (b1, b2) of counters 0..n-1 under key (..., 2)."""
    if key.device.type == "cpu" and key.dim() == 1 and n <= _HOST_COUNTS:
        k1, k2 = (int(v) for v in key.tolist())
        check_rounds(rounds)
        words = [_threefry(k1, k2, 0, i, rounds) for i in range(n)]
        return (torch.tensor([w[0] for w in words], dtype=torch.int64),
                torch.tensor([w[1] for w in words], dtype=torch.int64))
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], 0, counts, rounds)


def split(key: torch.Tensor, num: int = 2, rounds: int = 20) -> torch.Tensor:
    """``jax.random.split``: key (..., 2) -> (..., num, 2); with ``rounds``
    < 20 the same split hashed by Threefry-2x32-``rounds``."""
    b1, b2 = _hash_counts(key, num, rounds)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape, rounds: int = 20) -> torch.Tensor:
    """32-bit random words for key (..., 2) -> (..., *shape) int64."""
    shape = tuple(shape)
    b1, b2 = _hash_counts(key, math.prod(shape), rounds)
    return (b1 ^ b2).reshape((*key.shape[:-1], *shape))


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """bitcast((bits >> 9) | 0x3f800000) - 1: a float32 in [0, 1)."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape, rounds: int = 20) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)); with
    ``rounds`` < 20 its bits from Threefry-2x32-``rounds``."""
    return bits_to_unit_float(random_bits(key, shape, rounds))


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


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a host key (2,) and a uint32:
    threefry of the key over the seed words (0, data), jax's
    ``threefry_seed`` of a 32-bit value."""
    k1, k2 = (int(v) for v in key.tolist())
    return torch.tensor(_threefry(k1, k2, 0, int(data) & MASK32),
                        dtype=torch.int64)


# --- float32 arithmetic as XLA's CPU backend evaluates it --------------------
#
# jax.random.truncated_normal maps a uniform through lax.erf_inv, which XLA
# lowers to Giles' single-precision polynomial over log1p; on the CPU the
# log is its own Cephes-style polynomial, and LLVM contracts each multiply
# that feeds an add into one fused multiply-add. The functions below repeat
# those f32 steps in torch ops on CPU tensors, a fused multiply-add as the
# float64 product and sum rounded once to f32 (a product of two f32 is
# exact in float64).

def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    return (a.double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 log (Cephes' logf, as Eigen writes it) for x > 0."""
    t = torch.clamp(x, min=_f32(2.0 ** -126))
    bits = t.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    t = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = t < _f32(0.707106781186547524)
    t1 = torch.where(small, t, _f32(0.0))
    t = (t - 1.0) + t1
    e = e - small.to(torch.float32)
    x2 = t * t
    x3 = x2 * t
    y = _fma(_fma(t, _LOG_P[0], _LOG_P[1]), t, _LOG_P[2])
    y1 = _fma(_fma(t, _LOG_P[3], _LOG_P[4]), t, _LOG_P[5])
    y2 = _fma(_fma(t, _LOG_P[6], _LOG_P[7]), t, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _f32(-2.12194440e-4) * e)
    t = _fma(_f32(-0.5), x2, t)
    return _fma(_f32(0.693359375), e, t + y)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1., 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log1p: a Cephes rational below sqrt(2) - 1 in magnitude,
    else log(1 + x)."""
    def poly(coeffs):
        p = torch.zeros_like(x)
        for c in coeffs:
            p = _fma(p, x, _f32(c))
        return p
    x2 = x * x
    small = (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN))
    small = x + _fma(_f32(-0.5), x2, small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log_f32(x + 1.0))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` on f32 as XLA evaluates it: Giles' single-precision
    polynomial in w = -log1p(-x²) (``torch.erfinv`` is another
    approximation and differs in the last bits)."""
    w = -_log1p_f32(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, _f32(lo), _f32(hi)))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in f32 on
    the CPU (jax/_src/random.py ``_truncated_normal``): a uniform on
    [erf(lower/√2), erf(upper/√2)], mapped through √2·erf⁻¹, clamped to the
    open interval (lower, upper)."""
    sqrt2 = _f32(math.sqrt(2))
    lo, hi = _f32(lower), _f32(upper)
    a, b = torch.erf(lo / sqrt2), torch.erf(hi / sqrt2)
    unit = bits_to_unit_float(random_bits(key, shape))
    u = torch.maximum(a, _fma(unit, b - a, a))
    out = sqrt2 * erfinv_f32(u)
    return torch.clamp(out, torch.nextafter(lo, _f32(math.inf)),
                       torch.nextafter(hi, _f32(-math.inf)))


def flax_param_key(key: torch.Tensor, path) -> torch.Tensor:
    """The key flax 0.12 hands a parameter's initialiser
    (``flax/core/scope.py``): ``Scope.make_rng`` counts the ``make_rng``
    calls of a module (1 for the first parameter, 2 for the second) and
    wraps the init key in a ``LazyRng`` whose suffix is the module path
    then that count; ``LazyRng.as_jax_rng`` folds the suffix in with
    ``_fold_in_static``: a SHA-1 over each suffix item (a str as UTF-8, an
    int as its minimal big-endian bytes; with the
    ``flax_fix_rng_separator`` config, off by default and not set by the
    JAX package, each item would be preceded by a zero byte), whose first
    four bytes, big-endian, are folded into the key with ``fold_in``.
    ``path`` is that suffix, e.g. ``("Dense_0", 1)`` for the kernel of
    a top-level ``Dense_0``."""
    digest = hashlib.sha1()
    for item in path:
        if isinstance(item, str):
            digest.update(item.encode("utf-8"))
        else:
            digest.update(item.to_bytes((item.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(digest.digest()[:4], "big"))
