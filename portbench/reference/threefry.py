"""The draws of ``jax.random`` that a training tick consumes, in plain
PyTorch on any device: Threefry-2x32 at 20 rounds in the partitionable
layout (counter i hashed as the word pair (0, i); ``split`` keeps both
output words, random bits are their xor), ``uniform``, ``randint`` and,
for the nets' initial weights, flax's per-parameter keys and jax's f32
truncated normal as XLA's CPU backend evaluates it.

Keys are int64 tensors (..., 2) holding two uint32 words. Every value is
kept in [0, 2**32) on int64, so no backend's unsigned arithmetic is
needed. Nothing here imports the program under test.
"""

import hashlib
import math

import torch

MASK32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry(k1, k2, x0, x1):
    """Threefry-2x32-20 on Python ints or int64 tensors alike."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in (_ROT0 if i % 2 == 0 else _ROT1):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` of a seed in the int32 range."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def _counts(key: torch.Tensor, n: int):
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry(key[..., 0:1], key[..., 1:2], 0, counts)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    b1, b2 = _counts(key, num)
    return torch.stack([b1, b2], dim=-1)


def split_host(k1: int, k2: int, num: int):
    """``split`` of one key on Python ints: a list of ``num`` word pairs."""
    return [threefry(k1, k2, 0, i) for i in range(num)]


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(shape)
    b1, b2 = _counts(key, math.prod(shape))
    return (b1 ^ b2).reshape((*key.shape[:-1], *shape))


def unit_float(bits: torch.Tensor) -> torch.Tensor:
    """A float32 in [0, 1) from the high 23 bits of a word."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    return unit_float(random_bits(key, shape))


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` into int32: two words from ``split(key)``
    combined as ``(hi % span) * (2**32 % span) + lo % span`` in wrapping
    uint32 arithmetic."""
    span = 1 if maxval <= minval else (maxval - minval) & MASK32
    bits = random_bits(split(key, 2), shape)
    hi, lo = bits.select(key.dim() - 1, 0), bits.select(key.dim() - 1, 1)
    mult = (1 << 16) % span
    mult = (mult * mult & MASK32) % span
    off = (((hi % span) * mult & MASK32) + (lo % span)) & MASK32
    out = (minval + off % span) & MASK32
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(
        torch.int32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    k1, k2 = (int(v) for v in key.tolist())
    return torch.tensor(threefry(k1, k2, 0, int(data) & MASK32),
                        dtype=torch.int64)


def flax_param_key(key: torch.Tensor, path) -> torch.Tensor:
    """The key flax hands a parameter's initialiser: the first four bytes
    (big-endian) of a SHA-1 over the module path and the ``make_rng``
    count, folded into the init key."""
    digest = hashlib.sha1()
    for item in path:
        if isinstance(item, str):
            digest.update(item.encode("utf-8"))
        else:
            digest.update(item.to_bytes((item.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(digest.digest()[:4], "big"))


# --- f32 arithmetic as XLA's CPU backend evaluates it ------------------------
# A fused multiply-add is the float64 product and sum rounded once.

def _fma(a, b, c) -> torch.Tensor:
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log(x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(x, min=_f32(2.0 ** -126))
    bits = t.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    t = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = t < _f32(0.707106781186547524)
    t = (t - 1.0) + torch.where(small, t, _f32(0.0))
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


def _log1p(x: torch.Tensor) -> torch.Tensor:
    def poly(coeffs):
        p = torch.zeros_like(x)
        for c in coeffs:
            p = _fma(p, x, _f32(c))
        return p
    x2 = x * x
    small = x + _fma(_f32(-0.5), x2,
                     (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)))
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log(x + 1.0))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, _f32(lo), _f32(hi)))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape) -> torch.Tensor:
    """``jax.random.truncated_normal`` in f32 on the CPU."""
    sqrt2 = _f32(math.sqrt(2))
    lo, hi = _f32(lower), _f32(upper)
    a, b = torch.erf(lo / sqrt2), torch.erf(hi / sqrt2)
    u = torch.maximum(a, _fma(unit_float(random_bits(key, shape)), b - a, a))
    return torch.clamp(sqrt2 * _erfinv(u),
                       torch.nextafter(lo, _f32(math.inf)),
                       torch.nextafter(hi, _f32(-math.inf)))
