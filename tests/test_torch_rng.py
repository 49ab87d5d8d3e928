"""The port's jax.random subset against jax.random, bitwise.

Keys, splits, uniforms, randint draws and raw threefry words of
``dronerl_tpu_torch.rng`` must equal JAX's bit for bit: the port's env
transitions are bit-identical to the JAX package's only if its random
bits are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.ops.step_kernel import threefry2x32 as jax_threefry
from dronerl_tpu_torch import rng


def _key(seed):
    return rng.PRNGKey(seed)


def _np(t):
    return t.numpy().astype(np.int64)


def _jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, -123456])
def test_prng_key(seed):
    assert (_np(_key(seed)) == _jkey(seed)).all()


def test_prng_key_rejects_out_of_range():
    with pytest.raises(ValueError):
        rng.PRNGKey(2**31)


@pytest.mark.parametrize("num", [2, 3, 7, 130])
def test_split(num):
    for seed in (0, 9):
        ours = _np(rng.split(_key(seed), num))
        ref = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
        assert ours.shape == (num, 2)
        assert (ours == ref.astype(np.int64)).all()


@pytest.mark.parametrize("num", [1, 63, 64, 65])
def test_host_and_tensor_paths_agree(num):
    """A lone host key hashes few counters on Python ints; a stack of
    keys always on tensors: both give the same words."""
    key = _key(77)
    host = rng.split(key, num)
    stacked = rng.split(key[None], num)[0]
    assert torch.equal(host, stacked)
    assert torch.equal(rng.random_bits(key, (num,)),
                       rng.random_bits(key[None], (num,))[0])


def test_split_batched_keys():
    """A stack of keys splits row by row (the env axis of core.step)."""
    keys = rng.split(_key(5), 6)
    ours = _np(rng.split(keys, 2))
    jkeys = jax.random.split(jax.random.PRNGKey(5), 6)
    ref = np.stack([np.asarray(jax.random.split(k, 2)) for k in jkeys])
    assert (ours == ref.astype(np.int64)).all()


@pytest.mark.parametrize("shape", [(81,), (5, 128), (1,)])
def test_uniform(shape):
    for seed in (0, 3):
        ours = rng.uniform(_key(seed), shape).numpy()
        ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
        assert ours.dtype == np.float32
        assert (ours.view(np.uint32) == ref.view(np.uint32)).all()


@pytest.mark.parametrize("minval,maxval", [
    (0, 1), (0, 5), (0, 128), (0, 1000), (0, 65536), (0, 2**31 - 1),
    (-7, 9), (3, 3), (5, 2)])
def test_randint(minval, maxval):
    for seed in (0, 11):
        ours = rng.randint(_key(seed), (8,), minval, maxval).numpy()
        ref = np.asarray(jax.random.randint(
            jax.random.PRNGKey(seed), (8,), minval, maxval))
        assert ours.dtype == np.int32
        assert (ours == ref).all()


def test_randint_traced_bound_matches():
    """The ring sampler's bound is a traced jnp value in the JAX trainer."""
    key = jax.random.PRNGKey(4)
    valid = jnp.maximum(jnp.int32(384), 1)
    ref = np.asarray(jax.random.randint(key, (8,), 0, valid))
    assert (rng.randint(_key(4), (8,), 0, 384).numpy() == ref).all()


def test_threefry_words():
    """Raw threefry2x32 words on random uint32 inputs against the JAX
    package's in-kernel threefry."""
    r = np.random.default_rng(0)
    k1, k2, x0, x1 = (r.integers(0, 2**32, 257, dtype=np.uint64)
                      .astype(np.uint32) for _ in range(4))
    ref0, ref1 = jax_threefry(*(jnp.asarray(v) for v in (k1, k2, x0, x1)))
    ours0, ours1 = rng.threefry2x32(*(torch.from_numpy(v.astype(np.int64))
                                      for v in (k1, k2, x0, x1)))
    assert (ours0.numpy() == np.asarray(ref0).astype(np.int64)).all()
    assert (ours1.numpy() == np.asarray(ref1).astype(np.int64)).all()


def test_bits_to_unit_float_range():
    bits = torch.tensor([0, 1, 2**31, 2**32 - 1], dtype=torch.int64)
    u = rng.bits_to_unit_float(bits)
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
