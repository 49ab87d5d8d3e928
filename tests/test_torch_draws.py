"""The draws of ``dronerl_tpu_torch.rng`` and the ring's replay sample on
the CPU, where they run their plain versions (the card runs
``csrc/draws.cu``: ``tests/test_torch_kernel.py``'s ``gpu`` tests).

A CPU key never reaches the draw kernel's build; its words equal
``jax.random``'s (20 rounds) or the JAX package's reduced-round
``threefry2x32``; ``randint_plain`` holds to ``jax.random.randint`` at the
kernel's edge cases; the ring sample's plain version gives the same batch
from host offsets as from the key they were drawn from.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.ops.step_kernel import threefry2x32 as jax_threefry
from dronerl_tpu_torch import rng
from dronerl_tpu_torch.ops import _build, draws, fused_tick


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _words(t):
    return t.numpy().astype(np.int64)


@pytest.fixture
def no_build(monkeypatch):
    """Any load or build of a kernel library raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU draw reached the kernel build")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("case", ["split", "bits", "uniform", "randint",
                                  "randint_tensor_bound"])
def test_cpu_draws_match_jax_without_the_kernel(case, no_build):
    """Each public draw of a CPU key, host path (few counters) and tensor
    path (many) alike, equals jax.random at 20 rounds, and never loads a
    kernel library."""
    for seed, n in ((3, 5), (11, 300)):
        key, jk = rng.PRNGKey(seed), _jkey(seed)
        if case == "split":
            got, want = rng.split(key, n), jax.random.split(jk, n)
        elif case == "bits":
            got, want = rng.random_bits(key, (n,)), jax.random.bits(jk, (n,))
        elif case == "uniform":
            got = rng.uniform(key, (n,)).view(torch.int32)
            want = np.asarray(jax.random.uniform(jk, (n,))).view(np.int32)
        else:
            bound = 1000 if case == "randint" else torch.tensor(1000)
            got = rng.randint(key, (n,), -3, bound)
            want = jax.random.randint(jk, (n,), -3, 1000)
        assert (_words(got) == np.asarray(want).astype(np.int64)).all()


@pytest.mark.parametrize("rounds", [4, 8, 12, 16])
def test_cpu_draws_reduced_rounds_match_threefry(rounds, no_build):
    """split, bits, uniform and randint of a CPU key at a reduced round
    count: the JAX package's threefry2x32 at ``rounds`` over counters
    (0, i), randint on the split children's bits by jax's arithmetic."""
    n, span = 70, 7
    key = rng.PRNGKey(rounds)
    k1, k2 = (jnp.uint32(w) for w in key.tolist())
    count = jnp.arange(n, dtype=jnp.uint32)
    zeros = jnp.zeros(n, dtype=jnp.uint32)
    w1, w2 = (np.asarray(w).astype(np.int64)
              for w in jax_threefry(k1, k2, zeros, count, rounds))
    assert (_words(rng.split(key, n, rounds)) == np.stack([w1, w2], -1)).all()
    assert (_words(rng.random_bits(key, (n,), rounds)) == w1 ^ w2).all()
    unit = ((((w1 ^ w2) >> 9) | 0x3F800000).astype(np.uint32)
            .view(np.float32) - np.float32(1.0))
    assert (rng.uniform(key, (n,), rounds).numpy().view(np.uint32)
            == unit.view(np.uint32)).all()
    halves = []
    for c in range(2):
        c1, c2 = jax_threefry(k1, k2, jnp.uint32(0), jnp.uint32(c), rounds)
        b1, b2 = jax_threefry(c1, c2, zeros, count, rounds)
        halves.append(np.asarray(b1 ^ b2).astype(np.uint64))
    mult = (65536 % span) ** 2 % span
    want = ((halves[0] % span) * mult + halves[1] % span) % span
    assert (_words(rng.randint(key, (n,), 0, span, rounds)) == want).all()


@pytest.mark.parametrize("case", [
    "bound_below_minval", "bound_at_minval", "span_2_31_minus_1",
    "tensor_bound", "tensor_bound_below_minval", "counters_65537",
    "batched_keys"])
def test_randint_plain_edges_match_jax(case):
    """``randint_plain`` where the kernel's arithmetic has its edges."""
    key, jk = rng.PRNGKey(21), _jkey(21)
    shape, lo, hi, bound = (9,), 0, 10, None
    if case == "bound_below_minval":
        lo, hi = 5, -4
    elif case == "bound_at_minval":
        lo, hi = 7, 7
    elif case == "span_2_31_minus_1":
        lo, hi = -(2 ** 31) + 1, 0
    elif case == "tensor_bound":
        lo, hi, bound = 2, 1234, torch.tensor(1234, dtype=torch.int32)
    elif case == "tensor_bound_below_minval":
        lo, hi, bound = 3, 1, torch.tensor(1)
    elif case == "counters_65537":
        shape, hi = (65537,), 100_003
    if case == "batched_keys":
        keys = rng.split(key, 5)
        got = rng.randint_plain(keys, (3, 4), -8, 99)
        want = jax.vmap(lambda k: jax.random.randint(k, (3, 4), -8, 99))(
            jax.random.split(jk, 5))
    else:
        got = rng.randint_plain(key, shape, lo, hi if bound is None
                                else bound)
        want = jax.random.randint(jk, shape, lo, hi)
    assert got.dtype == torch.int32
    assert got.shape == want.shape
    assert (got.numpy() == np.asarray(want)).all()


@pytest.mark.parametrize("k", [1, 4])
def test_ring_sample_plain_offsets_equal_the_keyed_draw(k):
    """The ring sample's plain version from host offsets (what the kernel
    reads in place of the key on an eager tick) equals the keyed path,
    with a base slot that wraps the ring."""
    obs_dim, num_envs, nb, batch = 6, 16, 4, 8
    capacity = nb * num_envs
    gen = torch.Generator().manual_seed(k)
    ring = torch.randn((k * obs_dim, capacity), generator=gen).to(
        torch.bfloat16)
    shape = (capacity,) if k == 1 else (k, capacity)
    a_ring = torch.randint(0, 5, shape, generator=gen, dtype=torch.int32)
    r_ring = torch.randn(shape, generator=gen)
    d_ring = torch.randint(0, 2, shape, generator=gen, dtype=torch.int8)
    key = rng.PRNGKey(40 + k)
    valid, base_step = (nb - 1) * num_envs, 7  # slot 3: wraps to 0
    common = dict(num_envs=num_envs, capacity=capacity, batch_size=batch,
                  collect=k, obs_dim=obs_dim)
    keyed = fused_tick.ring_gather_batch_plain(
        key, ring, a_ring, r_ring, d_ring, valid, base_step, **common)
    offsets = rng.randint(key, (batch,), 0, valid)
    hosted = fused_tick.ring_gather_batch_plain(
        None, ring, a_ring, r_ring, d_ring, valid, base_step,
        offsets=offsets, **common)
    routed = fused_tick.ring_gather_batch(
        key, ring, a_ring, r_ring, d_ring, valid, base_step, **common)
    for name in keyed:
        assert torch.equal(keyed[name], hosted[name]), name
        assert torch.equal(keyed[name], routed[name]), name
    # The wrap: some sampled column lies past the ring's end from slot 3.
    phys = (3 * num_envs + offsets.long()) % capacity
    assert bool((phys < 3 * num_envs).any())
    drone = torch.arange(batch) // (batch // k)
    col = torch.stack([ring[drone[c] * obs_dim:(drone[c] + 1) * obs_dim,
                            phys[c]] for c in range(batch)], 1)
    assert torch.equal(keyed["obs"], col.float())


def test_build_lists_the_draw_source(monkeypatch):
    """The draw source's library: in the sources digest, both entry
    points bound, no -D, built for sm_90a without --use_fast_math."""
    assert _build.DRAW_SOURCE == "draws.cu"
    assert _build.DRAW_SOURCE in _build.SOURCES
    launches, error = _build.ENTRY_POINTS[_build.DRAW_SOURCE]
    assert launches == ("draw_launch", "ring_sample_launch")
    assert error == "draws_error_string"
    config = _build.draw_config()
    assert config == ("draws.cu", ())
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.build_command(config, "out.so")
    assert "-gencode=arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert not any(c.startswith("-D") for c in cmd)
    assert cmd[-1].endswith("csrc/draws.cu")
    src = open(cmd[-1]).read()
    for entry in launches + (error,):
        assert f" {entry}(" in src
    assert "replaces no Pallas kernel" in src


def test_plain_draws_scope():
    """``plain_draws`` holds for its block or decorated call alone, in
    this thread, and is restored after an error; a CPU key's words are
    the same inside and out."""
    key = rng.PRNGKey(4)
    seen = []

    @rng.plain_draws()
    def inside():
        seen.append(rng._PLAIN.on)
        return rng.split(key, 3)

    assert not getattr(rng._PLAIN, "on", False)
    assert torch.equal(inside(), rng.split(key, 3)) and seen == [True]
    with pytest.raises(ValueError):
        with rng.plain_draws():
            with rng.plain_draws():
                pass
            assert rng._PLAIN.on
            raise ValueError
    assert not rng._PLAIN.on


def test_draw_args_mirror_the_source():
    """The argument blocks' sizes and offsets match csrc/draws.cu's
    structs on this ABI (pointers and int64 8 bytes, int32 4)."""
    assert ctypes.sizeof(draws._DrawArgs) == 3 * 8 + 3 * 8 + 5 * 4 + 4
    assert draws._DrawArgs.num_keys.offset == 24
    assert draws._DrawArgs.span.offset == 64
    # The ring's fields, then the replays' modes': two words' pointers,
    # next_rows, rows_in and rows_out.
    assert ctypes.sizeof(draws._RingSampleArgs) == (
        10 * 8 + 5 * 8 + 5 * 4 + 4 + 3 * 8 + 2 * 4)
    assert draws._RingSampleArgs.ring_ld.offset == 80
    assert draws._RingSampleArgs.ring_bf16.offset == 136
    assert draws._RingSampleArgs.bound.offset == 144
    assert draws._RingSampleArgs.rows_in.offset == 168


@pytest.mark.parametrize("bad", ["cpu_key", "int32_key", "wide_key"])
def test_draw_wrapper_refuses(bad):
    """The draw wrapper takes a CUDA int64 (..., 2) key only; it raises
    before any build."""
    key = {"cpu_key": rng.PRNGKey(0),
           "int32_key": torch.zeros(2, dtype=torch.int32),
           "wide_key": torch.zeros(3, dtype=torch.int64)}[bad]
    with pytest.raises(ValueError):
        draws.draw(key, 4, "bits")
