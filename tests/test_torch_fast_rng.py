"""``--fast_rng``'s round counts: Threefry-2x32-R and the tick kernels'
plain versions against the JAX package.

``rng.threefry2x32`` (and ``split`` / ``uniform`` over it, on the host's
Python-int path and the tensor path) bitwise against
``dronerl_tpu.ops.step_kernel.threefry2x32`` at every round count the JAX
function takes (4, 8, 12, 16, 20). The plain versions of B1, B3 and B4 at
the round counts of ``--fast_rng actor`` (20, 8) and ``full`` (8, None)
against the JAX kernels in Pallas interpret mode (B3's in
tests/test_torch_fast_rng_full.py): env state, rewards,
dones and actions bitwise, observations bitwise but the charge channel
(1.3e-7). The JAX package has no reduced-round env core, so its kernels
are the only yardstick here. Last, ``rng_rounds_from_args``, the bare
flag and the CLI's two warnings. The engines are in
tests/test_torch_fast_rng_engines.py and
tests/test_torch_fast_rng_stream.py.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.ops import step_kernel as jstep
from dronerl_tpu_torch import rng, train
from tests.test_torch_collect import run_env_tick, run_ring_tick

ROUNDS = [4, 8, 12, 16, 20]


def _jax_words(k1, k2, x0, x1, rounds):
    u = jnp.uint32
    b1, b2 = jstep.threefry2x32(jnp.asarray(k1, u), jnp.asarray(k2, u),
                                jnp.asarray(x0, u), jnp.asarray(x1, u),
                                rounds)
    return np.asarray(b1).astype(np.int64), np.asarray(b2).astype(np.int64)


@pytest.mark.parametrize("rounds", ROUNDS)
def test_threefry_rounds_match_jax(rounds):
    r = np.random.default_rng(rounds)
    k1, k2, x0, x1 = (r.integers(0, 2**32, 4096, dtype=np.uint64).astype(
        np.int64) for _ in range(4))
    j1, j2 = _jax_words(k1, k2, x0, x1, rounds)
    t1, t2 = rng.threefry2x32(*(torch.from_numpy(a) for a in (k1, k2, x0, x1)),
                              rounds=rounds)
    assert (t1.numpy() == j1).all() and (t2.numpy() == j2).all()
    # split and uniform: the counters (0, i), on the host's Python-int
    # path (a (2,) CPU key, few counters) and the tensor path.
    key = torch.tensor([int(k1[0]), int(k2[0])], dtype=torch.int64)
    for n in (2, 9, 300):
        j1, j2 = _jax_words(np.full(n, k1[0]), np.full(n, k2[0]),
                            np.zeros(n, np.int64), np.arange(n), rounds)
        split = rng.split(key, n, rounds)
        assert (split[:, 0].numpy() == j1).all(), n
        assert (split[:, 1].numpy() == j2).all(), n
        u = rng.uniform(key, (n,), rounds)
        bits = ((j1 ^ j2) >> 9 | 0x3F800000).astype(np.uint32)
        assert (u.numpy() == bits.view(np.float32) - 1.0).all(), n


def test_threefry_rounds_checked():
    for bad in (0, 6, 24):
        with pytest.raises(ValueError, match="multiple of 4"):
            rng.threefry2x32(1, 2, 0, 0, rounds=bad)
        with pytest.raises(ValueError, match="multiple of 4"):
            rng.split(rng.PRNGKey(0), 2, bad)
    assert torch.equal(rng.split(rng.PRNGKey(3), 4),
                       rng.split(rng.PRNGKey(3), 4, 20))


@pytest.mark.parametrize("rounds", [(20, 8), (8, None)],
                         ids=["actor", "full"])
def test_ring_tick_plain_rounds_match_jax(rounds):
    run_ring_tick("window", 1, rounds)


def test_env_tick_plain_rounds_match_jax():
    run_env_tick("window", 1, rng_rounds=8)


def test_rng_rounds_from_args():
    """The JAX CLI's mapping: off (20, None), actor (20, 8), full and the
    bare flag (8, None)."""
    for argv, rounds in (([], (20, None)), (["--fast_rng", "off"], (20, None)),
                         (["--fast_rng", "actor"], (20, 8)),
                         (["--fast_rng", "full"], (8, None)),
                         (["--fast_rng"], (8, None))):
        args = train.parse_args(argv)
        assert train.rng_rounds_from_args(args) == rounds, argv
    with pytest.raises(SystemExit):
        train.parse_args(["--fast_rng", "half"])


def test_engine_rng_rounds_warnings(caplog):
    """The jnp engine warns and runs 20 rounds; ``actor`` on the fused
    engine warns that it does nothing; the ring and full engines take the
    mode as it is."""
    full = train.parse_args(["--fast_rng"])
    actor = train.parse_args(["--fast_rng", "actor"])
    with caplog.at_level(logging.WARNING, logger="dronerl_tpu_torch.train"):
        assert train.engine_rng_rounds(full, "jnp") == (20, None)
        assert "only affects the fused engines" in caplog.text
        caplog.clear()
        assert train.engine_rng_rounds(actor, "fused") == (20, 8)
        assert "no-op on the fused engine" in caplog.text
        caplog.clear()
        for engine in ("ring", "full"):
            assert train.engine_rng_rounds(actor, engine) == (20, 8)
            assert train.engine_rng_rounds(full, engine) == (8, None)
        assert train.engine_rng_rounds(full, "fused") == (8, None)
    assert not caplog.text


@pytest.mark.parametrize("argv,engine", [
    (["--num_envs", "64", "--fast_rng"], "jnp"),
    (["--num_envs", "128", "--memory_size", "256", "--fast_rng", "actor"],
     "ring"),
    (["--num_envs", "128", "--memory_size", "1024", "--fast_rng"], "full")])
def test_cli_runs_fast_rng_on_cpu(argv, engine, tmp_path):
    metrics = train.main(["--device", "cpu", "--num_steps", "3",
                          "--skip_final_eval", "--run_dir", str(tmp_path)]
                         + argv)
    assert metrics["engine"] == engine
    assert np.isfinite(metrics["td_loss_mean"])
