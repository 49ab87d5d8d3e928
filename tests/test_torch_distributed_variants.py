"""The sharded engines' other branches against JAX's
``DistributedTrainer`` (interpret mode), 2 ranks × 128 envs, 8 ticks with
a reset every 5, held as ``test_torch_distributed_kernels.py`` holds the
default ones: a conv net's im2col chain (``conv_matmul``) in B1 on the
ring engine and in B3 on the fused engine, two drones collected a column
(k = 2) on the ring engine, and ``--fast_rng actor`` (the in-kernel
actor's uniforms at 8 rounds) on the ring engine.
"""

import pytest

import tests.test_torch_distributed_kernels as kernels

TICKS = 8
CONV_MATMUL = dict(kernels.CONV, conv_matmul=True)


@pytest.mark.parametrize("engine,local", [("ring", "ring"),
                                          ("fused", "full")])
def test_conv_matmul_engines_match_jax(engine, local):
    results = kernels.check(kernels.kernel_spec(engine, CONV_MATMUL,
                                                ticks=TICKS))
    assert results[0]["local_engine"] == local


def test_ring_engine_two_drones_a_column_matches_jax():
    trainer = dict(kernels.TRAINER, buffer_capacity_per_shard=2 * 2 * 128,
                   collect_drones=2)
    results = kernels.check(kernels.kernel_spec(
        "ring", kernels.DENSE, ticks=TICKS, trainer=trainer))
    ring, scalar_rings = results[0]["init"][1][1], results[0]["init"][2]
    assert ring.shape == (2 * 294, 2 * 128)
    assert scalar_rings[0].shape == (2, 2 * 128)


def test_ring_engine_fast_rng_actor_matches_jax():
    trainer = dict(kernels.TRAINER, actor_rng_rounds=8)
    kernels.check(kernels.kernel_spec("ring", kernels.DENSE, ticks=TICKS,
                                      trainer=trainer))
