"""The ring engine with ``--fast_rng``'s round counts against the JAX
trainer: ``actor`` (20, 8) with one drone collected, ``full`` (8, None)
with two, and ``full`` on the ``in_kernel_td`` path, 4 ticks each with
the contract of tests/test_torch_collect_engines.py (env, rings and
scalars bitwise, the charge channel within 1.3e-7, loss rtol 1e-5,
params atol 1e-5).
"""

import pytest

from tests.test_torch_collect_engines import run_ring_engine


@pytest.mark.parametrize("k,rounds,in_kernel_td", [
    (1, (20, 8), False), (2, (8, None), False), (1, (8, None), True)],
    ids=["actor", "full-collect2", "full-in_kernel_td"])
def test_ring_engine_fast_rng_matches_jax(k, rounds, in_kernel_td):
    losses = run_ring_engine(k, rounds, in_kernel_td)
    assert min(losses[1:]) >= 0
