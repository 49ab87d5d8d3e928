"""The StreamReplay engines with ``--fast_rng``'s round counts against
the JAX trainers: the full engine at ``actor`` (20, 8) with two drones
collected and at ``full`` (8, None), the fused engine (whose kernel takes
``rng_rounds`` only) at ``full`` with two drones, with the contract of
tests/test_torch_collect_stream.py.
"""

import pytest

from tests.test_torch_collect_stream import run_stream_engine


@pytest.mark.parametrize("engine,k,rounds", [
    ("full", 2, (20, 8)), ("full", 1, (8, None)), ("fused", 2, (8, None))],
    ids=["full-actor-collect2", "full-full", "fused-full-collect2"])
def test_stream_engine_fast_rng_matches_jax(engine, k, rounds):
    losses = run_stream_engine(engine, k, rounds)
    assert losses[0] == -1.0 and min(losses[1:]) >= 0
