"""B3's plain version (``full_tick_plain``) at ``--fast_rng``'s round
counts, ``actor`` (20, 8) and ``full`` (8, None), with two drones
collected, against the JAX full kernel in Pallas interpret mode: env
state, rewards, dones and actions bitwise, both row groups of
observations bitwise but the charge channel (1.3e-7).
"""

import pytest

from tests.test_torch_collect import run_full_tick


@pytest.mark.parametrize("rounds", [(20, 8), (8, None)],
                         ids=["actor", "full"])
def test_full_tick_plain_rounds_collect_match_jax(rounds):
    run_full_tick("window", 2, rounds)
