"""B3's plain version (``full_tick_plain``) with all 4 drones collected on
the window against the JAX full kernel in Pallas interpret mode: env
state, rewards, dones and actions bitwise, the 4 observation row groups
bitwise but the charge channel (1.3e-7). Its own file: the kernel's
interpret-mode compile takes most of a minute on a CPU.
"""

from tests.test_torch_collect import run_full_tick


def test_full_tick_plain_collect_matches_jax_window4():
    run_full_tick("window", 4)
