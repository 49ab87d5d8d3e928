"""The work counts behind the roofline shares and tick_mfu, against
counts by hand at 65,536 envs."""

import pytest

from portbench import roofline

E = 65536
NETS = {"dense16": (294, 16, 16, 5), "dense128x64": (294, 128, 64, 5)}


def test_forward_flops_by_hand():
    assert roofline.forward_flops(NETS["dense16"]) == 2 * (
        294 * 16 + 16 * 16 + 16 * 5) == 10080
    assert roofline.forward_flops(NETS["dense128x64"]) == 2 * (
        294 * 128 + 128 * 64 + 64 * 5) == 92288


def test_hash_ops():
    assert roofline.hash_ops(20) == 79
    assert roofline.hash_ops(8) == 34


@pytest.mark.parametrize("net, actor, learner", [
    ("dense16", 660602880, 8 * (6 * 5040 + 2 * 336)),
    ("dense128x64", 6048186368, 8 * (6 * 46144 + 2 * 8512)),
])
def test_tick_model_flops(net, actor, learner):
    assert E * roofline.forward_flops(NETS[net]) == actor
    assert roofline.tick_model_flops(NETS[net], E, 8) == actor + learner


def test_env_bound_by_hand():
    # dense16's B1: 4 drones, 81 cells, a bf16 ring.
    n, c = 4, 81
    state = E * (c + n * 13)
    io = E * n * 9
    obs = 2 * 294 * E * 2
    weights = 4 * (294 * 16 + 16 + 16 * 16 + 16 + 16 * 5 + 5)
    ms, by, total, ops = roofline.tick_kernel_bound(NETS["dense16"], n, c, E,
                                                    2)
    assert total == 2 * state + io + obs + weights + 4
    assert ops == E * 10080 + 79 * (4 + 5 + 162) * E
    assert by == "bytes"
    assert ms == pytest.approx(total / 3.35e12 * 1e3)


def test_wide_net_is_operation_bound():
    ms, by, _, _ = roofline.tick_kernel_bound(NETS["dense128x64"], 4, 81, E,
                                              2)
    assert by == "operations"
    t_actor = (3 * E * 2 * 294 * 128 + 6 * E * 2 * 128 * 64) / 989e12 + (
        E * 2 * 64 * 5) / 67e12
    assert ms == pytest.approx((t_actor + 79 * 171 * E / 67e12) * 1e3)


def test_learner_bound_by_hand():
    widths = NETS["dense16"]
    p = 294 * 16 + 16 * 16 + 16 * 5 + 16 + 16 + 5
    ms, _, total, flops = roofline.learner_bound(widths, 8, 0)
    assert total == 4 * p * 7 + 2 * 294 * 8 * 4 + 3 * 8 * 4 + 4
    assert flops == 8 * (6 * 5040 + 2 * 336) + 13 * p
