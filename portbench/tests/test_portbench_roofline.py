"""The work counts behind the roofline shares and tick_mfu, against
counts by hand at 65,536 envs; and the dense cells' shares as the widths
arithmetic that came before the layer table read them."""

import json
import types

import pytest

from portbench import roofline, run, trace

E = 65536
NETS = {"dense16": roofline.dense_net((294, 16, 16, 5)),
        "dense128x64": roofline.dense_net((294, 128, 64, 5))}
AGENT5 = [{"kernel_size": 3, "out_channels": 8, "padding": 1, "stride": 1}]


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


def test_dqn_agent_5_by_hand():
    # 7 output rows, of which the first and last see 2 of the 3 taps: 19
    # in-bounds (row, tap) pairs an axis, 361 (position, tap) pairs.
    net = roofline.conv_net((7, 7, 6), AGENT5, (16,))
    assert roofline.in_bounds_taps(7, 3, 1, 1) == 19
    assert roofline.layer_products(net) == [361 * 6 * 8, 392 * 16, 16 * 5] \
        == [17328, 6272, 80]
    assert [x.weights for x in net.layers] == [3 * 3 * 6 * 8 + 8, 6288, 85]
    assert [(x.reads_obs, x.output) for x in net.layers] == [
        (True, False), (False, False), (False, True)]
    assert net.obs_dim == 294
    assert roofline.forward_flops(net) == 2 * (17328 + 6272 + 80) == 47360
    assert roofline.tick_model_flops(net, E, 8) == (
        E * 47360 + 8 * (6 * 23680 + 2 * (6272 + 80))) == 3105023232


def test_dqn_agent_5_b1_bound():
    net = roofline.conv_net((7, 7, 6), AGENT5, (16,))
    ms, by, total, ops = roofline.tick_kernel_bound(net, 4, 81, E, 2)
    assert by == "bytes" and ms == pytest.approx(0.028922, rel=1e-4)
    assert ops == E * 47360 + 79 * (4 + 5 + 162) * E
    t_actor = (3 * E * 2 * 17328 + 6 * E * 2 * 6272) / 989e12 + (
        E * 2 * 80) / 67e12
    assert roofline.actor_seconds(net, "bf16", E) == pytest.approx(t_actor)
    t_ops = (t_actor + 79 * 171 * E / 67e12) * 1e3
    assert t_ops == pytest.approx(0.02525, rel=1e-3) and t_ops < ms


def test_strided_conv_by_hand():
    # 3x3, stride 2, padding 1 on 7x7: outputs 0..3 read rows 2o-1..2o+1,
    # output 0 loses row -1 and output 3 row 7: 2 + 3 + 3 + 2 = 10 pairs
    # an axis. Then 2x2, stride 2, no padding, on the 4x4 map: every tap
    # in bounds, 4 pairs an axis.
    specs = [{"kernel_size": 3, "out_channels": 4, "padding": 1,
              "stride": 2},
             {"kernel_size": 2, "out_channels": 8, "stride": 2}]
    net = roofline.conv_net((7, 7, 6), specs, ())
    assert roofline.in_bounds_taps(7, 3, 2, 1) == 10
    assert roofline.in_bounds_taps(4, 2, 2, 0) == 4
    assert roofline.layer_products(net) == [
        100 * 6 * 4, 16 * 4 * 8, 2 * 2 * 8 * 5]
    assert [x.weights for x in net.layers] == [9 * 6 * 4 + 4,
                                               4 * 4 * 8 + 8, 32 * 5 + 5]
    assert [(x.reads_obs, x.output) for x in net.layers] == [
        (True, False), (False, False), (False, True)]


def test_global_view_conv_from_flags():
    # The global wrapper's board is the view: 9x9x6, padding 1 keeps 9x9;
    # 25 in-bounds pairs an axis (7 rows see 3 taps, 2 see 2).
    flags = {"network_type": "conv", "wrapper": "global", "grid_size": 9,
             "window_radius": 3, "conv_layers": json.dumps(AGENT5),
             "conv_dense_layers": [16]}
    net = roofline.net_of(flags)
    assert net.obs_dim == 486
    assert roofline.layer_products(net) == [625 * 48, 648 * 16, 80]
    assert roofline.net_of({**flags, "wrapper": "window"}) == \
        roofline.conv_net((7, 7, 6), AGENT5, (16,))


def test_conv_without_dense_layers_reads_its_obs_once():
    net = roofline.net_of({"network_type": "conv", "window_radius": 3,
                           "grid_size": 9,
                           "conv_layers": json.dumps(AGENT5[0])})
    assert [(x.products, x.reads_obs, x.output) for x in net.layers] == [
        (17328, True, False), (392 * 5, False, True)]


def test_dense_table_from_flags():
    flags = {"network_type": "dense", "window_radius": 3, "grid_size": 9,
             "hidden_layers": [16, 16]}
    assert roofline.net_of(flags) == NETS["dense16"]
    assert roofline.layer_products(NETS["dense16"]) == [294 * 16, 256, 80]
    one = roofline.dense_net((294, 5)).layers
    assert one == (roofline.Layer(1470, 1475, True, True),)


# The widths arithmetic the readers used before the layer table, frozen.
def _products(widths):
    return [i * o for i, o in zip(widths, widths[1:])]


def _forward_flops(widths):
    return 2 * sum(_products(widths))


def _actor_seconds(widths, scheme, num_envs):
    flops = [num_envs * 2 * p for p in _products(widths)]
    t = roofline.FIRST_LAYER_PRODUCTS[scheme] * flops[0] / roofline.PEAK_BF16
    if len(flops) > 1:
        t += roofline.HIDDEN_PRODUCTS * sum(flops[1:-1]) / roofline.PEAK_BF16
        t += flops[-1] / roofline.PEAK_F32
    return t


def _tick_kernel_bound(widths, n, c, num_envs, obs_itemsize):
    scheme = "bf16" if obs_itemsize == 2 else "f32"
    weight_bytes = 4 * sum(p + o for p, o in zip(_products(widths),
                                                  widths[1:]))
    obs_bytes = 2 * widths[0] * num_envs * obs_itemsize
    return roofline.env_bound(
        n, c, obs_bytes, weight_bytes + 4,
        num_envs * _forward_flops(widths), 4 + (n + 1) + 2 * c,
        _actor_seconds(widths, scheme, num_envs), num_envs)


def _tick_model_flops(widths, num_envs, batch):
    io = _products(widths)
    return (num_envs * _forward_flops(widths)
            + batch * (2 * sum(io) * 3 + 2 * sum(io[1:])))


DENSE_CELLS = [w["name"] for w in json.load(open(
    f"{run.ROOT}/BENCHMARK.json"))["workloads"]
    if w["config"].startswith("dense")]


@pytest.mark.parametrize("widths", [(294, 16, 16, 5), (294, 128, 64, 5),
                                    (294, 5), (486, 64, 5)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_dense_table_gives_the_widths_numbers_bit_for_bit(widths, itemsize):
    net = roofline.dense_net(widths)
    assert roofline.tick_kernel_bound(net, 4, 81, E, itemsize) == \
        _tick_kernel_bound(widths, 4, 81, E, itemsize)
    assert roofline.tick_model_flops(net, E, 8) == \
        _tick_model_flops(widths, E, 8)


@pytest.mark.parametrize("workload", DENSE_CELLS)
def test_dense_cells_read_as_before(workload):
    """``tick_mfu``, ``b1_roofline`` and ``b3_roofline`` of a dense cell on
    one traced context equal the widths arithmetic's readings exactly."""
    from portbench.metrics import b1_roofline, b3_roofline, tick_mfu

    cell = run.load_cell(workload)
    flags = cell.flags
    engine = cell.traffic["engine"]
    ticks = 500
    dev = [trace.Op("void dronerl::full_tick_kernel<float>", 0.0, 104150.0),
           trace.Op("td_adam_kernel", 104150.0, 120000.0)]
    ctx = types.SimpleNamespace(
        engine=engine, num_envs=flags["num_envs"],
        batch=flags["batch_size"], net=roofline.net_of(flags),
        n_drones=flags["n_drones"], cells=flags["grid_size"] ** 2,
        ticks=ticks, dev=dev, window_s=0.15, host_ms_per_tick=0.07,
        wall_ms_per_tick=0.3412)
    widths = (294, *flags["hidden_layers"], 5)
    ms = 104150.0 / 1e6 / ticks * 1e3
    itemsize = 2 if engine == "ring" else 4
    share = (_tick_kernel_bound(widths, 4, 81, flags["num_envs"],
                                itemsize)[0] / ms * 100)
    reader = b1_roofline if engine == "ring" else b3_roofline
    other = b3_roofline if engine == "ring" else b1_roofline
    assert reader.read(ctx) == share
    assert other.read(ctx) is None
    assert tick_mfu.read(ctx) == (
        _tick_model_flops(widths, flags["num_envs"], flags["batch_size"])
        / (0.3412 / 1e3 * roofline.PEAK_BF16) * 100)
