"""The conv Q-network family against the JAX package's.

Inputs are made from seeds with numpy (or drawn by both packages from one
key). On the CPU:

* the im2col matrices (``ops/conv2mat.py``) equal the JAX package's bit
  for bit, for the cases of ``tests/test_fused_tick.py``'s conv tests;
* ``DQN.init_state(key)`` draws the JAX package's initial conv nets bit
  for bit (``Conv_i`` kernels ``lecun_normal`` with fan-in k·k·C_in, in
  flax's HWIO shape), three configurations × three seeds;
* Q-values on both routes (the conv module, and with ``conv_matmul`` the
  im2col chain, row-major and feature-major) within rtol 1e-5, atol 1e-6;
* ``dqn-agent-5.safetensors``, read through the JAX package's reader and
  carried across with ``interop.from_jax``, gives the JAX Q-values;
* ``train_step_t`` on a conv net, with and without ``conv_matmul``: loss
  within rtol 1e-5, params within atol 1e-5 (Adam moments carried both
  ways);
* the engines' refusals: the ring engine without ``conv_matmul``,
  ``in_kernel_td`` with a conv net, and the JAX kernel's 50 MB budget on
  the weight chain.

The trainers with a conv net are held to the JAX trainers in
``tests/test_torch_conv_engines.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu.interop import safetensors_io
from dronerl_tpu.ops import conv2mat as jconv2mat
from dronerl_tpu_torch import replay, rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax
from dronerl_tpu_torch.ops import conv2mat, fused_tick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, BATCH = 128, 8
KW = dict(grid_size=9, n_drones=4)
STRIDED = ({"kernel_size": 3, "out_channels": 8, "padding": 1, "stride": 1},
           {"kernel_size": 3, "out_channels": 4, "padding": 0, "stride": 2})
# tests/test_fused_tick.py::test_conv_matmul_forward_matches_flax's cases.
NETS = {
    "default": dict(conv_dense_layers=()),
    "dense16": dict(conv_dense_layers=(16,)),
    "strided": dict(conv_dense_layers=(), conv_layers=STRIDED),
}


def _agents(net, conv_matmul, wrapper="window", **kw):
    jp = JParams(wrapper=wrapper, **KW)
    tp = EnvParams(wrapper=wrapper, **KW)
    cfg = dict(network_type="conv", conv_matmul=conv_matmul,
               **NETS[net], **kw)
    return (JDQN(JConfig(**cfg), jp),
            DQN(DQNConfig(**cfg), tp, device="cpu"), jp, tp)


def _state(ja, ta, seed):
    """The JAX state from PRNGKey(seed) and its port copy."""
    js = jax.device_get(ja.init_state(jax.random.PRNGKey(seed)))
    return js, from_jax.dqn_state_from_jax(
        js, obs_shape=ta.env_params.obs_shape,
        conv_specs=ta.config.conv_specs())


def _assert_tree_equal(jtree, ttree, tag=""):
    jl, tl = jtree["params"], ttree["params"]
    assert sorted(jl) == sorted(tl), tag
    for name in jl:
        for k in ("kernel", "bias"):
            a, b = np.asarray(jl[name][k]), tl[name][k]
            assert a.shape == b.shape and (a == b).all(), (tag, name, k)


@pytest.mark.parametrize("wrapper", ["window", "global"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_conv_matrices_match_jax(net, wrapper):
    """The im2col chain of one net, bitwise, weights and biases."""
    ja, ta, _, _ = _agents(net, True, wrapper)
    assert ta.net_spec == ja.net_spec
    js, ts = _state(ja, ta, 0)
    jchain = jconv2mat.effective_dense_params(js.params, ja.net_spec)
    tchain = conv2mat.effective_dense_params(ts.params, ta.net_spec)
    assert len(tchain) == 2 * len(jchain)
    for (jw, jb), tw, tb in zip(jchain, tchain[0::2], tchain[1::2]):
        assert tuple(tw.shape) == jw.shape and tw.dtype == torch.float32
        assert (np.asarray(jw) == tw.detach().numpy()).all()
        assert (np.asarray(jb)[:, 0] == tb.detach().numpy()).all()
    assert fused_tick.chain_widths(tchain) == (
        ja.obs_dim, *(w.shape[1] for w, _ in jchain))


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("net", sorted(NETS))
def test_conv_init_state_matches_jax(net, seed):
    """``init_state(key)``: the online net from the key, the target from
    ``split(key)[1]``, bitwise; moments zero."""
    ja, ta, _, _ = _agents(net, False)
    js = jax.device_get(ja.init_state(jax.random.PRNGKey(seed)))
    ts = ta.init_state(rng.PRNGKey(seed))
    _assert_tree_equal(js.params, from_jax.qnet_to_flax(ts.params), seed)
    _assert_tree_equal(js.target_params,
                       from_jax.qnet_to_flax(ts.target_params), seed)
    assert all(not m.any() for m in ts.opt_state.mu + ts.opt_state.nu)


@pytest.mark.parametrize("conv_matmul", [False, True])
@pytest.mark.parametrize("net", sorted(NETS))
def test_conv_q_values_match_jax(net, conv_matmul):
    """``q_values`` (row-major) and ``q_values_t`` (feature-major) on a
    seeded batch, both routes."""
    ja, ta, _, _ = _agents(net, conv_matmul)
    js, ts = _state(ja, ta, 3)
    obs = np.random.default_rng(1).random((32, ja.obs_dim)).astype(
        np.float32)
    with torch.no_grad():
        q = ta.q_values(ts.params, torch.from_numpy(obs)).numpy()
        q_t = ta.q_values_t(ts.params, torch.from_numpy(obs.T.copy()))
    np.testing.assert_allclose(q, np.asarray(ja.q_values(js.params, obs)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        q_t.numpy(), np.asarray(ja.q_values_t(js.params, obs.T)),
        rtol=1e-5, atol=1e-6)


def test_dqn_agent_5_matches_jax():
    """The shipped conv baseline, read by the JAX package's reader, carried
    across: the same Q-values on a seeded batch of observations."""
    path = os.path.join(REPO, "dronerl_tpu/evaluator/baselines/"
                        "dqn-agent-5.safetensors")
    config, params = safetensors_io.load_checkpoint(path)
    assert config.network_type == "conv"
    jp = JParams(**KW)
    ja = JDQN(config, jp)
    tcfg = DQNConfig(network_type="conv", conv_layers=config.conv_specs(),
                     conv_dense_layers=config.conv_dense_layers)
    ta = DQN(tcfg, EnvParams(**KW), device="cpu")
    net = from_jax.qnet_from_flax(jax.device_get(params),
                                  obs_shape=(7, 7, 6),
                                  conv_specs=tcfg.conv_specs())
    assert tuple(net.conv_kernels[0].shape) == (8, 6, 3, 3)
    obs = (np.random.default_rng(5).random((64, 294)) < 0.3).astype(
        np.float32)
    with torch.no_grad():
        q = ta.q_values(net, torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(q, np.asarray(ja.q_values(params, obs)),
                               rtol=1e-5, atol=1e-6)
    _assert_tree_equal(jax.device_get(params), from_jax.qnet_to_flax(net))


@pytest.mark.parametrize("conv_matmul", [False, True])
def test_conv_train_step_matches_jax(conv_matmul):
    """3 TD steps of ``train_step_t`` from one state on seeded batches:
    loss within rtol 1e-5, params and Adam moments within atol 1e-5."""
    ja, ta, _, _ = _agents("dense16", conv_matmul, gamma=0.9)
    js, ts = _state(ja, ta, 2)
    data = np.random.default_rng(3)
    jstate = ja.init_state(jax.random.PRNGKey(2))
    for t in range(3):
        both = (data.random((ja.obs_dim, 2 * BATCH)) < 0.3).astype(
            np.float32)
        batch = {"obs": both[:, :BATCH], "next_obs": both[:, BATCH:],
                 "actions": data.integers(0, 5, BATCH).astype(np.int32),
                 "rewards": data.choice([-1.0, 0.0, 1.0], BATCH).astype(
                     np.float32),
                 "dones": (data.random(BATCH) < 0.2).astype(np.float32)}
        jstate, jloss = ja.train_step_t(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tloss = ta.train_step_t(ts, from_jax.batch_from_jax(batch))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jnow = jax.device_get(jstate)
    ref = from_jax.dqn_state_from_jax(jnow, obs_shape=(7, 7, 6),
                                      conv_specs=ta.config.conv_specs())
    assert ts.opt_state.count == ref.opt_state.count == 3
    for got, want in ((ts.params.flat(), ref.params.flat()),
                      (ts.opt_state.mu, ref.opt_state.mu),
                      (ts.opt_state.nu, ref.opt_state.nu)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=0,
                                       atol=1e-5)


def test_ring_conv_requires_conv_matmul():
    """The ring and full engines run the actor in the tick kernel: a conv
    net needs its im2col chain, as the JAX trainer says."""
    _, ta, _, tp = _agents("default", False)
    with pytest.raises(ValueError, match="conv_matmul"):
        train.build_train_step_ring(ta, tp, E, 4 * E, BATCH, 100)
    with pytest.raises(ValueError, match="conv_matmul"):
        train.build_train_step_full(
            ta, replay.StreamReplay(3 * E, BATCH, stride=E), tp, E, 100)


def test_in_kernel_td_requires_dense():
    _, ta, _, tp = _agents("default", True)
    with pytest.raises(ValueError, match="dense"):
        train.build_train_step_ring(ta, tp, E, 4 * E, BATCH, 100,
                                    in_kernel_td=True)


def test_conv_matmul_budget_guard():
    """The JAX kernel's guard on tests/test_fused_tick.py's case (two
    64-channel convs on the global 24 x 24 board): the chain is refused
    before it is built, with the JAX package's advice; a chain within the
    budget passes, and the kernels' limits name no chain problem for
    it."""
    big = dict(grid_size=24, n_drones=4, wrapper="global")
    cfg = DQNConfig(network_type="conv", conv_matmul=True,
                    conv_dense_layers=(64,), epsilon_decay_every=5,
                    conv_layers=({"kernel_size": 3, "out_channels": 64,
                                  "padding": 1, "stride": 1},) * 2)
    agent = DQN(cfg, EnvParams(**big), device="cpu")
    st = agent.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="budget") as err:
        fused_tick.flatten_net_params(st.params, agent.net_spec)
    assert "without --conv_matmul" in str(err.value)
    widths = (24 * 24 * 6, 24 * 24 * 64, 24 * 24 * 64, 64, 5)
    assert any("budget" in p for p in fused_tick.kernel_problems(
        EnvParams(**big), E, widths))
    _, ta, _, tp = _agents("dense16", True)
    chain = fused_tick.flatten_net_params(
        ta.init_state(rng.PRNGKey(0)).params, ta.net_spec)
    assert fused_tick.kernel_problems(tp, E, fused_tick.chain_widths(
        chain)) == []


def test_cli_conv_flags():
    """``--network_type conv``, ``--conv_layers`` (JSON or a literal),
    ``--conv_dense_layers`` and ``--conv_matmul`` map onto the config as
    the JAX CLI maps them; the engine choice follows the JAX gate: the
    ring or full engine with ``--conv_matmul``, the fused engine without."""
    args = train.parse_args([
        "--device", "cpu", "--network_type", "conv", "--conv_layers",
        "{'kernel_size': 3, 'out_channels': 4, 'padding': 0}",
        "--conv_dense_layers", "16", "8", "--num_envs", "128",
        "--memory_size", "1024"])
    cfg = train.agent_config_from_args(args)
    assert cfg.network_type == "conv" and not cfg.conv_matmul
    assert cfg.conv_specs() == ({"kernel_size": 3, "out_channels": 4,
                                 "padding": 0},)
    assert cfg.conv_dense_layers == (16, 8)
    env = train.env_params_from_args(args)
    assert train.choose_engine(args, env) == "fused"
    args = train.parse_args(["--device", "cpu", "--network_type", "conv",
                             "--conv_matmul", "--num_envs", "128",
                             "--memory_size", "256"])
    assert train.agent_config_from_args(args).conv_specs() == (
        {"kernel_size": 3, "out_channels": 8, "padding": 1, "stride": 1},)
    assert train.choose_engine(args, train.env_params_from_args(args)) == (
        "ring")
    args.memory_size = 1024
    assert train.choose_engine(args, train.env_params_from_args(args)) == (
        "full")


@pytest.mark.parametrize("flags,engine", [
    (["--memory_size", "256", "--conv_matmul"], "ring"),
    (["--memory_size", "1024"], "fused")])
def test_cli_runs_conv_on_cpu(flags, engine):
    metrics = train.main(["--device", "cpu", "--num_envs", "128",
                          "--num_steps", "3", "--network_type", "conv",
                          *flags])
    assert metrics["engine"] == engine
    assert np.isfinite(metrics["td_loss_mean"])
