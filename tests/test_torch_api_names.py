"""The JAX package's API names that the port lacked, each against its
JAX definition: ``DQN.act_t(greedy=)``, ``EnvState.n_drones`` /
``.grid_size`` and ``env.types.empty_state``, ``ops.pointops.cell_mask``;
and the port's own names for three more: ``DQN.train_step(group=)`` for
``train_step_distributed``, ``ops.fused_tick.kernel_problems`` for
``supports`` and ``train.fused_engine_problems`` for
``fused_engine_supported``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu import train as jtrain
from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.env import types as jtypes
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu.ops import fused_tick as jfused
from dronerl_tpu.ops import pointops as jpointops
from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.agents import dqn as tdqn
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env import types as ttypes
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax
from dronerl_tpu_torch.ops import fused_tick, pointops
from dronerl_tpu_torch.parallel.mesh import make_env_mesh
from tests.test_torch_collect import env_params

AGENT = dict(hidden_layers=(16, 16), epsilon_decay_every=2,
             target_update_interval=2, gamma=0.9)


def jax_and_port_agents(**overrides):
    kw = dict(AGENT, **overrides)
    jp, tp = env_params()
    ja, ta = JDQN(JConfig(**kw), jp), DQN(DQNConfig(**kw), tp, device="cpu")
    jstate = ja.init_state(jax.random.PRNGKey(3))
    tstate = from_jax.dqn_state_from_jax(jax.device_get(jstate))
    return ja, jstate, ta, tstate


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "eps"])
def test_act_t_matches_jax(greedy):
    ja, jstate, ta, tstate = jax_and_port_agents(epsilon_start=0.5)
    obs_t = np.random.default_rng(0).standard_normal(
        (ta.obs_dim, 64)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = ja.act_t(key, jnp.asarray(obs_t), jstate, greedy=greedy)
    got = ta.act_t(rng.PRNGKey(11), torch.from_numpy(obs_t), tstate,
                   greedy=greedy)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_step_with_group_at_world_size_one():
    """At one rank the all-reduced step (the JAX package's
    ``train_step_distributed``) is ``train_step_t`` on the same batch
    (row-major here, feature-major there), with one all-reduce."""
    _, _, ta, first = jax_and_port_agents()
    _, _, _, second = jax_and_port_agents()
    g = np.random.default_rng(1)
    b = 8
    batch = {
        "obs": torch.from_numpy(g.random((b, ta.obs_dim), np.float32)),
        "next_obs": torch.from_numpy(g.random((b, ta.obs_dim), np.float32)),
        "actions": torch.from_numpy(g.integers(0, 5, b).astype(np.int32)),
        "rewards": torch.from_numpy(g.standard_normal(b).astype(np.float32)),
        "dones": torch.from_numpy((g.random(b) < 0.3).astype(np.float32)),
    }
    batch_t = dict(batch, obs=batch["obs"].t().contiguous(),
                   next_obs=batch["next_obs"].t().contiguous())
    mesh = make_env_mesh(1, "cpu")
    try:
        calls = tdqn.all_reduce_mean.calls
        first, loss = ta.train_step(first, batch, mesh.group)
        assert tdqn.all_reduce_mean.calls == calls + 1
    finally:
        torch.distributed.destroy_process_group()
    second, want = ta.train_step_t(second, batch_t)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    for p, q in zip(first.params.flat(), second.params.flat()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=1e-7)


def test_empty_state_and_state_properties():
    for kw in (dict(grid_size=9, n_drones=4), dict(grid_size=20, n_drones=7)):
        want = jtypes.empty_state(JParams(**kw))
        got = ttypes.empty_state(EnvParams(**kw))
        for name in ("ground", "air_x", "air_y", "carrying_package",
                     "charge"):
            j, t = np.asarray(getattr(want, name)), getattr(got, name)
            assert tuple(t.shape) == j.shape, name
            assert t.numpy().dtype == j.dtype, name
            assert not t.any(), name
        assert got.n_drones == want.n_drones == kw["n_drones"]
        assert got.grid_size == want.grid_size == kw["grid_size"]
        batched = core.reset_batch(rng.PRNGKey(0), EnvParams(**kw), 3)
        assert batched.n_drones == kw["n_drones"]
        assert batched.grid_size == kw["grid_size"]


# The JAX gate's cases: its kernels' limits and 128-lane blocks.
GATE_CASES = [
    (dict(grid_size=9, n_drones=4), 128),
    (dict(grid_size=9, n_drones=4), 65536),
    (dict(grid_size=9, n_drones=4), 64),
    (dict(grid_size=9, n_drones=4), 200),
    (dict(grid_size=9, n_drones=4, wrapper="global"), 256),
    (dict(grid_size=16, n_drones=25), 128),
    (dict(grid_size=17, n_drones=4), 128),
    (dict(grid_size=30, n_drones=40), 256),
    (dict(grid_size=9, n_drones=4, packets_factor=0), 128),
]


@pytest.mark.parametrize("kw,num_envs", GATE_CASES)
def test_kernel_and_engine_gates_match_jax(kw, num_envs):
    """``kernel_problems`` is JAX's ``supports`` without its 128-lane
    gate, which is the TPU's alone (the CUDA kernels take any count);
    ``fused_engine_problems`` keeps that gate, as the JAX CLI does, and
    is empty where JAX's is but for its backend reason (this host has no
    TPU)."""
    jp, tp = JParams(**kw), EnvParams(**kw)
    assert (not fused_tick.kernel_problems(tp, num_envs)
            and num_envs >= 128) == jfused.supports(jp, num_envs)
    jproblems = [p for p in jtrain.fused_engine_problems(jp, num_envs)
                 if not p.startswith("backend")]
    assert (not train.fused_engine_problems(tp, num_envs)) == (
        not jproblems)


def test_cell_mask_matches_jax():
    g = np.random.default_rng(2)
    for h, w, n in ((9, 9, 4), (5, 7, 12), (20, 20, 40)):
        rows = g.integers(-3, h + 3, (16, n)).astype(np.int32)
        cols = g.integers(-3, w + 3, (16, n)).astype(np.int32)
        want = jax.vmap(lambda r, c: jpointops.cell_mask(r, c, h, w))(
            jnp.asarray(rows), jnp.asarray(cols))
        got = pointops.cell_mask(torch.from_numpy(rows),
                                 torch.from_numpy(cols), h, w)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
