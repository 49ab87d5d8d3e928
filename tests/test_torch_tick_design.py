"""The full tick kernel's two mechanisms, checked on the CPU through their
plain mirrors in ``dronerl_tpu_torch/ops/fused_tick.py`` (the kernel,
``csrc/full_tick.cu`` on ``csrc/env_warp.cuh``, runs only on a card):

* the spawn pick as a warp reduction over the packed key ``2**31 | u <<
  8 | (255 - c)`` up to 256 cells and ``u << 9 | (511 - c)`` (with the
  candidates counted) above, with the lowest untaken cell when no
  candidate is left, against ``jax.lax.top_k(where(valid, u, -inf), k)``:
  the same indices, in order, for random 23-bit fields, fields with
  forced ties, boards with fewer candidates than slots, and a candidate
  with u = 0 at the last cell (the wide key's 0), at 25, 81 and 256 cells
  and at 400, 484 and 512;
* the dense layers but the last on the tensor cores from bf16 pieces (W
  in three, the operand too where it is f32: B3's observations, the
  hidden activations) summed in f32: its greedy action
  equals the f32 forward's wherever the best-minus-second gap of the f32
  Q-values exceeds 1e-5 of max |q| (the tolerance ``chip_smoke.py``
  holds the kernel to), and its Q-values are within 5e-6 of max |q| (half
  that gap: no action outside a near tie can flip), for
  both bench nets, on observations of ``core.observe_batch`` and weights
  after a few learner steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops import fused_tick

NEAR_TIE = 1e-5


def _unit_float(u23: np.ndarray) -> np.ndarray:
    """jax.random.uniform's float from its 23 mantissa bits."""
    return (u23.astype(np.uint32) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)


def _fields(case: str, cells: int, seed: int, rows: int = 64):
    r = np.random.default_rng(seed)
    if case == "ties":  # a few distinct values: many equal keys
        u = r.integers(0, 4, (rows, cells)) * (1 << 20)
        valid = r.random((rows, cells)) < 0.7
    elif case == "sparse":  # fewer candidates than slots
        u = r.integers(0, 1 << 23, (rows, cells))
        valid = np.zeros((rows, cells), dtype=bool)
        for i in range(rows):
            valid[i, r.choice(cells, size=int(r.integers(0, 6)),
                              replace=False)] = True
    elif case == "zero_last":  # u = 0 at the last cell, a candidate
        u = r.integers(0, 1 << 23, (rows, cells))
        valid = r.random((rows, cells)) < 0.05
        valid[:rows // 4] = False  # there, the only candidate
        u[:, -1] = 0
        valid[:, -1] = True
    else:
        u = r.integers(0, 1 << 23, (rows, cells))
        valid = r.random((rows, cells)) < 0.5
    return u.astype(np.int64), valid


@pytest.mark.parametrize("cells", [25, 81, 256, 400, 484, 512])
@pytest.mark.parametrize("case", ["random", "ties", "sparse", "zero_last"])
def test_packed_pick_order_matches_top_k(cells, case):
    u, valid = _fields(case, cells, seed=cells + len(case))
    for k in (12, cells):
        _, ref = jax.lax.top_k(
            jnp.where(jnp.asarray(valid), jnp.asarray(_unit_float(u)),
                      -jnp.inf), k)
        got = fused_tick.packed_pick_order(
            torch.from_numpy(u), torch.from_numpy(valid), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _trained_net(hidden, steps=3):
    tp = EnvParams(grid_size=9, n_drones=4)
    agent = DQN(DQNConfig(hidden_layers=hidden, gamma=0.9), tp,
                device="cpu")
    st = agent.init_state(torch.Generator().manual_seed(1))
    r = np.random.default_rng(2)
    for _ in range(steps):
        batch = {
            "obs": torch.from_numpy(
                (r.random((agent.obs_dim, 32)) < 0.3).astype(np.float32)),
            "next_obs": torch.from_numpy(
                (r.random((agent.obs_dim, 32)) < 0.3).astype(np.float32)),
            "actions": torch.from_numpy(r.integers(0, 5, 32)),
            "rewards": torch.from_numpy(
                r.choice([-1.0, 0.0, 1.0], 32).astype(np.float32)),
            "dones": torch.from_numpy(
                (r.random(32) < 0.2).astype(np.float32)),
        }
        st, _ = agent.train_step_t(st, batch)
    return tp, st.params


def _observations(tp, num_envs=2048, ticks=6):
    """core.observe_batch after a few random steps (charges below 100)."""
    state = core.reset_batch(rng.PRNGKey(3), tp, num_envs)
    key = rng.PRNGKey(4)
    g = torch.Generator().manual_seed(5)
    for _ in range(ticks):
        key, step_key = rng.split(key, 2)
        actions = torch.randint(0, 5, (num_envs, tp.n_drones), generator=g,
                                dtype=torch.int32)
        state, _, _ = core.step_batch(rng.split(step_key, num_envs), state,
                                      actions, tp)
    obs = core.observe_batch(state, tp, 1).reshape(num_envs, -1).t()
    return obs.contiguous()


@pytest.mark.parametrize("hidden", [(16, 16), (128, 64)])
@pytest.mark.parametrize("obs_dtype", [torch.bfloat16, torch.float32])
def test_split_forward_argmax_matches_f32(hidden, obs_dtype):
    tp, net = _trained_net(hidden)
    obs = _observations(tp).to(obs_dtype).float()
    charge = obs.reshape(-1, 6, obs.shape[1])[:, 4]
    assert bool(((charge > 0) & (charge < 1)).any())  # inexact in bf16
    with torch.no_grad():
        q_ref = net.forward_t(obs)
        q = fused_tick.split_forward_t(net.flat(), obs,
                                       exact_obs=obs_dtype == torch.bfloat16)
    scale = q_ref.abs().amax(dim=0)
    assert float(((q - q_ref).abs() / scale).max()) <= NEAR_TIE / 2
    top2 = q_ref.topk(2, dim=0).values
    tie = (top2[0] - top2[1]) <= NEAR_TIE * scale
    differ = torch.argmax(q, dim=0) != torch.argmax(q_ref, dim=0)
    assert not bool((differ & ~tie).any())
    assert int(tie.sum()) < obs.shape[1] // 10


def test_split_pieces_reconstruct():
    """Three bf16 pieces hold 24 significant bits: their f32 sum is the
    f32 value within one part in 2**-23, and each piece is a bf16."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        4096).astype(np.float32))
    pieces = fused_tick.bf16_pieces(x)
    for p in pieces:
        assert torch.equal(p, p.to(torch.bfloat16).float())
    rel = ((pieces[0] + pieces[1] + pieces[2]) - x).abs() / x.abs()
    assert float(rel.max()) <= 2.0 ** -23
