"""The CUDA tick kernel's wrapper, build and launches.

No JAX here: the ``gpu`` tests run on a machine with a card, where the
JAX package is not installed, by

    python -m pytest tests/test_torch_kernel.py -q --noconftest

(``--noconftest`` skips tests/conftest.py, which imports JAX). Without a
card they skip. The host-side tests check what the wrapper hands the
kernel: the argument block, the inputs it refuses and the build's
``-D`` set.
"""

import ctypes

import numpy as np
import pytest
import torch

from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops import _build, fused_tick

E = 128
CHARGE_ATOL = 1.3e-7
KW = dict(grid_size=9, n_drones=4)


def _kernel_inputs(hidden=(16, 16), dtype=torch.float32):
    tp = EnvParams(**KW)
    ta = DQN(DQNConfig(hidden_layers=hidden), tp, device="cpu")
    st = ta.init_state(torch.Generator().manual_seed(0))
    ts = fused_tick.to_tstate(core.reset_batch(rng.PRNGKey(0), tp, E))
    ring = torch.zeros((294, 2 * E), dtype=dtype)
    return [rng.PRNGKey(9), ts, ring, 0, E, st.params, st.epsilon, True, tp]


def test_kernel_args_block():
    """The launch's argument block, filled on host tensors (the kernel
    itself needs a card): pointers, slots, key words and env scalars."""
    args = _kernel_inputs(dtype=torch.bfloat16)
    block, (out, rewards, dones, actions) = fused_tick._kernel_args(*args)
    key, ts, ring, read, write, net, eps, do_reset, tp = args
    assert block.ring == ring.data_ptr() and block.ring_bf16 == 1
    assert block.ground_in == ts.ground.data_ptr()
    assert block.charge_out == out.charge.data_ptr()
    assert block.eps == eps.data_ptr()
    assert (block.ring_ld, block.read_col, block.write_col) == (2 * E, 0, E)
    assert (block.num_envs, block.do_reset) == (E, 1)
    assert [block.key0, block.key1] == key.tolist()
    assert [block.w[i] for i in range(3)] == [
        w.data_ptr() for w in net.kernels]
    assert block.w[3] is None
    assert block.crash_reward == tp.crash_reward
    assert ctypes.c_float(tp.charge_reward).value == block.charge_reward
    assert dones.dtype == torch.bool and actions.dtype == torch.int32
    assert tuple(rewards.shape) == (tp.n_drones, E)


@pytest.mark.parametrize("case", [
    "dtype", "contiguous", "overlap", "ring_dtype", "slot", "wrapper",
    "widths", "host_key"])
def test_kernel_args_reject(case):
    args = _kernel_inputs()
    if case == "dtype":
        args[1] = args[1]._replace(air_x=args[1].air_x.long())
    elif case == "contiguous":
        args[1] = args[1]._replace(
            charge=args[1].charge.t().contiguous().t())
    elif case == "overlap":
        args[4] = E // 2
    elif case == "ring_dtype":
        args[2] = args[2].half()
    elif case == "slot":
        args[4] = 2 * E
    elif case == "wrapper":
        args[8] = EnvParams(wrapper="global", **KW)
    elif case == "widths":
        args[5] = DQN(DQNConfig(hidden_layers=(16,) * 8), args[8],
                      device="cpu").make_net()
    elif case == "host_key":
        args[0] = args[0][None]
    with pytest.raises(ValueError):
        fused_tick._kernel_args(*args)


def test_build_defines_split_widths():
    """nvcc splits -D values at commas: one define per width."""
    d = dict(_build.tick_defines(EnvParams(**KW), (294, 128, 64, 5)))
    assert d["DR_NLAYERS"] == "3" and d["DR_DIM0"] == "294"
    assert (d["DR_DIM3"], d["DR_DIM4"], d["DR_DIM8"]) == ("5", "0", "0")
    assert d["DR_NPACKETS"] == "12" and d["DR_GRID"] == "9"
    assert not any("," in v for v in d.values())
    lib = _build.library_path(tuple(d.items()))
    other = _build.library_path(_build.tick_defines(
        EnvParams(**KW), (294, 16, 16, 5)))
    assert lib != other and lib.startswith(_build.BUILD_DIR)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel against its plain version at a small width, every
    env greedy (ε = 0): env outputs bitwise, charge within 1.3e-7."""
    dev = _card()
    key, ts, ring, _, _, net, eps, _, tp = _kernel_inputs(dtype=dtype)
    ts = fused_tick.TState(*(t.to(dev) for t in ts))
    ring, net = ring.to(dev), net.to(dev)
    eps = torch.tensor(0.0, device=dev)
    launches = fused_tick.full_tick_fused_ring.launches
    for t in range(3):
        key, step_key = rng.split(key, 2)
        ring_p = ring.clone()
        out_k = fused_tick.full_tick_fused_ring(
            step_key, ts, ring, 0, E, net, eps, t == 1, tp)
        out_p = fused_tick.full_tick_ring_plain(
            step_key, ts, ring_p, 0, E, net, eps, t == 1, tp,
            actions_override=out_k[3])
        for a, b in zip(out_k[0], out_p[0]):
            assert torch.equal(a, b), t
        assert torch.equal(out_k[1], out_p[1])
        assert torch.equal(out_k[2], out_p[2])
        diff = (ring.float() - ring_p.float()).abs().reshape(-1, 6, 2 * E)
        assert float(diff[:, [0, 1, 2, 3, 5]].max()) == 0.0
        assert float(diff[:, 4].max()) <= CHARGE_ATOL
        ts = out_k[0]
    assert fused_tick.full_tick_fused_ring.launches == launches + 3


@pytest.mark.gpu
def test_trainer_on_card_matches_cpu():
    """Four ticks of the ring trainer through the kernel on the card and
    through the plain version on the CPU, from one carry. ε stays 1 (every
    action random), so no near tie of the Q forward can split the two:
    rng chain, env state, ring and scalar rings bitwise (charge within
    1.3e-7); the learner's params within 1e-5 (cuBLAS and CPU sums)."""
    dev = _card()
    tp = EnvParams(**KW)
    cfg = DQNConfig(hidden_layers=(16, 16), epsilon_start=1.0,
                    epsilon_end=1.0, epsilon_decay_every=2,
                    target_update_interval=2)
    cap = 4 * E
    cpu_agent = DQN(cfg, tp, device="cpu")
    card_agent = DQN(cfg, tp, device=dev)
    c_cpu = train.init_ring_carry(cpu_agent, tp, E, cap, rng.PRNGKey(0))
    c_card = train.init_ring_carry(card_agent, tp, E, cap, rng.PRNGKey(0))
    for a, b in zip(c_cpu[3].params.flat(), c_card[3].params.flat()):
        assert torch.equal(a, b.cpu())
    t_cpu = train.build_train_step_ring(cpu_agent, tp, E, cap, 8, 3)
    t_card = train.build_train_step_ring(card_agent, tp, E, cap, 8, 3)
    launches = fused_tick.full_tick_fused_ring.launches
    for t in range(4):
        c_cpu, (r_cpu, _, l_cpu) = t_cpu(c_cpu)
        c_card, (r_card, _, l_card) = t_card(c_card)
        assert torch.equal(c_cpu[0], c_card[0]) and c_card[-1] == t + 1
        for a, b in zip(c_cpu[1][0], c_card[1][0]):
            assert torch.equal(a, b.cpu()), t
        for a, b in zip(c_cpu[2], c_card[2]):
            assert torch.equal(a, b.cpu()), t
        assert torch.equal(r_cpu, r_card.cpu()), t
        diff = (c_cpu[1][1] - c_card[1][1].cpu()).abs().reshape(-1, 6, cap)
        assert float(diff[:, [0, 1, 2, 3, 5]].max()) == 0.0, t
        assert float(diff[:, 4].max()) <= CHARGE_ATOL, t
        np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=1e-5)
    for a, b in zip(c_cpu[3].params.flat(), c_card[3].params.flat()):
        np.testing.assert_allclose(b.detach().cpu().numpy(),
                                   a.detach().numpy(), rtol=0, atol=1e-5)
    assert fused_tick.full_tick_fused_ring.launches == launches + 4
