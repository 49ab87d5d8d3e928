"""The CUDA kernels' wrappers, builds and launches: the tick kernel and
the learner kernel.

No JAX here: the ``gpu`` tests run on a machine with a card, where the
JAX package is not installed, by

    python -m pytest tests/test_torch_kernel.py -q --noconftest

(``--noconftest`` skips tests/conftest.py, which imports JAX). Without a
card they skip. The host-side tests check what the wrapper hands the
kernel: the argument block, the inputs it refuses and the build's
``-D`` set.
"""

import copy
import ctypes

import numpy as np
import pytest
import torch

from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops import _build, fused_tick, learner_kernel

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
    lib = _build.library_path(("full_tick.cu", tuple(d.items())))
    other = _build.library_path(_build.tick_config(
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



def _learner_state(dev, hidden, seed=0):
    tp = EnvParams(**KW)
    cfg = DQNConfig(hidden_layers=hidden, epsilon_decay=0.99,
                    epsilon_end=0.01, gamma=0.9)
    agent = DQN(cfg, tp, device=dev)
    return agent, agent.init_state(torch.Generator().manual_seed(seed))


def _card_batch(obs_dim, seed, dev, bsz=8):
    """A batch in the replay gather's layout: obs and next_obs are column
    slices of one (obs_dim, 2B) tensor."""
    r = np.random.default_rng(seed)
    both = torch.from_numpy(
        (r.random((obs_dim, 2 * bsz)) < 0.3).astype(np.float32)).to(dev)
    return {
        "obs": both[:, :bsz], "next_obs": both[:, bsz:],
        "actions": torch.from_numpy(
            r.integers(0, 5, bsz).astype(np.int32)).to(dev),
        "rewards": torch.from_numpy(
            r.choice([-1.0, 0.0, 1.0], bsz).astype(np.float32)).to(dev),
        "dones": torch.from_numpy(
            (r.random(bsz) < 0.2).astype(np.float32)).to(dev),
    }


def _leaves(st):
    """params, target, mu, nu: every learner leaf, in that order."""
    return (st.params.flat() + st.target_params.flat() + st.opt_state.mu
            + st.opt_state.nu)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [(16, 16), (128, 64)])
def test_learner_kernel_matches_plain_on_card(hidden):
    """6 learner ticks (learn off at tick 2, sync on even ticks, decay
    every third), each tick of the kernel and of the plain version from
    the same state: ε bitwise, loss within rtol 1e-5 (-1 when not
    learning), every leaf within rtol 1e-5, atol 1e-6 except where the
    gradient is a cancellation, and bitwise unchanged where a flag is
    off."""
    dev = _card()
    agent, st = _learner_state(dev, hidden)
    cfg = agent.config
    launches = learner_kernel.td_adam.launches
    for t in range(6):
        learn, sync, dec = t != 2, t % 2 == 0, t % 3 == 0
        batch = _card_batch(agent.obs_dim, t, dev)
        _, grads, scales = learner_kernel.td_gradients(
            batch, st.params, st.target_params, cfg.gamma, with_scales=True)
        cancelled = learner_kernel.cancellations(grads, scales)
        ref = copy.deepcopy(st)
        before = copy.deepcopy(st)
        ref_loss = learner_kernel.td_adam_plain(
            batch, ref.params, ref.target_params, ref.opt_state.mu,
            ref.opt_state.nu, ref.opt_state.count, learn=learn,
            sync_target=sync, decay_eps=dec, epsilon=ref.epsilon,
            gamma=cfg.gamma, lr=cfg.learning_rate, tau=cfg.tau,
            eps_decay=cfg.epsilon_decay, eps_end=cfg.epsilon_end)
        st, loss = learner_kernel.learn_tick_fused(
            batch, st, learn, sync, dec, cfg)
        torch.cuda.synchronize()
        assert torch.equal(st.epsilon, ref.epsilon), t
        assert torch.equal(st.epsilon, before.epsilon) != dec
        assert st.opt_state.count == before.opt_state.count + learn
        if learn:
            np.testing.assert_allclose(float(loss), float(ref_loss),
                                       rtol=1e-5)
        else:
            assert float(loss) == -1.0
        n = len(grads)
        for i, (k, p, b) in enumerate(zip(_leaves(st), _leaves(ref),
                                          _leaves(before))):
            if (i // n == 1 and not sync) or (i // n != 1 and not learn):
                assert torch.equal(k, b), (t, i)
            bad = (k - p).abs() > 1e-6 + 1e-5 * p.abs()
            assert not bool((bad & ~cancelled[i % n]).any()), (t, i)
    assert learner_kernel.td_adam.launches == launches + 6


@pytest.mark.gpu
def test_in_kernel_td_trainer_on_card_matches_cpu():
    """Four ticks of the in_kernel_td trainer through both kernels on the
    card and through the plain versions on the CPU, from one carry, ε = 1
    (no near tie can split the actors): rng chain, env state and scalar
    rings bitwise; losses within rtol 1e-5; params within 1e-5."""
    dev = _card()
    tp = EnvParams(**KW)
    cfg = DQNConfig(hidden_layers=(16, 16), epsilon_start=1.0,
                    epsilon_end=1.0, epsilon_decay_every=2,
                    target_update_interval=2)
    cap = 4 * E
    agents = [DQN(cfg, tp, device=d) for d in ("cpu", dev)]
    carries = [train.init_ring_carry(a, tp, E, cap, rng.PRNGKey(0),
                                     batch_size=8, in_kernel_td=True)
               for a in agents]
    ticks = [train.build_train_step_ring(a, tp, E, cap, 8, 3,
                                         in_kernel_td=True) for a in agents]
    launches = (fused_tick.full_tick_fused_ring.launches,
                learner_kernel.td_adam.launches)
    for t in range(4):
        (c_cpu, (r_cpu, _, l_cpu)), (c_card, (r_card, _, l_card)) = (
            tick(c) for tick, c in zip(ticks, carries))
        carries = [c_cpu, c_card]
        assert torch.equal(c_cpu[0], c_card[0]) and c_card[-1] == t + 1
        for a, b in zip(c_cpu[1][0] + c_cpu[2], c_card[1][0] + c_card[2]):
            assert torch.equal(a, b.cpu()), t
        assert torch.equal(r_cpu, r_card.cpu()), t
        np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=1e-5)
        assert (float(l_card) == -1.0) == (t == 0)
    for a, b in zip(c_cpu[3].params.flat(), c_card[3].params.flat()):
        np.testing.assert_allclose(b.detach().cpu().numpy(),
                                   a.detach().numpy(), rtol=0, atol=1e-5)
    assert c_card[3].opt_state.count == c_cpu[3].opt_state.count == 3
    assert (fused_tick.full_tick_fused_ring.launches,
            learner_kernel.td_adam.launches) == (launches[0] + 4,
                                                 launches[1] + 4)
