"""The CUDA kernels' wrappers, builds and launches: the full tick kernel
(ring and obs launches), the env tick kernel, the row-major step kernel
(with the jnp engine's observation), the learner kernel, and the draw and
ring sample kernels (the ring's, the StreamReplay's and the row-major
ReplayBuffer's samples).

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

from dronerl_tpu_torch import replay, rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import train_state_io
from dronerl_tpu_torch.ops import (
    _build, draws, fused_tick, learner_kernel, step_kernel)

E = 128
CHARGE_ATOL = 1.3e-7
KW = dict(grid_size=9, n_drones=4)


def _kernel_inputs(hidden=(16, 16), dtype=torch.float32):
    tp = EnvParams(**KW)
    ta = DQN(DQNConfig(hidden_layers=hidden), tp, device="cpu")
    st = ta.init_state(torch.Generator().manual_seed(0))
    ts = fused_tick.to_tstate(core.reset_batch(rng.PRNGKey(0), tp, E))
    ring = torch.zeros((294, 2 * E), dtype=dtype)
    return [rng.PRNGKey(9), ts, ring, 0, E, st.params.flat(), st.epsilon,
            True, tp]


def test_kernel_args_block():
    """The launch's argument block, filled on host tensors (the kernel
    itself needs a card): pointers, slots, key words and env scalars."""
    args = _kernel_inputs(dtype=torch.bfloat16)
    block, (out, rewards, dones, actions) = fused_tick._kernel_args(*args)
    key, ts, ring, read, write, net, eps, do_reset, tp = args
    assert block.obs_in == block.obs_out == ring.data_ptr()
    assert block.obs_bf16 == 1
    assert block.ground_in == ts.ground.data_ptr()
    assert block.charge_out == out.charge.data_ptr()
    assert block.eps == eps.data_ptr()
    assert (block.in_ld, block.read_col, block.out_ld, block.write_col) == (
        2 * E, 0, 2 * E, E)
    assert (block.num_envs, block.do_reset) == (E, 1)
    # The key's two words, read by the kernel through a pointer.
    assert block.key == block.key_words.data_ptr()
    assert block.key_words.dtype == torch.int32
    assert (block.key_words.long() & rng.MASK32).tolist() == key.tolist()
    assert [block.w[i] for i in range(3)] == [
        w.data_ptr() for w in net[0::2]]
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
        args[8] = EnvParams(wrapper="compass", **KW)
    elif case == "widths":
        args[5] = DQN(DQNConfig(hidden_layers=(16,) * 8), args[8],
                      device="cpu").make_net().flat()
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
    ring, net = ring.to(dev), [t.to(dev) for t in net]
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_ragged_envs_on_card(dtype):
    """100 envs: a partial last block of the kernel's 64-env tiles and ring
    columns off the 16-byte grid (its element-wise copies), ε = 0.5 and a
    reset at tick 1: env outputs bitwise, charge within 1.3e-7, actions
    equal outside near ties, the read columns untouched."""
    dev = _card()
    num_envs = 100
    tp = EnvParams(**KW)
    net = DQN(DQNConfig(hidden_layers=(16, 16)), tp, device=dev).init_state(
        torch.Generator().manual_seed(0)).params.flat()
    ts = fused_tick.to_tstate(core.reset_batch(rng.PRNGKey(1).to(dev), tp,
                                               num_envs))
    ring = torch.rand((294, 3 * num_envs), generator=torch.Generator(
        ).manual_seed(2)).round().to(dtype).to(dev)
    eps = torch.tensor(0.5, device=dev)
    key = rng.PRNGKey(3)
    for t in range(3):
        key, step_key = rng.split(key, 2)
        read, write = num_envs * (t % 2), num_envs * (1 + t % 2)
        ring_p = ring.clone()
        out_k = fused_tick.full_tick_fused_ring(
            step_key, ts, ring, read, write, net, eps, t == 1, tp)
        out_p = fused_tick.full_tick_ring_plain(
            step_key, ts, ring_p, read, write, net, eps, t == 1, tp,
            actions_override=out_k[3])
        for a, b in zip(out_k[0] + out_k[1:3], out_p[0] + out_p[1:3]):
            assert torch.equal(a, b), t
        diff = (ring.float() - ring_p.float()).abs().reshape(-1, 6,
                                                            3 * num_envs)
        assert float(diff[:, [0, 1, 2, 3, 5]].max()) == 0.0
        assert float(diff[:, 4].max()) <= CHARGE_ATOL
        act_p, q = fused_tick.plain_actions(
            rng.split_plain(step_key.to(dev), num_envs + 2)[num_envs], ring_p,
            read, net, eps, tp, num_envs)
        differ = (out_k[3] != act_p).any(dim=0)
        assert not bool((differ & ~_near_tie(q)).any()), t
        ts = out_k[0]


@pytest.mark.gpu
def test_trainer_on_card_matches_cpu():
    """Four ticks of the ring trainer through the kernels on the card (the
    default learner on the learner kernel) and through the plain version
    and the autograd learner on the CPU, from one carry. ε stays 1 (every
    action random), so no near tie of the Q forward can split the two:
    rng chain, env state, ring and scalar rings bitwise (charge within
    1.3e-7); the learner's params within 1e-5."""
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
    assert t_card.learner == train.KERNEL
    launches = (fused_tick.full_tick_fused_ring.launches,
                learner_kernel.td_adam.launches)
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
    assert (fused_tick.full_tick_fused_ring.launches,
            learner_kernel.td_adam.launches) == (launches[0] + 4,
                                                 launches[1] + 4)



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


# The learner kernel's card cases: the bench nets, a one-layer net whose
# 8 units leave half of 16 CTAs without a unit, (32,16) and (100,), which
# 16 does not divide, each at batch 1, the bench's 8 and 256; and (512,),
# too wide to stage its params, at 8 and 256.
LEARNER_CASES = [(h, b) for h in ((16, 16), (128, 64), (8,), (32, 16),
                                  (100,)) for b in (8, 1, 256)] + [
    ((512,), 8), ((512,), 256)]


def test_learner_cases_fit():
    """Every card case is one the kernel takes, and between them they run
    every launch plan: the batch staged, read whole, and in tiles, with
    the params staged and read from device memory."""
    plans = set()
    for hidden, bsz in LEARNER_CASES:
        widths = (294, *hidden, 5)
        assert not learner_kernel.kernel_problems(widths, bsz)
        plan = learner_kernel.batch_plan(widths, bsz)
        plans.add((plan.tile < bsz, plan.staged, plan.params_staged))
    assert plans == {(False, True, True), (False, False, True),
                     (True, False, True), (False, True, False),
                     (True, False, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,bsz", LEARNER_CASES)
def test_learner_kernel_matches_plain_on_card(hidden, bsz):
    """6 learner ticks (learn off at tick 2, sync on even ticks, decay
    every third), each tick of the kernel and of the plain version from
    the same state: ε bitwise, loss within rtol 1e-5 (at batch 1 plus
    ``learner_kernel.loss_slack``; -1 when not learning), every leaf
    within rtol 1e-5, atol 1e-6 except where the gradient is a
    cancellation, and bitwise unchanged where a flag is off."""
    dev = _card()
    agent, st = _learner_state(dev, hidden)
    cfg = agent.config
    launches = learner_kernel.td_adam.launches
    for t in range(6):
        learn, sync, dec = t != 2, t % 2 == 0, t % 3 == 0
        batch = _card_batch(agent.obs_dim, t, dev, bsz)
        _, grads, scales = learner_kernel.td_gradients(
            batch, st.params, st.target_params, cfg.gamma, with_scales=True)
        cancelled = learner_kernel.cancellations(grads, scales)
        # One TD error is the whole loss at batch 1: a cancellation of
        # Q-values that each learner sums in its own order.
        slack = learner_kernel.loss_slack(
            batch, st.params, st.target_params, cfg.gamma) if bsz == 1 else 0
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
                                       rtol=1e-5, atol=slack)
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
@pytest.mark.parametrize("hidden", [(16, 16), (128, 64)])
def test_default_kernel_step_matches_autograd_on_card(hidden):
    """The default path's step on the learner kernel
    (``train.kernel_train_step``, the Adam count read from an int32 word
    on the card as a chunk's row holds it) against the autograd learner
    (``DQN.train_step_t``) from the same state on the same batch, 4
    successive steps, at the bench's tolerances (``bench.
    _learner_problems``: loss within rtol 1e-5, params within rtol 1e-5,
    atol 1e-6 outside cancellations); the target and ε untouched, the Adam
    count advanced, one launch a step."""
    from dronerl_tpu_torch import bench

    dev = _card()
    agent, st = _learner_state(dev, hidden)
    assert train.learner_problems(agent, 8) == []
    stats = {"loss_max_err": 0.0, "params_max_err": 0.0,
             "cancellations_beyond_tolerance": 0}
    launches = learner_kernel.td_adam.launches
    for t in range(4):
        batch = _card_batch(agent.obs_dim, 40 + t, dev)
        before = copy.deepcopy(st)
        count = torch.tensor([st.opt_state.count], dtype=torch.int32,
                             device=dev)[0]
        st, loss = train.kernel_train_step(agent, st, batch, count)
        torch.cuda.synchronize()
        assert bench._learner_problems(f"step {t}", agent, before, batch,
                                       st.params, loss, stats) == []
        assert st.opt_state.count == t + 1
        assert torch.equal(st.epsilon, before.epsilon)
        for a, b in zip(st.target_params.flat(),
                        before.target_params.flat()):
            assert torch.equal(a, b), t
    assert learner_kernel.td_adam.launches == launches + 4


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


# --- the StreamReplay engines' kernels: B3 (obs launch), B4, B5 -------------

def test_full_args_block():
    """B3's block: obs_t read at column 0, a new f32 array written."""
    key, ts, _, _, _, net, eps, do_reset, tp = _kernel_inputs()
    obs_t = torch.rand((294, E))
    block, outs = fused_tick._full_args(key, ts, obs_t, net, eps, do_reset,
                                        tp)
    obs_next = outs[4]
    assert block.obs_in == obs_t.data_ptr() != block.obs_out
    assert block.obs_out == obs_next.data_ptr() and block.obs_bf16 == 0
    assert (block.in_ld, block.read_col, block.out_ld, block.write_col) == (
        E, 0, E, 0)
    assert obs_next.dtype == torch.float32 and obs_next.shape == obs_t.shape
    with pytest.raises(ValueError):
        fused_tick._full_args(key, ts, obs_t.bfloat16(), net, eps, False, tp)
    with pytest.raises(ValueError):
        fused_tick._full_args(key, ts, obs_t[:, :E // 2], net, eps, False,
                              tp)


def test_env_tick_args_block():
    """B4's block: the caller's actions, no net, a new obs array."""
    key, ts, _, _, _, _, _, _, tp = _kernel_inputs()
    actions = torch.randint(0, 5, (tp.n_drones, E), dtype=torch.int32)
    block, (out, rewards, dones, obs_next) = fused_tick._env_tick_args(
        key, ts, actions, tp)
    assert block.actions == actions.data_ptr()
    assert block.obs_out == obs_next.data_ptr()
    assert block.ground_in == ts.ground.data_ptr()
    assert block.charge_out == out.charge.data_ptr()
    assert block.num_envs == E
    # The key's two words, read by the kernel through a pointer.
    assert block.key == block.key_words.data_ptr()
    assert block.key_words.dtype == torch.int32
    assert (block.key_words.long() & rng.MASK32).tolist() == key.tolist()
    assert tuple(obs_next.shape) == (294, E) and dones.dtype == torch.bool
    with pytest.raises(ValueError):
        fused_tick._env_tick_args(key, ts, actions.long(), tp)
    with pytest.raises(ValueError):
        fused_tick._env_tick_args(key, ts, actions.t().contiguous(), tp)


def _row_inputs(kw, num_envs=E, seed=0):
    tp = EnvParams(**kw)
    states = core.reset_batch(rng.PRNGKey(seed), tp, num_envs)
    actions = torch.randint(0, 5, (num_envs, tp.n_drones),
                            generator=torch.Generator().manual_seed(seed),
                            dtype=torch.int32)
    return tp, states, actions


def test_step_args_block():
    """B5's block: row-major state, bool flags as bytes."""
    tp, states, actions = _row_inputs(dict(grid_size=20, n_drones=4))
    key = rng.PRNGKey(3)
    block, (out, rewards, dones) = step_kernel._kernel_args(
        key, states, actions, tp)
    assert block.ground_in == states.ground.data_ptr()
    assert block.carry_in == states.carrying_package.data_ptr()
    assert block.carry_out == out.carrying_package.data_ptr()
    assert block.actions == actions.data_ptr()
    assert out.carrying_package.dtype == torch.bool
    assert tuple(out.ground.shape) == (E, 20, 20)
    assert tuple(rewards.shape) == (E, 4) and dones.dtype == torch.bool
    assert ctypes.c_float(tp.charge_reward).value == block.charge_reward
    with pytest.raises(ValueError):
        step_kernel._kernel_args(key, states, actions.t(), tp)
    big, states, actions = _row_inputs(dict(grid_size=23, n_drones=4))
    with pytest.raises(ValueError, match="529 cells"):
        step_kernel._kernel_args(key, states, actions, big)


def test_build_env_only_configs():
    """B4 and B5 share one library per env: the env defines alone."""
    tp = EnvParams(**KW)
    env = _build.env_config(tp)
    assert env[0] == "env_kernel.cu" and env[1] == _build.env_defines(tp)
    assert _build.ENTRY_POINTS[env[0]][0] == ("tick_launch", "step_launch")
    assert not any(k.startswith("DR_DIM") or k == "DR_NLAYERS"
                   for k, _ in env[1])
    paths = {_build.library_path(c) for c in (
        env, _build.env_config(EnvParams(grid_size=20, n_drones=4)),
        _build.tick_config(tp, (294, 16, 16, 5)))}
    assert len(paths) == 3


def _near_tie(q, rel=1e-5):
    top2 = q.topk(2, dim=0).values
    return (top2[0] - top2[1]) <= rel * q.abs().amax(dim=0)


@pytest.mark.gpu
def test_full_tick_kernel_matches_plain_on_card():
    """B3 against ``full_tick_plain``, 3 ticks with a reset at tick 1, ε =
    0.5: env outputs bitwise, charge within 1.3e-7, actions equal outside
    near ties of the plain Q-values, obs_t never written."""
    dev = _card()
    key, ts, _, _, _, net, _, _, tp = _kernel_inputs(hidden=(128, 64))
    ts = fused_tick.TState(*(t.to(dev) for t in ts))
    net = [t.to(dev) for t in net]
    state = core.reset_batch(rng.PRNGKey(4).to(dev), tp, E)
    obs_t = core.observe_batch(state, tp, 1).reshape(E, 294).t().contiguous()
    eps = torch.tensor(0.5, device=dev)
    launches = fused_tick.full_tick_fused.launches
    for t in range(3):
        key, step_key = rng.split(key, 2)
        before = obs_t.clone()
        out_k = fused_tick.full_tick_fused(step_key, ts, obs_t, net, eps,
                                           t == 1, tp)
        out_p = fused_tick.full_tick_plain(step_key, ts, obs_t, net, eps,
                                           t == 1, tp,
                                           actions_override=out_k[3])
        for a, b in zip(out_k[0], out_p[0]):
            assert torch.equal(a, b), t
        assert torch.equal(out_k[1], out_p[1])
        assert torch.equal(out_k[2], out_p[2])
        diff = (out_k[4] - out_p[4]).abs().reshape(-1, 6, E)
        assert float(diff[:, [0, 1, 2, 3, 5]].max()) == 0.0
        assert float(diff[:, 4].max()) <= CHARGE_ATOL
        act_p, q = fused_tick.plain_actions(
            rng.split_plain(step_key.to(dev), E + 2)[E], obs_t, 0, net, eps,
            tp, E)
        differ = (out_k[3] != act_p).any(dim=0)
        assert not bool((differ & ~_near_tie(q)).any()), t
        assert torch.equal(obs_t, before)
        ts, obs_t = out_k[0], out_k[4]
    assert fused_tick.full_tick_fused.launches == launches + 3


def _push_inputs(k, device, seed=0, num_envs=E):
    """B3's inputs at ``num_envs`` envs with the first k drones collected,
    and a StreamReplay's storage of four pushes filled with noise."""
    tp = EnvParams(**KW)
    agent = DQN(DQNConfig(hidden_layers=(16, 16)), tp, device=device)
    chain = agent.init_state(rng.PRNGKey(seed)).params.flat()
    state = core.reset_batch(rng.PRNGKey(seed + 4).to(device), tp, num_envs)
    obs_t = train._stacked_obs(state, tp, k)
    state = core.reset_batch(rng.PRNGKey(seed + 5).to(device), tp, num_envs)
    capacity = 4 * k * num_envs
    gen = torch.Generator().manual_seed(seed)
    storage = {
        "obs": torch.rand((294, capacity), generator=gen).to(device),
        "actions": torch.randint(0, 5, (capacity,), generator=gen,
                                 dtype=torch.int32).to(device),
        "rewards": torch.rand((capacity,), generator=gen).to(device),
        "dones": (torch.rand((capacity,), generator=gen) < 0.5).to(device),
    }
    return tp, chain, fused_tick.to_tstate(state), obs_t, storage


def test_full_args_block_push():
    """B3's block with a replay: the push's pointers, start word and
    capacity, the next observation over obs_t; a start off the push's
    grid, storage of another shape or dtype, and a B1 block refused."""
    tp, chain, ts, obs_t, storage = _push_inputs(2, "cpu")
    eps = torch.tensor(0.5)
    block, outs = fused_tick._full_args(
        rng.PRNGKey(9), ts, obs_t, chain, eps, False, tp,
        replay=(storage, 2 * E), collect=2)
    assert outs[4] is obs_t and block.obs_in == block.obs_out
    assert block.push_obs == storage["obs"].data_ptr()
    assert block.push_actions == storage["actions"].data_ptr()
    assert block.push_rewards == storage["rewards"].data_ptr()
    assert block.push_dones == storage["dones"].data_ptr()
    assert block.push_ld == 8 * E
    assert block.push_start == block.start_word.data_ptr()
    assert block.start_word.dtype == torch.int32
    assert int(block.start_word) == 2 * E
    row = torch.tensor([7, 4 * E], dtype=torch.int32)
    block, _ = fused_tick._full_args(
        rng.PRNGKey(9), ts, obs_t, chain, eps, False, tp,
        replay=(storage, row[1]), collect=2)
    assert block.push_start == row[1].data_ptr()
    bad = [(storage, E), (dict(storage, rewards=storage["rewards"].double()),
                          0),
           (dict(storage, obs=storage["obs"][:, :6 * E + 1]), 0),
           (storage, row[1].long())]
    for replay_arg in bad:
        with pytest.raises(ValueError):
            fused_tick._full_args(rng.PRNGKey(9), ts, obs_t, chain, eps,
                                  False, tp, replay=replay_arg, collect=2)
    ring_block, _ = fused_tick._kernel_args(*_kernel_inputs())
    assert ring_block.push_obs is None


def _unfused_push(step_key, ts, obs_t, chain, eps, tp, k, storage, start):
    """B3 without a replay, then ``StreamReplay.push_many`` of its
    transitions: the push as the full engine made it before B3 took it
    over. Returns the launch's outputs and the storage."""
    storage = {n: t.clone() for n, t in storage.items()}
    out = fused_tick.full_tick_fused(step_key, ts, obs_t, chain, eps, False,
                                     tp, k)
    buf = replay.StreamReplay(storage["obs"].shape[-1], 8,
                              stride=k * obs_t.shape[-1])
    buf.push_many(replay.ReplayState(storage, 0, 0),
                  replay.stream_push_batch(obs_t, out[3], out[1], out[2], k),
                  start=start)
    return out, storage


def _assert_push_equal(got, storage, want, want_storage, obs_t):
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for i in (1, 2, 3):
        assert torch.equal(got[i], want[i]), i
    assert got[4] is obs_t and torch.equal(obs_t, want[4])
    for name, t in storage.items():
        assert torch.equal(t, want_storage[name]), name


@pytest.mark.gpu
@pytest.mark.parametrize("num_envs", [E, 100])
@pytest.mark.parametrize("start", ["first", "last"])
@pytest.mark.parametrize("epsilon", [0.0, 1.0])
@pytest.mark.parametrize("k", [1, 2])
def test_full_tick_push_matches_unfused_on_card(k, epsilon, start,
                                                num_envs):
    """B3 with the replay (the push inside the launch, the next
    observation over obs_t) against B3 without it followed by
    ``StreamReplay.push_many``: the replay's storage, obs_t, the state,
    rewards, dones and actions bitwise, at k = 1 and 2, with every env
    greedy (ε = 0) and none (ε = 1: no block runs the actor, so the push
    reads the observation itself), at the replay's first push and its
    last (``capacity - stride``); one push counted a launch. At 128 envs
    every block is whole and takes the 16-byte stores; at 100 the last
    block holds 36 envs and takes the push's scalar stores."""
    dev = _card()
    tp, chain, ts, obs_t, storage = _push_inputs(k, dev, num_envs=num_envs)
    eps = torch.tensor(epsilon, device=dev)
    capacity = storage["obs"].shape[-1]
    at = 0 if start == "first" else capacity - k * num_envs
    key = rng.PRNGKey(11)
    pushes, launches = (fused_tick.full_tick_fused.pushes,
                        fused_tick.full_tick_fused.launches)
    for t in range(2):
        key, step_key = rng.split(key, 2)
        want, want_storage = _unfused_push(step_key, ts, obs_t, chain, eps,
                                           tp, k, storage, at)
        got = fused_tick.full_tick_fused(step_key, ts, obs_t, chain, eps,
                                         False, tp, k, replay=(storage, at))
        torch.cuda.synchronize()
        _assert_push_equal(got, storage, want, want_storage, obs_t)
        ts = got[0]
    assert fused_tick.full_tick_fused.pushes == pushes + 2
    assert fused_tick.full_tick_fused.launches == launches + 4


@pytest.mark.gpu
def test_full_tick_push_in_graph_on_card():
    """B3's push captured in a CUDA graph with its start slot read by
    pointer: replays after the start word changes push at the new slot,
    bitwise to the unfused launch and push; the capture counts one push
    and the replays none (a chunk adds them)."""
    dev = _card()
    k = 1
    tp, chain, ts, obs_t, storage = _push_inputs(k, dev, seed=3)
    eps = torch.tensor(0.25, device=dev)
    step_key = rng.PRNGKey(12).to(dev)
    obs_in = obs_t.clone()
    word = torch.zeros(1, dtype=torch.int32, device=dev)
    # Built and warmed up outside the capture.
    fused_tick.full_tick_fused(step_key, ts, obs_t.clone(), chain, eps,
                               False, tp, k,
                               replay=({n: t.clone() for n, t in
                                        storage.items()}, word[0]))
    torch.cuda.synchronize()
    pushes = fused_tick.full_tick_fused.pushes
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fused_tick.full_tick_fused(step_key, ts, obs_t, chain, eps,
                                         False, tp, k,
                                         replay=(storage, word[0]))
    assert fused_tick.full_tick_fused.pushes == pushes + 1
    capacity = storage["obs"].shape[-1]
    for at in (2 * E, 0, capacity - E):
        obs_t.copy_(obs_in)
        want, want_storage = _unfused_push(step_key, ts, obs_in, chain, eps,
                                           tp, k, storage, at)
        word.fill_(at)
        graph.replay()
        torch.cuda.synchronize()
        _assert_push_equal(got, storage, want, want_storage, obs_t)
    assert fused_tick.full_tick_fused.pushes == pushes + 1


@pytest.mark.gpu
@pytest.mark.parametrize("kw,num_envs", [
    (KW, E), (dict(grid_size=16, n_drones=25), E), (KW, 100)])
def test_env_tick_kernel_matches_plain_on_card(kw, num_envs):
    """B4 against ``tick_plain`` for 3 ticks of random actions, on grid 9,
    on grid 16 with 25 drones (8 cells a lane), and at 100 envs (a partial
    last tile, rows off the 16-byte grid): env outputs bitwise, charge
    within 1.3e-7."""
    dev = _card()
    tp = EnvParams(**kw)
    ts = fused_tick.to_tstate(core.reset_batch(rng.PRNGKey(0).to(dev), tp,
                                               num_envs))
    key = rng.PRNGKey(9)
    g = torch.Generator().manual_seed(5)
    launches = fused_tick.tick_fused.launches
    for t in range(3):
        key, step_key = rng.split(key, 2)
        actions = torch.randint(0, 5, (tp.n_drones, num_envs), generator=g,
                                dtype=torch.int32).to(dev)
        out_k = fused_tick.tick_fused(step_key, ts, actions, tp)
        out_p = fused_tick.tick_plain(step_key, ts, actions, tp)
        for a, b in zip(out_k[0], out_p[0]):
            assert torch.equal(a, b), t
        assert torch.equal(out_k[1], out_p[1])
        assert torch.equal(out_k[2], out_p[2])
        diff = (out_k[3] - out_p[3]).abs().reshape(-1, 6, num_envs)
        assert float(diff[:, [0, 1, 2, 3, 5]].max()) == 0.0
        assert float(diff[:, 4].max()) <= CHARGE_ATOL
        ts = out_k[0]
    assert fused_tick.tick_fused.launches == launches + 3


@pytest.mark.gpu
@pytest.mark.parametrize("kw,num_envs", [
    (dict(grid_size=9, n_drones=4), E), (dict(grid_size=5, n_drones=2), E),
    (dict(grid_size=20, n_drones=4), E), (dict(grid_size=20, n_drones=20), E),
    (dict(grid_size=22, n_drones=48), E), (dict(grid_size=9, n_drones=4), 100)])
def test_step_kernel_matches_plain_on_card(kw, num_envs):
    """B5 against ``core.step_batch`` for 3 steps on grid 9, a tight board,
    a 400-cell board, the evaluator's 20-participant arena, 48 drones on
    a nearly full board, and grid 9 at 100 envs (a partial last tile, spans
    off the 16-byte grid): everything bitwise."""
    dev = _card()
    tp, states, _ = _row_inputs(kw, num_envs)
    states = type(states)(*(getattr(states, f).to(dev) for f in (
        "ground", "air_x", "air_y", "carrying_package", "charge")))
    g = torch.Generator().manual_seed(6)
    key = rng.PRNGKey(7)
    launches = step_kernel.step_batch_fused.launches
    for t in range(3):
        key, step_key = rng.split(key, 2)
        actions = torch.randint(0, 5, (num_envs, tp.n_drones), generator=g,
                                dtype=torch.int32).to(dev)
        out_k = step_kernel.step_batch_fused(step_key, states, actions, tp)
        out_p = step_kernel.step_batch_plain(step_key, states, actions, tp)
        for f in ("ground", "air_x", "air_y", "carrying_package", "charge"):
            assert torch.equal(getattr(out_k[0], f), getattr(out_p[0], f)), (
                t, f)
        assert torch.equal(out_k[1], out_p[1])
        assert torch.equal(out_k[2], out_p[2])
        states = out_k[0]
    assert step_kernel.step_batch_fused.launches == launches + 3


def _assert_obs(got, want, tag):
    """Observations (..., OBS) bitwise but the charge channel (channel 4
    of each cell's 6), within CHARGE_ATOL."""
    got, want = (t.reshape(*t.shape[:-1], -1, 6) for t in (got, want))
    other = torch.arange(6, device=got.device) != 4
    assert torch.equal(got[..., other], want[..., other]), tag
    err = float((got[..., 4] - want[..., 4]).abs().max())
    assert err <= CHARGE_ATOL, (tag, err)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("wrapper", ["window", "global"])
@pytest.mark.parametrize("num_envs", [1, 7, 64, 100])
def test_step_observation_matches_plain_on_card(num_envs, wrapper, k):
    """B5 with the jnp engine's observation (``collect`` = k) against its
    plain version (``core.step_batch`` + ``observe_batch``) for 4 ticks of
    random actions: state, rewards and dones bitwise, the (E, k, OBS)
    observation bitwise but the charge channel; the step key as a chunk
    row's int32 words on the card and as a host key."""
    dev = _card()
    tp, states, _ = _row_inputs(dict(KW, wrapper=wrapper), num_envs,
                                seed=num_envs)
    states = type(states)(*(getattr(states, f).to(dev) for f in (
        "ground", "air_x", "air_y", "carrying_package", "charge")))
    g = torch.Generator().manual_seed(num_envs + k)
    key = rng.PRNGKey(11)
    launches = step_kernel.step_batch_fused.launches
    for t in range(4):
        key, step_key = rng.split(key, 2)
        words = ((step_key.to(dev) & rng.MASK32).to(torch.int32)
                 if t % 2 else step_key)
        actions = torch.randint(0, 5, (num_envs, tp.n_drones), generator=g,
                                dtype=torch.int32).to(dev)
        out_k = step_kernel.step_batch_fused(words, states, actions, tp, k)
        out_p = step_kernel.step_batch_plain(step_key, states, actions, tp,
                                             k)
        for f in ("ground", "air_x", "air_y", "carrying_package", "charge"):
            assert torch.equal(getattr(out_k[0], f), getattr(out_p[0], f)), (
                t, f)
        assert torch.equal(out_k[1], out_p[1]) and torch.equal(out_k[2],
                                                               out_p[2])
        assert out_k[3].shape == out_p[3].shape == (
            num_envs, k, fused_tick.obs_rows(tp))
        _assert_obs(out_k[3], out_p[3], t)
        states = out_k[0]
    assert step_kernel.step_batch_fused.launches == launches + 4


def test_step_observation_refused_beyond_the_tick_limits():
    """The observation exists within 256 cells and 32 drones: the wrapper
    refuses it beyond them before any build, and a k beyond the drones."""
    tp, states, actions = _row_inputs(dict(grid_size=20, n_drones=4), 8)
    with pytest.raises(ValueError, match="400 cells > 256"):
        step_kernel._kernel_args(rng.PRNGKey(0), states, actions, tp, 1)
    tp, states, actions = _row_inputs(KW, 8)
    with pytest.raises(ValueError, match="collect_drones=5"):
        step_kernel._kernel_args(rng.PRNGKey(0), states, actions, tp, 5)
    block, outs = step_kernel._kernel_args(rng.PRNGKey(0), states, actions,
                                           tp, 2)
    assert outs[3].shape == (8, 2, 294) and block.obs_out == outs[
        3].data_ptr()


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["full", "fused"])
def test_stream_engine_on_card_matches_cpu(engine):
    """Four ticks of a StreamReplay engine through its kernel on the card
    and through the plain versions on the CPU, from one carry, ε = 1 (no
    near tie can split the actors): rng chain, env state, observations
    and replay bitwise (charge within 1.3e-7); losses within rtol 1e-5;
    params within 1e-5."""
    dev = _card()
    tp = EnvParams(**KW)
    cfg = DQNConfig(hidden_layers=(16, 16), epsilon_start=1.0,
                    epsilon_end=1.0, epsilon_decay_every=2,
                    target_update_interval=2)
    build = {"full": train.build_train_step_full,
             "fused": train.build_train_step_fused}[engine]
    counter = {"full": fused_tick.full_tick_fused,
               "fused": fused_tick.tick_fused}[engine]
    buf = replay.StreamReplay(3 * E, 8, stride=E)
    agents = [DQN(cfg, tp, device=d) for d in ("cpu", dev)]
    carries = [train.init_stream_carry(a, tp, E, buf, rng.PRNGKey(0))
               for a in agents]
    ticks = [build(a, buf, tp, E, 3) for a in agents]
    launches = counter.launches
    for t in range(4):
        (c_cpu, (r_cpu, _, l_cpu)), (c_card, (r_card, _, l_card)) = (
            tick(c) for tick, c in zip(ticks, carries))
        carries = [c_cpu, c_card]
        assert torch.equal(c_cpu[0], c_card[0]) and c_card[-1] == t + 1
        for a, b in zip(c_cpu[1], c_card[1]):
            assert torch.equal(a, b.cpu()), t
        b_cpu, b_card = c_cpu[4], c_card[4]
        assert (b_cpu.cursor, b_cpu.size) == (b_card.cursor, b_card.size)
        for k in ("actions", "rewards", "dones"):
            assert torch.equal(b_cpu.storage[k], b_card.storage[k].cpu())
        for o_cpu, o_card in ((c_cpu[2], c_card[2]),
                              (b_cpu.storage["obs"], b_card.storage["obs"])):
            diff = (o_cpu - o_card.cpu()).abs().reshape(-1, 6,
                                                        o_cpu.shape[-1])
            assert float(diff[:, [0, 1, 2, 3, 5]].max()) == 0.0, t
            assert float(diff[:, 4].max()) <= CHARGE_ATOL, t
        assert torch.equal(r_cpu, r_card.cpu()), t
        np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=1e-5)
    for a, b in zip(c_cpu[3].params.flat(), c_card[3].params.flat()):
        np.testing.assert_allclose(b.detach().cpu().numpy(),
                                   a.detach().numpy(), rtol=0, atol=1e-5)
    assert counter.launches == launches + 4


# --- the conv family and the global observation ------------------------------

_CONV5 = dict(network_type="conv", conv_matmul=True, conv_dense_layers=(16,))
_CONV32 = dict(network_type="conv", conv_matmul=True, conv_layers=(
    {"kernel_size": 3, "out_channels": 32, "padding": 1, "stride": 1},))
# (wrapper, grid, net, the full tick kernel's variant with bf16 / f32
# observations): the window conv's 392 hidden units fit shared memory, a
# conv on the global 9 x 9 board does not (its activations go to device
# memory), and on the global 16 x 16 board the observation tile does not.
CHAIN_CASES = {
    "window_conv5": ("window", 9, _CONV5, ("shared", "shared")),
    "global_dense": ("global", 9, dict(hidden_layers=(16, 16)),
                     ("shared", "shared")),
    "global_conv5": ("global", 9, _CONV5, ("device", "device")),
    "global_conv32": ("global", 9, _CONV32, ("device", "device")),
    "global16_dense": ("global", 16, dict(hidden_layers=(16, 16)),
                       ("device_obs", "device_obs")),
}


def _chain_case(case, device="cpu"):
    wrapper, grid, net, _ = CHAIN_CASES[case]
    tp = EnvParams(grid_size=grid, n_drones=4, wrapper=wrapper)
    agent = DQN(DQNConfig(**net), tp, device=device)
    st = agent.init_state(rng.PRNGKey(0))
    return tp, fused_tick.flatten_net_params(st.params, agent.net_spec)


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_tick_layout_variants(case):
    """The tick kernel's block for each chain: the variant, and a scratch
    exactly where the activations leave shared memory."""
    tp, chain = _chain_case(case)
    widths = fused_tick.chain_widths(chain)
    for bf16, variant in zip((True, False), CHAIN_CASES[case][3]):
        layout = fused_tick.tick_layout(tp, widths, bf16)
        assert layout["variant"] == variant
        assert layout["smem_bytes"] <= fused_tick.SMEM_LIMIT
        assert (layout["scratch_bytes"] > 0) == (variant != "shared")
    # The bench nets keep the blocks the kernel's header states.
    bench = EnvParams(**KW)
    assert [fused_tick.tick_layout(bench, (294, *h, 5), bf16)["smem_bytes"]
            for h in ((16, 16), (128, 64)) for bf16 in (True, False)] == [
        82848, 109472, 90272, 109472]


def test_kernel_args_block_scratch():
    """A chain whose activations do not fit shared memory: the block holds
    a device-memory scratch of the layout's bytes for each block of 64."""
    tp, chain = _chain_case("global_conv32")
    ts = fused_tick.to_tstate(core.reset_batch(rng.PRNGKey(0), tp, 100))
    obs = torch.zeros((486, 100), dtype=torch.float32)
    block, _ = fused_tick._full_args(rng.PRNGKey(1), ts, obs, chain,
                                     torch.tensor(0.5), False, tp)
    per_block = fused_tick.tick_layout(tp, (486, 2592, 5), False)[
        "scratch_bytes"]
    assert block.keep.numel() * 4 == 2 * per_block
    assert block.scratch == block.keep.data_ptr()
    tp, chain = _chain_case("global_dense")
    ts = fused_tick.to_tstate(core.reset_batch(rng.PRNGKey(0), tp, 100))
    block, _ = fused_tick._full_args(rng.PRNGKey(1), ts, obs, chain,
                                     torch.tensor(0.5), False, tp)
    assert block.scratch is None


def test_build_defines_global():
    """The global observation is one define more; a window build's set is
    unchanged."""
    window = dict(_build.env_defines(EnvParams(**KW)))
    glob = dict(_build.env_defines(EnvParams(wrapper="global", **KW)))
    assert "DR_GLOBAL" not in window and glob.pop("DR_GLOBAL") == "1"
    assert glob == window


@pytest.mark.gpu
@pytest.mark.parametrize("num_envs", [E, 100])
@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_kernels_match_plain_on_card(case, num_envs):
    """B1 (bf16 ring) and B3 (f32) with each chain against their plain
    versions, 3 ticks with a reset at tick 1, ε = 0.5: env outputs bitwise,
    charge within 1.3e-7, actions equal outside near ties; the library's
    shared memory and scratch as ``tick_layout`` says."""
    dev = _card()
    tp, chain = _chain_case(case, dev)
    widths = fused_tick.chain_widths(chain)
    cfg = fused_tick.kernel_config(tp, chain)
    for bf16 in (True, False):
        smem, _, scratch = fused_tick.kernel_occupancy(cfg, bf16)
        layout = fused_tick.tick_layout(tp, widths, bf16)
        assert (smem, scratch) == (layout["smem_bytes"],
                                   layout["scratch_bytes"])
    eps = torch.tensor(0.5, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        state = core.reset_batch(rng.PRNGKey(4).to(dev), tp, num_envs)
        ts = fused_tick.to_tstate(state)
        obs0 = core.observe_batch(state, tp, 1).reshape(
            num_envs, -1).t().contiguous()
        obs = torch.zeros((widths[0], 3 * num_envs), dtype=dtype,
                          device=dev)
        obs[:, :num_envs] = obs0.to(dtype)
        key = rng.PRNGKey(5)
        for t in range(3):
            key, step_key = rng.split(key, 2)
            if dtype == torch.bfloat16:
                read, write = (t % 3) * num_envs, ((t + 1) % 3) * num_envs
                obs_p = obs.clone()
                out_k = fused_tick.full_tick_fused_ring(
                    step_key, ts, obs, read, write, chain, eps, t == 1, tp)
                out_p = fused_tick.full_tick_ring_plain(
                    step_key, ts, obs_p, read, write, chain, eps, t == 1, tp,
                    actions_override=out_k[3])
                next_k, next_p = (o[:, write:write + num_envs]
                                  for o in (obs, obs_p))
                assert torch.equal(obs, obs_p) or torch.equal(
                    obs[:, read:read + num_envs],
                    obs_p[:, read:read + num_envs])
                obs_in = obs_p
            else:
                read, obs_in = 0, obs0
                out_k = fused_tick.full_tick_fused(
                    step_key, ts, obs0, chain, eps, t == 1, tp)
                out_p = fused_tick.full_tick_plain(
                    step_key, ts, obs0, chain, eps, t == 1, tp,
                    actions_override=out_k[3])
                next_k, next_p = out_k[4], out_p[4]
            for a, b in zip(out_k[0], out_p[0]):
                assert torch.equal(a, b), (dtype, t)
            assert torch.equal(out_k[1], out_p[1])
            assert torch.equal(out_k[2], out_p[2])
            diff = (next_k.float() - next_p.float()).abs().reshape(
                -1, 6, num_envs)
            assert float(diff[:, [0, 1, 2, 3, 5]].max()) == 0.0, (dtype, t)
            assert float(diff[:, 4].max()) <= CHARGE_ATOL, (dtype, t)
            act_p, q = fused_tick.plain_actions(
                rng.split_plain(step_key.to(dev), num_envs + 2)[num_envs],
                obs_in, read, chain, eps, tp, num_envs)
            differ = (out_k[3] != act_p).any(dim=0)
            assert not bool((differ & ~_near_tie(q)).any()), (dtype, t)
            ts = out_k[0]
            if dtype == torch.float32:
                obs0 = out_k[4]


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [9, 16])
def test_env_tick_kernel_global_on_card(grid):
    """B4 with the global observation against ``tick_plain``, 3 ticks of
    random actions at 100 envs: env outputs bitwise, charge within
    1.3e-7."""
    dev = _card()
    tp = EnvParams(grid_size=grid, n_drones=4, wrapper="global")
    ts = fused_tick.to_tstate(core.reset_batch(rng.PRNGKey(0).to(dev), tp,
                                               100))
    key = rng.PRNGKey(1)
    for t in range(3):
        key, act_key, step_key = rng.split(key, 3)
        actions = rng.randint(act_key.to(dev), (4, 100), 0, 5)
        out_k = fused_tick.tick_fused(step_key, ts, actions, tp)
        out_p = fused_tick.tick_plain(step_key, ts, actions, tp)
        for a, b in zip(out_k[0], out_p[0]):
            assert torch.equal(a, b), t
        assert torch.equal(out_k[1], out_p[1])
        assert torch.equal(out_k[2], out_p[2])
        diff = (out_k[3] - out_p[3]).abs().reshape(-1, 6, 100)
        assert tuple(out_k[3].shape) == (grid * grid * 6, 100)
        assert float(diff[:, [0, 1, 2, 3, 5]].max()) == 0.0, t
        assert float(diff[:, 4].max()) <= CHARGE_ATOL, t
        ts = out_k[0]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["default", "in_kernel_td", "conv_matmul",
                                  "collect2_fast_rng"])
def test_graphed_chunk_equals_eager_ticks_on_card(case, tmp_path):
    """The ring engine's chunk on the card (one CUDA graph replay a tick)
    against the eager tick from one carry: two chunks of 7 ticks with a
    train state saved and restored between them, every carry tensor and
    output bitwise; B1 and B2 (the default learner of a dense net on the
    same tick's batch, or in_kernel_td's) counted once a replayed tick.
    Also with a conv net's im2col chain rebuilt inside the graph (the
    autograd learner, no B2), and with 2 drones collected at 8 threefry
    rounds."""
    dev = _card()
    tp = EnvParams(**KW)
    in_kernel_td = case == "in_kernel_td"
    k = 2 if case == "collect2_fast_rng" else 1
    cfg = DQNConfig(hidden_layers=(16, 16), epsilon_decay_every=2,
                    target_update_interval=2, gamma=0.9,
                    **(dict(network_type="conv", conv_matmul=True)
                       if case == "conv_matmul" else {}))
    agent = DQN(cfg, tp, device=dev)
    cap = 2 * E

    def fresh(seed):
        return train.init_ring_carry(
            agent, tp, E, cap, rng.PRNGKey(seed), obs_dtype=torch.bfloat16,
            batch_size=8, in_kernel_td=in_kernel_td, collect_drones=k)

    chunk = train.build_chunk_ring(agent, tp, E, cap, 8, 3, k,
                                   in_kernel_td=in_kernel_td,
                                   rng_rounds=8 if k > 1 else 20)
    learner = case != "conv_matmul"
    assert chunk.tick.learner.startswith(
        train.IN_KERNEL_TD if in_kernel_td else train.KERNEL if learner
        else train.AUTOGRAD)
    carry = fresh(0)
    eager = copy.deepcopy(carry)
    launches = (fused_tick.full_tick_fused_ring.launches,
                learner_kernel.td_adam.launches)
    outs = []
    for _ in range(2):
        carry, out = chunk(carry, 7)
        outs.append(out)
        path = str(tmp_path / "state.safetensors")
        train_state_io.save(path, carry)
        carry = train_state_io.restore(path, fresh(1))
    # Every tick of the default path trains here (two ring slots).
    assert (fused_tick.full_tick_fused_ring.launches,
            learner_kernel.td_adam.launches) == (
        launches[0] + 14, launches[1] + 14 * learner)
    assert 0 < chunk.graphs <= 14 and chunk.capture_s > 0
    ref = []
    for _ in range(14):
        eager, out = chunk.tick(eager)
        ref.append(out)
    torch.cuda.synchronize()
    got, want = (train_state_io.leaves(c) for c in (carry, eager))
    assert got[1] == want[1] and set(got[0]) == set(want[0])
    for path, t in got[0].items():
        assert torch.equal(t, want[0][path]), path
    for i in range(3):
        assert torch.equal(torch.cat([o[i] for o in outs]),
                           torch.stack([o[i] for o in ref])), i


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["jnp", "full", "fused", "fused_conv"])
def test_engine_chunk_equals_eager_ticks_on_card(engine, tmp_path):
    """The jnp, full and fused engines' chunks on the card (one CUDA graph
    replay a tick, the replay's words read from device memory) against
    their eager ticks from one carry: two chunks of 7 ticks with a train
    state saved and restored between them, the replay wrapping, every
    carry tensor, its numbers and every output bitwise; B3 or B4 counted
    once a replayed tick, and B2, the default learner of a dense net,
    once a trained one; the jnp engine's step route on B5 (once a tick)
    and each replay's sample kernel once a trained tick. Also the fused
    engine with a conv net's own forward (cuDNN) and the autograd learner
    in the graph."""
    dev = _card()
    tp = EnvParams(**KW)
    conv = dict(network_type="conv") if engine == "fused_conv" else {}
    cfg = DQNConfig(hidden_layers=(16, 16), epsilon_decay_every=2,
                    target_update_interval=2, gamma=0.9, **conv)
    agent = DQN(cfg, tp, device=dev)
    if engine == "jnp":
        buf = replay.ReplayBuffer(64, 8, uniform_pushes=True)
        tick = train.build_train_step(agent, buf, tp, 4, 5)
        init, num_envs = train.init_jnp_carry, 4
        counter, sampler = step_kernel.step_batch_fused, draws.buffer_sample
        assert tick.env_step == train.KERNEL
    else:
        buf = replay.StreamReplay(3 * E, 8, stride=E)
        full = engine == "full"
        tick = (train.build_train_step_full if full else
                train.build_train_step_fused)(agent, buf, tp, E, 3)
        init, num_envs = train.init_stream_carry, E
        counter = fused_tick.full_tick_fused if full else fused_tick.tick_fused
        sampler = draws.stream_sample

    def fresh(seed):
        return init(agent, tp, num_envs, buf, rng.PRNGKey(seed))

    chunk = train.Chunk(tick)
    dense = engine != "fused_conv"
    assert (tick.learner == train.KERNEL) == dense
    carry = fresh(0)
    eager = copy.deepcopy(carry)
    launches, samples = counter.launches, sampler.launches
    steps = learner_kernel.td_adam.launches
    outs = []
    for _ in range(2):
        carry, out = chunk(carry, 7)
        outs.append(out)
        path = str(tmp_path / "state.safetensors")
        train_state_io.save(path, carry)
        carry = train_state_io.restore(path, fresh(1))
    assert counter.launches == launches + 14
    trained = int((torch.cat([o[2] for o in outs]) >= 0).sum())
    assert trained > 0
    assert learner_kernel.td_adam.launches == steps + trained * dense
    assert sampler.launches == samples + trained
    assert 0 < chunk.graphs <= 14 and chunk.capture_s > 0
    ref = []
    for _ in range(14):
        eager, out = tick(eager)
        ref.append(out)
    torch.cuda.synchronize()
    got, want = (train_state_io.leaves(c) for c in (carry, eager))
    assert got[1] == want[1] and set(got[0]) == set(want[0])
    for path, t in got[0].items():
        assert torch.equal(t, want[0][path]), path
    for i in range(3):
        assert torch.equal(torch.cat([o[i] for o in outs]),
                           torch.stack([o[i] for o in ref])), i


def _graphed_chunk(engine, dev):
    """A graphed ring or full engine chunk at E envs and its carry."""
    tp = EnvParams(**KW)
    cfg = DQNConfig(hidden_layers=(16, 16), epsilon_decay_every=2,
                    target_update_interval=2, gamma=0.9)
    agent = DQN(cfg, tp, device=dev)
    if engine == "ring":
        return (train.build_chunk_ring(agent, tp, E, 2 * E, 8, 3),
                train.init_ring_carry(agent, tp, E, 2 * E, rng.PRNGKey(0),
                                      obs_dtype=torch.bfloat16))
    buf = replay.StreamReplay(3 * E, 8, stride=E)
    return (train.Chunk(train.build_train_step_full(agent, buf, tp, E, 3)),
            train.init_stream_carry(agent, tp, E, buf, rng.PRNGKey(0)))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["ring", "full"])
def test_graphed_chunk_tallies_launches_once_a_chunk_on_card(engine):
    """After each graphed chunk every launch counter has grown by each
    signature's recorded launches times its replays in the chunk (the
    captures leave the counts as they were); the clock times the graphed
    phases, one capture a graph, and ``capture_s`` is its capture
    phase."""
    dev = _card()
    chunk, carry = _graphed_chunk(engine, dev)
    assert chunk.graphed
    for length in (7, 7, 9):
        _, sigs, _ = chunk.table(carry, length)
        before = chunk._launches()
        carry, _ = chunk(carry, length)
        recorded = chunk._graphs[2]
        want = [sum(recorded[sig][i] for sig in sigs)
                for i in range(len(train.Chunk.COUNTERS))]
        assert [a - b for a, b in zip(chunk._launches(), before)] == want
        assert sum(want) >= length
    clock = chunk.phase_ns()
    assert (clock["chunks"], clock["ticks"]) == (3, 23)
    # 9 ticks outgrow the output buffers: new graphs, captured again.
    assert clock["captures"] >= chunk.graphs > 0
    for phase in ("keys", "walk", "upload", "adopt", "capture", "replay",
                  "outputs"):
        assert clock[phase] > 0, phase
    assert "eager" not in clock
    assert chunk.capture_s == clock["capture"] / 1e9 > 0


@pytest.mark.gpu
def test_chunk_ranges_stay_on_the_host_on_card():
    """Under ``torch.profiler`` (host and card) a graphed chunk opens one
    range for its key table and one for its walk on the host, and the
    card's timeline holds no range of the chunk's: they launch
    nothing."""
    dev = _card()
    chunk, carry = _graphed_chunk("ring", dev)
    carry, _ = chunk(carry, 7)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        carry, _ = chunk(carry, 7)
        torch.cuda.synchronize()
    host = [ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CPU
            and ev.name.startswith("phase:")]
    card = [ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert sorted(host) == ["phase:chunk.keys", "phase:chunk.walk"]
    assert card and not [n for n in card if n.startswith("phase:")]


@pytest.mark.gpu
@pytest.mark.parametrize("local", ["ring", "full", "fused", "jnp"])
def test_sharded_chunk_equals_eager_ticks_on_card(local):
    """A world-1 NCCL ``DistributedTrainer``'s chunk on the card (one CUDA
    graph replay a tick, its gradient all-reduce captured inside) against
    the trainer's eager ticks from one carry: two chunks of 7 ticks, every
    carry tensor, its numbers and every output bitwise; B1, B3, B4 or
    (the jnp engine's step route) B5 counted once a replayed tick; one
    all-reduce a trained tick."""
    from dronerl_tpu_torch.agents import dqn as dqn_mod
    from dronerl_tpu_torch.parallel import mesh as mesh_mod
    from dronerl_tpu_torch.parallel.distributed import DistributedTrainer

    _card()
    tp = EnvParams(**KW)
    conv = dict(network_type="conv") if local == "fused" else {}
    cfg = DQNConfig(hidden_layers=(16, 16), epsilon_decay_every=2,
                    target_update_interval=2, gamma=0.9, **conv)
    engine = {"ring": "ring", "jnp": "jnp"}.get(local, "fused")
    num_envs = 4 if local == "jnp" else E
    counter = {"ring": fused_tick.full_tick_fused_ring,
               "full": fused_tick.full_tick_fused,
               "fused": fused_tick.tick_fused,
               "jnp": step_kernel.step_batch_fused}[local]
    mesh = mesh_mod.make_env_mesh(device="cuda")
    try:
        agent = DQN(cfg, tp, device=mesh.device)
        trainer = DistributedTrainer(
            agent, tp, mesh, num_envs=num_envs,
            buffer_capacity_per_shard=3 * num_envs, batch_size_per_shard=8,
            reset_env_every=3, engine=engine)
        assert trainer.local_engine == local
        chunk = trainer.build_chunk(7)
        assert chunk.chunk.graphed
        carry = trainer.init_carry(rng.PRNGKey(0))
        eager = copy.deepcopy(carry)
        launches = counter.launches
        calls = dqn_mod.all_reduce_mean.calls
        outs = []
        for _ in range(2):
            carry, out = chunk(carry)
            outs.append(out)
        torch.cuda.synchronize()
        calls = dqn_mod.all_reduce_mean.calls - calls
        assert counter.launches == launches + 14
        assert 0 < chunk.chunk.graphs <= 14
        tick, ref = trainer.build_tick(), []
        for _ in range(14):
            eager, out = tick(eager)
            ref.append(out)
        torch.cuda.synchronize()
    finally:
        torch.distributed.destroy_process_group()
    losses = torch.cat([o[1] for o in outs])
    assert calls == int((losses >= 0).sum()) > 0
    got, want = (train_state_io.leaves(c) for c in (carry, eager))
    assert got[1] == want[1] and set(got[0]) == set(want[0])
    for path, t in got[0].items():
        assert torch.equal(t, want[0][path]), path
    assert torch.equal(torch.cat([o[0] for o in outs]),
                       torch.stack([o[0] for o in ref]))
    assert torch.equal(losses, torch.stack([o[2] for o in ref]))


# --- the draw kernel and the ring sample kernel (csrc/draws.cu) --------------

def _draw_keys(dev):
    """A lone key, a stack of keys and a strided view of split children
    (the env core's ``ks[..., 0, :]``), on the card."""
    keys = rng.split_plain(rng.PRNGKey(17).to(dev), 6)
    return (rng.PRNGKey(5).to(dev), keys,
            rng.split_plain(keys.reshape(2, 3, 2), 2)[..., 1, :])


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", rng.ROUNDS)
@pytest.mark.parametrize("mode", ["split", "bits", "uniform", "randint"])
def test_draw_kernel_matches_plain_on_card(mode, rounds):
    """Each draw of a CUDA key, one launch, bitwise to its plain version
    on the same key, at every round count: lone, stacked and strided
    keys, 1 to 65,537 counters; randint with a host bound, a bound below
    minval and a device bound."""
    dev = _card()
    for key in _draw_keys(dev):
        for n in (1, 100, 65537):
            before = draws.draw.launches
            if mode == "split":
                got = rng.split(key, n, rounds)
                want = rng.split_plain(key, n, rounds)
            elif mode == "bits":
                got = rng.random_bits(key, (n,), rounds)
                want = rng.random_bits_plain(key, (n,), rounds)
            elif mode == "uniform":
                got = rng.uniform(key, (n,), rounds).view(torch.int32)
                want = rng.uniform_plain(key, (n,), rounds).view(torch.int32)
            else:
                for lo, hi in ((0, 7), (-5, 2 ** 31 - 1), (3, 1),
                               (0, torch.tensor(65536, device=dev))):
                    got = rng.randint(key, (n,), lo, hi, rounds)
                    want = rng.randint_plain(key, (n,), lo, hi, rounds)
                    assert got.dtype == want.dtype and torch.equal(
                        got, want), (lo, hi, n)
                assert draws.draw.launches == before + 4
                continue
            assert draws.draw.launches == before + 1
            assert got.dtype == want.dtype and torch.equal(got, want), n


@pytest.mark.gpu
def test_randint_device_bound_in_graph_on_card():
    """randint with its key and bound read by pointer inside a captured
    CUDA graph: a replay after the key's row and the bound change draws
    the new words, bitwise to the plain version."""
    dev = _card()
    row = torch.tensor([0, 7, 1000], dtype=torch.int32, device=dev)

    def step():
        key = row[:2].to(torch.int64) & rng.MASK32
        return rng.randint(key, (8,), 0, row[2])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for words in ([0, 7, 1000], [123, 456, 3], [2 ** 31 - 1, 9, 65537]):
        row.copy_(torch.tensor(words, dtype=torch.int32))
        graph.replay()
        want = rng.randint_plain(rng.PRNGKey(0).new_tensor(words[:2]).to(dev),
                                 (8,), 0, words[2])
        assert torch.equal(out, want), words


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 4])
def test_ring_sample_kernel_matches_plain_on_card(k, dtype):
    """The ring sample kernel, keyed (the graphed tick) and from host
    offsets (the eager tick), bitwise to ring_gather_batch_plain at the
    bench's ring (294 rows, 65,536 envs, 131,072 columns, batch 8) for one
    drone and four, the base slot wrapping."""
    dev = _card()
    num_envs, capacity, obs_dim = 65536, 131072, 294
    gen = torch.Generator().manual_seed(k)
    ring = torch.randn((k * obs_dim, capacity), generator=gen).to(dev, dtype)
    shape = (capacity,) if k == 1 else (k, capacity)
    a_ring = torch.randint(0, 5, shape, generator=gen,
                           dtype=torch.int32).to(dev)
    r_ring = torch.randn(shape, generator=gen).to(dev)
    d_ring = torch.randint(0, 2, shape, generator=gen,
                           dtype=torch.int8).to(dev)
    common = dict(num_envs=num_envs, capacity=capacity, batch_size=8 * k,
                  collect=k, obs_dim=obs_dim)
    for seed, valid, base in ((1, num_envs, 1), (2, 1, 0), (3, 0, 0)):
        key = rng.PRNGKey(seed)
        want = fused_tick.ring_gather_batch_plain(
            key, ring, a_ring, r_ring, d_ring, valid, base, **common)
        before = draws.ring_sample.launches
        keyed = fused_tick.ring_gather_batch(
            key.to(dev), ring, a_ring, r_ring, d_ring, valid, base, **common)
        hosted = fused_tick.ring_gather_batch(
            key, ring, a_ring, r_ring, d_ring, valid, base, **common)
        assert draws.ring_sample.launches == before + 2
        for name in want:
            assert torch.equal(keyed[name], want[name]), (seed, name)
            assert torch.equal(hosted[name], want[name]), (seed, name)


def _replay_storage(dev, capacity, obs_dim, seed, rows):
    """Random transitions on the card: obs (and next_obs) (capacity,
    obs_dim) rows or (obs_dim, capacity) columns, actions, rewards,
    dones."""
    gen = torch.Generator().manual_seed(seed)
    shape = (capacity, obs_dim) if rows else (obs_dim, capacity)
    storage = {"obs": torch.randn(shape, generator=gen).to(dev),
               "actions": torch.randint(0, 5, (capacity,), generator=gen,
                                        dtype=torch.int32).to(dev),
               "rewards": torch.randn((capacity,), generator=gen).to(dev),
               "dones": (torch.rand((capacity,), generator=gen)
                         < 0.3).to(dev)}
    if rows:
        storage["next_obs"] = torch.randn(shape, generator=gen).to(dev)
    return storage


def _words(dev, *values):
    return [torch.tensor(v, dtype=torch.int32, device=dev) for v in values]


@pytest.mark.gpu
def test_stream_sample_kernel_matches_plain_on_card():
    """The StreamReplay's sample in one launch, keyed with the bound and
    base as device words (the graphed tick), keyed with host ints and from
    host offsets (the eager tick), bitwise to ``sample_batch_plain`` at
    the full engine's shapes (294 rows, stride 65,536, 5 env-batches,
    batch 8): cold, filling, and full with the base at the cursor (the
    successor wrapping)."""
    dev = _card()
    stride, obs_dim = 65536, 294
    buf = replay.StreamReplay(5 * stride, 8, stride)
    storage = _replay_storage(dev, buf.capacity, obs_dim, 1, rows=False)
    for seed, (cursor, size) in enumerate(((stride, stride),
                                           (3 * stride, 3 * stride),
                                           (2 * stride, 5 * stride))):
        state = replay.ReplayState(storage, cursor, size)
        bound = max(size - stride, 1)
        base = cursor if size == buf.capacity else 0
        key = rng.PRNGKey(seed)
        want = buf.sample_batch_plain(key, state)
        before = draws.stream_sample.launches
        got = [buf.sample_batch(key.to(dev), state, *_words(dev, bound,
                                                            base)),
               buf.sample_batch(key.to(dev), state, bound, base),
               buf.sample_batch(key, state)]
        assert draws.stream_sample.launches == before + 3
        for i, batch in enumerate(got):
            assert set(batch) == set(want)
            for name in want:
                assert torch.equal(batch[name], want[name]), (seed, i, name)


@pytest.mark.gpu
@pytest.mark.parametrize("feature_major", [True, False])
def test_buffer_sample_kernel_matches_plain_on_card(feature_major):
    """The row-major ReplayBuffer's sample in one launch, feature-major
    (the learner kernel's batch) and row-major, keyed with the bound as a
    device word, keyed with a host bound and from host offsets, bitwise to
    ``sample_batch_plain`` at the CLI's replay (100,000 transitions of 294
    features, batch 8), cold and full."""
    dev = _card()
    buf = replay.ReplayBuffer(100_000, 8, uniform_pushes=True)
    storage = _replay_storage(dev, buf.capacity, 294, 2, rows=True)
    for seed, size in enumerate((9, buf.capacity)):
        state = replay.ReplayState(storage, size % buf.capacity, size)
        key = rng.PRNGKey(seed)
        want = buf.sample_batch_plain(key, state,
                                      feature_major=feature_major)
        before = draws.buffer_sample.launches
        got = [buf.sample_batch(key.to(dev), state, _words(dev, size)[0],
                                feature_major),
               buf.sample_batch(key.to(dev), state, None, feature_major),
               buf.sample_batch(key, state, None, feature_major)]
        assert draws.buffer_sample.launches == before + 3
        for i, batch in enumerate(got):
            assert set(batch) == set(want)
            for name in want:
                assert torch.equal(batch[name], want[name]), (seed, i, name)


@pytest.mark.gpu
def test_draw_library_failure_raises_on_card(monkeypatch):
    """A CUDA key whose draw library does not load raises; nothing falls
    back to the plain version, and no launch is counted."""
    dev = _card()

    def refuse(config):
        raise OSError(f"cannot load {config}")

    monkeypatch.setattr(_build, "load", refuse)
    before = draws.draw.launches
    for call in (lambda k: rng.split(k, 3), lambda k: rng.uniform(k, (4,)),
                 lambda k: rng.randint(k, (4,), 0, 5)):
        with pytest.raises(OSError):
            call(rng.PRNGKey(1).to(dev))
    assert draws.draw.launches == before


@pytest.mark.gpu
def test_plain_draws_launch_nothing_on_card(monkeypatch):
    """Inside ``plain_draws`` (the kernels' plain versions) a CUDA key's
    draws run as tensor ops with the draw library refused: no launch,
    the plain versions' words."""
    dev = _card()

    def refuse(config):
        raise OSError(f"cannot load {config}")

    monkeypatch.setattr(_build, "load", refuse)
    key = rng.PRNGKey(1).to(dev)
    before = draws.draw.launches
    with rng.plain_draws():
        got = (rng.split(key, 3), rng.uniform(key, (4,)).view(torch.int32),
               rng.randint(key, (4,), 0, 5))
    u, _ = fused_tick.actor_uniforms(key, 4, 16)
    assert draws.draw.launches == before
    want = (rng.split_plain(key, 3),
            rng.uniform_plain(key, (4,)).view(torch.int32),
            rng.randint_plain(key, (4,), 0, 5))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(u.view(torch.int32),
                       rng.uniform_plain(key, (5, 16)).view(torch.int32))
