"""The reference's conv Q-net (``reference/nets/conv.py``) against the
program's on the CPU, on seeded random weights and observations: its
initial nets against the CLI's own draw, its forward against the
program's two routes, and one TD step's gradients and Adam update against
the program's autograd learner (the route the conv cell trains on)."""

import math

import pytest
import torch

from portbench import engines, run
from portbench.reference import env as ref_env, threefry, trainer
from portbench.reference.nets import conv
from portbench.tests.conftest import tiny_cell

WORKLOAD = "conv8d16.ring.e65536"
BATCH = 8


def _agent(flags):
    from dronerl_tpu_torch import train
    from dronerl_tpu_torch.agents.dqn import DQN

    args = train.parse_args(run.cli_argv(flags) + ["--device", "cpu"])
    return DQN(train.agent_config_from_args(args),
               train.env_params_from_args(args), device="cpu")


def _obs(n, seed):
    # Observations as the env makes them: 0/1 channels and a charge share.
    g = torch.Generator().manual_seed(seed)
    obs = (torch.rand(294, n, generator=g) < 0.3).float()
    obs[5::6] = torch.randint(0, 101, (49, n), generator=g).float() / 100
    return obs


def _program_net(agent, leaves):
    net = agent.make_net()
    with torch.no_grad():
        for p, leaf in zip(net.flat(), leaves):
            p.copy_(leaf)
    return net


@pytest.mark.parametrize("seed", [3, 2**31 + 977])
def test_init_is_the_cli_draw_bit_for_bit(seed):
    cell = tiny_cell(WORKLOAD)
    _, _, carry = run.build(cell, seed, "cpu")
    online, target, _, _ = engines.learner(carry)
    key = threefry.prng_key(run.cli_seed(seed))
    want = conv.init(key, 294, cell.flags)
    want_target = conv.init(threefry.split(key, 2)[1], 294, cell.flags)
    assert [tuple(t.shape) for t in want] == [
        (8, 6, 3, 3), (8,), (392, 16), (16,), (16, 5), (5,)]
    for got, ref in zip([*online, *target], [*want, *want_target],
                        strict=True):
        assert torch.equal(got.detach(), ref)


def test_forward_agrees_with_both_program_routes():
    from dronerl_tpu_torch.agents.dqn import chain_forward_t
    from dronerl_tpu_torch.ops import conv2mat

    flags = run.load_cell(WORKLOAD).flags
    agent = _agent(flags)
    leaves = conv.init(threefry.prng_key(17), 294, flags)
    # Random biases, so that the flatten order and the bias layout show.
    g = torch.Generator().manual_seed(5)
    leaves = [t if t.dim() > 1 else torch.randn(t.shape, generator=g) * 0.1
              for t in leaves]
    net = _program_net(agent, leaves)
    obs = _obs(256, 7)
    want = conv.forward_t(leaves, obs, torch.matmul, flags)
    assert want.shape == (5, 256)
    # f32 sums in other orders: a conv output sums 54 products, a hidden
    # unit 392 and an action 16, each of magnitude under max |Q|; so every
    # route lands within a few hundred ulps of max |Q|, and 1e-5 of it
    # leaves room (TF32's operands alone part them by about 1e-3).
    atol = 1e-5 * float(want.abs().max())
    with torch.no_grad():
        module = net.forward(obs.t()).t()
        chain = chain_forward_t(conv2mat.effective_dense_params(
            net, agent.net_spec), obs)
    torch.testing.assert_close(module, want, rtol=0, atol=atol)
    torch.testing.assert_close(chain, want, rtol=0, atol=atol)
    # And the control's TF32 products do part them.
    tf32 = conv.forward_t(leaves, obs, trainer.matmul_for(
        trainer.Variant(tf32=True)), flags)
    assert float((tf32 - want).abs().max()) > 10 * atol


def test_td_step_agrees_with_the_autograd_learner():
    flags = run.load_cell(WORKLOAD).flags
    agent = _agent(flags)
    key = threefry.prng_key(23)
    state = agent.init_state(key)
    p = ref_env.Params.from_flags(flags)
    learner = trainer.Learner.from_seed(key, p, flags, "cpu",
                                        trainer.Variant())
    g = torch.Generator().manual_seed(9)
    batch = {"obs": _obs(BATCH, 1), "next_obs": _obs(BATCH, 2),
             "actions": torch.randint(0, 5, (BATCH,), generator=g),
             "rewards": torch.randn(BATCH, generator=g),
             "dones": (torch.rand(BATCH, generator=g) < 0.3).float()}
    before = [t.detach().clone() for t in state.params.flat()]
    state, loss = agent.train_step_t(state, dict(batch))
    with trainer.exact_f32():
        want_loss = learner.train(dict(batch))
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    # The gradient as Adam got it (its first moment after one step is 0.1
    # g): within 1e-5 of each leaf's norm, f32 sums in another order.
    for mu, ref in zip(state.opt_state.mu, learner.first_grads, strict=True):
        scale = float(ref.norm())
        torch.testing.assert_close(mu / 0.1, ref, rtol=0,
                                   atol=1e-5 * scale + 1e-12)
    # Adam's first step moves each weight by lr x g / (|g| + eps): a step
    # is at most lr (1e-3), and a gradient that differs by rounding moves
    # it by far less than a thousandth of that, except where |g| is near
    # eps (1e-8), which no element here comes near.
    lr = flags["learning_rate"]
    for b, after, ref in zip(before, state.params.flat(), learner.params,
                             strict=True):
        torch.testing.assert_close(after.detach() - b, ref - b, rtol=0,
                                   atol=lr * 1e-3)
    assert all(float((r - b).abs().max()) > 0.5 * lr
               for b, r in zip(before, learner.params))
    assert math.isfinite(float(loss))
