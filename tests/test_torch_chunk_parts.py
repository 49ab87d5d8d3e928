"""The pieces the ring engine's chunk rests on, on the CPU.

The replay sample's indices drawn from a device key (``rng``'s tensor
path, as on the card) against the host draw, bitwise; the autograd
learner's Adam step with its bias corrections as 0-d tensors against the
same step with the Python floats, bitwise; the tick's static signatures
over the bench's schedule; the per-tick row of words; and the chunk's
outputs on the CPU. No JAX here.
"""

import numpy as np
import pytest
import torch

from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.agents.dqn import (
    ADAM_B1, ADAM_B2, ADAM_EPS, DQN, DQNConfig, adam_bias_corrections)
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops import fused_tick

TP = EnvParams(grid_size=9, n_drones=4)
# The ring tick's row: the step and sample keys, the Adam count, the bias
# corrections and the tick's index.
RING_ROW = train.RowLayout(2)


@pytest.mark.parametrize("shape,span", [((8,), 128), ((8,), 65536),
                                        ((2, 4), 131072), ((64,), 3)])
def test_device_draw_equals_host_draw(shape, span, monkeypatch):
    """``rng.randint`` on a host key hashes Python ints; with the host
    path off (``_HOST_COUNTS`` 0) it hashes with tensor ops, as a key on
    the card does. Same words, bitwise, for the replay sample's shapes
    and spans."""
    for seed in range(5):
        key = rng.split(rng.PRNGKey(seed), 3)[2]
        host = rng.randint(key, shape, 0, span)
        with monkeypatch.context() as m:
            m.setattr(rng, "_HOST_COUNTS", 0)
            device = rng.randint(key, shape, 0, span)
        assert torch.equal(host, device), seed
        assert int(host.min()) >= 0 and int(host.max()) < span


@pytest.mark.parametrize("collect", [1, 2])
def test_ring_gather_draws_the_host_indices(collect):
    """The gather's batch is the ring's columns at the indices the host
    draw gives (``jax.random.randint`` over the valid columns, from the
    base slot, next_obs one env-batch later), for a host key drawn on
    Python ints and for the same key as int64 words derived from a row of
    int32 words, drawn with tensor ops as on the card."""
    num_envs, capacity, batch = 128, 512, 8
    g = torch.Generator().manual_seed(0)
    rows = 294 * collect
    ring = torch.rand((rows, capacity), generator=g).to(torch.bfloat16)
    shape = (capacity,) if collect == 1 else (collect, capacity)
    a_ring = torch.randint(0, 5, shape, generator=g, dtype=torch.int32)
    r_ring = torch.rand(shape, generator=g)
    d_ring = torch.randint(0, 2, shape, generator=g).to(torch.int8)
    key = rng.split(rng.PRNGKey(4), 3)[2]
    valid, base = 3 * num_envs, 2
    kw = dict(num_envs=num_envs, capacity=capacity, batch_size=batch,
              collect=collect, obs_dim=294)
    draw = (batch,) if collect == 1 else (collect, batch // collect)
    raw = rng.randint(key, draw, 0, valid).long().reshape(-1)
    phys = (base * num_envs + raw) % capacity
    drone = torch.arange(batch) // (batch // collect)
    want_obs = torch.stack([ring[d * 294:(d + 1) * 294, c]
                            for d, c in zip(drone, phys)], dim=1).float()
    want_next = torch.stack([ring[d * 294:(d + 1) * 294,
                                  (c + num_envs) % capacity]
                             for d, c in zip(drone, phys)], dim=1).float()
    pick = (phys,) if collect == 1 else (drone, phys)
    words = torch.tensor(RING_ROW.make(torch.stack([key, key]), 0, 0))
    row_key = (words[:2].to(torch.int64) & rng.MASK32)
    assert torch.equal(row_key, key)
    for k, host_counts in ((key, rng._HOST_COUNTS), (row_key, 0)):
        with pytest.MonkeyPatch.context() as m:  # 0: the card's tensor ops
            m.setattr(rng, "_HOST_COUNTS", host_counts)
            got = fused_tick.ring_gather_batch(k, ring, a_ring, r_ring,
                                               d_ring, valid, base, **kw)
        assert torch.equal(got["obs"], want_obs)
        assert torch.equal(got["next_obs"], want_next)
        assert torch.equal(got["actions"], a_ring[pick])
        assert torch.equal(got["rewards"], r_ring[pick])
        assert torch.equal(got["dones"], d_ring[pick].float())


def test_foreach_div_by_a_tensor_equals_the_float():
    """Adam's divisions by the bias corrections on the CPU: a 0-d f32
    tensor gives the bits the Python float gives, for the corrections of
    counts 1 to 200. (On a card they differ for some counts:
    ``scripts/torch_tick_parting.py --foreach_check``.)"""
    g = torch.Generator().manual_seed(1)
    xs = [torch.randn((294, 16), generator=g),
          torch.rand((16,), generator=g) * 1e-6,
          torch.randn((5,), generator=g) * 1e3]
    for count in range(1, 201):
        for bc in adam_bias_corrections(count):
            by_float = torch._foreach_div(xs, bc)
            by_tensor = torch._foreach_div(xs, torch.tensor(
                bc, dtype=torch.float32))
            for a, b in zip(by_float, by_tensor):
                assert torch.equal(a, b), count


def test_td_step_with_tensor_corrections_equals_the_floats():
    """``DQN.train_step_t`` with the corrections from a row (the chunk's
    path) against the Adam step written out with the Python floats (the
    path before the chunk), over 5 steps: loss, params and moments
    bitwise."""
    agent = DQN(DQNConfig(hidden_layers=(16, 16), gamma=0.9), TP,
                device="cpu")
    st = agent.init_state(rng.PRNGKey(0))
    ref = agent.init_state(rng.PRNGKey(0))
    g = torch.Generator().manual_seed(2)
    for step in range(5):
        both = (torch.rand((294, 16), generator=g) < 0.3).float()
        batch = {"obs": both[:, :8], "next_obs": both[:, 8:],
                 "actions": torch.randint(0, 5, (8,), generator=g,
                                          dtype=torch.int32),
                 "rewards": torch.randn((8,), generator=g),
                 "dones": (torch.rand((8,), generator=g) < 0.2).float()}
        words = torch.tensor(RING_ROW.make(
            torch.stack([rng.PRNGKey(0), rng.PRNGKey(1)]),
            st.opt_state.count, step))
        st, loss = agent.train_step_t(
            st, batch, corrections=RING_ROW.bias_corrections(words))
        ref_loss = _float_adam_step(agent, ref, batch)
        assert torch.equal(loss, ref_loss), step
        for a, b in zip(st.params.flat() + st.opt_state.mu + st.opt_state.nu,
                        ref.params.flat() + ref.opt_state.mu
                        + ref.opt_state.nu):
            assert torch.equal(a, b), step
        assert st.opt_state.count == ref.opt_state.count == step + 1


def _float_adam_step(agent, state, batch):
    """The TD step with optax's bias corrections as Python floats, each op
    in the order of ``DQN._td_step``."""
    params = state.params.flat()
    with torch.no_grad():
        bootstrap = agent.q_values_t(state.target_params,
                                     batch["next_obs"]).max(dim=0).values
        target = batch["rewards"] + agent.config.gamma * bootstrap * (
            1 - batch["dones"])
    with torch.enable_grad():
        q = agent.q_values_t(state.params, batch["obs"])
        taken = q.gather(0, batch["actions"].long()[None])[0]
        loss = torch.mean(torch.square(taken - target))
        grads = torch.autograd.grad(loss, params)
    adam = state.opt_state
    adam.count += 1
    bc1, bc2 = adam_bias_corrections(adam.count)
    with torch.no_grad():
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - ADAM_B1),
                                torch._foreach_mul(adam.mu, ADAM_B1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads),
                               1 - ADAM_B2),
            torch._foreach_mul(adam.nu, ADAM_B2))
        torch._foreach_copy_(adam.mu, mu)
        torch._foreach_copy_(adam.nu, nu)
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, bc2)), ADAM_EPS)
        update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(params, torch._foreach_mul(
            update, -agent.config.learning_rate))
    return loss.detach()


def _bench_tick(num_envs, capacity, in_kernel_td):
    agent = DQN(DQNConfig(hidden_layers=(16, 16), epsilon_decay_every=5,
                          target_update_interval=10, gamma=0.9), TP,
                device="cpu")
    return train.build_train_step_ring(agent, TP, num_envs, capacity, 8,
                                       100, in_kernel_td=in_kernel_td)


@pytest.mark.parametrize("in_kernel_td", [False, True],
                         ids=["default", "in_kernel_td"])
def test_signatures_of_the_bench_schedule(in_kernel_td):
    """The bench's schedule (65,536 envs, a ring of 2 env-batches, a reset
    every 100 ticks, sync every 10, decay every 5): over 200 ticks the
    signatures are the slot's two values by the sync and decay pattern,
    the reset, and on ``in_kernel_td`` tick 0, which does not train: 5 or
    6 graphs. With a ring of 4 env-batches (the CLI's nb <= 4) no more
    than 20."""
    tick = _bench_tick(65536, 131072, in_kernel_td)
    sigs = {tick.signature(step) for step in range(200)}
    S = train.RingSignature
    want = {S(0, 1, False, False, False, True),
            S(1, 1, False, False, False, True),
            S(1, 1, False, False, True, True),
            S(0, 1, False, True, True, True),
            S(0, 1, True, True, True, True)}
    if in_kernel_td:
        want.add(S(0, 1, True, True, True, False))
    assert sigs == want
    for step in range(200):  # a signature fixes the tick's host values
        sig = tick.signature(step)
        assert (sig.slot, sig.reset) == (step % 2, step % 100 == 0)
        assert (sig.sync, sig.decay) == (step % 10 == 0, step % 5 == 0)
    wide = _bench_tick(32768, 131072, in_kernel_td)
    assert len({wide.signature(step) for step in range(200)}) <= 20


def test_row_words():
    """A row holds the two keys' words, the count, the bias corrections of
    the count after the step (f32 bits) and the tick's index; a count the
    kernel's int32 cannot hold is refused."""
    step_key = torch.tensor([0xFFFFFFFF, 7], dtype=torch.int64)
    sample_key = torch.tensor([1 << 31, 0], dtype=torch.int64)
    keys = torch.stack([step_key, sample_key])
    row = RING_ROW.make(keys, 41, 3)
    assert row.dtype == np.int32 and row.shape == (RING_ROW.words,) == (8,)
    words = row.view(np.uint32)
    assert list(words[0:2]) == [0xFFFFFFFF, 7]
    assert list(words[2:4]) == [1 << 31, 0]
    assert (RING_ROW.count, RING_ROW.corrections, RING_ROW.tick) == (
        4, slice(5, 7), 7)
    assert row[RING_ROW.count] == 41 and row[RING_ROW.tick] == 3
    assert tuple(row[RING_ROW.corrections].view(np.float32)) == (
        adam_bias_corrections(42))
    assert torch.equal(RING_ROW.host_key(row, 1), sample_key)
    for got, want in zip(RING_ROW.keys(torch.from_numpy(row)), keys):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="out of int32"):
        RING_ROW.make(keys, 2**31 - 1, 0)


def test_chunk_on_the_cpu_outputs_and_numbers():
    """On the CPU the chunk runs its ticks eagerly and captures nothing;
    its outputs are (length, ...) tensors and its carry's step and Adam
    count come from the chain."""
    agent = DQN(DQNConfig(hidden_layers=(8,)), TP, device="cpu")
    chunk = train.build_chunk_ring(agent, TP, 128, 256, 8, 3)
    carry = train.init_ring_carry(agent, TP, 128, 256, rng.PRNGKey(0))
    carry, (rewards, eps, loss) = chunk(carry, 3)
    assert rewards.shape == (3, 128) and eps.shape == loss.shape == (3,)
    assert carry[-1] == 3 and carry[3].opt_state.count == 3
    assert chunk.graphs == 0 and chunk.capture_s == 0.0
