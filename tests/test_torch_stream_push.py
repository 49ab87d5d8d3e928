"""The full engine's StreamReplay push inside B3 (``full_tick_fused``'s
``replay``), on the plain path: the tick's transitions pushed as
``StreamReplay.push_many`` of ``replay.stream_push_batch`` pushed them,
the next observation written over the input ``obs_t``, and the push
counter (``full_tick_fused.pushes``) in a chunk's tallies.

No JAX here; the card's side is ``tests/test_torch_kernel.py``'s
``full_tick_push`` tests.
"""

import copy

import pytest
import torch

from dronerl_tpu_torch import replay, rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops import fused_tick

E = 128
TP = EnvParams(grid_size=9, n_drones=4)


def _agent():
    cfg = DQNConfig(hidden_layers=(16, 16), epsilon_decay_every=2,
                    target_update_interval=2)
    return DQN(cfg, TP, device="cpu")


@pytest.mark.parametrize("k", [1, 2])
def test_full_tick_plain_pushes_and_writes_obs_in_place(k):
    """``full_tick_fused`` with a replay on CPU tensors: the outputs of the
    call without one, the replay's storage as ``push_many_t`` of the
    tick's transitions at the start leaves it, and the next observation
    in the input ``obs_t``, which is returned."""
    agent = _agent()
    chain = agent.init_state(rng.PRNGKey(0)).params.flat()
    state = core.reset_batch(rng.PRNGKey(1), TP, E)
    obs_t = train._stacked_obs(state, TP, k)
    ts = fused_tick.to_tstate(core.reset_batch(rng.PRNGKey(2), TP, E))
    eps = torch.tensor(0.5)
    buf = replay.StreamReplay(3 * k * E, 8, stride=k * E)
    gen = torch.Generator().manual_seed(0)
    bstate = buf.init({"obs": torch.zeros(294), "actions":
                       torch.zeros((), dtype=torch.int32),
                       "rewards": torch.zeros(()),
                       "dones": torch.zeros((), dtype=torch.bool)})
    bstate.storage["obs"].copy_(torch.rand(bstate.storage["obs"].shape,
                                           generator=gen))
    want_storage = {n: t.clone() for n, t in bstate.storage.items()}
    obs_in = obs_t.clone()
    pushes = fused_tick.full_tick_fused.pushes
    want = fused_tick.full_tick_fused(rng.PRNGKey(3), ts, obs_t, chain, eps,
                                      True, TP, k)
    assert torch.equal(obs_t, obs_in)
    buf.push_many(replay.ReplayState(want_storage, 0, 0),
                  replay.stream_push_batch(obs_in, want[3], want[1],
                                           want[2], k), start=k * E)
    got = fused_tick.full_tick_fused(rng.PRNGKey(3), ts, obs_t, chain, eps,
                                     True, TP, k,
                                     replay=(bstate.storage, k * E))
    assert fused_tick.full_tick_fused.pushes == pushes + 1
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for i in (1, 2, 3):
        assert torch.equal(got[i], want[i]), i
    assert got[4] is obs_t and torch.equal(obs_t, want[4])
    for name, t in bstate.storage.items():
        assert torch.equal(t, want_storage[name]), name


@pytest.mark.parametrize("k", [1, 2])
def test_full_engine_push_matches_push_many(k, monkeypatch):
    """Eight eager ticks of the full engine (a reset every 3, the replay of
    three pushes wrapping twice) against ``full_tick_plain`` without a
    replay on each tick's inputs followed by ``StreamReplay.push_many``
    at the replay's own cursor: the storage, cursor, size and next
    observation the same, bitwise; the carry's ``obs_t`` written in
    place, one push a tick."""
    agent = _agent()
    buf = replay.StreamReplay(3 * k * E, 8, stride=k * E)
    tick = train.build_train_step_full(agent, buf, TP, E, 3, k)
    carry = train.init_stream_carry(agent, TP, E, buf, rng.PRNGKey(0), k)
    ref = replay.ReplayState({n: t.clone() for n, t in
                              carry[4].storage.items()}, 0, 0)
    calls = []
    tick_fn = fused_tick.full_tick_fused

    def recording(step_key, tstate, obs_t, chain, epsilon, do_reset, *args,
                  **kwargs):
        calls.append((step_key.clone(), tstate, obs_t.clone(),
                      [c.clone() for c in chain], epsilon.clone(), do_reset))
        return tick_fn(step_key, tstate, obs_t, chain, epsilon, do_reset,
                       *args, **kwargs)

    # The wrapper counts under the name the tick calls (the module's).
    recording.__dict__.update(tick_fn.__dict__)
    monkeypatch.setattr(fused_tick, "full_tick_fused", recording)
    pushes = recording.pushes
    for t in range(8):
        obs_t = carry[2]
        carry, _ = tick(carry)
        assert carry[2] is obs_t
        step_key, tstate, obs_in, chain, epsilon, do_reset = calls[-1]
        want = fused_tick.full_tick_plain(step_key, tstate, obs_in, chain,
                                          epsilon, do_reset, TP,
                                          collect=k)
        ref = buf.push_many(ref, replay.stream_push_batch(
            obs_in, want[3], want[1], want[2], k))
        bstate = carry[4]
        assert (bstate.cursor, bstate.size) == (ref.cursor, ref.size), t
        for name, t_ in bstate.storage.items():
            assert torch.equal(t_, ref.storage[name]), (t, name)
        assert torch.equal(carry[2], want[4]), t
    assert len(calls) == 8 and ref.cursor == 2 * k * E
    assert recording.pushes == pushes + 8


def test_chunk_counts_pushes_of_the_full_engine_only():
    """``full_tick_fused.pushes`` is one of a chunk's counters: one a tick
    of a full-engine chunk, none of a ring chunk's."""
    assert (fused_tick, "full_tick_fused", "pushes") in train.Chunk.COUNTERS
    agent = _agent()
    ring = train.build_chunk_ring(agent, TP, E, 2 * E, 8, 3)
    ring_carry = train.init_ring_carry(agent, TP, E, 2 * E, rng.PRNGKey(0))
    buf = replay.StreamReplay(3 * E, 8, stride=E)
    full = train.Chunk(train.build_train_step_full(agent, buf, TP, E, 3))
    full_carry = train.init_stream_carry(agent, TP, E, buf, rng.PRNGKey(0))
    before = fused_tick.full_tick_fused.pushes
    ring(ring_carry, 4)
    assert fused_tick.full_tick_fused.pushes == before
    kept = copy.deepcopy(full_carry)
    full(full_carry, 4)
    assert fused_tick.full_tick_fused.pushes == before + 4
    # The chunk wrote its first carry's observation and replay in place.
    assert not torch.equal(full_carry[2], kept[2])
