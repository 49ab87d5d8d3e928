"""The ring engine's chunk (``train.build_chunk_ring``) against the JAX
trainer's ``run_chunk``, ``jax.jit(lax.scan(tick))``.

On the CPU the chunk runs its ticks eagerly from one table of per-tick
words (the keys, the Adam count, the bias corrections) made at its entry;
on the card the same rows feed one CUDA graph replay a tick. Both trainers
start from one carry (the JAX package's, carried across by
``interop.from_jax``) and run 8 ticks at 128 envs with a ring of 2
env-batches, a reset every 3 ticks and the target sync and ε decay every
2, on the default path and on ``in_kernel_td``: the rng chain, the step,
the env state, the scalar rings, the rewards and ε bitwise; the ring
bitwise but the charge channel (1.3e-7); the loss within 1e-5 relative
and the params within 1e-5 absolute (the learner's tolerances, as
tests/test_torch_train.py). And the chunk against the eager tick, bitwise,
across a chunk boundary with a train state saved and restored.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu.train import (
    build_train_step_ring as jbuild, init_ring_carry as jinit)
from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax, train_state_io
from dronerl_tpu_torch.ops import fused_tick

E, CAP, BATCH, RESET, TICKS = 128, 256, 8, 3, 8
CHARGE_ATOL = 1.3e-7
KW = dict(hidden_layers=(16, 16), epsilon_decay_every=2,
          target_update_interval=2, gamma=0.9)


def _leaves(tree):
    layers = tree["params"]
    return [np.asarray(layers[f"Dense_{i}"][k])
            for i in range(len(layers)) for k in ("kernel", "bias")]


@pytest.mark.parametrize("in_kernel_td", [False, True],
                         ids=["default", "in_kernel_td"])
def test_chunk_matches_jax_scan(in_kernel_td):
    jp, tp = JParams(grid_size=9, n_drones=4), EnvParams(grid_size=9,
                                                         n_drones=4)
    ja = JDQN(JConfig(**KW), jp)
    ta = DQN(DQNConfig(**KW), tp, device="cpu")
    jtick = jbuild(ja, jp, E, CAP, BATCH, reset_env_every=RESET,
                   interpret=True, in_kernel_td=in_kernel_td)
    jc = jinit(ja, jp, E, CAP, jax.random.PRNGKey(0),
               obs_dtype=jnp.bfloat16, batch_size=BATCH,
               in_kernel_td=in_kernel_td)
    tc = from_jax.ring_carry_from_jax(jax.device_get(jc))

    run_chunk = jax.jit(lambda c: jax.lax.scan(jtick, c, None,
                                               length=TICKS))
    jc, (jrew, jeps, jloss) = jax.device_get(run_chunk(jc))
    chunk = train.build_chunk_ring(ta, tp, E, CAP, BATCH, RESET,
                                   in_kernel_td=in_kernel_td)
    tc, (trew, teps, tloss) = chunk(tc, TICKS)

    assert (np.asarray(jc[0]).astype(np.int64) == tc[0].numpy()).all()
    assert int(jc[-1]) == tc[-1] == TICKS
    for f, x in zip(fused_tick.TState._fields, tc[1][0]):
        assert (np.asarray(getattr(jc[1][0], f)) == x.numpy()).all(), f
    jring = np.asarray(jc[1][1]).astype(np.float32).reshape(-1, 6, CAP)
    tring = tc[1][1].float().numpy().reshape(-1, 6, CAP)
    channel = np.arange(6) != 4
    assert (jring[:, channel] == tring[:, channel]).all()
    np.testing.assert_allclose(tring[:, 4], jring[:, 4], rtol=0,
                               atol=CHARGE_ATOL)
    for a, b in zip(jc[2], tc[2]):
        assert (np.asarray(a) == b.numpy()).all()
    assert trew.shape == (TICKS, E) and (np.asarray(jrew)
                                         == trew.numpy()).all()
    assert (np.asarray(jeps) == teps.numpy()).all()
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5,
                               atol=1e-7)
    assert (tloss.numpy() >= 0).sum() == TICKS - int(in_kernel_td)
    assert tc[3].opt_state.count == int(jc[3].opt_state[0].count)
    for r, o in zip(_leaves(jc[3].params), tc[3].params.flat()):
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=0, atol=1e-5)
    if in_kernel_td:
        for k, v in tc[4].items():  # the carried batch: a gather, bitwise
            assert (np.asarray(jc[4][k]) == v.numpy()).all(), k


def _assert_carries_equal(a, b):
    ta, na = train_state_io.leaves(a)
    tb, nb = train_state_io.leaves(b)
    assert na == nb and set(ta) == set(tb)
    for path in ta:
        assert torch.equal(ta[path], tb[path]), path


@pytest.mark.parametrize("in_kernel_td", [False, True],
                         ids=["default", "in_kernel_td"])
def test_chunk_equals_eager_ticks_across_a_resume(in_kernel_td, tmp_path):
    """Two chunks of 7 ticks (no period of the ring, the reset or the
    schedules divides 7) with a train state saved after the first and
    restored into a fresh carry before the second, against 14 eager
    ticks from the same carry: every tensor of the carry, its numbers and
    every output bitwise."""
    tp = EnvParams(grid_size=9, n_drones=4)
    agent = DQN(DQNConfig(**KW), tp, device="cpu")

    def fresh(seed):
        return train.init_ring_carry(
            agent, tp, E, CAP, rng.PRNGKey(seed), obs_dtype=torch.bfloat16,
            batch_size=BATCH, in_kernel_td=in_kernel_td)

    chunk = train.build_chunk_ring(agent, tp, E, CAP, BATCH, RESET,
                                   in_kernel_td=in_kernel_td)
    carry = fresh(0)
    eager = copy.deepcopy(carry)
    outs = []
    for _ in range(2):
        carry, out = chunk(carry, 7)
        outs.append(out)
        path = str(tmp_path / "state.safetensors")
        train_state_io.save(path, carry)
        carry = train_state_io.restore(path, fresh(1))
    ref = []
    for _ in range(14):
        eager, out = chunk.tick(eager)
        ref.append(out)
    _assert_carries_equal(carry, eager)
    for i, name in enumerate(("rewards", "epsilon", "loss")):
        got = torch.cat([o[i] for o in outs])
        want = torch.stack([o[i] for o in ref])
        assert torch.equal(got, want), name
    trained = int((torch.stack([o[2] for o in ref]) >= 0).sum())
    assert trained == 14 - int(in_kernel_td)
    assert carry[-1] == 14 and carry[3].opt_state.count == trained
