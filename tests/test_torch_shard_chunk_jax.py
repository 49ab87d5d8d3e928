"""Two sharded chunks in a row against JAX's ``DistributedTrainer``.

JAX's ``build_chunk(4)`` (``jit(shard_map(lax.scan(tick)))``, its Pallas
engines in interpret mode) runs twice over 2 virtual CPU devices; the
port's two ranks (gloo, ``test_torch_shard_chunk.run_chunks``) run their
trainer's chunk twice from the same key. The second chunk starts from the
chain's key at the first one's end, which one chunk alone does not
reach. Shard by shard, as ``test_torch_distributed*.py`` hold one chunk:
the rng chain, env state, observations (or the ring), the scalar rings
or the replay bitwise (the charge channel within 1.3e-7), rewards
bitwise, the loss within rtol 1e-5, the params within atol 1e-5 of JAX's
and bitwise across the ranks.
"""

import numpy as np
import pytest

import tests.test_torch_distributed as base
import tests.test_torch_distributed_kernels as kernels
import tests.test_torch_shard_chunk as shard


def run_jax_chunks(s, world):
    """JAX's trainer over ``world`` devices: the initial carry, the carry
    after two chunks of ``s["ticks"]`` ticks, their rewards and losses
    stacked (host)."""
    import jax

    from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
    from dronerl_tpu.env.types import EnvParams as JParams
    from dronerl_tpu.parallel import DistributedTrainer as JTrainer
    from dronerl_tpu.parallel import make_env_mesh as jmesh

    env = JParams(**s["env"])
    agent = JDQN(JConfig(**s["agent"]), env)
    kw = dict(s["trainer"])
    if s["engine"] != "jnp":
        kw.update(engine=s["engine"], interpret=True)
    trainer = JTrainer(agent, env, jmesh(world), num_envs=s["num_envs"],
                       **kw)
    carry = trainer.init_carry(jax.random.PRNGKey(0),
                               obs_dtype=jax.numpy.dtype(s["obs_dtype"]))
    init = jax.device_get(carry)
    chunk = trainer.build_chunk(s["ticks"])
    rewards, losses = [], []
    for _ in range(2):
        carry, (r, loss) = chunk(carry)
        rewards.append(np.asarray(r))
        losses.append(np.asarray(loss))
    return (init, jax.device_get(carry), np.concatenate(rewards),
            np.concatenate(losses))


@pytest.mark.parametrize("local", ["jnp", "ring", "full"])
def test_two_chunks_match_jax(local):
    """The jnp engine (4 envs a rank), the ring engine over plain B1 (128
    envs a rank, a bf16 ring of 4 env-batches) and the full engine over
    plain B3 (a StreamReplay of 4 pushes, which wraps at the chunks'
    boundary): 2 x 4 ticks, a reset at tick 5."""
    s = shard.engine_spec(local)
    results = shard.spawn_chunks(s)
    compare = {"jnp": base.compare_jnp, "ring": kernels.compare_ring,
               "full": kernels.compare_stream}[local]
    compare(results, run_jax_chunks(s, 2), s)
    base.assert_ranks_bitwise(results)
