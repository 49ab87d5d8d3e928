"""The sharded trainers' chunk (``DistributedTrainer.build_chunk``, a
``train.Chunk`` over the rank's tick) on the CPU.

``shard_keys(rank, width, order).table`` walks JAX's per-shard chain
(``fold_in(fold_in(rng, rank), step)``, the split, ``rng' = fold_in(rng,
1)``) for a whole chunk: it equals the keys of as many single ticks
bitwise, for every rank and split, from a step that is not 0. Two ranks
over gloo (``parallel.launch.spawn``) run each local engine (ring over
B1, full over B3, fused over B4 with a conv net, jnp) as two chunks of 4
ticks, one chunk of 8 and 8 eager ticks from one initial carry: the
carries (every tensor, the rng, step, Adam count and the replay's cursor
and size) and the outputs bitwise; one all-reduce a trained tick; each
rank meets the same signatures at the same ticks, as the ranks' CUDA
graph captures need.

The rank workers are this module's functions, and it imports no JAX:
``test_torch_shard_chunk_jax.py`` holds the same runs to JAX's trainer.
"""

import numpy as np
import pytest
import torch

import tests.test_torch_distributed as base
import tests.test_torch_distributed_kernels as kernels
from dronerl_tpu_torch import rng
from dronerl_tpu_torch.agents import dqn as dqn_mod
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.parallel import launch, mesh as mesh_mod
from dronerl_tpu_torch.parallel.distributed import (
    DistributedTrainer, _SPLITS, shard_keys)

HALF = 4  # ticks a chunk; two chunks cross a reset (every 5) and a wrap

# (engine, net, envs a rank): each local engine of the sharded trainer.
ENGINES = {
    "ring": ("ring", kernels.DENSE, kernels.E),
    "full": ("fused", kernels.DENSE, kernels.E),
    "fused": ("fused", kernels.CONV, kernels.E),
    "jnp": ("jnp", base.CFG, 4),
}


def engine_spec(local, world=2):
    engine, agent, envs = ENGINES[local]
    if engine == "jnp":
        return base.spec(num_envs=world * envs, ticks=HALF)
    return kernels.kernel_spec(engine, agent, ticks=HALF, world=world)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("split", sorted(_SPLITS))
def test_shard_key_table_equals_the_tick_keys(rank, split):
    """``table(rng, n, step)`` equals ``n`` calls of ``keys`` from step
    37 on: each tick's keys and the chain's key after them."""
    width, order = _SPLITS[split]
    keys = shard_keys(rank, width, order)
    key, step = rng.PRNGKey(11), 37
    end, table = keys.table(key, 7, step)
    assert table.dtype == np.uint32 and table.shape == (7, len(order), 2)
    for t in range(7):
        key, tick_keys = keys(key, step + t)
        assert table[t].astype(np.int64).tolist() == tick_keys.tolist(), t
    assert torch.equal(end, key)


def run_chunks(s):
    """One rank of ``s``: its initial carry; two chunks of ``s["ticks"]``
    ticks (the carry, the outputs stacked, the all-reduces they called);
    one chunk of twice as many; as many eager ticks of ``build_tick``; the
    chunk's signatures."""
    mesh = mesh_mod.make_env_mesh(device="cpu")
    env = EnvParams(**s["env"])
    agent = DQN(DQNConfig(**s["agent"]), env, device="cpu")
    trainer = DistributedTrainer(agent, env, mesh, num_envs=s["num_envs"],
                                 engine=s["engine"], **s["trainer"])
    obs_dtype = getattr(torch, s["obs_dtype"])

    def fresh():
        return trainer.init_carry(rng.PRNGKey(0), obs_dtype=obs_dtype)

    n = s["ticks"]
    chunk = trainer.build_chunk(n)
    carry, init = fresh(), base._detach(fresh())
    calls = dqn_mod.all_reduce_mean.calls
    rewards, losses = [], []
    for _ in range(2):
        carry, (r, loss) = chunk(carry)
        rewards.append(r)
        losses.append(loss)
    calls = dqn_mod.all_reduce_mean.calls - calls
    one, (one_rewards, one_losses) = trainer.build_chunk(2 * n)(fresh())
    tick, eager, outs = trainer.build_tick(), fresh(), []
    for _ in range(2 * n):
        eager, out = tick(eager)
        outs.append(out)
    sigs = chunk.chunk.table(fresh(), 2 * n)[1]
    return dict(rank=mesh.rank, world=mesh.world_size, init=init,
                carry=base._detach(carry), rewards=torch.cat(rewards),
                losses=torch.cat(losses), calls=calls,
                one=base._detach(one), one_outs=(one_rewards, one_losses),
                eager=base._detach(eager),
                eager_outs=tuple(torch.stack(o) for o in zip(*outs)),
                sigs=[tuple(sig) for sig in sigs],
                local_engine=trainer.local_engine,
                graphed=chunk.chunk.graphed)


def spawn_chunks(s, world=2):
    return launch.spawn(run_chunks, world, (s,), device="cpu", num_threads=1,
                        timeout=300)


def assert_same(a, b, tag):
    """Two detached carries equal: every tensor bitwise, every number."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), tag
    elif isinstance(a, dict):
        assert set(a) == set(b), tag
        for k in a:
            assert_same(a[k], b[k], (tag, k))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), tag
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, (tag, i))
    else:
        assert a == b, tag


@pytest.mark.parametrize("local", sorted(ENGINES))
def test_two_chunks_equal_one_and_the_eager_ticks(local):
    """World 2 over gloo: two chunks of 4 ticks == one chunk of 8 == 8
    eager ticks, carries and outputs bitwise on each rank; as many
    all-reduces as trained ticks; the ranks' signatures equal; eager rows
    (no graph) over gloo."""
    results = spawn_chunks(engine_spec(local))
    for r in results:
        tag = (local, r["rank"])
        assert r["local_engine"] == local and not r["graphed"]
        assert_same(r["carry"], r["one"], (tag, "one"))
        assert_same(r["carry"], r["eager"], (tag, "eager"))
        assert torch.equal(r["rewards"], r["one_outs"][0])
        assert torch.equal(r["losses"], r["one_outs"][1])
        assert torch.equal(r["rewards"], r["eager_outs"][0])
        assert torch.equal(r["losses"], r["eager_outs"][2])
        trained = int((r["losses"] >= 0).sum())
        assert 0 < trained and r["calls"] == trained, (tag, r["calls"])
        assert r["carry"][5] == 2 * HALF
    assert results[0]["sigs"] == results[1]["sigs"]
    assert len(set(results[0]["sigs"])) > 1
    base.assert_ranks_bitwise(results)
