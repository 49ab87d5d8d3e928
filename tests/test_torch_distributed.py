"""The sharded jnp engine (``parallel.distributed``) against JAX's
``DistributedTrainer``.

The port's ranks run as processes of one gloo group on the CPU
(``parallel.launch.spawn``; one rank runs in the test's own process), the
JAX trainer over as many of the conftest's virtual CPU devices, both from
``PRNGKey(0)``. Shard by shard, after 12 ticks with resets every 5: the
rng chain, env state, observations, rewards and replay bitwise (the
observation's charge channel within 1.3e-7), the loss within rtol 1e-5,
the params within atol 1e-5 of JAX's and bitwise across the ranks. Also
the initial carry's shapes per rank, the refusals of ``num_envs`` that
does not divide and of more ranks than the group has, a mesh over a
prefix of the ranks, and the collectives a chunk makes: one all-reduce a
trained tick, nothing else.

The rank workers are this module's functions: it imports JAX only inside
the tests, so that a spawned rank imports torch and the port alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.constants import NO_TRAIN_LOSS
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.parallel import launch, mesh as mesh_mod
from dronerl_tpu_torch.parallel.distributed import DistributedTrainer

ENV = dict(grid_size=8, n_drones=3)
CFG = dict(hidden_layers=(8,), epsilon_decay_every=5,
           target_update_interval=5, gamma=0.9)
TRAINER = dict(buffer_capacity_per_shard=64, batch_size_per_shard=2,
               reset_env_every=5)
TICKS = 12
CHARGE_ATOL = 1.3e-7
ENV_FIELDS = ("ground", "air_x", "air_y", "carrying_package", "charge")
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
               "all_to_all", "reduce", "scatter", "gather", "barrier",
               "send", "recv")


def spec(num_envs, engine="jnp", ticks=TICKS, env=ENV, agent=CFG,
         trainer=TRAINER, mesh_size=None, obs_dtype="bfloat16"):
    return dict(num_envs=num_envs, engine=engine, ticks=ticks, env=env,
                agent=agent, trainer=trainer, mesh_size=mesh_size,
                obs_dtype=obs_dtype)


def run_rank(s):
    """One rank of ``s``: its initial carry, the carry after ``ticks``
    ticks, the chunk's rewards and losses, and the collectives the chunk
    called (``torch.distributed``'s, counted by name)."""
    mesh = mesh_mod.make_env_mesh(s["mesh_size"], device="cpu")
    if mesh is None:
        return None
    env = EnvParams(**s["env"])
    agent = DQN(DQNConfig(**s["agent"]), env, device="cpu")
    trainer = DistributedTrainer(agent, env, mesh, num_envs=s["num_envs"],
                                 engine=s["engine"], **s["trainer"])
    carry = trainer.init_carry(rng.PRNGKey(0),
                               obs_dtype=getattr(torch, s["obs_dtype"]))
    init = _detach(carry)
    chunk = trainer.build_chunk(s["ticks"])
    calls = {}
    dist = torch.distributed
    originals = {name: getattr(dist, name) for name in COLLECTIVES}

    def counted(name):
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return originals[name](*a, **k)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, counted(name))
    try:
        carry, (rewards, losses) = chunk(carry)
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
    return dict(rank=mesh.rank, world=mesh.world_size, init=init,
                carry=_detach(carry), rewards=rewards, losses=losses,
                calls=calls, local_engine=trainer.local_engine)


def _detach(carry):
    """A copy of the carry that later ticks do not write."""
    return _map(carry, lambda t: t.detach().clone())


def _map(node, fn):
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, torch.nn.Module):
        return [fn(p) for p in node.flat()]
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if dataclasses.is_dataclass(node):
        return {f.name: _map(getattr(node, f.name), fn)
                for f in dataclasses.fields(node)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map(v, fn) for v in node))
    if isinstance(node, (tuple, list)):
        return type(node)(_map(v, fn) for v in node)
    return node


def run_port(s, world):
    """Every rank's :func:`run_rank`: in this process for one rank (its
    own one-rank group, destroyed after), else spawned over gloo."""
    if world == 1:
        try:
            return [run_rank(s)]
        finally:
            torch.distributed.destroy_process_group()
    return launch.spawn(run_rank, world, (s,), device="cpu", num_threads=1,
                        timeout=300)


# --- the JAX side -------------------------------------------------------------

def run_jax(s, world):
    """JAX's DistributedTrainer over ``world`` virtual devices: the initial
    carry and the carry, rewards and losses after the chunk (host)."""
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
    carry, (rewards, losses) = trainer.build_chunk(s["ticks"])(carry)
    return init, jax.device_get(carry), np.asarray(rewards), np.asarray(
        losses)


def host_key(jkey):
    return np.asarray(jkey).astype(np.uint32).astype(np.int64)


def flax_leaves(tree):
    layers = tree["params"]
    conv = sorted(n for n in layers if n.startswith("Conv_"))
    dense = sorted((n for n in layers if n.startswith("Dense_")),
                   key=lambda n: int(n.split("_")[1]))
    out = []
    for name in conv:
        out += [np.transpose(np.asarray(layers[name]["kernel"]), (3, 2, 0, 1)),
                np.asarray(layers[name]["bias"])]
    for name in dense:
        out += [np.asarray(layers[name]["kernel"]),
                np.asarray(layers[name]["bias"])]
    return out


def assert_learner_close(jstate, tstate, tag, atol=1e-5):
    """Params, target and Adam moments within ``atol`` of JAX's; ε and the
    Adam count equal."""
    pairs = [(jstate.params, tstate["params"]),
             (jstate.target_params, tstate["target_params"]),
             (jstate.opt_state[0].mu, tstate["opt_state"]["mu"]),
             (jstate.opt_state[0].nu, tstate["opt_state"]["nu"])]
    for jtree, leaves in pairs:
        for j, t in zip(flax_leaves(jtree), leaves, strict=True):
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol,
                                       err_msg=str(tag))
    assert tstate["opt_state"]["count"] == int(
        np.asarray(jstate.opt_state[0].count)), tag
    assert np.float32(tstate["epsilon"]) == np.float32(
        np.asarray(jstate.epsilon)), tag


def assert_obs_close(j, t, tag):
    """Observations bitwise but the charge channel (the last axis is the
    channel for row-major observations)."""
    j = np.asarray(j).astype(np.float32).reshape(-1, 6)
    t = t.float().numpy().reshape(-1, 6)
    ch = np.arange(6) != 4
    assert (j[:, ch] == t[:, ch]).all(), tag
    np.testing.assert_allclose(t[:, 4], j[:, 4], rtol=0, atol=CHARGE_ATOL,
                               err_msg=str(tag))


def assert_losses_close(jlosses, tlosses, tag):
    t = tlosses.numpy()
    untrained = jlosses == NO_TRAIN_LOSS
    assert ((t == NO_TRAIN_LOSS) == untrained).all(), tag
    np.testing.assert_allclose(t[~untrained], jlosses[~untrained], rtol=1e-5,
                               err_msg=str(tag))


def assert_ranks_bitwise(results):
    """The replicated learner: every rank's params, target, moments and ε
    bitwise rank 0's."""
    base = results[0]["carry"][3]
    for r in results[1:]:
        other = r["carry"][3]
        for key in ("params", "target_params"):
            for a, b in zip(base[key], other[key], strict=True):
                assert torch.equal(a, b), (r["rank"], key)
        for key in ("mu", "nu"):
            for a, b in zip(base["opt_state"][key], other["opt_state"][key]):
                assert torch.equal(a, b), (r["rank"], key)
        assert torch.equal(base["epsilon"], other["epsilon"])
        assert torch.equal(results[0]["losses"], r["losses"])


def compare_jnp(results, jout, s):
    """The jnp engine's carry ``(rng, EnvState, obs (E, k, D), ag_state,
    ReplayState, step)``, shard by shard."""
    jinit, jcarry, jrewards, jlosses = jout
    eps = s["num_envs"] // len(results)
    for r in results:
        rows = slice(r["rank"] * eps, (r["rank"] + 1) * eps)
        for name, jc, tc in (("init", jinit, r["init"]),
                             ("chunk", jcarry, r["carry"])):
            tag = (r["rank"], name)
            assert (host_key(jc[0]) == tc[0].numpy()).all(), tag
            for f in ENV_FIELDS:
                assert (np.asarray(getattr(jc[1], f))[rows]
                        == tc[1][f].numpy()).all(), (tag, f)
            assert_obs_close(np.asarray(jc[2])[rows], tc[2], tag)
            cap = tc[4]["storage"]["obs"].shape[0]
            slots = slice(r["rank"] * cap, (r["rank"] + 1) * cap)
            for key, buf in tc[4]["storage"].items():
                jbuf = np.asarray(jc[4].storage[key])[slots]
                if key in ("obs", "next_obs"):
                    assert_obs_close(jbuf, buf, (tag, key))
                else:
                    assert (jbuf == buf.numpy()).all(), (tag, key)
            assert tc[4]["cursor"] == int(np.asarray(jc[4].cursor)), tag
            assert tc[4]["size"] == int(np.asarray(jc[4].size)), tag
            assert tc[5] == int(np.asarray(jc[5])), tag
            assert_learner_close(jc[3], tc[3], tag)
        assert (jrewards[:, rows] == r["rewards"].numpy()).all(), r["rank"]
        assert_losses_close(jlosses, r["losses"], r["rank"])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_jnp_engine_matches_jax(world):
    """1, 2 and 4 ranks of 4 envs each against JAX over as many devices."""
    s = spec(num_envs=4 * world)
    results = run_port(s, world)
    assert [r["rank"] for r in results] == list(range(world))
    compare_jnp(results, run_jax(s, world), s)
    assert_ranks_bitwise(results)
    assert results[0]["init"][1]["ground"].shape == (4, 8, 8)
    assert results[0]["init"][2].shape == (4, 1, 7 * 7 * 6)
    assert results[0]["init"][4]["storage"]["obs"].shape == (64, 294)
    eps = [float(r["carry"][3]["epsilon"]) for r in results]
    assert max(eps) < 1.0


def test_shards_hold_different_worlds():
    """Each rank resets from ``fold_in(key, rank)``: the shards differ."""
    results = run_port(spec(num_envs=8, ticks=1), 2)
    g0, g1 = (r["init"][1]["ground"] for r in results)
    assert not torch.equal(g0, g1)


def test_one_all_reduce_a_trained_tick():
    """A chunk of 12 ticks calls ``all_reduce`` once for each trained
    tick (the gradients and the loss in one buffer) and no other
    collective; untrained ticks call none."""
    trainer = dict(TRAINER, batch_size_per_shard=12)  # trains from tick 2
    results = run_port(spec(num_envs=8, trainer=trainer), 2)
    for r in results:
        trained = int((r["losses"] >= 0).sum())
        assert 0 < trained < TICKS, r["losses"]
        assert r["calls"] == {"all_reduce": trained}, r["calls"]


def test_num_envs_must_divide_the_ranks():
    env = EnvParams(**ENV)
    agent = DQN(DQNConfig(**CFG), env, device="cpu")
    mesh = mesh_mod.EnvMesh(rank=0, world_size=8,
                            device=torch.device("cpu"), group=None)
    with pytest.raises(ValueError, match="must divide over 8"):
        DistributedTrainer(agent, env, mesh, num_envs=12)
    with pytest.raises(ValueError, match="epsilon_decay_every"):
        DistributedTrainer(DQN(DQNConfig(hidden_layers=(8,)), env,
                               device="cpu"), env, mesh, num_envs=16)


def rank_asks_too_much(world):
    with pytest.raises(ValueError, match=f"requested {world + 1} devices"):
        mesh_mod.make_env_mesh(world + 1, device="cpu")
    return True


def test_mesh_over_a_prefix_of_the_ranks():
    """Four ranks, a mesh of the first two (``make_env_mesh(2)``, JAX's
    prefix of ``jax.devices()``): ranks 2 and 3 get no mesh, ranks 0 and
    1 train 8 envs as JAX does over 2 devices; more ranks than the group
    has are refused."""
    s = spec(num_envs=8, ticks=3, mesh_size=2)
    results = launch.spawn(run_rank, 4, (s,), device="cpu", num_threads=1,
                           timeout=300)
    assert results[2] is None and results[3] is None
    compare_jnp(results[:2], run_jax(s, 2), s)
    assert_ranks_bitwise(results[:2])
    assert launch.spawn(rank_asks_too_much, 2, (2,), device="cpu",
                        num_threads=1) == [
        True, True]
