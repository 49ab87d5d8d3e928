"""The sharded ring and fused engines against JAX's ``DistributedTrainer``
(its Pallas engines in interpret mode), 2 ranks × 128 envs.

Each rank runs its tick kernels' plain versions, as every kernel wrapper
does on CPU tensors: B1 (``full_tick_fused_ring``) on the ring engine, B3
(``full_tick_fused``) on the fused engine with a dense net, B4
(``tick_fused``) with a conv net's actor outside the kernel. 12 ticks with
a reset every 5, shard by shard: the rng chain, the transposed env state,
the observations (or the ring) bitwise but the charge channel (within
1.3e-7), the scalar rings or the replay bitwise, rewards bitwise, the
loss within rtol 1e-5, the params within atol 1e-5 of JAX's and bitwise
across the ranks. ``test_torch_distributed_variants.py`` takes the ring
engine's other branches.
"""

import numpy as np
import pytest

import tests.test_torch_distributed as base
from dronerl_tpu_torch.ops import fused_tick

E = 128
DENSE = dict(hidden_layers=(16, 16), epsilon_decay_every=5,
             target_update_interval=5, gamma=0.9)
CONV = dict(network_type="conv",
            conv_layers=({"out_channels": 4, "kernel_size": 3, "stride": 1,
                          "padding": 1},),
            conv_dense_layers=(8,), epsilon_decay_every=5,
            target_update_interval=5, gamma=0.9)
KERNEL_ENV = dict(grid_size=9, n_drones=4)
TRAINER = dict(buffer_capacity_per_shard=4 * E, batch_size_per_shard=4,
               reset_env_every=5)


def kernel_spec(engine, agent, ticks=base.TICKS, trainer=TRAINER,
                obs_dtype="bfloat16", world=2):
    return base.spec(num_envs=world * E, engine=engine, ticks=ticks,
                     env=KERNEL_ENV, agent=agent, trainer=trainer,
                     obs_dtype=obs_dtype)


def assert_obs_t_close(j, t, tag):
    """Feature-major observations (rows (cells, 6 channels), envs last)
    bitwise but the charge channel."""
    j = np.asarray(j).astype(np.float32)
    j = j.reshape(-1, 6, j.shape[-1])
    t = t.float().numpy().reshape(-1, 6, t.shape[-1])
    ch = np.arange(6) != 4
    assert (j[:, ch] == t[:, ch]).all(), tag
    np.testing.assert_allclose(t[:, 4], j[:, 4], rtol=0,
                               atol=base.CHARGE_ATOL, err_msg=str(tag))


def assert_tstate_equal(jt, tt, lanes, tag):
    for f in fused_tick.TState._fields:
        assert (np.asarray(getattr(jt, f))[:, lanes]
                == getattr(tt, f).numpy()).all(), (tag, f)


def compare_ring(results, jout, s):
    """The ring carry ``(rng, (tstate, ring), (a, r, d rings), ag_state,
    (), step)``: lanes and ring columns sharded."""
    jinit, jcarry, jrewards, jlosses = jout
    eps = s["num_envs"] // len(results)
    for r in results:
        lanes = slice(r["rank"] * eps, (r["rank"] + 1) * eps)
        for name, jc, tc in (("init", jinit, r["init"]),
                             ("chunk", jcarry, r["carry"])):
            tag = (r["rank"], name)
            assert (base.host_key(jc[0]) == tc[0].numpy()).all(), tag
            assert_tstate_equal(jc[1][0], tc[1][0], lanes, tag)
            cap = tc[1][1].shape[-1]
            cols = slice(r["rank"] * cap, (r["rank"] + 1) * cap)
            assert_obs_t_close(np.asarray(jc[1][1])[:, cols], tc[1][1], tag)
            for jring, tring in zip(jc[2], tc[2], strict=True):
                assert (np.asarray(jring)[..., cols]
                        == tring.numpy()).all(), tag
            assert tc[5] == int(np.asarray(jc[5])), tag
            base.assert_learner_close(jc[3], tc[3], tag)
        assert (jrewards[:, lanes] == r["rewards"].numpy()).all(), r["rank"]
        base.assert_losses_close(jlosses, r["losses"], r["rank"])


def compare_stream(results, jout, s):
    """The fused engine's carry ``(rng, tstate, obs_t, ag_state,
    ReplayState (slots last), step)``."""
    jinit, jcarry, jrewards, jlosses = jout
    eps = s["num_envs"] // len(results)
    for r in results:
        lanes = slice(r["rank"] * eps, (r["rank"] + 1) * eps)
        for name, jc, tc in (("init", jinit, r["init"]),
                             ("chunk", jcarry, r["carry"])):
            tag = (r["rank"], name)
            assert (base.host_key(jc[0]) == tc[0].numpy()).all(), tag
            assert_tstate_equal(jc[1], tc[1], lanes, tag)
            assert_obs_t_close(np.asarray(jc[2])[:, lanes], tc[2], tag)
            storage = tc[4]["storage"]
            cap = storage["actions"].shape[-1]
            slots = slice(r["rank"] * cap, (r["rank"] + 1) * cap)
            for key, buf in storage.items():
                jbuf = np.asarray(jc[4].storage[key])[..., slots]
                if key == "obs":
                    assert_obs_t_close(jbuf, buf, (tag, key))
                else:
                    assert (jbuf == buf.numpy()).all(), (tag, key)
            assert tc[4]["cursor"] == int(np.asarray(jc[4].cursor)), tag
            assert tc[4]["size"] == int(np.asarray(jc[4].size)), tag
            assert tc[5] == int(np.asarray(jc[5])), tag
            base.assert_learner_close(jc[3], tc[3], tag)
        assert (jrewards[:, lanes] == r["rewards"].numpy()).all(), r["rank"]
        base.assert_losses_close(jlosses, r["losses"], r["rank"])


def check(s, world=2):
    results = base.run_port(s, world)
    compare = compare_ring if s["engine"] == "ring" else compare_stream
    compare(results, base.run_jax(s, world), s)
    base.assert_ranks_bitwise(results)
    trained = int((results[0]["losses"] >= 0).sum())
    for r in results:
        assert r["calls"] == {"all_reduce": trained}, r["calls"]
    return results


def test_ring_engine_matches_jax():
    """Plain B1 per rank, a bf16 ring of 4 env-batches a shard."""
    results = check(kernel_spec("ring", DENSE))
    assert results[0]["local_engine"] == "ring"
    assert results[0]["init"][1][1].shape == (294, 4 * E)


@pytest.mark.parametrize("agent,local", [(DENSE, "full"), (CONV, "fused")],
                         ids=["dense_B3", "conv_B4"])
def test_fused_engine_matches_jax(agent, local):
    """Plain B3 per rank for a dense net; plain B4 with the conv actor
    (``DQN.act_t``) and the reset outside the kernel for a conv net."""
    results = check(kernel_spec("fused", agent))
    assert results[0]["local_engine"] == local
