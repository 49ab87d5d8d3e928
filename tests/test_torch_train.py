"""The whole ring-engine slice: the port's trainer against the JAX one.

Both trainers start from one carry (the JAX package's, carried across by
``interop.from_jax``) and run 4 ticks with a reset among them: the rng
chain, slots, scalar rings, env state, rewards and dones bitwise; the
ring bitwise except the charge channel (1.3e-7); loss within 1e-5
relative and params within 1e-5 absolute (the learner's tolerances, see
tests/test_torch_dqn.py). Also: the port imports no JAX, and the CLI
refuses to run without a card unless told ``--device cpu``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu.train import (
    build_train_step_ring as jbuild, init_ring_carry as jinit)
from dronerl_tpu_torch import train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, CAP, BATCH = 128, 512, 8
CHARGE_ATOL = 1.3e-7


def _leaves(tree):
    layers = tree["params"]
    return [np.asarray(layers[f"Dense_{i}"][k])
            for i in range(len(layers)) for k in ("kernel", "bias")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_slice_matches_jax(dtype):
    kw = dict(hidden_layers=(16, 16), epsilon_decay_every=2,
              target_update_interval=2, gamma=0.9)
    jp, tp = JParams(grid_size=9, n_drones=4), EnvParams(grid_size=9,
                                                         n_drones=4)
    ja = JDQN(JConfig(**kw), jp)
    ta = DQN(DQNConfig(**kw), tp, device="cpu")
    jtick = jbuild(ja, jp, E, CAP, BATCH, reset_env_every=3, interpret=True)
    jc = jinit(ja, jp, E, CAP, jax.random.PRNGKey(0),
               obs_dtype=jnp.dtype(dtype), batch_size=BATCH)
    tc = from_jax.ring_carry_from_jax(jax.device_get(jc))
    ttick = train.build_train_step_ring(ta, tp, E, CAP, BATCH, 3)
    trained = 0
    for t in range(4):
        jc, (jrew, jeps, jloss) = jtick(jc, None)
        tc, (trew, teps, tloss) = ttick(tc)
        jc_np = jax.device_get(jc)
        assert (np.asarray(jc_np[0]).astype(np.int64)
                == tc[0].numpy()).all(), t
        assert int(jc_np[-1]) == tc[-1] == t + 1
        for f, x in zip(("ground", "air_x", "air_y", "carrying", "charge"),
                        tc[1][0]):
            assert (np.asarray(getattr(jc_np[1][0], f))
                    == x.numpy()).all(), (t, f)
        jring = np.asarray(jc_np[1][1]).astype(np.float32).reshape(
            -1, 6, CAP)
        tring = tc[1][1].float().numpy().reshape(-1, 6, CAP)
        ch = np.arange(6) != 4
        assert (jring[:, ch] == tring[:, ch]).all(), t
        np.testing.assert_allclose(tring[:, 4], jring[:, 4], rtol=0,
                                   atol=CHARGE_ATOL)
        for a, b in zip(jc_np[2], tc[2]):
            assert (np.asarray(a) == b.numpy()).all(), t
        assert (np.asarray(jrew) == trew.numpy()).all(), t
        assert np.float32(teps.item()) == np.asarray(jeps), t
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        trained += float(tloss) >= 0
        for r, o in zip(_leaves(jc_np[3].params), tc[3].params.flat()):
            np.testing.assert_allclose(o.detach().numpy(), r, rtol=0,
                                       atol=1e-5)
    assert trained == 4  # the ring holds a full batch from the first tick


def test_carry_layout_and_ring_seed():
    tp = EnvParams(grid_size=9, n_drones=4)
    ta = DQN(DQNConfig(hidden_layers=(16,)), tp, device="cpu")
    key = torch.tensor([0, 7], dtype=torch.int64)
    carry = train.init_ring_carry(ta, tp, E, CAP, key,
                                  obs_dtype=torch.bfloat16)
    rng, (tstate, ring), scalar_rings, ag, aux, step = carry
    assert rng.device.type == "cpu" and step == 0 and aux == ()
    assert ring.dtype == torch.bfloat16 and tuple(ring.shape) == (294, CAP)
    assert ring[:, :E].any() and not ring[:, E:].any()
    assert [r.dtype for r in scalar_rings] == [
        torch.int32, torch.float32, torch.int8]
    tick = train.build_train_step_ring(ta, tp, E, CAP, BATCH, 100)
    seeded = ring[:, :E].clone()
    for _ in range(3):
        carry, (rew, eps, loss) = tick(carry)
    assert tuple(rew.shape) == (E,) and float(loss) >= 0
    assert torch.equal(carry[1][1][:, :E], seeded)  # slot 0 untouched
    assert carry[-1] == 3
    with pytest.raises(ValueError):
        train.build_train_step_ring(ta, tp, E, E, BATCH, 100)
    with pytest.raises(ValueError, match="multiple of collect_drones"):
        train.build_train_step_ring(ta, tp, E, CAP, BATCH + 1, 100,
                                    collect_drones=2)


def test_no_jax_imports():
    """Importing every module of the port pulls in no JAX, flax, optax or
    dronerl_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dronerl_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'dronerl_tpu')]\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith(pkg.__name__)))"
        "\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    modules = out.stdout.split()
    assert len(modules) >= 19
    assert {"dronerl_tpu_torch.ops.learner_kernel",
            "dronerl_tpu_torch.ops.fused_tick", "dronerl_tpu_torch.train",
            "dronerl_tpu_torch.interop.from_jax"} <= set(modules)


def test_cli_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--num_envs", "128", "--num_steps", "3"])


def test_cli_runs_on_cpu(tmp_path):
    metrics = train.main([
        "--device", "cpu", "--num_envs", "128", "--num_steps", "3",
        "--memory_size", "256", "--ring_obs_dtype", "float32",
        "--skip_final_eval", "--run_dir", str(tmp_path)])
    assert metrics["device"] == "cpu" and metrics["obs_per_sec"] > 0
    assert metrics["td_loss_mean"] is not None
    assert np.isfinite(metrics["td_loss_mean"])


def test_cli_rejects_unported_flags():
    with pytest.raises(SystemExit, match="not supported"):
        train.parse_args(["--use_sharding"])


def test_cli_epsilon_half_life_rule():
    args = train.parse_args(["--num_steps", "1000", "--device", "cpu"])
    cfg = train.agent_config_from_args(args)
    # ε reaches half its range after 20% of training
    assert cfg.epsilon_decay ** 200 == pytest.approx(0.505, rel=1e-9)
    assert cfg.hidden_layers == (16, 16) and cfg.epsilon_decay_every == 5
