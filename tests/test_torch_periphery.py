"""The periphery of the port against the JAX package's: the gym-style
façade (``env.gymapi``), the debug board (``env.debug``), the notebook
helpers, the sweep's trial arguments and the phase benchmark.

The façade's tests mirror ``tests/test_gymapi.py``; on the same seed its
observations, rewards and dones equal the JAX façade's over 30 steps
(window and grid views), and the board string equals JAX's character for
character. The helpers, sweep and benchmark tests mirror those of
``tests/test_aux.py``: the sweep's argv mapping runs with ``wandb``
blocked, the benchmark's single configuration on the CPU.
"""

import inspect
import sys
import types

import numpy as np
import pytest

from dronerl_tpu.env import debug as jdebug
from dronerl_tpu.env.gymapi import DeliveryDronesEnv as JaxEnv
from dronerl_tpu_torch import benchmark, helpers, sweep
from dronerl_tpu_torch.env import debug
from dronerl_tpu_torch.env.gymapi import DeliveryDronesEnv


def make(config, **kw):
    return DeliveryDronesEnv(config, device="cpu", **kw)


def test_reset_and_step_surface():
    env = make({"n_drones": 3})
    obs, info = env.reset(seed=0)
    assert set(obs) == {0, 1, 2} and info is None
    assert obs[0].shape == (7, 7, 6)
    next_obs, rewards, dones, truncated, extra = env.step({0: 2, 1: 4, 2: 0})
    assert set(rewards) == {0, 1, 2} and set(next_obs) == {0, 1, 2}
    assert isinstance(rewards[0], float)
    assert isinstance(dones[0], bool)
    assert truncated is False and extra == {}


def test_step_before_reset_raises():
    with pytest.raises(RuntimeError, match="reset"):
        make({"n_drones": 2}).step({0: 1})


def test_density_grid_sizing():
    env = make({"n_drones": 5, "drone_density": 0.05})
    assert env.side_size == 10  # ceil(sqrt(5/0.05)) = 10


def test_explicit_grid_size_override():
    env = make({"n_drones": 2, "grid_size": 12})
    assert env.side_size == 12


def test_grid_view_wrapper():
    env = make({"n_drones": 2, "grid_size": 8}, wrapper="global")
    obs, _ = env.reset(seed=1)
    assert obs[0].shape == (8, 8, 6)
    np.testing.assert_array_equal(obs[0], obs[1])


def test_ansi_render():
    env = make({"n_drones": 2})
    env.reset(seed=0)
    board = env.render()
    assert isinstance(board, str) and len(board.splitlines()) == env.side_size


def test_the_card_is_the_default_device():
    """No CUDA here: the default device raises instead of falling back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeliveryDronesEnv({"n_drones": 2})


@pytest.mark.parametrize("wrapper,config", [
    ("window", {"n_drones": 3}),
    ("grid", {"n_drones": 2, "grid_size": 8}),
    ("window", {"n_drones": 4, "grid_size": 9, "pickup_reward": 0.5}),
])
def test_facade_matches_jax(wrapper, config):
    """30 steps of seeded random actions: observations (the charge channel
    within 1.3e-7), rewards, dones and the board string as JAX's."""
    jenv, tenv = JaxEnv(config, wrapper=wrapper), make(config,
                                                       wrapper=wrapper)
    jobs, _ = jenv.reset(seed=3)
    tobs, _ = tenv.reset(seed=3)
    actions = np.random.default_rng(0).integers(0, 5, (30, tenv.n_drones))
    for t in range(31):
        for i in range(tenv.n_drones):
            ch = np.arange(6) != 4
            assert (jobs[i][..., ch] == tobs[i][..., ch]).all(), (t, i)
            np.testing.assert_allclose(tobs[i][..., 4], jobs[i][..., 4],
                                       rtol=0, atol=1.3e-7)
        assert tenv.render() == jenv.render(), t
        if t == 30:
            break
        step = {i: int(a) for i, a in enumerate(actions[t])}
        jobs, jrew, jdone, _, _ = jenv.step(step)
        tobs, trew, tdone, _, _ = tenv.step(step)
        assert trew == jrew and tdone == jdone, t


def test_debug_strings_match_jax():
    env = make({"n_drones": 3})
    env.reset(seed=5)
    jenv = JaxEnv({"n_drones": 3})
    jenv.reset(seed=5)
    assert debug.board_string(env.state) == jdebug.board_string(jenv.state)
    assert debug.format_actions([0, 1, 2, 3, 4]) == jdebug.format_actions(
        np.arange(5))
    assert env.format_actions({0: 1, 2: 4}) == jenv.format_actions(
        {0: 1, 2: 4})


def test_multi_agent_trainer_loop():
    helpers.set_seed(0)
    env = make({"n_drones": 2, "grid_size": 8})
    agents = {0: helpers.RandomHostAgent(), 1: helpers.RandomHostAgent()}
    trainer = helpers.MultiAgentTrainer(env, agents, seed=0)
    trainer.train(20)
    assert len(trainer.rewards_log[0]) == 20
    log = helpers.test_agents(env, agents, n_steps=10)
    assert len(log[0]) == 10


def test_random_host_agents_match_jax_helpers():
    """Seeded alike, the two packages' random host agents act alike, so
    the trainers' reward logs are equal."""
    from dronerl_tpu import helpers as jhelpers

    logs = []
    for mod, env in ((helpers, make({"n_drones": 3, "grid_size": 8})),
                     (jhelpers, JaxEnv({"n_drones": 3, "grid_size": 8}))):
        agents = {i: mod.RandomHostAgent() for i in range(3)}
        trainer = mod.MultiAgentTrainer(env, agents, seed=7)
        trainer.train(25)
        logs.append(dict(trainer.rewards_log))
        logs.append(mod.test_agents(env, agents, n_steps=10, seed=3))
    assert logs[0] == logs[2] and logs[1] == logs[3]
    assert set(logs[0]) == {0, 1, 2}


def test_checkpoint_agent_acts_greedily():
    """dqn-agent-3 (dense, window 7 x 7 x 6) picks the argmax of the JAX
    package's Q-values on the façade's observations."""
    import os

    from dronerl_tpu.helpers import CheckpointAgent as JaxCheckpointAgent
    from dronerl_tpu_torch.evaluator.evaluator import BASELINES

    path = os.path.join(BASELINES, "dqn-agent-3.safetensors")
    env = make({"n_drones": 3, "grid_size": 10})
    obs, _ = env.reset(seed=2)
    ours = helpers.CheckpointAgent(path, env)
    theirs = JaxCheckpointAgent(path, JaxEnv({"n_drones": 3,
                                              "grid_size": 10}))
    assert [ours.act(obs[i]) for i in range(3)] == [
        theirs.act(obs[i]) for i in range(3)]


def test_plots_render_to_files(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    log = {0: [0.1, -1.0, 1.0] * 10, 1: [0.0] * 30}
    ax = helpers.plot_cumulative_rewards(log, drone_ids=[0])
    ax.figure.savefig(tmp_path / "cum.png")
    ax2 = helpers.plot_rolling_rewards(log, window=5)
    ax2.figure.savefig(tmp_path / "roll.png")
    assert (tmp_path / "cum.png").exists()
    assert (tmp_path / "roll.png").exists()


def test_plots_name_the_missing_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="need matplotlib"):
        helpers.plot_cumulative_rewards({0: [1.0]})


def test_sweep_config_and_trial_argv(monkeypatch):
    """The JAX sweep's space; every swept parameter reaches the trial's
    argv, which the trainer CLI parses; ``--use_sharding`` where the env
    batch divides over several ranks; all with ``wandb`` blocked."""
    from dronerl_tpu import sweep as jsweep
    from dronerl_tpu_torch import train

    monkeypatch.setitem(sys.modules, "wandb", None)
    assert sweep.SWEEP_CONFIG == jsweep.SWEEP_CONFIG
    params = sweep.SWEEP_CONFIG["parameters"]
    src = inspect.getsource(sweep.trial_argv)
    for key in params:
        assert f"cfg.{key}" in src, f"swept parameter {key} not wired"
    cfg = types.SimpleNamespace(**{k: v["values"][-1] for k, v in
                                   params.items()})
    cfg.topology, cfg.num_envs = "dense:64,32", 64
    argv = sweep.trial_argv(cfg, 100, world=1, device="cpu")
    args = train.parse_args(argv)
    assert args.hidden_layers == [64, 32] and args.num_envs == 64
    assert args.gamma == cfg.gamma and args.n_drones == cfg.n_drones
    assert not args.use_sharding and args.device == "cpu"
    assert "--use_sharding" in sweep.trial_argv(cfg, 100, world=4)
    cfg.num_envs = 1
    assert "--use_sharding" not in sweep.trial_argv(cfg, 100, world=4)
    cfg.topology = "conv:32"
    assert train.parse_args(sweep.trial_argv(cfg, 100)).conv_dense_layers \
        == [32]
    assert sweep.world_size() == 1
    with pytest.raises(ImportError):
        sweep.run_trial(10, "cpu")


def test_benchmark_single_config_runs():
    row = benchmark.bench_config("Default", {}, n_drones=3, steps=5,
                                 num_envs=8, device="cpu")
    for key in ("env_steps_per_s", "act_steps_per_s", "learn_steps_per_s",
                "fused_obs_per_s"):
        assert row[key] > 0
    assert (row["config"], row["n_drones"], row["grid"]) == ("Default", 3,
                                                             8)


def test_benchmark_cli_on_the_fused_engine(capsys):
    """At 128 envs on grid 9 with 4 drones the full loop runs the fused
    engine (B4's plain version here); the table names the device."""
    rows = benchmark.main(["--steps", "2", "--num_envs", "128", "--configs",
                           "Default", "--drone_counts", "4", "--device",
                           "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "device: cpu"
    assert len(rows) == 1 and rows[0]["fused_obs_per_s"] > 0
