"""Evaluation, the competition arena and the trainer's lifecycle in the
PyTorch port, against the JAX package: ``train.evaluate``, its key
streams, ``evaluate_checkpoints``, ``arena_params``, the eval-arena guard,
the CLI's option set and a whole CLI run with its files, scalars and
histograms."""

import argparse
import inspect
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from dronerl_tpu import train as jax_train
from dronerl_tpu.agents.dqn import DQN as JaxDQN
from dronerl_tpu.agents.dqn import DQNConfig as JaxConfig
from dronerl_tpu.evaluator import evaluator as jax_evaluator
from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.constants import NO_TRAIN_LOSS
from dronerl_tpu_torch.evaluator import evaluator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV = ({"kernel_size": 3, "out_channels": 8, "padding": 1, "stride": 1},)
NETS = {"dense": dict(hidden_layers=(16, 16)),
        "conv": dict(network_type="conv", conv_layers=CONV,
                     conv_dense_layers=(16,))}


class ProbeLogger:
    def __init__(self):
        self.records = []
        self.histograms = []

    def log_scalar(self, tag, value, step):
        self.records.append((tag, value, step))

    def log_scalars(self, values, step):
        for tag, value in values.items():
            self.log_scalar(tag, value, step)

    def log_histogram(self, tag, values, step):
        self.histograms.append((tag, np.asarray(torch.as_tensor(
            values).float()), step))

    def close(self):
        pass


@pytest.mark.parametrize("net", list(NETS))
def test_evaluate_matches_jax(net):
    """2 seeds × 50 steps of greedy drone 0 against random drones, the
    nets the same (``init_state`` from one key): the means and stds equal
    the JAX package's up to the f32 rounding of a per-seed mean (a
    different trajectory moves a mean by at least 0.002)."""
    argv = ["--num_evals", "2", "--num_eval_steps", "50", "--eval_seed", "11"]
    jargs = jax_train.parse_args(argv)
    targs = train.parse_args(argv + ["--device", "cpu"])
    jagent = JaxDQN(JaxConfig(**NETS[net]),
                    jax_train.env_params_from_args(jargs, eval_mode=True))
    agent = DQN(DQNConfig(**NETS[net]),
                train.env_params_from_args(targs, eval_mode=True), "cpu")
    want = jax_train.evaluate(jargs, jagent,
                              jagent.init_state(jax.random.PRNGKey(2)))
    got = train.evaluate(targs, agent, agent.init_state(rng.PRNGKey(2)))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-6,
                               atol=1e-7)


def test_eval_tick_streams_are_independent():
    """The carry, the opponents' randint, the agent's act call and the env
    step each take their own key, ``jax.random.split(rng, 4)``'s."""
    keys = train._eval_tick_keys(rng.PRNGKey(7))
    assert len(keys) == 4
    assert len({tuple(k.tolist()) for k in keys}) == 4
    want = np.asarray(jax.random.split(jax.random.PRNGKey(7), 4))
    np.testing.assert_array_equal(
        np.stack([k.numpy() for k in keys]).astype(np.uint32), want)
    src = inspect.getsource(train.evaluate)
    assert re.search(r"randint\(\s*opp_key", src)
    assert re.search(r"agent\.act\(act_key", src)
    assert re.search(r"step_batch\(step_key", src)


def test_evaluate_checkpoints_matches_jax():
    """Three baselines (dqn-agent-5 a conv net) on 2 seeds × 100 steps:
    the episode scores equal the JAX package's up to the f32 rounding of
    their sums, and no step of the port's run had a near tie that could
    have parted the two."""
    paths = [os.path.join(evaluator.BASELINES, f"dqn-agent-{i}.safetensors")
             for i in (1, 3, 5)]
    want = jax_evaluator.evaluate_checkpoints(
        paths, episode_seeds=(845, 99), num_steps=100)
    got = evaluator.evaluate_checkpoints(
        paths, episode_seeds=(845, 99), num_steps=100, device="cpu")
    assert got["actions"].shape == got["q_gap"].shape == (100, 2, 3)
    assert got["q_gap"].min() > 1e-5
    np.testing.assert_allclose(got["episode_scores"], want["episode_scores"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["std"], want["std"], rtol=0, atol=1e-4)


def test_arena_sizing():
    for n in (1, 3, 5, 6, 20):
        ours, theirs = evaluator.arena_params(n), jax_evaluator.arena_params(n)
        assert (ours.grid_size, ours.n_drones, ours.window_radius) == (
            theirs.grid_size, theirs.n_drones, theirs.window_radius)
    assert evaluator.arena_params(6).grid_size == 11
    assert evaluator.EPISODE_SEEDS == jax_evaluator.EPISODE_SEEDS


def test_eval_grid_size_rejected_for_global_wrapper():
    args = train.parse_args(["--wrapper", "global", "--eval_grid_size", "12"])
    with pytest.raises(ValueError, match="global"):
        train.env_params_from_args(args, eval_mode=True)
    args = train.parse_args(["--eval_grid_size", "3"])
    with pytest.raises(ValueError, match="cells"):
        train.env_params_from_args(args, eval_mode=True)
    # train() checks the eval arena before it trains.
    args = train.parse_args(["--device", "cpu", "--eval_grid_size", "3",
                             "--num_envs", "2", "--num_steps", "1"])
    with pytest.raises(ValueError, match="cells"):
        train.train(args)


def _options(parse, monkeypatch):
    """The option strings of the parser that ``parse([])`` builds."""
    seen = {}
    for name in ("parse_args", "parse_known_args"):
        original = getattr(argparse.ArgumentParser, name)

        def grab(self, *a, _original=original, **k):
            seen["parser"] = self
            return _original(self, *a, **k)

        monkeypatch.setattr(argparse.ArgumentParser, name, grab)
    parse([])
    monkeypatch.undo()
    return {s for a in seen["parser"]._actions for s in a.option_strings}


def test_cli_options_match_jax(monkeypatch):
    """Every option of the JAX CLI but the four sharding flags and
    --jax_cache_dir, which are refused with their reason; the port adds
    --device and --in_kernel_td; a default run takes the final eval."""
    jax_opts = _options(jax_train.parse_args, monkeypatch)
    ours = _options(train.parse_args, monkeypatch)
    refused = set(train.REFUSED_FLAGS)
    assert refused == {"--use_sharding", "--coordinator_address",
                       "--num_processes", "--process_id", "--jax_cache_dir"}
    assert jax_opts - refused <= ours
    assert not ours & refused
    assert ours - jax_opts == {"--device", "--in_kernel_td"}
    for flag, value in (("--use_sharding", None), ("--process_id", "1"),
                        ("--jax_cache_dir", "c")):
        with pytest.raises(SystemExit, match=re.escape(flag)):
            train.parse_args([flag] + ([value] if value else []))
    args = train.parse_args([])
    assert not args.skip_final_eval and args.num_evals == 5
    assert args.num_eval_steps == 10_000 and args.max_scan_steps == 100_000


@pytest.mark.parametrize("in_kernel_td", [False, True])
def test_cli_lifecycle_on_cpu(tmp_path, in_kernel_td):
    """chip_smoke.py phase 5a's flags at a small size on the ring engine:
    warm start from dqn-agent-3, 2 chunks with an eval before the second,
    the final eval, both checkpoints and the train state; metrics.json
    with the JAX CLI's keys; per-chunk scalars with the warm-up
    NO_TRAIN_LOSS ticks masked; histograms of trained losses only."""
    agent_3 = os.path.join(evaluator.BASELINES, "dqn-agent-3.safetensors")
    flags = ["--num_steps", "6", "--max_scan_steps", "3",
             "--eval_while_training", "--num_evals", "2",
             "--num_eval_steps", "20", "--save_final_checkpoint",
             "--load_from_checkpoint", agent_3, "--epsilon_decay", "0.995"]
    probe = ProbeLogger()
    run_dir = tmp_path / "port"
    metrics = train.train(train.parse_args(
        flags + ["--device", "cpu", "--num_envs", "128", "--memory_size",
                 "256", "--save_train_state", "--run_dir", str(run_dir)]
        + (["--in_kernel_td"] if in_kernel_td else [])), probe)
    assert metrics["engine"] == "ring"
    files = set(os.listdir(run_dir))
    assert files == {"agent_6_steps_jax.safetensors",
                     "agent_6_steps_torch.safetensors", "metrics.json",
                     train.TRAIN_STATE_FILE}
    jax_dir = tmp_path / "jax"
    jax_train.train(jax_train.parse_args(flags + [
        "--num_envs", "2", "--memory_size", "64", "--run_dir", str(jax_dir),
        "--jax_cache_dir", os.path.join(REPO, ".jax_cache")]))
    with open(run_dir / "metrics.json") as f, \
            open(jax_dir / "metrics.json") as g:
        assert set(json.load(f)) == set(json.load(g))

    by_tag = {}
    for tag, value, step in probe.records:
        by_tag.setdefault(tag, []).append((step, value))
    assert [s for s, _ in by_tag["train_reward"]] == [3, 6]
    assert [s for s, _ in by_tag["epsilon"]] == [3, 6]
    assert [s for s, _ in by_tag["eval_reward"]] == [3, 6]
    # The ring holds 2 env-batches (256 / 128): with the PyTorch learner
    # tick 0 already samples a batch; in-kernel TD trains from tick 1.
    td = by_tag["td_loss"]
    assert [s for s, _ in td] == [3, 6] and all(
        np.isfinite(v) and v >= 0 for _, v in td)
    hists = {}
    for tag, values, step in probe.histograms:
        hists.setdefault(tag, []).append((step, values))
    assert set(hists) == {"td_loss", "q_values", "replay_actions"}
    for _, values in hists["td_loss"]:
        assert (values != NO_TRAIN_LOSS).all() and (values >= 0).all()
    first = hists["td_loss"][0][1]
    assert len(first) == (2 if in_kernel_td else 3)
    for step, values in hists["q_values"]:
        assert values.shape[1] == 5 and np.isfinite(values).all()
    for step, values in hists["replay_actions"]:
        assert values.shape == (min(step, 2) * 128,)


def test_ring_histograms_mask_unwritten_slots():
    """Only the slots written so far count, and with collect_drones > 1
    drone 0's row (``tests/test_train.py``'s JAX lock)."""
    args = train.parse_args(["--device", "cpu"])
    env = train.env_params_from_args(args)
    agent = DQN(train.agent_config_from_args(args), env, "cpu")
    num_envs, capacity, k = 8, 32, 2
    carry = train.init_ring_carry(agent, env, num_envs, capacity,
                                  rng.PRNGKey(0), collect_drones=k)
    key, ring_state, (a, r, d), ag_state, aux, _ = carry
    a[0], a[1] = 1, 2
    probe = ProbeLogger()
    train.log_chunk_histograms(probe, agent, (key, ring_state, (a, r, d),
                                              ag_state, aux, 0),
                               torch.zeros(4), True, False, step=0)
    assert not {t for t, _, _ in probe.histograms} & {"q_values",
                                                       "replay_actions"}
    probe = ProbeLogger()
    train.log_chunk_histograms(probe, agent, (key, ring_state, (a, r, d),
                                              ag_state, aux, 2),
                               torch.zeros(4), True, False, step=2)
    hists = {t: v for t, v, _ in probe.histograms}
    assert (hists["replay_actions"] == 1).all()
    assert hists["replay_actions"].shape == (2 * num_envs,)
    assert hists["q_values"].shape[0] <= 3 * num_envs


@pytest.mark.parametrize("argv,engine,slot_axis", [
    (["--num_envs", "2", "--memory_size", "64"], "jnp", 0),
    (["--num_envs", "128", "--memory_size", "1024"], "full", -1)])
def test_cli_histograms_and_inspect_memory_on_stream_engines(
        tmp_path, argv, engine, slot_axis, monkeypatch):
    """The jnp engine's row-major ReplayBuffer and the full engine's
    feature-major StreamReplay: per-chunk histograms off the replay and
    --inspect_memory with the right slot axis."""
    seen = []
    original = train.replay.inspect_memory

    def spy(state, **kw):
        seen.append(kw["slot_axis"])
        return original(state, **kw)

    monkeypatch.setattr(train.replay, "inspect_memory", spy)
    probe = ProbeLogger()
    metrics = train.train(train.parse_args([
        "--device", "cpu", "--num_steps", "8", "--max_scan_steps", "4",
        "--skip_final_eval", "--inspect_memory", "--run_dir", str(tmp_path)]
        + argv), probe)
    assert metrics["engine"] == engine and seen == [slot_axis]
    tags = [t for t, _, _ in probe.histograms]
    assert tags.count("q_values") == 2 and tags.count("replay_actions") == 2
