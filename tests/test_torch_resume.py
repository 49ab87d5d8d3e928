"""Train states, resume and warm start in the PyTorch port's trainer:
``train(2N)`` equals ``train(N)`` + resume + ``train(N)`` bit for bit on
every engine, a warm start installs its checkpoint as the JAX trainer's
does, and a warm-started run of the port and one of the JAX package save
the same params."""

import os

import numpy as np
import pytest
import torch

from dronerl_tpu import train as jax_train
from dronerl_tpu.interop import safetensors_io as jax_io
from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.evaluator import evaluator
from dronerl_tpu_torch.interop import safetensors_io, train_state_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENT_1 = os.path.join(evaluator.BASELINES, "dqn-agent-1.safetensors")
# The CLI's engine for each case (at most 4 env-batches of replay: the
# ring; more: the full engine, or the fused one for a conv net without
# --conv_matmul; below 128 envs: the jnp engine).
ENGINES = {
    "jnp": ["--num_envs", "4", "--memory_size", "64"],
    "ring": ["--num_envs", "128", "--memory_size", "256"],
    "ring_in_kernel_td": ["--num_envs", "128", "--memory_size", "256",
                          "--in_kernel_td"],
    "full": ["--num_envs", "128", "--memory_size", "1024"],
    "fused": ["--num_envs", "128", "--memory_size", "1024",
              "--network_type", "conv"],
}


def run(run_dir, steps, flags, *extra):
    """One CLI run on the CPU that saves its train state; ε's decay is
    pinned (the derived one depends on --num_steps)."""
    metrics = train.main([
        "--device", "cpu", "--num_steps", str(steps), "--skip_final_eval",
        "--save_train_state", "--epsilon_decay", "0.995", "--run_dir",
        str(run_dir), *flags, *extra])
    return metrics, os.path.join(str(run_dir), train.TRAIN_STATE_FILE)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_resume_bitwise(tmp_path, engine):
    """The whole carry (key, envs, ring or replay, nets, Adam, ε, the
    in-kernel TD batch, step) after 8 ticks equals the one after 4 ticks,
    a save, a resume and 4 more, tensor for tensor."""
    flags = ENGINES[engine]
    metrics, whole = run(tmp_path / "whole", 8, flags)
    assert metrics["engine"] == engine.split("_")[0]
    _, half = run(tmp_path / "half1", 4, flags)
    _, resumed = run(tmp_path / "half2", 4, flags, "--resume_from", half)
    a, meta_a = safetensors_io.read(whole)
    b, meta_b = safetensors_io.read(resumed)
    assert meta_a == meta_b
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key
    # The resumed run started where the first half stopped.
    assert safetensors_io.read(half)[1] != meta_b


def test_restore_checks_the_template(tmp_path):
    """A train state loads only into a carry of the same structure, shapes
    and dtypes."""
    _, path = run(tmp_path / "a", 2, ENGINES["ring"])
    args = train.parse_args(["--device", "cpu", *ENGINES["ring"]])
    env = train.env_params_from_args(args)
    for hidden, match in (((16, 16), None), ((8,), "does not match"),
                          ((16, 8), "in the template")):
        agent = DQN(DQNConfig(hidden_layers=hidden), env, device="cpu")
        carry = train.init_ring_carry(agent, env, 128, 256, rng.PRNGKey(1),
                                      obs_dtype=torch.bfloat16)
        if match is None:
            restored = train_state_io.restore(path, carry)
            assert restored[-1] == 2 and restored[1][1].is_contiguous()
        else:
            with pytest.raises(ValueError, match=match):
                train_state_io.restore(path, carry)


def test_warm_start_installs_checkpoint_params(tmp_path):
    """--load_from_checkpoint puts dqn-agent-1 into the online and target
    nets with a fresh Adam and ε; its (8,) topology replaces the CLI's.
    2 ticks of 2 envs never reach a batch of 8, so the saved net is the
    checkpoint's (``tests/test_train.py``'s JAX lock)."""
    metrics, state_path = run(
        tmp_path / "warm", 2, ["--num_envs", "2", "--memory_size", "64"],
        "--load_from_checkpoint", AGENT_1, "--save_final_checkpoint")
    assert metrics["engine"] == "jnp"
    src = safetensors_io.load_file(AGENT_1)
    out = safetensors_io.load_file(
        str(tmp_path / "warm" / "agent_2_steps_jax.safetensors"))
    assert set(src) == set(out)
    for key in src:
        np.testing.assert_array_equal(src[key], out[key])
    state, _ = safetensors_io.read(state_path)
    params = [state[f"3.params.{i}"] for i in range(4)]
    assert [tuple(p.shape) for p in params] == [(294, 8), (8,), (8, 5), (5,)]
    for i, p in enumerate(params):
        assert torch.equal(state[f"3.target_params.{i}"], p)
        assert not state[f"3.opt_state.mu.{i}"].any()
        assert not state[f"3.opt_state.nu.{i}"].any()
    # ε from its start value, decayed once (every 5 ticks, tick 0 too).
    assert state["3.epsilon"].item() == np.float32(0.995)


def test_warm_start_matches_jax(tmp_path):
    """The jnp engine warm-started from dqn-agent-1 with one --seed in the
    port and in the JAX package: the saved params agree within the
    trainer tolerance (atol 1e-5) after 20 ticks of 4 envs."""
    common = ["--num_envs", "4", "--memory_size", "64", "--num_steps", "20",
              "--skip_final_eval", "--save_final_checkpoint", "--seed", "3",
              "--load_from_checkpoint", AGENT_1]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_train.train(jax_train.parse_args(common + [
        "--run_dir", str(jax_dir), "--jax_cache_dir",
        os.path.join(REPO, ".jax_cache")]))
    metrics = train.main(common + ["--device", "cpu", "--run_dir",
                                   str(port_dir)])
    assert metrics["td_loss_mean"] is not None  # it trained
    for fmt in ("jax", "torch"):
        name = f"agent_20_steps_{fmt}.safetensors"
        want = jax_io.load_checkpoint(str(jax_dir / name))[1]["params"]
        got = safetensors_io.load_checkpoint(str(port_dir / name))[1][
            "params"]
        assert set(want) == set(got)
        for layer in want:
            for leaf in want[layer]:
                np.testing.assert_allclose(
                    got[layer][leaf], np.asarray(want[layer][leaf]),
                    rtol=0, atol=1e-5, err_msg=f"{fmt} {layer}.{leaf}")
    src = safetensors_io.load_file(AGENT_1)
    moved = safetensors_io.load_file(
        str(port_dir / "agent_20_steps_jax.safetensors"))
    assert any(not np.array_equal(src[k], moved[k]) for k in src)


def test_train_states_do_not_cross(tmp_path):
    """The JAX package's msgpack train state is refused by the port."""
    state = tmp_path / "train_state.msgpack"
    state.write_bytes(b"\x82\xa10\x00")
    args = train.parse_args(["--device", "cpu", "--num_envs", "2",
                             "--num_steps", "1", "--skip_final_eval",
                             "--run_dir", str(tmp_path / "r"),
                             "--resume_from", str(state)])
    with pytest.raises(safetensors_io.CheckpointFormatError):
        train.train(args)
