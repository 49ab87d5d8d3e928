"""Weights checkpoints of the PyTorch port against the JAX package's: the
port's safetensors reader and writer, both formats in both directions, the
five frozen baselines and the format guard."""

import os

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from dronerl_tpu.agents.dqn import DQN as JaxDQN
from dronerl_tpu.agents.dqn import DQNConfig as JaxConfig
from dronerl_tpu.env.types import EnvParams as JaxEnv
from dronerl_tpu.interop import safetensors_io as jax_io
from dronerl_tpu_torch import rng
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.evaluator import evaluator
from dronerl_tpu_torch.interop import safetensors_io, train_state_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BASELINES = os.path.join(REPO, "dronerl_tpu", "evaluator", "baselines")
CONV = ({"kernel_size": 3, "out_channels": 8, "padding": 1, "stride": 1},)
# (name, env fields, config fields): a dense net, a conv net and a net on
# the global observation.
NETS = (
    ("dense", {}, dict(hidden_layers=(16, 8))),
    ("conv", {}, dict(network_type="conv", conv_layers=CONV,
                      conv_dense_layers=(16,))),
    ("global", dict(wrapper="global", grid_size=6, n_drones=2,
                    skyscrapers_factor=1), dict(hidden_layers=(8,))),
)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            safetensors_io.flatten_dict(jax.device_get(tree)).items()}


def _assert_trees_equal(a, b):
    a, b = _flat(a), _flat(b)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("name,env,cfg", NETS, ids=[n[0] for n in NETS])
def test_port_checkpoints_load_in_jax(tmp_path, name, env, cfg):
    """The port writes both formats; the JAX package's loader and the
    safetensors package read them, with the JAX-written file's arrays and
    metadata (the nets are the same: ``init_state`` from one key)."""
    agent = DQN(DQNConfig(**cfg), EnvParams(**env), device="cpu")
    state = agent.init_state(rng.PRNGKey(3))
    jagent = JaxDQN(JaxConfig(**cfg), JaxEnv(**env))
    jstate = jagent.init_state(jax.random.PRNGKey(3))
    for fmt in ("jax", "torch"):
        ours, theirs = tmp_path / f"port_{fmt}.st", tmp_path / f"jax_{fmt}.st"
        (agent.save if fmt == "jax" else agent.save_as_torch)(
            str(ours), state)
        (jagent.save if fmt == "jax" else jagent.save_as_torch)(
            str(theirs), jstate)
        assert jax_io.read_metadata(str(ours)) == jax_io.read_metadata(
            str(theirs))
        a, b = load_file(str(ours)), load_file(str(theirs))
        assert set(a) == set(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        config, params = jax_io.load_checkpoint(str(ours))
        assert config.network_type == jagent.config.network_type
        _assert_trees_equal(params, jstate.params)


@pytest.mark.parametrize("name,env,cfg", NETS, ids=[n[0] for n in NETS])
def test_jax_checkpoints_load_in_port(tmp_path, name, env, cfg):
    """The JAX package writes both formats; the port reads them into the
    JAX package's flax tree and its net gives the JAX Q-values."""
    jenv = JaxEnv(**env)
    jagent = JaxDQN(JaxConfig(**cfg), jenv)
    jstate = jagent.init_state(jax.random.PRNGKey(5))
    obs = np.random.default_rng(0).random(
        (16, int(np.prod(jenv.obs_shape)))).astype(np.float32)
    want = np.asarray(jagent.q_values(jstate.params, obs))
    for fmt in ("jax", "torch"):
        path = str(tmp_path / f"{fmt}.st")
        (jagent.save if fmt == "jax" else jagent.save_as_torch)(path, jstate)
        config, params = safetensors_io.load_checkpoint(path)
        _assert_trees_equal(params, jstate.params)
        assert config.network_type == jagent.config.network_type
        assert config.hidden_layers == jagent.config.hidden_layers
        assert config.conv_dense_layers == jagent.config.conv_dense_layers
        agent, net = DQN.restore(path, EnvParams(**env), device="cpu")
        got = agent.q_values(net, torch.from_numpy(obs)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_baselines_match_jax_q_values():
    """The five frozen baselines load in the port (dqn-agent-5 is a conv
    net) and give the JAX package's Q-values on seeded observations (0/1
    cells, as an observation's channels but charge are)."""
    obs = (np.random.default_rng(7).random((64, 294)) < 0.3).astype(
        np.float32)
    for i in range(1, 6):
        path = os.path.join(evaluator.BASELINES, f"dqn-agent-{i}.safetensors")
        jagent, jparams = JaxDQN.restore(path, JaxEnv())
        agent, net = DQN.restore(path, EnvParams(), device="cpu")
        assert agent.config.network_type == jagent.config.network_type
        want = np.asarray(jagent.q_values(jparams, obs))
        got = agent.q_values(net, torch.from_numpy(obs)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"dqn-agent-{i}")


def test_baselines_are_byte_copies():
    for i in range(1, 6):
        name = f"dqn-agent-{i}.safetensors"
        with open(os.path.join(evaluator.BASELINES, name), "rb") as f:
            ours = f.read()
        with open(os.path.join(JAX_BASELINES, name), "rb") as f:
            assert ours == f.read(), name


def test_format_guard(tmp_path):
    """A jax file through the torch loader, a torch file through the jax
    loader, an unknown format, a file that is no safetensors file and a
    weights file given as a train state all raise."""
    agent = DQN(DQNConfig(hidden_layers=(4,)), EnvParams(), device="cpu")
    state = agent.init_state(rng.PRNGKey(0))
    jax_path, torch_path = str(tmp_path / "j.st"), str(tmp_path / "t.st")
    agent.save(jax_path, state)
    agent.save_as_torch(torch_path, state)
    err = safetensors_io.CheckpointFormatError
    with pytest.raises(err, match="not a torch-format"):
        safetensors_io.load_torch(jax_path)
    with pytest.raises(err, match="not a jax-format"):
        safetensors_io.load_jax(torch_path)
    odd = str(tmp_path / "odd.st")
    safetensors_io.write(odd, {"x": np.zeros(2, np.float32)},
                         {"checkpoint_format": "onnx"})
    with pytest.raises(err, match="Unknown checkpoint format"):
        safetensors_io.load_checkpoint(odd)
    junk = tmp_path / "junk.st"
    junk.write_bytes(b"\x05\x00")
    with pytest.raises(err, match="not a safetensors file"):
        safetensors_io.read(str(junk))
    with pytest.raises(err, match="not a train state"):
        train_state_io.restore(jax_path, (torch.zeros(2),))


def test_reader_and_writer_against_the_package(tmp_path):
    """Every dtype the train states use, bfloat16 and 0-d and empty
    tensors included, round-trips through the port and reads alike in the
    safetensors package."""
    from safetensors.torch import load_file as torch_load
    from safetensors.torch import save_file as torch_save

    gen = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=gen),
        "bf16": torch.randn(4, 6, generator=gen).to(torch.bfloat16),
        "i64": torch.tensor([1, -2, 3]),
        "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "i8": torch.tensor([[-1, 5]], dtype=torch.int8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(0.25),
        "empty": torch.zeros((0, 3)),
    }
    ours = str(tmp_path / "ours.st")
    safetensors_io.write(ours, tensors, {"k": "v"})
    back, meta = safetensors_io.read(ours)
    assert meta == {"k": "v"}
    pkg = torch_load(ours)
    for key, t in tensors.items():
        assert torch.equal(back[key], t) and back[key].dtype == t.dtype, key
        assert torch.equal(pkg[key], t), key
    theirs = str(tmp_path / "theirs.st")
    torch_save(tensors, theirs, metadata={"k": "v"})
    back, meta = safetensors_io.read(theirs)
    assert meta == {"k": "v"}
    for key, t in tensors.items():
        assert torch.equal(back[key], t), key
