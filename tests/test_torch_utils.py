"""The PyTorch port's metric loggers, profiling hooks, ``env.core.rollout``
and ``random_actions`` (against the JAX package's), and the port's
independence from the packages the card's machine lacks."""

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from dronerl_tpu.agents.random_agent import random_actions as jax_random
from dronerl_tpu.env import core as jax_core
from dronerl_tpu.env.types import EnvParams as JaxEnv
from dronerl_tpu_torch import rng
from dronerl_tpu_torch.agents.random_agent import random_actions
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.utils import metrics, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_random_actions_match_jax():
    for seed, shape in ((0, ()), (3, (7,)), (9, (3, 4))):
        got = random_actions(rng.PRNGKey(seed), shape)
        want = jax_random(jax.random.PRNGKey(seed), shape)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rollout_matches_jax():
    """10 ticks under a random policy, the key split three ways a tick:
    the final state, rewards and dones equal the JAX package's."""
    params = dict(grid_size=7, n_drones=3)
    jparams, tparams = JaxEnv(**params), EnvParams(**params)
    key = jax.random.PRNGKey(5)
    jstate = jax_core.reset(key, jparams)
    want = jax_core.rollout(key, jstate, jparams, 10,
                            lambda k, s: jax_random(k, (3,)))
    tstate = core.reset(rng.PRNGKey(5), tparams)
    got = core.rollout(rng.PRNGKey(5), tstate, tparams, 10,
                       lambda k, s: random_actions(k, (3,)))
    for field in ("ground", "air_x", "air_y", "carrying_package", "charge"):
        np.testing.assert_array_equal(getattr(got[0], field).numpy(),
                                      np.asarray(getattr(want[0], field)))
    assert tuple(got[1].shape) == (10, 3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


class _Sink(metrics.Logger):
    def __init__(self):
        self.seen = []

    def log_scalar(self, tag, value, step):
        self.seen.append(("s", tag, value, step))

    def log_histogram(self, tag, values, step):
        self.seen.append(("h", tag, len(values), step))

    def close(self):
        self.seen.append("closed")


def test_loggers(tmp_path, monkeypatch, caplog):
    assert isinstance(metrics.build_logger(), metrics.NoLogger)
    stdout = metrics.build_logger(stdout=True)
    assert isinstance(stdout, metrics.StdoutLogger)
    with caplog.at_level("INFO"):
        stdout.log_scalars({"a": 1.5}, step=3)
        stdout.log_histogram("h", torch.tensor([1.0, 2.0]), step=3)
    assert "a = 1.5" in caplog.text and "h histogram mean=1.5" in caplog.text
    a, b = _Sink(), _Sink()
    fan = metrics.MultiLogger([a, b])
    fan.log_scalars({"x": 1.0, "y": 2.0}, step=1)
    fan.log_histogram("q", torch.zeros(4), step=1)
    fan.close()
    assert a.seen == b.seen == [("s", "x", 1.0, 1), ("s", "y", 2.0, 1),
                                ("h", "q", 4, 1), "closed"]

    class Run:
        def __init__(self):
            self.logged = []

        def log(self, values, step):
            self.logged.append((values, step))

    fake = types.ModuleType("wandb")
    fake.Histogram = lambda values: ("hist", list(values))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    run = Run()
    sink = metrics.build_logger(wandb_run=run)
    sink.log_scalar("r", 0.5, step=2)
    sink.log_histogram("q", torch.tensor([1.0]), step=2)
    assert run.logged == [({"r": 0.5}, 2), ({"q": ("hist", [1.0])}, 2)]

    both = metrics.build_logger(tensorboard_dir=str(tmp_path / "tb"),
                                wandb_run=Run(), stdout=True)
    assert isinstance(both, metrics.MultiLogger) and len(both.loggers) == 3
    both.log_scalars({"r": 1.0}, step=1)
    both.log_histogram("q", np.arange(5.0), step=1)
    both.close()
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path / "tb"))


def test_tensorboard_missing_warns_and_keeps_the_other_sinks(
        tmp_path, monkeypatch, caplog):
    """As the JAX package's ``build_logger``: a TensorBoard directory
    without the package is skipped with a warning, and the other sinks
    stay."""
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    monkeypatch.delitem(sys.modules, "torch.utils.tensorboard",
                        raising=False)
    with caplog.at_level("WARNING", logger=metrics.logger.name):
        alone = metrics.build_logger(tensorboard_dir=str(tmp_path / "tb"))
        rest = metrics.build_logger(tensorboard_dir=str(tmp_path / "tb"),
                                    stdout=True)
    assert isinstance(alone, metrics.NoLogger)
    assert isinstance(rest, metrics.StdoutLogger)
    assert [r.getMessage() for r in caplog.records] == [
        "tensorboard unavailable; skipping TB logging"] * 2
    assert not os.path.exists(tmp_path / "tb")


def test_profiling_hooks(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / profiling.TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)
    with profiling.Stopwatch() as watch:
        x = torch.ones(8).sum()
        assert watch.stop(x) > 0
    stats = profiling.device_memory_stats()
    if torch.cuda.is_available():
        assert {"bytes_in_use", "peak_bytes_in_use",
                "bytes_limit"} <= set(stats)
    else:
        assert stats == {}
    profiling.log_device_memory("test ")


def test_memory_stats_read_the_current_device(monkeypatch, caplog):
    """Without an index the memory helpers read the current CUDA device
    (a rank's own card after ``set_device``), not cuda:0; under a process
    group ``log_device_memory`` logs that card alone. The CUDA calls are
    stand-ins that record the device asked for."""
    asked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: asked.append(
        d) or {"allocated_bytes.all.current": 2**20})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (0, 2**30))
    cuda = torch.device
    assert profiling.device_memory_stats()["bytes_limit"] == 2**30
    profiling.device_memory_stats("cuda")
    profiling.device_memory_stats("cuda:1")
    assert asked == [cuda("cuda", 3), cuda("cuda", 3), cuda("cuda", 1)]
    asked.clear()
    with caplog.at_level("INFO", logger=profiling.logger.name):
        profiling.log_device_memory()
        assert asked == [cuda("cuda", i) for i in range(4)]
        asked.clear()
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: True)
        profiling.log_device_memory("rank ")
    assert asked == [cuda("cuda", 3)]
    assert "rank cuda:3: 1.0 MiB in use" in caplog.text


BLOCKED = ("safetensors", "msgpack", "PIL", "tensorboard", "wandb", "jax",
           "jaxlib", "flax", "optax", "dronerl_tpu", "matplotlib")
# The modules of the port's last slice, which must be among those imported.
PERIPHERY = ("dronerl_tpu_torch.parallel.mesh",
             "dronerl_tpu_torch.parallel.launch",
             "dronerl_tpu_torch.parallel.distributed",
             "dronerl_tpu_torch.env.debug", "dronerl_tpu_torch.env.gymapi",
             "dronerl_tpu_torch.helpers", "dronerl_tpu_torch.sweep",
             "dronerl_tpu_torch.benchmark")


def test_port_runs_without_the_missing_packages(tmp_path):
    """With safetensors, msgpack, PIL, tensorboard, wandb and matplotlib
    (and JAX and the JAX package) blocked, every module of the port (the
    sharded trainer and the periphery among them) and chip_smoke.py
    import, and a CLI run writes both checkpoints and a train state that
    a second run resumes from."""
    code = f"""
import importlib, os, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
sys.path.insert(0, {REPO!r})
import dronerl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    dronerl_tpu_torch.__path__, "dronerl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert set({PERIPHERY!r}) <= set(names), names
import chip_smoke
from dronerl_tpu_torch import train
from dronerl_tpu_torch.agents.dqn import DQN
from dronerl_tpu_torch.env.types import EnvParams
run = {str(tmp_path / "run")!r}
flags = ["--device", "cpu", "--num_envs", "128", "--memory_size", "256",
         "--num_steps", "2", "--skip_final_eval", "--save_train_state",
         "--save_final_checkpoint"]
train.main(flags + ["--run_dir", run])
train.main(flags + ["--run_dir", run + "2", "--resume_from",
                    os.path.join(run, train.TRAIN_STATE_FILE)])
for fmt in ("jax", "torch"):
    DQN.restore(os.path.join(run, f"agent_2_steps_{{fmt}}.safetensors"),
                EnvParams(), device="cpu")
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 30


def _counter_tick(carry):
    key, total = carry
    split = rng.split(key, 2)
    key, draw = split[..., 0, :], split[..., 1, :]
    value = rng.randint(draw, (3,), 0, 100)
    return (key, total + value), (value, total)


def test_scan_stacks_a_tick():
    """On the CPU ``scan`` is the eager loop: the last carry and each
    output stacked over the ticks."""
    from dronerl_tpu_torch.utils.graphs import scan

    carry = (rng.PRNGKey(4)[None].repeat(2, 1), torch.zeros((2, 3),
                                                          dtype=torch.int32))
    last, (values, totals) = scan(_counter_tick, carry, 5)
    want, seen = carry, []
    for _ in range(5):
        want, (value, _) = _counter_tick(want)
        seen.append(value)
    assert values.shape == (5, 2, 3) and totals.shape == (5, 2, 3)
    assert torch.equal(values, torch.stack(seen))
    assert torch.equal(last[1], want[1]) and torch.equal(last[0], want[0])
    assert torch.equal(totals[0], carry[1])


@pytest.mark.gpu
def test_scan_graph_equals_eager_on_the_card():
    """On the card ``scan`` replays one CUDA graph of the tick; its
    carry and outputs equal the eager loop's bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dronerl_tpu_torch.utils.graphs import scan

    carry = (rng.PRNGKey(4)[None].repeat(2, 1).cuda(),
             torch.zeros((2, 3), dtype=torch.int32, device="cuda"))
    last, (values, totals) = scan(_counter_tick, carry, 7)
    want, seen = carry, []
    for _ in range(7):
        want, (value, _) = _counter_tick(want)
        seen.append(value)
    assert torch.equal(values, torch.stack(seen))
    assert torch.equal(last[1], want[1]) and torch.equal(last[0], want[0])
