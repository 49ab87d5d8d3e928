"""The chunk's own tracing, on the CPU: its phase clock
(``train.Chunk.phase_ns``), the profiler ranges around its table walk,
which open only while a profiler collects, ``train()``'s
``chunk_host_ms``, and ``scripts/torch_chunk_phases.py``, which reads
them on a benchmark cell. No JAX here."""

import contextlib
import importlib.util
import json
import os

import pytest
import torch

from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = EnvParams(grid_size=9, n_drones=4)
EAGER = ("keys", "walk", "upload", "eager", "outputs")


def _ring_chunk():
    agent = DQN(DQNConfig(hidden_layers=(8,)), TP, device="cpu")
    chunk = train.build_chunk_ring(agent, TP, 128, 256, 8, 3)
    return chunk, train.init_ring_carry(agent, TP, 128, 256, rng.PRNGKey(0))


def _chunk_ranges(prof):
    return [ev.name for ev in prof.events()
            if ev.name.startswith(profiling.PHASE_PREFIX + "chunk.")]


def test_eager_chunk_counts_its_phases():
    """Two eager chunks (the CPU's): each eager phase counted above 0, the
    graphed ones absent, the chunks and ticks exact, no capture."""
    chunk, carry = _ring_chunk()
    assert chunk.phase_ns() == {"chunks": 0, "ticks": 0, "captures": 0}
    carry, _ = chunk(carry, 3)
    carry, _ = chunk(carry, 2)
    clock = chunk.phase_ns()
    assert set(clock) == {*EAGER, *train.Chunk.COUNTS}
    assert all(clock[phase] > 0 for phase in EAGER)
    assert (clock["chunks"], clock["ticks"], clock["captures"]) == (2, 5, 0)
    assert chunk.capture_s == 0.0
    clock["walk"] = -1
    assert chunk.phase_ns()["walk"] > 0   # a copy


def test_chunk_ranges_the_walk_under_a_profiler():
    """Under ``torch.profiler`` one chunk opens one range for the key
    table and one for the walk, and no other chunk range."""
    chunk, carry = _ring_chunk()
    carry, _ = chunk(carry, 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        carry, _ = chunk(carry, 3)
    assert sorted(_chunk_ranges(prof)) == ["phase:chunk.keys",
                                           "phase:chunk.walk"]
    carry, _ = chunk(carry, 2)   # the profiler is gone: no range is open
    assert chunk.phase_ns()["chunks"] == 3


def test_no_range_without_a_profiler(monkeypatch):
    """With no profiler running ``record_function`` is never entered; the
    same counter counts the two ranges a chunk opens under one."""
    entered = []

    def counted(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    chunk, carry = _ring_chunk()
    for _ in range(3):
        carry, _ = chunk(carry, 2)
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        carry, _ = chunk(carry, 2)
    assert entered == ["phase:chunk.keys", "phase:chunk.walk"]


def test_phase_clock_counts_each_phase_alone(monkeypatch):
    """A phase inside another counts to itself alone: the outer one's
    time leaves it out, and the two add up to the time they cover."""
    readings = iter([0, 10, 40, 50, 100, 107])
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(readings))
    clock = profiling.PhaseClock("x.", ranged=("outer",))
    clock.look()
    with clock.phase("outer"):
        with clock.phase("inner"):
            pass
    with clock.phase("inner"):
        pass
    monkeypatch.undo()
    clock.count("n")
    clock.count("n", 4)
    assert clock.ns == {"outer": 20, "inner": 37}
    assert clock.counts == {"n": 5}
    with pytest.raises(ValueError):
        with clock.phase("outer"):
            raise ValueError
    assert clock._inner == []


def test_cli_writes_chunk_host_ms(tmp_path):
    """``train()`` on the CPU returns the chunk's host ms a chunk by phase
    with its captures, and writes them into metrics.json."""
    metrics = train.main(["--device", "cpu", "--num_envs", "128",
                          "--memory_size", "256", "--num_steps", "4",
                          "--max_scan_steps", "2", "--skip_final_eval",
                          "--run_dir", str(tmp_path)])
    host = metrics["chunk_host_ms"]
    assert set(host) == {*EAGER, "captures"}
    assert host["captures"] == 0 and metrics["capture_s"] == 0.0
    assert all(host[phase] > 0 for phase in EAGER)
    with open(tmp_path / "metrics.json") as f:
        assert json.load(f)["chunk_host_ms"] == host


def _phases_script():
    path = os.path.join(REPO, "scripts", "torch_chunk_phases.py")
    spec = importlib.util.spec_from_file_location("torch_chunk_phases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_idle_inside_the_walk_ranges():
    """``torch_chunk_phases.idle_inside`` on known intervals (us): the
    card busy over [0, 10] and [30, 40], the walk ranges over [5, 35] and
    [50, 70] and the window [0, 60]: idle inside a range over (10, 30) and
    (50, 60), 30 us."""
    script = _phases_script()
    op = script.trace.Op
    dev = [op("k", 30, 40), op("k", 0, 10)]
    walk = [op("phase:chunk.walk", 50, 70), op("phase:chunk.keys", 5, 20),
            op("phase:chunk.walk", 20, 35)]
    assert script.idle_inside(dev, walk, (0, 60)) == pytest.approx(30e-6)
    assert script.idle_inside([], walk, (0, 60)) == pytest.approx(40e-6)
    assert script.idle_inside(dev, [], (0, 60)) == 0.0
    chunks = [op("portbench:chunk", 0, 45), op("portbench:chunk", 45, 80)]
    gaps = script.longest_gaps([(10, 30), (40, 50), (60, 61)],
                               chunks + walk, chunks, top=2)
    assert [(g["ms"], g["chunk"]) for g in gaps] == [(0.02, 0), (0.01, 1)]
    assert gaps[0]["covered_ms"] == pytest.approx(
        {"phase:chunk.keys": 0.01, "phase:chunk.walk": 0.01})
    assert gaps[1]["covered_ms"] == {}


def test_chunk_phases_script_on_the_cpu(tmp_path):
    """The script on a benchmark cell cut to the CPU: the eager phases a
    tick add up to the enqueue's host time (only the chain's read and a
    few statements lie outside them), the traced chunk opens its two
    ranges, and no device reading is made without a device."""
    out = _phases_script().main([
        "--workload", "dense16.ring.e65536", "--device", "cpu",
        "--num_envs", "128", "--memory_size", "256", "--chunk_ticks", "3",
        "--host_chunks", "2", "--trace_chunks", "1", "--cost", "1",
        "--window_chunks", "1", "--out", str(tmp_path / "phases.json")])
    assert set(out["phase_ms_per_tick"]) == {*EAGER, "sum"}
    assert 0.9 < out["phases_over_host"] <= 1.0
    assert out["replay_ms_per_tick"] is None and out["walk_ms_per_tick"] > 0
    traced = out["traced"]
    assert traced["walk_ranges"] == 2 and traced["mirrored_phase_events"] == []
    assert traced["walk_idle_share"] is None and traced["idle_share"] is None
    assert [c["profiled"] for c in out["cost"]] == [False, True]
    with open(tmp_path / "phases.json") as f:
        assert json.load(f) == json.loads(json.dumps(out))
