"""The port's bench program (``dronerl_tpu_torch.bench``), its companion
scripts and the tick split they share, on the CPU at small sizes.

The JSON line, its correctness verdict and its failure modes; the
settings held to the JAX bench's (``bench.py``: the nets, the protocol's
counts, the ring's shape and dtype from ``jax.eval_shape``); one row of
each of ``scripts/torch_ring_bench.py``, ``torch_config5_bench.py`` and
``torch_scaling_bench.py`` (two gloo ranks). The tick the bench times is
``train.build_train_step_ring``'s, held to JAX by
``tests/test_torch_ring.py``.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys

import jax
import pytest
import torch

from dronerl_tpu_torch import bench
from dronerl_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"DRONERL_BENCH_ENVS": "128", "DRONERL_BENCH_STEPS": "3",
        "DRONERL_BENCH_CALLS": "1", "DRONERL_BENCH_REPEATS": "2",
        "DRONERL_BENCH_REPEATS_BIG": "2"}
METRIC_KEYS = {"metric", "value", "unit", "repeat_s", "median_s", "q1_s",
               "q3_s", "repeats", "steps_per_repeat", "build_s", "graphs",
               "capture_s", "warmup_s", "peak_mem_bytes", "launches"}
LINE_KEYS = METRIC_KEYS | {"extra_metrics", "num_envs", "engine", "seed",
                           "device", "clocks", "correct", "checks",
                           "per_layer"}
DEVICE_FIELDS = ("device_busy_share", "device_ms", "device_ms_by_kernel",
                 "launches_per_tick", "top_device_kernels")


@pytest.fixture
def tiny(monkeypatch):
    """The bench at 128 envs, 3 ticks a call, 2 repeats, a ring of 256
    columns."""
    for name, value in TINY.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(bench, "MEMORY_SIZE", 256)


def run_main(capsys, argv):
    rc = bench.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_json_line_on_the_cpu(tiny, capsys):
    rc, line = run_main(capsys, ["--device", "cpu"])
    assert rc == 0 and line["correct"] is True
    assert LINE_KEYS <= set(line)
    metrics = [line] + line["extra_metrics"]
    assert [m["metric"] for m in metrics] == [
        "train_obs_per_sec_dense16_128envs",
        "train_obs_per_sec_dense16_128envs_in_kernel_td",
        "train_obs_per_sec_dense128x64_128envs",
        "train_obs_per_sec_dense128x64_128envs_in_kernel_td"]
    for m in metrics:
        assert METRIC_KEYS <= set(m) and m["unit"] == "obs/s"
        assert m["repeats"] == 2 and m["steps_per_repeat"] == 3
        assert m["median_s"] == statistics.median(m["repeat_s"])
        assert m["value"] == 128 * 3 * 1 / statistics.median(m["repeat_s"])
        assert m["q1_s"] <= m["median_s"] <= m["q3_s"]
        # The CPU runs the plain versions: no kernel launches, no build.
        assert m["launches"] == {"full_tick_ring": 0, "td_adam": 0}
        assert m["build_s"] is None and m["peak_mem_bytes"] is None
        # The CPU runs the chunk's ticks eagerly: no graph is captured.
        assert m["graphs"] == 0 and m["capture_s"] == 0.0
        checks = line["checks"][m["metric"]]
        assert checks["plain"]["problems"] == []
        assert checks["plain"]["ticks"] == bench.CHECK_TICKS
        assert checks["plain"]["reset_ticks"] == 1
        assert checks["plain"]["trained_ticks"] >= 1
        assert checks["lockstep"]["problems"] == []
        assert checks["lockstep"]["ticks"] == max(bench.CHECK_TICKS, 4)
        assert checks["timed"]["problems"] == []
        assert checks["timed"]["ticks"] == checks["timed"]["trained_ticks"]
        split = line["per_layer"][m["metric"]]
        assert all(split[k] is None for k in DEVICE_FIELDS)
        assert split["ticks"] == bench.TRACE_TICKS
        assert 0 < split["host_ms_per_tick"] <= split["chunk_tick_ms"]
        assert line["clocks"][m["metric"]] == {"before": None, "after": None}
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "power_limit_w": None}
    assert (line["num_envs"], line["engine"], line["seed"]) == (128, "ring",
                                                               0)


def test_no_card_is_an_error_without_a_value(tiny, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, line = run_main(capsys, [])
    assert rc != 0
    assert "error" in line and "value" not in line
    assert line["metric"] == "train_obs_per_sec_dense16_128envs"


def test_a_tampered_plain_comparison_fails_the_line(tiny, capsys,
                                                    monkeypatch):
    plain = bench.full_tick_ring_plain

    def tampered(*args, **kwargs):
        tstate, rewards, dones, actions, ring = plain(*args, **kwargs)
        return tstate, rewards + 1.0, dones, actions, ring

    monkeypatch.setattr(bench, "full_tick_ring_plain", tampered)
    rc, line = run_main(capsys, ["--device", "cpu", "--nets", "dense16",
                                 "--in_kernel_td", "off", "--no_trace"])
    assert rc == 1 and line["correct"] is False
    problems = line["checks"][line["metric"]]["plain"]["problems"]
    assert problems and all("rewards differ" in p for p in problems)
    assert line["per_layer"] == {line["metric"]: None}


def test_settings_equal_the_jax_bench(monkeypatch):
    import bench as jax_bench

    assert bench.NETS == jax_bench.NETS
    for name in ("TIMED_STEPS", "CALLS_PER_REPEAT", "REPEATS",
                 "REPEATS_BIG", "WARMUP_CALLS"):
        assert getattr(bench, name) == getattr(jax_bench, name), name
    assert bench.Settings.from_environ({}) == bench.Settings()
    assert bench.NUM_ENVS == jax_bench.NUM_ENVS
    for envs in (128, 65536, 262144):
        monkeypatch.setattr(jax_bench, "NUM_ENVS", envs)
        for net in bench.NETS:
            _, make_carry, _ = jax_bench.build(net)
            ring = jax.eval_shape(make_carry)[1][1]
            assert ring.shape == (294, bench.capacity(envs)), (net, envs)
            assert str(ring.dtype) == "bfloat16"
    for net in bench.NETS:  # the port's own carry at 128 envs
        ring = bench.build(net, 128, device="cpu").make_carry()[1][1]
        assert tuple(ring.shape) == (294, bench.capacity(128))
        assert ring.dtype == torch.bfloat16
    assert bench.capacity(65536) == 131072


def test_tick_phases_and_host_split(monkeypatch):
    phases = {engine: set(profiling.tick_phases(engine))
              for engine in ("ring", "full", "fused")}
    common = {"learner", "schedules", "rng_split"}
    assert phases == {
        "ring": {"kernel", "gather", "scalar_writes"} | common,
        "full": {"kernel", "sample"} | common,   # B3 pushes itself
        "fused": {"kernel", "push", "sample", "actor", "opponents",
                  "reset"} | common}
    monkeypatch.setattr(bench, "MEMORY_SIZE", 256)
    prog = bench.build("dense16", 128, device="cpu", steps=2)
    carry = prog.make_carry()
    before = {name: getattr(owner, attr)
              for name, (owner, attr) in profiling.tick_phases("ring").items()}
    carry, host_ms, tick_ms = profiling.host_split(
        prog.tick, carry, 3, profiling.tick_phases("ring"),
        torch.device("cpu"))
    assert carry[-1] == 3
    assert set(host_ms) == phases["ring"] | {"other"}
    assert sum(host_ms.values()) == pytest.approx(tick_ms)
    after = {name: getattr(owner, attr)
             for name, (owner, attr) in profiling.tick_phases("ring").items()}
    assert before == after  # every wrapper taken off again
    carry, prof = profiling.profiled_ticks(
        prog.tick, carry, 2, torch.device("cpu"),
        profiling.tick_phases("ring"))
    assert carry[-1] == 5
    assert profiling.device_kernels(prof, 2) == []
    assert set(profiling.phase_device_ms(prof, 2)) >= {"kernel", "gather"}


def load_script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ring_and_config5_scripts_write_rows(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "MEMORY_SIZE", 256)
    tiny = ["--steps", "2", "--repeats", "2", "--calls", "1", "--device",
            "cpu"]
    out = tmp_path / "ring.json"
    rows = load_script("torch_ring_bench").main(
        ["--envs", "128", "--out", str(out)] + tiny)
    assert json.loads(out.read_text()) == rows and len(rows) == 1
    row = rows[0]
    assert {"num_envs", "network_type", "conv_matmul", "grid_size",
            "n_drones", "window_radius", "collect_drones", "obs_per_sec",
            "us_per_step", "median_s", "q1_s", "q3_s", "warmup_s",
            "repeat_s", "device", "capacity"} <= set(row)
    assert row["capacity"] == 256 and row["device"]["platform"] == "cpu"
    assert row["obs_per_sec"] == 128 * 2 / statistics.median(row["repeat_s"])

    out = tmp_path / "config5.json"
    rows = load_script("torch_config5_bench").main(
        ["--envs", "128", "--collect", "2", "9", "--out", str(out)] + tiny)
    assert json.loads(out.read_text()) == rows
    ran, refused = rows
    assert (ran["grid_size"], ran["n_drones"], ran["collect_drones"]) == (
        16, 8, 2)
    assert ran["ring_rows"] == 2 * 294 and ran["ring_columns"] == 256
    assert ran["obs_per_sec"] == 2 * ran["env_steps_per_sec"]
    assert refused["refused"] == [
        "collect=9 outside [1, n_drones=8]",
        "--batch_size 8 not divisible by --collect_drones 9"]


def test_scaling_script_two_gloo_ranks(tmp_path):
    out = tmp_path / "scaling.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_scaling_bench.py"),
         "--device", "cpu", "--world_sizes", "1", "2", "--envs_per_device",
         "8", "--steps", "3", "--repeats", "2", "--out", str(out)],
        capture_output=True, text=True, timeout=400, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = json.loads(out.read_text())
    assert [r["world_size"] for r in rows] == [1, 2]
    for row in rows:
        assert row["engine"] == row["local_engine"] == "jnp"
        assert row["obs_per_sec"] > 0
        assert "meaningless" in row["note"]
        assert len(row["ranks"]) == row["world_size"]
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    assert json.loads(proc.stdout.strip().splitlines()[-1])["scaling"][1][
        "world_size"] == 2


def test_replaced_carries_the_launch_counter():
    # A kernel wrapper counts through the name it is called by, so a
    # wrapper put in its place must hand the count back.
    module = type(sys)("counted")
    exec("def kernel():\n    kernel.launches += 1\nkernel.launches = 0",
         module.__dict__)
    original = module.kernel
    with profiling.replaced(module, "kernel", lambda: original()):
        module.kernel()
        module.kernel()
    assert module.kernel is original and original.launches == 2
    totals = {}
    with profiling.phase_timers(totals, {"kernel": (module, "kernel")}):
        module.kernel()
    assert original.launches == 3 and set(totals) == {"kernel"}
