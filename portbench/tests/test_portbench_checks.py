"""The guards around a run: the engine the CLI picks, the modules that
may not be loaded, the refusal without a card, and the result line."""

import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.conftest import tiny_cell


def test_engine_mismatch_fails():
    cell = tiny_cell("dense16.ring.e65536")
    cell.traffic["engine"] = "full"
    with pytest.raises(run.EngineMismatch):
        run.run_cell(cell.name, 5, 0.1, False, "cpu", cell)


def test_stream_traffic_on_a_small_replay_fails():
    # The stream mix's replay cut to the ring engine's size: the CLI then
    # picks the ring engine, and the run must not measure it.
    cell = tiny_cell("dense16.stream.e65536")
    cell.flags["memory_size"] = 256
    with pytest.raises(run.EngineMismatch):
        run.build(cell, 5, "cpu")


@pytest.mark.parametrize("modules, found", [
    (["dronerl_tpu_torch", "dronerl_tpu_torch.train", "torch"], []),
    (["dronerl_tpu"], ["dronerl_tpu"]),
    (["dronerl_tpu.train", "dronerl_tpu_torch"], ["dronerl_tpu.train"]),
    (["jax", "jax.numpy", "jaxlib", "flax.linen", "jaxtyping"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib"]),
])
def test_forbidden_modules_by_whole_top_level_name(modules, found):
    assert run.forbidden_modules(modules) == found


def _python(code):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_harness_and_reference_load_no_jax_and_no_program():
    out = _python(
        "import sys, portbench.run, portbench.check, portbench.calibrate\n"
        "import portbench.reference.engines.ring, "
        "portbench.reference.engines.full\n"
        "import portbench.reference.nets.dense, "
        "portbench.reference.nets.conv, portbench.roofline\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'dronerl_tpu', "
        "'dronerl_tpu_torch'}))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "dense16.ring.e65536", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=run.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""


def test_run_of_a_cut_cell_loads_no_jax():
    out = _python(
        "from portbench import run\n"
        "from portbench.tests.conftest import tiny_cell\n"
        "cell = tiny_cell('dense16.stream.e65536')\n"
        "out = run.run_cell(cell.name, 3, 0.1, False, 'cpu', cell)\n"
        "print(out['correct'], run.forbidden_modules())")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "True []"
