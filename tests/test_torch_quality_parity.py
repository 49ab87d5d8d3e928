"""The port's learning-quality lock against the JAX package's frozen
quality record.

``scripts/torch_quality_parity.py`` trains the port at the frozen
configuration of ``scripts/quality_parity.py`` (grid 9, 4 drones,
``num_envs`` 1: the jnp engine, 50k steps, then 5 greedy episodes x 10k
steps) on the card and writes ``repo`` rows only to
``scripts/torch_quality_parity_results*.json``; each file names the JAX
file whose ``reference`` rows form its band, ``band(z=4)`` as
``tests/test_quality_parity.py``. Two locks:

* the recorded port mean lies inside that band and beats the port's own
  random agent by 0.1;
* a ``slow`` re-run of seed 0 on the CPU lands inside ``band(z=6)``.
"""

import json
import os
import statistics
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")

# configuration -> (the port's record, the least number of its seeds)
PORT_FILES = {
    "dense": ("torch_quality_parity_results.json", 5),
    "conv": ("torch_quality_parity_results_conv.json", 3),
    "dense128x64": ("torch_quality_parity_results_dense128x64.json", 3),
}


def read(name):
    with open(os.path.join(SCRIPTS, name)) as f:
        return json.load(f)


def band(rows, z=4.0):
    means = [r["eval_reward_mean"] for r in rows]
    mu = statistics.mean(means)
    sd = statistics.stdev(means) if len(means) > 1 else 0.01
    return mu - z * sd, mu + z * sd


def reference_rows(port):
    ref = port["config"]["reference"]
    assert ref.startswith("scripts/quality_parity_results")
    return read(os.path.basename(ref))["reference"]


@pytest.mark.parametrize("config", sorted(PORT_FILES))
def test_port_mean_inside_the_reference_band(config):
    name, least = PORT_FILES[config]
    port = read(name)
    assert port["reference"] == []  # the band is the JAX file's
    assert port["config"]["num_steps"] == 50_000
    assert port["config"]["device"] != "cpu", "rows come from the card"
    rows = port["repo"]
    assert len(rows) >= least
    ref = reference_rows(port)
    assert len(ref) >= 3
    lo, hi = band(ref)
    mean = statistics.mean(r["eval_reward_mean"] for r in rows)
    assert lo <= mean <= hi, (
        f"{config}: port mean {mean:.4f} outside the reference band "
        f"[{lo:.4f}, {hi:.4f}]")
    rand = statistics.mean(r["random_reward_mean"] for r in rows)
    assert mean > rand + 0.1


@pytest.mark.slow
def test_fresh_port_run_lands_in_reference_band(tmp_path):
    """Train the dense configuration 50k steps now, on the CPU, and hold
    its final eval to the frozen band at z = 6."""
    port = read(PORT_FILES["dense"][0])
    run_dir = str(tmp_path / "fresh")
    subprocess.run(
        [sys.executable, "-m", "dronerl_tpu_torch.train", "--device", "cpu",
         "--seed", "0", "--num_steps", str(port["config"]["num_steps"]),
         "--run_dir", run_dir],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), check=True,
        timeout=3600, capture_output=True)
    with open(os.path.join(run_dir, "metrics.json")) as f:
        metrics = json.load(f)
    lo, hi = band(reference_rows(port), z=6.0)
    assert lo <= metrics["eval_reward_mean"] <= hi
