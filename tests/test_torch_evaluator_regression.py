"""The frozen-baseline round-robin lock (``tests/test_evaluator_regression
.py``) held by the PyTorch port on the CPU: the five baselines, 10 fixed
seeds × 1,000 steps, the JAX package's recorded CPU scores within rtol
0.01. Like the JAX lock it is backend-specific (greedy argmax turns the
last bits of a Q-value into another action), so it runs on the CPU."""

import os

import numpy as np
import pytest

from dronerl_tpu_torch.evaluator.evaluator import (
    BASELINES, evaluate_checkpoints)
from tests.test_evaluator_regression import EXPECTED


@pytest.mark.slow
def test_baseline_round_robin_scores():
    paths = [os.path.join(BASELINES, f"{name}.safetensors")
             for name in EXPECTED]
    results = evaluate_checkpoints(paths, device="cpu")
    for i, (name, (mean, std)) in enumerate(EXPECTED.items()):
        np.testing.assert_allclose(results["mean"][i], mean, rtol=0.01,
                                   err_msg=f"{name} mean score drifted")
        np.testing.assert_allclose(results["std"][i], std, rtol=0.01,
                                   err_msg=f"{name} std drifted")
