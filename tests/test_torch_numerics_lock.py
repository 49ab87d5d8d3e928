"""The port's numerics lock (``scripts/torch_numerics_lock.py``): the
ring engine's plain path on the CPU reproduces the Tier A digests of the
JAX package's TPU record (``scripts/tpu_numerics_lock.json``) bitwise,
and the card's own record (``scripts/torch_numerics_lock.json``) is
well formed, comes from the card and agrees with the TPU record's Tier
A. No JAX here: the records are JSON files."""

import importlib.util
import json
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_numerics_lock.py")


def load_script():
    spec = importlib.util.spec_from_file_location("torch_numerics_lock",
                                                  SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read(path):
    with open(path) as f:
        return json.load(f)


def test_plain_path_reproduces_the_tpu_record_tier_a():
    lock = load_script()
    now = lock.run_scenario(torch.device("cpu"))
    rec = read(lock.TPU_RECORD)
    assert set(rec["int_digests"]) == {
        "ground", "air_x", "air_y", "carrying", "charge", "rewards_trace"}
    assert now["int_digests"] == rec["int_digests"]
    assert now["env_floats"]["ring_sum"] == rec["env_floats"]["ring_sum"]
    assert now["env_floats"]["ring_nonzero"] == (
        rec["env_floats"]["ring_nonzero"])
    assert lock.compare(lock.tier_a(rec), now) == []


def test_card_record_schema():
    lock = load_script()
    rec = read(lock.RECORD)
    for section in ("int_digests", "env_floats", "learner", "meta"):
        assert section in rec
    for name, digest in rec["int_digests"].items():
        assert isinstance(digest, str) and len(digest) == 64, name
    ef = rec["env_floats"]
    assert ef["ring_nonzero"] > 0 and len(ef["ring_sample"]) > 0
    lr = rec["learner"]
    assert len(lr["param_abs_sums"]) == 6  # (16,16): 3 layers, W and b
    assert len(lr["q_probe"]) == 32 * 5
    assert np.isfinite(lr["q_probe"]).all()
    assert np.isfinite(lr["loss_tail_mean"])
    meta = rec["meta"]
    assert meta["platform"] != "cpu", "the record must come from the card"
    assert meta["platform"] == "gpu"
    assert meta["num_envs"] == lock.NUM_ENVS and meta["steps"] == lock.STEPS
    for key in ("device_kind", "nvidia_smi", "torch_version",
                "cuda_version", "recorded_wall_s"):
        assert meta[key], key


def test_card_record_tier_a_equals_the_tpu_record():
    lock = load_script()
    card, tpu = read(lock.RECORD), read(lock.TPU_RECORD)
    assert lock.tier_a(card) == lock.tier_a(tpu)
