"""Numerics lock of the PyTorch port: the ring engine's scenario of
``scripts/tpu_numerics_lock.py``, on the card through the tick kernel.

The scenario: 256 envs, 64 ticks, a ring of 1,024 columns of bf16
observations, batch 8, an env reset every 100 ticks, a dense (16,16)
net, ε pinned at 1.0 (every action is a threefry draw, so no Q-value
can steer the trajectory) and the key ``PRNGKey(1234)`` as its two
uint32 words. It runs through ``train.build_train_step_ring`` and
``init_ring_carry`` with the default learner (autograd and Adam after
the tick): on the card the tick kernel B1 runs the env side, on the CPU
its plain version.

Two tiers, as in the JAX script:

Tier A: SHA-256 digests of the env state's fields (``ground``,
  ``air_x``, ``air_y``, ``carrying``, ``charge``, in the JAX record's
  feature-major layout and dtypes) and of the (64, 256) reward trace,
  and a summary of the bf16 ring (sum, non-zero count, a strided
  sample). It depends on the program alone: the port must equal the
  JAX package's TPU record (``scripts/tpu_numerics_lock.json``),
  digests bitwise.
Tier B: the trained net's per-leaf absolute sums, the greedy Q-values
  of the first 32 ring columns and the mean of the last 16 losses. They
  depend on float rounding, so they are held to a record of the card's
  own (``scripts/torch_numerics_lock.json``, written with ``--record``)
  within ``compare``'s bands.

Usage:
    python scripts/torch_numerics_lock.py --record   # write the card's record
    python scripts/torch_numerics_lock.py            # check both records
    python scripts/torch_numerics_lock.py --device cpu  # the plain path
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dronerl_tpu_torch import resolve_device  # noqa: E402
from dronerl_tpu_torch import rng as rng_mod  # noqa: E402
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig  # noqa: E402
from dronerl_tpu_torch.env.types import EnvParams  # noqa: E402
from dronerl_tpu_torch.ops import fused_tick  # noqa: E402
from dronerl_tpu_torch.train import (  # noqa: E402
    build_train_step_ring, init_ring_carry)

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
TPU_RECORD = os.path.join(SCRIPTS, "tpu_numerics_lock.json")
RECORD = os.path.join(SCRIPTS, "torch_numerics_lock.json")

NUM_ENVS = 256
STEPS = 64
CAPACITY = 4 * NUM_ENVS


def run_scenario(device: torch.device) -> dict:
    """The scenario's observables: ``int_digests`` and ``env_floats``
    (Tier A), ``learner`` (Tier B)."""
    env_params = EnvParams(grid_size=9, n_drones=4, window_radius=3)
    config = DQNConfig(
        network_type="dense", hidden_layers=(16, 16),
        epsilon_start=1.0, epsilon_end=1.0, epsilon_decay=1.0,
        epsilon_decay_every=5, target_update_interval=10, gamma=0.9)
    agent = DQN(config, env_params, device=device)
    rng = rng_mod.PRNGKey(1234)
    tick = build_train_step_ring(agent, env_params, NUM_ENVS, CAPACITY,
                                 batch_size=8, reset_env_every=100)
    carry = init_ring_carry(agent, env_params, NUM_ENVS, CAPACITY, rng,
                            obs_dtype=torch.bfloat16, batch_size=8)
    rewards, losses = [], []
    for _ in range(STEPS):
        carry, (reward, _eps, loss) = tick(carry)
        rewards.append(reward)
        losses.append(loss)
    _rng, (tstate, ring), _scalars, ag_state, _aux, _step = carry
    rewards = torch.stack(rewards).float().cpu().numpy()
    losses = torch.stack(losses).float().cpu().numpy()
    ring_f = ring.float()
    with torch.no_grad():
        q_probe = agent.q_values(ag_state.params, ring_f[:, :32].t())

    out = {"int_digests": {}, "env_floats": {}, "learner": {}}
    for name, field in zip(tstate._fields, tstate):
        a = field.cpu().numpy()
        if a.dtype.kind not in "iub":
            a = a.astype(np.float32)
        out["int_digests"][name] = hashlib.sha256(
            np.ascontiguousarray(a).tobytes()).hexdigest()
    out["int_digests"]["rewards_trace"] = hashlib.sha256(
        np.ascontiguousarray(rewards).tobytes()).hexdigest()
    ring_np = ring_f.cpu().numpy()
    out["env_floats"] = {
        "ring_sum": float(ring_np.sum()),
        "ring_nonzero": int((ring_np != 0).sum()),
        "ring_sample": ring_np.reshape(-1)[::4099][:64].tolist(),
    }
    # flax's leaf order: Dense_0 bias, Dense_0 kernel, Dense_1 bias, ...
    leaves = []
    for w, b in zip(ag_state.params.kernels, ag_state.params.biases):
        leaves += [b, w]
    out["learner"] = {
        "param_abs_sums": [float(leaf.detach().abs().sum().cpu())
                           for leaf in leaves],
        "q_probe": q_probe.float().cpu().reshape(-1).tolist(),
        "loss_tail_mean": float(losses[-16:].mean()),
    }
    return out


def compare(rec: dict, now: dict) -> list:
    """The mismatches of ``now`` against the record ``rec``: Tier A's
    digests bitwise, the ring's non-zero count exactly, its sum within
    rtol 1e-3 / atol 1, its sample within bf16 granularity (atol 1e-2);
    Tier B's abs-sums within rtol 5e-2, the Q probe within rtol 5e-2 /
    atol 5e-3 (``scripts/tpu_numerics_lock.py``'s bands). A record
    without a learner section (Tier A alone) checks Tier A alone."""
    errs = []
    for name, digest in rec["int_digests"].items():
        if now["int_digests"].get(name) != digest:
            errs.append(f"Tier A bit mismatch: {name}")
    ef_rec, ef_now = rec["env_floats"], now["env_floats"]
    if ef_rec["ring_nonzero"] != ef_now["ring_nonzero"]:
        errs.append("Tier A: ring nonzero-count changed "
                    f"{ef_rec['ring_nonzero']} -> {ef_now['ring_nonzero']}")
    if not np.isclose(ef_rec["ring_sum"], ef_now["ring_sum"],
                      rtol=1e-3, atol=1.0):
        errs.append(f"Tier A: ring sum {ef_rec['ring_sum']} -> "
                    f"{ef_now['ring_sum']}")
    if not np.allclose(ef_rec["ring_sample"], ef_now["ring_sample"],
                       atol=1e-2):
        errs.append("Tier A: ring sample drifted past bf16 granularity")
    lr_rec, lr_now = rec.get("learner"), now["learner"]
    if lr_rec is None:
        return errs
    if not np.allclose(lr_rec["param_abs_sums"], lr_now["param_abs_sums"],
                       rtol=5e-2):
        errs.append("Tier B: trained-param abs-sums outside 5% band")
    if not np.allclose(lr_rec["q_probe"], lr_now["q_probe"],
                       rtol=5e-2, atol=5e-3):
        errs.append("Tier B: greedy Q probe outside band")
    return errs


def tier_a(rec: dict) -> dict:
    """A record's Tier A: its digests and ring summary."""
    return {"int_digests": rec["int_digests"],
            "env_floats": rec["env_floats"]}


def tier_b_max_diff(a: dict, b: dict) -> float:
    """The largest absolute difference between two runs' Tier B
    numbers."""
    diffs = [np.max(np.abs(np.subtract(a["learner"][k], b["learner"][k])))
             for k in ("param_abs_sums", "q_probe", "loss_tail_mean")]
    return float(max(diffs))


def card_meta(device: torch.device) -> dict:
    """The platform, the card's name and power limit (nvidia-smi), and
    the torch and CUDA versions."""
    meta = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda}
    if device.type == "cuda":
        meta["device_kind"] = torch.cuda.get_device_name(device)
        meta["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return meta


def check(now: dict, card: bool = True) -> list:
    """``now`` against the TPU record's Tier A and, with ``card``, the
    card's record."""
    with open(TPU_RECORD) as f:
        errs = [f"vs the TPU record: {e}"
                for e in compare(tier_a(json.load(f)), now)]
    if card:
        with open(RECORD) as f:
            errs += [f"vs the card's record: {e}"
                     for e in compare(json.load(f), now)]
    return errs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--record", action="store_true",
                   help="write the card's record (after checking Tier A "
                        "against the TPU record)")
    p.add_argument("--device", default="cuda",
                   help="default: the card; cpu runs the plain path and "
                        "checks Tier A alone")
    p.add_argument("--out", default=RECORD, help="the record to write")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    before = fused_tick.full_tick_fused_ring.launches
    t0 = time.perf_counter()
    now = run_scenario(device)
    wall = time.perf_counter() - t0
    launches = fused_tick.full_tick_fused_ring.launches - before
    where = (f"{wall:.1f}s on {card_meta(device).get('nvidia_smi', 'cpu')}"
             f", {launches} tick-kernel launches")

    on_card = device.type == "cuda"
    if args.record:
        if not on_card:
            sys.exit("the record is the card's: run --record on the card")
        errs = check(now, card=False)
        if errs:
            sys.exit("Tier A differs:\n - " + "\n - ".join(errs))
        now["meta"] = {**card_meta(device), "num_envs": NUM_ENVS,
                       "steps": STEPS, "recorded_wall_s": round(wall, 1)}
        with open(args.out, "w") as f:
            json.dump(now, f, indent=1)
        print(f"recorded -> {args.out} ({where})")
        return
    errs = check(now, card=on_card)
    if errs:
        print("numerics lock FAILED:")
        for e in errs:
            print(" -", e)
        sys.exit(1)
    print(f"numerics lock OK ({where}; Tier A equals the TPU record"
          + ("; Tier B inside the card's record)" if on_card
             else "; Tier B not checked on the CPU)"))


if __name__ == "__main__":
    main()
