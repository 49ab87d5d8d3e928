"""Ring-engine throughput of the PyTorch/CUDA port at BASELINE config 5's
board (counterpart of ``scripts/config5_bench.py``).

BASELINE.json configs[4], the multi-host workload, trains 32k envs on a
16 x 16 grid with 8 drones. This measures the ring engine at 32,768 envs
on one card, with ``collect_drones`` 1 and 8 (at 8 the ring holds 8 ·
294 = 2,352 rows of 131,072 bf16 columns, 617 MB), by the protocol of
``python -m dronerl_tpu_torch.bench``. obs/s counts one observation per
env-step per collected drone. A configuration that the tick kernel or the
ring engine refuses (``fused_tick.kernel_problems`` / ``tick_problems``,
``train.ring_skip_reasons``) is a row with the refusal's own words.
Appends rows to ``scripts/torch_config5_results.json`` (``--out``).

Run on a machine with a CUDA card, from the repository root:

    python scripts/torch_config5_bench.py
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dronerl_tpu_torch import bench, resolve_device, train  # noqa: E402
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig  # noqa: E402
from dronerl_tpu_torch.constants import NUM_ACTIONS  # noqa: E402
from dronerl_tpu_torch.env.types import EnvParams  # noqa: E402
from dronerl_tpu_torch.ops import fused_tick  # noqa: E402

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_config5_results.json")
GRID, DRONES = 16, 8
HIDDEN = (16, 16)
BATCH = 8


def refusals(params: EnvParams, num_envs: int, collect: int) -> list:
    """Why the ring engine's kernel does not run this case (empty: it
    does)."""
    widths = (fused_tick.obs_rows(params), *HIDDEN, NUM_ACTIONS)
    cap = bench.capacity(num_envs)
    return (fused_tick.kernel_problems(params, num_envs, widths)
            + fused_tick.tick_problems(params, collect, 20)
            + train.ring_skip_reasons(True, cap * collect, num_envs * collect,
                                      BATCH, collect))


def measure(num_envs: int, collect: int, steps: int, repeats: int,
            calls: int, device: torch.device) -> dict:
    params = EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=3)
    row = {"num_envs": num_envs, "grid_size": GRID,
           "n_drones": DRONES, "collect_drones": collect,
           "device": bench.device_info(device)}
    refused = refusals(params, num_envs, collect)
    if refused:
        return {**row, "refused": refused}
    config = DQNConfig(
        network_type="dense", hidden_layers=HIDDEN,
        epsilon_decay_every=5, target_update_interval=10, gamma=0.9)
    agent = DQN(config, params, device=device)
    prog = bench.ring_program(agent, params, num_envs, batch_size=BATCH,
                              collect_drones=collect, steps=steps)
    carry = prog.make_carry()
    if device.type == "cuda":
        fused_tick.prepare_kernel(params, carry[3].params.flat(),
                                  collect=collect)
    carry, warm_s = bench.warm_up(prog.run, carry)
    timing = bench.timed_median(prog.run, carry, repeats, calls)
    q1, q3 = bench.quartiles(timing.repeat_s)
    ticks = steps * calls
    return {
        **row,
        "ring_rows": int(carry[1][1].shape[0]),
        "ring_columns": prog.capacity,
        "obs_per_sec": num_envs * ticks * collect / timing.median_s,
        "env_steps_per_sec": num_envs * ticks / timing.median_s,
        "us_per_step": 1e6 * timing.median_s / ticks,
        "median_s": timing.median_s, "q1_s": q1, "q3_s": q3,
        "warmup_s": warm_s,
        "repeat_s": timing.repeat_s,
        "steps": steps, "calls": calls,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--repeats", type=int, default=6)
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--envs", type=int, default=32768)
    p.add_argument("--collect", type=int, nargs="+", default=[1, 8],
                   help="collect_drones values to measure")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=RESULTS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for collect in args.collect:
        row = measure(args.envs, collect, args.steps, args.repeats,
                      args.calls, device)
        print(json.dumps(row), flush=True)
        bench.append_row(args.out, row)
        rows.append(row)
    print(f"wrote {args.out}", flush=True)
    return rows


if __name__ == "__main__":
    main()
