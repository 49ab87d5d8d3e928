"""Ring-engine throughput of the PyTorch/CUDA port at any configuration
(counterpart of ``scripts/ring_bench.py``).

The protocol of ``python -m dronerl_tpu_torch.bench`` (``bench.warm_up``
and ``bench.timed_median``: warm-up excluded, every repeat ending in a
synchronise and a readback, the median of repeats), over the network
type, board, drones collected and env count: the env-count sweep of the
bench net, and BASELINE configs[2]'s conv datapoint (a conv Q-net on the
window observation through its im2col chain in the tick kernel). Appends
one row per env count, with the card's name and power limit, to
``scripts/torch_ring_bench_results.json`` (``--out``).

Run on a machine with a CUDA card, from the repository root:

    python scripts/torch_ring_bench.py --envs 4096 16384 65536 262144
    python scripts/torch_ring_bench.py --network_type conv --conv_matmul \\
        --envs 1024 65536
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dronerl_tpu_torch import bench, resolve_device  # noqa: E402
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig  # noqa: E402
from dronerl_tpu_torch.env.types import EnvParams  # noqa: E402
from dronerl_tpu_torch.ops import fused_tick  # noqa: E402

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_ring_bench_results.json")


def measure(args, num_envs: int, device: torch.device) -> dict:
    env_params = EnvParams(grid_size=args.grid_size, n_drones=args.n_drones,
                           window_radius=args.window_radius)
    config = DQNConfig(
        network_type=args.network_type,
        hidden_layers=tuple(args.hidden_layers),
        conv_dense_layers=tuple(args.conv_dense_layers),
        conv_matmul=args.conv_matmul,
        epsilon_decay_every=5, target_update_interval=10, gamma=0.9)
    agent = DQN(config, env_params, device=device)
    prog = bench.ring_program(agent, env_params, num_envs,
                              batch_size=args.batch_size,
                              collect_drones=args.collect_drones,
                              steps=args.steps)
    carry = prog.make_carry()
    if device.type == "cuda":
        fused_tick.prepare_kernel(
            env_params, fused_tick.flatten_net_params(carry[3].params,
                                                      agent.net_spec),
            collect=args.collect_drones)
    carry, warm_s = bench.warm_up(prog.run, carry)
    timing = bench.timed_median(prog.run, carry, args.repeats, args.calls)
    q1, q3 = bench.quartiles(timing.repeat_s)
    ticks = args.steps * args.calls
    return {
        "num_envs": num_envs,
        "network_type": args.network_type,
        "conv_matmul": args.conv_matmul,
        "hidden_layers": args.hidden_layers,
        "conv_dense_layers": args.conv_dense_layers,
        "grid_size": args.grid_size, "n_drones": args.n_drones,
        "window_radius": args.window_radius,
        "collect_drones": args.collect_drones,
        "batch_size": args.batch_size,
        "capacity": prog.capacity,
        "obs_per_sec": (num_envs * ticks * args.collect_drones
                        / timing.median_s),
        "us_per_step": 1e6 * timing.median_s / ticks,
        "median_s": timing.median_s, "q1_s": q1, "q3_s": q3,
        "warmup_s": warm_s,
        "repeat_s": timing.repeat_s,
        "steps": args.steps, "calls": args.calls,
        "device": bench.device_info(device),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--envs", type=int, nargs="+", default=[65536])
    p.add_argument("--network_type", choices=["dense", "conv"],
                   default="dense")
    p.add_argument("--conv_matmul", action="store_true")
    p.add_argument("--hidden_layers", type=int, nargs="+", default=[16, 16])
    p.add_argument("--conv_dense_layers", type=int, nargs="+", default=[])
    p.add_argument("--grid_size", type=int, default=9)
    p.add_argument("--n_drones", type=int, default=4)
    p.add_argument("--window_radius", type=int, default=3)
    p.add_argument("--collect_drones", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--repeats", type=int, default=6)
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=RESULTS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for envs in args.envs:
        row = measure(args, envs, device)
        print(json.dumps(row), flush=True)
        bench.append_row(args.out, row)
        rows.append(row)
    print(f"wrote {args.out}", flush=True)
    return rows


if __name__ == "__main__":
    main()
