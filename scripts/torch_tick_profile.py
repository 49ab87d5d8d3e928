"""Where one tick of the PyTorch port's trainer spends its time, on a card.

Runs one of the trainer's engines (``dronerl_tpu_torch.train``) at the
bench configuration (grid 9, 4 drones, radius 3, 65,536 envs, batch 8,
reset every 100): ``--engine ring`` (the default) with a ring of 131,072
bf16 columns; ``--engine full`` (kernel B3) or ``--engine fused`` (kernel
B4, the actions and the reset outside the kernel) over a StreamReplay of
1,048,576 f32 slots (``--memory_size 1000000`` rounded up to 16
env-batches). It reports:

* wall time per tick (host clock around ticks ending in a synchronise);
* host wall time per phase of the tick (the kernel's wrapper, the replay
  gather with its randint or the StreamReplay sample, the fused
  engine's StreamReplay push (the full engine's is B3's own), actor and
  random opponents and its reset, the learner step, the schedules, the
  host rng split), timed by wrapping each phase's function;
* under ``torch.profiler``: device time per kernel and per phase (each
  phase an annotated range), launches per tick, and the device's busy
  share of the unprofiled tick.

This is the eager tick, the ring chunk's reference; the ring chunk that
the CLI and the bench run on a card (``train.build_chunk_ring``, one CUDA
graph replay a tick) is traced by the bench's ``per_layer``.

With ``--in_kernel_td`` the trainer runs its in-kernel TD path: the
learner is one launch of the learner kernel, whose wrapper's host time
counts to the "kernel" phase (it is called from inside the tick's
wrapper), and the "learner" phase is empty.

Run on a machine with a CUDA card, from the repository root:

    python scripts/torch_tick_profile.py --hidden 16 16
    python scripts/torch_tick_profile.py --hidden 128 64 --trace out.json
    python scripts/torch_tick_profile.py --hidden 16 16 --in_kernel_td
    python scripts/torch_tick_profile.py --hidden 16 16 --engine full
    python scripts/torch_tick_profile.py --hidden 16 16 --engine fused
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dronerl_tpu_torch import replay, rng, train  # noqa: E402
from dronerl_tpu_torch.agents import dqn  # noqa: E402
from dronerl_tpu_torch.env.types import EnvParams  # noqa: E402
from dronerl_tpu_torch.ops import fused_tick  # noqa: E402
from dronerl_tpu_torch.utils import profiling  # noqa: E402

STREAM_CAPACITY = 1048576  # ceil(1e6 / 65,536) env-batches


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hidden", nargs="+", type=int, default=[16, 16])
    p.add_argument("--num_envs", type=int, default=65536)
    p.add_argument("--ticks", type=int, default=50)
    p.add_argument("--profile_ticks", type=int, default=20)
    p.add_argument("--trace", default=None,
                   help="write the profiler's chrome trace here")
    p.add_argument("--in_kernel_td", action="store_true",
                   help="the learner kernel instead of the autograd learner "
                   "(ring engine)")
    p.add_argument("--engine", choices=["ring", "full", "fused"],
                   default="ring")
    args = p.parse_args(argv)
    if args.in_kernel_td and args.engine != "ring":
        sys.exit("torch_tick_profile: --in_kernel_td runs on the ring engine")
    if not torch.cuda.is_available():
        sys.exit("torch_tick_profile: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    params = EnvParams(grid_size=9, n_drones=4, window_radius=3)
    agent = dqn.DQN(dqn.DQNConfig(hidden_layers=tuple(args.hidden),
                                  epsilon_decay_every=5,
                                  target_update_interval=10, gamma=0.9),
                    params, device="cuda")
    num_envs = args.num_envs
    td = args.in_kernel_td
    if args.engine == "ring":
        capacity = max(-(-100_000 // num_envs) * num_envs, 2 * num_envs)
        tick = train.build_train_step_ring(agent, params, num_envs, capacity,
                                           8, 100, in_kernel_td=td)
        carry = train.init_ring_carry(agent, params, num_envs, capacity,
                                      rng.PRNGKey(0),
                                      obs_dtype=torch.bfloat16,
                                      batch_size=8, in_kernel_td=td)
    else:
        capacity = max(-(-STREAM_CAPACITY // num_envs) * num_envs,
                       2 * num_envs)
        buf = replay.StreamReplay(capacity, 8, stride=num_envs)
        build = {"full": train.build_train_step_full,
                 "fused": train.build_train_step_fused}[args.engine]
        tick = build(agent, buf, params, num_envs, 100)
        carry = train.init_stream_carry(agent, params, num_envs, buf,
                                        rng.PRNGKey(0))
    fused_tick.prepare_kernel(
        params, None if args.engine == "fused" else carry[3].params.flat(),
        in_kernel_td=td, env_tick=args.engine == "fused")
    for _ in range(10):
        carry, _ = tick(carry)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.ticks):
        carry, _ = tick(carry)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / args.ticks * 1e3

    n = args.ticks
    device = torch.device("cuda")
    carry, host_ms, timed_tick_ms = profiling.host_split(
        tick, carry, n, profiling.tick_phases(args.engine), device)

    phases = profiling.tick_phases(args.engine)
    carry, prof = profiling.profiled_ticks(tick, carry, args.profile_ticks,
                                           device, phases)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    # Device time: the kernels and copies on the card's timeline only.
    kernels = profiling.device_kernels(prof, args.profile_ticks)
    device_ms = sum(k[1] for k in kernels)
    result = {
        "card": card,
        "hidden": args.hidden,
        "engine": args.engine,
        "in_kernel_td": td,
        "capacity": capacity,
        "num_envs": num_envs,
        "tick_ms": tick_ms,
        "obs_per_sec": num_envs / tick_ms * 1e3,
        "device_ms_per_tick": device_ms,
        "device_busy_share": device_ms / tick_ms,
        "device_launches_per_tick": sum(k[2] for k in kernels),
        "host_ms_per_tick_by_phase": host_ms,
        "device_ms_per_tick_by_phase": profiling.phase_device_ms(
            prof, args.profile_ticks),
        "phase_timed_tick_ms": timed_tick_ms,
        "top_device_kernels_ms_per_tick": [
            {"name": k[0][:90], "ms": k[1], "calls": k[2]}
            for k in kernels[:10]],
    }
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
