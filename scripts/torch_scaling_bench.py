"""Weak scaling of the PyTorch/CUDA port's sharded trainer: obs/s against
the number of ranks (counterpart of ``scripts/scaling_bench.py``).

Each world size runs ``parallel.DistributedTrainer`` in that many ranks
(``parallel.launch.spawn``: one process a rank, NCCL on the card, gloo on
the CPU) with a fixed number of envs a rank; efficiency(N) = obs/s(N) /
(N · obs/s(1)), against the first world measured. Each rank times chunks
of ``--steps`` ticks by the bench's protocol (``bench.warm_up``, then
``bench.timed_median``: the median of ``--repeats`` chunks, each ending
in a synchronise and a readback); a world's obs/s takes its slowest
rank's median. ``--engine auto`` picks the fused engine on the card at
128 or more envs a rank and the jnp engine otherwise, as the JAX script
picks it (``:54-58``); with the dense net the fused engine runs the full
tick kernel (B3) in each rank.

On the card a rank drives a card of its own: a world larger than the
card count is a row that says so, not a run (ranks sharing a card would
measure contention, not scaling). With ``--device cpu`` the ranks are
gloo processes on one host and share its cores: the efficiency there is
meaningless (it tends to 1/N by construction), as the JAX script says of
``--force_cpu``. Appends rows to ``scripts/torch_scaling_results.json``
(``--out``).

Run from the repository root:

    python scripts/torch_scaling_bench.py                  # every card
    python scripts/torch_scaling_bench.py --device cpu --world_sizes 1 2
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dronerl_tpu_torch import bench, resolve_device, rng  # noqa: E402
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig  # noqa: E402
from dronerl_tpu_torch.env.types import EnvParams  # noqa: E402
from dronerl_tpu_torch.ops import fused_tick  # noqa: E402
from dronerl_tpu_torch.parallel import (  # noqa: E402
    DistributedTrainer, launch, make_env_mesh)

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_scaling_results.json")
CPU_NOTE = ("gloo ranks sharing one host's CPU cores: the efficiency is "
            "meaningless here (it tends to 1/N by construction)")
KERNELS = {"ring": fused_tick.full_tick_fused_ring,
           "full": fused_tick.full_tick_fused,
           "fused": fused_tick.tick_fused}


def rank_measure(device: str, engine: str, envs_per_device: int, steps: int,
                 repeats: int) -> dict:
    """One rank of a world: its trainer's warm-up and timed chunks."""
    mesh = make_env_mesh(device=device)
    env_params = EnvParams(grid_size=9, n_drones=4)
    config = DQNConfig(hidden_layers=(16, 16), epsilon_decay_every=5,
                       target_update_interval=10)
    agent = DQN(config, env_params, device=mesh.device)
    trainer = DistributedTrainer(
        agent, env_params, mesh, num_envs=envs_per_device * mesh.world_size,
        buffer_capacity_per_shard=envs_per_device * 40,
        batch_size_per_shard=8, engine=engine)
    carry = trainer.init_carry(rng.PRNGKey(0))
    local = trainer.local_engine
    if mesh.device.type == "cuda" and local != "jnp":
        fused_tick.prepare_kernel(
            env_params, None if local == "fused" else carry[3].params.flat(),
            env_tick=local == "fused")
    chunk = trainer.build_chunk(steps)
    carry, warmup_s = bench.warm_up(chunk, carry, calls=1)
    for fn in KERNELS.values():
        fn.launches = 0
    timing = bench.timed_median(chunk, carry, repeats, 1)
    return {"rank": mesh.rank, "local_engine": local,
            "median_s": timing.median_s, "repeat_s": timing.repeat_s,
            "warmup_s": warmup_s,
            "launches": {k: fn.launches for k, fn in KERNELS.items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world_sizes", type=int, nargs="+", default=None,
                   help="default: 1, 2, 4, ... up to the card count (the "
                   "CPU: 1)")
    p.add_argument("--envs_per_device", type=int, default=256)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--engine", choices=["auto", "fused", "jnp", "ring"],
                   default="auto")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=RESULTS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    worlds = args.world_sizes or (
        [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= cards] if on_card
        else [1])
    engine = args.engine
    if engine == "auto":
        engine = "fused" if on_card and args.envs_per_device >= 128 else "jnp"
    info = bench.device_info(device)
    rows, base = [], None
    for world in worlds:
        row = {"world_size": world, "engine": engine,
               "envs_per_device": args.envs_per_device,
               "steps": args.steps, "repeats": args.repeats, "device": info}
        if on_card and world > cards:
            row["refused"] = (f"world size {world} > {cards} card(s): one "
                              "rank drives one card")
        else:
            ranks = launch.spawn(
                rank_measure, world, (device.type, engine,
                                      args.envs_per_device, args.steps,
                                      args.repeats),
                device=device.type, num_threads=None if on_card else 1)
            slowest = max(r["median_s"] for r in ranks)
            obs = args.envs_per_device * world * args.steps / slowest
            base = base or obs / world  # a rank's obs/s in the first world
            row.update({
                "local_engine": ranks[0]["local_engine"],
                "obs_per_sec": obs,
                "weak_scaling_efficiency": obs / (base * world),
                "ranks": ranks,
            })
            if not on_card:
                row["note"] = CPU_NOTE
        print(json.dumps(row), flush=True)
        bench.append_row(args.out, row)
        rows.append(row)
    print(json.dumps({"scaling": [
        {k: r.get(k) for k in ("world_size", "obs_per_sec",
                               "weak_scaling_efficiency", "refused")}
        for r in rows]}), flush=True)
    return rows


if __name__ == "__main__":
    main()
