"""Same-run comparison of two source trees' trainer ticks on one card.

For each tree, in turns (other, this, this, other, other, this, ... over
``--rounds`` pairs), in that tree's own checkout and processes:

* the ring bench, ``python -m dronerl_tpu_torch.bench`` (the graphed ring
  chunk at 65,536 envs, both nets, default and ``in_kernel_td``; its
  traced ``per_layer`` run gives the launches, device ms and busy share of
  a tick), at ``--repeats`` / ``--repeats_big`` repeats;
* the tree's ``chip_smoke.py`` phase 10 (``engine_chunks``: the jnp, full
  and fused engines' graphed chunks against their eager ticks) and phase
  6e (``sharded_chunks``: the sharded trainers' at world 1 over NCCL),
  each case's stats captured from its ``log_ways`` line.

Writes every run's rows to ``--out`` and prints one line a run. Compare
within one run of this script only: two runs may land on two cards.

Run on a machine with a CUDA card, from the repository root:

    mkdir -p .archive/parent && git archive HEAD~1 | tar -x -C .archive/parent
    python scripts/torch_tree_compare.py --other .archive/parent
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chunks_worker(out_path: str) -> None:
    """Phases 10 and 6e of the tree in the working directory, each case's
    stats (``log_ways``' arguments) written to ``out_path``."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from dronerl_tpu_torch import train
    from dronerl_tpu_torch.ops import fused_tick, learner_kernel, step_kernel
    from dronerl_tpu_torch.parallel import mesh as mesh_mod

    counters = {"full_tick_ring": fused_tick.full_tick_fused_ring,
                "td_adam": learner_kernel.td_adam,
                "full_tick": fused_tick.full_tick_fused,
                "tick": fused_tick.tick_fused,
                "step": step_kernel.step_batch_fused}
    try:  # a tree with the draw kernel counts its launches apart
        from dronerl_tpu_torch.ops import draws
        drawn = [getattr(draws, name) for name in (
            "draw", "ring_sample", "stream_sample", "buffer_sample")
            if hasattr(draws, name)]
    except ImportError:
        drawn = []

    def zero_counts():
        for fn in (*counters.values(), *drawn):
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    rows = []
    log_ways = chip_smoke.log_ways

    def capture(tag, stats, chunk, ticks, expect, numbers, card, beside=""):
        rows.append({"tag": tag, "graphs": chunk.graphs, "ticks": ticks,
                     "launches": expect, "stats": stats})
        log_ways(tag, stats, chunk, ticks, expect, numbers, card, beside)

    chip_smoke.log_ways = capture
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    runs = os.path.join(os.getcwd(), "output", "tree_compare")
    chip_smoke.engine_chunks(torch, train, zero_counts, counts, card, runs)
    mesh = mesh_mod.make_env_mesh(device="cuda")
    chip_smoke.sharded_chunks(torch, train, zero_counts, counts, card, runs,
                              mesh)
    torch.distributed.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"card": card, "rows": rows}, f)


def bench_summary(line: dict) -> dict:
    """obs/s and the traced tick of each of the bench's metrics."""
    out = {}
    for m in [line, *line.get("extra_metrics", [])]:
        layer = line["per_layer"].get(m["metric"]) or {}
        out[m["metric"]] = {
            "obs_per_s": m["value"],
            "launches_per_tick": layer.get("launches_per_tick"),
            "device_ms": layer.get("device_ms"),
            "busy": layer.get("device_busy_share"),
            "host_ms": layer.get("host_ms_per_tick"),
        }
    return out


def run_tree(tree: str, args, index: int) -> dict:
    env = {**os.environ, "DRONERL_BENCH_REPEATS": str(args.repeats),
           "DRONERL_BENCH_REPEATS_BIG": str(args.repeats_big)}
    t0 = time.perf_counter()
    bench = subprocess.run([sys.executable, "-m", "dronerl_tpu_torch.bench"],
                           cwd=tree, env=env, capture_output=True, text=True,
                           timeout=args.timeout)
    if bench.returncode != 0:
        raise RuntimeError(f"the bench in {tree} exited {bench.returncode}:"
                           f"\n{bench.stderr[-3000:]}")
    line = json.loads(bench.stdout.strip().splitlines()[-1])
    bench_s = time.perf_counter() - t0
    rows_path = os.path.abspath(f"{args.out}.{index}.chunks.json")
    t0 = time.perf_counter()
    worker = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--chunks_worker",
         rows_path], cwd=tree, capture_output=True, text=True,
        timeout=args.timeout)
    if worker.returncode != 0:
        raise RuntimeError(f"phases 10 and 6e in {tree} exited "
                           f"{worker.returncode}:\n{worker.stdout[-3000:]}"
                           f"\n{worker.stderr[-3000:]}")
    with open(rows_path) as f:
        chunks = json.load(f)
    return {"tree": tree, "correct": line["correct"],
            "bench": bench_summary(line), "bench_s": bench_s,
            "chunks_s": time.perf_counter() - t0, **chunks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", help="the other tree's root")
    p.add_argument("--rounds", type=int, default=3,
                   help="pairs of runs: other, this, then this, other, ...")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--repeats_big", type=int, default=3)
    p.add_argument("--timeout", type=int, default=900)
    p.add_argument("--out", default=os.path.join(HERE, "output",
                                                 "tree_compare.json"))
    p.add_argument("--chunks_worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.chunks_worker:
        chunks_worker(args.chunks_worker)
        return 0
    if not args.other:
        p.error("--other is required")
    trees = {"this": HERE, "other": os.path.abspath(args.other)}
    order = []
    for i in range(args.rounds):
        order += ["other", "this"] if i % 2 == 0 else ["this", "other"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = []
    for i, name in enumerate(order):
        row = dict(run_tree(trees[name], args, i), which=name)
        results.append(row)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        ms = {r["tag"]: round(r["stats"]["graphed"]["tick_ms"], 4)
              for r in row["rows"]}
        print(json.dumps({"run": i, "which": name, "correct": row["correct"],
                          "bench": row["bench"], "graphed_ms": ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
