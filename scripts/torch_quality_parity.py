"""Learning-quality lock of the PyTorch port: trained agents' final eval
reward at the frozen configuration of ``scripts/quality_parity.py``.

Runs ``python -m dronerl_tpu_torch.train`` as a subprocess per seed at
the CLI defaults (grid 9, 4 drones, ``num_envs`` 1: the jnp engine,
batch 8, lr 1e-3, gamma 0.9) for 50,000 steps, then the final eval (5
greedy episodes x 10k steps, eval seeds 0-4), and records the agent's
and the random agent's means. Three configurations, each written to its
own file beside the JAX package's frozen record, whose ``reference``
rows form the band that ``tests/test_torch_quality_parity.py`` holds
the port's mean to:

    dense        dense (16,16)   torch_quality_parity_results.json
    conv         conv (CLI)      torch_quality_parity_results_conv.json
    dense128x64  dense (128,64)  torch_quality_parity_results_dense128x64.json

The port's files hold ``repo`` rows only (``"reference": []``); each
file's ``config`` names the JAX file of its band and the device. The
runs go on the card unless ``--device cpu``; ``--jobs N`` runs N seeds
at once as separate processes. A file is updated after every run, and
seeds already in it (at the same step count and device) are skipped.

Usage:
    python scripts/torch_quality_parity.py --config dense --seeds 0 1 2 3 4
    python scripts/torch_quality_parity.py --config conv dense128x64 \\
        --seeds 0 1 2 --jobs 6
"""

import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")

# name -> (extra CLI flags, net description, the JAX package's record)
CONFIGS = {
    "dense": ((), "dense (16,16)", "quality_parity_results.json"),
    "conv": (("--network_type", "conv"), "conv (8ch 3x3, CLI default)",
             "quality_parity_results_conv.json"),
    "dense128x64": (("--hidden_layers", "128", "64"), "dense (128x64)",
                    "quality_parity_results_dense128x64.json"),
}

# train.py's "Final eval: agent m ± s | random m ± s" line.
EVAL_RE = re.compile(
    r"Final eval: agent (-?\d+\.\d+) . (-?\d+\.\d+) \| "
    r"random (-?\d+\.\d+) . (-?\d+\.\d+)")


def results_path(name: str, out_dir: str = SCRIPTS) -> str:
    suffix = "" if name == "dense" else f"_{name}"
    return os.path.join(out_dir, f"torch_quality_parity_results{suffix}.json")


def device_name(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``cpu``."""
    if device == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def run_seed(name: str, seed: int, num_steps: int, device: str,
             threads: int, run_root: str) -> dict:
    """One training run of ``name`` at ``seed``; its row."""
    run_dir = os.path.join(run_root, f"torch_parity_{name}_seed{seed}")
    os.makedirs(run_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "dronerl_tpu_torch.train",
           "--device", device, "--seed", str(seed),
           "--num_steps", str(num_steps), "--run_dir", run_dir,
           *CONFIGS[name][0]]
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               PYTHONPATH=REPO)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True)
    wall = time.time() - t0
    out = proc.stdout + proc.stderr
    with open(os.path.join(run_dir, "train.log"), "w") as f:
        f.write(out)
    match = EVAL_RE.search(out)
    metrics_path = os.path.join(run_dir, "metrics.json")
    if proc.returncode != 0 or not match or not os.path.exists(
            metrics_path):
        raise RuntimeError(f"{name} seed {seed} failed:\n{out[-3000:]}")
    with open(metrics_path) as f:
        metrics = json.load(f)
    return {
        "seed": seed,
        "eval_reward_mean": metrics["eval_reward_mean"],
        "eval_reward_std": metrics["eval_reward_std"],
        "random_reward_mean": float(match.group(3)),
        "random_reward_std": float(match.group(4)),
        "train_seconds": metrics["time_taken"],
        "wall_seconds": round(wall, 1),
    }


def load_results(name: str, path: str, num_steps: int,
                 device: str) -> dict:
    """The file's rows when its step count and device match this run's,
    else a fresh record."""
    extra, net, jax_file = CONFIGS[name]
    fresh = {"config": {
        "num_steps": num_steps,
        "trainer_config": f"CLI defaults: grid 9, 4 drones, {net}, "
                          "num_envs 1, batch 8, lr 1e-3, gamma 0.9",
        "cli": ["python", "-m", "dronerl_tpu_torch.train", *extra],
        "eval": "5 greedy episodes x 10k steps, eval seeds 0-4",
        "reference": f"scripts/{jax_file}",
        "device": device,
    }, "reference": [], "repo": []}
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        cfg = prev.get("config", {})
        if cfg.get("num_steps") == num_steps and cfg.get(
                "device") == device:
            return prev
    return fresh


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", nargs="+", choices=sorted(CONFIGS),
                   default=["dense"])
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--num_steps", type=int, default=50_000)
    p.add_argument("--device", default="cuda",
                   help="the trainer's device (default: the card)")
    p.add_argument("--jobs", type=int, default=1,
                   help="seeds run at once, one process each")
    p.add_argument("--out_dir", default=SCRIPTS,
                   help="where the results files go")
    p.add_argument("--run_root", default=os.path.join(REPO, "output"),
                   help="the runs' directories go under it")
    args = p.parse_args(argv)

    device = device_name(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    records = {name: load_results(name, results_path(name, args.out_dir),
                                  args.num_steps, device)
               for name in args.config}
    todo = [(name, seed) for name in args.config for seed in args.seeds
            if not any(r["seed"] == seed for r in records[name]["repo"])]
    threads = max(1, (os.cpu_count() or 1) // max(1, args.jobs))
    lock = threading.Lock()

    def one(name, seed):
        print(f"[{name}] seed {seed} ...", flush=True)
        row = run_seed(name, seed, args.num_steps, args.device, threads,
                       args.run_root)
        with lock:
            rows = records[name]["repo"]
            rows.append(row)
            rows.sort(key=lambda r: r["seed"])
            records[name]["config"]["seeds"] = [r["seed"] for r in rows]
            with open(results_path(name, args.out_dir), "w") as f:
                json.dump(records[name], f, indent=2)
        print(f"[{name}] seed {seed}: {row}", flush=True)

    failed = 0
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        futures = [pool.submit(one, *job) for job in todo]
        for fut in concurrent.futures.as_completed(futures):
            if fut.exception() is not None:
                failed += 1
                print(fut.exception(), file=sys.stderr, flush=True)

    for name in args.config:
        rows = records[name]["repo"]
        if rows:
            means = [r["eval_reward_mean"] for r in rows]
            print(f"{name} on {device}: mean over {len(rows)} seeds = "
                  f"{sum(means) / len(means):.4f}  per-seed = "
                  f"{[round(m, 4) for m in means]}")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
