"""Train the five evaluator baseline agents with the PyTorch port (the
counterpart of ``scripts/create_baselines.py``): four dense nets of
increasing width and one conv net, each trained against random
opponents (seed 100 + i, 32 envs, batch 32, two evals of 1,000 steps)
and saved as a JAX-format safetensors checkpoint, which either package
loads.

They go to ``output/baselines_<time>/`` unless ``--out_dir`` says
otherwise; the committed copies in ``dronerl_tpu_torch/evaluator/
baselines/`` are the arena's and stay as they are. On the card unless
``--device cpu``.

Usage: python scripts/torch_create_baselines.py [--num_steps 20000] \\
           [--num_eval_steps 1000] [--out_dir DIR] [--device cpu]
"""

import argparse
import glob
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dronerl_tpu_torch import train as train_mod  # noqa: E402

BASELINE_SPECS = [
    ("dqn-agent-1", ["--hidden_layers", "8"]),
    ("dqn-agent-2", ["--hidden_layers", "16"]),
    ("dqn-agent-3", ["--hidden_layers", "16", "16"]),
    ("dqn-agent-4", ["--hidden_layers", "32", "16"]),
    ("dqn-agent-5", ["--network_type", "conv", "--conv_dense_layers", "16"]),
]


def default_out_dir() -> str:
    return os.path.join(REPO, "output",
                        time.strftime("baselines_%Y%m%d_%H%M%S"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_steps", type=int, default=20_000)
    parser.add_argument("--num_envs", type=int, default=32)
    parser.add_argument("--num_eval_steps", type=int, default=1000,
                        help="each of the two evals' steps")
    parser.add_argument("--out_dir", type=str, default=None,
                        help="default: output/baselines_<time>/")
    parser.add_argument("--device", default="cuda",
                        help="default: the card")
    cli = parser.parse_args(argv)

    out_dir = cli.out_dir or default_out_dir()
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, (name, flags) in enumerate(BASELINE_SPECS):
        print(f"=== training baseline {name} ===", flush=True)
        run_dir = os.path.join(out_dir, f"run_{name}")
        args = train_mod.parse_args([
            "--device", cli.device,
            "--num_steps", str(cli.num_steps),
            "--num_envs", str(cli.num_envs),
            "--batch_size", "32",
            "--seed", str(100 + i),
            "--num_evals", "2",
            "--num_eval_steps", str(cli.num_eval_steps),
            "--save_final_checkpoint",
            "--run_dir", run_dir,
        ] + flags)
        metrics = train_mod.train(args)
        src = glob.glob(os.path.join(run_dir, "*_jax.safetensors"))[0]
        dst = os.path.join(out_dir, f"{name}.safetensors")
        shutil.copy(src, dst)
        written.append(dst)
        print(f"{name}: eval {metrics.get('eval_reward_mean'):.3f} → {dst}",
              flush=True)
    return written


if __name__ == "__main__":
    main()
