"""W&B Bayesian hyper-parameter sweep entry point (counterpart of
``dronerl_tpu/sweep.py``).

A bayes search over network topology, env batch, exploration schedule,
batch size, learning rate, the learner's schedule and the env's shaping,
maximising the final eval reward. Each trial runs the trainer CLI
(:mod:`dronerl_tpu_torch.train`); ``--use_sharding`` turns on by itself
where the process group spans several ranks (one a device, torchrun's
``WORLD_SIZE``) and the env batch divides over them.

Run: python -m dronerl_tpu_torch.sweep [--count 20] [--num_steps 5000000]
Requires the optional ``wandb`` package, imported where it is used.
"""

import argparse
import os

import torch

SWEEP_CONFIG = {
    "method": "bayes",
    "metric": {"goal": "maximize", "name": "eval_reward"},
    "parameters": {
        # One joint topology parameter, so the search never varies a
        # dimension the chosen net ignores: "dense:<widths>" sets
        # --hidden_layers; "conv[:<head widths>]" the CLI's default conv
        # stack with an optional --conv_dense_layers head.
        "topology": {"values": [
            "dense:16,16", "dense:64,32", "dense:128,64",
            "conv", "conv:32",
        ]},
        "num_envs": {"values": [1, 8, 64, 512]},
        "epsilon_end": {"values": [0.01, 0.05, 0.1]},
        "batch_size": {"values": [8, 32, 128]},
        "learning_rate": {"values": [1e-2, 1e-3, 1e-4]},
        "gamma": {"values": [0.9, 0.95, 0.99, 0.995, 0.999]},
        "target_update_interval": {"values": [1, 10, 100]},
        "epsilon_decay": {"values": [0.9, 0.95, 0.99, 0.995, 0.999]},
        "epsilon_decay_every": {"values": [1, 5, 25]},
        "memory_size": {"values": [1_000, 10_000, 100_000]},
        "n_drones": {"values": [2, 4, 8]},
        "pickup_reward": {"values": [0.0, 0.1, 0.5, 1.0]},
    },
}


def world_size() -> int:
    """The ranks a trial would shard over: the process group's, else
    torchrun's ``WORLD_SIZE``, else 1."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def trial_argv(cfg, num_steps: int, world: int = 1,
               device: str = "cuda") -> list:
    """The trainer CLI's arguments for one trial's config ``cfg`` (any
    object with the swept parameters as attributes)."""
    net, _, spec = cfg.topology.partition(":")
    argv = [
        "--device", device,
        "--num_steps", str(num_steps),
        "--network_type", net,
        "--num_envs", str(cfg.num_envs),
        "--epsilon_end", str(cfg.epsilon_end),
        "--batch_size", str(cfg.batch_size),
        "--learning_rate", str(cfg.learning_rate),
        "--gamma", str(cfg.gamma),
        "--target_update_interval", str(cfg.target_update_interval),
        "--epsilon_decay", str(cfg.epsilon_decay),
        "--epsilon_decay_every", str(cfg.epsilon_decay_every),
        "--memory_size", str(cfg.memory_size),
        "--n_drones", str(cfg.n_drones),
        "--pickup_reward", str(cfg.pickup_reward),
    ]
    if net == "dense":
        argv += ["--hidden_layers", *spec.split(",")]
    elif spec:
        argv += ["--conv_dense_layers", *spec.split(",")]
    if world > 1 and cfg.num_envs > 1 and cfg.num_envs % world == 0:
        argv.append("--use_sharding")
    return argv


def run_trial(num_steps: int, device: str = "cuda"):
    import wandb

    from dronerl_tpu_torch import train as train_mod

    run = wandb.init()
    args = train_mod.parse_args(trial_argv(wandb.config, num_steps,
                                           world_size(), device))
    metrics = train_mod.train(args)
    run.log({
        "eval_reward": metrics.get("eval_reward_mean", float("-inf")),
        "obs_per_sec": metrics["obs_per_sec"],
    })
    run.finish()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--count", type=int, default=20)
    parser.add_argument("--num_steps", type=int, default=5_000_000)
    parser.add_argument("--project", type=str, default="dronerl-tpu-sweep")
    parser.add_argument("--entity", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()

    import wandb

    sweep_id = wandb.sweep(SWEEP_CONFIG, project=args.project,
                           entity=args.entity)
    wandb.agent(sweep_id, lambda: run_trial(args.num_steps, args.device),
                count=args.count)


if __name__ == "__main__":
    main()
