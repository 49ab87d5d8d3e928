#!/usr/bin/env python3
"""Time the port's evaluation on the card eagerly and as CUDA graphs.

``train.evaluate`` and ``evaluator.evaluate_checkpoints`` run a tick of
the plain env core a step; ``utils.graphs.scan`` captures that tick once
as a CUDA graph and replays it. This script runs both loops each way in
one call (eager, graph, graph, eager), holds the graphed results to the
eager ones bitwise, and prints the seconds of each:

    python scripts/torch_eval_graph.py [--steps 200]

It needs a CUDA card and prints the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dronerl_tpu_torch import rng, train  # noqa: E402
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig  # noqa: E402
from dronerl_tpu_torch.evaluator import evaluator  # noqa: E402
from dronerl_tpu_torch.utils import graphs  # noqa: E402


def eager(tick, carry, length):
    """``graphs.scan``'s CPU loop, run on the card."""
    steps = []
    for _ in range(length):
        carry, outs = tick(carry)
        steps.append(outs)
    return carry, tuple(torch.stack(o) for o in zip(*steps))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    steps = p.parse_args().steps
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    order = (("eager", eager), ("graph", graphs.scan),
             ("graph", graphs.scan), ("eager", eager))
    args = train.parse_args(["--num_evals", "5", "--num_eval_steps",
                             str(steps)])
    env = train.env_params_from_args(args, eval_mode=True)
    for cfg in (DQNConfig(hidden_layers=(16, 16)),
                DQNConfig(network_type="conv", conv_dense_layers=(16,))):
        agent = DQN(cfg, env, "cuda")
        state = agent.init_state(rng.PRNGKey(0))
        results = []
        for name, fn in order:
            train.scan = fn
            out, seconds = timed(lambda: train.evaluate(args, agent, state))
            results.append(out)
            print(f"evaluate {cfg.network_type}, 5 seeds x {steps} steps, "
                  f"{name}: {seconds:.3f} s -> {out}", flush=True)
        if any(r != results[0] for r in results):
            sys.exit(f"evaluate: the graphed results differ: {results}")
    paths = [os.path.join(evaluator.BASELINES, f"dqn-agent-{i}.safetensors")
             for i in range(1, 6)]
    results = []
    for name, fn in order:
        evaluator.scan = fn
        out, seconds = timed(lambda: evaluator.evaluate_checkpoints(
            paths, num_steps=steps, device="cuda"))
        results.append(out)
        print(f"arena of the five baselines, 10 seeds x {steps} steps, "
              f"{name}: {seconds:.3f} s -> mean {out['mean'].tolist()}",
              flush=True)
    for key in ("episode_scores", "actions", "q_gap"):
        if any((r[key] != results[0][key]).any() for r in results):
            sys.exit(f"arena: the graphed {key} differ")
    print(f"graphed results equal the eager ones bitwise, on {card}")


if __name__ == "__main__":
    main()
