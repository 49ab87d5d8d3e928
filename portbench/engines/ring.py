"""The ring engine's carry ``(rng, (tstate, ring), (actions, rewards,
dones), learner, aux, step)``: after tick ``step`` the next observations
sit in the ring's slot after the tick's, and the tick's drone-0 scalars
at its own slot."""

import torch

from portbench import engines
from portbench.engines import learner, state_answers  # noqa: F401


def answers(carry, step: int, num_envs: int) -> dict:
    (tstate, ring), (a_ring, r_ring, d_ring) = carry[1], carry[2]
    nb = ring.shape[1] // num_envs
    read = (step % nb) * num_envs
    write = ((step + 1) % nb) * num_envs
    cols = slice(read, read + num_envs)
    return {**state_answers(tstate),
            "obs": ring[:, write:write + num_envs].float().cpu(),
            "action": a_ring[cols].cpu(), "reward": r_ring[cols].cpu(),
            "done": d_ring[cols].to(torch.bool).cpu()}


def snapshot(carry) -> dict:
    (tstate, ring), scalars = carry[1], carry[2]
    return engines.snapshot(carry, tstate, dict(zip(
        ("ring", "actions", "rewards", "dones"),
        (t.clone() for t in (ring, *scalars)))))
