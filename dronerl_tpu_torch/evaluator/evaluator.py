"""Round-robin competition evaluator over fixed seeds (counterpart of
``dronerl_tpu/evaluator/evaluator.py``).

N checkpoints fly in one shared world, one drone each, for 10 fixed
episode seeds × 1,000 greedy steps; an agent's score is its summed reward
per episode, averaged over the episodes (secondary: the standard
deviation). The arena's side follows the drone-density rule
``ceil(sqrt(N / 0.05))``.

As in the JAX package, every episode runs at once: the seed axis is the
env axis of the plain env core (``core.reset_keys`` / ``step_batch``),
each agent takes one Q forward a tick over all the seeds, and the key
chain is the JAX package's (episode s starts from ``PRNGKey(seed_s)``,
which is also its carry; each tick splits it two ways). Everything runs
on ``device``; on the card the ticks are one CUDA graph
(``utils.graphs.scan``), as the JAX package's are one compiled program.

Greedy argmax turns the last bits of a Q-value into a different action
at a near tie, so scores are bitwise only between runs on the same
backend; each step's actions and each agent's best-minus-second Q gap
come back with the scores, which lets a caller find where two backends'
episodes part.
"""

import logging
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dronerl_tpu_torch import resolve_device, rng
from dronerl_tpu_torch.agents.dqn import DQN
from dronerl_tpu_torch.env import core as env_core
from dronerl_tpu_torch.env.types import EnvParams, EnvState, env_fields
from dronerl_tpu_torch.utils.graphs import scan

logger = logging.getLogger(__name__)

EPISODE_SEEDS = (845, 99, 65, 96, 85, 39, 51, 17, 52, 35)
TOTAL_EPISODE_STEPS = 1000
DRONE_DENSITY = 0.05
BASELINES = os.path.join(os.path.dirname(os.path.realpath(__file__)),
                         "baselines")


def arena_params(n_drones: int, window_radius: int = 3) -> EnvParams:
    side = int(math.ceil(math.sqrt(n_drones / DRONE_DENSITY)))
    return EnvParams(
        n_drones=n_drones, grid_size=side, window_radius=window_radius)


def seed_keys(seeds) -> torch.Tensor:
    """``jax.vmap(jax.random.PRNGKey)`` over uint32 seeds: (S, 2) host
    keys ``(0, seed)``."""
    return torch.tensor([[0, int(s) & 0xFFFFFFFF] for s in seeds],
                        dtype=torch.int64)


def q_gap(q: torch.Tensor) -> torch.Tensor:
    """(B, A) Q-values → (B,) best minus second best over max |q|: a near
    tie where it is at most 1e-5."""
    top = torch.topk(q, 2, dim=-1).values
    scale = q.abs().amax(dim=-1).clamp_min(torch.finfo(q.dtype).tiny)
    return (top[..., 0] - top[..., 1]) / scale


def evaluate_checkpoints(
    checkpoint_paths: List[str],
    episode_seeds: Tuple[int, ...] = EPISODE_SEEDS,
    num_steps: int = TOTAL_EPISODE_STEPS,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Fly one drone per checkpoint; return per-agent score stats.

    Returns ``mean`` (N,), ``std`` (N,), the raw ``episode_scores``
    (num_episodes, N), each step's ``actions`` (num_steps, num_episodes,
    N) and ``q_gap`` (the same shape, :func:`q_gap` of each agent's
    Q-values)."""
    device = resolve_device(device)
    n = len(checkpoint_paths)
    params = arena_params(n)
    agents = [DQN.restore(path, params, device) for path in checkpoint_paths]
    keys = seed_keys(episode_seeds).to(device)
    state = env_core.reset_keys(keys, params)

    def tick(carry):
        keys, state = carry[0], EnvState(*carry[1:])
        split = rng.split(keys, 2)
        keys, step_keys = split[:, 0], split[:, 1]
        obs = env_core.observe_batch(state, params)
        q = torch.stack([agent.q_values(net, obs[:, i])
                         for i, (agent, net) in enumerate(agents)],
                        dim=1)  # (S, N, A)
        actions = torch.argmax(q, dim=-1).to(torch.int32)
        state, rewards, _ = env_core.step_batch(step_keys, state, actions,
                                                params)
        return (keys, *env_fields(state)), (rewards, actions, q_gap(q))

    with torch.no_grad():
        _, (rewards, actions, gaps) = scan(
            tick, (keys, *env_fields(state)), num_steps)
    episode_scores = rewards.sum(dim=0).cpu().numpy()
    return {
        "mean": episode_scores.mean(axis=0),
        "std": episode_scores.std(axis=0),
        "episode_scores": episode_scores,
        "actions": actions.cpu().numpy(),
        "q_gap": gaps.cpu().numpy(),
    }


class DroneRacerEvaluator:
    """AIcrowd-style evaluator: frozen baselines plus one submission.

    ``answer_folder_path`` defaults to the five frozen checkpoints shipped
    in ``dronerl_tpu_torch/evaluator/baselines/`` (byte copies of the JAX
    package's)."""

    def __init__(self, answer_folder_path: Optional[str] = None,
                 round: int = 1, device="cuda"):
        self.round = round
        self.device = device
        base = answer_folder_path or BASELINES
        self.participating_agents = {
            f"baseline-{i}": os.path.join(base, f"dqn-agent-{i}.safetensors")
            for i in range(1, 6)
        }
        missing = [p for p in self.participating_agents.values()
                   if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"missing baseline checkpoints: {missing}")

    def agent_names(self, with_submission: bool = True) -> List[str]:
        names = list(self.participating_agents)
        if with_submission:
            names.append("YOU")
        return sorted(names)

    def _evaluate(self, client_payload: dict,
                  _context: Optional[dict] = None) -> dict:
        """Score a submission against the baselines.

        ``client_payload`` needs ``submission_file_path``; returns a dict
        with ``score``, ``score_secondary``, ``media_video_path`` and
        ``all_scores``."""
        paths = dict(self.participating_agents)
        paths["YOU"] = client_payload["submission_file_path"]
        ordered_names = sorted(paths)
        ordered_paths = [paths[name] for name in ordered_names]

        results = evaluate_checkpoints(ordered_paths, device=self.device)
        you = ordered_names.index("YOU")

        video_path = client_payload.get("video_output_path")
        if video_path is None:
            import tempfile

            video_path = os.path.join(tempfile.mkdtemp(), "episode0.mp4")
        video_path = self._render_first_episode(ordered_paths, ordered_names,
                                                video_path)
        logger.info("evaluator scores: %s",
                    dict(zip(ordered_names, results["mean"])))
        return {
            "score": float(results["mean"][you]),
            "score_secondary": float(results["std"][you]),
            "media_video_path": video_path,
            "all_scores": dict(zip(ordered_names, results["mean"].tolist())),
        }

    def _render_first_episode(self, paths, names, output_path,
                              num_frames: int = 60) -> str:
        """The first episode's first ``num_frames`` steps as a video."""
        from dronerl_tpu_torch.render.renderer import Renderer
        from dronerl_tpu_torch.render.video import encode_video, host_frame

        device = resolve_device(self.device)
        n = len(paths)
        params = arena_params(n)
        agents = [DQN.restore(p, params, device) for p in paths]
        key = rng.PRNGKey(EPISODE_SEEDS[0])
        state = env_core.reset(key.to(device), params)
        renderer = Renderer(n, params.grid_size,
                            player_name_mappings=dict(enumerate(names)),
                            resolution_scale_factor=2.0)
        renderer.init()
        frames = [renderer.render_state(state)]
        for _ in range(num_frames):
            key, step_key = rng.split(key, 2)
            obs = env_core.observe(state, params)
            with torch.no_grad():
                actions = torch.stack([
                    torch.argmax(agent.q_values(net, obs[i:i + 1])[0])
                    for i, (agent, net) in enumerate(agents)]).to(torch.int32)
            state, rewards, _ = env_core.step(step_key.to(device), state,
                                              actions, params)
            frames.append(host_frame(renderer, state, rewards, actions))
        return encode_video(frames, output_path)
