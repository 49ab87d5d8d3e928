"""Episode video rendering: a greedy rollout → PIL frames → a video
(counterpart of ``dronerl_tpu/render/video.py``).

Encoding prefers OpenCV's mp4 writer, falls back to an ``ffmpeg``
subprocess, and to an animated GIF beside the requested path as the last
resort. The rollout is the JAX package's: drone 0 greedy on the agent's
Q-values, the other drones uniformly random, one env on the agent's
device, the state fetched to the host once a frame.
"""

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

import numpy as np
import torch

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.constants import NUM_ACTIONS
from dronerl_tpu_torch.env import core as env_core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.render.renderer import Renderer


def encode_video(frames: List, output_path: str, fps: int = 4) -> str:
    """Encode PIL frames to a video file. Returns the written path (a
    ``.gif`` beside ``output_path`` when neither OpenCV nor ffmpeg can
    write it)."""
    if not frames:
        raise ValueError("no frames to encode")
    try:
        import cv2

        h, w = frames[0].height, frames[0].width
        # mp4 encoders want even dimensions
        w2, h2 = w - (w % 2), h - (h % 2)
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        writer = cv2.VideoWriter(output_path, fourcc, fps, (w2, h2))
        if writer.isOpened():
            for frame in frames:
                arr = np.asarray(frame.convert("RGB"))[:h2, :w2, ::-1]
                writer.write(np.ascontiguousarray(arr))
            writer.release()
            return output_path
    except ImportError:
        pass

    if shutil.which("ffmpeg"):
        with tempfile.TemporaryDirectory() as tmp:
            for i, frame in enumerate(frames):
                frame.save(os.path.join(tmp, f"{i:04d}.png"))
            cmd = [
                "ffmpeg", "-y", "-r", str(fps), "-start_number", "0",
                "-i", os.path.join(tmp, "%04d.png"),
                "-c:v", "libx264", "-vf", f"fps={fps}",
                "-pix_fmt", "yuv420p", output_path,
            ]
            result = subprocess.run(cmd, capture_output=True)
            if result.returncode != 0:
                raise RuntimeError(result.stderr.decode())
        return output_path

    # last resort: an animated GIF next to the requested path
    gif_path = os.path.splitext(output_path)[0] + ".gif"
    frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return gif_path


def host_frame(renderer: Renderer, state, rewards, actions):
    """``renderer``'s frame of one env's state, rewards and actions (any
    device)."""
    host = [getattr(state, f).cpu().numpy() for f in (
        "ground", "air_x", "air_y", "carrying_package", "charge")]
    return renderer.render_frame(*host, rewards.cpu().numpy(),
                                 actions.cpu().numpy())


def render_policy_video(env_params: EnvParams, agent, ag_state,
                        output_path: str, num_steps: int = 200,
                        seed: int = 0, fps: int = 4,
                        renderer: Optional[Renderer] = None) -> str:
    """Roll out greedy drone 0 against random drones and encode the
    episode: each step splits the key three ways (carry, actions, step),
    the random actions are ``randint(act_key, (N,), 0, 5)`` and drone 0's
    the lowest-index argmax of ``agent.q_values``."""
    device = agent.device
    key = rng.PRNGKey(seed)
    state = env_core.reset(key.to(device), env_params)
    if renderer is None:
        renderer = Renderer(env_params.n_drones, env_params.grid_size,
                            resolution_scale_factor=2.0)
    if not renderer.is_initialized:
        renderer.init()

    frames = [renderer.render_state(state)]
    for _ in range(num_steps):
        key, act_key, step_key = rng.split(key, 3)
        actions = rng.randint(act_key, (env_params.n_drones,), 0, NUM_ACTIONS)
        obs = env_core.observe(state, env_params, 1).reshape(1, agent.obs_dim)
        with torch.no_grad():
            q = agent.q_values(ag_state.params, obs)
        actions[0] = torch.argmax(q[0]).to(torch.int32).cpu()
        actions = actions.to(device)
        state, rewards, _ = env_core.step(step_key.to(device), state,
                                          actions, env_params)
        frames.append(host_frame(renderer, state, rewards, actions))
    return encode_video(frames, output_path, fps=fps)
