"""The PyTorch port's renderer, video encoding and AIcrowd glue against
the JAX package's: frames byte for byte, the GIF fallback, the policy
video's rollout, and the grading flags, movies and uploads
(``tests/test_evaluator.py``'s cases)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dronerl_tpu.agents.dqn import DQN as JaxDQN
from dronerl_tpu.agents.dqn import DQNConfig as JaxConfig
from dronerl_tpu.env import core as jax_core
from dronerl_tpu.env.types import EnvParams as JaxEnv
from dronerl_tpu.render import renderer as jax_renderer
from dronerl_tpu.render import video as jax_video
from dronerl_tpu_torch import rng
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams, EnvState
from dronerl_tpu_torch.evaluator import aicrowd
from dronerl_tpu_torch.render import renderer, video

SMALL = dict(grid_size=6, n_drones=2, skyscrapers_factor=1, packets_factor=1,
             dropzones_factor=1, stations_factor=1)


def _port_state(state) -> EnvState:
    host = jax.device_get(state)
    return EnvState(*(torch.from_numpy(np.array(getattr(host, f))) for f in (
        "ground", "air_x", "air_y", "carrying_package", "charge")))


@pytest.mark.parametrize("scale,trace", [(1.0, 0), (2.0, 3)])
def test_frames_match_jax(scale, trace):
    """The same states (a reset and 6 random steps) draw the same frames,
    byte for byte, with traces and the reward panel."""
    params = JaxEnv()
    key = jax.random.PRNGKey(4)
    state = jax_core.reset(key, params)
    kw = dict(player_name_mappings={0: "agent"}, resolution_scale_factor=scale,
              trace_length=trace)
    ours = renderer.Renderer(params.n_drones, params.grid_size, **kw)
    theirs = jax_renderer.Renderer(params.n_drones, params.grid_size, **kw)
    ours.init()
    theirs.init()
    assert ours.render_state(_port_state(state)).tobytes() == \
        theirs.render_state(state).tobytes()
    for _ in range(6):
        key, act_key, step_key = jax.random.split(key, 3)
        actions = jax.random.randint(act_key, (params.n_drones,), 0, 5)
        state, rewards, _ = jax_core.step(step_key, state, actions, params)
        args = [np.asarray(x) for x in (
            state.ground, state.air_x, state.air_y, state.carrying_package,
            state.charge, rewards, actions)]
        a, b = ours.render_frame(*args), theirs.render_frame(*args)
        assert a.size == b.size and a.tobytes() == b.tobytes()


def test_render_policy_video_matches_jax(tmp_path):
    """The greedy-vs-random rollout of the policy video draws the JAX
    package's frames (the same net from one key)."""
    cfg = dict(hidden_layers=(8,))
    frames = {}

    def recorder(module, name):
        r = module.Renderer(2, 6)
        draw = r.render_frame

        def keep(*a):
            img = draw(*a)
            frames.setdefault(name, []).append(img.tobytes())
            return img

        r.render_frame = keep
        return r

    jagent = JaxDQN(JaxConfig(**cfg), JaxEnv(**SMALL))
    jax_video.render_policy_video(
        JaxEnv(**SMALL), jagent, jagent.init_state(jax.random.PRNGKey(1)),
        str(tmp_path / "jax.mp4"), num_steps=8, seed=3,
        renderer=recorder(jax_renderer, "jax"))
    agent = DQN(DQNConfig(**cfg), EnvParams(**SMALL), "cpu")
    out = video.render_policy_video(
        EnvParams(**SMALL), agent, agent.init_state(rng.PRNGKey(1)),
        str(tmp_path / "port.mp4"), num_steps=8, seed=3,
        renderer=recorder(renderer, "port"))
    assert os.path.getsize(out) > 0
    assert len(frames["port"]) == 9 and frames["port"] == frames["jax"]


def test_gif_fallback(tmp_path, monkeypatch):
    """Without OpenCV and ffmpeg the frames become an animated GIF beside
    the requested path."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(video.shutil, "which", lambda _: None)
    frames = [Image.new("RGB", (20, 20), (i * 50, 0, 0)) for i in range(4)]
    out = video.encode_video(frames, str(tmp_path / "clip.mp4"), fps=5)
    assert out == str(tmp_path / "clip.gif")
    with Image.open(out) as gif:
        assert gif.n_frames == 4
    with pytest.raises(ValueError, match="no frames"):
        video.encode_video([], str(tmp_path / "none.mp4"))


class _FakeS3:
    def __init__(self):
        self.calls = []

    def put_object(self, **kwargs):
        kwargs["Body"] = kwargs["Body"].read()
        self.calls.append(kwargs)


def _write_frames(folder, n=4, size=(40, 40)):
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        Image.new("RGB", size, (i * 40 % 255, 10, 10)).save(
            os.path.join(folder, f"{i:04d}.jpg"))


def test_aicrowd_grading_flags(monkeypatch):
    for var in ("AICROWD_IS_GRADING", "CROWDAI_IS_GRADING",
                "AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY"):
        monkeypatch.delenv(var, raising=False)
    assert not aicrowd.is_grading()
    assert not aicrowd.is_aws_configured()
    with pytest.raises(RuntimeError, match="AWS Credentials"):
        aicrowd.get_boto_client()
    monkeypatch.setenv("AICROWD_IS_GRADING", "true")
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    assert aicrowd.is_grading() and aicrowd.is_aws_configured()
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(RuntimeError, match="boto3 is not installed"):
        aicrowd.get_boto_client()


def test_aicrowd_movie_and_uploads(tmp_path, monkeypatch):
    frames = str(tmp_path / "frames")
    _write_frames(frames)
    out_path, thumb_path = aicrowd.generate_movie_from_frames(frames)
    assert os.path.getsize(out_path) > 0 and os.path.getsize(thumb_path) > 0
    monkeypatch.setenv("S3_UPLOAD_PATH_TEMPLATE", "media/{}.mp4")
    monkeypatch.setenv("S3_BUCKET", "test-bucket")
    s3 = _FakeS3()
    key = aicrowd.upload_to_s3(out_path, s3=s3)
    assert key.startswith("media/") and key.endswith(".mp4")
    assert aicrowd.upload_random_frame_to_s3(frames, s3=s3).endswith(".jpg")
    assert [c["Bucket"] for c in s3.calls] == ["test-bucket"] * 2
    assert all(c["ACL"] == "public-read" and c["Body"] for c in s3.calls)
    result = aicrowd.publish_submission_media(frames, s3=s3, movie=out_path)
    assert result["uploaded"] and len(s3.calls) == 4
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY"):
        monkeypatch.delenv(var, raising=False)
    local = aicrowd.publish_submission_media(frames)
    assert not local["uploaded"] and os.path.exists(local["video_path"])


def test_drone_racer_evaluator_on_cpu(tmp_path, monkeypatch):
    """The evaluator scores a submission against the five baselines and
    renders the first episode (two seeds of 30 steps here)."""
    from dronerl_tpu_torch.evaluator import evaluator

    real = evaluator.evaluate_checkpoints
    monkeypatch.setattr(evaluator, "evaluate_checkpoints",
                        lambda paths, device: real(
                            paths, episode_seeds=(845, 99), num_steps=30,
                            device=device))
    judge = evaluator.DroneRacerEvaluator(device="cpu")
    assert judge.agent_names() == sorted(
        [f"baseline-{i}" for i in range(1, 6)] + ["YOU"])
    submission = os.path.join(evaluator.BASELINES, "dqn-agent-2.safetensors")
    result = judge._evaluate({
        "submission_file_path": submission,
        "video_output_path": str(tmp_path / "episode0.mp4")})
    assert result["all_scores"]["YOU"] == result["score"]
    assert len(result["all_scores"]) == 6
    assert np.isfinite(list(result["all_scores"].values())).all()
    assert os.path.getsize(result["media_video_path"]) > 0
