"""AIcrowd platform glue: grading-mode detection, S3 uploads, movies
(counterpart of ``dronerl_tpu/evaluator/aicrowd.py``).

Counterpart of the reference's leaderboard plumbing
(reference: aicrowd_helpers.py:24-147 and the aicrowd.json manifest):
environment-variable-driven grading detection, S3 media uploads behind an
optional boto3 import, and the two-size (thumbnail + normal) episode
movie the grader attaches to a submission. The manifest lives at the repo
root (``aicrowd.json``) and names :class:`~dronerl_tpu_torch.evaluator
.evaluator.DroneRacerEvaluator` as the entry class, mirroring the
reference manifest's keys.

Differences from the reference, by design:

- movie encoding reuses :func:`dronerl_tpu_torch.render.video.encode_video`
  (cv2 → ffmpeg → GIF fallback chain) instead of a hard ffmpeg
  subprocess, so grading boxes without an ffmpeg binary still produce
  media; frame files may be jpg or png.
- boto3 stays optional: credential and import
  errors raise with the same messages/shape the platform expects, and
  the client is injectable for tests.
"""

import glob
import os
import random
import uuid
from typing import List, Optional, Tuple

S3_BUCKET_DEFAULT = "aicrowd-production"
S3_UPLOAD_PATH_TEMPLATE_DEFAULT = "misc/amld2020-drone-rl-workshop/{}.mp4"

# Frame sizes the grader publishes (reference: aicrowd_helpers.py:127,141).
THUMB_SIZE = (320, 320)
VIDEO_SIZE = (600, 600)
MOVIE_FPS = 7


def _env(name: str, default=False):
    return os.getenv(name, default)


def is_grading() -> bool:
    """True inside the grading pipeline (reference: aicrowd_helpers.py:55-57)."""
    return bool(_env("CROWDAI_IS_GRADING") or _env("AICROWD_IS_GRADING"))


def is_aws_configured() -> bool:
    return bool(_env("AWS_ACCESS_KEY_ID") and _env("AWS_SECRET_ACCESS_KEY"))


def get_boto_client():
    """S3 client from env credentials (reference: aicrowd_helpers.py:30-45)."""
    if not is_aws_configured():
        raise RuntimeError("AWS Credentials not provided..")
    try:
        import boto3
    except ImportError as e:  # boto3 is optional
        raise RuntimeError(
            "boto3 is not installed. Please manually install by: "
            "pip install -U boto3") from e
    return boto3.client(
        "s3",
        aws_access_key_id=_env("AWS_ACCESS_KEY_ID"),
        aws_secret_access_key=_env("AWS_SECRET_ACCESS_KEY"),
    )


def _upload(localpath: str, key: str, s3=None) -> str:
    s3 = s3 or get_boto_client()
    bucket = _env("S3_BUCKET", S3_BUCKET_DEFAULT)
    if not bucket:
        raise RuntimeError("S3_BUCKET not provided...")
    with open(localpath, "rb") as body:
        s3.put_object(ACL="public-read", Bucket=bucket, Key=key, Body=body)
    return key


def _key_template() -> str:
    template = _env("S3_UPLOAD_PATH_TEMPLATE", S3_UPLOAD_PATH_TEMPLATE_DEFAULT)
    if not template:
        raise RuntimeError("S3_UPLOAD_PATH_TEMPLATE not provided...")
    return template


def upload_to_s3(localpath: str, s3=None) -> str:
    """Upload a media file under a fresh UUID key; returns the key
    (reference: aicrowd_helpers.py:79-93)."""
    return _upload(localpath, _key_template().format(uuid.uuid4()), s3=s3)


def upload_random_frame_to_s3(frames_folder: str, s3=None) -> str:
    """Upload one random frame as the submission's still thumbnail
    (reference: aicrowd_helpers.py:60-76)."""
    frames = sorted(
        glob.glob(os.path.join(frames_folder, "*.jpg"))
        + glob.glob(os.path.join(frames_folder, "*.png")))
    if not frames:
        raise RuntimeError(f"no frames found under {frames_folder}")
    frame = random.choice(frames)
    ext = os.path.splitext(frame)[1]
    key = _key_template().replace(".mp4", ext).format(uuid.uuid4())
    return _upload(frame, key, s3=s3)


def _load_frames(frames_folder: str, size: Tuple[int, int]) -> List:
    from PIL import Image

    paths = sorted(
        glob.glob(os.path.join(frames_folder, "*.jpg"))
        + glob.glob(os.path.join(frames_folder, "*.png")))
    if not paths:
        raise RuntimeError(f"no frames found under {frames_folder}")
    return [Image.open(p).convert("RGB").resize(size, Image.NEAREST)
            for p in paths]


def generate_movie_from_frames(frames_folder: str) -> Tuple[str, str]:
    """Encode the grader's two movies from a folder of ordered frames.

    Returns ``(out_path, thumb_path)`` — a 600×600 normal video and a
    320×320 thumbnail at 7 fps, both written into ``frames_folder``
    (reference: aicrowd_helpers.py:108-147; sizes/fps at :127,:141).
    """
    from dronerl_tpu_torch.render.video import encode_video

    thumb_path = encode_video(
        _load_frames(frames_folder, THUMB_SIZE),
        os.path.join(frames_folder, "out_thumb.mp4"), fps=MOVIE_FPS)
    out_path = encode_video(
        _load_frames(frames_folder, VIDEO_SIZE),
        os.path.join(frames_folder, "out.mp4"), fps=MOVIE_FPS)
    return out_path, thumb_path


def publish_submission_media(frames_folder: str, s3=None,
                             movie: Optional[str] = None) -> dict:
    """Grading-pipeline convenience: movie → S3, plus a still frame.

    Composes the reference's `_evaluate` media steps (reference:
    drone_evaluator.py:190-193 + aicrowd_helpers.py uploads) into one
    call; returns the S3 keys. Outside grading mode (or without AWS
    credentials and an injected client) it only encodes the movie and
    returns local paths, so local runs never need boto3.
    """
    if movie is None:
        movie, thumb = generate_movie_from_frames(frames_folder)
    else:
        thumb = None
    if not (s3 or is_aws_configured()):
        return {"video_path": movie, "thumb_path": thumb, "uploaded": False}
    return {
        "video_key": upload_to_s3(movie, s3=s3),
        "frame_key": upload_random_frame_to_s3(frames_folder, s3=s3),
        "uploaded": True,
    }
