"""The competition CLI of the PyTorch port (the counterpart of
``scripts/evaluate_agent.py``): a checkpoint scored against the five
frozen baselines by ``DroneRacerEvaluator._evaluate``, on the card
unless ``--device cpu``.

Usage: python scripts/torch_evaluate_agent.py <model.safetensors> \\
           [--video_output_path out.mp4] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dronerl_tpu_torch.evaluator.evaluator import (  # noqa: E402
    DroneRacerEvaluator)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("submission", help="path to a safetensors checkpoint")
    parser.add_argument("--video_output_path", default=None)
    parser.add_argument("--device", default="cuda",
                        help="default: the card")
    args = parser.parse_args(argv)

    evaluator = DroneRacerEvaluator(device=args.device)
    result = evaluator._evaluate({
        "submission_file_path": args.submission,
        "aicrowd_submission_id": 0,
        "aicrowd_participant_id": 0,
        "video_output_path": args.video_output_path,
    })
    print(f"score: {result['score']:.3f} ± {result['score_secondary']:.3f}")
    print(f"video: {result['media_video_path']}")
    for name, score in sorted(result["all_scores"].items()):
        print(f"  {name:12s} {score:8.2f}")
    return result


if __name__ == "__main__":
    main()
