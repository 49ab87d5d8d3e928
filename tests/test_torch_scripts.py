"""The port's competition CLI (``scripts/torch_evaluate_agent.py``) and
baseline creator (``scripts/torch_create_baselines.py``) on the CPU."""

import importlib.util
import os

import pytest

from dronerl_tpu_torch.evaluator import evaluator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_evaluate_agent_prints_a_score(tmp_path, capsys):
    cli = load_script("torch_evaluate_agent")
    ckpt = os.path.join(evaluator.BASELINES, "dqn-agent-3.safetensors")
    result = cli.main([ckpt, "--device", "cpu", "--video_output_path",
                       str(tmp_path / "episode.mp4")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (f"score: {result['score']:.3f} ± "
                        f"{result['score_secondary']:.3f}")
    assert lines[1].startswith("video: ")
    assert sorted(result["all_scores"]) == [
        "YOU", *[f"baseline-{i}" for i in range(1, 6)]]
    # The submission is baseline 3's checkpoint, in one more slot.
    assert len(lines) == 2 + 6


def test_create_baselines_writes_five_loadable_checkpoints(tmp_path):
    cli = load_script("torch_create_baselines")
    written = cli.main(["--num_steps", "20", "--num_envs", "4",
                        "--num_eval_steps", "20", "--device", "cpu",
                        "--out_dir", str(tmp_path)])
    names = [name for name, _ in cli.BASELINE_SPECS]
    assert [os.path.basename(p) for p in written] == [
        f"{n}.safetensors" for n in names]
    judge = evaluator.DroneRacerEvaluator(answer_folder_path=str(tmp_path),
                                          device="cpu")
    paths = list(judge.participating_agents.values())
    scores = evaluator.evaluate_checkpoints(paths, episode_seeds=(1, 2),
                                            num_steps=5, device="cpu")
    assert scores["episode_scores"].shape == (2, 5)


def test_create_baselines_default_is_a_run_directory(monkeypatch):
    cli = load_script("torch_create_baselines")
    out = os.path.realpath(cli.default_out_dir())
    assert out.startswith(os.path.join(REPO, "output", "baselines_"))
    assert os.path.realpath(evaluator.BASELINES) != out
    seen = []
    monkeypatch.setattr(cli.train_mod, "train",
                        lambda args: seen.append(args.run_dir) or {})
    with pytest.raises(IndexError):  # no checkpoint: train was stubbed
        cli.main(["--device", "cpu"])
    assert os.path.realpath(seen[0]).startswith(
        os.path.join(REPO, "output", "baselines_"))
