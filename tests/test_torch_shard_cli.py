"""The CLI's ``--use_sharding`` runs as chunks on the CPU.

At world 1 (one process, its own gloo group) ``--max_scan_steps 4``
below ``--num_steps 10`` runs 3 chunks of the trainer's ``train.Chunk``
(eager rows: no graph on the CPU), and the run's train state equals 12
eager ticks of the same rank's tick bitwise. At world 2 (two ranks over
gloo, ``parallel.launch.spawn``, each calling ``train.main``) 4 ticks, a
save and a resume of 8 more in chunks of 4 equal the 12-tick run's train
state on each rank bitwise, its metadata included.
"""

import os

import pytest
import torch

from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.agents.dqn import DQN
from dronerl_tpu_torch.interop import safetensors_io, train_state_io
from dronerl_tpu_torch.parallel import launch, mesh as mesh_mod

FLAGS = ["--device", "cpu", "--use_sharding", "--batch_size", "4",
         "--epsilon_decay", "0.99", "--reset_env_every", "5",
         "--skip_final_eval", "--save_train_state", "--max_scan_steps", "4"]
# Envs and memory a rank: the jnp engine (below 128 envs) and the ring
# engine (a ring of 2 env-batches).
CASES = {"jnp": (8, 64), "ring": (128, 256)}


def case_flags(engine, world):
    envs, memory = CASES[engine]
    return ["--num_envs", str(world * envs), "--memory_size",
            str(world * memory)]


@pytest.mark.parametrize("engine", sorted(CASES))
def test_sharded_cli_chunks_equal_the_eager_ticks(engine, tmp_path):
    argv = FLAGS + case_flags(engine, 1) + ["--num_steps", "10",
                                            "--run_dir", str(tmp_path)]
    metrics = train.main(argv)
    assert metrics["engine"] == f"sharded-{engine}"
    assert (metrics["world_size"], metrics["graphs"]) == (1, 0)
    assert metrics["trained_ticks"] > 0
    args = train.parse_args(argv)
    mesh = mesh_mod.make_env_mesh(device="cpu")
    try:
        params = train.env_params_from_args(args)
        agent = DQN(train.agent_config_from_args(args), params, device="cpu")
        trainer, chunk, carry, _ = train._build_sharded(args, agent, params,
                                                        mesh, 4)
        for _ in range(12):
            carry, _ = chunk.tick(carry)
        saved = train_state_io.restore(
            train.train_state_path(str(tmp_path), mesh),
            trainer.init_carry(rng.PRNGKey(5)), shard=(0, 1))
    finally:
        torch.distributed.destroy_process_group()
    got, want = (train_state_io.leaves(c) for c in (saved, carry))
    assert got[1] == want[1] and want[1]["5"] == 12
    assert set(got[0]) == set(want[0])
    for path, t in want[0].items():
        assert torch.equal(got[0][path], t), path


def rank_resumes(root, engine):
    """Rank r of the CLI runs: 12 ticks; 4 ticks and a save; a resume of
    those and 8 ticks more."""
    flags = FLAGS + case_flags(engine, 2)
    engines = []
    for name, steps, extra in (("whole", 12, []), ("first", 4, []),
                               ("resumed", 8, ["--resume_from",
                                               os.path.join(root, "first")])):
        engines.append(train.main(flags + [
            "--num_steps", str(steps), "--run_dir",
            os.path.join(root, name)] + extra)["engine"])
    return torch.distributed.get_rank(), engines


@pytest.mark.parametrize("engine", sorted(CASES))
def test_sharded_cli_resumes_across_chunks_per_rank(engine, tmp_path):
    ranks = launch.spawn(rank_resumes, 2, (str(tmp_path), engine),
                         device="cpu", num_threads=1, timeout=300)
    assert ranks == [(r, [f"sharded-{engine}"] * 3) for r in range(2)]
    for rank in range(2):
        name = train.TRAIN_STATE_RANK_FILE.format(rank=rank)
        want, want_meta = safetensors_io.read(
            os.path.join(tmp_path, "whole", name))
        got, got_meta = safetensors_io.read(
            os.path.join(tmp_path, "resumed", name))
        assert set(want) == set(got) and want_meta == got_meta, rank
        for key in want:
            assert torch.equal(want[key], got[key]), (rank, key)
