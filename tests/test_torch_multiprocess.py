"""The CLI's sharded path in two processes on the CPU.

``python -m dronerl_tpu_torch.train --device cpu --use_sharding
--num_processes 2 --process_id i --coordinator_address 127.0.0.1:<port>``
as two subprocesses (a gloo group; the jnp engine, 8 envs, 20 ticks):
both ranks end with the same params and ε; each rank's train state
(``train_state.rank<r>.safetensors``) holds its rank and the world size,
and 10 ticks, a save, a resume and 10 more equal the 20 ticks bitwise on
each rank; ranks also join by torchrun's environment. ``--in_kernel_td``
with ``--use_sharding``, and a resume at another world size, are refused
with their reasons. ``parallel.launch.spawn`` stops the peers of a rank
that fails. Last, two processes that build the same kernel library at
once run nvcc once (the build directory's lock; nvcc is a stand-in script
here).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from dronerl_tpu_torch import train
from dronerl_tpu_torch.interop import safetensors_io
from dronerl_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--device", "cpu", "--use_sharding", "--num_envs", "8",
         "--batch_size", "4", "--memory_size", "64", "--epsilon_decay",
         "0.99", "--skip_final_eval", "--save_train_state"]


def run_two_ranks(tmp_path, flags, timeout=240, torchrun=False):
    """The CLI as ranks 0 and 1 of one group, joined by the three flags or
    (``torchrun``) by torchrun's environment variables; fails (killing the
    peer) when either fails or overruns."""
    port = launch.free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def rank(i):
        if torchrun:
            return [], dict(env, RANK=str(i), LOCAL_RANK=str(i),
                            WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port))
        return ["--num_processes", "2", "--process_id", str(i),
                "--coordinator_address", f"127.0.0.1:{port}"], env

    procs = []
    for i in range(2):
        extra, rank_env = rank(i)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dronerl_tpu_torch.train", *flags,
             *extra], cwd=str(tmp_path), env=rank_env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
    return outputs


def read_state(run_dir, rank):
    return safetensors_io.read(os.path.join(
        run_dir, train.TRAIN_STATE_RANK_FILE.format(rank=rank)))


def test_two_processes_train_alike_and_resume_bitwise(tmp_path):
    whole, half, resumed = (str(tmp_path / n) for n in ("whole", "half",
                                                        "resumed"))
    outputs = run_two_ranks(tmp_path, FLAGS + ["--num_steps", "20",
                                               "--run_dir", whole])
    assert "Sharded engine: jnp (2 ranks x 4 envs)" in outputs[0]
    states = [read_state(whole, r) for r in range(2)]
    for rank, (_, meta) in enumerate(states):
        assert (meta["rank"], meta["world_size"]) == (str(rank), "2")
        assert json.loads(meta["numbers"])["5"] == 20
    learner = [k for k in states[0][0] if k.startswith("3.")]
    assert "3.params.0" in learner and "3.epsilon" in learner
    for key in learner:
        assert torch.equal(states[0][0][key], states[1][0][key]), key
    assert float(states[0][0]["3.epsilon"]) < 1.0
    assert not torch.equal(states[0][0]["1.ground"], states[1][0]["1.ground"])
    with open(os.path.join(whole, "metrics.json")) as f:
        assert json.load(f)["obs_per_sec"] > 0

    run_two_ranks(tmp_path, FLAGS + ["--num_steps", "10", "--run_dir", half])
    run_two_ranks(tmp_path, FLAGS + ["--num_steps", "10", "--run_dir",
                                     resumed, "--resume_from", half])
    for rank in range(2):
        want, want_meta = read_state(whole, rank)
        got, got_meta = read_state(resumed, rank)
        assert set(want) == set(got)
        for key in want:
            assert torch.equal(want[key], got[key]), (rank, key)
        assert want_meta == got_meta

    # The same train states at another world size: refused.
    try:
        with pytest.raises(ValueError, match="rank 0 of a world of 2; this "
                           "is rank 0 of a world of 1"):
            train.main(FLAGS + ["--num_steps", "2", "--run_dir",
                                str(tmp_path / "one"), "--resume_from",
                                whole])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_torchrun_environment_joins_the_group(tmp_path):
    """Without the three flags the ranks join by torchrun's RANK,
    WORLD_SIZE and MASTER_ADDR / MASTER_PORT."""
    run_dir = str(tmp_path / "env")
    run_two_ranks(tmp_path, FLAGS + ["--num_steps", "4", "--run_dir",
                                     run_dir], torchrun=True)
    (a, meta_a), (b, meta_b) = (read_state(run_dir, r) for r in range(2))
    assert (meta_a["world_size"], meta_b["rank"]) == ("2", "1")
    assert torch.equal(a["3.params.0"], b["3.params.0"])


def fail_on_rank_one():
    """Rank 1 raises; rank 0 waits for it at a barrier it never reaches."""
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank one fails")
    torch.distributed.barrier()


def test_spawn_stops_the_peers_of_a_failed_rank():
    """A rank that raises ends the run: its peer, blocked in a collective,
    is killed, and the caller gets the rank's traceback."""
    with pytest.raises(RuntimeError, match="rank one fails"):
        launch.spawn(fail_on_rank_one, 2, device="cpu", num_threads=1,
                     timeout=120)


def test_in_kernel_td_with_sharding_is_refused():
    with pytest.raises(ValueError, match="no point for the gradient "
                       "all-reduce"):
        train.parse_args(FLAGS + ["--in_kernel_td"])


def test_concurrent_builds_run_nvcc_once(tmp_path):
    """Two processes build one library at once: the second waits on the
    lock and finds it built."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    calls = tmp_path / "calls"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo run >> {calls}
        sleep 2
        while [ "$1" != "-o" ]; do shift; done
        echo lib > "$2"
        """))
    nvcc.chmod(0o755)
    code = textwrap.dedent(f"""\
        from dronerl_tpu_torch.ops import _build
        from dronerl_tpu_torch.env.types import EnvParams
        _build.BUILD_DIR = {str(tmp_path / "build")!r}
        _build.build([_build.env_config(EnvParams())])
        """)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_HOME=str(tmp_path / "cuda"))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert calls.read_text().split() == ["run"]
