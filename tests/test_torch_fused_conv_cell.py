"""The competition's conv agent (dqn-agent-5) on the CLI's own conv path,
the benchmark's ``conv8d16.fused.e65536`` cell, on the CPU: the fused
engine (the actor through the net's module, the env tick's plain version,
the StreamReplay's ATen push, the autograd learner) against the plain
reference fused engine (``portbench/reference/engines/fused.py``); faults
planted in the program's path, each judged not correct; the counters
that ``train.Chunk`` keeps of the work done outside the port's kernels;
and the cell's four per-layer readers on planted device timelines."""

import copy
import functools
import types

import pytest
import torch

from portbench import check, engines, roofline, run, trace
from portbench.engines import fused as fused_adapter
from portbench.metrics import (actor_ms_per_tick, actor_roofline,
                               b4_ms_per_tick, b4_roofline)
from portbench.reference import trainer
from portbench.reference.engines import fused as fused_reference

from dronerl_tpu_torch import replay, train
from dronerl_tpu_torch.agents.dqn import DQN
from dronerl_tpu_torch.env import core as env_core
from dronerl_tpu_torch.ops import fused_tick

WORKLOAD = "conv8d16.fused.e65536"
TRAINED = 3


def _cell(num_envs: int, **flags):
    """The cell with its envs cut to ``num_envs`` and a replay of two
    env-batches (the cell's 65,536 envs and 100,000 transitions round up
    to two), chunks of 4 ticks."""
    cell = run.load_cell(WORKLOAD)
    cell.flags.update(num_envs=num_envs, memory_size=2 * num_envs - 1,
                      **flags)
    cell.traffic.update(chunk_ticks=4)
    cell.warmup_chunks = cell.host_chunks = cell.trace_chunks = 1
    return cell


def _fused(cell, seed: int):
    """The CLI's fused engine for the cell on the CPU (``run.build`` with
    the engine named: below 128 envs the CLI would pick the jnp engine):
    ``(chunk, carry)``."""
    args = train.parse_args(run.cli_argv(cell.flags) + [
        "--seed", str(run.cli_seed(seed)), "--device", "cpu",
        "--skip_final_eval"])
    env_params = train.env_params_from_args(args)
    agent = DQN(train.agent_config_from_args(args), env_params, device="cpu")
    return train._build_engine(args, agent, env_params, "fused",
                               *train.engine_rng_rounds(args, "fused"))


def test_the_cell_takes_the_fused_engine():
    """At the cell's own flags the CLI sends the conv net (no
    ``--conv_matmul``: the configuration leaves it off, and the traffic
    turns it off for any conv configuration) to the fused engine, whose
    actor runs outside the tick kernels."""
    cell = run.load_cell(WORKLOAD)
    assert cell.config["flags"]["conv_matmul"] is False
    assert cell.traffic["flags"]["conv_matmul"] is False
    assert cell.flags["conv_matmul"] is False
    assert "--conv_matmul" not in run.cli_argv(cell.flags)
    args = train.parse_args(run.cli_argv(cell.flags) + ["--device", "cpu"])
    env_params = train.env_params_from_args(args)
    assert train.choose_engine(args, env_params,
                               train.agent_config_from_args(args)) == "fused"
    assert cell.traffic["engine"] == "fused"


@pytest.mark.parametrize("seed", [5, 2**31 + 977])
def test_reference_actor_is_act_t(seed):
    """The reference's epsilon-greedy actor draws as ``DQN.act_t``: the
    same explore and action draws from one key, and the same greedy
    actions where the reference sees no near tie."""
    cell = _cell(64)
    _, carry = _fused(cell, seed)
    flags = cell.flags
    learner = trainer.Learner.from_snapshot(
        engines.snapshot(carry, carry[1], {})["learner"], flags, "cpu",
        trainer.Variant())
    args = train.parse_args(run.cli_argv(flags) + ["--device", "cpu"])
    agent = DQN(train.agent_config_from_args(args),
                train.env_params_from_args(args), device="cpu")
    key = fused_reference.threefry.prng_key(run.cli_seed(seed) ^ 0x5A5A)
    obs_t = carry[2]
    for epsilon in (0.0, 0.5, 1.0):
        learner.epsilon = torch.tensor(epsilon)
        state = copy.copy(carry[3])
        state.epsilon = torch.tensor(epsilon)
        got = agent.act_t(key, obs_t, state)
        with trainer.exact_f32():
            want, ties = fused_reference.act(key, obs_t, learner)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got[~ties], want[~ties]), epsilon


@pytest.mark.parametrize("num_envs,seed,epsilon_start,reset_every", [
    (16, 3, 1.0, 3), (64, 2**31 + 41, 0.05, 2)],
    ids=["e16-explore", "e64-greedy"])
def test_fused_engine_matches_the_reference(num_envs, seed, epsilon_start,
                                            reset_every):
    """The program's fused engine, driven one tick a call, against the
    reference from the seed (the start: ticks 0.. through the resets until
    3 have trained), then after a chunk against the reference resumed from
    a snapshot of the program (the late run): the env's answers agree
    exactly, and the losses, the first gradient, the update and epsilon
    within the cell's limits."""
    cell = _cell(num_envs, epsilon_start=epsilon_start,
                 reset_env_every=reset_every)
    chunk, carry = _fused(cell, seed)
    carry, start = run.check_ticks(chunk, carry, fused_adapter, num_envs,
                                   TRAINED)
    assert len(start["ticks"]) > reset_every   # a reset after tick 0 too
    carry, _ = chunk(carry, 5)
    snap = fused_adapter.snapshot(carry)
    carry, late = run.check_ticks(chunk, carry, fused_adapter, num_envs,
                                  TRAINED)
    numbers = check.compare_runs({"start": start, "late": late},
                                 run.references(cell, seed, snap, "cpu"))
    assert numbers["start_env_diff"] == numbers["late_env_diff"] == 0.0
    correct, checks = check.judge(numbers, cell.limits)
    assert correct, checks


def _env_state_unchanged(monkeypatch):
    real = fused_tick.tick_fused

    @functools.wraps(real)
    def still(step_key, tstate, *args, **kwargs):
        return (tstate, *real(step_key, tstate, *args, **kwargs)[1:])

    monkeypatch.setattr(fused_tick, "tick_fused", still)


def _push_rewards_altered(monkeypatch):
    real = replay.stream_push_batch

    def altered(*args, **kwargs):
        batch = real(*args, **kwargs)
        return {**batch, "rewards": batch["rewards"] + 1.0}

    monkeypatch.setattr(replay, "stream_push_batch", altered)


def _half_batch(monkeypatch):
    real = train.learner_step

    def half(agent, route, ag_state, batch, row, layout, group=None,
             row_major=False):
        n = batch["actions"].shape[0] // 2
        batch = {k: v[..., :n] for k, v in batch.items()}
        return real(agent, route, ag_state, batch, row, layout, group,
                    row_major)

    monkeypatch.setattr(train, "learner_step", half)


def _schedules_skipped(monkeypatch):
    monkeypatch.setattr(DQN, "apply_schedules",
                        lambda self, state, step, done, flags=None: state)


def _opponents_from_the_actors_key(monkeypatch):
    real = train.RowLayout.keys

    def keys(self, row):
        rand_key, act_key, *rest = real(self, row)
        return (act_key, act_key, *rest)

    monkeypatch.setattr(train.RowLayout, "keys", keys)


@pytest.mark.parametrize("fault", [
    _env_state_unchanged, _push_rewards_altered, _half_batch,
    _schedules_skipped, _opponents_from_the_actors_key],
    ids=["env_state_unchanged", "push_rewards_altered", "half_batch",
         "schedules_skipped", "opponents_from_the_actors_key"])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    """A whole run of the cell cut to 128 envs (the CLI's fused engine,
    chosen by ``choose_engine``) with the fault planted in the program:
    ``correct`` is false. The sound program holds (the first case)."""
    cell = _cell(128)
    fault(monkeypatch)
    out = run.run_cell(WORKLOAD, 2**31 + 41, 0.1, False, "cpu", cell)
    assert out["correct"] is False, out["checks"]


def test_sound_run_is_correct():
    cell = _cell(128)
    out = run.run_cell(WORKLOAD, 2**31 + 41, 0.1, False, "cpu", cell)
    assert out["correct"] is True, out["checks"]


COUNTED = {"module_forwards": (DQN.act_t, "module_forwards"),
           "pushes": (replay.StreamReplay.push_many, "calls"),
           "autograd_steps": (DQN._td_step, "calls"),
           "resets": (env_core.reset_batch, "calls")}


def _counts():
    return {name: getattr(fn, count) for name, (fn, count) in
            COUNTED.items()}


@pytest.mark.parametrize("reset_every", [5, 100])
def test_chunk_counts_the_work_outside_the_kernels(reset_every):
    """Every tick of the fused engine's chunk runs the conv actor through
    its module once and the ATen push once; every trained tick one
    autograd step; and the plain reset once every ``reset_env_every``
    ticks (tick 0 among them). Each counter is one of ``Chunk.COUNTERS``,
    which a graphed chunk tallies once a chunk."""
    owners = {(getattr(owner, name), count)
              for owner, name, count in train.Chunk.COUNTERS}
    assert set(COUNTED.values()) <= owners
    cell = _cell(16, reset_env_every=reset_every)
    chunk, carry = _fused(cell, 9)
    length = 12
    trained = 0
    before = _counts()
    for _ in range(length):
        carry, (_, _, loss) = chunk(carry, 1)
        trained += int(float(loss[0]) >= 0)
    got = {name: n - before[name] for name, n in _counts().items()}
    assert trained == length - 1        # two env-batches: tick 0 fills one
    assert got == {"module_forwards": length, "pushes": length,
                   "autograd_steps": trained,
                   "resets": len(range(0, length, reset_every))}


def _op(name, start, length):
    return trace.Op(name, float(start), float(start + length))


ROW, DRAW, B4 = ("Memcpy DtoD (Device -> Device)", "void dronerl::draw_kernel",
                 "void dronerl::env_kernel<true>(dronerl::EnvArgs)")
# One tick on the card's timeline (us): the row copy, the opponents'
# draw, the actor (layout copy, conv, ReLU, GEMM, argmax), its epsilon
# draws and select, B4, then the push, the sample and the learner.
TICK = [(ROW, 2), (DRAW, 5), ("elementwise_kernel copy", 40),
        ("cudnn::conv2d_grouped_direct_kernel", 150), ("relu", 30),
        ("sm80_xmma_gemm_f32f32", 60), ("reduce_kernel argmax", 20),
        (DRAW, 5), (DRAW, 5), ("where", 5), (B4, 155),
        ("index_copy_kernel", 90), ("ring_sample_kernel", 8),
        ("sm80_xmma_gemm_f32f32", 10), ("multi_tensor_apply_kernel", 12)]
ACTOR_US = 40 + 150 + 30 + 60 + 20 + 5


def _ctx(engine="fused", ticks=3, tick=TICK):
    cell = run.load_cell(WORKLOAD)
    dev, t = [], 0.0
    for _ in range(ticks):
        for name, us in tick:
            dev.append(_op(name, t, us))
            t += us + 1
    f = cell.flags
    return types.SimpleNamespace(
        engine=engine, num_envs=f["num_envs"], batch=f["batch_size"],
        net=roofline.net_of(f), n_drones=f["n_drones"],
        cells=f["grid_size"] ** 2, ticks=ticks, dev=dev, window_s=t / 1e6)


@pytest.mark.parametrize("reader,want", [
    (b4_ms_per_tick, 0.155), (actor_ms_per_tick, ACTOR_US / 1e3),
    (b4_roofline, 0.02891409194 / 0.155 * 100),
    (actor_roofline, 0.02309245731 / (ACTOR_US / 1e3) * 100)],
    ids=["b4_ms_per_tick", "actor_ms_per_tick", "b4_roofline",
         "actor_roofline"])
def test_reader_on_a_planted_timeline(reader, want):
    """Each reader on three planted ticks of the fused engine; each reads
    nothing on another engine's timeline or where B4 never ran."""
    assert reader.read(_ctx()) == pytest.approx(want, rel=1e-9)
    for engine in ("ring", "full", "jnp"):
        assert reader.read(_ctx(engine)) is None
    assert reader.read(_ctx(tick=[op for op in TICK if op[0] != B4])) is None


def test_readers_bounds_and_tick_boundaries():
    """The bounds are the kernel table's B4 bound (0.0289 ms, bytes) and
    the actor's bytes (0.0231 ms, above its 0.0189 ms of products); a
    tick's actor starts at its row copy, so the previous tick's push and
    learner never count, and the first tick of a window, cut before its
    row copy, counts from the window's start."""
    ctx = _ctx()
    assert b4_roofline.bound_ms(ctx) == pytest.approx(0.0289, abs=5e-5)
    assert actor_roofline.bound_ms(ctx) == pytest.approx(0.0231, abs=5e-5)
    assert roofline.actor_seconds(ctx.net, "f32", ctx.num_envs) * 1e3 < (
        actor_roofline.bound_ms(ctx))
    ops = actor_ms_per_tick.actor_ops(ctx.dev)
    assert len(ops) == 3 * 6
    assert not any(name in op.name for op in ops
                   for name in (ROW, DRAW, B4, "index_copy", "ring_sample",
                                "multi_tensor"))
    cut = ctx.dev[1:]          # the window opens after the first row copy
    assert len(actor_ms_per_tick.actor_ops(cut)) == 3 * 6
