"""Training throughput of the PyTorch/CUDA port, in obs/s: the port's
counterpart of the top-level ``bench.py`` and of ``scripts/_timing.py``.

The workload is ``bench.py``'s (``:98-126``): grid 9, 4 drones, window
radius 3, the dense (16,16) and (128,64) nets, ε decay every 5 ticks,
target sync every 10, γ 0.9, 65,536 envs, replay batch 8, a reset every
100 ticks and a bf16 ring of ``max(ceil(100000 / E) · E, 2 E)`` columns.
Each metric times the ring engine's chunk (``train.build_chunk_ring`` /
``init_ring_carry``), the program ``bench.py`` times (``jax.jit(lax.scan(
tick))``): on the card one CUDA graph replay a tick, which runs the tick
kernel (B1) and the learner kernel (B2) after it: on the default metrics
on the batch gathered in the same tick (``train.kernel_train_step``, the
learner XLA fuses around ``bench.py``'s kernels), on the
``_in_kernel_td`` ones on the batch of the tick before. obs/s = num_envs
× ticks / wall time, the metric of ``bench.py``.

The protocol is ``scripts/_timing.py``'s: the kernels are built in one
nvcc wave and loaded before any timing (``build_s``, where ``bench.py``
reports ``compile_s``); ``WARMUP_CALLS`` runs of ``TIMED_STEPS`` ticks
(``warmup_s``, which holds the CUDA graphs' captures: ``graphs``
signatures in ``capture_s``); then each repeat chains ``CALLS_PER_REPEAT``
runs through the carry and ends with a synchronise and a scalar readback,
and the median over repeats is the value. Tracing is off while it
times.

``correct`` is decided here. (a) Before timing, ``CHECK_TICKS`` eager
ticks of each program (tick 0 resets, later ticks train) hold every
launch of B1
against its plain version on the same inputs (``full_tick_ring_plain``):
env state, rewards, dones and the ring bitwise but the charge channel
(within ``CHARGE_ATOL``), actions equal outside near ties of the plain
Q-values; every step of the learner kernel (on the default path and on
``in_kernel_td``), its loss and params against the autograd learner
(``DQN.train_step_t``) on the same batch and state, within rtol 1e-5,
atol 1e-6 outside cancellations. (a') From one carry,
``max(CHECK_TICKS, 2 nb)`` ticks of the chunk (graphed on the card)
against as many eager ticks: every carry tensor and every output
bitwise, the learner included, as both run the same kernels in the same
order. (b) After timing: the
step counter equals the ticks run, B1 launched once a timed tick and B2
once a trained one (every tick on ``in_kernel_td``; no launch on the
CPU, where the wrappers run the plain versions and the default learner
is autograd), the Adam count the trained ticks, every loss finite and >=
0 on the ticks that train, ε decayed and the params moved. A failed
check prints the line with ``correct: false`` and exits 1.

``per_layer`` comes from a separate chunk of ``TRACE_TICKS`` ticks a
metric: the host ms a tick (the table at the chunk's entry, then a copy
and a graph replay a tick, before the host waits for the card), then the
same chunk under ``torch.profiler``: the device's busy share of the
untraced tick, device ms a tick by kernel (B1, B2, the rest) and
launches a tick. On the CPU every device field is null: not measured.
The eager tick's split by phase is ``scripts/torch_tick_profile.py``'s.

Environment variables, as ``bench.py``'s: ``DRONERL_BENCH_ENVS``,
``_STEPS``, ``_CALLS``, ``_REPEATS`` (the (16,16) metrics),
``_REPEATS_BIG`` (the (128,64) ones), ``_SECOND_NET`` (0: the first net
alone). One JSON line on stdout, the stages on stderr.

Run on the card:  python -m dronerl_tpu_torch.bench
On the CPU:       DRONERL_BENCH_ENVS=128 DRONERL_BENCH_STEPS=3 \\
                  DRONERL_BENCH_CALLS=1 DRONERL_BENCH_REPEATS=2 \\
                  python -m dronerl_tpu_torch.bench --device cpu
"""

import argparse
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, List, NamedTuple, Optional

import torch

from dronerl_tpu_torch import resolve_device, rng, train
from dronerl_tpu_torch.agents.dqn import AdamState, DQN, DQNConfig, DQNState
from dronerl_tpu_torch.benchmark import device_line
from dronerl_tpu_torch.constants import NO_TRAIN_LOSS, NUM_ACTIONS
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import train_state_io
from dronerl_tpu_torch.ops import _build, fused_tick, learner_kernel
from dronerl_tpu_torch.ops.fused_tick import full_tick_ring_plain
from dronerl_tpu_torch.utils import profiling

_T0 = time.perf_counter()

NETS = {
    "dense16": (16, 16),
    "dense128x64": (128, 64),
}
NUM_ENVS = 65536
TIMED_STEPS = 200
CALLS_PER_REPEAT = 4
REPEATS = 10
REPEATS_BIG = 6
WARMUP_CALLS = 2
MEMORY_SIZE = 100_000
BATCH_SIZE = 8
RESET_EVERY = 100
CHECK_TICKS = 4
TRACE_TICKS = 20
CHARGE_ATOL = 1.3e-7     # one ULP of charge / 100
NEAR_TIE = 1e-5          # of max |q|
LEARNER_RTOL, LEARNER_ATOL = 1e-5, 1e-6


def _stage(msg: str) -> None:
    # Stage progress on stderr (stdout stays one JSON line).
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Settings:
    """The sizes ``bench.py`` reads from its environment variables."""

    num_envs: int = NUM_ENVS
    steps: int = TIMED_STEPS
    calls: int = CALLS_PER_REPEAT
    repeats: int = REPEATS
    repeats_big: int = REPEATS_BIG
    second_net: bool = True

    @classmethod
    def from_environ(cls, environ=None) -> "Settings":
        environ = os.environ if environ is None else environ

        def get(name, default):
            return int(environ.get("DRONERL_BENCH_" + name, default))

        return cls(get("ENVS", NUM_ENVS), get("STEPS", TIMED_STEPS),
                   get("CALLS", CALLS_PER_REPEAT), get("REPEATS", REPEATS),
                   get("REPEATS_BIG", REPEATS_BIG),
                   environ.get("DRONERL_BENCH_SECOND_NET", "1") != "0")


def capacity(num_envs: int) -> int:
    """Ring columns: ``MEMORY_SIZE`` rounded up to whole env-batches (the
    pushes stay contiguous), at least two."""
    return max(-(-MEMORY_SIZE // num_envs) * num_envs, 2 * num_envs)


def metric_name(net: str, num_envs: int, in_kernel_td: bool) -> str:
    return (f"train_obs_per_sec_{net}_{num_envs}envs"
            + ("_in_kernel_td" if in_kernel_td else ""))


class Program(NamedTuple):
    """A ring-engine program: its chunk (``train.Chunk``), its eager
    tick (``chunk.tick``), ``run`` (``steps`` ticks, one chunk: the
    counterpart of ``jax.lax.scan`` over the tick) and ``make_carry``."""

    agent: DQN
    env_params: EnvParams
    num_envs: int
    capacity: int
    batch_size: int
    collect_drones: int
    in_kernel_td: bool
    steps: int
    chunk: Callable
    tick: Callable
    run: Callable
    make_carry: Callable


def ring_program(agent: DQN, env_params: EnvParams, num_envs: int, *,
                 batch_size: int = BATCH_SIZE, collect_drones: int = 1,
                 in_kernel_td: bool = False, seed: int = 0,
                 steps: int = TIMED_STEPS) -> Program:
    """The ring engine's chunk for ``agent`` with a bf16 ring of
    :func:`capacity` columns (each ``collect_drones`` transitions), envs
    and nets drawn from ``seed``."""
    cap = capacity(num_envs)
    chunk = train.build_chunk_ring(
        agent, env_params, num_envs, cap, batch_size, RESET_EVERY,
        collect_drones, in_kernel_td=in_kernel_td)

    def make_carry():
        return train.init_ring_carry(
            agent, env_params, num_envs, cap, rng.PRNGKey(seed),
            obs_dtype=torch.bfloat16, batch_size=batch_size,
            in_kernel_td=in_kernel_td, collect_drones=collect_drones)

    def run(carry):
        """``steps`` ticks: ``(carry, (rewards (steps, E), epsilon
        (steps,), loss (steps,)))``."""
        return chunk(carry, steps)

    return Program(agent, env_params, num_envs, cap, batch_size,
                   collect_drones, bool(in_kernel_td), steps, chunk,
                   chunk.tick, run, make_carry)


def kernel_learner(prog: Program) -> bool:
    """Whether ``prog``'s tick trains with the learner kernel (its default
    route on a card, or ``in_kernel_td``)."""
    return prog.tick.learner in (train.KERNEL, train.IN_KERNEL_TD)


def build(net: str, num_envs: int, *, in_kernel_td: bool = False,
          device="cuda", seed: int = 0, steps: int = TIMED_STEPS) -> Program:
    """``bench.py``'s program for ``net`` (``:98-126``), on ``device``."""
    env_params = EnvParams(grid_size=9, n_drones=4, window_radius=3)
    config = DQNConfig(
        network_type="dense", hidden_layers=NETS[net],
        epsilon_decay_every=5, target_update_interval=10, gamma=0.9)
    agent = DQN(config, env_params, device=resolve_device(device))
    return ring_program(agent, env_params, num_envs,
                        in_kernel_td=in_kernel_td, seed=seed, steps=steps)


# --- the timing protocol (scripts/_timing.py) --------------------------------

def _readback(rewards: torch.Tensor) -> float:
    """A hard sync: wait for the device, then read a scalar back."""
    profiling.synchronize(rewards.device)
    return float(rewards.sum())


def warm_up(run, carry, calls: int = WARMUP_CALLS):
    """``scripts/_timing.py``'s warm-up: ``calls`` runs and a readback;
    returns ``(carry, seconds)``."""
    t0 = time.perf_counter()
    for _ in range(calls):
        carry, (rewards, *_aux) = run(carry)
    _readback(rewards)
    return carry, time.perf_counter() - t0


class Timing(NamedTuple):
    median_s: float
    repeat_s: List[float]
    carry: object
    aux: list  # every timed run's outputs but its rewards


def timed_median(run, carry, repeats: int, calls: int) -> Timing:
    """``scripts/_timing.py``'s ``timed_median`` after its warm-up
    (:func:`warm_up`): each repeat chains ``calls`` runs through the carry
    (``run(carry) -> (carry, (rewards, *aux))``) and ends with a
    synchronise and a scalar readback; the median over repeats."""
    times, aux = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            carry, (rewards, *rest) = run(carry)
            aux.append(rest)
        _readback(rewards)
        times.append(time.perf_counter() - t0)
    return Timing(statistics.median(times), times, carry, aux)


def quartiles(times: List[float]):
    """(q1, q3) of the repeat times (inclusive method)."""
    if len(times) < 2:
        return times[0], times[0]
    q1, _, q3 = statistics.quantiles(times, n=4, method="inclusive")
    return q1, q3


def append_row(path: str, row: dict) -> None:
    """Append one result row to a JSON list file, saving at once: a
    failure later in a sweep keeps the earlier rows."""
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    with open(path, "w") as f:
        json.dump(existing + [row], f, indent=1)


# --- the card -----------------------------------------------------------------

def device_info(device: torch.device) -> dict:
    """Platform, name, count and power limit of the device measured."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "power_limit_w": None}
    line = device_line(device)  # "<name>, <limit> W" from nvidia-smi
    try:
        limit = float(line.rsplit(",", 1)[1].split()[0])
    except (IndexError, ValueError):
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "power_limit_w": limit,
            "nvidia_smi": line}


def clocks(device: torch.device) -> Optional[dict]:
    """The card's SM clock, power draw and temperature now (None on the
    CPU, or where nvidia-smi does not answer)."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
             "temperature.gpu", "--format=csv,noheader,nounits",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    fields = [v.strip() for v in out.stdout.strip().split(",")]
    return dict(zip(("clocks_sm_mhz", "power_draw_w", "temperature_c"),
                    fields))


def build_kernels(programs: List[Program], device: torch.device):
    """Build every program's kernel libraries in one nvcc wave (B1 a net,
    B2 where its tick trains with the learner kernel); returns
    ``({program index: seconds of its libraries' builds, the longest},
    the wave's wall seconds)`` (None on the CPU: nothing to build).
    Libraries already built cost 0."""
    if device.type != "cuda":
        return {i: None for i in range(len(programs))}, None
    configs = []
    for prog in programs:
        widths = (fused_tick.obs_rows(prog.env_params),
                  *prog.agent.config.hidden_layers, NUM_ACTIONS)
        configs.append([_build.tick_config(prog.env_params, widths,
                                           prog.collect_drones)]
                       + ([_build.learner_config(widths)]
                          if kernel_learner(prog) else []))
    t0 = time.perf_counter()
    built = _build.build([c for cs in configs for c in cs])
    wall = time.perf_counter() - t0
    per = {i: max(built.get(_build.library_path(c), 0.0) for c in cs)
           for i, cs in enumerate(configs)}
    return per, wall


def launch_counts() -> dict:
    return {"full_tick_ring": fused_tick.full_tick_fused_ring.launches,
            "td_adam": learner_kernel.td_adam.launches}


def zero_launch_counts() -> None:
    fused_tick.full_tick_fused_ring.launches = 0
    learner_kernel.td_adam.launches = 0


# --- correctness --------------------------------------------------------------

def _env_problems(tag, out, plain, ring, ring_plain, write_slot, num_envs):
    """The env side of one tick against the plain version: state, rewards
    and dones bitwise; the ring bitwise but the charge channel of the
    written columns. Returns (problems, the charge channel's error)."""
    problems = []
    for name, a, b in zip(fused_tick.TState._fields, out[0], plain[0]):
        if not torch.equal(a, b):
            problems.append(f"{tag}: state {name} differs")
    for name, i in (("rewards", 1), ("dones", 2)):
        if not torch.equal(out[i], plain[i]):
            problems.append(f"{tag}: {name} differ")
    cols = slice(write_slot, write_slot + num_envs)
    rest = torch.ones(ring.shape[1], dtype=torch.bool, device=ring.device)
    rest[cols] = False
    if not torch.equal(ring[:, rest], ring_plain[:, rest]):
        problems.append(f"{tag}: ring columns outside the written slot "
                        "differ")
    obs_k = ring[:, cols].float().reshape(-1, 6, num_envs)
    obs_p = ring_plain[:, cols].float().reshape(-1, 6, num_envs)
    channel = torch.arange(6, device=ring.device) != 4
    if not torch.equal(obs_k[:, channel], obs_p[:, channel]):
        problems.append(f"{tag}: observation channels differ")
    charge = float((obs_k[:, 4] - obs_p[:, 4]).abs().max())
    if charge > CHARGE_ATOL:
        problems.append(f"{tag}: charge channel off by {charge}")
    return problems, charge


def _action_problems(tag, actions, step_key, ring, read_slot, chain, epsilon,
                     params, num_envs, rounds, actor_rounds):
    """The kernel's actions against the plain actor's outside near ties
    of the plain Q-values; returns (problems, near-tie envs)."""
    keys = rng.split_plain(step_key.to(ring.device), num_envs + 2, rounds)
    act_p, q = fused_tick.plain_actions(keys[num_envs], ring, read_slot,
                                        chain, epsilon, params, num_envs,
                                        actor_rounds)
    top2 = q.topk(2, dim=0).values
    tie = (top2[0] - top2[1]) <= NEAR_TIE * q.abs().amax(dim=0)
    bad = int(((actions != act_p).any(dim=0) & ~tie).sum())
    problems = ([f"{tag}: {bad} actions differ outside near ties"]
                if bad else [])
    return problems, int(tie.sum())


def _learner_problems(tag, agent, ref: DQNState, batch, params, loss,
                      stats) -> List[str]:
    """The learner kernel's step (``params`` updated in place, ``loss``)
    against the autograd learner's from the same state ``ref`` on the
    same batch: loss within rtol, params within rtol and atol except
    where the gradient is a cancellation."""
    _, grads, scales = learner_kernel.td_gradients(
        batch, ref.params, ref.target_params, agent.config.gamma,
        with_scales=True)
    cancelled = learner_kernel.cancellations(grads, scales)
    ref, ref_loss = agent.train_step_t(ref, batch)
    problems = []
    lk, lp = float(loss), float(ref_loss)
    stats["loss_max_err"] = max(stats["loss_max_err"], abs(lk - lp))
    if not abs(lk - lp) <= LEARNER_RTOL * abs(lp):
        problems.append(f"{tag}: loss {lk} vs the autograd learner's {lp}")
    for i, (k, p, c) in enumerate(zip(params.flat(), ref.params.flat(),
                                      cancelled)):
        diff = (k.detach() - p.detach()).abs()
        bad = diff > LEARNER_ATOL + LEARNER_RTOL * p.detach().abs()
        if bool((bad & ~c).any()):
            problems.append(f"{tag}: param {i}: {int((bad & ~c).sum())} "
                            f"elements beyond rtol {LEARNER_RTOL}, atol "
                            f"{LEARNER_ATOL} (max {float(diff.max())})")
        stats["params_max_err"] = max(stats["params_max_err"],
                                      float(diff.max()))
        stats["cancellations_beyond_tolerance"] += int((bad & c).sum())
    return problems


def check_against_plain(prog: Program, ticks: int = CHECK_TICKS) -> dict:
    """Correctness (a): ``ticks`` ticks of ``prog`` from a fresh carry,
    every launch of the tick kernel held against its plain version on the
    same inputs and every step of the learner kernel against the autograd
    learner (``in_kernel_td``'s inside the tick kernel's wrapper, the
    default path's ``train.kernel_train_step``). Returns the tallies and
    ``problems`` (empty when everything held)."""
    agent, kernel = prog.agent, fused_tick.full_tick_fused_ring
    stats = {"ticks": 0, "reset_ticks": 0, "trained_ticks": 0,
             "charge_max_err": 0.0, "near_tie_envs": 0, "loss_max_err": 0.0,
             "params_max_err": 0.0, "cancellations_beyond_tolerance": 0,
             "problems": []}

    def checked(step_key, tstate, ring, read_slot, write_slot, chain,
                epsilon, do_reset, params, collect=1, rng_rounds=20,
                actor_rng_rounds=None, **td):
        tag = f"check tick {stats['ticks']}"
        tstate_in = fused_tick.TState(*(t.clone() for t in tstate))
        ring_plain = ring.clone()
        chain_in = [c.detach().clone() for c in chain]
        ref = None
        if td.get("td_hparams") is not None and td["td_aux"][4]:
            net, target, mu, nu, _, count = td["td_aux"]
            ref = DQNState(copy.deepcopy(net), copy.deepcopy(target),
                           AdamState(int(count), [m.clone() for m in mu],
                                     [v.clone() for v in nu]),
                           epsilon.clone())
            batch = {k: v.clone() for k, v in td["td_batch"].items()}
        out = kernel(step_key, tstate, ring, read_slot, write_slot, chain,
                     epsilon, do_reset, params, collect, rng_rounds=rng_rounds,
                     actor_rng_rounds=actor_rng_rounds, **td)
        plain = full_tick_ring_plain(
            step_key, tstate_in, ring_plain, read_slot, write_slot, chain_in,
            epsilon, do_reset, params, actions_override=out[3],
            collect=collect, rng_rounds=rng_rounds,
            actor_rng_rounds=actor_rng_rounds)
        problems, charge = _env_problems(tag, out, plain, ring, ring_plain,
                                         write_slot, prog.num_envs)
        more, ties = _action_problems(
            tag, out[3], step_key, ring_plain, read_slot, chain_in, epsilon,
            params, prog.num_envs, rng_rounds,
            fused_tick.actor_rounds(rng_rounds, actor_rng_rounds))
        problems += more
        if ref is not None:
            problems += _learner_problems(tag, agent, ref, batch, out[5],
                                          out[8], stats)
            stats["trained_ticks"] += 1
        stats["problems"] += problems
        stats["charge_max_err"] = max(stats["charge_max_err"], charge)
        stats["near_tie_envs"] += ties
        stats["ticks"] += 1
        stats["reset_ticks"] += bool(do_reset)
        return out

    kernel_step = train.kernel_train_step

    def checked_step(agent_, state, batch, count):
        ref = DQNState(copy.deepcopy(state.params),
                       copy.deepcopy(state.target_params),
                       AdamState(int(count),
                                 [m.clone() for m in state.opt_state.mu],
                                 [v.clone() for v in state.opt_state.nu]),
                       state.epsilon.clone())
        before = {k: v.clone() for k, v in batch.items()}
        state, loss = kernel_step(agent_, state, batch, count)
        stats["problems"] += _learner_problems(
            f"check tick {stats['ticks'] - 1} learner", agent, ref, before,
            state.params, loss, stats)
        stats["trained_ticks"] += 1
        return state, loss

    carry = prog.make_carry()
    losses = []
    with profiling.replaced(fused_tick, "full_tick_fused_ring", checked), \
            profiling.replaced(train, "kernel_train_step", checked_step):
        for _ in range(ticks):
            carry, (_, _, loss) = prog.tick(carry)
            losses.append(float(loss))
    trained = sum(loss >= 0 for loss in losses)
    if not kernel_learner(prog):
        stats["trained_ticks"] = trained
    elif not prog.in_kernel_td and stats["trained_ticks"] != trained:
        stats["problems"].append(
            f"{stats['trained_ticks']} learner kernel steps checked in "
            f"{trained} trained ticks")
    if stats["reset_ticks"] < 1 or stats["trained_ticks"] < 1:
        stats["problems"].append(
            f"the check ran {stats['reset_ticks']} reset ticks and "
            f"{stats['trained_ticks']} trained ticks (at least one each)")
    return stats


def check_lockstep(prog: Program, ticks: Optional[int] = None) -> dict:
    """Correctness (a'): ``ticks`` (at least ``CHECK_TICKS`` and two
    passes of the ring) ticks of a chunk of ``prog``'s (graphed on the
    card; a chunk of its own, so that the timed chunk adopts the timed
    carry) against as many eager ticks from the same carry: every carry
    tensor, the carry's numbers and every output bitwise. Returns the
    tallies and ``problems``."""
    nb = prog.capacity // prog.num_envs
    ticks = ticks or max(CHECK_TICKS, 2 * nb)
    chunk = train.Chunk(prog.tick)
    carry = prog.make_carry()
    eager = copy.deepcopy(carry)
    carry, outs = chunk(carry, ticks)
    ref = []
    for _ in range(ticks):
        eager, out = prog.tick(eager)
        ref.append(out)
    got, want = (train_state_io.leaves(c) for c in (carry, eager))
    problems = []
    if got[1] != want[1]:
        problems.append(f"lockstep: the carry's numbers {got[1]} != the "
                        f"eager ticks' {want[1]}")
    for path, t in want[0].items():
        if path not in got[0] or not torch.equal(got[0][path], t):
            problems.append(f"lockstep: carry tensor {path} differs")
    for i, name in enumerate(("rewards", "epsilon", "loss")):
        if not torch.equal(outs[i], torch.stack([o[i] for o in ref])):
            problems.append(f"lockstep: the {name} differ")
    return {"ticks": ticks, "graphs": chunk.graphs,
            "tensors": len(want[0]), "problems": problems}


def trains(prog: Program, step: int) -> bool:
    """Whether the tick at ``step`` takes a learner step (its signature's;
    on ``in_kernel_td`` on the batch of the tick before, in a launch of
    every tick)."""
    return prog.tick.signature(step).trains


def check_timed(prog: Program, carry, first_step: int, ticks: int, aux,
                launches: dict, params0, epsilon0: float,
                on_card: bool) -> dict:
    """Correctness (b): the timed run of ``ticks`` ticks from step
    ``first_step`` (``aux``: each run's (epsilon, loss))."""
    losses = torch.cat([loss for _, loss in aux]).cpu()
    steps = range(first_step, first_step + ticks)
    trained = torch.tensor([trains(prog, s) for s in steps])
    learner = ticks if prog.in_kernel_td else int(trained.sum())
    expect = {"full_tick_ring": ticks if on_card else 0,
              "td_adam": learner if on_card and kernel_learner(prog) else 0}
    problems = []
    if carry[-1] != first_step + ticks:
        problems.append(f"step counter {carry[-1]} != "
                        f"{first_step + ticks}")
    if launches != expect:
        problems.append(f"launches {launches} in {ticks} ticks "
                        f"(expected {expect})")
    if not bool(torch.isfinite(losses).all()):
        problems.append("a loss is not finite")
    if bool((losses[trained] < 0).any()):
        problems.append("a tick that trains has a negative loss")
    if not bool((losses[~trained] == NO_TRAIN_LOSS).all()):
        problems.append("a tick that does not train has a loss")
    epsilon = float(carry[3].epsilon)
    if not epsilon < epsilon0:
        problems.append(f"epsilon {epsilon} did not decay from {epsilon0}")
    if all(torch.equal(a, b) for a, b in zip(params0,
                                             carry[3].params.flat())):
        problems.append("the params did not move")
    count = sum(trains(prog, s) for s in range(first_step + ticks))
    if carry[3].opt_state.count != count:
        problems.append(f"Adam count {carry[3].opt_state.count} != "
                        f"{count} trained ticks")
    return {"ticks": ticks, "trained_ticks": int(trained.sum()),
            "epsilon": [epsilon0, epsilon],
            "loss_last": float(losses[-1]), "problems": problems}


# --- the traced per-layer run ---------------------------------------------------

def per_layer(prog: Program, carry, tick_ms: float, device: torch.device):
    """The traced split of a chunk of ``TRACE_TICKS`` ticks: the host ms a
    tick (up to the last replay's launch, before the host waits), then
    device time by kernel under ``torch.profiler`` (null on the CPU).
    Returns ``(carry, split)``."""
    t0 = time.perf_counter()
    carry, (rewards, *_aux) = prog.chunk(carry, TRACE_TICKS)
    host_ms = (time.perf_counter() - t0) / TRACE_TICKS * 1e3
    profiling.synchronize(device)
    chunk_tick_ms = (time.perf_counter() - t0) / TRACE_TICKS * 1e3
    t0 = time.perf_counter()
    carry, prof = profiling.profiled_ticks(
        lambda c: prog.chunk(c, TRACE_TICKS), carry, 1, device)
    profiled_tick_ms = (time.perf_counter() - t0) / TRACE_TICKS * 1e3
    split = {"ticks": TRACE_TICKS, "tick_ms": tick_ms,
             "host_ms_per_tick": host_ms, "chunk_tick_ms": chunk_tick_ms,
             "profiled_tick_ms": profiled_tick_ms,
             "device_busy_share": None, "device_ms": None,
             "device_ms_by_kernel": None, "launches_per_tick": None,
             "top_device_kernels": None}
    if device.type != "cuda":
        return carry, split
    kernels = profiling.device_kernels(prof, TRACE_TICKS)
    device_ms = sum(k[1] for k in kernels)

    def named(part):
        return sum(ms for name, ms, _ in kernels if part in name)

    by_kernel = {"full_tick_ring": named("full_tick_kernel"),
                 "td_adam": named("td_adam_kernel")}
    by_kernel["other"] = device_ms - sum(by_kernel.values())
    split.update(
        device_busy_share=device_ms / tick_ms, device_ms=device_ms,
        device_ms_by_kernel=by_kernel,
        launches_per_tick=sum(k[2] for k in kernels),
        top_device_kernels=[{"name": k[0][:90], "ms": k[1], "calls": k[2]}
                            for k in kernels[:10]])
    return carry, split


# --- one metric ---------------------------------------------------------------

def measure(name: str, prog: Program, settings: Settings, repeats: int,
            device: torch.device, build_s, trace: bool) -> dict:
    """Check, warm up, time and (with ``trace``) trace one program, the
    metric ``name``."""
    on_card = device.type == "cuda"
    clocks_before = clocks(device)
    _stage(f"[{name}] checking {CHECK_TICKS} ticks against the plain "
           "versions")
    plain = check_against_plain(prog)
    _stage(f"[{name}] the chunk against the eager tick in lockstep")
    lockstep = check_lockstep(prog)
    if on_card:  # the timed run's peak: its carry, graphs and ticks
        torch.cuda.reset_peak_memory_stats(device)
    carry = prog.make_carry()
    if on_card:
        fused_tick.prepare_kernel(prog.env_params, carry[3].params.flat(),
                                  in_kernel_td=kernel_learner(prog))
    params0 = [p.detach().clone() for p in carry[3].params.flat()]
    epsilon0 = float(carry[3].epsilon)
    _stage(f"[{name}] warming up ({WARMUP_CALLS} x {prog.steps} ticks)")
    carry, warmup_s = warm_up(prog.run, carry)
    first = carry[-1]
    _stage(f"[{name}] warm-up {warmup_s:.1f}s; timing {repeats} repeats of "
           f"{settings.calls} x {prog.steps} ticks")
    zero_launch_counts()
    timing = timed_median(prog.run, carry, repeats, settings.calls)
    launches = launch_counts()
    ticks = repeats * settings.calls * prog.steps
    timed = check_timed(prog, timing.carry, first, ticks, timing.aux,
                        launches, params0, epsilon0, on_card)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    split = None
    if trace:
        tick_ms = timing.median_s / (settings.calls * prog.steps) * 1e3
        _stage(f"[{name}] tracing {TRACE_TICKS} ticks")
        _, split = per_layer(prog, timing.carry, tick_ms, device)
    q1, q3 = quartiles(timing.repeat_s)
    steps_per_repeat = settings.calls * prog.steps
    value = prog.num_envs * steps_per_repeat / timing.median_s
    ok = not (plain["problems"] or lockstep["problems"]
              or timed["problems"])
    _stage(f"[{name}] {value:.1f} obs/s, correct {ok}, {prog.chunk.graphs} "
           f"graphs; device memory now "
           f"{torch.cuda.memory_allocated(device) if on_card else None} B, "
           f"peak {peak} B")
    return {
        "metric": name, "value": value, "unit": "obs/s",
        "repeat_s": timing.repeat_s, "median_s": timing.median_s,
        "q1_s": q1, "q3_s": q3, "repeats": repeats,
        "steps_per_repeat": steps_per_repeat, "build_s": build_s,
        "graphs": prog.chunk.graphs, "capture_s": prog.chunk.capture_s,
        "warmup_s": warmup_s, "peak_mem_bytes": peak, "launches": launches,
        "_correct": ok,
        "_checks": {"plain": plain, "lockstep": lockstep, "timed": timed},
        "_clocks": {"before": clocks_before, "after": clocks(device)},
        "_per_layer": split,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--nets", nargs="+", choices=list(NETS),
                   default=list(NETS))
    p.add_argument("--in_kernel_td", choices=["on", "off", "both"],
                   default="both")
    p.add_argument("--no_trace", action="store_true",
                   help="skip the traced per-layer run")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    settings = Settings.from_environ()
    nets = args.nets if settings.second_net else args.nets[:1]
    tds = {"off": [False], "on": [True], "both": [False, True]}[
        args.in_kernel_td]
    variants = [(net, td) for net in nets for td in tds]
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        print(json.dumps({"metric": metric_name(
            variants[0][0], settings.num_envs, variants[0][1]),
            "unit": "obs/s", "error": str(err)}))
        return 1
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    info = device_info(device)
    _stage(f"device {info}; {settings}")
    programs = [build(net, settings.num_envs, in_kernel_td=td, device=device,
                      seed=args.seed, steps=settings.steps)
                for net, td in variants]
    build_s, build_wall = build_kernels(programs, device)
    _stage(f"kernels built or loaded: {build_wall} s")
    results = []
    for i, (net, td) in enumerate(variants):
        results.append(measure(
            metric_name(net, settings.num_envs, td), programs[i], settings,
            settings.repeats if net == "dense16" else settings.repeats_big,
            device, build_s[i], not args.no_trace))
        # Its chunk's carry, graphs and buffers go before the next metric,
        # whose peak memory is its own.
        programs[i] = None
    correct = all(r["_correct"] for r in results)
    line = {k: v for k, v in results[0].items() if not k.startswith("_")}
    line["extra_metrics"] = [
        {k: v for k, v in r.items() if not k.startswith("_")}
        for r in results[1:]]
    line.update({
        "num_envs": settings.num_envs, "engine": "ring", "seed": args.seed,
        "build_wall_s": build_wall, "device": info,
        "clocks": {r["metric"]: r["_clocks"] for r in results},
        "correct": correct,
        "checks": {r["metric"]: r["_checks"] for r in results},
        "per_layer": {r["metric"]: r["_per_layer"] for r in results},
    })
    print(json.dumps(line), flush=True)
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
