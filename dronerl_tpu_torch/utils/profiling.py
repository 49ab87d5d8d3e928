"""Profiling hooks: trace capture, timing, device memory (counterpart of
``dronerl_tpu/utils/profiling.py``), and the split of a trainer tick.

:func:`trace` records ``torch.profiler`` (host and, where CUDA is
available, device activity) for everything inside the block and writes a
Chrome trace; :class:`Stopwatch` times host work and synchronises the
device before it stops; :func:`device_memory_stats` reads
``torch.cuda.memory_stats``.

The tick split (``scripts/torch_tick_profile.py`` and
``dronerl_tpu_torch.bench``'s ``per_layer``): :func:`tick_phases` names
the functions a tick of each engine spends its host time in,
:func:`host_split` times them by wrapping each (:func:`phase_timers`),
and :func:`device_kernels` / :func:`phase_device_ms` read a
``torch.profiler`` run of ticks: device time by kernel, and by the phase
that launched it. The chunk's split (``train.Chunk.phase_ns``) is a
:class:`PhaseClock` that the chunk keeps itself, since a graph replay
calls none of a tick's functions.
"""

import contextlib
import logging
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block; writes ``log_dir/trace.json`` (Chrome trace
    format, viewable in Perfetto or ``chrome://tracing``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


class Stopwatch:
    """Wall-clock timer whose :meth:`stop` waits for the device."""

    def __init__(self):
        self.start = None
        self.elapsed = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def stop(self, *block_on) -> float:
        """Synchronise the devices of the tensors ``block_on`` (every
        CUDA device when none is given and CUDA is available), then
        stop."""
        devices = {t.device for t in block_on
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
        if not block_on and torch.cuda.is_available():
            devices = {None}
        for device in devices:
            torch.cuda.synchronize(device)
        self.elapsed = time.perf_counter() - self.start
        return self.elapsed

    def __exit__(self, *exc):
        if self.elapsed == 0.0:
            self.elapsed = time.perf_counter() - self.start


def current_device() -> torch.device:
    """The CUDA device this process launches on (``torch.cuda.
    set_device``'s: a rank's own card)."""
    return torch.device("cuda", torch.cuda.current_device())


def device_memory_stats(device: Optional[torch.device] = None) -> dict:
    """Live and peak device memory of one CUDA device (empty without
    CUDA): ``bytes_in_use``, ``peak_bytes_in_use`` (the caching
    allocator's allocated bytes) and ``bytes_limit`` (the card's memory),
    as the JAX package names them. ``device`` defaults to the current
    device, and ``"cuda"`` without an index means it too."""
    if not torch.cuda.is_available():
        return {}
    device = current_device() if device is None else torch.device(device)
    if device.index is None:
        device = current_device()
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }


def log_device_memory(prefix: str = "") -> None:
    """Log every card's memory, or under a process group (one rank a
    card) this rank's card alone."""
    if not torch.cuda.is_available():
        return
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        devices = [current_device()]
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    for device in devices:
        stats = device_memory_stats(device)
        logger.info("%s%s: %.1f MiB in use (peak %.1f / limit %.1f)",
                    prefix, device, stats["bytes_in_use"] / 2**20,
                    stats["peak_bytes_in_use"] / 2**20,
                    stats["bytes_limit"] / 2**20)


# --- the split of a trainer tick ---------------------------------------------

PHASE_PREFIX = "phase:"


class PhaseClock:
    """Host nanoseconds by phase, cumulative: ``with clock.phase(name):``
    adds the block's ``time.perf_counter_ns`` difference to ``name``, less
    the time of the phases opened inside it (each phase counts its own
    time alone, so the phases add up to the time they cover); ``count``
    adds to a count. A phase named in ``ranged`` is also a
    ``torch.profiler`` range ``PHASE_PREFIX + prefix + name`` where
    :meth:`look` last found a profiler collecting: the caller looks once
    for many phases (a chunk's), as a range costs about 10 µs even when
    nothing collects it. Range only host work: the profiler mirrors a
    range that launches device work onto the card's timeline."""

    def __init__(self, prefix: str, ranged=()):
        self.prefix = PHASE_PREFIX + prefix
        self.ranged = frozenset(ranged)
        self.ns: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}
        self._inner: List[int] = []   # ns of the phases inside each open one
        self._collecting = False

    def look(self) -> None:
        """Whether a profiler collects, for the phases until the next
        look."""
        self._collecting = torch.autograd.profiler._is_profiler_enabled

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        with (torch.profiler.record_function(self.prefix + name)
              if self._collecting and name in self.ranged
              else contextlib.nullcontext()):
            self._inner.append(0)
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                ns = time.perf_counter_ns() - t0
                inner = self._inner.pop()
                self.ns[name] = self.ns.get(name, 0) + ns - inner
                if self._inner:
                    self._inner[-1] += ns


def tick_phases(engine: str) -> Dict[str, Tuple[object, str]]:
    """The host phases of one tick of ``engine`` ("ring", "full" or
    "fused"): ``{phase: (owner, attribute)}`` of the function each phase
    is, as :func:`phase_timers` wraps them. A phase's function called
    inside another phase counts to the outer one (the split inside the
    gather's randint counts to the gather). The learner is the default
    TD step on either route (``train.learner_step``); on ``in_kernel_td``
    it runs inside the kernel's wrapper."""
    from dronerl_tpu_torch import replay, rng, train
    from dronerl_tpu_torch.agents import dqn
    from dronerl_tpu_torch.env import core
    from dronerl_tpu_torch.ops import fused_tick

    by_engine = {
        "ring": {
            "kernel": (fused_tick, "full_tick_fused_ring"),
            "gather": (fused_tick, "ring_gather_batch"),
            "scalar_writes": (fused_tick, "ring_scalar_writes"),
        },
        "full": {  # B3 pushes into the replay itself
            "kernel": (fused_tick, "full_tick_fused"),
            "sample": (replay.StreamReplay, "sample"),
        },
        "fused": {
            "kernel": (fused_tick, "tick_fused"),
            "push": (replay.StreamReplay, "push_many"),
            "sample": (replay.StreamReplay, "sample"),
            "actor": (dqn.DQN, "act_t"),
            "opponents": (rng, "randint"),
            "reset": (core, "reset_batch"),
        },
    }
    return {**by_engine[engine],
            "learner": (train, "learner_step"),
            "schedules": (dqn.DQN, "apply_schedules"),
            "rng_split": (rng, "split")}


@contextlib.contextmanager
def replaced(owner, attr: str, wrapper):
    """Put ``wrapper`` in ``owner.attr``'s place for the block. A kernel
    wrapper counts its launches in an attribute of the name it is called
    by (``fused_tick.full_tick_fused_ring.launches``), which inside the
    block names ``wrapper``: the function's attributes go over to
    ``wrapper`` and come back after."""
    fn = getattr(owner, attr)
    wrapper.__dict__.update(fn.__dict__)
    setattr(owner, attr, wrapper)
    try:
        yield fn
    finally:
        setattr(owner, attr, fn)
        fn.__dict__.update(wrapper.__dict__)


@contextlib.contextmanager
def phase_timers(totals: Dict[str, float],
                 phases: Dict[str, Tuple[object, str]],
                 annotate: bool = False):
    """Add each phase's host wall time (outermost calls only) into
    ``totals``; with ``annotate`` each outermost call is also a
    ``torch.profiler`` range named ``PHASE_PREFIX + phase``, which
    :func:`phase_device_ms` reads."""
    depth = [0]

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            outer = depth[0] == 0
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                if annotate and outer:
                    with torch.profiler.record_function(PHASE_PREFIX + name):
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if outer:
                    totals[name] = (totals.get(name, 0.0)
                                    + time.perf_counter() - t0)
        return wrapper

    with contextlib.ExitStack() as stack:
        for name, (owner, attr) in phases.items():
            stack.enter_context(replaced(owner, attr,
                                         timed(name, getattr(owner, attr))))
        yield


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the
    CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_split(tick, carry, ticks: int, phases, device):
    """Run ``ticks`` ticks with every phase timed; returns ``(carry, host
    ms a tick by phase, with "other" the rest of the tick, the phase-timed
    tick's ms)``."""
    totals = {}
    with phase_timers(totals, phases):
        t0 = time.perf_counter()
        for _ in range(ticks):
            carry, _ = tick(carry)
        synchronize(device)
        tick_ms = (time.perf_counter() - t0) / ticks * 1e3
    host_ms = {k: v / ticks * 1e3 for k, v in totals.items()}
    host_ms["other"] = tick_ms - sum(host_ms.values())
    return carry, host_ms, tick_ms


def profiled_ticks(tick, carry, ticks: int, device, phases=None):
    """Run ``ticks`` ticks under ``torch.profiler`` (host, and the card's
    timeline on a CUDA ``device``); with ``phases``, each an annotated
    range (:func:`phase_timers`). Returns ``(carry, profile)``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(torch.profiler.profile(activities=acts))
        if phases:
            stack.enter_context(phase_timers({}, phases, annotate=True))
        for _ in range(ticks):
            carry, _ = tick(carry)
        synchronize(device)
    return carry, prof


def device_kernels(prof, ticks: int) -> List[Tuple[str, float, float]]:
    """``(name, device ms a tick, calls a tick)`` of every kernel and copy
    on the card's timeline in a profile of ``ticks`` ticks, the longest
    first (the phases' annotated ranges left out)."""
    per = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.name.startswith(PHASE_PREFIX)):
            ms, calls = per.get(ev.name, (0.0, 0))
            per[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, calls + 1)
    return sorted(((k, ms / ticks, calls / ticks)
                   for k, (ms, calls) in per.items()), key=lambda k: -k[1])


def phase_device_ms(prof, ticks: int) -> Dict[str, float]:
    """Device ms a tick of the kernels and copies each annotated phase
    launched (:func:`profiled_ticks` with ``phases``)."""
    out = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith(PHASE_PREFIX)):
            name = ev.name[len(PHASE_PREFIX):]
            us = getattr(ev, "device_time_total", None)
            if us is None:  # torch before the device_* names
                us = ev.cuda_time_total
            out[name] = out.get(name, 0.0) + us / 1e3 / ticks
    return out
