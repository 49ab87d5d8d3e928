"""The reduction of a ``torch.profiler`` run of whole chunks to what the
per-layer readers take: every device operation (kernels, copies and
memsets of the card's timeline, graph replays included), the union of
their intervals, and the idle gaps named by what the host was doing.

The kernels of the program are told apart by name: the full tick kernel
(B1 on the ring engine, B3 on the full engine), the learner kernel and
the replay sample kernel."""

import collections
from typing import List, NamedTuple, Tuple

import torch

TICK_KERNEL = "full_tick_kernel"
LEARNER_KERNEL = "td_adam_kernel"
SAMPLE_KERNEL = "ring_sample_kernel"
HARNESS_RANGE = "portbench:"


class Op(NamedTuple):
    name: str
    start_us: float
    end_us: float


def device_ops(prof) -> List[Op]:
    """Every operation on the card's timeline, in start order (the
    harness's own ranges, which the profiler mirrors there, left out)."""
    ops = [Op(ev.name, ev.time_range.start, ev.time_range.end)
           for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and not ev.name.startswith(HARNESS_RANGE)]
    return sorted(ops, key=lambda op: op.start_us)


def host_ops(prof) -> List[Op]:
    return [Op(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CPU]


def union(ops: List[Op]) -> List[Tuple[float, float]]:
    """The device's busy intervals: the union of the operations'."""
    spans = []
    for op in ops:
        if spans and op.start_us <= spans[-1][1]:
            spans[-1] = (spans[-1][0], max(spans[-1][1], op.end_us))
        else:
            spans.append((op.start_us, op.end_us))
    return spans


def busy_s(ops: List[Op]) -> float:
    return sum(end - start for start, end in union(ops)) / 1e6


def by_name(ops: List[Op]):
    """``{name: (device seconds, calls)}``."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for op in ops:
        out[op.name][0] += (op.end_us - op.start_us) / 1e6
        out[op.name][1] += 1
    return {k: tuple(v) for k, v in out.items()}


def seconds_of(ops: List[Op], fragment: str) -> float:
    return sum(op.end_us - op.start_us for op in ops
               if fragment in op.name) / 1e6


def idle_gaps(dev: List[Op], host: List[Op], window: Tuple[float, float],
              top: int = 10):
    """The ``top`` longest idle gaps of the card inside ``window`` (us),
    each named by the innermost host operation running at its middle."""
    spans = union(dev)
    edges = [window[0]] + [x for s in spans for x in s] + [window[1]]
    gaps = []
    for start, end in zip(edges[0::2], edges[1::2]):
        start, end = max(start, window[0]), min(end, window[1])
        if end > start:
            gaps.append((start, end))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for start, end in gaps[:top]:
        mid = (start + end) / 2
        inside = [op for op in host if op.start_us <= mid <= op.end_us]
        name = (min(inside, key=lambda op: op.end_us - op.start_us).name
                if inside else "outside the profiled ranges")
        if name.startswith(HARNESS_RANGE):
            # No op of the profiler's inside the harness's range: Python.
            name = f"python in {name}"
        out.append([name, (end - start) / 1e6])
    return out


def short(name: str, width: int = 96) -> str:
    """A kernel's name cut to ``width`` characters (templates run long)."""
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(dev: List[Op], host: List[Op], window) -> dict:
    ops = sorted(by_name(dev).items(), key=lambda kv: -kv[1][0])
    return {"device_ops": [[short(name), s] for name, (s, _) in ops[:10]],
            "idle_gaps": [[short(name), s] for name, s in
                          idle_gaps(dev, host, window)]}
