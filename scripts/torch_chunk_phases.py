"""The host phases of ``train.Chunk``, and the card's idle time under them,
on a cell of the benchmark.

Builds a cell of ``BENCHMARK.json`` as the benchmark does
(``portbench.run.load_cell`` and ``build``: the CLI's flags, engine, nets
and carry from the seed), warms it up over two chunks, then:

* untraced, ``--host_chunks`` chunks, each timed from its call to before
  its readback (the benchmark's ``host_ms_per_tick``), with
  ``train.Chunk.phase_ns`` read before and after: the host ms a tick of
  each phase, and their sum against ``host_ms_per_tick``; and the
  counters of ``train.Chunk.COUNTERS`` a tick (``counters_per_tick``, by
  ``<function>.<count>``: the kernels' launches, a conv actor's module
  forwards, the StreamReplay's ATen pushes, the autograd learner's steps,
  the plain resets);
* traced, ``--trace_chunks`` chunks under ``torch.profiler`` (host and
  card), in the benchmark's own ranges: the card's idle share of the
  window; ``walk_idle_share``, the share of the window in which the card
  idles while the host is inside a ``phase:chunk.keys`` or
  ``phase:chunk.walk`` range (none on the CPU: it has no device
  timeline); the longest idle gaps, each named by the innermost host
  operation at its middle (``portbench.trace.idle_gaps``), and the five
  longest with the host operations that cover them; the idle share by
  the length of its gaps; device operations a tick; and the device
  events named ``phase:``, which should be none (the ranges launch
  nothing, so the profiler mirrors none onto the card's timeline);
* with ``--cost N``, N pairs of windows of ``--window_chunks`` chunks in
  turns, one under ``torch.profiler`` (host activity: the ranges open)
  and one without: obs/s, the median chunk ms (call to readback) and the
  host ms a chunk by phase of each.

Writes one JSON object to ``--out`` and prints it. ``--num_envs``,
``--memory_size`` and ``--chunk_ticks`` override the cell's (a rehearsal
on the CPU takes ``--device cpu --num_envs 128 --memory_size 256
--chunk_ticks 4``). On a card, from the repository root:

    python scripts/torch_chunk_phases.py --workload dense16.ring.e65536 \\
        --seed 7 --cost 3 --out chiprun_out/phases.json
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run, trace  # noqa: E402

WALK_RANGES = ("phase:chunk.keys", "phase:chunk.walk")
GAP_BINS = ((0, 10), (10, 100), (100, 1000), (1000, float("inf")))  # us


def idle_inside(dev, ranges, window):
    """Seconds of ``window`` (us) in which the card runs none of ``dev``
    while the host is inside one of ``ranges`` (``trace.Op`` lists)."""
    busy = trace.union(sorted(dev, key=lambda op: op.start_us))
    out = 0.0
    for start, end in trace.union(sorted(ranges, key=lambda op: op.start_us)):
        start, end = max(start, window[0]), min(end, window[1])
        if end > start:
            out += (end - start) - sum(
                max(0.0, min(end, b_end) - max(start, b_start))
                for b_start, b_end in busy)
    return out / 1e6


def longest_gaps(gaps, host, chunks, top: int = 5):
    """The ``top`` longest idle gaps ``(start, end)`` (us), each with the
    traced chunk whose range holds its end (0 the first; a chunk's gap
    opens in the readback before it) and the ms of it that each host
    operation (the harness's ranges left out) covers, the most first."""
    out = []
    for start, end in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        covered = {}
        for op in host:
            ms = (min(end, op.end_us) - max(start, op.start_us)) / 1e3
            if ms > 0 and not op.name.startswith(trace.HARNESS_RANGE):
                covered[op.name] = covered.get(op.name, 0.0) + ms
        out.append({
            "ms": (end - start) / 1e3,
            "chunk": next((i for i, c in enumerate(chunks)
                           if c.start_us < end <= c.end_us), None),
            "covered_ms": dict(sorted(covered.items(),
                                      key=lambda kv: -kv[1])[:6])})
    return out


def _readback(outs):
    rewards, epsilon, loss = outs
    return torch.stack([loss, epsilon, rewards.sum(dim=1)]).cpu()


def phase_ms(chunk, before: dict, per: str) -> dict:
    """The chunk's host ms by phase since its ``phase_ns()`` read
    ``before``, over the ``per`` ("ticks" or "chunks") between."""
    after = chunk.phase_ns()
    n = after[per] - before[per]
    return {name: (ns - before.get(name, 0)) / n / 1e6
            for name, ns in after.items() if name not in chunk.COUNTS}


def counters(chunk) -> dict:
    """The values of ``chunk.COUNTERS`` by ``<function>.<count>``."""
    return dict(zip((f"{name}.{count}" for _, name, count in chunk.COUNTERS),
                    chunk._launches()))


def untraced(chunk, carry, length: int, chunks: int):
    """``(carry, host ms a tick by phase and in all, the enqueue's host ms
    a tick, the counters a tick)`` over ``chunks`` chunks."""
    before = chunk.phase_ns()
    counted = counters(chunk)
    enqueue = 0.0
    for _ in range(chunks):
        t0 = time.perf_counter()
        carry, outs = chunk(carry, length)
        enqueue += time.perf_counter() - t0
        _readback(outs)
    phases = phase_ms(chunk, before, "ticks")
    phases["sum"] = sum(phases.values())
    ticks = chunks * length
    per_tick = {name: (n - counted[name]) / ticks
                for name, n in counters(chunk).items()}
    return carry, phases, enqueue / ticks * 1e3, per_tick


def traced(chunk, carry, length: int, chunks: int, device):
    """The benchmark's traced run of ``chunks`` chunks (``portbench.run.
    traced``'s ranges), read for the walk: ``(carry, readings)``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.HARNESS_RANGE + "window"):
            for _ in range(chunks):
                with torch.profiler.record_function(
                        trace.HARNESS_RANGE + "chunk"):
                    carry, outs = chunk(carry, length)
                with torch.profiler.record_function(
                        trace.HARNESS_RANGE + "readback"):
                    _readback(outs)
    host = trace.host_ops(prof)
    span = next(op for op in host
                if op.name == trace.HARNESS_RANGE + "window")
    window = (span.start_us, span.end_us)
    dev = [trace.Op(op.name, max(op.start_us, span.start_us),
                    min(op.end_us, span.end_us))
           for op in trace.device_ops(prof)
           if op.end_us > span.start_us and op.start_us < span.end_us]
    window_s = (span.end_us - span.start_us) / 1e6
    walk = [op for op in host if op.name in WALK_RANGES]
    mirrored = sorted({ev.name for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA
                       and ev.name.startswith("phase:")})
    idle_s = window_s - trace.busy_s(dev)
    walk_idle_s = idle_inside(dev, walk, window)
    spans = trace.union(dev)
    edges = [window[0]] + [x for span in spans for x in span] + [window[1]]
    gaps = [(start, end) for start, end in zip(edges[0::2], edges[1::2])
            if end > start]
    lengths = [end - start for start, end in gaps]
    chunk_ranges = sorted((op for op in host
                           if op.name == trace.HARNESS_RANGE + "chunk"),
                          key=lambda op: op.start_us)
    return carry, {
        "window_s": window_s,
        "walk_ranges": len(walk),
        "idle_share": idle_s / window_s * 100 if dev else None,
        "walk_idle_share": walk_idle_s / window_s * 100 if dev else None,
        "walk_share_of_idle": (walk_idle_s / idle_s * 100
                               if dev and idle_s > 0 else None),
        # The card's idle time by the length of its gaps: the short ones
        # lie between the kernels of the replayed graphs.
        "idle_share_by_gap_us": {
            f"{lo}-{hi}": sum(g for g in lengths if lo <= g < hi) / 1e4
            / window_s for lo, hi in GAP_BINS} if dev else None,
        "longest_gaps": (longest_gaps(gaps, host, chunk_ranges) if dev
                         else []),
        "device_ops_per_tick": len(dev) / (chunks * length),
        "mirrored_phase_events": mirrored,
        "idle_gaps": trace.idle_gaps(dev, host, window) if dev else [],
    }


def window(chunk, carry, length: int, chunks: int, num_envs: int,
           profiled: bool):
    """``chunks`` chunks back to back, each read back, under a host-only
    profiler or none: ``(carry, obs/s, median chunk ms, host ms a chunk
    by phase)``."""
    chunk_ms = []
    before = chunk.phase_ns()
    with (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) if profiled
          else contextlib.nullcontext()):
        start = time.perf_counter()
        for _ in range(chunks):
            t0 = time.perf_counter()
            carry, outs = chunk(carry, length)
            _readback(outs)
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
        elapsed = time.perf_counter() - start
    return (carry, num_envs * length * chunks / elapsed,
            statistics.median(chunk_ms), phase_ms(chunk, before, "chunks"))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    p.add_argument("--host_chunks", type=int, default=run.HOST_CHUNKS)
    p.add_argument("--trace_chunks", type=int, default=run.TRACE_CHUNKS)
    p.add_argument("--cost", type=int, default=0)
    p.add_argument("--window_chunks", type=int, default=50)
    p.add_argument("--num_envs", type=int)
    p.add_argument("--memory_size", type=int)
    p.add_argument("--chunk_ticks", type=int)
    p.add_argument("--out")
    a = p.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_chunk_phases: no CUDA card")
    cell = run.load_cell(a.workload)
    cell.flags.update({k: v for k, v in (("num_envs", a.num_envs),
                                         ("memory_size", a.memory_size))
                       if v is not None})
    length = a.chunk_ticks or cell.traffic["chunk_ticks"]
    engine, chunk, carry = run.build(cell, a.seed, a.device)
    for _ in range(run.WARMUP_CHUNKS):
        carry, outs = chunk(carry, length)
        _readback(outs)
    carry, phases, host_ms, per_tick = untraced(chunk, carry, length,
                                                a.host_chunks)
    carry, tr = traced(chunk, carry, length, a.trace_chunks, a.device)
    cost = []
    for i in range(a.cost):
        for profiled in ((False, True) if i % 2 == 0 else (True, False)):
            carry, obs, ms, phases_ms = window(
                chunk, carry, length, a.window_chunks,
                cell.flags["num_envs"], profiled)
            cost.append({"profiled": profiled, "obs_per_s": obs,
                         "chunk_ms_median": ms,
                         "phase_ms_per_chunk": phases_ms})
    is_cuda = torch.device(a.device).type == "cuda"
    out = {
        "workload": a.workload, "engine": engine, "seed": a.seed,
        "device": torch.cuda.get_device_name(a.device) if is_cuda else "cpu",
        "num_envs": cell.flags["num_envs"], "chunk_ticks": length,
        "graphed": chunk.graphed, "captures": chunk.phase_ns()["captures"],
        "host_ms_per_tick": host_ms, "phase_ms_per_tick": phases,
        "phases_over_host": phases["sum"] / host_ms,
        "walk_ms_per_tick": phases["keys"] + phases["walk"],
        "replay_ms_per_tick": phases.get("replay"),
        "counters_per_tick": per_tick,
        "traced": tr, "cost": cost,
    }
    text = json.dumps(out, indent=1)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text)
    print(text)
    return out


if __name__ == "__main__":
    main()
