"""The benchmark of ``dronerl_tpu_torch``'s training: one cell of
``BENCHMARK.json`` (a configuration under a traffic mix) on one card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run reads the cell's configuration (``configs/<config>.json``) and
traffic (``traffic/<traffic>.json``), turns their ``flags`` into the
port CLI's flags (``train.parse_args``), fails unless ``train.
choose_engine`` picks the traffic's ``engine``, and builds the chunk and
its carry as the CLI does (``train._build_engine``; nets and envs from
the seed, on the card). Set-up then drives the chunk through its first
ticks one at a time until ``CHECK_TRAINED`` of them have trained,
keeping what each produced for the comparison (the ``start`` run), and
warms it up over ``WARMUP_CHUNKS`` chunks of the traffic's
``chunk_ticks`` ticks (every tick signature captured, the replay
wrapped).

With ``--trace 0`` the window calls ``train.Chunk(carry, chunk_ticks)``
back to back for ``--seconds`` and reads each chunk's losses, epsilon and
reward sum back to the host, as the CLI's ``_log_chunk`` does; it reports
the cell's end-to-end metrics. With ``--trace 1`` it times
``HOST_CHUNKS`` untraced chunks, then profiles ``TRACE_CHUNKS`` chunks
with ``torch.profiler`` and reports the per-layer metrics, each read by
``metrics/<name>.py``.

After the window the peak memory is read, the program's state is copied
(``engines/<engine>.py``'s ``snapshot``) and the same chunk drives one
tick a call, through the window's own graphs, until ``CHECK_TRAINED``
more have trained (the ``late`` run). The program is then freed, and the
reference (``reference/engines/<engine>.py``, plain PyTorch on the card)
runs the start from the seed and the late ticks from the snapshot;
``check.compare_runs`` and the cell's ``limits/<workload>.json`` decide
``correct``. The last line of standard output is the JSON result; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

A run exits non-zero and prints no result without a CUDA card, when the
engine differs, and when a module of JAX or of the JAX package was
imported.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import torch  # noqa: E402

from portbench import check, roofline, trace  # noqa: E402
from portbench.reference import trainer  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dronerl_tpu")
B1 = 0.9                  # Adam's first-moment decay: mu' = B1 mu + (1 - B1) g
MAX_CHECK_TICKS = 64
CHECK_TRAINED = 3         # trained ticks in each run that is compared
WARMUP_CHUNKS = 2         # chunks of set-up after the start's ticks
HOST_CHUNKS = 10          # untraced chunks of a traced run
TRACE_CHUNKS = 5          # chunks under the profiler


class EngineMismatch(RuntimeError):
    """``train.choose_engine`` picked another engine than the traffic's."""


def _stage(msg: str) -> None:
    print(f"[portbench +{time.perf_counter() - _T0:7.2f}s] {msg}",
          file=sys.stderr, flush=True)


def _load(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT) -> types.SimpleNamespace:
    """The cell named ``workload`` and everything it names, found by name:
    its configuration, traffic and limits, the merged CLI flags, the
    per-layer metrics that read it, and the run's chunk counts (which the
    tests cut)."""
    bench = _load(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = _load(HERE, "configs", cell["config"] + ".json")
    traffic = _load(HERE, "traffic", cell["traffic"] + ".json")
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", (workload,))]
    return types.SimpleNamespace(
        name=workload, chips=cell["chips"], config=config, traffic=traffic,
        flags={**config["flags"], **traffic["flags"]},
        limits=_load(HERE, "limits", workload + ".json"),
        end_to_end=bench["end_to_end"], per_layer=per_layer,
        warmup_chunks=WARMUP_CHUNKS, host_chunks=HOST_CHUNKS,
        trace_chunks=TRACE_CHUNKS)


def cli_argv(flags: dict) -> list:
    """The port CLI's flags for ``flags``: ``--name value``, a list as its
    items, True as the bare flag."""
    argv = []
    for name, value in flags.items():
        if value is True:
            argv.append(f"--{name}")
        elif isinstance(value, (list, tuple)):
            argv += [f"--{name}", *map(str, value)]
        elif value is not False and value is not None:
            argv += [f"--{name}", str(value)]
    return argv


def cli_seed(seed: int) -> int:
    """The CLI's seed (its key takes the int32 range) for a run's seed."""
    return int(seed) % (1 << 31)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    jaxlib's, flax's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted(name for name in names
                  if name.split(".", 1)[0] in FORBIDDEN)


def build(cell, seed: int, device: str):
    """The CLI's engine for the cell: ``(engine, chunk, carry)``."""
    from dronerl_tpu_torch import train
    from dronerl_tpu_torch.agents.dqn import DQN

    args = train.parse_args(cli_argv(cell.flags) + [
        "--seed", str(cli_seed(seed)), "--device", device,
        "--skip_final_eval"])
    env_params = train.env_params_from_args(args)
    env_params.validate()
    agent_config = train.agent_config_from_args(args)
    engine = train.choose_engine(args, env_params, agent_config)
    if engine != cell.traffic["engine"]:
        raise EngineMismatch(
            f"train.choose_engine picked the {engine} engine; the traffic "
            f"{cell.traffic['name']} runs the {cell.traffic['engine']} "
            "engine")
    agent = DQN(agent_config, env_params, device=device)
    chunk, carry = train._build_engine(
        args, agent, env_params, engine,
        *train.engine_rng_rounds(args, engine))
    return engine, chunk, carry


def _host(tensors):
    return [t.detach().float().cpu().clone() for t in tensors]


def check_ticks(chunk, carry, adapter, num_envs: int, trained: int):
    """Drive the chunk one tick a call until ``trained`` ticks have
    trained; returns ``(carry, readings)`` in the reference's layout."""
    online, target, mu, _ = adapter.learner(carry)
    before = (_host(online), _host(target))
    mu_before = _host(mu)
    ticks, losses, epsilons, grads = [], [], [], None
    step = carry[-1]
    while len(losses) < trained:
        if len(ticks) == MAX_CHECK_TICKS:
            raise RuntimeError(f"{trained} trained ticks not reached in "
                               f"{MAX_CHECK_TICKS}")
        carry, (_, epsilon, loss) = chunk(carry, 1)
        ticks.append({k: v.clone() for k, v in
                      adapter.answers(carry, step, num_envs).items()})
        if float(loss[0]) >= 0:
            losses.append(float(loss[0]))
            if grads is None:
                grads = [(m.double() - B1 * m0.double()) / (1 - B1)
                         for m, m0 in zip(_host(adapter.learner(carry)[2]),
                                          mu_before)]
        epsilons.append(float(epsilon[0]))
        step += 1
    online, target, _, _ = adapter.learner(carry)
    return carry, {"ticks": ticks, "losses": losses, "epsilons": epsilons,
                   "grads": grads, "params": (before[0], _host(online)),
                   "target": (before[1], _host(target))}


def references(cell, seed: int, snap: dict, device,
               variant=trainer.Variant()) -> dict:
    """The reference's readings of both runs compared: the start from the
    seed, the late ticks from the program's snapshot."""
    engine = importlib.import_module(
        f"portbench.reference.engines.{cell.traffic['engine']}")
    return {"start": trainer.start(engine, cell.flags, cli_seed(seed),
                                   CHECK_TRAINED, device, variant),
            "late": trainer.resume(engine, cell.flags, snap, CHECK_TRAINED,
                                   device, variant)}


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _readback(outs):
    """A chunk's losses, epsilon and reward sum on the host."""
    rewards, epsilon, loss = outs
    return torch.stack([loss, epsilon, rewards.sum(dim=1)]).cpu()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(chunk, carry, length: int, seconds: float, num_envs: int):
    """Chunks back to back for ``seconds``, each timed from its call to
    its readback: ``(carry, end-to-end values, chunks, failed)``."""
    chunk_ms, failed = [], 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        carry, outs = chunk(carry, length)
        host = _readback(outs)
        t1 = time.perf_counter()
        chunk_ms.append((t1 - t0) * 1e3)
        failed += int(not bool(torch.isfinite(host[0]).all()))
        if t1 - start >= seconds:
            break
    elapsed = t1 - start
    if len(chunk_ms) >= 5:
        fifth = len(chunk_ms) // 5
        _stage("chunk ms, median of each fifth of the window: " + " ".join(
            f"{statistics.median(chunk_ms[i:i + fifth]):.3f}"
            for i in range(0, fifth * 5, fifth)))
    p95 = (statistics.quantiles(chunk_ms, n=20, method="inclusive")[18]
           if len(chunk_ms) > 1 else chunk_ms[0])
    values = {"obs_per_s": num_envs * length * len(chunk_ms) / elapsed,
              "chunk_ms_p95": p95}
    return carry, values, len(chunk_ms), failed


def traced(chunk, carry, cell, engine: str, device):
    """The per-layer run: ``cell.host_chunks`` untraced chunks for the
    host and wall time a tick, then ``cell.trace_chunks`` chunks under
    ``torch.profiler``. Returns ``(carry, ctx, breakdown)``."""
    length = cell.traffic["chunk_ticks"]
    enqueue = 0.0
    start = time.perf_counter()
    for _ in range(cell.host_chunks):
        t0 = time.perf_counter()
        carry, outs = chunk(carry, length)
        enqueue += time.perf_counter() - t0
        _readback(outs)
    wall = time.perf_counter() - start
    host_ticks = cell.host_chunks * length
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.HARNESS_RANGE + "window"):
            for _ in range(cell.trace_chunks):
                with torch.profiler.record_function(
                        trace.HARNESS_RANGE + "chunk"):
                    carry, outs = chunk(carry, length)
                with torch.profiler.record_function(
                        trace.HARNESS_RANGE + "readback"):
                    _readback(outs)
    host = trace.host_ops(prof)
    span = next(op for op in host
                if op.name == trace.HARNESS_RANGE + "window")
    dev = [trace.Op(op.name, max(op.start_us, span.start_us),
                    min(op.end_us, span.end_us))
           for op in trace.device_ops(prof)
           if op.end_us > span.start_us and op.start_us < span.end_us]
    flags = cell.flags
    ctx = types.SimpleNamespace(
        engine=engine, num_envs=flags["num_envs"],
        batch=flags["batch_size"], net=roofline.net_of(flags),
        n_drones=flags["n_drones"], cells=flags["grid_size"] ** 2,
        ticks=cell.trace_chunks * length, dev=dev,
        window_s=(span.end_us - span.start_us) / 1e6,
        host_ms_per_tick=enqueue / host_ticks * 1e3,
        wall_ms_per_tick=wall / host_ticks * 1e3)
    return carry, ctx, trace.breakdown(dev, host,
                                       (span.start_us, span.end_us))


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", cell=None) -> dict:
    """One run of the cell (``cell`` in place of ``load_cell(workload)``,
    as the tests size it down). Returns the result's dict."""
    cell = cell or load_cell(workload)
    traffic, flags = cell.traffic, cell.flags
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    _stage(f"{cell.name}: building on {device}")
    engine, chunk, carry = build(cell, seed, device)
    adapter = importlib.import_module(f"portbench.engines.{engine}")
    carry, start = check_ticks(chunk, carry, adapter, flags["num_envs"],
                               CHECK_TRAINED)
    for _ in range(cell.warmup_chunks):
        carry, outs = chunk(carry, traffic["chunk_ticks"])
        _readback(outs)
    _sync(device)
    setup_s = time.perf_counter() - _T0
    _stage(f"set-up {setup_s:.2f} s ({chunk.graphs} graphs)")

    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if is_cuda else "cpu",
           "count": 1}
    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not trace_on:
        carry, values, chunks, failed = window(
            chunk, carry, traffic["chunk_ticks"], seconds,
            flags["num_envs"])
        out.update(attempted=chunks, failed=failed)
        peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
        values.update(peak_mem_mib=peak / 2**20, setup_s=setup_s)
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end
                          if cell.name in m.get("workloads", (cell.name,))}
    else:
        carry, ctx, breakdown = traced(chunk, carry, cell, engine, device)
        out.update(attempted=cell.trace_chunks)
        peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
        for m in cell.per_layer:
            value = importlib.import_module(
                f"portbench.metrics.{m['name']}").read(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        dev.update(busy_s=trace.busy_s(ctx.dev), window_s=ctx.window_s)
        out["breakdown"] = breakdown
    dev["memory_peak_bytes"] = peak
    out["device"] = dev
    _stage(f"window done; peak {peak / 2**20:.1f} MiB")

    snap = adapter.snapshot(carry)
    carry, late = check_ticks(chunk, carry, adapter, flags["num_envs"],
                              CHECK_TRAINED)
    del chunk, carry
    free(device)
    t0 = time.perf_counter()
    numbers = check.compare_runs({"start": start, "late": late},
                                 references(cell, seed, snap, device))
    correct, checks = check.judge(numbers, cell.limits)
    _stage(f"late ticks from step {snap['step']}; reference "
           f"{time.perf_counter() - t0:.2f} s")
    out["correct"] = bool(correct and out["failed"] == 0)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                   cell)
    found = forbidden_modules()
    if found:
        print("portbench: modules of JAX or of the JAX package were "
              f"imported: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
