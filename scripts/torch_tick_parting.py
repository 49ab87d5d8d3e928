"""Where two trees' jnp-engine training runs part, tick by tick.

Runs the quality lock's configuration (``scripts/torch_quality_parity.py``
--config dense: the CLI's defaults, grid 9, 4 drones, dense (16,16),
``num_envs`` 1, memory 100,000, batch 8; ``--seed``) in worker processes,
one a run ``TREE:MODE``. Each imports ``dronerl_tpu_torch`` from its tree,
builds the CLI's jnp engine (``train._build_engine``) and trains tick by
tick: ``eager`` calls the tick, ``graphed`` calls the tree's chunk one tick
at a time (its CUDA graphs on a card). After each tick it takes, on the
device, a digest of every carry tensor (of the replay's storage the slot
the tick wrote) and of the tick's outputs, beside the carry's numbers
(step, Adam count, cursor, size), and writes them out every ``--flush``
ticks. The parent holds each run to the first as the digests come and
reports, for each, the first tick where they part and the tensors that
differ there; a run that has parted is stopped, and all are stopped at
``--steps`` ticks or ``--seconds``.

``--foreach_check N`` also divides random f32 tensors (the (16,16) net's
shapes, magnitudes 1e-12 to 1e3) by the Adam bias corrections of counts 1
to N given as Python floats and as 0-d f32 tensors on the device
(``torch._foreach_div``, and ``torch.div`` on one tensor), and reports how
many counts give other bits, the first of them and the first 100 counts
whose ``_foreach_div`` differs, and how many of each way's quotients
differ from the CPU's (IEEE division).

Run from the repository root (the other trees unpacked with ``git
archive``):

    python scripts/torch_tick_parting.py --runs .:graphed .:eager \\
        other_tree:eager --seed 2 --out parting.json
    python scripts/torch_tick_parting.py --device cpu --steps 50 \\
        --runs .:graphed other_tree:eager
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

NUMBERS = ("step", "count", "cursor", "size")
OUTPUTS = ("out.rewards", "out.epsilon", "out.loss")


# --- a worker: one tree, one mode --------------------------------------------

def _carry_leaves(tsio, carry):
    if hasattr(tsio, "leaves"):
        return tsio.leaves(carry)
    tensors, numbers = {}, {}
    tsio._flatten(carry, "", tensors, numbers)
    return tensors, numbers


def _digest(torch, t, weights):
    """Sum of the tensor's 32-bit words (64-bit words for int64) times
    fixed odd weights, wrapping in int64: equal bits, equal digests."""
    t = t.detach().reshape(-1).to(weights.device)
    if t.dtype in (torch.bool, torch.int8, torch.uint8, torch.int16):
        bits = t.to(torch.int64)
    elif t.dtype == torch.int64:
        bits = t
    elif t.element_size() == 4:
        bits = t.view(torch.int32).to(torch.int64)
    else:
        bits = t.to(torch.float32).view(torch.int32).to(torch.int64)
    return (bits * weights[:bits.numel()]).sum()


def worker(tree: str, mode: str, seed: int, steps: int, flush: int,
           device: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from dronerl_tpu_torch import train
    from dronerl_tpu_torch.agents.dqn import DQN
    from dronerl_tpu_torch.interop import train_state_io as tsio

    torch.backends.cuda.matmul.allow_tf32 = False
    args = train.parse_args(["--device", device, "--seed", str(seed),
                             "--skip_final_eval"])
    env_params = train.env_params_from_args(args)
    agent = DQN(train.agent_config_from_args(args), env_params,
                device=device)
    engine, carry = train._build_engine(
        args, agent, env_params, "jnp",
        *train.engine_rng_rounds(args, "jnp"))
    if mode == "graphed":
        if not hasattr(engine, "graphs"):
            raise SystemExit(f"{tree}: its engine has no chunk to graph")

        def step(carry):
            carry, outs = engine(carry, 1)
            return carry, tuple(o[0] for o in outs)
    else:
        step = engine.tick if hasattr(engine, "graphs") else engine

    storage = "4.storage."
    tensors, _ = _carry_leaves(tsio, carry)
    paths = sorted(tensors)
    size = max(t[0].numel() if p.startswith(storage) else t.numel()
               for p, t in tensors.items())
    dev = torch.device(device)
    weights = (torch.arange(1, size + 1, dtype=torch.int64, device=dev)
               * 0x9E3779B1 + 0x7F4A7C15) | 1
    names = paths + list(OUTPUTS)
    with open(out + ".json", "w") as f:
        json.dump({"tree": tree, "mode": mode, "columns": names
                   + list(NUMBERS)}, f)
    digests = torch.zeros((flush, len(names)), dtype=torch.int64, device=dev)
    numbers = []
    t0 = time.perf_counter()
    for t in range(steps):
        slot = carry[4].cursor
        carry, outs = step(carry)
        tensors, _ = _carry_leaves(tsio, carry)
        row = [_digest(torch, tensors[p][slot] if p.startswith(storage)
                       else tensors[p], weights) for p in paths]
        row += [_digest(torch, o, weights) for o in outs]
        digests[t % flush] = torch.stack(row)
        numbers.append((carry[-1], carry[3].opt_state.count,
                        carry[4].cursor, carry[4].size))
        if (t + 1) % flush == 0 or t + 1 == steps:
            n = t % flush + 1
            block = np.concatenate(
                [digests[:n].cpu().numpy(),
                 np.asarray(numbers, dtype=np.int64).reshape(n, -1)], axis=1)
            with open(out + ".bin", "ab") as f:
                f.write(block.astype(np.int64).tobytes())
            numbers = []
    with open(out + ".done", "w") as f:
        json.dump({"ticks": steps, "seconds": time.perf_counter() - t0}, f)


# --- the parent ----------------------------------------------------------------

def _read(out: str, columns: int) -> np.ndarray:
    if not os.path.exists(out + ".bin"):
        return np.zeros((0, columns), dtype=np.int64)
    raw = np.fromfile(out + ".bin", dtype=np.int64)
    return raw[:raw.size // columns * columns].reshape(-1, columns)


def _parting(ref, ref_cols, got, got_cols):
    """The first tick where ``got`` differs from ``ref`` on the columns
    both have, and those columns there; None where they agree."""
    common = [c for c in ref_cols if c in got_cols]
    a = ref[:, [ref_cols.index(c) for c in common]]
    b = got[:, [got_cols.index(c) for c in common]]
    n = min(len(a), len(b))
    differ = np.nonzero((a[:n] != b[:n]).any(axis=1))[0]
    if differ.size == 0:
        return None, n, common
    t = int(differ[0])
    return {"tick": t, "step_after": int(ref[t, ref_cols.index("step")]),
            "count_after": int(ref[t, ref_cols.index("count")]),
            "columns": [c for i, c in enumerate(common)
                        if a[t, i] != b[t, i]]}, n, common


def foreach_check(counts: int, device: str) -> dict:
    """Bits of Adam's divisions by the bias corrections, the corrections
    given as Python floats and as 0-d f32 tensors on ``device``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dronerl_tpu_torch.agents.dqn import adam_bias_corrections

    g = torch.Generator().manual_seed(0)
    shapes = ((294, 16), (16,), (16, 16), (16,), (16, 5), (5,))
    xs = [(torch.rand(s, generator=g) * 10.0 ** torch.randint(
        -12, 4, s, generator=g).float()).to(device) for s in shapes]
    cpu = [x.cpu() for x in xs]
    result = {"counts": counts, "foreach_differ": 0, "div_differ": 0,
              "first_foreach": None, "first_div": None,
              "foreach_counts": [], "float_vs_cpu_differ": 0,
              "tensor_vs_cpu_differ": 0}
    for count in range(1, counts + 1):
        for i, bc in enumerate(adam_bias_corrections(count)):
            by_tensor = torch.tensor(bc, dtype=torch.float32, device=device)
            a = torch._foreach_div(xs, bc)
            b = torch._foreach_div(xs, by_tensor)
            # The CPU's quotients: IEEE division, as optax's on the CPU.
            want = torch._foreach_div(cpu, bc)
            result["float_vs_cpu_differ"] += not all(
                torch.equal(x.cpu(), y) for x, y in zip(a, want))
            result["tensor_vs_cpu_differ"] += not all(
                torch.equal(x.cpu(), y) for x, y in zip(b, want))
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                result["foreach_differ"] += 1
                result["first_foreach"] = result["first_foreach"] or [
                    count, ("bc1", "bc2")[i]]
                if len(result["foreach_counts"]) < 100:
                    result["foreach_counts"].append(count)
            if not torch.equal(xs[0] / bc, xs[0] / by_tensor):
                result["div_differ"] += 1
                result["first_div"] = result["first_div"] or [
                    count, ("bc1", "bc2")[i]]
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", nargs="+",
                   help="TREE:MODE (eager or graphed); the first is the "
                   "reference")
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--steps", type=int, default=50_000)
    p.add_argument("--seconds", type=float, default=1_200.0)
    p.add_argument("--flush", type=int, default=250)
    p.add_argument("--device", default="cuda")
    p.add_argument("--foreach_check", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--worker", nargs=2, metavar=("RUN", "OUT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        tree, mode = args.worker[0].rsplit(":", 1)
        worker(tree, mode, args.seed, args.steps, args.flush, args.device,
               args.worker[1])
        return
    if not args.runs:
        p.error("--runs is required")
    with tempfile.TemporaryDirectory(prefix="parting_") as scratch:
        result = compare(args, scratch)
    text = json.dumps(result, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


def compare(args, scratch: str) -> dict:
    """Start the workers of ``args.runs`` with their files in
    ``scratch``, hold each to the first as their digests come, stop them
    and return the result."""
    runs = []
    for i, run in enumerate(args.runs):
        tree, mode = run.rsplit(":", 1)
        if mode not in ("eager", "graphed"):
            raise SystemExit(f"{run}: the mode is eager or graphed")
        out = os.path.join(scratch, f"run{i}")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", run,
               out, "--seed", str(args.seed), "--steps", str(args.steps),
               "--flush", str(args.flush), "--device", args.device]
        log = open(out + ".log", "w")
        runs.append({"run": run, "out": out, "log": log,
                     "proc": subprocess.Popen(cmd, stdout=log,
                                              stderr=subprocess.STDOUT)})
    result = {"seed": args.seed, "steps": args.steps, "device": args.device}
    if args.device == "cuda":
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    if args.foreach_check:
        result["foreach_check"] = foreach_check(args.foreach_check,
                                                args.device)
    t0 = time.time()

    def columns(run):
        path = run["out"] + ".json"
        if "columns" not in run and os.path.exists(path):
            with open(path) as f:
                run["columns"] = json.load(f)["columns"]
        return run.get("columns")

    def hold():
        """Hold each run's digests so far to the reference's; stop a run
        that has parted."""
        ref = runs[0]
        if not columns(ref):
            return
        ref_data = _read(ref["out"], len(ref["columns"]))
        for run in runs[1:]:
            if not columns(run) or run.get("parted"):
                continue
            data = _read(run["out"], len(run["columns"]))
            parted, run["compared"], _ = _parting(
                ref_data, ref["columns"], data, run["columns"])
            if parted is not None:
                run["parted"] = parted
                run["proc"].terminate()

    while True:
        time.sleep(2.0)
        hold()
        alive = [r for r in runs if r["proc"].poll() is None]
        # Done when every run has parted, or has ended with the reference.
        done = all(r.get("parted") or (r["proc"].poll() is not None
                                       and runs[0]["proc"].poll() is not None)
                   for r in runs[1:])
        if not alive or done or time.time() - t0 > args.seconds:
            break
    for run in runs:
        if run["proc"].poll() is None:
            run["proc"].terminate()
        run["proc"].wait()
        run["log"].close()
    hold()
    result["seconds"] = time.time() - t0
    result["runs"] = []
    for run in runs:
        entry = {"run": run["run"], "exit": run["proc"].returncode,
                 "ticks_written": len(_read(run["out"], len(columns(run))))
                 if columns(run) else 0}
        if os.path.exists(run["out"] + ".done"):
            with open(run["out"] + ".done") as f:
                entry.update(json.load(f))
        if run is not runs[0]:
            entry["ticks_compared"] = run.get("compared", 0)
            entry["parted"] = run.get("parted")
        with open(run["out"] + ".log") as f:
            entry["log_tail"] = f.read()[-1500:]
        result["runs"].append(entry)
    return result


if __name__ == "__main__":
    main()
