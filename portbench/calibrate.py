"""The readings that a cell's limits (``limits/<workload>.json``) are set
from, in one process on the card, at the cell's own size. A seed's
program is driven as a run drives it (``run.build``, the start's check
ticks, the warm-up), then ``--chunks`` chunks of the traffic in place of
the window (enough for epsilon to reach its floor), then the late check
ticks; the readings, each against the sound reference:

- ``program``: the program, one line a seed: the lower reading of each
  number is the largest of these;
- ``control``: the reference in TF32 (every matmul operand rounded to
  TF32's 10 mantissa bits, the precision below the configured float32)
  put in the program's place;
- ``actor_control``: the reference with only the actor's Q forward in
  TF32 (the tick kernels' part) put in the program's place;
- ``half_batch``: the reference trained on half of each batch (a fault
  planted in the reference put in the program's place).

The upper reading of a number is the smallest that the control or a
fault gives. A state left unchanged reads 1 by ``update_gap``'s measure
and needs no run.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 ... \\
        [--control_seeds 1 2 3] [--chunks 100]

Each reading is a JSON line on standard output, the summary last.
"""

import argparse
import importlib
import json
import sys

import torch

from portbench import check, run
from portbench.reference import trainer


PLANTED = (("control", trainer.Variant(tf32=True)),
           ("actor_control", trainer.Variant(actor_tf32=True)),
           ("half_batch", trainer.Variant(half_batch=True)))


def program_runs(cell, seed: int, chunks: int, device):
    """The program's start and late readings of ``seed`` and the snapshot
    its late ticks start from, ``chunks`` chunks after the warm-up."""
    engine, chunk, carry = run.build(cell, seed, device)
    adapter = importlib.import_module(f"portbench.engines.{engine}")
    e, length = cell.flags["num_envs"], cell.traffic["chunk_ticks"]
    carry, start = run.check_ticks(chunk, carry, adapter, e,
                                   run.CHECK_TRAINED)
    for _ in range(cell.warmup_chunks + chunks):
        carry, outs = chunk(carry, length)
        run._readback(outs)
    snap = adapter.snapshot(carry)
    carry, late = run.check_ticks(chunk, carry, adapter, e,
                                  run.CHECK_TRAINED)
    del chunk, carry
    run.free(device)
    return {"start": start, "late": late}, snap


def readings(cell, seeds, control_seeds, device="cuda", emit=print,
             chunks: int = 100):
    """The readings of ``seeds`` (the program) and, for those also in
    ``control_seeds``, the control's and the faults': one row a seed and
    kind, each handed to ``emit`` as a JSON line."""
    rows = []

    def put(kind, seed, numbers):
        row = {"workload": cell.name, "kind": kind, "seed": seed, **numbers}
        rows.append(row)
        emit(json.dumps(row))

    for seed in seeds:
        program, snap = program_runs(cell, seed, chunks, device)
        reference = run.references(cell, seed, snap, device)
        put("program", seed, check.compare_runs(program, reference))
        if seed in control_seeds:
            for kind, variant in PLANTED:
                planted = run.references(cell, seed, snap, device, variant)
                put(kind, seed, check.compare_runs(planted, reference))
        del snap
        run.free(device)
    return rows


def summary(rows) -> dict:
    """Per number: the lower reading (largest of the program's) and the
    smallest reading of the control and of each fault."""
    out = {}
    for name in check.NAMES:
        out[name] = {"lower": max(r[name] for r in rows
                                  if r["kind"] == "program")}
        for kind in sorted({r["kind"] for r in rows} - {"program"}):
            out[name][kind] = min(r[name] for r in rows if r["kind"] == kind)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=())
    p.add_argument("--chunks", type=int, default=100)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    emit = lambda line: print(line, flush=True)  # noqa: E731
    rows = readings(run.load_cell(a.workload), a.seeds,
                    set(a.control_seeds), "cuda", emit, a.chunks)
    emit(json.dumps({"workload": a.workload, "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
