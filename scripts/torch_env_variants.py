"""Block shapes and register choices of the env kernel, measured on a card.

Builds variants of a copy of the env kernel's sources (``env_kernel.cu``
and the headers it includes: B4 feature-major, B5 row-major), each with
one text patch, and times B5 (``step_launch``) on every board of
``--boards`` and B4 (``tick_launch``) on the boards within the tick's 256
cells and 32 drones, by CUDA events over launches of one prebuilt
argument block at 65,536 envs from a fresh reset. Every variant is timed
in turn on the same card, the unpatched one first and last.

Variants:

* ``base``: unchanged;
* ``no_skip``: the wide body runs every spawn round (no skip of the
  rounds that write 0 onto a vacant cell, nor of the air picks after the
  last drone to place);
* ``wide_n8``: the wide body from 9 drones on (rather than from 33);
* ``air_late_kc4``: the air field hashed into the ground field's
  registers after the ground spawns from 5 cells a lane on (rather than
  from 9);
* ``large_256x2``: the boards that run one block of 64 envs and 512
  threads an SM (the wide body's, and those of 5 to 8 cells a lane) in
  blocks of 32 envs and 256 threads, two an SM (at most 128 registers a
  thread as well);
* ``large_256x3``: the same at three blocks an SM (at most 85
  registers);
* ``kc8_at_64``: boards of 5 to 8 cells a lane at two blocks an SM (at
  most 64 registers) rather than one;
* ``small_256x4``: the boards that run two blocks an SM in blocks of 32
  envs and 256 threads, four an SM;
* ``small_128x8``: the same in blocks of 16 envs and 128 threads, eight
  an SM.

For each (variant, board): ptxas registers, spills and stack, the block
shape and blocks per SM (``env_block_shape``), and ms per launch. Run on
a machine with a CUDA card, from the repository root:

    python scripts/torch_env_variants.py [--variants base no_skip ...]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tick_ablation import (  # noqa: E402
    LAUNCHES, NUM_ENVS, make_variant, ptxas_summary, time_launches)
from dronerl_tpu_torch import rng  # noqa: E402
from dronerl_tpu_torch.env import core  # noqa: E402
from dronerl_tpu_torch.env.types import EnvParams  # noqa: E402
from dronerl_tpu_torch.ops import _build, fused_tick, step_kernel  # noqa: E402

BOARDS = ((9, 4), (5, 2), (16, 25), (20, 4), (20, 20), (22, 48))

_SHAPE = ("constexpr int EB = 64;                     // envs a block\n"
          "constexpr int BLOCK = 512;                 // threads a block\n"
          "constexpr int MIN_BLOCKS = LARGE ? 1 : 2;  // resident blocks an SM")


def _shape(eb, block, min_blocks):
    return [("env_kernel.cu", _SHAPE,
             f"constexpr int EB = {eb};\nconstexpr int BLOCK = {block};\n"
             f"constexpr int MIN_BLOCKS = {min_blocks};")]


# (file, old text, new text) replacements per variant.
PATCHES = {
    "base": [],
    "no_skip": [
        ("env_warp.cuh", "      if (s == live && s < n_vacant) {",
         "      if (false) {"),
        ("env_warp.cuh", "    rounds = past_last(unplaced);", "    rounds = N;"),
    ],
    "wide_n8": [
        ("env_warp.cuh", "constexpr bool WIDE = C > 256 || N > 32;",
         "constexpr bool WIDE = C > 256 || N > 8;"),
    ],
    "air_late_kc4": [
        ("env_warp.cuh", "uint32_t* const air = KC > 8 ? u : ua;",
         "uint32_t* const air = KC > 4 ? u : ua;"),
        ("env_warp.cuh", "if constexpr (KC <= 8) lane_field(air_key, air);",
         "if constexpr (KC <= 4) lane_field(air_key, air);"),
        ("env_warp.cuh", "if constexpr (KC > 8) lane_field(air_key, air);",
         "if constexpr (KC > 4) lane_field(air_key, air);"),
    ],
    "large_256x2": _shape("LARGE ? 32 : 64", "LARGE ? 256 : 512", "2"),
    "large_256x3": _shape("LARGE ? 32 : 64", "LARGE ? 256 : 512", "LARGE ? 3 : 2"),
    "kc8_at_64": [
        ("env_kernel.cu", "constexpr bool LARGE = warp::WIDE || warp::KC > 4;",
         "constexpr bool LARGE = warp::WIDE;"),
    ],
    "small_256x4": _shape("LARGE ? 64 : 32", "LARGE ? 512 : 256", "LARGE ? 1 : 4"),
    "small_128x8": _shape("LARGE ? 64 : 16", "LARGE ? 512 : 128", "LARGE ? 1 : 8"),
}


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name in ("tick_launch", "step_launch"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    lib.env_block_shape.argtypes = [ctypes.c_void_p]
    lib.env_block_shape.restype = None
    return lib


def blocks(params, device):
    """Prebuilt B5 and (within the tick's limits) B4 argument blocks at
    NUM_ENVS envs from a fresh reset: {entry: (block, buffers)}."""
    n = params.n_drones
    states = core.reset_batch(rng.PRNGKey(10).to(device), params, NUM_ENVS)
    step_actions = rng.randint(rng.PRNGKey(11).to(device), (NUM_ENVS, n), 0, 5)
    out = {"step_launch": step_kernel._kernel_args(
        rng.PRNGKey(12), states, step_actions, params) + (states, step_actions)}
    if not fused_tick.kernel_problems(params, NUM_ENVS):
        tstate = fused_tick.to_tstate(states)
        actions_t = step_actions.t().contiguous()
        out["tick_launch"] = fused_tick._env_tick_args(
            rng.PRNGKey(12), tstate, actions_t, params) + (tstate, actions_t)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="*", default=list(PATCHES))
    ap.add_argument("--boards", nargs="*", default=[f"{g}x{n}" for g, n in BOARDS],
                    help="grid x drones")
    ap.add_argument("--out", default=os.path.join(_build.BUILD_DIR, "env_variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    boards = [tuple(int(v) for v in b.split("x")) for b in args.boards]
    params = {b: EnvParams(grid_size=b[0], n_drones=b[1], window_radius=3) for b in boards}

    # Build every (variant, board) library at once, one nvcc each.
    procs = {}
    for v in args.variants:
        src = os.path.join(args.out, v, "csrc")
        make_variant(_build.CSRC, src, PATCHES[v], "warp")
        for b in boards:
            lib = os.path.join(args.out, v, f"libenv_{b[0]}x{b[1]}.so")
            cmd = ([_build.nvcc_path(), _build.ARCH, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
                   + [f"-D{k}={val}" for k, val in _build.env_defines(params[b])]
                   + ["-o", lib, os.path.join(src, _build.ENV_SOURCE)])
            procs[(v, b)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        libs[key] = load(path)
        ptxas[key] = ptxas_summary(log)

    rows = []
    order = args.variants + (["base"] if "base" in args.variants else [])
    for b in boards:
        prebuilt = blocks(params[b], device)
        for v in order:
            lib = libs[(v, b)]
            shape = (ctypes.c_int * 5)()
            lib.env_block_shape(shape)
            for entry, (block, *_keep) in prebuilt.items():
                ms = time_launches(getattr(lib, entry), block)
                row = {"variant": v, "board": list(b), "entry": entry, "ms": ms,
                       "envs": shape[0], "threads": shape[1], "smem": shape[2],
                       "blocks_per_sm": shape[3] if entry == "tick_launch" else shape[4],
                       "ptxas": ptxas[(v, b)]}
                rows.append(row)
                frames = [(f["stack"], f["spill_st"]) for f in row["ptxas"]["functions"]]
                print(f"{entry[:4]} grid {b[0]} drones {b[1]} {v:13s}: {ms:.4f} ms/launch "
                      f"({LAUNCHES} launches of one block), {shape[0]} envs x "
                      f"{shape[1]} threads, blocks/SM {row['blocks_per_sm']}, "
                      f"registers {row['ptxas']['registers']}, (stack, spill) "
                      f"{frames}", flush=True)
    print(f"card: {card}")
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
