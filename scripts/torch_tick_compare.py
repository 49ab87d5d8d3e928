"""Same-call timing of the tick kernels from two source trees, and of two
ways to write the collected drones' observations.

Times B1 (the ring launch, bf16 ring), B3 (the obs launch, f32) and B4
(the env tick) of this tree's ``dronerl_tpu_torch/ops/csrc`` and, with
``--other``, of another tree's copy of it (e.g. a ``git archive`` of the
parent commit), each over launches of one prebuilt argument block (CUDA
events), every env greedy (ε = 0), at the bench shapes (65,536 envs,
grid 9, 4 drones, radius 3) for the (16,16) and (128,64) nets, with one
drone collected at 20 rounds. The order is other, this, this, other, so
that a drift of the card's clock shows as a difference between the two
runs of one tree.

With ``--collect K`` it also times this tree's B1, B3 and B4 with K
drones collected in two variants: ``direct`` (the package's: drone 0's
window made in the one-observation tile and stored with coalesced
16-byte stores, drones 1..K-1 written by the observation pass straight
to device memory, element by element) and ``tile`` (a text-patched copy
where every drone's window takes a pass through the tile and its
coalesced stores). Each variant is launched twice and the outputs of
the four launches compared bitwise first. B4 writes every drone
straight out in both (the patch touches B1/B3 only).

An older tree's env kernel that takes B4's key by value (``key0``,
``key1``) gets its block in that layout (``env_block_for``), the same
pointers and key words; an older tick kernel without the StreamReplay
push gets its B1/B3 block without the push's fields
(``tick_block_for``). This tree's B3 is also timed with the push
(``B3push``: the launch's StreamReplay push into a 1,048,576-slot replay
and the next observation written over its input, as the full engine
launches it); an older tree has no such launch.

Each build's ptxas figures are printed kernel by kernel (registers,
barriers, stack, spills); with ``--other`` the two trees' figures of every
kernel both libraries hold are compared and the differences printed.

Run on a machine with a CUDA card, from the repository root:

    mkdir -p .archive/parent && git archive HEAD~1 dronerl_tpu_torch/ops/csrc \\
        | tar -x -C .archive/parent
    python scripts/torch_tick_compare.py \\
        --other .archive/parent/dronerl_tpu_torch/ops/csrc --collect 4
"""

import argparse
import ctypes
import json
import os
import subprocess

import torch

from torch_tick_ablation import (  # beside this script; puts the repo on the path
    LAUNCHES, NUM_ENVS, make_variant, time_launches)

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops import _build, fused_tick

NETS = ((16, 16), (128, 64))

# The tile variant: every drone's window through the tile
# (full_tick.cu's loop over the collected drones).
TILE_PATCH = (
    ("full_tick.cu", "    if (Lay::OBS_GLOBAL || (!GLOBAL && i > 0)) {",
     "    if (Lay::OBS_GLOBAL) {"),
    ("full_tick.cu", "      if (i == 0) {\n",
     "      if (i == 0 || !GLOBAL) {\n        if (i > 0) __syncthreads();\n"))


def build(src_dir, out_dir, source, defines):
    """One nvcc process for ``source`` of ``src_dir`` with ``defines``."""
    os.makedirs(out_dir, exist_ok=True)
    tag = "_".join(f"{k}{v}" for k, v in defines if not k.startswith(
        ("DR_N", "DR_CHARGE", "DR_DISCHARGE", "DR_RADIUS", "DR_GRID")))
    lib = os.path.join(out_dir, f"lib_{os.path.splitext(source)[0]}_{tag}.so")
    cmd = ([_build.nvcc_path(), _build.ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
           + [f"-D{k}={v}" for k, v in defines]
           + ["-o", lib, os.path.join(src_dir, source)])
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def ptxas_by_kernel(log: str) -> dict:
    """nvcc's ``-Xptxas -v`` output as {kernel's mangled name: its lines
    (stack and spills, registers and barriers)}."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.split(":", 1)[-1].strip())
    return out


def load(lib_path, entries):
    lib = ctypes.CDLL(lib_path)
    for entry in entries:
        getattr(lib, entry).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, entry).restype = ctypes.c_int
    return lib


class ValueKeyEnvArgs(ctypes.Structure):
    """``EnvArgs`` of an env kernel that takes the step key by value
    (``key0``, ``key1``), as the env kernel did before it read its key
    through a pointer: the block an older tree's B4 launch takes."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        *fused_tick._STATE_FIELDS, "actions", *fused_tick._OUT_FIELDS,
        "rewards", "dones", "obs_out")] + [
        ("num_envs", ctypes.c_int),
        ("key0", ctypes.c_uint32),
        ("key1", ctypes.c_uint32),
    ] + fused_tick._REWARD_FIELDS


def env_block_for(src_dir, block):
    """B4's ``block`` (this tree's ``EnvArgs``) in the layout that
    ``src_dir``'s env kernel takes: itself, or for a kernel that takes the
    key by value a :class:`ValueKeyEnvArgs` with the same pointers and
    scalars and the key's two words."""
    with open(os.path.join(src_dir, _build.ENV_SOURCE)) as f:
        if "uint32_t key0;" not in f.read():
            return block
    legacy = ValueKeyEnvArgs()
    for name, _ in ValueKeyEnvArgs._fields_:
        if name not in ("key0", "key1"):
            setattr(legacy, name, getattr(block, name))
    legacy.key0, legacy.key1 = (
        block.key_words.cpu().long() & rng.MASK32).tolist()
    return legacy


class PushlessTickArgs(ctypes.Structure):
    """``TickArgs`` of a tick kernel without B3's StreamReplay push (no
    ``push_*`` fields), as the kernel was before B3 pushed: the block an
    older tree's B1 and B3 launches take."""

    _fields_ = [f for f in fused_tick._TickArgs._fields_
                if not f[0].startswith("push_")]


def tick_block_for(src_dir, block):
    """A B1 or B3 ``block`` (this tree's ``TickArgs``) in the layout that
    ``src_dir``'s tick kernel takes: itself, or for a kernel without the
    push a :class:`PushlessTickArgs` with the same fields."""
    with open(os.path.join(src_dir, _build.TICK_SOURCE)) as f:
        if "push_obs" in f.read():
            return block
    legacy = PushlessTickArgs()
    for name, ctype in PushlessTickArgs._fields_:
        value = getattr(block, name)
        if issubclass(ctype, ctypes.Array):
            getattr(legacy, name)[:] = value[:]
        else:
            setattr(legacy, name, value)
    return legacy


def tensors(tree):
    """Every tensor of nested tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for item in tree for t in tensors(item)]


def blocks(params, chain, k, device):
    """Prebuilt argument blocks of B1, B3 and B4 with k drones collected,
    on one fresh state: {kind: (entry, block, its outputs and inputs,
    which must stay alive while the block is launched)}."""
    state = core.reset_batch(rng.PRNGKey(1).to(device), params, NUM_ENVS)
    tstate = fused_tick.to_tstate(state)
    obs = core.observe_batch(state, params, k).reshape(
        NUM_ENVS, -1).t().contiguous()
    ring = torch.zeros((obs.shape[0], 2 * NUM_ENVS), dtype=torch.bfloat16,
                       device=device)
    ring[:, :NUM_ENVS] = obs.to(torch.bfloat16)
    eps = torch.tensor(0.0, device=device)
    actions = rng.randint(rng.PRNGKey(8).to(device),
                          (params.n_drones, NUM_ENVS), 0, 5)
    key = rng.PRNGKey(7)
    out = {}
    if chain is not None:
        b1, o1 = fused_tick._kernel_args(key, tstate, ring, 0, NUM_ENVS,
                                         chain, eps, False, params, collect=k)
        b3, o3 = fused_tick._full_args(key, tstate, obs, chain, eps, False,
                                       params, collect=k)
        out["B1"] = ("full_tick_ring_launch", b1, (o1, ring, tstate, eps))
        out["B3"] = ("full_tick_launch", b3, (o3, obs, tstate, eps))
        if k == 1:
            # The full engine's launch: the push into the bench's
            # StreamReplay at its last slot, the next obs over its input.
            capacity = 16 * NUM_ENVS
            storage = {
                "obs": torch.zeros((obs.shape[0], capacity), device=device),
                "actions": torch.zeros(capacity, dtype=torch.int32,
                                       device=device),
                "rewards": torch.zeros(capacity, device=device),
                "dones": torch.zeros(capacity, dtype=torch.bool,
                                     device=device)}
            obs_p = obs.clone()
            bp, op = fused_tick._full_args(
                key, tstate, obs_p, chain, eps, False, params,
                replay=(storage, capacity - NUM_ENVS), collect=k)
            out["B3push"] = ("full_tick_launch", bp,
                             (op, obs_p, storage, tstate, eps))
    else:
        b4, o4 = fused_tick._env_tick_args(key, tstate, actions, params, k)
        out["B4"] = ("tick_launch", b4, (o4, tstate, actions))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", default=None,
                    help="another tree's dronerl_tpu_torch/ops/csrc")
    ap.add_argument("--collect", type=int, default=0,
                    help="also time K drones collected: tile against direct")
    ap.add_argument("--out", default=os.path.join(_build.BUILD_DIR,
                                                  "compare"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    params = EnvParams(grid_size=9, n_drones=4, window_radius=3)
    chains = {}
    for hidden in NETS:
        agent = DQN(DQNConfig(hidden_layers=hidden), params, device=device)
        chains[hidden] = agent.init_state(
            torch.Generator().manual_seed(0)).params.flat()

    trees = {"this": _build.CSRC}
    if args.other:
        trees["other"] = args.other
    if args.collect > 1:
        trees["tile"] = os.path.join(args.out, "tile_csrc")
        make_variant(_build.CSRC, trees["tile"], TILE_PATCH, "warp")

    # (tree, k, net or None) -> library; every nvcc at once.
    jobs = {}
    for tree, src in trees.items():
        ks = [1] if tree == "other" else (
            [args.collect] if tree == "tile" else
            [1] + ([args.collect] if args.collect > 1 else []))
        for k in ks:
            out_dir = os.path.join(args.out, tree)
            jobs[(tree, k, None)] = build(src, out_dir, _build.ENV_SOURCE,
                                          _build.env_defines(params, k))
            for hidden in NETS:
                widths = fused_tick.chain_widths(chains[hidden])
                jobs[(tree, k, hidden)] = build(
                    src, out_dir, _build.TICK_SOURCE,
                    _build.tick_defines(params, widths, k))
    libs, ptxas = {}, {}
    for key, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        ptxas[key] = ptxas_by_kernel(log)
        for kernel, lines in ptxas[key].items():
            print(f"{key} {kernel}: {' | '.join(lines)}", flush=True)
        libs[key] = load(path, ("tick_launch",) if key[2] is None else (
            "full_tick_ring_launch", "full_tick_launch"))
    for (tree, k, net), figures in ptxas.items():
        if tree != "this" or ("other", k, net) not in ptxas:
            continue
        theirs = ptxas[("other", k, net)]
        common = sorted(set(figures) & set(theirs))
        differ = [kern for kern in common if figures[kern] != theirs[kern]]
        print(f"ptxas this vs other k={k} net {net}: {len(common)} kernels "
              f"in both, {len(differ)} differ {differ}", flush=True)

    rows = []
    for net in NETS + (None,):
        chain = None if net is None else chains[net]
        for k in sorted({key[1] for key in libs}):
            blk = blocks(params, chain, k, device)
            order = ([("other", 1), ("this", 1), ("this", 1), ("other", 1)]
                     if k == 1 else [("tile", k), ("this", k), ("this", k),
                                     ("tile", k)])
            for kind, (entry, block, _keep) in blk.items():
                if k > 1:  # each variant alike on two launches, and both
                    outs = []
                    for tree in ("this", "this", "tile", "tile"):
                        launch = getattr(libs[(tree, k, net)], entry)
                        stream = torch.cuda.current_stream().cuda_stream
                        if launch(ctypes.byref(block), stream) != 0:
                            raise SystemExit(f"{tree} {kind} launch failed")
                        torch.cuda.synchronize()
                        outs.append([t.clone() for t in tensors(_keep)])
                    for (i, j) in ((0, 1), (2, 3), (0, 2)):
                        differ = [(n, int((a != b).sum()))
                                  for n, (a, b) in enumerate(zip(outs[i],
                                                                 outs[j]))
                                  if not torch.equal(a, b)]
                        print(f"{kind} k={k} net {net}: launches {i} and {j} "
                              f"(direct, direct, tile, tile) differ in "
                              f"(output, elements) {differ}", flush=True)
                        if differ:
                            raise SystemExit("the variants differ")
                for tree, kk in order:
                    if (tree, kk, net) not in libs or (
                            kind == "B3push" and tree != "this"):
                        continue
                    launch = getattr(libs[(tree, kk, net)], entry)
                    ms = time_launches(launch, (
                        env_block_for if kind == "B4" else tick_block_for)(
                            trees[tree], block))
                    rows.append({"kind": kind, "net": net, "k": kk,
                                 "tree": tree if kk == 1 else (
                                     "direct" if tree == "this" else "tile"),
                                 "ms": ms})
                    print(f"{kind} net {net} k={kk} "
                          f"{rows[-1]['tree']:6s}: {ms:.4f} ms/launch "
                          f"({LAUNCHES} launches of one block)", flush=True)
    print(f"card: {card}")
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
