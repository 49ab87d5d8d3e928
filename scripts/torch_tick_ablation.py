"""Where the full tick kernel's time goes, by subtraction, on a card.

Builds variants of a copy of the full tick kernel's sources (B1 and B3,
``full_tick.cu`` and the headers it includes), each with one part taken
out by a text patch, and times every variant's ring launch (B1, bf16
ring) by CUDA events over launches of one prebuilt argument block, at
the bench shapes (65,536 envs, grid 9, 4 drones, radius 3) for the
(16,16) and (128,64) nets (``--nets``; ``conv5`` is dqn-agent-5's conv
net as its im2col chain 294→392→16→5), every env greedy (ε = 0). The difference to
the unpatched build is the part's share. The patches break the kernel's
results on purpose: they live here, never in the package's sources.

Variants (``--gen thread``: the one-thread-per-env kernel, whose sources
are given by ``--src``, e.g. a ``git archive`` of its commit):

* ``base``: unchanged; timed first and last, and with ε = 1 (the actor
  off: every env random);
* ``fixed_picks``: every spawn pick a fixed cell (the uniform fields
  still hashed and kept live);
* ``no_hashes``: the spawn fields from a multiply instead of threefry;
* ``no_obs``: the observation write removed;
* ``threads64`` / ``threads256``: blocks of 64 / 256 threads.

``--gen warp`` (the warp-per-env kernel in the package, the default
``--src``): ``base`` (with ε = 1 too), ``fixed_picks``, ``no_hashes``,
``no_obs``, ``no_w_loads`` (the weights' loads from device memory
replaced by constants, the split and staging kept), ``w_once`` (each
layer's first weight chunk staged, the later chunks' barriers kept),
``w_once_no_sync`` (their barriers dropped too), ``mma_x2`` (every
mma.sync issued twice), ``no_obs_read`` (the observation tile not read),
``no_output_layer`` (the output layer replaced by a lookup), ``no_step`` (the
warp's step_env call removed: its hashes, picks and drone logic),
``no_keys`` (the per-env key chain replaced by constants) and ``no_mma``
(each mma.sync replaced by an integer op and an add on the same
registers, the fragment loads kept).

For each variant: ptxas registers, spills and stack, blocks per SM (the
occupancy query the variant exports), and ms per launch. Run on a
machine with a CUDA card, from the repository root:

    mkdir -p .archive/thread && git archive <commit> dronerl_tpu_torch/ops/csrc \\
        | tar -x -C .archive/thread
    python scripts/torch_tick_ablation.py --gen thread \\
        --src .archive/thread/dronerl_tpu_torch/ops/csrc
    python scripts/torch_tick_ablation.py --gen warp
    python scripts/torch_tick_ablation.py --gen warp --nets conv5
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dronerl_tpu_torch import rng  # noqa: E402
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig  # noqa: E402
from dronerl_tpu_torch.env import core  # noqa: E402
from dronerl_tpu_torch.env.types import EnvParams  # noqa: E402
from dronerl_tpu_torch.ops import _build, fused_tick  # noqa: E402

NUM_ENVS = 65536
LAUNCHES = 50
NETS = {
    "16x16": DQNConfig(hidden_layers=(16, 16)),
    "128x64": DQNConfig(hidden_layers=(128, 64)),
    "conv5": DQNConfig(network_type="conv", conv_matmul=True,
                       conv_dense_layers=(16,)),
}

# The occupancy query appended to a copy of the one-thread-per-env kernel
# (the current kernel exports its own).
THREAD_OCCUPANCY = """
extern "C" int full_tick_blocks_per_sm(int bf16) {
  int n = 0;
  cudaError_t err = bf16
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, dronerl::full_tick_kernel<__nv_bfloat16>, dronerl::THREADS, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, dronerl::full_tick_kernel<float>, dronerl::THREADS, 0);
  return err == cudaSuccess ? n : -1;
}
"""

# (file, old text, new text) replacements per variant.
PATCHES = {
    "thread": {
        "base": [],
        "fixed_picks": [
            ("env_step.cuh",
             "  for (int s = 0; s < ROUNDS; ++s) g[pick.next(u)] = fills[s];",
             "  uint32_t live = 0;\n"
             "  for (int c = 0; c < C; ++c) live ^= u[c];\n"
             "  for (int s = 0; s < ROUNDS; ++s) g[(s + (live & 1u)) % C] = fills[s];"),
            ("env_step.cuh",
             "    const int cand = pick.next(u);",
             "    const int cand = (i + (int)(u[i % C] & 1u)) % C;"),
        ],
        "no_hashes": [
            ("env_step.cuh",
             "  for (int c = 0; c < C; ++c) u[c] = uniform_bits(key, (uint32_t)c);",
             "  for (int c = 0; c < C; ++c) u[c] = ((uint32_t)c * 2654435761u ^ key.k0) >> 9;"),
        ],
        "no_obs": [
            ("full_tick.cu",
             "  write_obs(static_cast<T*>(a.obs_out) + a.write_col + e, a.out_ld, g, ax, ay, "
             "carrying, charge);",
             ""),
        ],
        "threads64": [
            ("env_step.cuh", "constexpr int THREADS = 128;",
             "constexpr int THREADS = 64;"),
        ],
        "threads256": [
            ("env_step.cuh", "constexpr int THREADS = 128;",
             "constexpr int THREADS = 256;"),
        ],
    },
    "warp": {
        "base": [],
        "fixed_picks": [
            ("env_warp.cuh",
             "__device__ __forceinline__ int pick_next(",
             "__device__ __forceinline__ uint32_t ablate_live(const uint32_t* u) {\n"
             "  uint32_t x = 0u;\n"
             "  for (int k = 0; k < KC; ++k) x ^= u[k];\n"
             "  return __reduce_or_sync(FULL, x) & 1u;\n"
             "}\n"
             "__device__ __forceinline__ int pick_next("),
            ("env_warp.cuh",
             "    set_cell(g, pick_next(u, valid, taken, s < n_vacant), v);",
             "    set_cell(g, (s + (int)ablate_live(u)) % C, v);"),
            ("env_warp.cuh",
             "    const int cand = pick_next(u, valid, taken, i < n_valid);",
             "    const int cand = (i + (int)ablate_live(u)) % C;"),
        ],
        "no_hashes": [
            ("env_warp.cuh",
             "    u[k] = c < C ? uniform_bits(key, (uint32_t)c) : 0u;",
             "    u[k] = c < C ? (((uint32_t)c * 2654435761u) ^ key.k0) >> 9 : 0u;"),
        ],
        "no_obs": [
            ("full_tick.cu",
             "  warp::observe_tile<EB, BLOCK>(tile, Lay::S, s_board, s_x, s_y, s_carry, "
             "s_charge);",
             ""),
        ],
        "no_w_loads": [
            ("full_tick.cu",
             "    lo[it] = live && k < M::IN ? __ldcg(w + k * M::OUT + n) : 0.0f;\n"
             "    hi[it] = live && k + 1 < M::IN ? __ldcg(w + (k + 1) * M::OUT + n) : 0.0f;",
             "    lo[it] = live && k < M::IN ? (float)n : 0.0f;\n"
             "    hi[it] = live && k + 1 < M::IN ? (float)k : 0.0f;"),
        ],
        "w_once": [
            ("full_tick.cu",
             "    stage_w<L, CHUNK>(frag, w, s0, steps, p * M::NTP * 8);",
             "    if (s0 == 0) stage_w<L, CHUNK>(frag, w, s0, steps, p * M::NTP * 8);"),
        ],
        "w_once_no_sync": [
            ("full_tick.cu",
             "    __syncthreads();  // the previous chunk's fragments are read\n"
             "    stage_w<L, CHUNK>(frag, w, s0, steps, p * M::NTP * 8);\n"
             "    __syncthreads();",
             "    if (s0 == 0) {\n"
             "      __syncthreads();\n"
             "      stage_w<L, CHUNK>(frag, w, s0, steps, p * M::NTP * 8);\n"
             "      __syncthreads();\n"
             "    }"),
        ],
        "mma_x2": [
            ("full_tick.cu",
             '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));',
             '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));\n'
             '  asm volatile(\n'
             '      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "\n'
             '      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"\n'
             '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
             '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b1), "r"(b0));'),
        ],
        "no_obs_read": [
            ("full_tick.cu",
             "      Tile::template stage_rows<Raw, Lay::S>(raw, static_cast<const Raw*>(a.obs_in), "
             "a.in_ld,\n                                             a.read_col + e0, OBS, ne);",
             ""),
        ],
        "no_output_layer": [
            ("full_tick.cu",
             "    return output_layer<L>(x, meta, el, sub);",
             "    return (int)x[el * act_stride(L - 1) + sub] & 3;"),
        ],
        "no_step": [
            ("full_tick.cu",
             "    warp::step_env(\n"
             "        ground_key, air_key, act, s_board + el, EB, [&](int k) { return g0[k] == "
             "SKYSCRAPER; },\n        g, d, reward, done, rw, u, ua);",
             "    reward[0] = (float)(ground_key.k0 ^ air_key.k1 ^ (uint32_t)act[0]);\n"
             "    done[0] = false;"),
        ],
        "no_keys": [
            ("full_tick.cu",
             "      const Key env_key = split_row(step_key, (uint32_t)e);\n"
             "      const Key nk = split_row(env_key, 0u);\n"
             "      const Key ground_key = split_row(env_key, 1u);\n"
             "      const Key air_key = split_row(nk, 1u);",
             "      const Key ground_key{(uint32_t)e ^ step_key.k0, 1u};\n"
             "      const Key air_key{(uint32_t)e ^ step_key.k1, 2u};"),
        ],
        "no_mma": [
            ("full_tick.cu",
             '  asm volatile(\n'
             '      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "\n'
             '      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"\n'
             '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
             '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));',
             "  d[0] += __uint_as_float((a[0] ^ b0) & 0x007FFFFFu);\n"
             "  d[1] += __uint_as_float((a[1] ^ b1) & 0x007FFFFFu);\n"
             "  d[2] += __uint_as_float((a[2] ^ b0) & 0x007FFFFFu);\n"
             "  d[3] += __uint_as_float((a[3] ^ b1) & 0x007FFFFFu);"),
        ],
    },
}


def make_variant(src: str, dst: str, patches, gen: str) -> None:
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    for name, old, new in patches:
        path = os.path.join(dst, name)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"patch text not found once in {name}: {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    if gen == "thread":
        with open(os.path.join(dst, "full_tick.cu"), "a") as f:
            f.write(THREAD_OCCUPANCY)


def ptxas_summary(log: str):
    """Registers, spill bytes and stack frame of each kernel in a ptxas
    log."""
    out = []
    for m in re.finditer(r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
                         r"(\d+) bytes spill stores, (\d+) bytes spill loads", log):
        out.append({"kernel": m.group(1)[-40:], "stack": int(m.group(2)),
                    "spill_st": int(m.group(3)), "spill_ld": int(m.group(4))})
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    smem = [int(s) for s in re.findall(r"(\d+) bytes smem", log)]
    return {"functions": out, "registers": regs, "static_smem": smem}


def ring_block(net, params, device, eps_value):
    """A prebuilt ring-launch block at NUM_ENVS envs for the net of
    ``NETS[net]``: bf16 ring of 2E columns, read 0, write E. Returns
    (block, buffers to keep alive)."""
    agent = DQN(NETS[net], params, device=device)
    st = agent.init_state(torch.Generator().manual_seed(0))
    chain = fused_tick.flatten_net_params(st.params, agent.net_spec)
    state = core.reset_batch(rng.PRNGKey(1).to(device), params, NUM_ENVS)
    obs_dim = fused_tick.obs_rows(params)
    ring = torch.zeros((obs_dim, 2 * NUM_ENVS), dtype=torch.bfloat16,
                       device=device)
    ring[:, :NUM_ENVS] = core.observe_batch(state, params, 1).reshape(
        NUM_ENVS, obs_dim).t().to(torch.bfloat16)
    eps = torch.tensor(eps_value, device=device)
    tstate = fused_tick.to_tstate(state)
    block, outs = fused_tick._kernel_args(
        rng.PRNGKey(7), tstate, ring, 0, NUM_ENVS, chain, eps, False, params)
    return block, (outs, ring, eps, st, tstate, chain)


def time_launches(launch, block) -> float:
    """ms per launch of ``launch`` on the prebuilt argument ``block``
    (CUDA events over LAUNCHES launches, after one checked launch)."""
    stream = torch.cuda.current_stream().cuda_stream
    err = launch(ctypes.byref(block), stream)
    torch.cuda.synchronize()
    if err != 0:
        raise SystemExit(f"launch failed: {err}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        launch(ctypes.byref(block), stream)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gen", choices=sorted(PATCHES), default="warp")
    ap.add_argument("--src", default=_build.CSRC,
                    help="the kernel sources to copy and patch")
    ap.add_argument("--out", default=os.path.join(_build.BUILD_DIR, "ablation"))
    ap.add_argument("--variants", nargs="*", default=None)
    ap.add_argument("--nets", nargs="*", choices=sorted(NETS),
                    default=["16x16", "128x64"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    params = EnvParams(grid_size=9, n_drones=4, window_radius=3)
    widths = {}
    for net in args.nets:
        agent = DQN(NETS[net], params, device="cpu")
        widths[net] = fused_tick.chain_widths(fused_tick.flatten_net_params(
            agent.init_state(torch.Generator()).params, agent.net_spec))
    variants = args.variants or list(PATCHES[args.gen])

    # Build every (variant, net) library at once, one nvcc each.
    procs = {}
    for v in variants:
        src = os.path.join(args.out, args.gen, v, "csrc")
        make_variant(args.src, src, PATCHES[args.gen][v], args.gen)
        for hidden in args.nets:
            defines = _build.tick_defines(params, widths[hidden])
            lib = os.path.join(args.out, args.gen, v, f"lib_{hidden}.so")
            cmd = ([_build.nvcc_path(), _build.ARCH, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
                   + [f"-D{k}={val}" for k, val in defines]
                   + ["-o", lib, os.path.join(src, "full_tick.cu")])
            procs[(v, hidden)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(path)
        lib.full_tick_ring_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.full_tick_ring_launch.restype = ctypes.c_int
        lib.full_tick_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.full_tick_blocks_per_sm.restype = ctypes.c_int
        libs[key] = lib
        ptxas[key] = ptxas_summary(log)

    rows = []
    for hidden in args.nets:
        greedy = ring_block(hidden, params, device, 0.0)
        random_ = ring_block(hidden, params, device, 1.0)
        order = [("base", greedy)] + [(v, greedy) for v in variants if v != "base"] + [
            ("base", random_), ("base", greedy)]
        for v, (block, _keep) in order:
            if v not in variants:
                continue
            lib = libs[(v, hidden)]
            ms = time_launches(lib.full_tick_ring_launch, block)
            eps = float(_keep[2])
            row = {"gen": args.gen, "net": hidden, "variant": v, "eps": eps,
                   "ms": ms, "blocks_per_sm": lib.full_tick_blocks_per_sm(1),
                   "ptxas": ptxas[(v, hidden)]}
            rows.append(row)
            print(f"{args.gen} net {hidden} {v:12s} eps {eps:.0f}: {ms:.4f} ms/launch "
                  f"({LAUNCHES} launches of one block), blocks/SM "
                  f"{row['blocks_per_sm']}, registers {row['ptxas']['registers']}, "
                  f"spills {[(f['spill_st'], f['stack']) for f in row['ptxas']['functions']]}",
                  flush=True)
    print(f"card: {card}")
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
