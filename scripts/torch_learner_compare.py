"""Time the learner kernel (B2/B6, ``ops/csrc/td_adam.cu``) against variants
of its source, on a card, in one process.

Builds, for the bench nets (16,16) and (128,64):

* ``f64_16``: the source as it is (16 CTAs, dot products summed in
  doubles);
* ``f64_8``: the same on 8 CTAs, the portable cluster size (the source's
  ``CLUSTER`` patched);
* ``f32_16``: 16 CTAs with the dot products summed in f32, as the TPU
  kernels sum them (the source's ``dot_t`` patched);
* ``other_<stem>``, for each ``--other``: another td_adam.cu, for
  example the one-block kernel of an earlier commit, written out with
  ``git show <commit>:dronerl_tpu_torch/ops/csrc/td_adam.cu >
  .archive/td_adam_other.cu``.

Each variant is built with the net's ``-D`` set into its own directory
under the build cache, every ``nvcc`` at once. Per net and batch (the
bench's 8, and 256), it times the learn launch of one prebuilt argument
block (CUDA events over ``LAUNCHES`` launches back to back), every variant
in turns (forward, then backward) and reports the mean of each variant's
turns; a variant that refuses the batch is reported as such. Then an
empty launch of each cluster size (the floor a launch costs). It prints
each library's ptxas lines, one JSON line per net and batch, then the
card's name and power limit. Run from the repository root on a machine
with a CUDA card:

    python scripts/torch_learner_compare.py [--other .archive/td_adam_other.cu ...]
"""

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dronerl_tpu_torch import rng  # noqa: E402
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig  # noqa: E402
from dronerl_tpu_torch.env.types import EnvParams  # noqa: E402
from dronerl_tpu_torch.ops import _build, learner_kernel  # noqa: E402

NETS = ((16, 16), (128, 64))
BATCHES = (8, 256)
LAUNCHES = 200
# name: text patches of the source (old, new), each found exactly once.
VARIANTS = {
    "f64_16": (),
    "f64_8": (("constexpr int CLUSTER = 16;", "constexpr int CLUSTER = 8;"),),
    "f32_16": (("using dot_t = double;", "using dot_t = float;"),),
}


def variant_source(name: str, patches, out_dir: str) -> str:
    """Write the current source with ``patches`` applied into ``out_dir``."""
    with open(os.path.join(_build.CSRC, _build.LEARNER_SOURCE)) as f:
        text = f.read()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"patch text not found once for {name}: {old!r}")
        text = text.replace(old, new)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"td_adam_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def start_build(name: str, source: str, widths):
    """Start nvcc on ``source`` with the net's -D set; returns (name,
    library path, process)."""
    with open(source, "rb") as f:
        tag = hashlib.sha256(f.read() + repr(widths).encode()).hexdigest()
    out_dir = os.path.join(_build.BUILD_DIR, "compare", tag[:16])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"libtd_adam_{name}.so")
    cmd = ([_build.nvcc_path(), _build.ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
           + [f"-D{k}={v}" for k, v in _build.net_defines(widths)]
           + ["-o", path, source])
    return name, path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)


def finish_build(name: str, path: str, proc, widths) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name} {widths}:\n{log}")
    print(f"ptxas {name} {widths}: " + " | ".join(
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln), flush=True)
    lib = ctypes.CDLL(path)
    lib.td_adam_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.td_adam_launch.restype = ctypes.c_int
    if hasattr(lib, "td_adam_empty_launch"):
        lib.td_adam_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.td_adam_empty_launch.restype = ctypes.c_int
    return lib


def cuda_ms(fn, count: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(count):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def learner_block(hidden, bsz, device):
    """A learn launch's argument block on a fresh agent and a random batch
    (obs and next_obs column slices of one (obs_dim, 2B) tensor)."""
    params = EnvParams(grid_size=9, n_drones=4, window_radius=3)
    agent = DQN(DQNConfig(hidden_layers=hidden, gamma=0.9), params,
                device=device)
    st = agent.init_state(rng.PRNGKey(0))
    r = np.random.default_rng(0)
    both = torch.from_numpy(
        (r.random((agent.obs_dim, 2 * bsz)) < 0.3).astype(np.float32))
    batch = {
        "obs": both[:, :bsz].to(device),
        "next_obs": both[:, bsz:].to(device),
        "actions": torch.from_numpy(
            r.integers(0, 5, bsz).astype(np.int32)).to(device),
        "rewards": torch.from_numpy(
            r.choice([-1.0, 0.0, 1.0], bsz).astype(np.float32)).to(device),
        "dones": torch.zeros(bsz, device=device),
    }
    keep = (st, batch)  # the block points into these tensors
    block, loss = learner_kernel._learner_args(
        batch, st.params, st.target_params, st.opt_state.mu,
        st.opt_state.nu, 0, learn=True, sync_target=False, decay_eps=False,
        epsilon=None, gamma=0.9, lr=1e-3, tau=1.0, eps_decay=1.0,
        eps_end=0.0, b1=0.9, b2=0.999, adam_eps=1e-8)
    return block, (keep, loss), agent.obs_dim


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", action="append", default=[],
                   help="another td_adam.cu to time beside them (repeatable)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_learner_compare: needs a CUDA card")
    device = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    src_dir = os.path.join(_build.BUILD_DIR, "compare", "src")
    sources = {name: variant_source(name, patches, src_dir)
               for name, patches in VARIANTS.items()}
    for path in args.other:
        stem = os.path.splitext(os.path.basename(path))[0]
        sources[f"other_{stem}"] = path
    obs_dim = 294  # grid 9, window radius 3
    builds = [start_build(name, src, (obs_dim, *hidden, 5))
              for hidden in NETS for name, src in sources.items()]
    libs = {}
    for (name, path, proc), (hidden, _) in zip(
            builds, [(h, n) for h in NETS for n in sources]):
        libs[hidden, name] = finish_build(name, path, proc,
                                          (obs_dim, *hidden, 5))
    order = list(sources)
    for hidden in NETS:
        for bsz in BATCHES:
            block, _keep, _ = learner_block(hidden, bsz, device)
            turns, refused = {}, {}
            for name in order + order[::-1]:
                lib = libs[hidden, name]
                if name in refused:
                    continue
                err = lib.td_adam_launch(ctypes.byref(block), stream)
                torch.cuda.synchronize()
                if err != 0:
                    refused[name] = err
                    continue
                turns.setdefault(name, []).append(cuda_ms(
                    lambda: lib.td_adam_launch(ctypes.byref(block), stream),
                    LAUNCHES))
            empty = {name: cuda_ms(
                lambda: libs[hidden, name].td_adam_empty_launch(bsz, stream),
                LAUNCHES) for name in ("f64_16", "f64_8")}
            print(json.dumps({
                "net": list(hidden), "batch": bsz, "launches": LAUNCHES,
                **{f"ms_{k}": statistics.mean(v) for k, v in turns.items()},
                "turns": turns,
                "refused": {k: int(v) for k, v in refused.items()},
                **{f"empty_{k}_ms": v for k, v in empty.items()},
                "card": card}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
