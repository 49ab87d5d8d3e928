"""Build and load the hand-written CUDA kernels from the package's sources.

The kernels are compiled at first use with ``nvcc`` into shared libraries
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). A library is one source compiled with one ``-D``
set: a *config* is the pair ``(source, defines)``. The full tick kernel
(``full_tick.cu``, the ring and obs launches) is specialised on the env
and the Q-net widths, the env-only kernel (``env_kernel.cu``, the
feature-major tick and the row-major step, on the same warp-per-env body
``env_warp.cuh`` and block copies ``env_tile.cuh``) on the env alone, the
learner kernel (``td_adam.cu``) on the widths alone (``-D`` constants, as
the TPU kernels are specialised on their static arguments); the draws
(``draws.cu``: ``rng``'s draws of a CUDA key and the ring's replay
sample) take no ``-D`` and choose their round count at run time, one
library for every engine (:func:`draw_config`). Each config
is cached under ``ops/_build/`` by a hash of the sources, the source name
and the ``-D`` set; one process builds at a time (a lock file there), so
ranks that start together build each library once. ``--use_fast_math``
is never passed: the
observation's charge channel divides by 100 and must round as IEEE
division does, and the learner's Adam step keeps IEEE divides and roots.

A failed build or a missing ``nvcc`` raises; nothing falls back to the
plain PyTorch version.
"""

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
TICK_SOURCE = "full_tick.cu"
ENV_SOURCE = "env_kernel.cu"
LEARNER_SOURCE = "td_adam.cu"
DRAW_SOURCE = "draws.cu"
SOURCES = (TICK_SOURCE, ENV_SOURCE, "env_step.cuh", "env_tile.cuh",
           "env_warp.cuh", "threefry.cuh", LEARNER_SOURCE, DRAW_SOURCE)
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
MAX_LAYERS = 8  # as csrc/full_tick.cu

# Each source's (launch functions, error-string function).
ENTRY_POINTS = {
    TICK_SOURCE: (("full_tick_ring_launch", "full_tick_launch"),
                  "full_tick_error_string"),
    ENV_SOURCE: (("tick_launch", "step_launch"), "env_error_string"),
    LEARNER_SOURCE: (("td_adam_launch",), "td_adam_error_string"),
    DRAW_SOURCE: (("draw_launch", "ring_sample_launch"),
                  "draws_error_string"),
}

Defines = Tuple[Tuple[str, str], ...]
Config = Tuple[str, Defines]

_loaded: Dict[str, ctypes.CDLL] = {}


def net_defines(widths: Sequence[int]) -> Defines:
    """The ``-D`` set of the Q-net widths (obs_dim, hidden..., actions).
    nvcc splits ``-D`` values at commas, so every width is a define of
    its own."""
    return (("DR_NLAYERS", str(len(widths) - 1)),) + tuple(
        (f"DR_DIM{i}", str(int(widths[i])) if i < len(widths) else "0")
        for i in range(MAX_LAYERS + 1))


def env_defines(params, collect: int = 1, rng_rounds: int = 20) -> Defines:
    """The ``-D`` set of an env (``env_step.cuh``): ``DR_GLOBAL`` only for
    the global observation, ``DR_COLLECT`` only for ``collect`` > 1 and
    the round count only where it is not 20, so the set of a window build
    that collects one drone at 20 rounds is unchanged."""
    options = (("DR_GLOBAL", "1"),) if params.wrapper == "global" else ()
    options += (("DR_COLLECT", str(collect)),) if collect != 1 else ()
    if rng_rounds != 20:  # threefry.cuh: the env side's hashes
        options += (("DR_RNG_ROUNDS", str(rng_rounds)),)
    return options + (
        ("DR_GRID", str(params.grid_size)),
        ("DR_NDRONES", str(params.n_drones)),
        ("DR_RADIUS", str(params.window_radius)),
        ("DR_NPACKETS", str(params.num_packets)),
        ("DR_NDROPZONES", str(params.num_dropzones)),
        ("DR_NSTATIONS", str(params.num_stations)),
        ("DR_NSKYSCRAPERS", str(params.num_skyscrapers)),
        ("DR_CHARGE_UP", str(params.charge)),
        ("DR_DISCHARGE", str(params.discharge)),
    )


def tick_defines(params, widths: Sequence[int], collect: int = 1,
                 rng_rounds: int = 20, actor_rounds=None) -> Defines:
    """The ``-D`` set of the full tick kernel for an env and Q-net widths
    (``widths`` = obs_dim, hidden..., num_actions), the drones collected
    and the round counts (``actor_rounds``, the actor's uniform field's
    ``DR_ACTOR_ROUNDS``, only where it is given and is not ``rng_rounds``)."""
    actor = (() if actor_rounds in (None, rng_rounds)
             else (("DR_ACTOR_ROUNDS", str(actor_rounds)),))
    return env_defines(params, collect, rng_rounds) + actor + net_defines(
        widths)


def tick_config(params, widths: Sequence[int], collect: int = 1,
                rng_rounds: int = 20, actor_rounds=None) -> Config:
    """The full tick kernel's library (B1 and B3) for an env, Q-net
    widths, the drones collected and the round counts."""
    return (TICK_SOURCE, tick_defines(params, widths, collect, rng_rounds,
                                      actor_rounds))


def env_config(params, collect: int = 1, rng_rounds: int = 20) -> Config:
    """The env kernel's library for an env, the drones collected and the
    round count: the feature-major tick (B4, ``tick_launch``) and the
    row-major step (B5, ``step_launch``, whose wrapper takes the library
    of the drones it observes, one where it observes none, at 20
    rounds: the jnp engine's)."""
    return (ENV_SOURCE, env_defines(params, collect, rng_rounds))


def learner_config(widths: Sequence[int]) -> Config:
    """The learner kernel's library for Q-net widths (no env defines)."""
    return (LEARNER_SOURCE, net_defines(widths))


def draw_config() -> Config:
    """The draw kernel's library (``draw_launch``, ``ring_sample_launch``):
    no ``-D``, every round count instantiated."""
    return (DRAW_SOURCE, ())


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc was not found (set CUDA_HOME); the CUDA "
                       "kernels are built from source at first use")


@functools.lru_cache(maxsize=None)
def _sources_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def _config(config) -> Config:
    source, defines = config
    if source not in ENTRY_POINTS:
        raise ValueError(f"no kernel source {source!r}")
    return source, tuple(tuple(d) for d in defines)


@functools.lru_cache(maxsize=None)
def library_path(config: Config) -> str:
    source, defines = _config(config)
    key = _sources_digest() + source + repr(defines) + ARCH
    tag = hashlib.sha256(key.encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, tag, f"lib{stem}.so")


def build_command(config: Config, out_path: str) -> List[str]:
    source, defines = _config(config)
    return ([nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
            + [f"-D{k}={v}" for k, v in defines]
            + ["-o", out_path, os.path.join(CSRC, source)])


class _Build:
    """One nvcc process writing a library under a temporary name."""

    def __init__(self, config: Config):
        self.path = library_path(config)
        self.tmp = f"{self.path}.{os.getpid()}.tmp"
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            build_command(config, self.tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def finish(self) -> float:
        log, _ = self.proc.communicate()
        seconds = time.perf_counter() - self.t0
        with open(self.path + ".log", "w") as f:
            f.write(log)
        if self.proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({self.proc.returncode}) building "
                f"{self.path}:\n{log}")
        os.replace(self.tmp, self.path)
        return seconds


def build(configs: Iterable[Config]) -> Dict[str, float]:
    """Build every config in ``configs`` that is not built yet, all nvcc
    processes at once; returns {library path: seconds}. Holds the build
    directory's lock meanwhile: another process's wave finishes first, and
    what it built is not built again."""
    configs = [c for c in dict.fromkeys(_config(c) for c in configs)
               if not os.path.exists(library_path(c))]
    if not configs:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        pending = [_Build(c) for c in configs
                   if not os.path.exists(library_path(c))]
        seconds, errors = {}, []
        for b in pending:  # wait for every process before raising
            try:
                seconds[b.path] = b.finish()
            except RuntimeError as err:
                errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build_log(config: Config) -> str:
    """nvcc's output (ptxas registers, spills) for a built library."""
    with open(library_path(config) + ".log") as f:
        return f.read()


def load(config: Config) -> ctypes.CDLL:
    """The library of one config, built if needed. Each launch function
    takes (argument block, stream) and returns a CUDA error code."""
    config = _config(config)
    path = library_path(config)
    lib = _loaded.get(path)
    if lib is not None:
        return lib
    if not os.path.exists(path):
        build([config])
    lib = ctypes.CDLL(path)
    launches, error = ENTRY_POINTS[config[0]]
    for launch in launches:
        getattr(lib, launch).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, launch).restype = ctypes.c_int
    getattr(lib, error).argtypes = [ctypes.c_int]
    getattr(lib, error).restype = ctypes.c_char_p
    lib.error_string = getattr(lib, error)
    _loaded[path] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{err} ({lib.error_string(err).decode()})"
