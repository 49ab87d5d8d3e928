"""Build and load the hand-written CUDA kernels from the package's sources.

The kernels are compiled at first use with ``nvcc`` into shared libraries
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). The tick kernel is specialised at compile time on
the env and the Q-net widths (``-D`` constants, as the TPU kernel is
specialised on its static ``EnvParams``), so each configuration is its
own library, cached under ``ops/_build/`` by a hash of the sources and
the ``-D`` set. ``--use_fast_math`` is never passed: the observation's
charge channel divides by 100 and must round as IEEE division does.

A failed build or a missing ``nvcc`` raises; nothing falls back to the
plain PyTorch version.
"""

import ctypes
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
SOURCES = ("full_tick.cu", "threefry.cuh")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
MAX_LAYERS = 8  # as csrc/full_tick.cu

_loaded: Dict[str, ctypes.CDLL] = {}


def tick_defines(params, widths: Sequence[int]) -> Tuple[Tuple[str, str], ...]:
    """The ``-D`` set of the tick kernel for an env and Q-net widths
    (``widths`` = obs_dim, hidden..., num_actions). nvcc splits ``-D``
    values at commas, so every width is a define of its own."""
    return (
        ("DR_GRID", str(params.grid_size)),
        ("DR_NDRONES", str(params.n_drones)),
        ("DR_RADIUS", str(params.window_radius)),
        ("DR_NPACKETS", str(params.num_packets)),
        ("DR_NDROPZONES", str(params.num_dropzones)),
        ("DR_NSTATIONS", str(params.num_stations)),
        ("DR_NSKYSCRAPERS", str(params.num_skyscrapers)),
        ("DR_CHARGE_UP", str(params.charge)),
        ("DR_DISCHARGE", str(params.discharge)),
        ("DR_NLAYERS", str(len(widths) - 1)),
    ) + tuple((f"DR_DIM{i}", str(int(widths[i])) if i < len(widths) else "0")
              for i in range(MAX_LAYERS + 1))


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


@functools.lru_cache(maxsize=None)
def library_path(defines) -> str:
    key = _sources_digest() + repr(tuple(defines)) + ARCH
    tag = hashlib.sha256(key.encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, tag, "libfull_tick.so")


def build_command(defines, out_path: str) -> List[str]:
    return ([nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
            + [f"-D{k}={v}" for k, v in defines]
            + ["-o", out_path, os.path.join(CSRC, "full_tick.cu")])


class _Build:
    """One nvcc process writing a library under a temporary name."""

    def __init__(self, defines):
        self.path = library_path(defines)
        self.tmp = f"{self.path}.{os.getpid()}.tmp"
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            build_command(defines, self.tmp), stdout=subprocess.PIPE,
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


def build(configs: Iterable) -> Dict[str, float]:
    """Build every ``-D`` set in ``configs`` that is not built yet, all
    nvcc processes at once; returns {library path: seconds}."""
    pending = [_Build(d) for d in dict.fromkeys(tuple(c) for c in configs)
               if not os.path.exists(library_path(d))]
    seconds, errors = {}, []
    for b in pending:  # wait for every process before raising
        try:
            seconds[b.path] = b.finish()
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build_log(defines) -> str:
    """nvcc's output (ptxas registers, spills) for a built library."""
    with open(library_path(defines) + ".log") as f:
        return f.read()


def load(defines) -> ctypes.CDLL:
    """The tick kernel's library for one ``-D`` set, built if needed."""
    defines = tuple(defines)
    path = library_path(defines)
    lib = _loaded.get(path)
    if lib is not None:
        return lib
    if not os.path.exists(path):
        build([defines])
    lib = ctypes.CDLL(path)
    lib.full_tick_ring_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.full_tick_ring_launch.restype = ctypes.c_int
    lib.full_tick_error_string.argtypes = [ctypes.c_int]
    lib.full_tick_error_string.restype = ctypes.c_char_p
    _loaded[path] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{err} ({lib.full_tick_error_string(err).decode()})"
