"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each library is one ``.cu`` file with a plain C interface (it may include
the shared headers ``csrc/*.cuh``), compiled for
``sm_90a`` into ``lammps_buck_intel_tpu_torch/_build/`` at first use.
The file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing library.  No
PyTorch header is included: a build takes seconds, not minutes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-lineinfo", "-Xptxas", "-v"]
# library -> extra nvcc flags.  The rebin, the integrator, the constraint
# solves, the neighbor list and the barostat passes are compiled without
# FMA contraction so their wrap, cell, distance, update and solve
# arithmetic rounds like the plain torch version; no library uses
# --use_fast_math.
LIBRARIES = {
    "cellpair": [],
    "rebin": ["--fmad=false"],
    "pppm": [],
    "bonded": [],
    "verlet": ["--fmad=false"],
    "shake": ["--fmad=false"],
    "nlist": ["--fmad=false"],
    "npt": ["--fmad=false"],
}

_loaded: dict[str, ctypes.CDLL] = {}
# library -> (seconds spent building, path of the nvcc log)
build_info: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ[k], "bin", "nvcc")
             for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(_ARCH + _FLAGS + LIBRARIES[name]).encode())
    # the source and every shared header (csrc/*.cuh) it may include
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name``; cached per process."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    log = so[:-3] + ".log"
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ([_nvcc()] + _ARCH + _FLAGS + LIBRARIES[name]
               + ["-o", tmp, os.path.join(CSRC, f"{name}.cu")])
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        with open(log, "w") as f:
            f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for csrc/{name}.cu (log {log}):\n"
                f"{res.stderr[-4000:]}")
        os.replace(tmp, so)
        build_info[name] = (time.perf_counter() - t0, log)
    else:
        build_info.setdefault(name, (0.0, log))
    lib = ctypes.CDLL(so)
    _loaded[name] = lib
    return lib


def load_all() -> dict[str, ctypes.CDLL]:
    """Build and load every library, one nvcc per source, all started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        return dict(zip(LIBRARIES, ex.map(load, LIBRARIES)))
