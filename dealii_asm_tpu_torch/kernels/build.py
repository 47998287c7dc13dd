"""Build and load the port's CUDA kernels (nvcc into a plain-C shared library).

The sources under ``csrc/`` are compiled for Hopper (``sm_90a``) at first use
into ``dealii_asm_tpu_torch/_build/<hash>/``, keyed by a hash of the sources
and flags, and loaded with ``ctypes``.  A later process with the same sources
reuses the library.  No fallback: a missing ``nvcc`` or a failed compile
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("banded_laplace.cu", "fdm_patch.cu", "merged_laplace.cu",
           "smoother_step.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
LIB_NAME = "libdealii_asm_kernels.so"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_P = ctypes.c_void_p
_I = ctypes.c_int

# argument types of every extern "C" entry (pointers and the stream as void*)
_BANDED = [_P, _P, _P] + [_P] * 6 + [_I] * 5 + [_P]
_FDM = [_P, _P, _P] + [_P] * 12 + [_I] * 4
_STEP = [_P, _P, _P, _P] + [_P] * 6 + [_P] * 12 + [_I] * 4
_MERGED = [_P] * 6 + [_I] * 5 + [_P]
SIGNATURES = {
    "dat_banded_laplace_f32": _BANDED,
    "dat_banded_laplace_f64": _BANDED,
    "dat_fdm_patch_f32": _FDM + [ctypes.c_float, _I, _P],
    "dat_fdm_patch_f64": _FDM + [ctypes.c_double, _I, _P],
    "dat_merged_laplace_f32": _MERGED,
    "dat_merged_laplace_f64": _MERGED,
    "dat_smoother_step_f32": _STEP + [ctypes.c_float, _P],
    "dat_smoother_step_f64": _STEP + [ctypes.c_double, _P],
}

_loaded: ctypes.CDLL | None = None
last_build_seconds: float | None = None


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of dealii_asm_tpu_torch "
        "are compiled with nvcc for sm_90a on the machine with the GPU")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global last_build_seconds
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *[str(CSRC / s) for s in SOURCES]]
    if verbose:
        cmd.insert(1, "--ptxas-options=-v")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent process sees all or nothing
    return lib


def load(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _loaded
    if _loaded is None:
        lib = ctypes.CDLL(str(build(verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded = lib
    return _loaded


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
