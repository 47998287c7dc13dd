"""Build and load the port's CUDA kernels (nvcc into a plain-C shared library).

The sources under ``csrc/`` are compiled for Hopper (``sm_90a``) at first use,
one nvcc process per source, all started together, then linked into
``dealii_asm_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and
flags, and loaded with ``ctypes``.  A later process with the same sources
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
SOURCES = ("banded_laplace.cu", "fdm_patch.cu", "lanes_laplace.cu",
           "merged_laplace.cu", "smoother_step.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "libdealii_asm_kernels.so"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_P = ctypes.c_void_p
_I = ctypes.c_int

# argument types of every extern "C" entry (pointers and the stream as void*)
_BANDED = [_P, _P, _P] + [_P] * 6 + [_I] * 5 + [_P]
_FDM = [_P, _P, _P] + [_P] * 12 + [_I] * 4
_STEP = [_P, _P, _P, _P] + [_P] * 6 + [_P] * 12 + [_I] * 4
_MERGED = [_P] * 6 + [_I] * 5 + [_P]
_LANES = [_P] * 9 + [_I] * 4 + [_P]
SIGNATURES = {
    "dat_banded_laplace_f32": _BANDED,
    "dat_banded_laplace_f64": _BANDED,
    "dat_fdm_patch_f32": _FDM + [ctypes.c_float, _I, _P],
    "dat_fdm_patch_f64": _FDM + [ctypes.c_double, _I, _P],
    "dat_lanes_laplace_f32": _LANES,
    "dat_lanes_laplace_f64": _LANES,
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


def _nvcc_all(nvcc: str, work: Path, verbose: bool) -> None:
    """Compile every source to an object file, one nvcc per source, all
    started together; raise with the compiler output of any that fails."""
    extra = ["--ptxas-options=-v"] if verbose else []
    procs = []
    for s in SOURCES:
        log = open(work / f"{s}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-I", str(CSRC),
               "-o", str(work / f"{s}.o"), str(CSRC / s)]
        procs.append((s, log, subprocess.Popen(cmd, stdout=log,
                                               stderr=subprocess.STDOUT)))
    failed = []
    for s, log, proc in procs:
        rc = proc.wait()
        log.close()
        text = (work / f"{s}.log").read_text()
        if rc != 0:
            failed.append(f"{s} ({rc}):\n{text}")
        elif verbose:
            print(text)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global last_build_seconds
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    try:
        _nvcc_all(nvcc, work, verbose)
        tmp = work / LIB_NAME
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *[str(work / f"{s}.o") for s in SOURCES]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent process sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0
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
