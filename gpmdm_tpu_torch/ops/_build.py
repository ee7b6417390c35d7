"""Build the CUDA kernels with nvcc and bind them with ctypes.

The sources under ``ops/csrc/`` expose plain ``extern "C"`` launchers, so
one ``nvcc`` call builds a shared library in seconds, with no PyTorch
headers and no ninja.  The library lands in
``build/torch_kernels/<sha256 of the sources and flags>/`` at the root of
the checkout: written under a temporary name, then moved into place with
``os.replace``, so concurrent first uses never see half a file and no lock
file is needed.  nvcc's output, including the ``-Xptxas -v`` register and
shared-memory report, goes to stderr.

Variants for measurement come from the same sources with compile-time
``-D`` flags (``library(defines=("GP_SKIP_GEN",))``); each set of flags
builds into its own directory.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from ..utils.profiling import span

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "gp_posterior.cu", _CSRC / "resample_rank.cu", _CSRC / "sgpr_predict.cu")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I = ctypes.c_int
# (restype, argtypes) of each launcher; pointers and the stream are c_void_p
# so that ctypes never cuts a 64-bit address to a 32-bit int.
_SIGNATURES = {
    "gp_plan": (_I, [_I] * 7 + [_P]),
    "gp_posterior_launch": (_I, [_P] * 8 + [_I] * 10 + [_P] * 3),
    "obs_loglik_launch": (_I, [_P] * 9 + [_I] * 7 + [_P] * 3),
    "resample_rank_launch": (_I, [_P] * 2 + [_I] * 2 + [_P]),
    "sgpr_plan": (_I, [_I] * 5 + [_P]),
    "sgpr_predict_launch": (_I, [_P] * 10 + [_I] * 7 + [_P] * 2),
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def build_dir(defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_ROOT / h.hexdigest()


def build(defines: tuple[str, ...] = ()) -> Path:
    """Compile the kernels if this source/flag hash has no library yet;
    ``defines`` are ``NAME=VALUE`` macros for a measurement variant."""
    out_dir = build_dir(defines)
    lib = out_dir / "libgpmdm_kernels.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".build-", suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *_flags(defines), "-o", tmp, *map(str, SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        sys.stderr.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built kernel library, with every launcher's ctypes signature set;
    its build or load runs once a process, in the span ``ops.library``."""
    with span("ops.library"):
        lib = ctypes.CDLL(str(build(defines)))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        return lib
