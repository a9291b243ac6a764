"""Build and load the package's CUDA kernels (csrc/*.cu).

The sources compile at first use with nvcc for Hopper (sm_90a) into one
shared library with a plain C interface, loaded with ctypes. The library
lands in `build/kernels/<hash>/` at the repository root (listed in
.gitignore), keyed by a hash of the sources and flags, so an edit rebuilds
and an unchanged tree reuses the last build; `rm -rf build/kernels` forces a
rebuild. nvcc's output, including the registers and shared memory that
`-Xptxas -v` reports for each kernel, is kept beside the library as
`build.log`.

Nothing here runs at import: nvcc runs only when a wrapper first meets a
CUDA tensor, so the modules import on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("int8_mm.cu", "flash_attn.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the kernels' `dtype` argument
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argument types (pointers and the stream as void*)
SIGNATURES = {
    # h, q, s, y, B, O, D, layer, dtype, stream
    "int8_mm_stacked": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _vp),
    # h, q, s, y, B, O, D, dtype, stream
    "int8_mm": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _vp),
    # q, k, v, o, B, S, H, K, Dh, dtype, stream
    "flash_attn_causal": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _vp),
}

_lib: Optional[ctypes.CDLL] = None  # the process's one loaded library
build_seconds: Optional[float] = None  # wall time of this process's nvcc run


def build_root() -> Path:
    return CSRC.parent.parent / "build" / "kernels"


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_root() / _source_hash() / "libllava_kernels.so"


def build() -> Path:
    """Compile csrc/ into the hashed build directory unless already there."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")
