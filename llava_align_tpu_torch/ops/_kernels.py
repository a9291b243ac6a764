"""Build and load the package's CUDA kernels (csrc/*.cu).

The sources compile at first use with nvcc for Hopper (sm_90a), one nvcc
process per source, all started together, and link into one shared library
with a plain C interface, loaded with ctypes. The library
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
# + wq_gemm.cuh and stream_mma.cuh, included
SOURCES = ("int8_mm.cu", "flash_attn.cu", "int4_mm.cu", "repeat2d.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

# the kernels' `dtype` argument
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: name -> argument types (pointers and the stream as void*)
SIGNATURES = {
    # h, q, s, y, work, B, O, D, layer, dtype, stream
    "int8_mm_stacked": (_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _vp),
    # h, q, s, y, work, B, O, D, dtype, stream
    "int8_mm": (_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _vp),
    # B, O, D -> fp32 elements of split-K workspace
    "int8_mm_workspace": (_int, _int, _int),
    # q, k, v, o, B, S, H, K, Dh, dtype, stream
    "flash_attn_causal": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _vp),
    # h, q4, gs, y, work, B, O, D, layer, dtype, stream
    "int4_mm_stacked": (_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _vp),
    # B, O, D -> fp32 elements of split-K workspace
    "int4_mm_workspace": (_int, _int, _int),
    # h, p, s, y, B, O, D, layer, mode (0 per-channel, 1 group 128), stream
    "int4_rowmajor_mm_stacked": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _vp),
    # h, w, y, B, O, D, layer, stream
    "bf16_mm_stacked": (_vp, _vp, _vp, _int, _int, _int, _int, _vp),
    # format (0 int8, 1 int4, 2 bf16), B, O, D -> blocks per channel tile of
    # the tensor-core streaming kernel's split plan
    "stream_mma_splits": (_int, _int, _int, _int),
    # x, y, ld, rows, cols, r0, c0, mode_r, n_r, mode_c, n_c, scale, stream
    "repeat2d": (_vp, _vp, _i64, _int, _int, _int, _int, _int, _int, _int, _int, _f32, _vp),
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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_root() / _source_hash() / "libllava_kernels.so"


def build() -> Path:
    """Compile csrc/ into the hashed build directory unless already there:
    one nvcc per source in parallel, then one link."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in SOURCES:
        obj = out.parent / f"{Path(src).stem}.{tag}.o"
        cmd = [nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    log, failed = [], []
    for cmd, obj, proc in jobs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text}")
    tmp = out.with_suffix(f".{tag}")
    if not failed:
        cmd = [nvcc(), *LINK_FLAGS, "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    (out.parent / "build.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on t's device, where a
    kernel launches (cheaper than torch.cuda.current_stream(...).cuda_stream,
    which builds a Stream object: at a few rows the wrapper's host time is
    a share of the call)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")
