"""ctypes bindings for the native IO runtime (native/jsonl_loader.cpp, host
C++: an mmap'd jsonl line index and a threaded file prefetcher), the torch
twin of llava_align_tpu/framework/native.py.

The library builds on first use with g++ into `build/native/<hash>/` at
the repository root (listed in .gitignore), keyed by a hash of the source
and flags, so an edited source rebuilds; nothing is written under
`native/`. Every consumer falls back to plain Python when the toolchain is
absent (`load_library` returns None), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
SRC = REPO_ROOT / "native" / "jsonl_loader.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None  # the loaded library, False once a build failed
_lib_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    return REPO_ROOT / "build" / "native" / h / "libjsonl_loader.so"


def _build() -> Optional[Path]:
    """The library, compiled unless already built (into a temporary name,
    then renamed: builds running at once each finish whole); None without
    g++ or the source."""
    try:
        out = library_path()
    except OSError:
        return None
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC), "-lpthread"], check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def load_library():
    """Returns the ctypes lib or None when unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        so = _build()
        if so is None:
            _lib = False
            return None
        lib = ctypes.CDLL(str(so))
        lib.jsonl_open.restype = ctypes.c_void_p
        lib.jsonl_open.argtypes = [ctypes.c_char_p]
        lib.jsonl_num_lines.restype = ctypes.c_int64
        lib.jsonl_num_lines.argtypes = [ctypes.c_void_p]
        lib.jsonl_get_line.restype = ctypes.c_int64
        lib.jsonl_get_line.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.jsonl_close.argtypes = [ctypes.c_void_p]
        lib.prefetcher_create.restype = ctypes.c_void_p
        lib.prefetcher_create.argtypes = [ctypes.c_int]
        lib.prefetcher_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
        lib.prefetcher_wait_size.restype = ctypes.c_int64
        lib.prefetcher_wait_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.prefetcher_take.restype = ctypes.c_int64
        lib.prefetcher_take.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeJsonl:
    """Indexed jsonl reader: O(1) random line access over an mmap, no Python
    materialization of the file."""

    def __init__(self, path: str):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native loader unavailable (g++ missing?)")
        self._lib = lib
        self._h = lib.jsonl_open(os.path.expanduser(path).encode())
        if not self._h:
            raise FileNotFoundError(path)

    def __len__(self) -> int:
        return int(self._lib.jsonl_num_lines(self._h))

    def line(self, i: int) -> bytes:
        buf = ctypes.create_string_buffer(1 << 16)
        n = self._lib.jsonl_get_line(self._h, i, buf, len(buf))
        if n < 0:  # buffer too small: -n is the needed size (-1: no such line)
            buf = ctypes.create_string_buffer(-n)
            n = self._lib.jsonl_get_line(self._h, i, buf, len(buf))
        if n < 0:
            raise IndexError(i)
        return buf.raw[:n]

    def __getitem__(self, i: int):
        import json

        return json.loads(self.line(i))

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._h:
            self._lib.jsonl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativePrefetcher:
    """Background-thread file reader: submit paths, take bytes by ticket."""

    def __init__(self, num_threads: int = 4):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._h = lib.prefetcher_create(num_threads)
        self._next = 0

    def submit(self, path: str) -> int:
        t = self._next
        self._next += 1
        self._lib.prefetcher_submit(self._h, t, os.path.expanduser(path).encode())
        return t

    def take(self, ticket: int) -> bytes:
        size = self._lib.prefetcher_wait_size(self._h, ticket)
        buf = ctypes.create_string_buffer(max(int(size), 1))
        n = self._lib.prefetcher_take(self._h, ticket, buf, len(buf))
        if n < 0:
            raise KeyError(ticket)
        return buf.raw[:n]

    def close(self):
        if self._h:
            self._lib.prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
