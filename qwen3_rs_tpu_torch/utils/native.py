"""The port's C++ host helper: the BPE encoder and the loader's transpose.

The port of the reference package's ``utils/native.py``, with the same C
interface: ``csrc/bpe_tokenizer.cpp`` (the tokenizer's encode, the
reference's semantics with hash lookups) and ``csrc/host_io.cpp`` (the
cache-blocked, multithreaded transpose of the loader, row-major ``[out, in]``
codes to the in-major compute layout) compile with the host C++ compiler
into one library at first use, ``lib<LIB_NAME>-<hash>.so`` in the kernels'
build directory (``ops.kernels.build.BUILD_DIR``), the hash over the sources
and the flags.  Concurrent first uses (test workers, ranks) each build to a
file of their own and install it by an atomic rename.

No C++ compiler: ``load_library()`` returns None and every caller takes its
numpy or Python path.  A compiler whose build fails raises with its output.
``CALLS`` counts the library's calls (encodes and transposes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("bpe_tokenizer.cpp", "host_io.cpp")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-pthread")
LIB_NAME = "host_helper"

CALLS: dict[str, int] = {"encode": 0, "transpose": 0}
_lib = None  # the loaded library; False once found unavailable


def compiler() -> str | None:
    return shutil.which("g++") or shutil.which("clang++")


def lib_path() -> Path:
    """Where the library of the current sources and flags lives."""
    from ..ops.kernels import build

    h = hashlib.sha256(b"".join((CSRC / s).read_bytes() for s in SOURCES) + " ".join(CXX_FLAGS).encode())
    return Path(build.BUILD_DIR) / f"lib{LIB_NAME}-{h.hexdigest()[:12]}.so"


def build_library(cxx: str) -> Path:
    """Compile the library unless it exists; raises with the compiler's
    output if the build fails."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host helper build failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    tmp.replace(out)
    return out


def load_library():
    """Load (building on demand) the host helper library, or None when no
    C++ compiler is present."""
    global _lib
    if _lib is not None:
        return _lib or None
    path = lib_path()
    if not path.exists():
        cxx = compiler()
        if cxx is None:
            _lib = False
            return None
        build_library(cxx)
    lib = ctypes.CDLL(str(path))
    lib.bpe_new.restype = ctypes.c_void_p
    lib.bpe_new.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_encode.restype = ctypes.c_int32
    lib.bpe_encode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32,
    ]
    for name in ("transpose_i8", "transpose_f32"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int32]
    _lib = lib
    return lib


def native_transpose(src: np.ndarray, n_threads: int = 0):
    """Batched last-two-axes transpose ``[..., R, C]`` → ``[..., C, R]``
    (a new contiguous array) through the C++ blocked, multithreaded kernel;
    None when the library is unavailable or the array is not int8 or f32 of
    two axes or more, so that callers fall back to numpy."""
    lib = load_library()
    if lib is None or src.ndim < 2:
        return None
    if src.dtype == np.int8:
        fn = lib.transpose_i8
    elif src.dtype == np.float32:
        fn = lib.transpose_f32
    else:
        return None
    src = np.ascontiguousarray(src)
    *lead, rows, cols = src.shape
    batch = int(np.prod(lead)) if lead else 1
    dst = np.empty((*lead, cols, rows), dtype=src.dtype)
    CALLS["transpose"] += 1
    fn(src.ctypes.data_as(ctypes.c_void_p), dst.ctypes.data_as(ctypes.c_void_p), batch, rows, cols, n_threads)
    return dst


class NativeBpeEncoder:
    """The C++ BPE encoder, with the Python encoder's semantics
    (``inference.tokenizer.Tokenizer._encode_py``)."""

    def __init__(self, vocab: list[bytes], merge_scores: list[float], max_token_length: int):
        lib = load_library()
        if lib is None:
            raise ImportError("native host library unavailable")
        self._lib = lib
        n = len(vocab)
        self._tokens = (ctypes.c_char_p * n)(*vocab)
        self._lens = (ctypes.c_uint32 * n)(*[len(t) for t in vocab])
        self._scores = (ctypes.c_float * n)(*merge_scores)
        self._handle = lib.bpe_new(self._tokens, self._lens, self._scores, n, max_token_length)
        if not self._handle:
            raise ImportError("bpe_new failed")

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        cap = max(len(text) + 16, 64)
        out = (ctypes.c_uint32 * cap)()
        CALLS["encode"] += 1
        n = self._lib.bpe_encode(self._handle, data, len(data), out, cap)
        if n < 0:
            raise RuntimeError("bpe_encode failed")
        return list(out[:n])

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bpe_free(self._handle)
            self._handle = None
