"""Build and load the port's CUDA kernels.

The sources under ``quadrs_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, and bound with ``ctypes``.  The library lands in
``build/quadrs_tpu_torch/`` of the checkout (git-ignored), named by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import: the
CPU-only test lanes import every module of the port.

The flags leave out ``--use_fast_math`` on purpose: the decode's
divisions must be IEEE and ``cosf``/``sinf`` the accurate ones.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "frontend.cu",)
BUILD_DIR = _PKG.parent / "build" / "quadrs_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# argtypes of each entry point of csrc/frontend.cu; pointers and the stream
# must be c_void_p, or ctypes passes them as 32-bit ints
_SIGNATURES = {
    "qt_frontend_fir": (
        _I, _I, _P, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P, _P, _P,
    ),
    "qt_frontend_fir_stft": (
        _I, _I, _P, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P, _P, _I, _P, _P,
    ),
}


class KernelLibrary:
    """The loaded kernel library, with what its build printed."""

    def __init__(self, path: pathlib.Path, build_log: str, build_seconds: float):
        self.path = path
        self.build_log = build_log
        self.build_seconds = build_seconds
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        self._lib.qt_error_string.argtypes = [ctypes.c_int]
        self._lib.qt_error_string.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        """Call an entry point; raise with CUDA's message when it returns
        a non-zero ``cudaError_t`` (a refused or failed launch)."""
        code = getattr(self._lib, name)(*args)
        if code != 0:
            msg = self._lib.qt_error_string(code).decode()
            raise RuntimeError(f"{name} failed: CUDA error {code}: {msg}")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels")
    nvcc = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}: cannot build the kernels")
    return str(nvcc)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises on a failed
    build.  Concurrent processes each compile to a temporary name and
    rename into place, so a half-written library is never loaded."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        out = BUILD_DIR / f"libquadrs_frontend_{_digest()}.so"
        log, seconds = "", 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _SOURCES)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                seconds = time.perf_counter() - t0
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
                    )
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        _loaded = KernelLibrary(out, log, seconds)
        return _loaded
