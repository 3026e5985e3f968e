"""Build and load the port's CUDA kernels.

The sources under ``quadrs_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all at once, and
linked into one shared library with a plain C interface, bound with
``ctypes``.  The library lands in
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
from concurrent.futures import ThreadPoolExecutor

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "frontend.cu", _PKG / "csrc" / "waterfall.cu", _PKG / "csrc" / "rowscan.cu")
_HEADERS = (_PKG / "csrc" / "decode.cuh", _PKG / "csrc" / "device.cuh", _PKG / "csrc" / "fft.cuh")
BUILD_DIR = _PKG.parent / "build" / "quadrs_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# the waterfall entry points' shared leading arguments (csrc/waterfall.cu)
_WATERFALL = (_I, _I, _P, _LL, _LL, _I, _LL, _LL, _I, _I, _I, _P, _P, _P)
# the frontend entry points' shared leading arguments (csrc/frontend.cu):
# format, device, re, im, n_ok, bases, cos, sin, taps, decode table, D, m_sub,
# tout, outputs a block, chunk groups, threads, n_out
_FRONTEND = (_I, _I, _P, _P, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL)
# argtypes of each entry point of csrc/*.cu; pointers and the stream must be
# c_void_p, or ctypes passes them as 32-bit ints
_SIGNATURES = {
    "qt_frontend_fir": (*_FRONTEND, _P, _P, _P),
    "qt_frontend_fir_stft": (*_FRONTEND, _P, _P, _I, _P, _P),
    "qt_frontend_banded": (_I, _I, _P, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _P, _P, _P),
    "qt_waterfall_norms": (*_WATERFALL, _P, _P),
    "qt_waterfall_search": (*_WATERFALL, _P, _P, _P),
    "qt_waterfall_scan": (*_WATERFALL, _F, _P, _P, _P),
    # channels, device, x, rows, len, [sub,] tile, scratch..., out, stream (csrc/rowscan.cu)
    "qt_row_sum": (_I, _I, _P, _LL, _LL, _I, _P, _P, _P),
    "qt_row_exclusive_prefix": (_I, _I, _P, _LL, _LL, _P, _I, _P, _P, _P, _P),
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
    for src in (*_SOURCES, *_HEADERS):
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _run(cmd: list[str]) -> str:
    """Run one nvcc command; return its output, raise if it fails."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _build(out: pathlib.Path) -> tuple[str, float]:
    """Compile every source at once, then link them into ``out``; returns
    the build log and seconds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(pathlib.Path(tmp) / f"{src.stem}.o") for src in _SOURCES]
        with ThreadPoolExecutor(len(_SOURCES)) as pool:
            logs = list(pool.map(_run, ([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(src)]
                                        for src, o in zip(_SOURCES, objs))))
        so = str(pathlib.Path(tmp) / "lib.so")
        logs.append(_run([nvcc, *_ARCH, "-shared", "-o", so, *objs]))
        # rename into place: a concurrent process never loads a half-written library
        os.replace(so, out)
    return "".join(logs), time.perf_counter() - t0


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``: the serve daemon's sessions launch
    from several threads at once, and ``+=`` on an attribute is no atomic
    step."""
    with _count_lock:
        wrapper.launches += 1


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises on a failed
    build."""
    global _loaded
    with _lock:
        if _loaded is None:
            out = BUILD_DIR / f"libquadrs_kernels_{_digest()}.so"
            log, seconds = _build(out) if not out.exists() else ("", 0.0)
            _loaded = KernelLibrary(out, log, seconds)
        return _loaded
