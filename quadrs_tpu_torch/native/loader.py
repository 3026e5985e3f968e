"""Build and bind the capture loader (``loader.cc``).

The counterpart of ``quadrs_tpu.native.loader``.  The library is compiled
with g++ at first use into ``build/quadrs_tpu_torch/`` of the checkout
(git-ignored), named by a hash of the source, the flags and the CPU it is
built for (``-march=native``: a library is never carried to another
machine), and bound with ``ctypes.CDLL``, which releases the interpreter
lock for the length of every call: reads and copies overlap Python's
launch work.  Nothing here runs at import.

Unlike the JAX package's binding there is no numpy fallback: a build or
load that fails raises with the compiler's output.  Every read lands in
memory the caller owns; with ``out=`` that can be a page-locked slot.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import tempfile
import threading
import time

import numpy as np

from quadrs_tpu_torch.formats import FileFormat

_SRC = pathlib.Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "quadrs_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# (restype, argtypes) of each entry point of loader.cc
_SIGNATURES = {
    "qt_open": (_P, [ctypes.c_char_p, ctypes.c_int]),
    "qt_samples": (_I64, [_P]),
    "qt_read_planes": (_I64, [_P, _I64, _I64, _P, _P]),
    "qt_close": (None, [_P]),
    "qt_prefetch_start": (_P, [_P, _I64, ctypes.c_int, _I64, _I64, ctypes.c_int]),
    "qt_prefetch_lend": (ctypes.c_int, [_P, _P, _P]),
    "qt_prefetch_next": (_I64, [_P, ctypes.POINTER(_I64)]),
    "qt_prefetch_stop": (None, [_P]),
}


class LoaderLibrary:
    """The loaded library, with what its build took."""

    def __init__(self, path: pathlib.Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        try:
            self.lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"the capture loader at {path} does not load: {e}") from e
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.restype, fn.argtypes = restype, argtypes


def _cpu_id() -> str:
    """What ``-march=native`` depends on: the machine type and the CPU's
    feature flags (Linux), else the platform's processor string."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith(("flags", "Features"))), "")
    except OSError:
        flags = platform.processor()
    return platform.machine() + flags


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_id().encode())
    h.update(_SRC.read_bytes())
    return h.hexdigest()[:16]


def _build(out: pathlib.Path) -> float:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = str(pathlib.Path(tmp) / "loader.so")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(_SRC), "-o", so]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"cannot build the capture loader: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"cannot build the capture loader ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        # rename into place: a concurrent process never loads a half-written library
        os.replace(so, out)
    return time.perf_counter() - t0


_lock = threading.Lock()
_loaded: LoaderLibrary | None = None


def library() -> LoaderLibrary:
    """Build (if needed) and load the loader; raises on a failed build."""
    global _loaded
    with _lock:
        if _loaded is None:
            out = BUILD_DIR / f"libquadrs_loader_{_digest()}.so"
            seconds = _build(out) if not out.exists() else 0.0
            _loaded = LoaderLibrary(out, seconds)
        return _loaded


def _plane_pointers(out: np.ndarray, fmt: FileFormat, n: int) -> tuple[int, int]:
    """The addresses of the two rows of ``out``, checked to be a writable
    (2, >= n) array of the format's dtype whose rows are contiguous."""
    if (
        out.ndim != 2 or out.shape[0] != 2 or out.shape[1] < n or out.dtype != fmt.raw_dtype
        or not out.flags.writeable or (out.shape[1] > 1 and out.strides[1] != out.itemsize)
    ):
        raise ValueError(
            f"out must be a writable (2, >= {n}) {fmt.raw_dtype} array with contiguous rows, "
            f"got {out.dtype} {out.shape} strides {out.strides}"
        )
    return out[0].ctypes.data, out[1].ctypes.data


class NativeCapture:
    """A capture file opened through the loader."""

    def __init__(self, path: str | os.PathLike, fmt: FileFormat):
        self._lib = library().lib
        self.fmt = fmt
        self.path = str(path)
        self._h = self._lib.qt_open(self.path.encode(), fmt.type_bytes)
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.length = int(self._lib.qt_samples(self._h))

    def read_planes(self, off: int, n: int, out: np.ndarray | None = None) -> np.ndarray:
        """(2, n) native-dtype planes for samples [off, off+n), zero-padded
        past EOF.  ``out``: a writable (2, >= n) array with contiguous rows
        to read into (a page-locked slot, a row pair of a bank buffer); its
        first ``n`` columns are returned."""
        if off < 0 or n < 0:
            raise ValueError(f"read_planes({off}, {n}): negative offset or count")
        if out is None:
            out = np.empty((2, n), dtype=self.fmt.raw_dtype)
        re, im = _plane_pointers(out, self.fmt, n)
        got = self._lib.qt_read_planes(self._h, off, n, re, im)
        if got < 0:
            raise OSError(f"read failed at {off} of {self.path}")
        out = out[:, :n]
        out[:, got:] = 0
        return out

    def prefetch(
        self,
        chunk_samples: int,
        n_buffers: int = 4,
        start_off: int = 0,
        overlap: int = 0,
        n_workers: int = 2,
        out=None,
    ):
        """Iterate (offset, (2, n) planes) chunks with background readahead.

        ``n_workers`` reader threads pread and deinterleave in parallel,
        straight into the arrays the chunks are delivered in, which are
        lent to them ``n_buffers - 1`` chunks ahead; delivery is in stream
        order.  With ``overlap``, each chunk also carries the next
        ``overlap`` samples of the stream (re-read from the following
        chunk's head), so consumers that need filter lookahead get it
        without stitching.  Offsets advance by ``chunk_samples``.

        ``out``: a callable that gives, in stream order, the writable (2,
        >= chunk_samples + overlap) array each chunk is read into (the next
        free page-locked slot; it may block until one is free, as long as
        ``n_buffers - 1`` of them can be held at once); by default each
        chunk gets a new array.  Columns past the delivered count keep what
        the array held.
        """
        if chunk_samples < 1 or start_off < 0 or overlap < 0:
            raise ValueError("prefetch: chunk_samples must be positive, start_off and overlap non-negative")
        width = chunk_samples + overlap
        ahead = max(1, n_buffers - 1)
        ph = self._lib.qt_prefetch_start(self._h, chunk_samples, ahead, start_off, overlap, n_workers)
        if not ph:
            raise RuntimeError("the capture loader refused to start its prefetcher")
        lent: collections.deque[np.ndarray] = collections.deque()  # keeps each lent array alive

        def lend() -> None:
            buf = np.empty((2, width), dtype=self.fmt.raw_dtype) if out is None else out()
            re, im = _plane_pointers(buf, self.fmt, width)
            if self._lib.qt_prefetch_lend(ph, re, im) != 0:
                raise RuntimeError("the capture loader has no room for another buffer")
            lent.append(buf)

        try:
            for _ in range(ahead):
                lend()
            while True:
                off = ctypes.c_int64()
                got = self._lib.qt_prefetch_next(ph, ctypes.byref(off))
                if got < 0:
                    raise OSError(f"read failed in the prefetcher of {self.path}")
                if got == 0:
                    return
                yield int(off.value), lent.popleft()[:, :got]
                lend()
        finally:
            # joins the reader threads: nothing writes into a lent array after this
            self._lib.qt_prefetch_stop(ph)

    def close(self) -> None:
        if self._h:
            self._lib.qt_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
