"""Live terminal waterfall: the interactive event loop.

The counterpart of ``quadrs_tpu.viz.live``.  The reference ships its
interactivity as desktop GUI loops: the legacy conrod window re-renders on
every button press (``src/ui/mod.rs:87-258``; fft+ doubles the width,
``:140-160``) and the egui window as the sliders move
(``src/eui/mod.rs:118-161``).  A server has no display, so this module
runs that loop in the terminal: spectrogram rows stream as ANSI
truecolour cells while keystrokes retune the STFT mid-stream:

  ``+`` / ``-``   double / halve the FFT width (the fft+/fft- buttons)
  ``]`` / ``[``   double / halve the window stride (stride+/stride-)
  ``q``           quit

The STFT runs on the device through the same
:class:`~quadrs_tpu_torch.runtime.Executor` as the PNG renderers; only the
colour map (the legacy GUI's HSV map, or eui's blue map) runs on the host.
When stdin or stdout is not a TTY (tests, pipes) the loop is still
drivable: ``keys`` injects ``(row_index, key)`` events and ``max_rows``
bounds the run; the terminal's keyboard is never touched then.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from quadrs_tpu_torch.ops.stft import blackman_harris_window, stft_norms
from quadrs_tpu_torch.runtime import Executor
from quadrs_tpu_torch.stream import Stream
from quadrs_tpu_torch.viz.waterfall import _hsv_to_rgb_u8, blue_map


@dataclass
class LiveParams:
    """Starting state of the interactive loop (the GUI's defaults are a
    window too small to read in a terminal, so the CLI's widen)."""

    fft_width: int = 64
    stride: int = 256  # samples between rows
    cols: int | None = None  # terminal cells a row; None = the terminal's width
    max_rows: int | None = None  # stop after N rows; None = to EOF
    batch: int = 64  # windows a device dispatch
    # "rectangular" (the legacy ui STFT) or "blackman-harris" (eui)
    windowing: str = "rectangular"
    # "hsv" (the legacy ui map) or "blue" (eui's blue-channel map)
    colormap: str = "hsv"


class _TtyKeys:
    """Raw-mode non-blocking keyboard on an already-chosen tty fd."""

    def __init__(self, fd: int, file=None):
        import termios

        self.fd = fd
        self._file = file  # an owned /dev/tty handle, closed on exit
        self.saved = termios.tcgetattr(fd)

    def __enter__(self):
        import tty

        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)
        if self._file is not None:
            self._file.close()

    def poll(self) -> list[str]:
        import os
        import select

        out = []
        while select.select([self.fd], [], [], 0)[0]:
            out.append(os.read(self.fd, 1).decode("ascii", errors="ignore"))
        return out


def _try_tty_keys(stream) -> _TtyKeys | None:
    """The keyboard for the interactive loop, or None to run without one.

    stdin when it is the terminal; when stdin carries the capture (``eui
    -live yes -stdin yes``, a live root source) the controlling terminal
    ``/dev/tty``, but only if this process is its foreground group (a
    background job touching the tty would be stopped by SIGTTOU).  Any
    failure on the way (no controlling tty, termios errors) runs without a
    keyboard instead of raising."""
    import os
    import termios

    try:
        if hasattr(sys.stdin, "isatty") and sys.stdin.isatty():
            return _TtyKeys(sys.stdin.fileno())
        if not getattr(stream.root(), "is_live", False):
            # file-backed runs with redirected stdin stay non-interactive
            return None
        f = open("/dev/tty", "rb", buffering=0)
        try:
            if os.tcgetpgrp(f.fileno()) != os.getpgrp():
                f.close()
                return None
            return _TtyKeys(f.fileno(), f)
        except Exception:
            f.close()
            raise
    except (OSError, ValueError, termios.error):
        return None


def _pool_bins(norms: np.ndarray, cols: int) -> np.ndarray:
    """(B, fw) -> (B, cols) by the max over bin groups (keeps peaks visible
    when the FFT is wider than the terminal; repeats bins when narrower)."""
    fw = norms.shape[1]
    if fw == cols:
        return norms
    if fw < cols:
        reps = -(-cols // fw)
        return np.repeat(norms, reps, axis=1)[:, :cols]
    edges = (np.arange(cols) * fw) // cols
    return np.maximum.reduceat(norms, edges, axis=1)


def _row_line(norms_row: np.ndarray, cols: int, colormap: str = "hsv") -> str:
    """One spectrogram row as ANSI background-coloured cells: the legacy
    GUI's HSV map (``src/ui/mod.rs:351-372``) or eui's blue map
    (``src/eui/mod.rs:103-106``)."""
    if colormap == "blue":
        rgb = np.zeros((len(norms_row), 3), dtype=np.uint8)
        rgb[:, 2] = blue_map(norms_row)
    else:
        scaled = np.clip(norms_row / np.float32(2.29), 0.0, 1.0)
        rgb = _hsv_to_rgb_u8(scaled.astype(np.float64)[None, :])[0]
    cells = [f"\x1b[48;2;{r};{g};{b}m " for r, g, b in rgb]
    return "".join(cells) + "\x1b[0m"


def _term_cols(out) -> int:
    try:
        import shutil

        if out is sys.stdout:
            return max(16, shutil.get_terminal_size().columns - 1)
    except (ValueError, OSError):
        pass
    return 80


def live_waterfall(stream: Stream, params: LiveParams | None = None, *, device: torch.device | str, out=None,
                   keys=None) -> dict:
    """Run the interactive loop over ``stream``; returns the exit state
    ``{"rows": N, "fft_width": F, "stride": S}``.

    ``keys``: optional ``(row_index, key)`` pairs, each applied once at
    least ``row_index`` rows are out (the stand-in for the keyboard in
    tests and pipes).  When None and both stdin and ``out`` are TTYs, real
    keystrokes are polled between batches.  Over a file every window must
    come back full; over a live pipe the batch that crosses EOF renders
    its full windows and ends the run (a pipe's length is a sentinel until
    EOF)."""
    p = params or LiveParams()
    out = out if out is not None else sys.stdout
    cols = p.cols if p.cols is not None else _term_cols(out)
    fw, stride = int(p.fft_width), int(p.stride)
    if fw < 2 or stride < 1:
        raise ValueError("fft width must be >= 2 and stride >= 1")

    injected = sorted(keys, key=lambda e: e[0]) if keys is not None else None

    def header():
        out.write(f"-- live fft {fw} stride {stride} --\n")

    pos = 0
    rows = 0
    quit_ = False
    ex = None
    tty_keys = None
    if injected is None and hasattr(out, "isatty") and out.isatty():
        tty_keys = _try_tty_keys(stream)

    def apply(key: str):
        nonlocal fw, stride, ex, quit_
        if key == "q":
            quit_ = True
        elif key == "+" and fw * 2 <= min(8192, stream.length):
            fw *= 2
            ex = None
        elif key == "-" and fw >= 4:
            fw //= 2
            ex = None
        elif key == "]":
            stride *= 2
            header()
        elif key == "[" and stride >= 2:
            stride //= 2
            header()

    try:
        if tty_keys is not None:
            tty_keys.__enter__()
        while not quit_:
            if injected is not None:
                while injected and injected[0][0] <= rows:
                    apply(injected.pop(0)[1])
            elif tty_keys is not None:
                for k in tty_keys.poll():
                    apply(k)
            if quit_:
                break
            if p.max_rows is not None and rows >= p.max_rows:
                break
            avail = stream.length - fw + 1
            if pos >= avail:
                break
            if ex is None:
                window = None
                if p.windowing in ("blackman-harris", "blackmanharris"):
                    window = torch.from_numpy(blackman_harris_window(fw)).to(device)
                ex = Executor(stream, fw, device, batch=p.batch, post=lambda x, w=window: stft_norms(x, window=w))
                header()
            k = min(p.batch, (avail - 1 - pos) // stride + 1)
            if p.max_rows is not None:
                k = min(k, p.max_rows - rows)
            if injected and injected[0][0] > rows:
                # end the batch at the next injected event, so that keys act
                # at their exact row (the TTY path is batch-granular, like
                # the GUI's frame-granular input)
                k = min(k, injected[0][0] - rows)
            offs = pos + stride * np.arange(k, dtype=np.int64)
            norms, valid = ex.run(offs)
            full = valid == fw
            if not np.all(full):
                if not getattr(stream.root(), "is_live", False):
                    raise RuntimeError("read-exact messed up in live render")
                # the batch that crosses a live pipe's EOF carries short
                # trailing windows: render the full ones, then stop
                k = int(np.argmax(~full))
                if k == 0:
                    break
            pooled = _pool_bins(np.asarray(norms)[:k], cols)
            for r in range(k):
                out.write(_row_line(pooled[r], cols, p.colormap) + "\n")
            rows += k
            pos = int(offs[k - 1]) + stride
            if not np.all(full):
                break
    finally:
        if tty_keys is not None:
            tty_keys.__exit__()
    return {"rows": rows, "fft_width": fw, "stride": stride}
