"""The plain reference of the benchmark's FSK chains, written from the
semantics of upstream quadrs (FauxFaux/quadrs: ``src/samples.rs``,
``src/shift.rs``, ``src/filter.rs``, ``src/fft.rs``) and of the
conditioning stages as this repository's README documents them.

It imports nothing of the measured program.  Every table (taps, NCO
phases, DFT matrix, glyph levels) is worked out here again from the
configuration's parameters.

Semantics:

* cs8 decode: ``int8 / 127`` for I and Q, interleaved I, Q.
* shift ``f``: sample ``m`` (absolute index) times ``exp(j 2 pi f m / sr)``.
* lowpass ``F -power P -decimate D``: ``N = 2P`` Blackman-windowed sinc
  taps at cutoff ``F / sr``, normalised to unit sum; a read of ``n``
  outputs at ``off`` pulls ``n D + N`` inputs at ``off D`` and gives
  ``y[i] = sum_j x[i D + ceil(N/2) + j] h[j]``, with inputs past the
  read's valid count taken as zero (upstream's per-read truncation).
  Its length over-reports: ``1 + (L - N) // D``.
* dcblock ``W``: ``y[m] = x[m] - mean(x[max(0, m-W+1) .. m])``; agc
  ``W``: ``y[m] = x[m] target / max(rms[m], target / max_gain)``, ``rms``
  over the same trailing window; each re-reads its lookback in one read of
  ``n + W - 1`` inputs from the clamped start.
* sparkfft ``-width W -stride S``: windows at ``0, S, 2S, .. < len - W``,
  one read of ``W`` each; rustfft's forward DFT, fftshifted magnitudes;
  nine glyph levels between ``lo`` and ``hi``.
* stream: the same shift and FIR over the whole capture at once (the
  filter sees the true continuation; zeros past the end), the decimated
  stream cut into adjacent windows of ``W``.

Precision: ``f64`` is the reference.  ``f32`` computes every step in
float32; ``tf32`` is ``f32`` with the operands of each product that a
matrix multiplication would carry (the FIR and the DFT) rounded to TF32's
10-bit mantissa, as a GPU's TF32 path rounds them: the benchmark's
control (one precision below the configuration's float32 with TF32 off).
"""

from __future__ import annotations

import math

import torch

PRECISIONS = ("f64", "f32", "tf32")

# upstream src/fft.rs:34-36: blank below lo, full block at or above hi
GLYPHS = (" ", "▁", "▂", "▃", "▄", "▅", "▆", "▇", "█")
FRAME = "│"


def real_dtype(prec: str) -> torch.dtype:
    if prec not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {prec!r}")
    return torch.float64 if prec == "f64" else torch.float32


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _operand(t: torch.Tensor, prec: str) -> torch.Tensor:
    return tf32_round(t) if prec == "tf32" else t


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` in the precision's arithmetic: float64; float32 with TF32
    off; or float32 accumulation over TF32-rounded operands."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _operand(a, prec) @ _operand(b, prec)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# -- tables -------------------------------------------------------------------


def lowpass_taps(freq: int, sample_rate: int, size: int, prec: str = "f64", device="cpu") -> torch.Tensor:
    """Blackman-windowed sinc at cutoff ``freq / sample_rate``, unit sum
    (upstream src/filter.rs:86-105, 126-128), in float64 then cast."""
    c = freq / sample_rate
    i = torch.arange(size, dtype=torch.float64, device=device)
    x = 2.0 * c * (i - (size - 1) / 2.0)
    sinc = torch.where(x == 0, torch.ones_like(x), torch.sin(math.pi * x) / (math.pi * torch.where(x == 0, 1.0, x)))
    t = 2.0 * math.pi * i / (size - 1)
    h = sinc * (0.42 - 0.5 * torch.cos(t) + 0.08 * torch.cos(2.0 * t))
    return (h / h.sum()).to(real_dtype(prec))


def dft_matrix(width: int, prec: str, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward DFT's real and imaginary parts, ``exp(-j 2 pi k n / W)``,
    from exact integer phases."""
    k = torch.arange(width, dtype=torch.int64, device=device)
    ang = (k[:, None] * k[None, :] % width).to(torch.float64) * (2.0 * math.pi / width)
    dt = real_dtype(prec)
    return torch.cos(ang).to(dt), (-torch.sin(ang)).to(dt)


def nco(index: torch.Tensor, freq: int, sample_rate: int, prec: str) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of ``2 pi f m / sr`` at absolute int64 indices ``m``,
    the angle reduced exactly in integers first."""
    frac = (index % sample_rate) * (freq % sample_rate) % sample_rate
    ang = frac.to(torch.float64) * (2.0 * math.pi / sample_rate)
    if prec != "f64":
        ang = ang.to(torch.float32)
    return torch.cos(ang), torch.sin(ang)


# -- the capture --------------------------------------------------------------


class Capture:
    """Interleaved cs8 bytes (a 1-D uint8 tensor), read at any absolute
    sample index; ``length`` samples; indices past it read zero.
    ``loop``: the bytes repeat (a live pipe fed from a looped capture)
    up to ``length``."""

    def __init__(self, data: torch.Tensor, length: int | None = None, loop: bool = False):
        self.data = data
        self.period = data.numel() // 2
        self.length = self.period if length is None else int(length)
        self.loop = loop
        if not loop and self.length > self.period:
            raise ValueError("a capture that does not loop cannot be longer than its bytes")

    def gather(self, index: torch.Tensor, prec: str) -> tuple[torch.Tensor, torch.Tensor]:
        """Decoded (re, im) at int64 indices of any shape; zero outside
        ``[0, length)``."""
        ok = (index >= 0) & (index < self.length)
        src = index % self.period if self.loop else index.clamp(0, self.period - 1)
        raw = self.data.view(torch.int8)
        dt = real_dtype(prec)
        re = raw[2 * src].to(dt) / 127.0
        im = raw[2 * src + 1].to(dt) / 127.0
        zero = torch.zeros((), dtype=dt, device=re.device)
        return torch.where(ok, re, zero), torch.where(ok, im, zero)


# -- the chain's stages as reads ---------------------------------------------


class Chain:
    """A configuration's chain (``cfg["chain"]``) as pull reads over a
    :class:`Capture`: ``read(off, n)`` gives each row's ``(re, im, valid)``
    for a batch of offsets, as the upstream ``read_at`` recursion would."""

    def __init__(self, cfg: dict, capture: Capture, prec: str = "f64"):
        self.cfg = cfg
        self.capture = capture
        self.prec = prec
        self.device = capture.data.device
        self.sample_rate = int(cfg["sample_rate"])
        self.stages = [dict(s) for s in cfg["chain"]]
        self._taps = {}

    def taps(self, st: dict, rate: int) -> torch.Tensor:
        key = (st["freq"], rate, 2 * st["power"])
        if key not in self._taps:
            self._taps[key] = lowpass_taps(st["freq"], rate, 2 * st["power"], self.prec, self.device)
        return self._taps[key]

    def length(self, depth: int | None = None) -> int:
        """Upstream's ``len()`` of the chain's output (LowPass over-reports)."""
        n = self.capture.length
        for st in self.stages[:depth]:
            if st["stage"] == "lowpass":
                n = 1 + (n - 2 * st["power"]) // st["decimate"]
        return n

    def rate(self, depth: int) -> int:
        r = self.sample_rate
        for st in self.stages[:depth]:
            if st["stage"] == "lowpass":
                r //= st["decimate"]
        return r

    def read(self, off: torch.Tensor, n: int, depth: int | None = None):
        """Rows ``[off_b, off_b + n)`` of the output of the first ``depth``
        stages (all by default): ``(re, im, valid)``, ``(B, n)`` each and
        ``(B,)`` int64 valid counts; entries past ``valid`` are zero."""
        depth = len(self.stages) if depth is None else depth
        if depth == 0:
            idx = off[:, None] + torch.arange(n, device=off.device)[None, :]
            re, im = self.capture.gather(idx, self.prec)
            valid = (self.capture.length - off).clamp(0, n)
            return re, im, valid
        st = self.stages[depth - 1]
        kind = st["stage"]
        if kind == "shift":
            re, im, valid = self.read(off, n, depth - 1)
            m = off[:, None] + torch.arange(n, device=off.device)[None, :]
            c, s = nco(m, int(st["freq"]), self.rate(depth - 1), self.prec)
            return re * c - im * s, re * s + im * c, valid
        if kind == "lowpass":
            return self._lowpass(st, off, n, depth)
        if kind in ("dcblock", "agc"):
            return self._trailing(st, off, n, depth)
        raise ValueError(f"unknown stage {kind!r}")

    def _lowpass(self, st: dict, off: torch.Tensor, n: int, depth: int):
        d = int(st["decimate"])
        size = 2 * int(st["power"])
        n_in = n * d + size
        re, im, valid_in = self.read(off * d, n_in, depth - 1)
        keep = torch.arange(n_in, device=off.device)[None, :] < valid_in[:, None]
        re, im = re * keep, im * keep  # the read's truncated block
        h = self.taps(st, self.rate(depth - 1))
        c = size - size // 2
        pad = (n - 1) * d + c + size - n_in
        if pad > 0:
            re = torch.nn.functional.pad(re, (0, pad))
            im = torch.nn.functional.pad(im, (0, pad))
        yr = fir_frames(re[:, c:], h, d, n, self.prec)
        yi = fir_frames(im[:, c:], h, d, n, self.prec)
        return yr, yi, (valid_in - size).clamp(min=0) // d

    def _trailing(self, st: dict, off: torch.Tensor, n: int, depth: int):
        w = int(st["window"])
        off_in = (off - (w - 1)).clamp(min=0)
        lead = off - off_in
        re, im, valid_in = self.read(off_in, n + w - 1, depth - 1)
        k = torch.arange(n, device=off.device)[None, :]
        p = lead[:, None] + k  # each output's own input in the block
        m = off[:, None] + k  # its absolute index
        count = torch.clamp(m + 1, max=w).to(re.dtype)
        if st["stage"] == "dcblock":
            mr = trailing_sum(re, p, w) / count
            mi = trailing_sum(im, p, w) / count
            yr = torch.gather(re, 1, p) - mr
            yi = torch.gather(im, 1, p) - mi
        else:
            target, max_gain = float(st.get("target", 1.0)), float(st.get("max_gain", 1000.0))
            rms = torch.sqrt(torch.clamp(trailing_sum(re * re + im * im, p, w), min=0.0) / count)
            g = target / torch.clamp(rms, min=target / max_gain)
            yr = torch.gather(re, 1, p) * g
            yi = torch.gather(im, 1, p) * g
        valid = (valid_in - lead).clamp(0, n)
        keep = k < valid[:, None]
        return yr * keep, yi * keep, valid


def fir_frames(x: torch.Tensor, h: torch.Tensor, d: int, n: int, prec: str) -> torch.Tensor:
    """``y[b, i] = sum_j x[b, i d + j] h[j]`` for ``i < n``."""
    frames = x.unfold(1, h.numel(), d)[:, :n, :]
    return matmul(frames, h[:, None], prec)[..., 0]


def trailing_sum(v: torch.Tensor, p: torch.Tensor, w: int) -> torch.Tensor:
    """Each position ``p``'s sum of ``v`` over ``(p - w, p]`` within its
    row (clamped at the row's start), by an inclusive running sum."""
    cs = torch.nn.functional.pad(torch.cumsum(v, dim=1), (1, 0))
    return torch.gather(cs, 1, p + 1) - torch.gather(cs, 1, (p + 1 - w).clamp(min=0))


def spectra(re: torch.Tensor, im: torch.Tensor, prec: str) -> torch.Tensor:
    """fftshifted DFT magnitudes of each row of width ``W``."""
    width = re.shape[-1]
    cr, ci = dft_matrix(width, prec, re.device)
    fr = matmul(re, cr, prec) - matmul(im, ci, prec)
    fi = matmul(re, ci, prec) + matmul(im, cr, prec)
    mag = torch.sqrt(fr * fr + fi * fi)
    half = width // 2
    return torch.cat([mag[..., half:], mag[..., :half]], dim=-1)


# -- the commands' outputs ----------------------------------------------------


def sparkfft_rows(cfg: dict, capture: Capture) -> int:
    """How many rows ``sparkfft`` prints over the chain's output."""
    chain = Chain(cfg, capture)
    sink = cfg["sink"]
    length = chain.length()
    return max(0, -(-(length - sink["width"]) // sink["stride"]))


def sparkfft_norms(cfg: dict, capture: Capture, rows: torch.Tensor, prec: str = "f64") -> torch.Tensor:
    """The fftshifted magnitudes behind ``sparkfft`` rows ``rows``: each
    row one read of ``width`` chain outputs at ``row * stride``."""
    chain = Chain(cfg, capture, prec)
    sink = cfg["sink"]
    re, im, valid = chain.read(rows.to(torch.int64) * sink["stride"], sink["width"])
    if bool((valid != sink["width"]).any()):
        raise ValueError("a sparkfft row reads past the end of the chain")
    return spectra(re, im, prec)


def _lowpass_all(cfg: dict, capture: Capture, n_out: int, prec: str, block: int = 1 << 16):
    """shift then lowpass over the whole capture as one read: decimated
    outputs ``[0, n_out)``, zeros past the capture's end."""
    st = {s["stage"]: s for s in cfg["chain"][:2]}
    lp, sr = st["lowpass"], int(cfg["sample_rate"])
    d, size = int(lp["decimate"]), 2 * int(lp["power"])
    c = size - size // 2
    dev = capture.data.device
    h = lowpass_taps(int(lp["freq"]), sr, size, prec, dev)
    parts_r, parts_i = [], []
    for k0 in range(0, n_out, block):
        nb = min(block, n_out - k0)
        idx = k0 * d + c + torch.arange((nb - 1) * d + size, device=dev)
        re, im = capture.gather(idx, prec)
        cs, sn = nco(idx, int(st["shift"]["freq"]), sr, prec)
        re, im = re * cs - im * sn, re * sn + im * cs
        parts_r.append(fir_frames(re[None], h, d, nb, prec)[0])
        parts_i.append(fir_frames(im[None], h, d, nb, prec)[0])
    return torch.cat(parts_r), torch.cat(parts_i)


def _window_sums(v: torch.Tensor, m: torch.Tensor, w: int) -> torch.Tensor:
    """Sum of ``v`` over ``[max(0, m - w + 1), m]`` for positions ``m``."""
    cs = torch.nn.functional.pad(torch.cumsum(v, 0), (1, 0))
    return cs[m + 1] - cs[(m + 1 - w).clamp(min=0)]


def _agc(st: dict) -> tuple[float, float]:
    target = float(st.get("target", 1.0))
    return target, target / float(st.get("max_gain", 1000.0))


def sparkfft_all(cfg: dict, capture: Capture, prec: str = "f64", block: int = 8192) -> torch.Tensor:
    """Every ``sparkfft`` row of a chain ``shift, lowpass[, dcblock][, agc]``
    at once, equal to :func:`sparkfft_norms` over all rows: each stage
    computed once over the whole stream, then, row by row, the outputs that
    the row's one lowpass read truncates at its end (and what the trailing
    stages derive from them) put in their place."""
    kinds = [s["stage"] for s in cfg["chain"]]
    if kinds[:2] != ["shift", "lowpass"] or any(k not in ("dcblock", "agc") for k in kinds[2:]):
        raise ValueError(f"sparkfft_all takes shift, lowpass and trailing stages, not {kinds}")
    chain = Chain(cfg, capture, prec)
    dev = capture.data.device
    lp = cfg["chain"][1]
    d, size = int(lp["decimate"]), 2 * int(lp["power"])
    c = size - size // 2
    sink = cfg["sink"]
    width, stride = int(sink["width"]), int(sink["stride"])
    n_lp = chain.length(2)
    rows = max(0, -(-(chain.length() - width) // stride))
    off = torch.arange(rows, device=dev, dtype=torch.int64) * stride
    # each row's lowpass read (s, n), walking the trailing stages down
    s, n = off.clone(), width
    for st in reversed(cfg["chain"][2:]):
        s, n = (s - (int(st["window"]) - 1)).clamp(min=0), n + int(st["window"]) - 1
    if rows and int(((s + n) * d + size).max()) > capture.length:
        raise ValueError("a row's read runs past the capture")
    # outputs i of a read of n that some tap of falls past the read's end
    t = sum(1 for i in range(max(0, n - size), n) if i * d + c > n * d)
    xr, xi = _lowpass_all(cfg, capture, n_lp, prec)
    h = lowpass_taps(int(lp["freq"]), int(cfg["sample_rate"]), size, prec, dev)
    q = torch.arange(t, device=dev)
    j = torch.arange(size, device=dev)
    keep = (j[None, :] < ((t - q) * d + size - c)[:, None]).to(xr.dtype)  # (t, size) taps each keeps
    shift = cfg["chain"][0]
    # each stage's output over the whole stream, as one read would give it
    streams = [(xr, xi)]
    for st in cfg["chain"][2:]:
        cur_r, cur_i = streams[-1]
        w = int(st["window"])
        pos = torch.arange(cur_r.numel(), device=dev)
        cnt = torch.clamp(pos + 1, max=w).to(xr.dtype)
        if st["stage"] == "dcblock":
            streams.append((cur_r - _window_sums(cur_r, pos, w) / cnt, cur_i - _window_sums(cur_i, pos, w) / cnt))
        else:
            target, floor = _agc(st)
            p = _window_sums(cur_r * cur_r + cur_i * cur_i, pos, w)
            g = target / torch.clamp(torch.sqrt(torch.clamp(p, min=0.0) / cnt), min=floor)
            streams.append((cur_r * g, cur_i * g))
    out = []
    for r0 in range(0, rows, block):
        o, sb = off[r0 : r0 + block], s[r0 : r0 + block]
        T = sb + n - t  # (B,) first truncated position
        k = T[:, None] + q[None, :]  # (B, t) absolute decimated positions
        idx = k[:, :, None] * d + c + j[None, None, :]
        re, im = capture.gather(idx, prec)
        cs, sn = nco(idx, int(shift["freq"]), int(cfg["sample_rate"]), prec)
        re, im = re * cs - im * sn, re * sn + im * cs
        hk = h[None, :] * keep  # (t, size)
        tr = (_operand(re, prec) * _operand(hk, prec)[None]).sum(-1)
        ti = (_operand(im, prec) * _operand(hk, prec)[None]).sum(-1)
        # the read's own values at k, stage by stage: the stream's window
        # sums there, less the stream's values, plus the read's
        m = o[:, None] + torch.arange(width, device=dev)[None, :]
        fix_r, fix_i = tr, ti
        for (cur_r, cur_i), st in zip(streams, cfg["chain"][2:]):
            w = int(st["window"])
            cnt_k = torch.clamp(k + 1, max=w).to(xr.dtype)
            base_r, base_i = cur_r[k], cur_i[k]
            if st["stage"] == "dcblock":
                f_r = fix_r - (_window_sums(cur_r, k, w) + torch.cumsum(fix_r - base_r, 1)) / cnt_k
                f_i = fix_i - (_window_sums(cur_i, k, w) + torch.cumsum(fix_i - base_i, 1)) / cnt_k
            else:
                target, floor = _agc(st)
                p = cur_r * cur_r + cur_i * cur_i
                dp = torch.cumsum(fix_r * fix_r + fix_i * fix_i - base_r * base_r - base_i * base_i, 1)
                pk = torch.clamp(_window_sums(p, k, w) + dp, min=0.0)
                gk = target / torch.clamp(torch.sqrt(pk / cnt_k), min=floor)
                f_r, f_i = fix_r * gk, fix_i * gk
            fix_r, fix_i = f_r, f_i
        cur_r, cur_i = streams[-1]
        yr, yi = cur_r[m], cur_i[m]
        # put the read's own values where the row holds a truncated position
        col = k - o[:, None]
        ok = col < width
        rr = torch.arange(len(o), device=dev)[:, None].expand_as(col)
        yr[rr[ok], col[ok]] = fix_r[ok]
        yi[rr[ok], col[ok]] = fix_i[ok]
        out.append(spectra(yr, yi, prec))
    return torch.cat(out) if out else torch.zeros((0, width), dtype=real_dtype(prec), device=dev)


def stream_norms(cfg: dict, capture: Capture, windows: torch.Tensor, prec: str = "f64") -> torch.Tensor:
    """``stream``'s rows ``windows``: window ``w`` is decimated outputs
    ``[w W, (w + 1) W)`` of shift and FIR over the whole capture."""
    shift = next(s for s in cfg["chain"] if s["stage"] == "shift")
    lp = next(s for s in cfg["chain"] if s["stage"] == "lowpass")
    d, size, width = int(lp["decimate"]), 2 * int(lp["power"]), int(cfg["sink"]["width"])
    c = size - size // 2
    sr = int(cfg["sample_rate"])
    n_in = (width - 1) * d + size
    idx = (windows.to(torch.int64) * width * d + c)[:, None] + torch.arange(n_in, device=windows.device)[None, :]
    re, im = capture.gather(idx, prec)
    cs, sn = nco(idx, int(shift["freq"]), sr, prec)
    re, im = re * cs - im * sn, re * sn + im * cs
    h = lowpass_taps(int(lp["freq"]), sr, size, prec, windows.device)
    return spectra(fir_frames(re, h, d, width, prec), fir_frames(im, h, d, width, prec), prec)


def glyph_levels(norms: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Upstream src/fft.rs:45-61: 0 below ``lo``, 8 at or above ``hi``,
    else ``1 + floor((v - lo) / ((hi - lo) / 7))`` capped at 7."""
    d = (hi - lo) / 7.0
    mid = torch.clamp(torch.floor((norms.to(torch.float64) - lo) / d), 0, 6).to(torch.int64) + 1
    mid = torch.where(norms < lo, torch.zeros_like(mid), mid)
    return torch.where(norms >= hi, torch.full_like(mid, 8), mid)


def glyph_row(levels) -> str:
    return FRAME + "".join(GLYPHS[int(v)] for v in levels) + FRAME


def level_gap(norms: torch.Tensor, levels: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """How far each reference magnitude lies outside the interval of the
    level printed for it, in units of one level's width ``(hi - lo) / 7``:
    0 where the printed level holds the reference's value."""
    d = (hi - lo) / 7.0
    v = norms.to(torch.float64)
    g = levels.to(torch.float64)
    low = torch.where(g == 0, torch.full_like(v, -math.inf), lo + (g - 1) * d)
    high = torch.where(g >= 7, torch.full_like(v, math.inf), lo + g * d)
    high = torch.where(g == 7, torch.full_like(v, hi), high)
    low = torch.where(g == 8, torch.full_like(v, hi), low)
    return (torch.clamp(low - v, min=0) + torch.clamp(v - high, min=0)) / d
