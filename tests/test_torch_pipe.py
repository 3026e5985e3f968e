"""Live pipe input in the port (``PipeSource``, ``RawRing``,
``LivePipeStream``, ``burst_spans``, ``BurstGate``, the runners' pipe
chunking, ``stream|waterfall|scan -stdin`` and ``stream -trigger``)
against quadrs_tpu's originals on the CPU.

The contracts: rows, peaks and survey tables from a pipe are bit-equal to
the file run over the same bytes (same window floor, same EOF tail, same
absolute-offset NCO phases; only the length is discovered at EOF); burst
files have the same names and bytes as the file run's and as the JAX
package's; ``BurstGate.feed`` over any split of the flags equals
``burst_spans`` over the whole; a pipe that ends mid-pair drops the
partial pair.  Tests feed a ``BytesIO``, a dribbling reader or an
``os.pipe()``; inputs are made with numpy from a seed."""

import glob
import io
import os
import pathlib
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import cli as jcli  # noqa: E402
from quadrs_tpu import sources as jsources  # noqa: E402
from quadrs_tpu import stream_runner as jrunner  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat, planes_from_bytes  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402
from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel  # noqa: E402
from quadrs_tpu_torch.sources import LivePipeStream, PipeSource, RawRing, SampleSource  # noqa: E402
from quadrs_tpu_torch.stream_runner import BurstGate, StreamRunner, WaterfallRunner, burst_spans  # noqa: E402


def capture_bytes(n_samples: int, fmt=FileFormat.COMPLEX_INT8, seed=7) -> bytes:
    rng = np.random.default_rng(seed)
    if fmt is FileFormat.COMPLEX_FLOAT32:
        return rng.normal(scale=0.3, size=2 * n_samples).astype("<f4").tobytes()
    return rng.integers(0, 256, n_samples * fmt.pair_bytes, dtype=np.int64).astype(np.uint8).tobytes()


class Dribble(io.RawIOBase):
    """A reader that returns at most ``k`` bytes per read call: pipes
    deliver arbitrary boundaries, not sample-aligned ones."""

    def __init__(self, data: bytes, k: int):
        self._data, self._pos, self._k = data, 0, k

    def read(self, n=-1):
        if self._pos >= len(self._data):
            return b""
        n = len(self._data) if n is None or n < 0 else n
        take = min(n, self._k, len(self._data) - self._pos)
        out = self._data[self._pos : self._pos + take]
        self._pos += take
        return out


def os_pipe_reader(data: bytes):
    """The read end of a real ``os.pipe()`` that a thread feeds ``data``."""
    r, w = os.pipe()

    def feed():
        with os.fdopen(w, "wb") as f:
            f.write(data)

    threading.Thread(target=feed, daemon=True).start()
    return os.fdopen(r, "rb", buffering=0)


@pytest.mark.parametrize("fmt", ["cs8", "cs16", "cu8", "cf32"])
def test_pipe_planes_match_the_original(fmt):
    """Reads at hostile (3-byte) boundaries reassemble the planes of a
    one-shot deinterleave and of the JAX package's ``PipeSource``; the
    trailing partial pair drops."""
    f = FileFormat(fmt)
    data = capture_bytes(501, f) + b"\x55"  # 501 samples and a partial pair
    want = planes_from_bytes(np.frombuffer(data, dtype=np.uint8), f)
    src = PipeSource(Dribble(data, 3), f, 48_000)
    jsrc = jsources.PipeSource(Dribble(data, 3), JFormat(fmt), 48_000)
    parts = []
    while True:
        p = src.read_planes(97)
        jp = jsrc.read_planes(97)
        assert p.dtype == jp.dtype and p.tobytes() == jp.tobytes()
        if p.shape[1] == 0:
            break
        parts.append(p)
    got = np.concatenate(parts, axis=1)
    assert got.shape == want.shape == (2, 501) and got.tobytes() == want.tobytes()
    assert src.eof and src.length is None and src.is_pipe and src.native is None
    with pytest.raises(ValueError, match="positive"):
        PipeSource(io.BytesIO(b""), f, 0)


def test_pipe_waits_on_a_source_that_has_no_data_yet():
    """A non-blocking source signals "no data yet" with None: not EOF."""
    class Gappy(Dribble):
        gaps = 3

        def read(self, n=-1):
            if self.gaps and self._pos == 4:
                self.gaps -= 1
                return None
            return super().read(n)

    data = capture_bytes(50)
    src = PipeSource(Gappy(data, 4), FileFormat.COMPLEX_INT8, 1000)
    assert src.read_planes(50).tobytes() == planes_from_bytes(np.frombuffer(data, np.uint8), FileFormat.COMPLEX_INT8).tobytes()


def test_raw_ring_matches_the_original():
    for ring in (RawRing(pair_bytes=2, cap_bytes=64), jsources.RawRing(pair_bytes=2, cap_bytes=64)):
        ring.append(bytes(range(10)))  # samples 0..4
        ring.append(bytes(range(10, 20)))  # samples 5..9
        ring.append(b"")
        assert ring.end == 10
        assert ring.slice(2, 5) == bytes(range(4, 10))
        ring.prune(3)
        assert ring.base == 3 and ring.end == 10
        assert ring.slice(3, 10) == bytes(range(6, 20))
        assert ring.slice(8, 99) == bytes(range(16, 20))  # clipped at the end
        assert ring.slice(9, 9) == b""
        with pytest.raises(ValueError, match="pruned"):
            ring.slice(2, 5)
        ring.prune(1)  # below the base: nothing to drop
        assert ring.base == 3
        with pytest.raises(ValueError, match="exceeds"):
            ring.append(bytes(80))


def test_raw_ring_under_two_threads():
    """The staging thread appends while the consumer slices and prunes:
    every slice is the stream's own bytes, nothing is lost."""
    ring = RawRing(pair_bytes=2, cap_bytes=1 << 20)
    data = capture_bytes(40_000)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def feed():
            for i in range(0, len(data), 200):
                ring.append(data[i : i + 200])

        t = threading.Thread(target=feed)
        t.start()
        pos = 0
        while pos < 40_000:
            end = ring.end
            if end > pos:
                assert ring.slice(pos, end) == data[2 * pos : 2 * end]
                ring.prune(end)
                pos = end
        t.join(timeout=30)
        assert not t.is_alive() and ring.base == ring.end == 40_000
    finally:
        sys.setswitchinterval(old)


def test_burst_spans_matches_the_original():
    cases = [
        ([], 0, 0), ([False, False], 0, 0), ([True, True, False], 0, 0), ([False, True, False, False, True], 0, 0),
        ([False, True, False, False, True, False], 1, 1), ([False, True] + [False] * 5 + [True, False], 1, 1),
        ([True, False, False], 3, 0),
    ]
    want = [[], [], [(0, 1)], [(1, 1), (4, 4)], [(0, 5)], [(0, 2), (6, 8)], [(0, 0)]]
    for (active, pre, post), w in zip(cases, want):
        assert burst_spans(active, pre, post) == w == jrunner.burst_spans(active, pre, post)


def test_burst_gate_streams_exactly():
    """``BurstGate`` fed any activity mask in ragged pieces yields exactly
    ``burst_spans`` of the whole, runs that end at feed edges included, and
    what the JAX package's gate yields feed by feed; what it still needs
    never lies past a span it later returns."""
    rng = np.random.default_rng(77)
    for _ in range(300):
        n = int(rng.integers(1, 160))
        active = rng.random(n) < rng.uniform(0.05, 0.6)
        pre, post = int(rng.integers(0, 4)), int(rng.integers(0, 4))
        gate, jgate = BurstGate(pre, post), jrunner.BurstGate(pre, post)
        got = []
        i = 0
        while i < n:
            sz = int(rng.integers(1, 20))
            needed = gate.earliest_needed()
            new = gate.feed(active[i : i + sz])
            assert new == jgate.feed(active[i : i + sz])
            assert gate.earliest_needed() == jgate.earliest_needed()
            assert all(lo >= needed for lo, _ in new)
            got += new
            i += sz
        assert gate.feed([]) == []
        got += gate.finish(n)
        assert got == burst_spans(active, pre, post) == jrunner.burst_spans(active, pre, post), (pre, post, active)


def stream_model(fmt) -> PipelineModel:
    return PipelineModel(PipelineConfig(
        sample_rate=48_000, shift_freq=1_000, lp_freq=8_000, decimate=4, taps=40, fft_width=32, fmt=fmt,
    ))


def collect(run, **kw):
    rows = []
    stats = run(lambda w0, out: rows.append((w0, out)), **kw)
    return rows, stats


def assert_same_rows(got, want):
    assert len(got) == len(want)
    for (gw, g), (ww, w) in zip(got, want):
        assert gw == ww
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("reader", ["bytesio", "os.pipe"])
@pytest.mark.parametrize("n_samples", [40_000, 39_781])
def test_pipe_runner_matches_file(n_samples, reader):
    """A multi-chunk pipe run equals the in-memory file run bit for bit,
    on chunk-aligned and ragged capture lengths."""
    fmt = FileFormat.COMPLEX_INT8
    data = capture_bytes(n_samples, fmt)
    model = stream_model(fmt)
    chunk = 10_000  # rounds down to a whole number of 128-sample windows
    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows, fstats = collect(StreamRunner(fsrc, model, "cpu", chunk_samples=chunk).run)
    f = io.BytesIO(data) if reader == "bytesio" else os_pipe_reader(data)
    prows, pstats = collect(StreamRunner(PipeSource(f, fmt, 48_000), model, "cpu", chunk_samples=chunk).run)
    assert len(prows) > 1
    assert_same_rows(prows, frows)
    assert (pstats.samples_in, pstats.windows_out) == (fstats.samples_in, fstats.windows_out)


@pytest.mark.parametrize("frontend", ["auto", "chain"])
def test_pipe_runner_search_and_scan_match_file(frontend):
    fmt = FileFormat.COMPLEX_INT16
    data = capture_bytes(30_011, fmt)
    model = stream_model(fmt)

    def runner(src):
        return StreamRunner(src, model, "cpu", chunk_samples=8_000, frontend=frontend)

    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows, _ = collect(runner(fsrc).run_search)
    prows, _ = collect(runner(PipeSource(io.BytesIO(data), fmt, 48_000)).run_search)
    assert len(prows) > 1
    assert_same_rows(prows, frows)
    fscan = runner(fsrc).run_scan(threshold=1.0)
    pscan = runner(PipeSource(Dribble(data, 777), fmt, 48_000)).run_scan(threshold=1.0)
    assert pscan.windows == fscan.windows > 0
    for name in ("sum_norms", "max_norms", "above"):
        assert getattr(pscan, name).tobytes() == getattr(fscan, name).tobytes()


def test_pipe_resume_drains_to_exact_offset():
    """``start_window`` on a pipe drains the skipped samples; the rows that
    follow are those of a full file run (absolute-offset phases)."""
    fmt = FileFormat.COMPLEX_INT8
    data = capture_bytes(25_000, fmt)
    model = stream_model(fmt)
    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows, _ = collect(StreamRunner(fsrc, model, "cpu", chunk_samples=8_000).run)
    full = np.concatenate([n for _, n in frows])
    start = frows[1][0]  # the second chunk's first window
    prows, _ = collect(StreamRunner(PipeSource(io.BytesIO(data), fmt, 48_000), model, "cpu", chunk_samples=8_000).run,
                       start_window=start)
    assert prows[0][0] == start
    assert np.concatenate([n for _, n in prows]).tobytes() == full[start:].tobytes()
    bounded, st = collect(StreamRunner(PipeSource(io.BytesIO(data), fmt, 48_000), model, "cpu", chunk_samples=8_000).run,
                          max_chunks=1)
    assert len(bounded) == 1 and bounded[0][1].tobytes() == frows[0][1].tobytes()


def test_pipe_short_capture_emits_nothing():
    fmt = FileFormat.COMPLEX_INT8
    model = stream_model(fmt)
    for n in (0, 10, 100):
        rows, stats = collect(StreamRunner(PipeSource(io.BytesIO(capture_bytes(n, fmt)), fmt, 48_000), model, "cpu").run)
        assert rows == [] and stats.windows_out == 0


def test_pipe_fuzz_random_boundaries_and_chunks():
    """Hostile read boundaries, random lengths and chunk sizes, every
    format: the pipe run stays bit-identical to the file run."""
    rng = np.random.default_rng(31)
    fmts = list(FileFormat)
    for trial in range(6):
        fmt = fmts[trial % len(fmts)]
        n = int(rng.integers(5_000, 30_000))
        k = int(rng.integers(1, 4096))  # dribble size
        chunk = int(rng.integers(2_000, 12_000))
        data = capture_bytes(n, fmt, seed=100 + trial)
        model = stream_model(fmt)
        fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
        frows, fstats = collect(StreamRunner(fsrc, model, "cpu", chunk_samples=chunk).run)
        prows, pstats = collect(StreamRunner(PipeSource(Dribble(data, k), fmt, 48_000), model, "cpu", chunk_samples=chunk).run)
        assert_same_rows(prows, frows)
        assert (pstats.samples_in, pstats.windows_out) == (fstats.samples_in, fstats.windows_out), (trial, n, k, chunk)


@pytest.mark.parametrize(
    "width,stride,n_samples",
    [
        (128, 64, 20_000),  # overlapped: the width - stride carry between chunks
        (128, 128, 20_011),  # tiled, ragged EOF
        (128, 300, 30_000),  # skipping: gaps between chunks read and discarded
    ],
)
def test_waterfall_pipe_matches_file(width, stride, n_samples):
    fmt = FileFormat.COMPLEX_INT8
    data = capture_bytes(n_samples, fmt, seed=11)
    model = WaterfallModel(WaterfallConfig(n_streams=1, fft_width=width, stride=stride, fmt=fmt))

    def runner(src):
        return WaterfallRunner([src], model, "cpu", chunk_windows=37)

    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows, fstats = collect(runner(fsrc).run)
    prows, pstats = collect(runner(PipeSource(io.BytesIO(data), fmt, 48_000)).run)
    assert len(prows) > 1
    assert_same_rows(prows, frows)
    assert (pstats.samples_in, pstats.windows_out) == (fstats.samples_in, fstats.windows_out)
    fpk, _ = collect(runner(fsrc).run_search)
    ppk, _ = collect(runner(PipeSource(Dribble(data, 999), fmt, 48_000)).run_search)
    assert_same_rows(ppk, fpk)
    fscan = runner(fsrc).run_scan(2.0)
    pscan = runner(PipeSource(io.BytesIO(data), fmt, 48_000)).run_scan(2.0)
    assert pscan.windows == fscan.windows
    assert pscan.sum_norms.tobytes() == fscan.sum_norms.tobytes() and pscan.above.tobytes() == fscan.above.tobytes()

    # the staged chunks are the JAX package's, span for span
    from quadrs_tpu.models.waterfall import WaterfallConfig as JConfig
    from quadrs_tpu.models.waterfall import WaterfallModel as JModel

    jmodel = JModel(JConfig(n_streams=1, fft_width=width, stride=stride, fmt=JFormat.COMPLEX_INT8, frontend="xla"))
    jstaged = jrunner.WaterfallRunner([jsources.PipeSource(io.BytesIO(data), JFormat.COMPLEX_INT8, 48_000)], jmodel,
                                      chunk_windows=37)._staged_chunks_pipe(0)
    staged = runner(PipeSource(io.BytesIO(data), fmt, 48_000))._staged_chunks_pipe(0)
    for (w, n_w, new, planes), (jw, jn_w, jnew, (jplanes,)) in zip(staged, jstaged, strict=True):
        assert (w, n_w, new) == (jw, jn_w, jnew) and planes.tobytes() == jplanes.tobytes()


def test_waterfall_pipe_resume_and_guards():
    fmt = FileFormat.COMPLEX_INT8
    data = capture_bytes(15_000, fmt, seed=12)
    model = WaterfallModel(WaterfallConfig(n_streams=1, fft_width=128, stride=64, fmt=fmt))
    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows, _ = collect(WaterfallRunner([fsrc], model, "cpu", chunk_windows=50).run)
    start = frows[1][0]
    prows, _ = collect(WaterfallRunner([PipeSource(io.BytesIO(data), fmt, 48_000)], model, "cpu", chunk_windows=50).run,
                       start_window=start)
    assert prows[0][0] == start
    assert (np.concatenate([n for _, n in prows], axis=1).tobytes()
            == np.concatenate([n for _, n in frows[1:]], axis=1).tobytes())

    def empty():
        return PipeSource(io.BytesIO(b""), fmt, 48_000)

    two = WaterfallModel(WaterfallConfig(n_streams=2, fft_width=128, stride=64, fmt=fmt))
    with pytest.raises(ValueError, match="bank"):
        WaterfallRunner([empty(), empty()], two, "cpu")
    rows, stats = collect(WaterfallRunner([empty()], model, "cpu").run)  # no windows, a clean exit
    assert rows == [] and stats.windows_out == 0


def test_live_pipe_stream_stages_and_slides():
    """``LivePipeStream`` serves forward-moving random access over a pipe:
    staged planes match the in-memory source and the original's, discarded
    data cannot be rewound to, and the length turns from the sentinel to
    the real one at EOF."""
    fmt = FileFormat.COMPLEX_INT8
    data = capture_bytes(5_000, fmt, seed=21)
    ref = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    live = LivePipeStream(PipeSource(Dribble(data, 997), fmt, 48_000))
    jlive = jsources.LivePipeStream(jsources.PipeSource(Dribble(data, 997), JFormat.COMPLEX_INT8, 48_000))
    assert live.length == jlive.length > 5_000 and live.is_live and live.native is None
    for lo, hi in [(0, 700), (512, 1400), (1400, 3000), (2900, 5000)]:
        assert live.stage(lo, hi).tobytes() == ref.stage(lo, hi).tobytes() == jlive.stage(lo, hi).tobytes()
    with pytest.raises(ValueError, match="rewind"):
        live.stage(100, 700)
    slot = np.zeros((2, 3000), np.int8)
    got = live.stage(4000, 6000, out=slot)  # past EOF: a short return, and the real length appears
    assert np.shares_memory(got, slot) and got.tobytes() == ref.stage(4000, 5000).tobytes()
    assert live.length == 5_000


# -- the CLI -------------------------------------------------------------------------


def run(main, argv, capsys, stdin: bytes | None = None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(stdin)))
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def untimed(out: str) -> list[str]:
    """Output lines with the stats line's seconds and Msps cut off."""
    return [ln.rsplit(" windows, ", 1)[0] if " Msps" in ln else ln for ln in out.splitlines()]


STREAM_FLAGS = ["-shift", "1k", "-lowpass", "8k", "-power", "20", "-decimate", "4", "-width", "32", "-chunk", "8000"]


@pytest.mark.parametrize("mode", [[], ["-search", "yes"], ["-scan", "yes", "-threshold", "40", "-top", "5"]],
                         ids=["norms", "search", "scan"])
def test_cli_stream_stdin_matches_file(mode, tmp_path, capsys, monkeypatch):
    """``stream -stdin yes`` over a pipe: the file run's stdout (timing
    apart) and output files, byte for byte; and the JAX package's lines on
    the same argv and input."""
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    fmt = FileFormat.COMPLEX_UINT8
    data = capture_bytes(20_000, fmt)
    path = tmp_path / "live.cu8"
    path.write_bytes(data)
    rc, file_out, err = run(tcli.main, ["stream", *STREAM_FLAGS, *mode, "-sr", "48k", "-out", str(tmp_path / "o"), str(path)], capsys)
    assert rc == 0, err
    stdin_argv = ["stream", *STREAM_FLAGS, *mode, "-stdin", "yes", "-sr", "48k", "-format", "cu8", "-out", str(tmp_path / "o")]
    kept = {p: pathlib.Path(p).read_bytes() for p in glob.glob(str(tmp_path / "o.*"))}
    assert len(kept) == 1
    rc, pipe_out, err = run(tcli.main, stdin_argv, capsys, data, monkeypatch)
    assert rc == 0, err
    assert untimed(pipe_out) == untimed(file_out)
    assert all(pathlib.Path(p).read_bytes() == b for p, b in kept.items())
    rc, jax_out, err = run(jcli.main, stdin_argv, capsys, data, monkeypatch)
    assert rc == 0, err
    if not mode:  # the peak line's bin and window; magnitudes to 5e-5 of the scale elsewhere
        assert pipe_out.splitlines()[0].rsplit(" mag=", 1)[0] == jax_out.splitlines()[0].rsplit(" mag=", 1)[0]
    assert [ln for ln in untimed(pipe_out) if ln.startswith(("stream:", "wrote"))] == \
        [ln for ln in untimed(jax_out) if ln.startswith(("stream:", "wrote"))]


@pytest.mark.parametrize("cmd,flags", [
    ("waterfall", ["-width", "128", "-stride", "64", "-chunk", "50"]),
    ("waterfall", ["-width", "128", "-stride", "64", "-chunk", "50", "-search", "yes"]),
    ("scan", ["-width", "128", "-stride", "300", "-chunk", "20", "-threshold", "9", "-top", "4", "-db", "yes"]),
], ids=["waterfall", "waterfall-search", "scan"])
def test_cli_bank_stdin_matches_file(cmd, flags, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    data = capture_bytes(20_000, FileFormat.COMPLEX_INT8, seed=13)
    path = tmp_path / "live.cs8"
    path.write_bytes(data)
    rc, file_out, err = run(tcli.main, [cmd, *flags, "-sr", "48k", "-out", str(tmp_path / "o"), str(path)], capsys)
    assert rc == 0, err
    kept = {p: pathlib.Path(p).read_bytes() for p in glob.glob(str(tmp_path / "o.*"))}
    assert len(kept) == 1
    for p in kept:
        os.remove(p)  # scan -out refuses to overwrite
    stdin_argv = [cmd, *flags, "-stdin", "yes", "-sr", "48k", "-format", "cs8", "-out", str(tmp_path / "o")]
    rc, pipe_out, err = run(tcli.main, stdin_argv, capsys, data, monkeypatch)
    assert rc == 0, err
    assert untimed(pipe_out) == untimed(file_out)
    assert all(pathlib.Path(p).read_bytes() == b for p, b in kept.items())
    for p in kept:
        os.remove(p)
    rc, jax_out, err = run(jcli.main, stdin_argv, capsys, data, monkeypatch)
    assert rc == 0, err
    # bins, windows, counts and file names are the JAX package's; magnitudes agree to f32 tolerance
    assert len(pipe_out.splitlines()) == len(jax_out.splitlines())
    assert untimed(pipe_out)[-1] == untimed(jax_out)[-1]
    if cmd == "waterfall":
        assert pipe_out.splitlines()[0].rsplit(" mag=", 1)[0] == jax_out.splitlines()[0].rsplit(" mag=", 1)[0]


def test_cli_stdin_requires_sr_and_format(capsys):
    for argv, msg in [
        (["stream", "-stdin", "yes", "-format", "cu8"], "requires -sr and -format"),
        (["stream", "-stdin", "yes", "-sr", "48k"], "requires -sr and -format"),
        (["waterfall", "-stdin", "yes", "-sr", "48k"], "requires -sr and -format"),
        (["scan", "-stdin", "yes", "-sr", "48k", "-format", "cs8", "x.cs8"], "takes no filenames"),
    ]:
        t = run(tcli.main, argv, capsys)
        j = run(jcli.main, argv, capsys)
        assert t[0] == j[0] == 1 and msg in t[2] and t[2] == j[2]


def bursty_capture(tmp_path, noise: float):
    """300 windows of 128 samples: tone bursts on windows [50, 80) and
    [200, 210) over seeded noise of sigma ``noise``."""
    sr, win_raw = 48_000, 4 * 32
    n = 300 * win_raw
    rng = np.random.default_rng(13)
    x = (noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    for a, b in ((50, 80), (200, 210)):
        x[a * win_raw : b * win_raw] += 1.0
    cap = tmp_path / f"bursty.sr{sr}.cf32"
    cap.write_bytes(x.view(np.float32).tobytes())
    return cap, sr, win_raw


TRIGGER_FLAGS = ["-lowpass", "8k", "-power", "20", "-decimate", "4", "-width", "32", "-chunk", "32k",
                 "-trigger", "5", "-pre", "2", "-post", "2"]


def burst_lines(out: str, directory) -> list[str]:
    return [ln.replace(str(directory), "DIR") for ln in out.splitlines() if ln.startswith(("stream burst", "stream trigger"))]


def test_cli_stream_trigger(tmp_path, capsys, monkeypatch):
    """Two tone bursts in a noise-free capture come out as two byte-exact
    slices of the original file that ``from`` reads back; names, bytes and
    summary lines are the JAX package's."""
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    cap, sr, win_raw = bursty_capture(tmp_path, noise=0.0)
    outs = {}
    for tag, main in (("t", tcli.main), ("j", jcli.main)):
        (tmp_path / tag).mkdir()
        rc, out, err = run(main, ["stream", *TRIGGER_FLAGS, "-out", str(tmp_path / tag / "rec"), str(cap)], capsys)
        assert rc == 0, err
        outs[tag] = burst_lines(out, tmp_path / tag)
    assert outs["t"][-1].startswith("stream trigger: 2 bursts over 300 windows")
    assert [ln.split(", peak")[0] for ln in outs["t"]] == [ln.split(", peak")[0] for ln in outs["j"]]
    files = sorted(glob.glob(str(tmp_path / "t" / "rec.b*")))
    jfiles = sorted(glob.glob(str(tmp_path / "j" / "rec.b*")))
    assert len(files) == 2 and [pathlib.Path(f).name for f in files] == [pathlib.Path(f).name for f in jfiles]
    src_bytes = cap.read_bytes()
    for path, jpath, (a, b) in zip(files, jfiles, ((48, 82), (198, 212))):
        name = pathlib.Path(path).name
        s0 = int(name.split(".s")[1].split(".")[0])
        assert abs(s0 - a * win_raw) <= 2 * win_raw  # the FIR's group delay smears the edge
        data = pathlib.Path(path).read_bytes()
        assert data == src_bytes[s0 * 8 : s0 * 8 + len(data)] == pathlib.Path(jpath).read_bytes()
        assert name.endswith(f".sr{sr}.cf32")
        assert run(tcli.main, ["from", path, "sparkfft", "-width", "4"], capsys)[0] == 0
    for argv, msg in [(["stream", "-trigger", "5", str(cap)], "requires -out"),
                      (["stream", "-pre", "2", str(cap)], "requires 'stream -trigger"),
                      (["stream", "-trigger", "5", "-scan", "yes", "-out", "x", str(cap)], "excludes")]:
        rc, _, err = run(tcli.main, argv, capsys)
        assert rc == 1 and msg in err


@pytest.mark.parametrize("chunk", ["32k", "1k"])
def test_cli_stream_trigger_live_pipe_matches_file(chunk, tmp_path, capsys, monkeypatch):
    """``stream -stdin -trigger`` writes the file run's burst files (same
    names, same bytes) and summary lines: the rolling ring and the
    incremental gate reproduce the whole-capture segmentation, also when a
    burst spans many chunks and the ring is pruned between them."""
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    cap, sr, _ = bursty_capture(tmp_path, noise=0.01)
    flags = [*TRIGGER_FLAGS[:8], "-chunk", chunk, *TRIGGER_FLAGS[10:]]
    lines = {}
    for tag, extra, stdin in (("f", [str(cap)], None), ("p", ["-stdin", "yes", "-sr", str(sr), "-format", "cf32"], cap.read_bytes())):
        (tmp_path / tag).mkdir()
        rc, out, err = run(tcli.main, ["stream", *flags, "-out", str(tmp_path / tag / "rec"), *extra], capsys, stdin, monkeypatch)
        assert rc == 0, err
        lines[tag] = burst_lines(out, tmp_path / tag)
        assert untimed(out)[-1].startswith("stream: 38400 samples, 300")
    assert lines["p"] == lines["f"] and len(lines["f"]) == 3
    f_files = sorted(glob.glob(str(tmp_path / "f" / "rec.b*")))
    p_files = sorted(glob.glob(str(tmp_path / "p" / "rec.b*")))
    assert len(f_files) == len(p_files) == 2
    for fp, pp in zip(f_files, p_files):
        assert pathlib.Path(fp).name == pathlib.Path(pp).name
        assert pathlib.Path(fp).read_bytes() == pathlib.Path(pp).read_bytes()
