"""The port's capture loader (``quadrs_tpu_torch.native``) against
quadrs_tpu's (``quadrs_tpu.native.loader.NativeCapture``) and against
``SampleSource.stage`` over the same bytes, bit for bit: every format, odd
lengths (a trailing partial pair), ``overlap``, ``start_off``, reads that
straddle EOF, caller-owned slots.  Then the runners through the staging
rings on the CPU: a file read through the loader's ring prefetcher gives
the in-memory route's rows bit for bit, and quadrs_tpu's runner's within
``5e-5 * max`` (stream) and ``rtol 2e-5, atol 2e-5 * max`` (bank).

Captures are made with numpy from a seed and written to ``tmp_path``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.native.loader import NativeCapture as JCapture  # noqa: E402
from quadrs_tpu.native.loader import native_available  # noqa: E402

from quadrs_tpu_torch.formats import FileFormat, planes_from_bytes  # noqa: E402
from quadrs_tpu_torch.native import NativeCapture, library  # noqa: E402
from quadrs_tpu_torch.native import loader as tloader  # noqa: E402
from quadrs_tpu_torch.sources import SampleSource, open_capture  # noqa: E402

FORMATS = [f.value for f in FileFormat]
N = 10_007  # samples; the file carries one byte more (a partial pair)


def write_capture(tmp_path, fmt: FileFormat, n: int = N, seed: int = 17, extra: bytes = b"\x55"):
    rng = np.random.default_rng(seed + n)
    raw = rng.integers(0, 256, n * fmt.pair_bytes, dtype=np.int64).astype(np.uint8)
    if fmt is FileFormat.COMPLEX_FLOAT32:
        # finite floats: NaN payloads compare unequal to themselves
        raw = rng.normal(size=2 * n).astype("<f4").view(np.uint8)
    path = tmp_path / f"cap{n}.sr48k.{fmt.value}"
    path.write_bytes(raw.tobytes() + extra)
    return path, raw


def test_library_is_built_in_the_checkouts_build_dir():
    lib = library()
    assert lib.path.parent == tloader.BUILD_DIR and lib.path.exists()
    assert lib.path.name.startswith("libquadrs_loader_") and lib.path.suffix == ".so"
    assert library() is lib  # loaded once


@pytest.mark.parametrize("fmt", FORMATS)
def test_read_planes_bitwise(fmt, tmp_path):
    """Whole file, interior reads, reads that straddle and lie past EOF:
    equal to the numpy deinterleave, to ``SampleSource.stage`` of the same
    bytes and to the JAX package's loader; zero-padded past EOF."""
    fmt = FileFormat(fmt)
    path, raw = write_capture(tmp_path, fmt)
    cap = NativeCapture(path, fmt)
    assert cap.length == N  # the partial pair is no sample
    want = planes_from_bytes(raw, fmt)
    mem = SampleSource(raw, fmt, 48_000)
    jcap = JCapture(path, JFormat(fmt.value)) if native_available() else None
    for off, n in [(0, N), (1234, 100), (0, 1), (N - 1, 1), (N - 10, 100), (N, 5), (N + 7, 3), (5, 0)]:
        got = cap.read_planes(off, n)
        assert got.shape == (2, n) and got.dtype == fmt.raw_dtype
        real = max(0, min(n, N - off))
        assert got[:, :real].tobytes() == want[:, off : off + real].tobytes()
        assert got[:, :real].tobytes() == mem.stage(off, off + n).tobytes()
        assert not np.any(got[:, real:].view(np.uint8))
        if jcap is not None:
            assert got.tobytes() == jcap.read_planes(off, n).tobytes()


@pytest.mark.parametrize("fmt", ["cs8", "cs16"])
def test_a_large_read_is_split_over_threads(fmt, tmp_path):
    """Reads of 4M samples and more are split over reader threads: the
    same planes, also across EOF and at odd offsets."""
    fmt = FileFormat(fmt)
    n = (5 << 20) + 12_345
    path, raw = write_capture(tmp_path, fmt, n=n)
    cap = NativeCapture(path, fmt)
    want = planes_from_bytes(raw, fmt)
    for off, m in [(0, n), (7, (4 << 20) + 1), (1 << 20, 5 << 20), (3, 4 << 20)]:
        got = cap.read_planes(off, m)
        real = min(m, n - off)
        assert got[:, :real].tobytes() == want[:, off : off + real].tobytes()
        assert not got[:, real:].any()


@pytest.mark.parametrize("fmt", FORMATS)
def test_read_planes_into_a_callers_rows(fmt, tmp_path):
    """``out=``: the read lands in the caller's memory (a row pair of a
    bank slot), its stale tail past EOF is zeroed, and what lies past the
    asked columns is left alone."""
    fmt = FileFormat(fmt)
    path, raw = write_capture(tmp_path, fmt)
    cap = NativeCapture(path, fmt)
    want = planes_from_bytes(raw, fmt)
    bank = np.full((3, 2, 300), 7, dtype=fmt.raw_dtype)
    got = cap.read_planes(N - 100, 250, out=bank[1])
    assert np.shares_memory(got, bank) and got.shape == (2, 250)
    assert bank[1, :, :100].tobytes() == want[:, N - 100 :].tobytes()
    assert not np.any(bank[1, :, 100:250].view(np.uint8))
    assert np.all(bank[1, :, 250:] == 7) and np.all(bank[0] == 7) and np.all(bank[2] == 7)
    for bad in (np.zeros((2, 10), fmt.raw_dtype), np.zeros((3, 300), fmt.raw_dtype),
                np.zeros((2, 600), fmt.raw_dtype)[:, ::2], np.zeros((2, 300), np.float64)):
        with pytest.raises(ValueError, match="out must be"):
            cap.read_planes(0, 250, out=bad)
    with pytest.raises(ValueError, match="negative"):
        cap.read_planes(-1, 5)


@pytest.mark.parametrize("n_workers", [1, 2, 3])
@pytest.mark.parametrize("fmt", FORMATS)
def test_prefetch_bitwise(fmt, n_workers, tmp_path):
    """Chunks arrive in stream order whatever the worker count, each with
    the next ``overlap`` samples re-read from the following chunk's head;
    offsets advance by the chunk from ``start_off``; the sequence is the
    JAX package's."""
    fmt = FileFormat(fmt)
    path, raw = write_capture(tmp_path, fmt)
    cap = NativeCapture(path, fmt)
    want = planes_from_bytes(raw, fmt)
    for chunk, overlap, start in [(1024, 0, 0), (1000, 96, 0), (1000, 96, 333), (4096, 5000, 1), (N, 3, 0)]:
        got = list(cap.prefetch(chunk, n_buffers=3, start_off=start, overlap=overlap, n_workers=n_workers))
        assert [off for off, _ in got] == list(range(start, N, chunk))
        for off, planes in got:
            assert planes.shape[1] == min(chunk + overlap, N - off)
            assert planes.tobytes() == want[:, off : off + planes.shape[1]].tobytes()
        if native_available():
            jgot = list(JCapture(path, JFormat(fmt.value)).prefetch(
                chunk, n_buffers=3, start_off=start, overlap=overlap, n_workers=n_workers))
            assert [(o, p.tobytes()) for o, p in got] == [(o, p.tobytes()) for o, p in jgot]


def test_prefetch_into_slots_and_early_close(tmp_path):
    """``out=`` hands each chunk a caller-owned slot, which the reader
    threads fill directly: a reused slot keeps its earlier bytes past the
    delivered count (the runner zeroes them); abandoning the iterator stops
    the reader threads before it returns."""
    fmt = FileFormat.COMPLEX_UINT8
    path, raw = write_capture(tmp_path, fmt, n=2500)
    cap = NativeCapture(path, fmt)
    want = planes_from_bytes(raw, fmt)
    slots = [np.full((2, 1100), 9, np.uint8) for _ in range(2)]
    handed = []

    def take():
        handed.append(slots[len(handed) % 2])
        return handed[-1]

    seen = []
    for off, planes in cap.prefetch(1000, n_buffers=2, overlap=100, out=take):  # one slot lent ahead
        assert np.shares_memory(planes, handed[-1])
        seen.append((off, planes.shape[1], planes.tobytes()))
    assert [(o, n) for o, n, _ in seen] == [(0, 1100), (1000, 1100), (2000, 500)]
    assert all(b == want[:, o : o + n].tobytes() for o, n, b in seen)
    # the last chunk reused slot 0: its tail is chunk 0's, not zeros
    assert slots[0][:, 500:].tobytes() == want[:, 500:1100].tobytes()
    it = cap.prefetch(512, n_workers=2)
    next(it)
    next(it)
    it.close()  # stops the prefetcher with its workers mid-flight
    with pytest.raises(ValueError, match="chunk_samples must be positive"):
        next(cap.prefetch(0))
    with pytest.raises(OSError, match="cannot open"):
        NativeCapture(tmp_path / "missing.cs8", fmt)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No numpy fallback: a loader that cannot be built raises, and so does
    opening a capture file."""
    monkeypatch.setattr(tloader, "_loaded", None)
    monkeypatch.setattr(tloader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot build the capture loader"):
        library()
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tloader, "_SRC", broken)
    monkeypatch.delenv("CXX")
    with pytest.raises(RuntimeError, match="error") as e:
        library()
    assert "broken.cc" in str(e.value)
    path, _ = write_capture(tmp_path, FileFormat.COMPLEX_INT8, n=100)
    with pytest.raises(RuntimeError, match="cannot build the capture loader"):
        open_capture(str(path))


@pytest.mark.parametrize("fmt", FORMATS)
def test_file_source_stages_through_the_loader(fmt, tmp_path):
    fmt = FileFormat(fmt)
    path, raw = write_capture(tmp_path, fmt)
    src = open_capture(str(path))
    mem = SampleSource(raw, fmt, 48_000)
    assert src.native is not None and mem.native is None
    assert (src.length, src.sample_rate, src.format) == (N, 48_000, fmt)
    for lo, hi in [(0, N), (17, 4000), (N - 5, N + 50), (N + 1, N + 9), (-3, 10)]:
        assert src.stage(lo, hi).tobytes() == mem.stage(lo, hi).tobytes()
    slot = np.full((2, 64), 3, dtype=fmt.raw_dtype)
    for s in (src, mem):
        got = s.stage(N - 20, N + 20, out=slot)
        assert got.shape == (2, 20) and np.shares_memory(got, slot)
        assert got.tobytes() == mem.stage(N - 20, N).tobytes()
    assert src.raw_bytes(5, 9) == raw[5 * fmt.pair_bytes : 9 * fmt.pair_bytes].tobytes()


# -- the runners through the rings ---------------------------------------------

WIN = 8 * 32  # raw samples per window of the stream model below


def stream_models(fmt: str):
    from quadrs_tpu.models.receiver import PipelineConfig as JConfig
    from quadrs_tpu.models.receiver import PipelineModel as JModel

    from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel

    args = dict(sample_rate=1_000_000, shift_freq=12_345, lp_freq=50_000, decimate=8, taps=60, fft_width=32)
    return JModel(JConfig(fmt=JFormat(fmt), **args)), PipelineModel(PipelineConfig(fmt=FileFormat(fmt), **args))


def collect(run, **kw):
    rows = []
    stats = run(lambda w0, out: rows.append((w0, out)), **kw)
    return rows, stats


# a short last chunk after full ones: the reused slot's stale tail must be
# zeroed (cu8 and cs16 decode a zero byte to a large negative value, which
# the model masks; a stale byte it would not)
@pytest.mark.parametrize("frontend", ["auto", "chain"])
@pytest.mark.parametrize("fmt,n", [("cu8", 7 * WIN + 77), ("cs16", 7 * WIN + 3), ("cs8", 9 * WIN), ("cf32", 4 * WIN + 200)])
def test_stream_through_the_ring_equals_the_in_memory_route(fmt, n, frontend, tmp_path):
    from quadrs_tpu.sources import SampleSource as JSource
    from quadrs_tpu.stream_runner import StreamRunner as JRunner

    from quadrs_tpu_torch.stream_runner import StreamRunner

    jm, tm = stream_models(fmt)
    path, raw = write_capture(tmp_path, FileFormat(fmt), n=n, extra=b"")
    chunk = 3 * WIN + 5

    def runner(src):
        return StreamRunner(src, tm, "cpu", chunk_samples=chunk, frontend=frontend)

    file_src = open_capture(str(path), "1M")
    assert file_src.native is not None
    mem_rows, mem_stats = collect(runner(SampleSource(raw, FileFormat(fmt), 1_000_000)).run)
    for _ in range(2):  # the second run reuses the runner's ring
        r = runner(file_src)
        rows, stats = collect(r.run)
        assert len(rows) == len(mem_rows) > 1
        for (w, got), (mw, want) in zip(rows, mem_rows):
            assert w == mw and got.tobytes() == want.tobytes()
        assert (stats.samples_in, stats.windows_out) == (mem_stats.samples_in, mem_stats.windows_out)
        again, _ = collect(r.run_search)
        peaks, _ = collect(runner(SampleSource(raw, FileFormat(fmt), 1_000_000)).run_search)
        for (w, (i, v)), (mw, (mi, mv)) in zip(again, peaks):
            assert w == mw and i.tobytes() == mi.tobytes() and v.tobytes() == mv.tobytes()
    # resume and a bounded run, through the ring
    tail, _ = collect(runner(file_src).run, start_window=3)
    assert np.concatenate([r for _, r in tail]).tobytes() == np.concatenate([r for _, r in mem_rows])[3:].tobytes()
    first, st = collect(runner(file_src).run, max_chunks=1)
    assert len(first) == 1 and st.windows_out == 3 and first[0][1].tobytes() == mem_rows[0][1].tobytes()
    scan = runner(file_src).run_scan(threshold=0.5)
    mem_scan = runner(SampleSource(raw, FileFormat(fmt), 1_000_000)).run_scan(threshold=0.5)
    assert scan.sum_norms.tobytes() == mem_scan.sum_norms.tobytes() and scan.windows == mem_scan.windows

    want_rows, _ = collect(JRunner(JSource(raw, JFormat(fmt), 1_000_000), jm, chunk_samples=3 * WIN).run)
    want = np.concatenate([np.asarray(r) for _, r in want_rows])
    got = np.concatenate([r for _, r in mem_rows])
    assert [w for w, _ in mem_rows] == [w for w, _ in want_rows]
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5 * want.max())


@pytest.mark.parametrize("fmt,stride", [("cs8", 128), ("cu8", 32), ("cs16", 200)])
def test_bank_through_the_ring_equals_the_in_memory_route(fmt, stride, tmp_path):
    """Three files read row by row into one slot per chunk (no stack): the
    in-memory route's rows bit for bit, the JAX runner's within its
    tolerance; the ragged last chunk reuses a slot that held a full one."""
    from quadrs_tpu.models.waterfall import WaterfallConfig as JConfig
    from quadrs_tpu.models.waterfall import WaterfallModel as JModel
    from quadrs_tpu.sources import SampleSource as JSource
    from quadrs_tpu.stream_runner import WaterfallRunner as JRunner

    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.stream_runner import WaterfallRunner

    f = FileFormat(fmt)
    n = 5000 + 3 * stride
    files = []
    for k in range(3):
        p, raw = write_capture(tmp_path, f, n=n, seed=k, extra=b"")
        files.append((p.rename(p.with_name(f"s{k}.{p.name}")), raw))
    cfg = dict(n_streams=3, fft_width=128, stride=stride, windowing="blackman-harris")
    model = WaterfallModel(WaterfallConfig(fmt=f, **cfg))

    def runner(sources):
        return WaterfallRunner(sources, model, "cpu", chunk_windows=11)

    disk = [open_capture(str(p), "48k") for p, _ in files]
    mem = [SampleSource(raw, f, 48_000) for _, raw in files]
    assert all(s.native is not None for s in disk)
    mem_rows, mem_stats = collect(runner(mem).run)
    r = runner(disk)
    for _ in range(2):
        rows, stats = collect(r.run)
        assert len(rows) == len(mem_rows) > 2 and rows[-1][1].shape[1] < 11
        for (w, got), (mw, want) in zip(rows, mem_rows):
            assert w == mw and got.tobytes() == want.tobytes()
        assert (stats.samples_in, stats.windows_out) == (mem_stats.samples_in, mem_stats.windows_out)
    peaks, _ = collect(runner(disk).run_search)
    mem_peaks, _ = collect(runner(mem).run_search)
    for (_, (i, v)), (_, (mi, mv)) in zip(peaks, mem_peaks):
        assert i.tobytes() == mi.tobytes() and v.tobytes() == mv.tobytes()
    scan, mem_scan = runner(disk).run_scan(0.3), runner(mem).run_scan(0.3)
    assert scan.sum_norms.tobytes() == mem_scan.sum_norms.tobytes()
    assert scan.above.tobytes() == mem_scan.above.tobytes()
    first, st = collect(runner(disk).run, start_window=11, max_chunks=1)
    assert first[0][0] == 11 and first[0][1].tobytes() == mem_rows[1][1].tobytes() and st.windows_out == 33

    jmodel = JModel(JConfig(fmt=JFormat(fmt), frontend="xla", **cfg))
    want_rows, _ = collect(JRunner([JSource(raw, JFormat(fmt), 48_000) for _, raw in files], jmodel, chunk_windows=11).run)
    want = np.concatenate([np.asarray(r) for _, r in want_rows], axis=1)
    got = np.concatenate([r for _, r in mem_rows], axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * want.max())


@pytest.mark.parametrize("fmt", ["cu8", "cs16"])
def test_a_reused_slots_stale_tail_is_zeroed(fmt, tmp_path):
    """The last chunk is short and lands in a slot that held a full one:
    what the runner stages past the real samples is zero bytes, as the
    in-memory route's padding is (the model masks zero bytes' decoded
    values, -127.5 in cu8 and -32767.5 in cs16, by the same count)."""
    from quadrs_tpu_torch.stream_runner import StreamRunner

    _, tm = stream_models(fmt)
    f = FileFormat(fmt)
    path, raw = write_capture(tmp_path, f, n=7 * WIN + 77, extra=b"")
    width = 3 * WIN + 90
    for src in (open_capture(str(path), "1M"), SampleSource(raw, f, 1_000_000)):
        # two dirty slots in turn (the loader holds two at once): the short
        # third chunk lands in the first, which held a full chunk
        slots = [np.full((2, width), 85, dtype=f.raw_dtype) for _ in range(2)]
        handed = []

        def take():
            handed.append(slots[len(handed) % 2])
            return handed[-1]

        runner = StreamRunner(src, tm, "cpu", chunk_samples=3 * WIN)
        staged = runner._chunks_native(0, take) if src.native is not None else runner._chunks(0, take)
        want = list(StreamRunner(SampleSource(raw, f, 1_000_000), tm, "cpu", chunk_samples=3 * WIN)._chunks())
        seen = 0
        for (off, planes, valid), (woff, wplanes, wvalid) in zip(staged, want, strict=True):
            assert (off, valid) == (woff, wvalid) and np.shares_memory(planes, slots[seen % 2])
            assert planes.tobytes() == wplanes.tobytes()
            seen += 1
        assert seen == 3 and valid == WIN + 77 < planes.shape[1] == WIN + 90
        assert not planes[:, valid:].any() and slots[0][:, WIN + 90 :].any()


def test_a_callback_may_keep_its_arrays_and_a_failure_stops_the_staging(tmp_path):
    """Each chunk's output is memory of its own (kept rows stay valid while
    slots are reused), and an exception in ``emit`` ends the run and its
    staging thread."""
    import threading

    from quadrs_tpu_torch.stream_runner import StreamRunner

    _, tm = stream_models("cs8")
    path, raw = write_capture(tmp_path, FileFormat.COMPLEX_INT8, n=40 * WIN, extra=b"")
    runner = StreamRunner(open_capture(str(path), "1M"), tm, "cpu", chunk_samples=2 * WIN)
    kept, _ = collect(runner.run)
    assert len(kept) == 20
    copies = [r.copy() for _, r in kept]
    collect(runner.run)  # slots and outputs are used again
    assert all(a.tobytes() == b.tobytes() for (_, a), b in zip(kept, copies))

    before = threading.active_count()

    def boom(w0, rows):
        raise KeyError("sink failed")

    with pytest.raises(KeyError, match="sink failed"):
        runner.run(boom)
    assert threading.active_count() <= before
    rows, _ = collect(runner.run)  # the runner is usable afterwards
    assert len(rows) == 20


def test_executor_stages_a_file_through_the_loader(tmp_path):
    """The reference chain over a file (loader, one page-locked slot) and
    over the same bytes in memory: the same sparkfft rows."""
    from quadrs_tpu_torch import sinks
    from quadrs_tpu_torch.stream import LowPass, Shift

    path, raw = write_capture(tmp_path, FileFormat.COMPLEX_INT8, n=30_000, extra=b"")
    rows = []
    for src in (open_capture(str(path)), SampleSource(raw, FileFormat.COMPLEX_INT8, 48_000)):
        chain = LowPass(Shift(src, 1_000), 8_000, 4, 40)
        rows.append(sinks.spark_fft(chain, width=32, stride=16, lo=0.01, hi=0.5, device="cpu"))
    assert rows[0] == rows[1] and len(rows[0]) > 400
