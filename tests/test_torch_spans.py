"""The port's spans (``quadrs_tpu_torch.utils.profiling``): nothing kept and
no clock read while accounting is off; the Executor's and ``sparkfft``'s
spans one of each a batch, the runners' one of each a chunk, each keyed by
its batch or chunk; the runners' consumer loop, whose ``runner.wait``
spans show when each output was collected (``early``: back before the next
chunk was staged); the spans on ``torch.profiler``'s clock; ``trace()``'s
file holding them beside the profiler's events.  The last test needs a
card (marked ``cuda``, it skips on the CPU): a span around a launched
kernel and ``torch.cuda.synchronize()`` holds the kernel's device
interval.  This file imports no JAX: on a card it runs with
``python -m pytest --noconftest tests/test_torch_spans.py``."""

import io
import json
import os
import queue
import threading
import time
import tracemalloc
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu_torch import runtime, sinks, stream_runner  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402
from quadrs_tpu_torch.sources import PipeSource, SampleSource  # noqa: E402
from quadrs_tpu_torch.stream import LowPass, Shift  # noqa: E402
from quadrs_tpu_torch.stream_runner import StreamRunner  # noqa: E402
from quadrs_tpu_torch.utils import profiling  # noqa: E402
from quadrs_tpu_torch.utils.profiling import PROFILER, profiled, trace  # noqa: E402

CPU = torch.device("cpu")
CS8 = FileFormat.COMPLEX_INT8
EXECUTOR = ("executor.stage", "executor.plan", "executor.launch", "executor.wait", "sink.render")
RUNNER = ("runner.next", "runner.upload", "runner.launch", "runner.wait", "runner.emit", "runner.recycle")


@pytest.fixture(autouse=True)
def fresh():
    PROFILER.reset()
    yield
    PROFILER.reset()


def cs8(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, 2 * n, dtype=np.int64).astype(np.uint8)


def chain(n: int = 40_000):
    return LowPass(Shift(SampleSource(cs8(n, 3), CS8, 48_000), 1_000), 8_000, 4, 20)


def sparkfft(monkeypatch, stream, windows_a_batch: int = 7) -> list[str]:
    """``sparkfft -width 32`` over ``stream`` in batches of
    ``windows_a_batch`` windows."""
    monkeypatch.setattr(sinks, "stream_batches",
                        lambda s, offs, w: runtime.stream_batches(s, offs, w, budget=w * windows_a_batch))
    lines: list[str] = []
    sinks.spark_fft(stream, 32, 32, out=lines.append, device=CPU)
    return lines


def stream_model() -> PipelineModel:
    return PipelineModel(PipelineConfig(sample_rate=48_000, shift_freq=1_000, lp_freq=8_000, decimate=4, taps=40,
                                        fft_width=32, fmt=CS8))


def by_key(spans) -> dict:
    out: dict = defaultdict(list)
    for s in spans:
        out[s.key].append(s)
    return out


def test_off_keeps_nothing_reads_no_clock_and_allocates_nothing(monkeypatch):
    def clock():
        raise AssertionError("a clock was read with accounting off")

    monkeypatch.setattr(profiling, "_now", clock)
    assert not PROFILER.enabled
    sparkfft(monkeypatch, chain())
    StreamRunner(SampleSource(cs8(30_000, 4), CS8, 48_000), stream_model(), CPU, chunk_samples=8_000).run()
    assert PROFILER.spans() == [] and PROFILER.stages == {}

    def boundaries(n: int) -> None:
        for i in range(n):
            with PROFILER.span("executor.stage", 7, i) as sp:
                sp.count("bytes", 4096)

    boundaries(100)  # warm
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        boundaries(100_000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename") if d.size_diff > 0)
    assert grown < 2048  # tracemalloc's own bookkeeping; nothing a boundary keeps
    assert PROFILER.spans() == []


def test_the_executor_and_sparkfft_give_one_span_of_each_a_batch(monkeypatch):
    stream = chain()
    with profiled():
        lines = sparkfft(monkeypatch, stream)
    spans = PROFILER.spans()
    groups = by_key(spans)
    rows = len(lines) - 1
    n_batches = -(-rows // 7)
    assert n_batches > 3
    assert len(groups) == n_batches
    owner = spans[0].key[0]
    assert sorted(groups) == [(owner, i) for i in range(n_batches)]
    for key, group in groups.items():
        names = Counter(s.name for s in group)
        assert names == Counter(EXECUTOR + ("executor.sync_upload",)), key  # no slot to await on the CPU
        launch = next(s for s in group if s.name == "executor.launch")
        upload = next(s for s in group if s.name == "executor.sync_upload")
        assert upload.parent == launch.id and launch.start <= upload.start <= upload.end <= launch.end
        assert upload.counters["tensors"] >= 2 and upload.counters["bytes"] > 0
        stage = next(s for s in group if s.name == "executor.stage")
        assert stage.counters["bytes"] > 0
        order = [s.name for s in sorted(group, key=lambda s: s.start)]
        assert order.index("executor.stage") < order.index("executor.plan") < order.index("executor.launch")
        assert order.index("executor.wait") < order.index("sink.render")
    # the launch stays the one accounted region, under the stream's name alone
    assert set(PROFILER.stages) == {"lowpass"}
    assert PROFILER.stages["lowpass"].steps == n_batches
    launched = sum(s.end - s.start for s in spans if s.name == "executor.launch") / 1e9
    assert PROFILER.stages["lowpass"].seconds == pytest.approx(launched)


@pytest.mark.parametrize("kind", ["pipe", "buffer"])
def test_a_runner_gives_one_span_of_each_a_chunk(kind):
    data = cs8(60_000, 5)
    src = (PipeSource(io.BytesIO(data.tobytes()), CS8, 48_000) if kind == "pipe"
           else SampleSource(data, CS8, 48_000))
    got = []
    with profiled():
        stats = StreamRunner(src, stream_model(), CPU, chunk_samples=8_000).run(lambda w0, rows: got.append(w0))
    spans = PROFILER.spans()
    n = len(got)
    assert n >= 5 and stats.windows_out > 0
    run = next(s.key[0] for s in spans if s.name == "runner.launch")
    consumer = [s for s in spans if s.name.startswith("runner.")]
    staging = [s for s in spans if s.name.startswith("staging.")]
    for name in RUNNER:
        # the last runner.next finds the stream's end
        want = [(run, k) for k in range(n + (name == "runner.next"))]
        assert sorted(s.key for s in consumer if s.name == name) == want, name
    for name in ("staging.read", "staging.slot", "staging.fill", "staging.handoff"):
        assert {(run, k) for k in range(n)} <= {s.key for s in staging if s.name == name}, name
    assert all(s.counters["bytes"] > 0 for s in staging if s.name == "staging.read")
    # the staging spans come on the staging thread
    assert len({s.thread for s in consumer}) == 1
    assert not {s.thread for s in staging} & {s.thread for s in consumer}
    # chunk k's output is awaited after its own launch: before chunk k+1 is
    # staged (counter early), or else once chunk k+1 is launched
    first = {(s.name, s.key[1]): s for s in consumer}
    for k in range(n):
        wait = first["runner.wait", k]
        assert wait.start >= first["runner.launch", k].end
        if wait.counters is not None:
            assert wait.counters == {"early": 1}
            assert first["runner.emit", k].end <= first["runner.next", k + 1].start
        elif k + 1 < n:
            assert wait.start >= first["runner.launch", k + 1].end
        else:
            assert wait.start >= first["runner.next", n].end
        assert first["runner.emit", k].start >= wait.end


def waits() -> dict:
    """Each chunk's ``runner.wait`` span by chunk."""
    return {s.key[1]: s for s in PROFILER.spans() if s.name == "runner.wait"}


class StubRing:
    """The ring's side of the consumer loop, on the CPU: a slot's buffers
    are the tensor staged with it."""

    def upload(self, k, **shapes):
        return k

    def consumed(self, k):
        pass

    def recycle(self, k):
        pass

    def close(self):
        pass


def drive(staged, step, on_emit=lambda w0: None):
    """``_pipelined`` over a stub ring and ``staged``'s items ``(slot, w0,
    {}, account)``: the ``(w0, output)`` pairs ``emit`` received, in
    order, and the ``ValueError`` it raised (or None)."""
    got = []

    def emit(w0, out):
        got.append((w0, out.copy()))
        on_emit(w0)

    try:
        stream_runner._pipelined(StubRing(), staged, step, emit, [CPU], None)
    except ValueError as e:
        return got, e
    return got, None


def test_a_live_pipe_gets_each_output_before_the_next_chunk_is_written():
    """A writer that sends chunk k+1's samples only once chunk k's output
    has reached ``emit`` (a source slower than the device, at its
    limit): every chunk comes out, every wait but the last one's is
    early, and the rows are those of the same bytes through a
    ``BytesIO``.  Waiting for chunk k+1 before emitting chunk k would
    starve the writer; its 10 s timeout then closes the pipe and the
    count fails."""
    model = stream_model()
    probe = StreamRunner(PipeSource(io.BytesIO(b""), CS8, 48_000), model, CPU, chunk_samples=8_000)
    chunk, la, n = probe.chunk_samples, probe._lookahead, 6
    raw = cs8(n * chunk + la, 8).tobytes()
    emitted: queue.Queue = queue.Queue()
    starved = []
    r, w = os.pipe()

    def write() -> None:
        with os.fdopen(w, "wb") as f:
            for k in range(n):
                f.write(raw[2 * (k * chunk + (la if k else 0)) : 2 * ((k + 1) * chunk + la)])
                f.flush()
                try:
                    emitted.get(timeout=10)
                except queue.Empty:
                    starved.append(k)
                    return

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    rows = []

    def emit(w0, norms):
        rows.append((w0, norms.copy()))
        emitted.put(w0)

    with profiled(), os.fdopen(r, "rb") as f:
        StreamRunner(PipeSource(f, CS8, 48_000), model, CPU, chunk_samples=8_000).run(emit)
    writer.join(timeout=30)
    assert not writer.is_alive() and starved == []
    assert len(rows) == n
    spans = waits()
    assert sorted(spans) == list(range(n))
    assert all(spans[k].counters == {"early": 1} for k in range(n - 1))
    want = []
    StreamRunner(PipeSource(io.BytesIO(raw), CS8, 48_000), model, CPU, chunk_samples=8_000).run(
        lambda w0, norms: want.append((w0, norms.copy())))
    assert [w0 for w0, _ in rows] == [w0 for w0, _ in want]
    for (_, a), (_, b) in zip(rows, want):
        np.testing.assert_array_equal(a, b)


def test_an_input_ahead_of_the_device_keeps_the_one_ahead_order():
    """Every chunk's step returns only once the staging queue holds the
    next item (or the end): no wait is early, each chunk's output is
    awaited once the next chunk is launched, and the outputs come in
    order."""
    n = 8
    put = [threading.Event() for _ in range(n + 1)]  # item k queued (n: the end)

    def staged():
        for k in range(n):
            yield k, k * 10, {}, lambda: None
            put[k].set()
        put[n].set()

    def step(w0, k):
        assert put[k + 1].wait(timeout=10)
        if k + 1 == n:
            time.sleep(0.05)  # the producer queues the end right after its last item
        return torch.full((3,), float(w0))

    with profiled():
        got, err = drive(staged(), step)
    assert err is None
    assert [w0 for w0, _ in got] == [k * 10 for k in range(n)]
    assert all((out == w0).all() for w0, out in got)
    spans = {(s.name, s.key[1]): s for s in PROFILER.spans()}
    for k in range(n):
        assert spans["runner.wait", k].counters is None
        if k + 1 < n:
            assert spans["runner.wait", k].start >= spans["runner.launch", k + 1].end


def test_an_output_not_back_waits_for_the_next_chunk(monkeypatch):
    """The input behind the device (each item 20 ms apart) but no output
    back before the next chunk is staged (``Download.done`` false, as for
    work still on the card): nothing is finished early, each chunk's
    output is awaited once the next chunk is launched, and the outputs
    come in order."""

    class NeverBack(stream_runner.Download):
        def done(self) -> bool:
            return False

    monkeypatch.setattr(stream_runner, "Download", NeverBack)
    n = 5

    def staged():
        for k in range(n):
            yield k, k, {}, lambda: None
            time.sleep(0.02)

    with profiled():
        got, err = drive(staged(), lambda w0, k: torch.full((2,), float(w0)))
    assert err is None and [w0 for w0, _ in got] == list(range(n))
    spans = {(s.name, s.key[1]): s for s in PROFILER.spans()}
    for k in range(n):
        assert spans["runner.wait", k].counters is None
        if k + 1 < n:
            assert spans["runner.wait", k].start >= spans["runner.launch", k + 1].end


@pytest.mark.parametrize("ending", ["end", "error"])
@pytest.mark.parametrize("pace", ["ahead", "behind"])
def test_the_streams_end_and_a_staging_error_still_surface_in_order(pace, ending):
    """After four chunks the staging generator ends or raises.  Ahead, the
    end or the error is queued when the loop looks; behind, the generator
    waits for chunk 3's output before it ends or raises, so the loop has
    to emit chunk 3 first.  The outputs come in order, once each, and the
    error surfaces; ahead, an error drops the chunk still pending."""
    n = 4
    put = [threading.Event() for _ in range(n + 1)]  # item k queued (n: the end or the error)
    emitted = threading.Event()

    def staged():
        for k in range(n):
            yield k, k, {}, lambda: None
            put[k].set()
        if pace == "behind":
            emitted.wait(timeout=10)
        put[n].set()
        if ending == "error":
            raise ValueError("staging failed")

    def step(w0, k):
        if k + 1 < n or pace == "ahead":
            assert put[k + 1].wait(timeout=10)
        if k + 1 == n and pace == "ahead":
            time.sleep(0.05)  # the producer queues the end or the error right after
        return torch.full((2,), float(w0))

    def on_emit(w0):
        if w0 == n - 1:
            emitted.set()

    with profiled():
        got, err = drive(staged(), step, on_emit)
    assert (None if err is None else str(err)) == ("staging failed" if ending == "error" else None)
    want = n - 1 if (pace, ending) == ("ahead", "error") else n
    assert [w0 for w0, _ in got] == list(range(want))
    assert all((out == w0).all() for w0, out in got)
    early = {k for k, sp in waits().items() if sp.counters}
    assert early == ({n - 1} if pace == "behind" else set())


def test_spans_sit_on_the_profilers_clock():
    """Each span holds the ``record_function`` event it wraps, within 1 ms
    on the profiler's clock, and in the tightest of five the two agree at
    both ends within 1 ms (a thread preempted between the two readings
    widens one pair, never all)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profiled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        for i in range(5):
            with PROFILER.span("test.block", 1, i):
                with record_function(f"test.block.{i}"):
                    a = torch.randn(200, 200)
                    for _ in range(10):
                        a = torch.tanh(a @ a)
    spans = {s.key[1]: s for s in PROFILER.spans() if s.name == "test.block"}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    worst = []
    for i, span in spans.items():
        ev = events[f"test.block.{i}"]
        assert span.start - 1_000_000 <= ev.start_ns() <= ev.end_ns() <= span.end + 1_000_000
        worst.append(max(abs(ev.start_ns() - span.start), abs(ev.end_ns() - span.end)))
    assert len(worst) == 5 and min(worst) < 1_000_000


def test_trace_writes_the_spans_beside_the_profilers_events(monkeypatch, tmp_path):
    with trace(str(tmp_path / "tr")):
        sparkfft(monkeypatch, chain(20_000))
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    events = doc["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    torch_ops = [e for e in events if e.get("ph") == "X" and e.get("cat") != "span"]
    assert {e["name"] for e in spans} >= set(EXECUTOR) | {"executor.sync_upload"}
    assert torch_ops
    assert len({e["pid"] for e in spans}) == 1 and not {e["pid"] for e in spans} & {e["pid"] for e in torch_ops}
    names = [e for e in events if e.get("ph") == "M" and e["pid"] == spans[0]["pid"]]
    assert names and names[0]["args"]["name"] == "quadrs_tpu_torch spans"
    # one timeline: the torch ops of a batch's launch lie inside its span
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    ops = [e for e in torch_ops if e["name"].startswith("aten::")]
    assert ops and all(lo - 1e3 <= e["ts"] <= hi + 1e3 for e in ops)
    launches = [e for e in spans if e["name"] == "executor.launch"]
    inside = [e for e in ops if any(s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"] for s in launches)]
    assert len(inside) > len(ops) // 4


def test_spans_nest_are_capped_and_reset(monkeypatch):
    monkeypatch.setattr(PROFILER, "cap", 5)
    with profiled():
        with PROFILER.span("outer", 1, 0) as outer:
            outer.count("bytes", 3)
            outer.count("bytes", 4)
            with PROFILER.span("inner", 1, 0):
                pass
        for i in range(10):
            with PROFILER.span("many", 1, i):
                pass
    spans = PROFILER.spans()
    assert len(spans) == 5 and PROFILER.dropped == 7
    inner, outer = spans[1], spans[0]
    assert (outer.name, inner.name) == ("outer", "inner")
    assert inner.parent == outer.id and outer.parent is None
    assert outer.counters == {"bytes": 7} and inner.counters is None
    PROFILER.reset()
    assert PROFILER.spans() == [] and PROFILER.dropped == 0


@pytest.mark.cuda
def test_a_span_holds_its_kernels_device_interval_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    a = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize()
    with profiled(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            with PROFILER.span("test.kernel", 1, i):
                b = a @ a
                torch.cuda.synchronize()
            time.sleep(0.002)  # a gap between the spans
    del b
    spans = [s for s in PROFILER.spans() if s.name == "test.kernel"]
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not (getattr(e, "is_user_annotation", None) and e.is_user_annotation())]
    assert len(spans) == 3 and len(kernels) >= 3
    slack = 100_000  # 100 us
    for e in kernels:
        held = [s for s in spans if s.start - slack <= e.start_ns() and e.end_ns() <= s.end + slack]
        assert len(held) == 1, (e.name(), e.start_ns(), e.end_ns(), [(s.start, s.end) for s in spans])
