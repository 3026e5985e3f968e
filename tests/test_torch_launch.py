"""The Executor's launch on the CPU: constant tables from one cache, and
the plan's arrays sent without a wait.

- **Tables** (``ops/tables.device_table``): ``Shift``'s in-window angles,
  ``gen``'s, the receiver's NCO tables, each ``fir_decimate`` impl's taps,
  matrix or spectrum are bit-equal to the host arrays they were uploaded
  from before the cache (``ExactNCO.angles``, the polyphase ``hp``,
  ``banded_weights``, the f32-rounded correlation spectra); the cache
  keeps the tables used last, at most ``CAPACITY`` of them and
  ``CAPACITY_BYTES`` together; a miss counts one upload on the calling
  thread alone.
- **The launch**: a second batch of an Executor reads the very tensors the
  first did (same ``data_ptr``), and ``executor.launch``'s counter
  ``table_uploads`` is at least 1 on a pass's first batch and 0 on every
  later one, over the conditioned chain ``shift lowpass dcblock agc
  sparkfft``.
- **The plan's arrays** (``runtime._to_device``): each comes back with its
  dtype, shape and values; on the card's route (its copy stubbed here)
  each crosses ``non_blocking``, the small ones page-locked; and
  ``executor.sync_upload`` counts the plan's arrays alone.

The card's side, that no launch after the first synchronizes, is the
``cuda`` test ``-k never_waits``.  This file imports no JAX.
"""

import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu_torch import runtime, sinks, stream  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402
from quadrs_tpu_torch.ops import fir, tables  # noqa: E402
from quadrs_tpu_torch.ops.nco import ExactNCO  # noqa: E402
from quadrs_tpu_torch.sources import SampleSource, ToneGen  # noqa: E402
from quadrs_tpu_torch.utils.profiling import PROFILER, profiled  # noqa: E402

CPU = torch.device("cpu")
CS8 = FileFormat.COMPLEX_INT8


@pytest.fixture(autouse=True)
def fresh():
    tables.clear()
    PROFILER.reset()
    yield
    tables.clear()
    PROFILER.reset()


def cs8(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, 2 * n, dtype=np.int64).astype(np.uint8)


def conditioned(n: int = 40_000) -> stream.Stream:
    """``shift 1000 lowpass -decimate 4 (20 taps) dcblock -window 500 agc
    -window 100`` over seeded cs8 at 48 kHz."""
    src = SampleSource(cs8(n, 5), CS8, 48_000)
    return stream.Agc(stream.DcBlock(stream.LowPass(stream.Shift(src, 1_000), 8_000, 4, 20), 500), window=100)


def recorded(monkeypatch) -> list[tuple[str, torch.Tensor]]:
    """Every table the stages ask the cache for, in order, as (what, tensor)."""
    calls: list[tuple[str, torch.Tensor]] = []

    def spy(what, key, device, build):
        t = tables.device_table(what, key, device, build)
        calls.append((what, t))
        return t

    for module in (stream, fir):
        monkeypatch.setattr(module, "device_table", spy)
    return calls


# -- the tables are the host's arrays, bit for bit ----------------------------


@pytest.mark.parametrize("f,sr,n", [(1_000, 48_000, 63), (280_000, 21_000_000, 1_154_384), (-7_919, 2_400_000, 4_097)])
def test_shift_angles_are_the_host_angles(monkeypatch, f, sr, n):
    seen = []
    monkeypatch.setattr(stream, "mix", lambda x, theta: seen.append(theta) or x)

    class Ones:
        @staticmethod
        def read_batch(ctx, prep, n):
            return torch.ones((1, n), dtype=torch.complex64)

    shift = stream.Shift(SampleSource(cs8(16, 1), CS8, sr), f)
    shift.inner = Ones()
    shift.read_batch({}, {"inner": None, "theta0": torch.zeros(1)}, n)  # theta0 + delta = delta
    want = ExactNCO(f, sr).angles(np.arange(n, dtype=np.int64))
    assert seen[0].dtype == torch.float32 and seen[0][0].numpy().tobytes() == want.tobytes()


def old_polyphase(taps: np.ndarray, d: int) -> np.ndarray:
    m = -(-len(taps) // d)
    h = np.zeros(m * d, dtype=np.float32)
    h[: len(taps)] = taps
    return np.ascontiguousarray(h.reshape(m, d).T)


def old_spectrum(h: np.ndarray, n: int, axis: int = -1) -> np.ndarray:
    """The tap spectrum as the FIR uploaded it: each part of the f64
    correlation spectrum rounded to f32 apart."""
    s = fir._correlation_spectrum(h, n, axis)
    return torch.complex(torch.tensor(s.real.astype(np.float32)), torch.tensor(s.imag.astype(np.float32))).numpy()


@pytest.mark.parametrize("size,d", [(400, 32), (20, 4), (33, 2), (4000, 32)])
def test_fir_tables_are_the_host_tables(size, d):
    taps = fir.lowpass_taps(0.19 / d, size)
    key = taps.tobytes()
    hp = tables.device_table("fir.polyphase", (key, d), CPU, lambda: fir.polyphase_matrix(taps, d))
    assert hp.numpy().tobytes() == old_polyphase(taps, d).tobytes()
    assert hp.shape == (d, -(-size // d))
    w = tables.device_table("fir.banded", (key, d), CPU, lambda: fir.banded_weights(key, d))
    assert w.numpy().tobytes() == fir.banded_weights(key, d).tobytes()
    m = fir._overlap_save_frame(size)
    got = fir._complex64(fir._correlation_spectrum(taps, m))
    assert got.tobytes() == old_spectrum(taps, m).tobytes()
    md = -(-size // d)
    hp2 = np.zeros(md * d, dtype=np.complex128)
    hp2[:size] = taps
    got2 = fir._complex64(fir._correlation_spectrum(hp2.reshape(md, d), 512, axis=0).T)
    assert got2.tobytes() == np.ascontiguousarray(old_spectrum(hp2.reshape(md, d), 512, axis=0).T).tobytes()


@pytest.mark.parametrize("impl", fir.IMPLS)
def test_each_fir_impl_reads_its_table_from_the_cache(monkeypatch, impl):
    calls = recorded(monkeypatch)
    taps = fir.lowpass_taps(0.05, 33)
    x = torch.complex(torch.randn(3, 40 * 2 + 33, generator=torch.Generator().manual_seed(1)),
                      torch.randn(3, 40 * 2 + 33, generator=torch.Generator().manual_seed(2)))
    first = fir.fir_decimate(x, taps, 2, 40, impl=impl)
    uploads = tables.uploads()
    again = fir.fir_decimate(x, taps, 2, 40, impl=impl)
    assert tables.uploads() == uploads  # the second call misses nothing
    assert first.numpy().tobytes() == again.numpy().tobytes()
    assert len(calls) == 2 and calls[0][0] == f"fir.{impl}" and calls[0][1] is calls[1][1]


def test_gen_and_receiver_tables_are_the_host_arrays():
    gen = ToneGen([1_000, -2_500], 48_000, 1.0)
    delta = tables.device_table("gen.delta", (tuple(gen.cos), 48_000, 77), CPU, lambda: gen._delta(77))
    i = np.arange(77, dtype=np.int64)
    assert delta.numpy().tobytes() == np.stack([ExactNCO(f, 48_000).angles(i) for f in gen.cos]).tobytes()

    model = PipelineModel(PipelineConfig(sample_rate=48_000, shift_freq=1_000, lp_freq=8_000, decimate=4, taps=40,
                                         fft_width=32, fmt=CS8))
    c, s = model._cis(5, 3, 11, CPU)
    want_c, want_s = model._nco.cis(5 + 3 * np.arange(11, dtype=np.int64))
    assert c.numpy().tobytes() == want_c.tobytes() and s.numpy().tobytes() == want_s.tobytes()


# -- the cache ----------------------------------------------------------------


def test_the_cache_keeps_the_tables_used_last(monkeypatch):
    monkeypatch.setattr(tables, "CAPACITY", 4)
    made = []

    def table(i):
        return tables.device_table("t", i, CPU, lambda: made.append(i) or np.full(3, i, dtype=np.float32))

    first = [table(i) for i in range(4)]
    assert all(table(i) is t for i, t in enumerate(first)) and made == [0, 1, 2, 3]
    table(0)  # 0 is now the one used last
    table(4)  # evicts 1, the one used longest ago
    table(0)
    assert made == [0, 1, 2, 3, 4]
    table(1)
    assert made == [0, 1, 2, 3, 4, 1] and len(tables._tables) == 4
    assert float(table(4)[0]) == 4.0


def test_the_cache_keeps_at_most_its_bytes(monkeypatch):
    monkeypatch.setattr(tables, "CAPACITY_BYTES", 100)
    made = []

    def table(i, n=10):
        return tables.device_table("t", (i, n), CPU, lambda: made.append(i) or np.full(n, i, dtype=np.float32))

    table(0), table(1)
    table(2)  # 120 bytes: 0, used longest ago, goes
    assert [k[1][0] for k in tables._tables] == [1, 2]
    table(1)
    table(3, 50)  # 200 bytes alone: the newest is kept whatever its size
    assert [k[1][0] for k in tables._tables] == [3] and made == [0, 1, 2, 3]
    table(4)
    assert [k[1][0] for k in tables._tables] == [4]


def test_a_table_is_a_copy_of_its_host_array():
    host = np.arange(5, dtype=np.float32)
    t = tables.device_table("t", "copy", CPU, lambda: host)
    host[:] = -1
    assert t.tolist() == [0, 1, 2, 3, 4]


def test_uploads_count_the_calling_threads_misses():
    before = tables.uploads()
    tables.device_table("t", "a", CPU, lambda: np.zeros(2, np.float32))
    tables.device_table("t", "a", CPU, lambda: np.zeros(2, np.float32))
    other = []
    thread = threading.Thread(target=lambda: other.append(
        (tables.uploads(), tables.device_table("t", "b", CPU, lambda: np.ones(2, np.float32)), tables.uploads())))
    thread.start()
    thread.join()
    assert tables.uploads() == before + 1
    assert other[0][0] == 0 and other[0][2] == 1


def test_threads_share_the_cache_without_losing_a_table(monkeypatch):
    """16 threads, more than the cores, ask for 6 tables in turns with a
    capacity of 4 and a short switch interval: every table read holds its
    own key's values, the cache never holds more than its capacity, and
    each thread's count is the builds it ran."""
    import sys

    monkeypatch.setattr(tables, "CAPACITY", 4)
    wrong, counts = [], []

    def worker(seed: int) -> None:
        built = 0
        rng = np.random.default_rng(seed)

        def build(i):
            nonlocal built
            built += 1
            return np.full(64, i, dtype=np.int64)

        start = tables.uploads()
        for i in rng.integers(0, 6, 400):
            t = tables.device_table("stress", int(i), CPU, lambda i=int(i): build(i))
            with tables._lock:
                held = len(tables._tables)
            if not bool((t == int(i)).all()) or held > 4:
                wrong.append((seed, int(i), held))
        counts.append((tables.uploads() - start, built))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrong == [] and len(counts) == 16 and all(u == b for u, b in counts)


# -- the launch ----------------------------------------------------------------


def test_a_later_batch_reads_the_same_tables(monkeypatch):
    calls = recorded(monkeypatch)
    ex = runtime.Executor(conditioned(), 32, CPU)
    offs = 32 * np.arange(14, dtype=np.int64)
    ex.run(offs[:7])
    first = list(calls)
    calls.clear()
    ex.run(offs[7:])
    assert [w for w, _ in first] == [w for w, _ in calls] == ["nco.delta", "fir.polyphase"]
    assert [t.data_ptr() for _, t in first] == [t.data_ptr() for _, t in calls]


@pytest.mark.parametrize("windows_a_batch", [1, 7])
def test_table_uploads_count_on_the_first_batch_alone(monkeypatch, windows_a_batch):
    monkeypatch.setattr(sinks, "stream_batches",
                        lambda s, offs, w: runtime.stream_batches(s, offs, w, budget=w * windows_a_batch))
    lines: list[str] = []
    with profiled():
        sinks.spark_fft(conditioned(), 32, 32, out=lines.append, device=CPU)
        second = PROFILER.spans()
        sinks.spark_fft(conditioned(), 32, 32, out=lines.append, device=CPU)
    launches = sorted((s for s in PROFILER.spans() if s.name == "executor.launch"), key=lambda s: s.start)
    passes = [[s for s in launches if s.key[0] == owner] for owner in dict.fromkeys(s.key[0] for s in launches)]
    assert len(passes) == 2 and len(passes[0]) > 3 and len(second) > 0
    counts = [[s.counters["table_uploads"] for s in sorted(p, key=lambda s: s.key[1])] for p in passes]
    assert counts[0][0] >= 1 and all(c == 0 for c in counts[0][1:])
    assert all(c == 0 for c in counts[1])  # a later pass finds its tables cached


def test_a_pass_gives_the_glyphs_it_gave_before_the_cache(monkeypatch):
    """The same rows with the cache warm, cold, and cleared between batches."""
    rows = {}
    for mode in ("cold", "warm", "cleared"):
        lines: list[str] = []
        if mode == "cleared":
            orig = runtime.Executor.submit

            def submit(self, offs, aux=None):
                tables.clear()
                return orig(self, offs, aux)

            monkeypatch.setattr(runtime.Executor, "submit", submit)
        sinks.spark_fft(conditioned(), 32, 16, out=lines.append, device=CPU)
        rows[mode] = lines
    assert rows["cold"] == rows["warm"] == rows["cleared"] and len(rows["cold"]) > 100


# -- the plan's arrays ------------------------------------------------------------

ARRAYS = {
    "int64": np.arange(-3, 58, dtype=np.int64),
    "f32 0-d": np.float32(3.25),
    "f64": np.random.default_rng(0).standard_normal((3, 5)),
    "empty": np.zeros((0, 3), np.float32),
    "bool": np.array([True, False, True]),
    "int32 odd": np.arange(7, dtype=np.int32),
    "complex64": (np.arange(6) + 1j * np.arange(6)).astype(np.complex64).reshape(2, 3),
    "f32 strided": np.arange(18, dtype=np.float32)[::2],
    "uint8": np.arange(13, dtype=np.uint8),
}


class Counts:
    def __init__(self):
        self.counters: dict[str, int] = {}

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + n


@pytest.mark.parametrize("name", list(ARRAYS))
def test_each_plan_array_crosses_with_its_dtype_shape_and_values(name):
    tree = {"a": ARRAYS["uint8"], "b": {"c": ARRAYS[name], "d": ARRAYS["f32 0-d"]}}
    span = Counts()
    out = runtime._to_device(tree, CPU, span)
    for a, t in ((tree["a"], out["a"]), (tree["b"]["c"], out["b"]["c"]), (tree["b"]["d"], out["b"]["d"])):
        assert t.dtype == torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).dtype
        assert tuple(t.shape) == np.shape(a)
        assert t.numpy().tobytes() == np.asarray(a).tobytes()
    assert span.counters == {"tensors": 3, "bytes": sum(np.asarray(a).nbytes for a in runtime_leaves(tree))}


def runtime_leaves(tree) -> list:
    return [a for v in tree.values() for a in runtime_leaves(v)] if isinstance(tree, dict) else [tree]


def test_on_a_card_each_array_crosses_without_a_wait(monkeypatch):
    """The card's route with the copy itself stubbed (this CPU build has no
    CUDA): every array is copied ``non_blocking``, from page-locked memory
    up to ``_PINNED_MAX`` bytes and from its own memory past it."""
    pinned, copies = [], []

    def pin_memory(self):
        pinned.append(self.nbytes)
        return self.clone()

    def to(self, device, non_blocking=False):
        copies.append((device, non_blocking))
        return self

    monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
    monkeypatch.setattr(torch.Tensor, "to", to)
    cuda = torch.device("cuda", 0)
    edge = np.arange(runtime._PINNED_MAX, dtype=np.uint8)
    big = np.arange(runtime._PINNED_MAX // 4 + 1, dtype=np.float32)
    tree = {"small": ARRAYS["int64"], "inner": {"edge": edge, "big": big}, "scalar": ARRAYS["f32 0-d"]}
    span = Counts()
    out = runtime._to_device(tree, cuda, span)
    assert pinned == [ARRAYS["int64"].nbytes, edge.nbytes, 4]
    assert copies == [(cuda, True)] * 4
    assert out["inner"]["big"].numpy().tobytes() == big.tobytes() and out["scalar"].shape == ()
    assert span.counters == {"tensors": 4, "bytes": ARRAYS["int64"].nbytes + edge.nbytes + big.nbytes + 4}


def test_sync_upload_counts_the_plans_arrays_alone():
    """``executor.sync_upload`` counts the plan's arrays; a ``post``'s
    scalar ``aux`` crosses outside it, uncounted."""
    s = conditioned()
    offs = 32 * np.arange(9, dtype=np.int64) + 5
    lo, _ = s.span(int(offs.min()), 32)
    leaves = runtime_leaves(s.plan(offs, 32, lo).prep)
    seen = []
    ex = runtime.Executor(s, 32, CPU, post=lambda x, aux: seen.append(aux) or x.abs(), post_takes_aux=True)
    with profiled():
        ex.run(offs, aux=2.5)
    (up,) = [sp for sp in PROFILER.spans() if sp.name == "executor.sync_upload"]
    assert len(leaves) >= 8
    assert up.counters == {"tensors": len(leaves), "bytes": sum(np.asarray(a).nbytes for a in leaves)}
    assert seen[0].dtype == torch.float32 and seen[0].shape == () and float(seen[0]) == 2.5
