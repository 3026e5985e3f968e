"""The ported ``serve`` daemon against the JAX package's, case for case
with ``tests/test_serve_tcp.py``: both daemons run on threads
(``quadrs_tpu.serve.run_serve``, and ``quadrs_tpu_torch.serve.run_serve``
on the CPU), clients send the same seeded payloads over loopback while
they read, and the replies are compared.

Tolerances, as the port's command tests state them: stream norms within
``5e-5 * scale`` (``tests/test_torch_cli.py``) and bit-equal to the port's
own ``StreamRunner`` run; search peak bins exact where the top two
magnitudes differ by more than that; waterfall norms and the scan CSV
within ``rtol 2e-5, atol 2e-5 * max`` (``tests/test_torch_waterfall_cli.py``),
threshold counts off only by norms that close to the threshold; ``find``'s
offsets and ``which`` exact, scores and scales within ``2e-4``; ``ook`` and
``fsk`` text exact, PSK's bits exact but at counted near-ties; audio
header lines exact and samples within ``1e-5`` of full scale; trailers and
log lines equal but for the time and ``Msps`` figures and the ports.
``-mesh``: stream norms byte for byte a direct mesh ``StreamRunner``'s, and
within ``1e-5`` of scale of the unmeshed daemon's; ``fsk`` and ``find``
replies those of the unmeshed daemon."""

import io
import pathlib
import re
import socket
import struct
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import args as jargs  # noqa: E402
from quadrs_tpu import cli as jcli  # noqa: E402
from quadrs_tpu import serve as jserve  # noqa: E402
from quadrs_tpu.models import demod as jdemod  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFileFormat  # noqa: E402
from quadrs_tpu.sources import SampleSource as JSampleSource  # noqa: E402

from quadrs_tpu_torch import args as targs  # noqa: E402
from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch import serve as tserve  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.models import demod as tdemod  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402
from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel  # noqa: E402
from quadrs_tpu_torch.ops import frontend as fe  # noqa: E402
from quadrs_tpu_torch.sources import PipeSource, SampleSource  # noqa: E402
from quadrs_tpu_torch.stream_runner import StreamRunner, WaterfallRunner  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
CPU = torch.device("cpu")
TOL = 5e-5  # stream norms and magnitudes, of the scale
WF_RTOL = 2e-5  # waterfall norms and the scan's sums: rtol, and atol of the max
FIND_TOL = 2e-4  # find's scores and scales
AUDIO_TOL = 1e-5  # of full scale
NEAR = 1e-5  # rad: a PSK decision this close to a slicing boundary is a near-tie


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    """The port's CLI runs on the CPU here (it asks for CUDA when unset)."""
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")


# -- the daemons and their clients ------------------------------------------------


def serve_cmd(args_mod, **kw):
    base = dict(
        port=0, host="127.0.0.1", once=True, search=False, shift=1_000, lowpass=8_000, size=40, decimate=4,
        fft_width=32, chunk=8_000, sample_rate="48k", format="cs8",
    )
    base.update(kw)
    return args_mod.ServeCmd(**base)


def start(pkg: str, max_connections=None, **kw):
    """``run_serve`` of the port (``torch``, on the CPU) or of the JAX package
    (``jax``) on a thread; returns (thread, bound port, startup errors)."""
    port_box: list[int] = []
    errors: list[BaseException] = []
    evt = threading.Event()

    def ready(p):
        port_box.append(p)
        evt.set()

    def run():
        try:
            if pkg == "torch":
                tserve.run_serve(serve_cmd(targs, **kw), CPU, ready=ready, max_connections=max_connections)
            else:
                jserve.run_serve(serve_cmd(jargs, **kw), ready=ready, max_connections=max_connections)
        except BaseException as e:  # reported by the test, not lost on the thread
            errors.append(e)
            evt.set()

    th = threading.Thread(target=run)
    th.start()
    assert evt.wait(60), "server never came up"
    assert not errors, errors
    return th, port_box[0], errors


def join(th, errors) -> None:
    th.join(timeout=60)
    assert not th.is_alive() and not errors, errors


def session(port: int, payload: bytes) -> bytes:
    """One client session: send all, half-close, read to EOF, with a
    reader thread draining while the payload goes out."""
    out: list[bytes] = []
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:

        def drain():
            while True:
                b = s.recv(1 << 16)
                if not b:
                    return
                out.append(b)

        rd = threading.Thread(target=drain)
        rd.start()
        s.sendall(payload)
        s.shutdown(socket.SHUT_WR)
        rd.join(timeout=60)
        assert not rd.is_alive(), "server never closed the connection"
    return b"".join(out)


def trickle(port: int, payload: bytes, pieces: int = 6, pause: float = 0.05) -> bytes:
    """A client that sends its payload in ``pieces`` timed pieces."""
    out: list[bytes] = []
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:

        def drain():
            while True:
                b = s.recv(1 << 16)
                if not b:
                    return
                out.append(b)

        rd = threading.Thread(target=drain)
        rd.start()
        step = max(1, len(payload) // pieces)
        for off in range(0, len(payload), step):
            s.sendall(payload[off : off + step])
            time.sleep(pause)
        s.shutdown(socket.SHUT_WR)
        rd.join(timeout=120)
        assert not rd.is_alive()
    return b"".join(out)


def serve_both(capsys, payloads, **kw) -> tuple[dict[str, list[bytes]], dict[str, str]]:
    """Each payload as one session of the JAX package's daemon, then of the
    port's; returns each daemon's replies and log."""
    replies, logs = {}, {}
    many = len(payloads) > 1
    for pkg in ("jax", "torch"):
        th, port, errors = start(pkg, max_connections=len(payloads) if many else None, once=not many, **kw)
        replies[pkg] = [session(port, p) for p in payloads]
        join(th, errors)
        logs[pkg] = capsys.readouterr().out
    return replies, logs


def untimed(text: str) -> list[str]:
    """Lines with the ports, the seconds and the Msps figures blanked."""
    text = re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:P", text)
    return [re.sub(r"\d+\.\d+s, \d+\.\d+ Msps", "Ts, R Msps", ln) for ln in text.splitlines()]


def capture(n: int, fmt=FileFormat.COMPLEX_INT8, seed: int = 41) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, n * fmt.pair_bytes, dtype=np.int64).astype(np.uint8).tobytes()


def cf32(x: np.ndarray) -> bytes:
    raw = np.empty(2 * len(x), dtype="<f4")
    raw[0::2], raw[1::2] = x.real, x.imag
    return raw.tobytes()


# -- the port's own runs, and the comparisons --------------------------------------


def direct_stream(data: bytes, chunk: int = 8_000, search: bool = False):
    """The port's StreamRunner over the bytes in memory at ``serve_cmd``'s
    channel: (first window, output) per chunk."""
    model = PipelineModel(PipelineConfig(sample_rate=48_000, shift_freq=1_000, lp_freq=8_000, decimate=4, taps=40,
                                         fft_width=32, fmt=FileFormat.COMPLEX_INT8))
    runner = StreamRunner(SampleSource(np.frombuffer(data, dtype=np.uint8), model.cfg.fmt, 48_000), model, CPU,
                          chunk_samples=chunk)
    rows = []
    (runner.run_search if search else runner.run)(lambda w, o: rows.append((w, o)))
    return rows


def direct_norms(data: bytes, chunk: int = 8_000) -> np.ndarray:
    return np.concatenate([n for _, n in direct_stream(data, chunk)])


def search_lines(rows, waterfall: bool = False) -> list[str]:
    """The ``window,bin,mag`` lines of per-chunk peaks."""
    out = []
    for w0, (idx, val) in rows:
        if waterfall:
            idx, val = idx[0], val[0]
        out += [f"{w0 + i},{int(idx[i])},{float(val[i]):.9g}" for i in range(len(idx))]
    return out


def margins(norms: np.ndarray) -> np.ndarray:
    """Each row's top magnitude less its second."""
    top2 = np.sort(norms, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def assert_search_close(got: list[str], want: list[str], norms: np.ndarray, atol: float) -> None:
    """Peak CSV rows: windows equal, magnitudes within ``atol``, bins equal
    where the row's top two magnitudes differ by more than ``atol``."""
    g = np.array([ln.split(",") for ln in got], dtype=np.float64).reshape(-1, 3)
    w = np.array([ln.split(",") for ln in want], dtype=np.float64).reshape(-1, 3)
    assert g.shape == w.shape == (norms.shape[0], 3)
    assert (g[:, 0] == w[:, 0]).all()
    assert np.abs(g[:, 2] - w[:, 2]).max() <= atol
    clear = margins(norms) > atol
    assert (g[clear, 1] == w[clear, 1]).all()


def wf_runner(data: bytes, width: int, stride: int, chunk: int) -> WaterfallRunner:
    """The port's WaterfallRunner over a pipe of the bytes."""
    model = WaterfallModel(WaterfallConfig(n_streams=1, fft_width=width, stride=stride, fmt=FileFormat.COMPLEX_INT8))
    return WaterfallRunner([PipeSource(io.BytesIO(data), FileFormat.COMPLEX_INT8, 48_000)], model, CPU,
                           chunk_windows=chunk)


def wf_norms(data: bytes, width: int, stride: int, chunk: int) -> np.ndarray:
    """:func:`wf_runner`'s norms: (windows, width)."""
    rows = []
    wf_runner(data, width, stride, chunk).run(lambda w0, n: rows.append(n[0]))
    return np.concatenate(rows)


def reply_lines(reply: bytes) -> list[str]:
    return reply.decode().strip().splitlines()


def audio_of(reply: bytes, mode: str) -> tuple[str, np.ndarray, str]:
    """(header line, samples, trailer) of an audio reply."""
    header, rest = reply.split(b"\n", 1)
    n, rate = header.decode().removeprefix(f"# {mode} ").split()
    audio = np.frombuffer(rest[: 4 * int(n)], dtype="<f4")
    return header.decode(), audio, rest[4 * int(n) :].decode()


def assert_audio_close(t_reply: bytes, j_reply: bytes, mode: str) -> np.ndarray:
    t_head, t_audio, t_trail = audio_of(t_reply, mode)
    j_head, j_audio, j_trail = audio_of(j_reply, mode)
    assert (t_head, t_trail) == (j_head, j_trail)
    assert t_trail.startswith(f"\n# {mode}: ")
    assert np.abs(t_audio - j_audio).max() <= AUDIO_TOL
    return t_audio


def decision_angles(sym: np.ndarray) -> np.ndarray:
    """The differential decisions' angles."""
    s = sym.astype(np.complex128)
    d = s[1:] * np.conj(s[:-1])
    return np.arctan2(d.imag, d.real)


def near_ties(ang: np.ndarray, order: int) -> np.ndarray:
    step = 2 * np.pi / order
    frac = ang / step - 0.5
    return np.abs(frac - np.round(frac)) * step < NEAR


# -- stream, waterfall, scan -------------------------------------------------------


def test_serve_norms_roundtrip(capsys):
    data = capture(30_000)
    replies, logs = serve_both(capsys, [data])
    got = np.frombuffer(replies["torch"][0], dtype=np.float32).reshape(-1, 32)
    np.testing.assert_array_equal(got, direct_norms(data))
    want = np.frombuffer(replies["jax"][0], dtype=np.float32).reshape(-1, 32)
    assert got.shape == want.shape and np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert "serve: listening on 127.0.0.1:" in logs["torch"]
    assert "serve: conn 1 " in logs["torch"] and "Msps" in logs["torch"]
    assert untimed(logs["torch"]) == untimed(logs["jax"])


def test_serve_search_two_connections_no_remake(capsys):
    """Two sessions against one daemon, then an empty one: each reply's
    lines are the port's own run_search, and the JAX daemon's within the
    tolerance; the empty session answers the header and the trailer."""
    payloads = [capture(25_000, seed=42), capture(25_000, seed=43), b""]
    replies, logs = serve_both(capsys, payloads, search=True)
    for i, data in enumerate(payloads[:2]):
        t, j = reply_lines(replies["torch"][i]), reply_lines(replies["jax"][i])
        assert t[0] == "window,bin,mag" and t[-1].startswith("# stream: ")
        assert t[1:-1] == search_lines(direct_stream(data, search=True))
        norms = direct_norms(data)
        assert_search_close(t[1:-1], j[1:-1], norms, TOL * norms.max())
        assert untimed(t[-1]) == untimed(j[-1])
    empty = reply_lines(replies["torch"][2])
    assert empty[0] == "window,bin,mag" and untimed("\n".join(empty)) == untimed(replies["jax"][2].decode().strip())
    assert untimed(logs["torch"]) == untimed(logs["jax"])


def test_serve_waterfall_mode(capsys):
    """-mode waterfall -search: the port's WaterfallRunner over a pipe of
    the same bytes, line for line, and the JAX daemon's lines within the
    waterfall tolerance."""
    data = capture(20_000, seed=44)
    kw = dict(search=True, mode="waterfall", fft_width=128, chunk=50, stride=64)
    replies, logs = serve_both(capsys, [data], **kw)
    t, j = reply_lines(replies["torch"][0]), reply_lines(replies["jax"][0])
    assert t[0] == "window,bin,mag" and t[-1].startswith("# waterfall: ")
    rows = []
    wf_runner(data, 128, 64, 50).run_search(lambda w0, o: rows.append((w0, o)))
    assert t[1:-1] == search_lines(rows, waterfall=True)
    norms = wf_norms(data, 128, 64, 50)
    assert_search_close(t[1:-1], j[1:-1], norms, WF_RTOL * norms.max() * 2)
    assert untimed(t[-1]) == untimed(j[-1]) and untimed(logs["torch"]) == untimed(logs["jax"])


def test_serve_waterfall_norms_mode(capsys):
    """-mode waterfall without -search streams raw f32 spectrogram rows."""
    data = capture(15_000, seed=45)
    replies, logs = serve_both(capsys, [data], mode="waterfall", fft_width=128, chunk=40)
    got = np.frombuffer(replies["torch"][0], dtype=np.float32).reshape(-1, 128)
    np.testing.assert_array_equal(got, wf_norms(data, 128, 128, 40))
    want = np.frombuffer(replies["jax"][0], dtype=np.float32).reshape(-1, 128)
    np.testing.assert_allclose(got, want, rtol=WF_RTOL, atol=WF_RTOL * want.max())
    assert untimed(logs["torch"]) == untimed(logs["jax"])


def test_serve_scan_mode(capsys):
    """-mode scan answers with the band-survey CSV: the port's pipe
    run_scan line for line, and the JAX daemon's within the waterfall
    tolerance (counts off only by norms that close to the threshold)."""
    data = capture(20_000, seed=47)
    kw = dict(mode="scan", fft_width=128, chunk=50, stride=64, threshold=8.0)
    replies, logs = serve_both(capsys, [data], **kw)
    t, j = reply_lines(replies["torch"][0]), reply_lines(replies["jax"][0])
    assert t[0] == j[0] == "bin,freq_hz,avg,max,above,occupancy" and len(t) == len(j) == 1 + 128 + 1
    assert t[-1].startswith("# scan: ") and "threshold 8" in t[-1] and untimed(t[-1]) == untimed(j[-1])
    result = wf_runner(data, 128, 64, 50).run_scan(threshold=8.0)
    freq = (np.arange(128) - 64) * (48_000 / 128)
    assert t[:129] == [ln.rstrip("\n") for ln in tserve._scan_csv_lines(result, 0, freq)]
    g = np.array([ln.split(",") for ln in t[1:129]], dtype=np.float64)
    w = np.array([ln.split(",") for ln in j[1:129]], dtype=np.float64)
    norms = wf_norms(data, 128, 64, 50)
    peak = norms.max()
    np.testing.assert_array_equal(g[:, :2], w[:, :2])
    np.testing.assert_allclose(g[:, 2:4], w[:, 2:4], rtol=WF_RTOL, atol=WF_RTOL * peak)
    near = (np.abs(norms - 8.0) <= WF_RTOL * peak).sum(axis=0)
    assert (np.abs(g[:, 4] - w[:, 4]) <= near).all()
    assert 0.0 < g[:, 5].mean() < 1.0  # occupancy discriminates at this threshold
    assert untimed(logs["torch"]) == untimed(logs["jax"])


def test_serve_parallel_concurrent_sessions(capsys):
    """-parallel 2 serves two simultaneous connections over the one model;
    each reply is its own direct run's, and the JAX daemon's within the
    tolerance."""
    payloads = [capture(25_000, seed=s) for s in (47, 48)]
    replies: dict[str, list] = {}
    for pkg in ("jax", "torch"):
        th, port, errors = start(pkg, max_connections=2, search=True, once=False, parallel=2)
        results: list[bytes | None] = [None, None]

        def client(i):
            results[i] = session(port, payloads[i])

        clients = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
            assert not c.is_alive()
        join(th, errors)
        replies[pkg] = results
        out = capsys.readouterr().out
        assert "parallel 2" in out and "serve: conn 1 " in out and "serve: conn 2 " in out
    for i, data in enumerate(payloads):
        t, j = reply_lines(replies["torch"][i]), reply_lines(replies["jax"][i])
        assert t[0] == "window,bin,mag" and t[-1].startswith("# stream: ")
        assert t[1:-1] == search_lines(direct_stream(data, search=True))
        norms = direct_norms(data)
        assert_search_close(t[1:-1], j[1:-1], norms, TOL * norms.max())


def test_serve_parallel_tables_made_once(capsys, monkeypatch):
    """The shared model's lazily made tables are made once, by the warm run
    before the daemon listens, and never by a session: four sessions under
    -parallel 2 make no decode table."""
    made = []
    real = fe.decode_tensor

    def counted(*a, **kw):
        made.append(threading.current_thread().name)
        return real(*a, **kw)

    monkeypatch.setattr(fe, "decode_tensor", counted)
    th, port, errors = start("torch", max_connections=4, search=True, once=False, parallel=2)
    assert len(made) == 1  # the warm run, before ready
    payloads = [capture(12_000, seed=90 + i) for i in range(4)]
    results: list[bytes | None] = [None] * 4

    def client(i):
        results[i] = session(port, payloads[i])

    clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=120)
        assert not c.is_alive()
    join(th, errors)
    assert len(made) == 1
    for data, reply in zip(payloads, results):
        assert reply_lines(reply)[1:-1] == search_lines(direct_stream(data, search=True))
    assert capsys.readouterr().out.count("done") == 4


@pytest.mark.parametrize("mode", ["stream", "waterfall", "ook"])
def test_serve_timeout_drops_stalled_client(capsys, mode):
    """-timeout S: a client that connects and then sends nothing is dropped
    after ~S seconds, and the next connection is served.  In ``stream`` and
    ``waterfall`` the read that times out runs on the runner's staging
    thread; the session gets its exception.  (The JAX package's case is
    ``stream``; its daemon logs the same lines.)"""
    kw = dict(stream={}, waterfall=dict(fft_width=128, chunk=40),
              ook=dict(fft_width=4, stride=2, bit=16.0, sample_rate="400", format="cf32"))[mode]
    path = EXAMPLES / "ook-sim.sr400.cf32"
    data = path.read_bytes() if mode == "ook" else capture(20_000, seed=71)
    logs, good = {}, {}
    for pkg in ("jax", "torch"):
        th, port, errors = start(pkg, max_connections=2, once=False, timeout=0.5, mode=mode, **kw)
        stalled = socket.create_connection(("127.0.0.1", port), timeout=30)
        try:
            # no bytes, no half-close: the daemon's first read blocks until
            # the timeout fires, and the session is dropped: EOF (or a reset)
            stalled.settimeout(10)
            t0 = time.perf_counter()
            try:
                got = stalled.recv(1024)
            except OSError:
                got = b""
            waited = time.perf_counter() - t0
            assert got == b"", "expected the server to close the stalled session"
            assert waited < 8, f"stalled session held for {waited:.1f}s"
        finally:
            stalled.close()
        good[pkg] = session(port, data)
        join(th, errors)
        logs[pkg] = capsys.readouterr().out
    assert "timeout 0.5s" in logs["torch"]
    assert "serve: conn 1 failed: TimeoutError" in logs["torch"]
    assert "serve: conn 2 " in logs["torch"] and "done" in logs["torch"]
    assert untimed(logs["torch"]) == untimed(logs["jax"])
    if mode == "stream":
        np.testing.assert_array_equal(np.frombuffer(good["torch"], dtype=np.float32).reshape(-1, 32), direct_norms(data))
    elif mode == "waterfall":
        np.testing.assert_array_equal(np.frombuffer(good["torch"], dtype=np.float32).reshape(-1, 128),
                                      wf_norms(data, 128, 128, 40))
    else:
        assert good["torch"] == good["jax"]


def test_serve_timeout_frees_parallel_slots(capsys):
    """Two stalled clients fill both -parallel 2 slots; the timeout, raised
    on their staging threads, frees them, so a third session completes."""
    th, port, errors = start("torch", max_connections=3, once=False, parallel=2, timeout=0.5)
    stalled = [socket.create_connection(("127.0.0.1", port), timeout=30) for _ in range(2)]
    try:
        data = capture(20_000, seed=72)
        good = session(port, data)  # queued behind the stalled pair
        np.testing.assert_array_equal(np.frombuffer(good, dtype=np.float32).reshape(-1, 32), direct_norms(data))
    finally:
        for s in stalled:
            s.close()
    join(th, errors)
    out = capsys.readouterr().out
    assert out.count("failed: TimeoutError") == 2
    assert "serve: conn 3 " in out and "done" in out


def test_serve_parallel_soak_interleaved_slow_fast(capsys):
    """-parallel 4 soak: eight concurrent sessions, half trickling their
    capture in timed pieces, half sending at once.  Every reply is its own
    direct run's, line for line, and the JAX daemon's within the tolerance;
    no trickler is dropped by the timeout (the clock restarts on every
    completed socket operation)."""
    payloads = [capture(15_000, seed=80 + i) for i in range(8)]
    replies: dict[str, list] = {}
    for pkg in ("jax", "torch"):
        th, port, errors = start(pkg, max_connections=8, search=True, once=False, parallel=4, timeout=5.0)
        results: list[bytes | None] = [None] * 8

        def client(i):
            results[i] = (trickle if i % 2 else session)(port, payloads[i])

        clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
            assert not c.is_alive()
        join(th, errors)
        replies[pkg] = results
        out = capsys.readouterr().out
        assert out.count("done") == 8 and "failed" not in out
    for i, data in enumerate(payloads):
        t, j = reply_lines(replies["torch"][i]), reply_lines(replies["jax"][i])
        assert t[0] == "window,bin,mag" and t[-1].startswith("# stream: ")
        assert t[1:-1] == search_lines(direct_stream(data, search=True)), f"session {i} mismatch"
        norms = direct_norms(data)
        assert_search_close(t[1:-1], j[1:-1], norms, TOL * norms.max())


def test_serve_timeout_parse_and_banner(capsys):
    (cmd,) = targs.parse("serve -timeout 2.5 -sr 48k -format cs8".split())
    assert cmd.timeout == 2.5
    argv = ["serve", "-timeout", "-1", "-sr", "48k", "-format", "cs8"]
    assert tcli.main(argv) == 1
    t_err = capsys.readouterr().err
    assert "-timeout must be >= 0" in t_err
    assert jcli.main(argv) == 1 and capsys.readouterr().err == t_err


# -- -mesh ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode,kw",
    [
        ("stream", {}),
        ("fsk", dict(shift=0, lowpass=8_000, size=20, decimate=4, fft_width=64, stride=600, format="cf32")),
        ("find", dict(patterns=("sync.sr48k.cf32",), threshold=0.8, chunk=1 << 13, format="cf32")),
    ],
)
def test_serve_mesh_refused_before_listening(capsys, tmp_path, monkeypatch, mode, kw):
    """``serve -mesh 2`` (the JAX package's three -mesh cases: stream, fsk,
    find) through the CLI: fsk's parser refuses it before anything listens,
    with quadjax's text; stream's and find's parse as quadjax's, and their
    daemons listen with a ``, mesh 2x1`` banner and log one session as
    quadjax's daemon does (the times and ports aside)."""
    monkeypatch.chdir(tmp_path)
    argv = ["serve", "-mode", mode, "-mesh", "2", "-sr", "48k", "-format", "cf32"]
    if mode == "find":
        argv += ["-pattern", "sync.sr48k.cf32"]
    if mode == "fsk":
        assert tcli.main(argv) == 1
        out, err = capsys.readouterr()
        assert "listening" not in out and "-mesh does not apply to -mode fsk" in err
        assert jcli.main(argv) == 1 and capsys.readouterr().err == err
        return
    (t_cmd,), (j_cmd,) = targs.parse(argv), jargs.parse(argv)
    assert t_cmd.mesh == j_cmd.mesh == (2, 1)
    payload, _ = find_case(tmp_path)
    _, logs = serve_both(capsys, [payload], mesh=(2, 1), **dict(kw, format="cf32", sample_rate="48k"))
    assert ", mesh 2x1)" in logs["torch"] and "done" in logs["torch"]
    assert untimed(logs["torch"]) == untimed(logs["jax"])


def test_serve_mesh_matches_direct_mesh_run(capsys):
    """``serve -mesh 4x1`` time-shards each connection's chunks over the
    mesh (the socket is a live pipe): the reply is byte for byte a direct
    mesh ``StreamRunner`` over the same bytes, within ``1e-5`` of scale of
    the unmeshed daemon's (the mesh bound of the stream), and within the
    stream tolerance of quadjax's mesh daemon."""
    from quadrs_tpu_torch.parallel.sharding import make_mesh

    data = capture(30_000, seed=46)
    replies, logs = serve_both(capsys, [data], mesh=(4, 1))
    assert "mesh 4x1" in logs["torch"] and untimed(logs["torch"]) == untimed(logs["jax"])
    model = PipelineModel(PipelineConfig(sample_rate=48_000, shift_freq=1_000, lp_freq=8_000, decimate=4, taps=40,
                                         fft_width=32, fmt=FileFormat.COMPLEX_INT8))
    rows = []
    StreamRunner(SampleSource(np.frombuffer(data, dtype=np.uint8), model.cfg.fmt, 48_000), model, CPU,
                 chunk_samples=8_000, mesh=make_mesh(4, 1, devices=[CPU] * 4)).run(lambda w, n: rows.append(n))
    got = np.frombuffer(replies["torch"][0], dtype=np.float32).reshape(-1, 32)
    assert got.tobytes() == np.concatenate(rows).tobytes()
    single = direct_norms(data)
    assert got.shape == single.shape
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-5 * single.max())
    want = np.frombuffer(replies["jax"][0], dtype=np.float32).reshape(-1, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * want.max())


def test_serve_fsk_demod_mode_mesh(capsys):
    """``serve -mode fsk -mesh 4`` time-shards each burst's front end: the
    reply is byte for byte the unmeshed daemon's, and quadjax's mesh
    daemon's."""
    path = EXAMPLES / "fsk-sim.sr48k.cf32"
    kw = dict(mode="fsk", shift=0, lowpass=8_000, size=20, decimate=4, fft_width=64, stride=600, bit=None,
              sample_rate="48k", format="cf32")
    th, port, errors = start("torch", **kw)
    want = session(port, path.read_bytes())
    join(th, errors)
    capsys.readouterr()
    replies, logs = serve_both(capsys, [path.read_bytes()], mesh=(4, 1), **kw)
    assert "mesh 4x1" in logs["torch"] and untimed(logs["torch"]) == untimed(logs["jax"])
    assert replies["torch"][0] == want == replies["jax"][0]


def test_serve_find_mesh(capsys, tmp_path):
    """``serve -mode find -mesh 4`` buffers each burst and time-shards the
    correlation: the reply lines are the unmeshed daemon's, and quadjax's
    mesh daemon's within the find tolerance."""
    payload, pat_path = find_case(tmp_path, seed=62)
    kw = dict(mode="find", patterns=(str(pat_path),), threshold=0.8, chunk=1 << 13, sample_rate="48k", format="cf32")
    th, port, errors = start("torch", **kw)
    want = reply_lines(session(port, payload))
    join(th, errors)
    capsys.readouterr()
    replies, _ = serve_both(capsys, [payload], mesh=(4, 1), **kw)
    got, j = reply_lines(replies["torch"][0]), reply_lines(replies["jax"][0])
    assert [ln.split(",")[0] for ln in got[:-1]] == ["3000", "30000"]
    assert got == want
    assert_matches_close(got[:-1], j[:-1])
    assert got[-1] == j[-1]


def test_serve_find_mesh_buffer_cap(capsys, tmp_path, monkeypatch):
    """A ``-mode find -mesh`` burst past the buffer cap answers with
    quadjax's error line and the session fails; the cap is cut to 4 KiB
    here, in both daemons."""
    monkeypatch.setattr(tserve, "_STDIN_BUFFER_CAP", 4096)
    monkeypatch.setattr(jserve, "_STDIN_BUFFER_CAP", 4096)
    payload, pat_path = find_case(tmp_path)
    kw = dict(mode="find", patterns=(str(pat_path),), threshold=0.8, chunk=1 << 13, sample_rate="48k", format="cf32",
              mesh=(2, 1))
    replies, logs = serve_both(capsys, [payload[:4097]], **kw)
    line = ("# error: connection burst exceeds the buffer cap (1 GiB); find -mesh buffers the whole burst — "
            "drop -mesh for unbounded streams")
    assert reply_lines(replies["torch"][0]) == [line] and replies["torch"][0] == replies["jax"][0]
    assert "serve: conn 1 failed: ValueError: connection burst exceeds the buffer cap" in logs["torch"]
    assert untimed(logs["torch"]) == untimed(logs["jax"])


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_serve_waterfall_mesh(capsys, mesh):
    """``-mode waterfall -mesh 2`` time-shards each connection's bank of one
    stream: the norms are the unmeshed daemon's, bit for bit, and quadjax's
    within the waterfall tolerance.  ``-mesh 2x2`` asks a connection's one
    stream to fill two stream rows: each session fails, logged as
    quadjax's daemon logs it, and the daemon goes on."""
    data = capture(15_000, seed=49)
    kw = dict(mode="waterfall", fft_width=128, stride=64, chunk=40)
    if mesh[1] == 2:
        logs = {}
        for pkg in ("jax", "torch"):
            th, port, errors = start(pkg, mesh=mesh, **kw)
            with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
                assert s.recv(1) == b""  # the daemon closes the session before it reads
            join(th, errors)
            logs[pkg] = capsys.readouterr().out
        assert "serve: conn 1 failed: ValueError: 1 sources do not shard over 2 'stream' mesh rows" in logs["torch"]
        assert untimed(logs["torch"]) == untimed(logs["jax"]) and "mesh 2x2" in logs["torch"]
        return
    replies, logs = serve_both(capsys, [data], mesh=mesh, **kw)
    assert untimed(logs["torch"]) == untimed(logs["jax"]) and "mesh 2x1" in logs["torch"]
    got = np.frombuffer(replies["torch"][0], dtype=np.float32).reshape(-1, 128)
    np.testing.assert_array_equal(got, wf_norms(data, 128, 64, 40))
    want = np.frombuffer(replies["jax"][0], dtype=np.float32).reshape(-1, 128)
    np.testing.assert_allclose(got, want, rtol=WF_RTOL, atol=WF_RTOL * want.max())


def test_serve_parallel_mesh_sessions(capsys):
    """``-parallel 2 -mesh 2``: two sessions at once, each time-sharded
    over the mesh (a stream of its own on each device, a ring a shard): each
    reply is its own direct mesh run's, byte for byte."""
    from quadrs_tpu_torch.parallel.sharding import make_mesh

    payloads = [capture(25_000, seed=s) for s in (47, 48)]
    th, port, errors = start("torch", max_connections=2, search=True, once=False, parallel=2, mesh=(2, 1))
    results: list[bytes | None] = [None, None]

    def client(i):
        results[i] = session(port, payloads[i])

    clients = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=120)
        assert not c.is_alive()
    join(th, errors)
    out = capsys.readouterr().out
    assert "mesh 2x1, parallel 2" in out and out.count(" done: ") == 2
    model = PipelineModel(PipelineConfig(sample_rate=48_000, shift_freq=1_000, lp_freq=8_000, decimate=4, taps=40,
                                         fft_width=32, fmt=FileFormat.COMPLEX_INT8))
    for data, reply in zip(payloads, results):
        rows = []
        StreamRunner(PipeSource(io.BytesIO(data), model.cfg.fmt, 48_000), model, CPU, chunk_samples=8_000,
                     mesh=make_mesh(2, 1, devices=[CPU] * 2)).run_search(lambda w, o: rows.append((w, o)))
        lines = reply_lines(reply)
        assert lines[1:-1] == search_lines(rows) and lines[-1].startswith("# stream: ")


# -- the receivers ---------------------------------------------------------------------


def test_serve_ook_demod_mode(capsys):
    """-mode ook answers with exactly the lines ``ook`` prints for the same
    bytes, and the JAX daemon's reply."""
    path = EXAMPLES / "ook-sim.sr400.cf32"
    kw = dict(mode="ook", fft_width=4, stride=2, bit=16.0, threshold=0.001, raw=False, sample_rate="400", format="cf32")
    replies, logs = serve_both(capsys, [path.read_bytes()], **kw)
    assert "ook bits" in logs["torch"] and untimed(logs["torch"]) == untimed(logs["jax"])
    assert tcli.main(["ook", "-bit", "16", str(path)]) == 0
    want_bits, want_stats = capsys.readouterr().out.strip().splitlines()
    assert reply_lines(replies["torch"][0]) == [want_bits, f"# {want_stats}"]
    assert replies["torch"][0] == replies["jax"][0]


def test_serve_fsk_demod_mode(capsys):
    """-mode fsk answers with the symbols ``fsk`` prints (no -bit)."""
    path = EXAMPLES / "fsk-sim.sr48k.cf32"
    kw = dict(mode="fsk", shift=0, lowpass=8_000, size=20, decimate=4, fft_width=64, stride=600, bit=None,
              sample_rate="48k", format="cf32")
    replies, logs = serve_both(capsys, [path.read_bytes()], **kw)
    assert "fsk bits" in logs["torch"] and untimed(logs["torch"]) == untimed(logs["jax"])
    argv = ["fsk", "-lowpass", "8k", "-power", "10", "-decimate", "4", "-width", "64", "-stride", "600", str(path)]
    assert tcli.main(argv) == 0
    want_syms, want_stats = capsys.readouterr().out.strip().splitlines()
    assert reply_lines(replies["torch"][0]) == [want_syms, f"# {want_stats}"]
    assert replies["torch"][0] == replies["jax"][0]


def test_serve_fsk_bits_mode(capsys):
    """-mode fsk -bit N answers with the clock-recovered bits."""
    path = EXAMPLES / "fsk-sim.sr48k.cf32"
    kw = dict(mode="fsk", shift=0, lowpass=8_000, size=20, decimate=4, fft_width=64, stride=600, bit=4.0,
              sample_rate="48k", format="cf32")
    replies, _ = serve_both(capsys, [path.read_bytes()], **kw)
    lines = reply_lines(replies["torch"][0])
    assert len(lines) == 2 and lines[1].startswith("# fsk: ") and "bits, clock error" in lines[1]
    assert replies["torch"][0] == replies["jax"][0]


def psk_payload() -> tuple[bytes, np.ndarray]:
    """A differential BPSK burst at 128 kHz, 2 kbaud, with a carrier offset
    and a common phase (``tests/test_serve_tcp.py``'s)."""
    tau = 2 * np.pi
    rng = np.random.default_rng(9)
    incr = rng.integers(0, 2, 96)
    sr, sps_raw = 128_000, 64.0
    a = np.cumsum(incr) % 2
    n = int(len(a) * sps_raw)
    k = np.minimum((np.arange(n) / sps_raw).astype(np.int64), len(a) - 1)
    ph = tau * a[k] / 2 + 0.5 + tau * 60.0 * np.arange(n) / sr
    return cf32(np.exp(1j * ph)), incr


def test_serve_psk_demod_mode(capsys, tmp_path):
    """-mode psk answers with exactly the lines ``psk`` prints for the same
    bytes; the JAX daemon's bits are the same but at counted near-ties."""
    payload, incr = psk_payload()
    kw = dict(mode="psk", shift=0, lowpass=5_000, size=64, decimate=4, symbol_rate=2_000.0, order=2,
              sample_rate="128k", format="cf32")
    replies, logs = serve_both(capsys, [payload], **kw)
    assert "psk bits" in logs["torch"]
    path = tmp_path / "psk-sim.sr128k.cf32"
    path.write_bytes(payload)
    assert tcli.main(["psk", "-lowpass", "5k", "-power", "32", "-decimate", "4", "-symbol-rate", "2k", str(path)]) == 0
    want_bits, want_stats = capsys.readouterr().out.strip().splitlines()
    got = reply_lines(replies["torch"][0])
    assert got == [want_bits, f"# {want_stats}"]
    assert want_bits in "".join(map(str, incr))
    j_bits, j_stats = reply_lines(replies["jax"][0])
    src = JSampleSource(np.frombuffer(payload, dtype=np.uint8), JFileFormat.COMPLEX_FLOAT32, 128_000)
    _, j_sym = jdemod.PskDemod(bandwidth=5_000, decimate=4, taps=64, symbol_rate=2_000.0).symbols(src)
    assert len(got[0]) == len(j_bits)
    bad = np.flatnonzero(np.frombuffer(got[0].encode(), np.uint8) != np.frombuffer(j_bits.encode(), np.uint8))
    assert near_ties(decision_angles(j_sym), 2)[bad].all()
    assert got[1] == f"# {j_stats.removeprefix('# ')}"


def fm_payload() -> bytes:
    sr = 100_000
    t = np.arange(60_000) / sr
    inst = 3_000.0 * np.cos(2 * np.pi * 200.0 * t)
    phase = 2 * np.pi * np.cumsum(inst) / sr
    return cf32(np.cos(phase) + 1j * np.sin(phase))


def test_serve_fm_demod_mode(capsys):
    """-mode fm answers with a header line, the f32 audio and a trailer; the
    audio is the port's FmDemod run on the same bytes, and the JAX daemon's
    within 1e-5 of full scale."""
    payload = fm_payload()
    kw = dict(mode="fm", shift=0, lowpass=10_000, size=80, decimate=4, bit=None, deviation=3_000.0,
              sample_rate="100k", format="cf32")
    replies, logs = serve_both(capsys, [payload], **kw)
    assert "fm audio" in logs["torch"] and untimed(logs["torch"]) == untimed(logs["jax"])
    audio = assert_audio_close(replies["torch"][0], replies["jax"][0], "fm")
    src = SampleSource(np.frombuffer(payload, dtype=np.uint8), FileFormat.COMPLEX_FLOAT32, 100_000)
    rate, want = tdemod.FmDemod(bandwidth=10_000, decimate=4, taps=80, deviation=3_000.0).demodulate(src, device=CPU)
    assert rate == 25_000
    np.testing.assert_array_equal(audio, want)


def test_serve_am_demod_mode(capsys):
    """-mode am answers with the "# am N RATE" header, the f32 audio and a
    trailer; the audio is the port's AmDemod run."""
    sr = 100_000
    t = np.arange(40_000) / sr
    payload = cf32((1.0 + 0.5 * np.cos(2 * np.pi * 250.0 * t)).astype(np.complex64))
    kw = dict(mode="am", shift=0, lowpass=8_000, size=80, decimate=4, bit=None, sample_rate="100k", format="cf32")
    replies, logs = serve_both(capsys, [payload], **kw)
    assert "am audio" in logs["torch"] and untimed(logs["torch"]) == untimed(logs["jax"])
    audio = assert_audio_close(replies["torch"][0], replies["jax"][0], "am")
    src = SampleSource(np.frombuffer(payload, dtype=np.uint8), FileFormat.COMPLEX_FLOAT32, sr)
    _, want = tdemod.AmDemod(bandwidth=8_000, decimate=4, taps=80).demodulate(src, device=CPU)
    np.testing.assert_array_equal(audio, want)


def test_serve_ssb_demod_mode(capsys):
    """-mode ssb (no case in the JAX package's tests): a tone 700 Hz above
    the carrier comes back as audio, the port's SsbDemod run, and the JAX
    daemon's within 1e-5 of full scale."""
    sr = 48_000
    m = np.arange(48_000)
    payload = cf32(0.5 * np.exp(2j * np.pi * 700.0 * m / sr))
    kw = dict(mode="ssb", shift=0, size=80, decimate=4, bit=None, sample_rate="48k", format="cf32")
    replies, logs = serve_both(capsys, [payload], **kw)
    assert "ssb audio" in logs["torch"] and untimed(logs["torch"]) == untimed(logs["jax"])
    audio = assert_audio_close(replies["torch"][0], replies["jax"][0], "ssb")
    src = SampleSource(np.frombuffer(payload, dtype=np.uint8), FileFormat.COMPLEX_FLOAT32, sr)
    _, want = tdemod.SsbDemod(bandwidth=3_000, decimate=4, taps=80).demodulate(src, device=CPU)
    np.testing.assert_array_equal(audio, want)
    spec = np.abs(np.fft.rfft(audio[len(audio) // 4 : 3 * len(audio) // 4]))
    assert abs(np.argmax(spec) * 12_000 / (2 * (len(spec) - 1)) - 700.0) < 30.0


def test_serve_demod_empty_burst_answers_error_and_survives(capsys):
    """An empty burst does not end the daemon nor leave the client with
    silence: it answers ``# error: ...`` (the JAX daemon's line) and the next
    connection is served."""
    path = EXAMPLES / "ook-sim.sr400.cf32"
    kw = dict(mode="ook", fft_width=4, stride=2, bit=16.0, threshold=0.001, raw=False, sample_rate="400",
              format="cf32")
    replies, _ = serve_both(capsys, [b"", path.read_bytes()], **kw)
    bad = replies["torch"][0].decode()
    assert bad.startswith("# error: ") and "shorter than the envelope window" in bad
    assert bad == replies["jax"][0].decode()
    assert tcli.main(["ook", "-bit", "16", str(path)]) == 0
    want_bits = capsys.readouterr().out.strip().splitlines()[0]
    assert reply_lines(replies["torch"][1])[0] == want_bits


# -- find ---------------------------------------------------------------------------------


def find_case(tmp_path, seed: int = 61) -> tuple[bytes, pathlib.Path]:
    rng = np.random.default_rng(seed)
    n, l = 50_000, 300
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    for o in (3_000, 30_000):
        x[o : o + l] += 0.5 * p
    pat_path = tmp_path / "sync.sr48k.cf32"
    pat_path.write_bytes(cf32(p))
    return cf32(x), pat_path


def assert_matches_close(got: list[str], want: list[str]) -> None:
    """Match lines: offsets, freqs and ``which`` exact; scores and scales within 2e-4."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.split(","), w.split(",")
        assert (g[0], g[3:]) == (w[0], w[3:])
        assert abs(float(g[1]) - float(w[1])) <= FIND_TOL + 5e-5  # printed to 4 decimals
        assert abs(float(g[2]) - float(w[2])) <= FIND_TOL * max(1.0, abs(float(w[2])))


def test_serve_find_mode(capsys, tmp_path, monkeypatch):
    """-mode find streams each connection through the matched filter and
    answers with exactly the lines ``find -stdin`` prints; the JAX daemon's
    lines within the find tolerance."""
    payload, pat_path = find_case(tmp_path)
    kw = dict(mode="find", patterns=(str(pat_path),), threshold=0.8, chunk=1 << 16, sample_rate="48k", format="cf32")
    replies, logs = serve_both(capsys, [payload], **kw)
    assert "find matches" in logs["torch"] and untimed(logs["torch"]) == untimed(logs["jax"])
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(payload)))
    argv = ["find", "-pattern", str(pat_path), "-threshold", "0.8", "-stdin", "yes", "-sr", "48k", "-format", "cf32"]
    assert tcli.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()
    got, j = reply_lines(replies["torch"][0]), reply_lines(replies["jax"][0])
    assert got[:-1] == want[:-1] and got[-1] == f"# {want[-1]}"
    assert [int(ln.split(",")[0]) for ln in got[:-1]] == [3_000, 30_000]
    assert_matches_close(got[:-1], j[:-1])
    assert got[-1] == j[-1]


def test_serve_find_bank_mode(capsys, tmp_path):
    """-mode find with a bank of two templates over a carrier-offset grid:
    lines with ``which``, the JAX daemon's within the find tolerance."""
    payload, pat_path = find_case(tmp_path, seed=63)
    rng = np.random.default_rng(64)
    other = tmp_path / "other.sr48k.cf32"
    other.write_bytes(cf32((rng.standard_normal(200) + 1j * rng.standard_normal(200)).astype(np.complex64)))
    kw = dict(mode="find", patterns=(str(pat_path), str(other)), threshold=0.8, freq_tol=100.0, chunk=None,
              sample_rate="48k", format="cf32")
    replies, _ = serve_both(capsys, [payload], **kw)
    got, j = reply_lines(replies["torch"][0]), reply_lines(replies["jax"][0])
    assert [ln.split(",")[0] for ln in got[:-1]] == ["3000", "30000"]
    assert all(ln.split(",")[4] == "0" for ln in got[:-1])
    assert_matches_close(got[:-1], j[:-1])
    assert got[-1] == j[-1]


# -- parsing and gating ------------------------------------------------------------------


def both_fail(capsys, argv: list[str], text: str) -> None:
    """The port's CLI and the JAX package's exit 1 with the same error, which holds ``text``."""
    assert tcli.main(argv) == 1
    t_err = capsys.readouterr().err
    assert text in t_err
    assert jcli.main(argv) == 1
    assert capsys.readouterr().err == t_err


def test_serve_psk_mode_gating(capsys):
    (cmd,) = targs.parse(["serve", "-mode", "psk", "-symbol-rate", "2k", "-order", "4", "-sr", "128k", "-format", "cf32"])
    assert cmd.mode == "psk" and cmd.symbol_rate == 2_000.0 and cmd.order == 4
    both_fail(capsys, ["serve", "-mode", "psk", "-sr", "128k", "-format", "cf32"], "-mode psk requires -symbol-rate")
    both_fail(capsys, ["serve", "-mode", "stream", "-symbol-rate", "2k", "-sr", "128k", "-format", "cf32"],
              "-symbol-rate does not apply to -mode stream")
    both_fail(capsys, ["serve", "-mode", "psk", "-symbol-rate", "2k", "-search", "yes", "-sr", "128k", "-format", "cf32"],
              "-search does not apply to -mode psk")


def test_serve_find_mode_gating(capsys):
    argv = ["serve", "-mode", "find", "-pattern", "a.sr48k.cf32", "-pattern", "b.sr48k.cf32", "-freq-tol", "200",
            "-sr", "48k", "-format", "cf32"]
    (cmd,) = targs.parse(argv)
    assert cmd.mode == "find" and cmd.patterns == ("a.sr48k.cf32", "b.sr48k.cf32")
    assert cmd.threshold == 0.5 and cmd.freq_tol == 200.0 and cmd.chunk is None
    both_fail(capsys, ["serve", "-mode", "find", "-sr", "48k", "-format", "cf32"], "-mode find requires -pattern")
    both_fail(capsys, ["serve", "-mode", "find", "-pattern", "a.sr48k.cf32", "-shift", "1k", "-sr", "48k", "-format",
                       "cf32"], "-shift does not apply to -mode find")
    both_fail(capsys, ["serve", "-mode", "stream", "-pattern", "a.sr48k.cf32", "-sr", "48k", "-format", "cf32"],
              "-pattern does not apply to -mode stream")


def test_serve_demod_mode_parse_and_gating(capsys):
    (cmd,) = targs.parse(["serve", "-mode", "ook", "-bit", "16", "-threshold", "0.01", "-raw", "yes", "-sr", "400",
                          "-format", "cf32"])
    assert cmd.mode == "ook" and cmd.bit == 16.0 and cmd.threshold == 0.01
    assert cmd.raw and cmd.fft_width == 4 and cmd.stride == 2
    (cmd,) = targs.parse(["serve", "-mode", "fsk", "-lowpass", "8k", "-sr", "48k", "-format", "cf32"])
    assert cmd.mode == "fsk" and cmd.bit is None and cmd.fft_width == 64
    both_fail(capsys, ["serve", "-mode", "ook", "-search", "yes", "-sr", "400", "-format", "cf32"],
              "-search does not apply to -mode ook")
    both_fail(capsys, ["serve", "-mode", "fsk", "-threshold", "0.1", "-sr", "48k", "-format", "cf32"],
              "-threshold does not apply to -mode fsk")
    both_fail(capsys, ["serve", "-mode", "stream", "-bit", "8", "-sr", "48k", "-format", "cf32"],
              "-bit does not apply to -mode stream")


def test_serve_fm_mode_gating(capsys):
    both_fail(capsys, ["serve", "-mode", "fm", "-threshold", "0.5", "-sr", "2M", "-format", "cu8"],
              "-threshold does not apply to -mode fm")
    both_fail(capsys, ["serve", "-mode", "ook", "-deviation", "75k", "-sr", "400", "-format", "cf32"],
              "-deviation does not apply to -mode ook")


def test_serve_requires_sr_and_format(capsys):
    both_fail(capsys, ["serve", "-once", "yes"], "'serve' requires -sr and -format (a socket has no filename to sniff)")


def test_serve_rejects_mode_inapplicable_flags(capsys):
    both_fail(capsys, ["serve", "-mode", "waterfall", "-shift", "280k", "-sr", "2M", "-format", "cu8"],
              "-shift does not apply to -mode waterfall")
    both_fail(capsys, ["serve", "-stride", "32", "-sr", "2M", "-format", "cu8"], "-stride does not apply to -mode stream")
    both_fail(capsys, ["serve", "-mode", "bogus", "-sr", "2M", "-format", "cu8"], "unknown -mode")
    both_fail(capsys, ["serve", "-parallel", "0", "-sr", "2M", "-format", "cu8"], "-parallel must be >= 1")


def test_serve_scan_mode_gating():
    for argv in ("serve -mode scan -search yes -sr 48k -format cs8", "serve -mode scan -deviation 75k -sr 48k -format cs8"):
        with pytest.raises(ValueError, match="does not apply to -mode scan"):
            targs.parse(argv.split())
    (c,) = targs.parse("serve -mode scan -width 256 -stride 128 -threshold 0.5 -chunk 100 -sr 48k -format cs8".split())
    assert c.mode == "scan" and c.threshold == 0.5 and c.stride == 128 and c.chunk == 100


@pytest.mark.parametrize(
    "argv",
    [
        "serve -sr 48k -format cs8",
        "serve -mode waterfall -stride 256 -search yes -parallel 4 -timeout 5 -sr 21M -format cu8",
        "serve -mode scan -width 256 -threshold 0.5 -sr 48k -format cs8",
        "serve -mode ook -raw yes -sr 400 -format cf32",
        "serve -mode psk -symbol-rate 2k -order 4 -block 4096 -sr 128k -format cf32",
        "serve -mode fm -deviation 5k -audio-rate 48k -audio-power 16 -sr 2M -format cu8",
        "serve -mode am -sr 2M -format cu8",
        "serve -mode ssb -sideband lsb -bandwidth 2k -sr 48k -format cs8",
        "serve -mode find -pattern a.sr48k.cf32 -pattern b.sr48k.cf32 -top 3 -distance 10 -freq-step 50 -sr 48k -format cf32",
        "serve -mesh 2x1 -port 7000 -host 0.0.0.0 -once yes -sr 48k -format cs8",
    ],
)
def test_serve_parses_as_jax(argv):
    """Every mode's defaults and flags parse into the JAX package's fields."""
    import dataclasses

    (t,) = targs.parse(argv.split())
    (j,) = jargs.parse(argv.split())
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_usage_lists_serve():
    assert "serve [-port 7373]" in tcli.USAGE
    assert "ROADMAP A12c" not in tcli.USAGE


# -- the fuzz ---------------------------------------------------------------------------


def fuzz_bursts(fmt_bytes: int, seed: int) -> list[bytes]:
    """Adversarial bursts: empty, under one sample, partial-pair tails,
    NaN/inf/all-zero f32 payloads, and random garbage at odd lengths."""
    rng = np.random.default_rng(seed)
    bursts = [
        b"",
        b"\x01",
        bytes(fmt_bytes - 1),
        rng.integers(0, 256, 4097, dtype=np.int64).astype(np.uint8).tobytes(),
        np.full(512, np.nan, dtype=np.float32).tobytes(),
        np.full(512, np.inf, dtype=np.float32).tobytes(),
        bytes(8192),  # all zero (psk: no power; am: zero carrier)
    ]
    for _ in range(3):
        n = int(rng.integers(1, 20_000))
        bursts.append(rng.integers(0, 256, n, dtype=np.int64).astype(np.uint8).tobytes())
    return bursts


def psk_burst_cf32() -> bytes:
    """A clean differential-BPSK burst at 48 kHz, 1.5 kbaud, cf32."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 200)
    sym = np.exp(1j * np.cumsum(np.where(bits, np.pi, 0.0)))
    return (0.5 * np.repeat(sym, 32)).astype(np.complex64).tobytes()


def good_burst(mode: str) -> bytes:
    if mode == "psk":
        return psk_burst_cf32()
    if mode == "fm":
        return (0.5 * np.exp(2j * np.pi * 900.0 * np.arange(12_000) / 48_000)).astype(np.complex64).tobytes()
    if mode == "ook":
        n = 4_000
        env = np.zeros(n, dtype=np.float32)
        env[: n // 2] = 0.4
        u = np.empty(2 * n, dtype=np.float32)
        u[0::2], u[1::2] = env, env
        return np.round(u * 255.0 + 127.5).clip(0, 255).astype(np.uint8).tobytes()
    return capture(30_000)


@pytest.mark.parametrize(
    "mode_kw",
    [
        dict(mode="psk", format="cf32", symbol_rate=1_500.0, decimate=4, size=40, lowpass=8_000, chunk=None),
        dict(mode="fm", format="cf32", decimate=4, size=40, lowpass=8_000, chunk=None),
        dict(mode="ook", format="cu8", fft_width=4, stride=2, threshold=0.05, chunk=None),
        dict(mode="stream", format="cs8"),
    ],
    ids=["psk", "fm", "ook", "stream"],
)
def test_serve_fuzz_garbage_bursts_survive(capsys, mode_kw):
    """Malformed bursts (empty, partial pairs, NaN/inf cf32, all zero,
    random garbage, and one abrupt RST) never end the daemon: every
    session is answered with result text or an ``# error:`` line, or closed
    cleanly, and a well-formed burst after the garbage is still served.
    Each burst is answered as the JAX daemon answers it: result text or
    the same error line."""
    fmt = FileFormat(mode_kw["format"])
    bursts = fuzz_bursts(fmt.pair_bytes, seed=sum(map(ord, mode_kw["mode"])))
    good = good_burst(mode_kw["mode"])
    replies = {}
    for pkg in ("jax", "torch"):
        th, port, errors = start(pkg, max_connections=len(bursts) + 2, once=False, **mode_kw)
        got = []
        for payload in bursts:
            got.append(session(port, payload))
            assert b"Traceback" not in got[-1]
        # abrupt RST mid-send: SO_LINGER 0 and a close without half-close
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        s.sendall(bytes(1024))
        s.close()
        got.append(session(port, good))
        join(th, errors)
        replies[pkg] = got
        assert "Traceback" not in capsys.readouterr().out
    t_good = replies["torch"][-1]
    if mode_kw["mode"] == "stream":
        np.testing.assert_array_equal(np.frombuffer(t_good, dtype=np.float32).reshape(-1, 32), direct_norms(good))
    else:
        assert b"# error:" not in t_good and t_good
    for t, j in zip(replies["torch"][:-1], replies["jax"][:-1]):
        t_err, j_err = t.startswith(b"# error:"), j.startswith(b"# error:")
        assert t_err == j_err and (t == j or not t_err), (t[:120], j[:120])
