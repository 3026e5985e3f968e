"""Command-line entry point: ``python -m quadrs_tpu_torch``.

Mirrors ``quadrs_tpu.cli`` (itself ``src/bin/quadrs.rs``): parse argv into
commands, print usage on error or when empty, then fold the commands
over the stream accumulator, on the device ``QUADRS_PLATFORM`` names:
``cpu``, or ``cuda`` (the default).  With CUDA asked for and none
available the run fails; it never carries on silently on the CPU.
"""

from __future__ import annotations

import itertools
import os
import sys

import torch

from quadrs_tpu_torch import args as argmod
from quadrs_tpu_torch import serve
from quadrs_tpu_torch.ops.frontend import no_tf32
from quadrs_tpu_torch.pipeline import FindOp, run_pipeline
from quadrs_tpu_torch.sources import LivePipeStream, SampleSource
from quadrs_tpu_torch.utils.sniff import guess_details

USAGE = """\
usage: {us} \\
    from [-sr SAMPLE_RATE] [-format cf32|cs8|cu8|cs16] FILENAME.sr32k.cf32 \\
   shift [-]FREQUENCY \\
 lowpass [-power 20] [-decimate 8] FREQUENCY \\
resample [-power 8] [-size N] UP/DOWN [rational rate conversion, e.g. 3/2 or 147/160] \\
 dcblock [-window 32k] [subtract the trailing-window mean: kills a tuner's DC spike] \\
     agc [-target 1] [-window 4k] [-max-gain 1k] [normalize trailing-window RMS to target] \\
   iqbal [-c RE:IM] [-est 256k] [IQ-imbalance image cancel; -c explicit, else blind-estimated] \\
sparkfft [-width 128] [-stride =width] [-range LOW:HIGH] \\
  bucket [-width 128] [-stride =width] [-by freq] COUNT \\
    find [-pattern FILE.srR.cf32]+ [-threshold 0.5] [-top 0 (all)] [-distance =patlen] \\
         [-freq-tol HZ (also search a carrier-offset grid)] [-freq-step =0.4*sr/patlen] \\
         [matched filter: find every occurrence of the pattern(s) in the stream by \\
          gain/phase-invariant normalized correlation; prints offset,score,scale,freq \\
          (repeated -pattern = a sync-word bank; lines then add the winning template)] \\
         [-stdin no] [-sr R] [-format F] [search a live pipe with O(chunk) memory: \\
          rtl_sdr - | {us} find -pattern sync.sr2M.cf32 -stdin yes -sr 2M -format cu8] \\
         [-write PREFIX] [-pre 0] [-post 0] [-overwrite no] [save each match as a \\
          re-from-able slice of the ORIGINAL capture, widened by pre/post samples — \\
          preamble-triggered packet extraction, span-mapped through the chain] \\
   write [-overwrite no] [-format cf32|cs8|cu8|cs16 (quantize; default cf32)] FILENAME_PREFIX \\
     gen [-cos FREQUENCY]* [-len 1 (second)] [-noise 0 (sigma/component, seeded)] [-seed 0] SAMPLE_RATE \\
      ui [-fft 8] [-stretch 4] [-stride 4] [-frames 1] [renders waterfall to ui.png] \\
         [-live no] [-rows N] [-cols N] [live: stream ANSI waterfall to the terminal; \\
          keys: +/- fft width, [/] stride, q quit] \\
         [-stdin no] [-sr R] [-format F] [live waterfall off a pipe, like eui] \\
     eui [-start 46] [-end 46.3] [-fft 512] [-frames 1] [FILENAME] [renders to eui.png] \\
         [-live no] [-stride =fft] [-rows N] [-cols N] [live: blue ANSI waterfall] \\
         [-stdin no] [-sr R] [-format F] [live waterfall off a pipe: rtl_sdr - | {us} eui -live yes -stdin yes ...] \\
  stream [-shift 0] [-lowpass 200k] [-power 200] [-decimate 32] [-width 64] \\
         [-chunk 4M] [-chunks N] [-search no] [-scan no] [-threshold 0] [-top 20] \\
         [-db no] [-trigger LEVEL (burst recorder; needs -out)] [-pre 1] [-post 1] \\
         [-out PREFIX] FILENAME | -stdin yes -sr RATE -format FMT \\
waterfall [-width 1024] [-stride =width] [-window rectangular] [-chunk 2k] \\
         [-chunks N] [-search no] [-out PREFIX] FILENAME... | -stdin yes -sr RATE -format FMT \\
    scan [-width 1024] [-stride =width] [-window rectangular] [-chunk 2k] [-chunks N] \\
         [-threshold 0 (occupancy level)] [-top 20] [-db no] [-out PREFIX (full \\
         per-bin CSV)] [-plot no (render .sK.png survey plots)] [-overwrite no] \\
         FILENAME... | -stdin yes -sr RATE -format FMT \\
    info [-chunk 4M] [-limit N (first N samples)] FILENAME...   (capture statistics) \\
  replay [-speed 1 (x real time; 0 = unthrottled)] [-loop 1] [-chunk 64k] FILENAME \\
         (raw bytes to stdout, paced: a recorded capture as a live pipe) \\
   serve [-port 7373] [-host 127.0.0.1] [-once no] [-search no] [-shift 0] [-lowpass 200k] \\
         [-power 200] [-decimate 32] [-width 64] [-chunk 4M] -sr R -format F \\
         [-mode stream|waterfall|scan|ook|fsk|psk|fm|am|ssb|find] [-stride =width] [waterfall: \\
          the raw spectrogram; scan: the per-bin band-survey CSV, -threshold as in scan; \\
          find: stream the connection through the matched filter ([-pattern FILE]+, \\
          -threshold/-top/-distance/-freq-tol as in find; matches back at EOF)] \\
         [ook/fsk/psk/fm/am/ssb: a receiver as a service: send the burst, read back the bits \\
          (or, fm/am/ssb: a "# MODE N RATE" header + N f32 audio samples); -threshold/-bit/-raw/ \\
          -deviation/-audio-*/-sideband/-bandwidth/-symbol-rate/-order as in the matching \\
          commands] \\
         [-mesh TxS] [-parallel 1] [-timeout 0 (seconds; drop a connection idle \\
          that long: stalled peers cannot hold a slot)] [parallel: serve N connections at \\
          once, each on its own CUDA stream, over the one model] \\
         [TCP service: the model and its tables made once, then each connection streams \\
          IQ in, results out] \\
     ook [-width 4] [-stride 2] [-threshold 0.001] [-bit 8] [-raw no] [-stdin no] [-mesh T] FILENAME \\
     fsk [-shift 0] [-lowpass 200k] [-power 200] [-decimate 32] [-width 64] [-stride S] [-bit N] [-stdin no] [-mesh T] FILENAME \\
     psk [-shift 0] [-lowpass 200k] [-power 200] [-decimate 32] -symbol-rate HZ \\
         [-order 2 (BPSK; 4 = QPSK, Gray 00 01 11 10)] [-differential yes] \\
         [-block 0 (re-estimate the carrier every N baseband samples: \\
          tracks drifting crystals; 0 = one whole-burst estimate)] \\
         [-plot FILE.png (render the synchronized constellation)] [-overwrite no] \\
         [-stdin no] [-mesh T] FILENAME [block-coherent: per-burst carrier + timing, no PLL] \\
      fm [-shift 0] [-lowpass 100k] [-power 200] [-decimate 8] [-deviation 75k] \\
         [-audio-lowpass HZ] [-audio-decimate 1] [-audio-power 32] [-audio-rate HZ] \\
         [-out PREFIX (writes PREFIX.srR.f32 mono audio; '-': stream to stdout, e.g. | aplay)] \\
         [-wav no (write PREFIX.wav instead)] \\
         [-overwrite no] [-stdin no] [-mesh T (time-shard the channel chain over the \\
          device mesh; all demods take it)] FILENAME \\
      am [-shift 0] [-lowpass 10k] [-power 200] [-decimate 8] \\
         [-audio-lowpass HZ] [-audio-decimate 1] [-audio-power 32] [-audio-rate HZ] \\
         [-out PREFIX] [-wav no] [-overwrite no] [-stdin no] [-mesh T] FILENAME [audio = envelope/carrier - 1] \\
     ssb [-shift 0] [-sideband usb|lsb] [-bandwidth 3k] [-power 200] [-decimate 8] \\
         [-audio-lowpass HZ] [-audio-decimate 1] [-audio-power 32] [-audio-rate HZ] \\
         [-out PREFIX|-] [-wav no] [-overwrite no] [-stdin no] [-mesh T] FILENAME \\
         [single-sideband to audio; -shift -CARRIER_OFFSET brings the carrier to DC] \\
channelize [-channels 8] [-power 20] [-freq =sr/2K] [-chunk 256k] [-select 0,3,..] \\
         [-out PREFIX (writes PREFIX.chK.srR.cf32 per channel)] [-overwrite no] \\
         [-stdin no] [-mesh T] FILENAME [polyphase filter bank: every channel in \\
          one pass; channel k = shift -k*sr/K + lowpass -decimate K]

(-mesh runs for stream, waterfall, scan, find and channelize; the receivers' and serve's
-mesh parse as in quadjax but are not yet ported, ROADMAP A13.)

Formats:

 * cf32: complex (little endian) floats, 32-bit (GNU-Radio, gqrx)
 *  cs8: complex      signed (integers),  8-bit (HackRF)
 *  cu8: complex    unsigned (integers),  8-bit (RTL-SDR)
 * cs16: complex      signed (integers), 16-bit (Fancy)
"""


_RUNNERS = {
    argmod.StreamCmd: serve.run_stream,
    argmod.WaterfallCmd: serve.run_waterfall,
    argmod.ScanCmd: serve.run_scan,
    argmod.InfoCmd: serve.run_info,
    argmod.ReplayCmd: serve.run_replay,
    argmod.OokCmd: serve.run_ook,
    argmod.FskCmd: serve.run_fsk,
    argmod.PskCmd: serve.run_psk,
    argmod.FmCmd: serve.run_fm,
    argmod.AmCmd: serve.run_am,
    argmod.SsbCmd: serve.run_ssb,
    argmod.ChannelizeCmd: serve.run_channelize,
    argmod.ServeCmd: serve.run_serve,
}


def _run_ui(command: argmod.Ui, stream, device: torch.device):
    """``ui``: the accumulator's waterfall as ``ui.png`` (``-frames N``: a
    sweep of fft widths, ``ui000.png`` ...), or live in the terminal; the
    live pipe with ``-live yes -stdin yes``.  Returns the accumulator after
    it: ``ui`` takes the samples (the reference's ``samples.take()``), but
    a live pipe's run leaves them alone."""
    from quadrs_tpu_torch.viz.waterfall import UiParams, ui_render_file, ui_render_frames

    if command.live and command.stdin:
        ui_input = LivePipeStream(serve._stdin_pipe_source(command))
    elif stream is None:
        raise ValueError("ui requires an input")
    else:
        ui_input = stream
    if command.live:
        from quadrs_tpu_torch.viz.live import LiveParams, live_waterfall

        stats = live_waterfall(ui_input, LiveParams(fft_width=command.fft_width, stride=command.stride,
                                                    cols=command.cols, max_rows=command.rows), device=device)
        print(f"live: {stats['rows']} rows, fft {stats['fft_width']}, stride {stats['stride']}")
        return stream if command.stdin else None
    params = UiParams(fft_width=command.fft_width, stretch=command.stretch, stride=command.stride)
    if command.frames > 1:
        for path in ui_render_frames(stream, command.frames, params=params, device=device):
            print(f"wrote {path}")
    else:
        print(f"wrote {ui_render_file(stream, params=params, device=device)}")
    return None


def _run_eui(command: argmod.Eui, device: torch.device) -> None:
    """``eui``: a percentage slice of a file as ``eui.png`` (``-frames N``: a
    scrolling slice, ``eui000.png`` ...), or live in the terminal from the
    file or the pipe.  It reads its own input and leaves the accumulator
    alone."""
    from quadrs_tpu_torch.viz.waterfall import EuiParams, eui_render_file, eui_render_frames

    if command.live:
        from quadrs_tpu_torch.viz.live import LiveParams, live_waterfall

        if command.stdin:
            src = LivePipeStream(serve._stdin_pipe_source(command))
        elif command.filename is None:
            raise ValueError("eui -live requires a filename")
        else:
            src = SampleSource.from_file(str(command.filename), guess_details(str(command.filename)))
        stats = live_waterfall(src, LiveParams(fft_width=command.fft_width, stride=command.stride or command.fft_width,
                                               cols=command.cols, max_rows=command.rows,
                                               windowing="blackman-harris", colormap="blue"), device=device)
        print(f"live: {stats['rows']} rows, fft {stats['fft_width']}, stride {stats['stride']}")
        return
    params = EuiParams(start_pct=command.start_pct, end_pct=command.end_pct, fft_width=command.fft_width)
    if command.frames > 1:
        for path in eui_render_frames(command.filename, command.frames, params=params, device=device):
            print(f"wrote {path}")
    else:
        print(f"wrote {eui_render_file(command.filename, params=params, device=device)}")


def _kind(command) -> str:
    """How :func:`main` runs a command: folded over the accumulator
    (``chain``), as ``find -stdin`` over the pipe (``live find``), or as a
    command of its own (``runner``)."""
    if not isinstance(command, argmod.Octagon):
        return "runner"
    return "live find" if isinstance(command.op, FindOp) and command.op.stdin else "chain"


def select_device() -> torch.device:
    """The device ``QUADRS_PLATFORM`` names; unset means ``cuda``.
    Raises when CUDA is asked for and unavailable."""
    want = os.environ.get("QUADRS_PLATFORM") or "cuda"
    if want == "cpu":
        return torch.device("cpu")
    if want != "cuda":
        raise ValueError(f"QUADRS_PLATFORM must be 'cpu' or 'cuda', got {want!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available (torch.cuda.is_available() is False); "
            "set QUADRS_PLATFORM=cpu to run on the CPU"
        )
    no_tf32()
    return torch.device("cuda")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    us = "python -m quadrs_tpu_torch"

    try:
        commands = argmod.parse(argv)
    except ValueError as e:
        print(USAGE.format(us=us))
        print(f"Error: {e}", file=sys.stderr)
        return 1

    if not commands:
        print(USAGE.format(us=us))
        print("Error: no commands provided", file=sys.stderr)
        return 1

    stream = None
    try:
        device = select_device()
        # each run of chainable commands folds over the accumulator, which
        # carries across the other commands between them
        for kind, group in itertools.groupby(commands, key=_kind):
            if kind == "chain":
                stream = run_pipeline([c.op for c in group], device=device, stream=stream)
                continue
            for command in group:
                if kind == "live find":
                    # find -stdin searches the pipe itself and leaves the
                    # accumulator untouched; matches print at EOF
                    run_pipeline([command.op], device=device, stream=LivePipeStream(serve._stdin_pipe_source(command.op)))
                    continue
                if isinstance(command, argmod.Ui):
                    stream = _run_ui(command, stream, device)
                    continue
                if isinstance(command, argmod.Eui):
                    _run_eui(command, device)
                    continue
                rc = _RUNNERS[type(command)](command, device)
                if rc:
                    return rc
    except (ValueError, RuntimeError, OSError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
