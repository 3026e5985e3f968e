"""``chain_roofline_share.conditioned``: the least time the conditioned
chain's work (shift, lowpass, dcblock, agc, strided spectra) takes on the
card over the card's kernel time in the window (copies out), in percent.
The work: each native input byte read once and each f32 norm written once
over the HBM peak, or the chain's f32 operations over the f32 peak, the
larger; counted from the configuration's shapes, whatever implements it.
Each decimated sample is computed once, as a streaming filter would, and
the lookback that every window re-reads is not counted
(``arith.conditioned_flops_per_sample``)."""

from sdrbench import arith


def read(run):
    if run.device.type != "cuda":
        return None  # a device number comes from the card alone
    cfg = run.config
    stages = [s["stage"] for s in cfg["chain"]]
    kernel = run.trace_out.get("kernel_s")
    if stages != ["shift", "lowpass", "dcblock", "agc"] or run.kind != "capture" or not kernel or not run.samples:
        return None
    lp = cfg["chain"][1]
    width, stride = cfg["sink"]["width"], cfg["sink"]["stride"]
    n = run.samples
    flops = n * arith.conditioned_flops_per_sample(2 * lp["power"], lp["decimate"], width, stride)
    nbytes = n * 2 + (n // (lp["decimate"] * stride)) * width * 4
    least, _ = arith.least_seconds(flops, nbytes)
    return 100.0 * least / kernel
