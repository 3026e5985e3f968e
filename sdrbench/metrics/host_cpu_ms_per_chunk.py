"""``host_cpu_ms_per_chunk``: the host CPU time the process spent over the
window, all its threads (the program's and the sink's), over the chunks
it emitted, in milliseconds (live cells): what keeping up with the source
costs the host."""


def read(run):
    if run.kind != "live" or not run.chunks:
        return None
    return 1e3 * run.cpu_s / run.chunks
