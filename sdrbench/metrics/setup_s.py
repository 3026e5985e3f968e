"""``setup_s``: from the process's start to the window's: imports, the
card's context, the kernel library's load (its build in a checkout's first
run), the seeded capture, the warm-up."""


def read(run):
    return run.setup_s
