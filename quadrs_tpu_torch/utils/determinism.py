"""Determinism audits.

The counterpart of ``quadrs_tpu.utils.determinism``: (a) re-execution
equality, bit for bit: the port's programs are pure functions of their
inputs, so a difference between two runs is a race (a buffer reused while
a kernel still reads it) or a fault; (b) the same function on two
execution paths within float tolerance.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _leaves(tree) -> list[np.ndarray]:
    """The arrays of a result: tensors and arrays, in tuples, lists and
    dicts (sorted by key), as numpy."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for x in tree for a in _leaves(x)]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


def check_repeatable(fn: Callable, *args, runs: int = 2) -> bool:
    """Run ``fn(*args)`` ``runs`` times and assert bitwise-identical results."""
    first = _leaves(fn(*args))
    for _ in range(runs - 1):
        again = _leaves(fn(*args))
        if len(again) != len(first) or any(a.tobytes() != b.tobytes() for a, b in zip(first, again)):
            raise AssertionError("nondeterministic execution detected")
    return True


def compare_backends(fn: Callable, *args, rtol: float = 1e-5, atol: float = 1e-5) -> bool:
    """Run ``fn(device, *args)`` on the device the package's entry points
    take (:func:`quadrs_tpu_torch.cli.select_device`: the card, unless
    ``QUADRS_PLATFORM=cpu`` asks for the CPU) and on an independent path,
    and assert closeness.

    On the card the second path is the CPU (the kernels' plain versions,
    MKL and PocketFFT in place of the CUDA kernels, cuBLAS and cuFFT).
    Where the default device already is the CPU, the second path is the
    CPU with one intra-op thread: reductions split over threads sum in
    another order, so the comparison stays a real one and not CPU against
    the same CPU run."""
    from quadrs_tpu_torch.cli import select_device

    dev = select_device()
    default = _leaves(fn(dev, *args))
    if dev.type == "cpu":
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            other = _leaves(fn(dev, *args))
        finally:
            torch.set_num_threads(threads)
    else:
        other = _leaves(fn(torch.device("cpu"), *args))
    if len(default) != len(other):
        raise AssertionError(f"{len(default)} results on {dev}, {len(other)} on the other path")
    for a, b in zip(default, other):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    return True
