"""The benchmark of ``quadrs_tpu_torch`` on an NVIDIA H100: ``python3 -m
sdrbench.run --workload CELL --seed N --seconds S --trace 0|1``
(:mod:`sdrbench.run`).  Configurations, traffic mixes, cells and metrics
are files of their own, found by name (:mod:`sdrbench.spec`); the plain
reference is :mod:`sdrbench.reference`."""
