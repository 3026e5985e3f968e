"""The benchmark's plain reference: PyTorch operations only, nothing of
the measured program, the JAX package or JAX (:mod:`.chain`)."""
