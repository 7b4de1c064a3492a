"""Wrappers of the hand-written CUDA kernels in ``csrc/``, each beside its
plain PyTorch version and with a ``launches`` count on the wrapper."""
