"""Eval building blocks (``dispatch``), the kernel build (``build``) and
the hand-written CUDA kernels' wrappers (``kernels``)."""
