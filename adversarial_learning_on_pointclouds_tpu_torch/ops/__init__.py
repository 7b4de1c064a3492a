"""The building blocks the models call (``dispatch``), the kernel build
(``build``), the launch helpers (``launch``) and
the hand-written CUDA kernels' wrappers (``kernels``)."""
