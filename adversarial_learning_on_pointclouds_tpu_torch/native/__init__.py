"""The native ``.pts``/``.seg`` loader (C++ source, built with ``g++`` at
first use by ``build.py``)."""
