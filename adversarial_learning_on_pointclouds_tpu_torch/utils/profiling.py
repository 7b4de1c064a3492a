"""Profiling hook (SURVEY.md §5 "Tracing / profiling").

Counterpart of ``adversarial_learning_on_pointclouds_tpu/utils/
profiling.py::maybe_trace``: with ``--profile_dir`` set, a training run
is wrapped in a ``torch.profiler`` window (host activity, and the card's
kernels when there is a card) and the trace is written to
``<profile_dir>/trace.json`` (Chrome trace format; open it in Perfetto
or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]):
    """Yields the ``torch.profiler.profile`` (or None when ``profile_dir``
    is empty); the trace is written when the block ends."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
