"""Profiling hooks (SURVEY.md §5 "Tracing / profiling").

Counterpart of ``adversarial_learning_on_pointclouds_tpu/utils/
profiling.py``. ``maybe_trace``: with ``--profile_dir`` set, a training
run is wrapped in a ``torch.profiler`` window (host activity, and the
card's kernels when there is a card) and the trace is written to
``<profile_dir>/trace.json`` (Chrome trace format; open it in Perfetto
or ``chrome://tracing``). ``debug_nans``: the counterpart of JAX's NaN
checker, autograd's anomaly mode with its NaN check, for debug runs.
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


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Within the context autograd's anomaly mode is ``enabled`` with its
    NaN check (``torch.autograd.set_detect_anomaly(..., check_nan=True)``):
    a backward that makes a NaN raises, naming the forward operation that
    led to it. The previous mode is restored after."""
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(enabled, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)
