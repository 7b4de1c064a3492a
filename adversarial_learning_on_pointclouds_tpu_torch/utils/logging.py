"""Structured training logs (SURVEY.md §5 "Metrics / logging").

Counterpart of ``adversarial_learning_on_pointclouds_tpu/utils/
logging.py``: the same ``MetricLogger`` (file names, CSV headers, stdout
lines and ``lag`` semantics). The reference prints ``[epoch:
batch/num] train loss: x accuracy: y`` per batch; ``MetricLogger`` keeps
that stdout format (``--quiet`` trims it) and appends every scalar to a
CSV, with the points/sec/chip meter.

``HostFetch`` is the JAX helper ``start_host_fetch``: a step's device
tensors are copied into pinned host tensors with ``non_blocking=True``
(queued behind the step's work) and read only when a later launch is
already queued, so the logger never waits on the step it just launched.
"""

from __future__ import annotations

import collections
import csv
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch


class HostFetch:
    """Non-blocking device->host copies of a dict of values, started now
    and read by ``get()``: tensors on a card are copied into pinned host
    memory (those of one shape and dtype stacked, in one transfer), and
    a CUDA event marks the copies' end. CPU tensors and numbers are kept
    as they are (a step's metrics are fresh tensors that no later step
    writes)."""

    def __init__(self, values: Dict[str, object]):
        self._keys = list(values)
        self._event = None
        cuda = [k for k, v in values.items()
                if isinstance(v, torch.Tensor) and v.is_cuda]
        self._host = {k: v for k, v in values.items() if k not in cuda}
        self._stacked = None
        if not cuda:
            return
        kinds = {(values[k].shape, values[k].dtype) for k in cuda}
        if len(kinds) == 1 and len(cuda) > 1:
            src = {"": torch.stack([values[k] for k in cuda])}
            self._stacked = cuda
        else:
            src = {k: values[k] for k in cuda}
        for k, v in src.items():
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v, non_blocking=True)
            self._host[k] = buf
        self._event = torch.cuda.Event()
        self._event.record()

    def get(self) -> Dict[str, np.ndarray]:
        """The values as numpy arrays, waiting for the copies."""
        if self._event is not None:
            self._event.synchronize()
        out = {}
        if self._stacked is not None:
            block = self._host.pop("").numpy()
            out.update(zip(self._stacked, block))
        for k, v in self._host.items():
            out[k] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v))
        return {k: np.asarray(out[k]) for k in self._keys}


class MetricLogger:
    """``lag`` defers metric device->host readbacks: ``log_step`` enqueues
    the step's (still on-device) metric scalars and only materializes a
    row once ``lag`` newer launches have been enqueued, so the readback
    of step N overlaps steps N+1..N+lag already queued on the device. Rows
    print/append in order, just ``lag`` launches late; ``lag=0`` restores
    strictly synchronous per-batch prints (the reference's behavior).
    ``enabled=False`` (a data-parallel rank other than 0) reads the
    metrics back as rank 0 does but writes and prints nothing."""

    def __init__(self, out_dir: str, run_name: str = "train",
                 quiet: bool = False, lag: int = 2, enabled: bool = True):
        self.enabled = enabled
        self.quiet = quiet or not enabled
        self.lag = max(int(lag), 0)
        self._pending: collections.deque = collections.deque()
        self.csv_path = os.path.join(out_dir, f"{run_name}_metrics.csv")
        # Per-epoch summaries get their own CSV (mIoU/acc/train_s/...).
        self.epoch_csv_path = os.path.join(out_dir,
                                           f"{run_name}_epochs.csv")
        if enabled:
            os.makedirs(out_dir, exist_ok=True)
        self._csv_file = open(self.csv_path if enabled else os.devnull, "a",
                              newline="")
        self._csv: Optional[csv.DictWriter] = None
        self._epoch_csv_file = open(
            self.epoch_csv_path if enabled else os.devnull, "a", newline="")
        self._epoch_csv: Optional[csv.DictWriter] = None
        self._step_t0 = time.perf_counter()

    def _emit(self, rows, fetch: HostFetch, headers) -> None:
        """Materialize one launch group: ``rows``/``headers`` are lists
        (length 1 for single steps, K for a K-step launch); the fetched
        values are scalars or [K] arrays indexed per row."""
        arrs = fetch.get()
        for i, (row, header) in enumerate(zip(rows, headers)):
            vals = {k: float(a[i] if a.ndim else a)
                    for k, a in arrs.items()}
            row.update(vals)
            if self._csv is None:
                self._csv = csv.DictWriter(self._csv_file,
                                           fieldnames=row.keys())
                if self._csv_file.tell() == 0:
                    self._csv.writeheader()
            self._csv.writerow(row)
            if not self.quiet:
                parts = " ".join(f"{k}: {v:.6f}" for k, v in vals.items())
                print(f"{header} {parts}")
        if not self.quiet:
            sys.stdout.flush()

    def _drain(self, keep: int) -> None:
        while len(self._pending) > keep:
            self._emit(*self._pending.popleft())

    def log_step(self, epoch: int, batch: int, num_batches: int, step: int,
                 metrics: Dict[str, object], points_per_step: int = 0,
                 num_chips: int = 1) -> None:
        now = time.perf_counter()
        dt = now - self._step_t0
        self._step_t0 = now
        # With lag > 0 the interval is enqueue-to-enqueue; under a
        # saturated device queue that equals the steady-state step time.
        row = {"epoch": epoch, "batch": batch, "step": step,
               "step_time_s": round(dt, 5)}
        if points_per_step:
            row["points_per_sec_per_chip"] = round(
                points_per_step / dt / num_chips, 1)
        self._pending.append(([row], HostFetch(dict(metrics)),
                              [f"[{epoch}: {batch}/{num_batches}]"]))
        self._drain(self.lag)

    def log_scan_steps(self, epoch: int, batch0: int, num_batches: int,
                       step_end: int, metrics: Dict[str, object], k: int,
                       points_per_step: int = 0, num_chips: int = 1) -> None:
        """Log K steps taken by one K-step call (``--scan K``).

        ``metrics`` values carry a leading K axis; one elapsed interval is
        split evenly over the K rows. The K rows enqueue as ONE pending
        group (one transfer of the [K] metric arrays) and ``lag`` counts
        launches."""
        now = time.perf_counter()
        dt = (now - self._step_t0) / max(k, 1)
        self._step_t0 = now
        rows, headers = [], []
        for i in range(k):
            row = {"epoch": epoch, "batch": batch0 + i,
                   "step": step_end - k + 1 + i,
                   "step_time_s": round(dt, 5)}
            if points_per_step:
                row["points_per_sec_per_chip"] = round(
                    points_per_step / dt / num_chips, 1)
            rows.append(row)
            headers.append(f"[{epoch}: {batch0 + i}/{num_batches}]")
        self._pending.append((rows, HostFetch(dict(metrics)), headers))
        self._drain(self.lag)

    def log_epoch(self, epoch: int, **scalars: float) -> None:
        self._drain(0)
        parts = " ".join(f"{k}: {v:.6f}" for k, v in scalars.items())
        if self.enabled:
            print(f"[epoch {epoch}] {parts}")
        row = {"epoch": epoch, **{k: float(v) for k, v in scalars.items()}}
        if self._epoch_csv is None:
            self._epoch_csv = csv.DictWriter(self._epoch_csv_file,
                                             fieldnames=row.keys())
            if self._epoch_csv_file.tell() == 0:
                self._epoch_csv.writeheader()
        self._epoch_csv.writerow(row)
        sys.stdout.flush()

    def close(self) -> None:
        self._drain(0)
        self._csv_file.close()
        self._epoch_csv_file.close()
