"""Multi-host data parallelism, simulated on one machine.

The port of ``scripts/multihost_check.py``: 2 hosts x 2 ranks, four
processes in one gloo group on localhost, laid out host-major (rank =
host x 2 + local, ``parallel/dist.host_major_rank``, as
``make_multihost_mesh`` lays out its devices), run the full adversarial
G+D step (config 4, 50 parts, B=8 clouds of 64 points, no augmentation)
with each rank feeding only its own rows of the batch, as a per-host
input pipeline would. The launcher runs the same step in one process;
every metric must agree within 1e-5 of ``1 + |metric|``, and after the
step every rank's parameters and BatchNorm buffers must equal rank 0's
bit for bit. The ranks and the one process run on the first card (the
ranks under gloo) unless ``--device cpu`` asks for the CPU; without a
card the one process raises before any rank starts.

    python -m adversarial_learning_on_pointclouds_tpu_torch.multihost_check
    python -m adversarial_learning_on_pointclouds_tpu_torch.multihost_check --device cpu
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from adversarial_learning_on_pointclouds_tpu_torch.dryrun_multichip import (
    add_device_flag, rank_devices,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist, steps

NUM_HOSTS = 2
RANKS_PER_HOST = 2
B, N = 8, 64
RTOL = 1e-5


def host_rank(cfg_kw: dict, batch: tuple, device: str = "cuda") -> dict:
    """One rank of the simulated slice: its (host, local) place, and
    ``steps.run_steps`` on its rows on ``device``."""
    r = dist.rank()
    host, local = divmod(r, RANKS_PER_HOST)
    assert dist.host_major_rank(host, local, RANKS_PER_HOST) == r
    out = steps.run_steps("adversarial", cfg_kw, [batch], device=device)
    out["host"], out["local"] = host, local
    return out


def scenario():
    """``(cfg_kw, batch)``: the step's config and its global batch (the
    same data in every process)."""
    cfg_kw = dict(num_parts=50, batch_size=B, num_points=N,
                  feature_transform=False, augment=False)
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((B, N, 3)).astype(np.float32),
             rng.integers(0, 50, (B, N)).astype(np.int32),
             rng.standard_normal((B, N, 3)).astype(np.float32))
    return cfg_kw, batch


def check(outs: list, ref: dict) -> list:
    """Every rank's metrics (``outs``, ``host_rank``'s results) against
    one process's (``ref``), and every rank's parameters equal; returns
    the report lines."""
    lines, worst = [], 0.0
    for out in outs:
        for k, v in out["metrics"][0].items():
            err = abs(v - ref[k]) / (1.0 + abs(ref[k]))
            worst = max(worst, err)
            assert err < RTOL, (out["rank"], k, v, ref[k])
        assert out["same"], f"rank {out['rank']}: parameters differ"
        lines.append(f"rank {out['rank']} (host {out['host']}, local "
                     f"{out['local']}): OK {NUM_HOSTS} hosts x "
                     f"{RANKS_PER_HOST} ranks G+D step == one process, "
                     f"worst rel={worst:.2e}")
    return lines + ["MULTIHOST OK"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(p)
    device = p.parse_args(argv).device
    cfg_kw, batch = scenario()
    ref = steps.run_steps("adversarial", cfg_kw, [batch],
                          device=device)["metrics"][0]
    world = NUM_HOSTS * RANKS_PER_HOST
    outs = dist.spawn(host_rank, world, rank_devices(world, device),
                      backend="gloo", args=(cfg_kw, batch, device))
    for line in check(outs, ref):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
