"""Dry run of data parallelism and point sharding on W ranks.

The port of ``__graft_entry__.py::dryrun_multichip``: one adversarial G+D
step (config 4, feature transform, augmentation on) on a global batch of
``2 W`` clouds of 64 points over W ranks (``parallel/dist.py``), held
against the same step on one device: every loss within rel 1e-5, ``acc``
within two flipped points (an argmax can flip under reduction-order
noise). Then the JAX package's variants: ``--no_paired_heads``,
``--paired_trunks`` and ``--paired_conv1`` (each at W against one device,
rel 1e-4, the fc-head BNs at this batch are in the small-batch regime
where rounding grows); point-sharded eval of the segmenter on 2 clouds of
``64 W`` points against its one-device forward (max |delta| 2e-4); and the
point-sharded train step (8 clouds of ``64 W`` points, 6 parts, no
augmentation) against the one-device step (loss rel 1e-5).

The ranks run on the first card under gloo, as ``chip_smoke.py``'s phase
25 runs its ranks (``--device cpu``: on the CPU, the kernels' plain
versions), in fp32; without a card the one-device reference raises
before any rank starts. After each step every rank must hold the same
parameters and buffers bit for bit.

    python -m adversarial_learning_on_pointclouds_tpu_torch.dryrun_multichip 4
    python -m adversarial_learning_on_pointclouds_tpu_torch.dryrun_multichip 4 --device cpu
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np

from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist, steps

NPTS = 64          # points per cloud of the G+D step
STEP_RTOL = 1e-5
VARIANT_RTOL = 1e-4
EVAL_ATOL = 2e-4
POINT_TRAIN_RTOL = 1e-5


def calls(n: int, device: str = "cuda") -> List[tuple]:
    """The dry run's checks as ``steps.run_many`` calls, for W = ``n``
    ranks and for one device."""
    batch = 2 * n
    rng = np.random.default_rng(0)
    host_batch = (
        rng.standard_normal((batch, NPTS, 3)).astype(np.float32),
        rng.integers(0, 50, (batch, NPTS)).astype(np.int32),
        rng.standard_normal((batch, NPTS, 3)).astype(np.float32))
    base = dict(batch_size=batch, num_points=NPTS, feature_transform=True,
                augment=True)
    out = [("step", steps.run_steps, dict(
        kind="adversarial", cfg_kw=base, batches=[host_batch],
        device=device), "float32")]
    for name, kw in (("no_paired_heads", dict(paired_heads=False)),
                     ("paired_trunks", dict(paired_trunks=True)),
                     ("paired_conv1", dict(paired_conv1=True))):
        out.append((name, steps.run_steps, dict(
            kind="adversarial", cfg_kw={**base, **kw}, batches=[host_batch],
            device=device), "float32"))
    xg = np.random.default_rng(3).standard_normal(
        (2, n * 64, 3)).astype(np.float32)
    seg = dict(num_parts=50, feature_transform=True)
    out.append(("point_eval", steps.run_point_eval, dict(
        kind="segment", cfg_kw=seg, x=xg, device=device, per_point=True),
        "float32"))
    rng_g = np.random.default_rng(5)
    xt = rng_g.standard_normal((8, n * 64, 3)).astype(np.float32)
    yt = rng_g.integers(0, 6, (8, n * 64)).astype(np.int32)
    out.append(("point_train", steps.run_point_train, dict(
        cfg_kw=dict(num_parts=6, num_points=n * 64, batch_size=8,
                    feature_transform=True, augment=False),
        x=xt, y=yt, device=device), "float32"))
    return out


def reference_calls(n: int, device: str = "cuda") -> List[tuple]:
    """``calls`` as one device runs them; point-sharded eval's reference
    is the model's ordinary forward (``steps.eval_forward``)."""
    out = []
    for name, fn, kw, dtype in calls(n, device):
        if name == "point_eval":
            kw = {k: v for k, v in kw.items() if k != "per_point"}
            fn = steps.eval_forward
        out.append((name, fn, kw, dtype))
    return out


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-8)


def check(got: Dict[str, dict], ref: Dict[str, dict], n: int,
          step_rtol: float = STEP_RTOL) -> List[str]:
    """The dry run's assertions on W ranks' results ``got`` (rank 0's)
    against one device's ``ref``; returns its report lines."""
    lines = []
    npts = 2 * n * NPTS
    for name, rtol in (("step", step_rtol), ("no_paired_heads", VARIANT_RTOL),
                       ("paired_trunks", VARIANT_RTOL),
                       ("paired_conv1", VARIANT_RTOL)):
        m, r = got[name]["metrics"][0], ref[name]["metrics"][0]
        assert got[name]["same"], (name, "ranks' parameters differ")
        for k in r:
            assert np.isfinite(m[k]), (name, k, m[k])
            if k == "acc":
                assert abs(m[k] - r[k]) <= 2.0 / npts + 1e-12, (name, k,
                                                                m[k], r[k])
            else:
                assert rel(m[k], r[k]) < rtol, (name, k, m[k], r[k],
                                                rel(m[k], r[k]))
        worst = max(rel(m[k], r[k]) for k in r if k != "acc")
        lines.append(f"dryrun_multichip({n}): {name} OK - "
                     + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                     + f" | {n} ranks == 1 device at rel<{rtol:g} (worst "
                     f"{worst:.1e})")
    dmax = float(np.abs(got["point_eval"] - ref["point_eval"]).max())
    assert dmax < EVAL_ATOL, ("point-sharded eval vs one device", dmax)
    lines.append(f"dryrun_multichip({n}): point-sharded eval OK - "
                 f"N={n * 64} over {n} ranks, max|delta| {dmax:.1e}")
    a = got["point_train"]["metrics"][0]["loss"]
    b = ref["point_train"]["metrics"][0]["loss"]
    assert got["point_train"]["same"], "point-sharded ranks differ"
    assert rel(a, b) < POINT_TRAIN_RTOL, ("point-sharded train loss", a, b)
    lines.append(f"dryrun_multichip({n}): point-sharded train step OK - "
                 f"N={n * 64} over {n} ranks, loss rel delta "
                 f"{rel(a, b):.1e}")
    return lines


def rank_devices(n: int, device: str) -> List[str]:
    """The ranks' devices: every rank on ``device``, a CUDA one on the
    first card."""
    return [device if device == "cpu" else "cuda:0"] * n


def dryrun_multichip(n: int, device: str = "cuda") -> List[str]:
    """Run the dry run at W = ``n`` ranks against one device; raises
    ``AssertionError`` on a failed check, else prints and returns the
    report lines."""
    ref = steps.run_many(reference_calls(n, device))
    got = dist.spawn(steps.run_many, n, rank_devices(n, device), "gloo",
                     args=(calls(n, device),))[0]
    lines = check(got, ref, n)
    for line in lines:
        print(line, flush=True)
    return lines


def add_device_flag(p: argparse.ArgumentParser) -> None:
    """``--device``, for the dry runs: ``cuda`` (every rank on the first
    card) or ``cpu``."""
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default): every rank on the first card; "
                        "cpu: the kernels' plain versions on the CPU")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=4,
                   help="ranks (gloo)")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    a = parse_args(argv)
    return dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
