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

``layer_report(n, device)`` records the ``"step"`` check layer by layer
(every BatchNorm's moments and the kernel sums behind them, the pooled
rows, the T-Net heads, the log-probs, D's logits, the semi mask) on the
device at one rank and at W ranks, and on the CPU's plain versions in
fp32 and float64 replaying the batch the device drew; it names the
first quantity where the device sits more than ``SITE_FACTOR`` times the
CPU fp32's distance from float64.

    python -m adversarial_learning_on_pointclouds_tpu_torch.dryrun_multichip 4
    python -m adversarial_learning_on_pointclouds_tpu_torch.dryrun_multichip 4 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# The dry run's G+D step layer by layer (``layer_report``)
# ---------------------------------------------------------------------------

# How a recorded quantity is held against its reference: "rel" element by
# element (the variances and sums of squares, which BatchNorm divides
# by), "norm" the largest difference over the reference's largest value
# (means, sums, activations), "count" the entries that differ (the
# pseudo-labels, the semi mask).
KINDS = {"var": "rel", "ss": "rel", "pseudo": "count", "mask": "count"}
SITE_FACTOR = 4.0    # a card result this far past the yardstick: the site


def _kind(name: str) -> str:
    return KINDS.get(name.split("/")[0].rsplit(".", 1)[-1], "norm")


def _rows_np(t: torch.Tensor) -> np.ndarray:
    """The global batch's rows of a rank's ``t`` (every rank's block in
    rank order), on the host in float64."""
    return dist.gather_axis(t.detach().double()).to("cpu").numpy()


def _global_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy().copy()


@contextlib.contextmanager
def _taps(rec: dict, augmented: Optional[tuple], dev):
    """Record the G step's quantities (of the state ``steps.make_state``
    builds) into ``rec`` (``{name: float64 array}``, the global batch's)
    for the duration: every BatchNorm's batch mean and variance
    (``core.update_running``) and, where a kernel made them, the column
    sums ``s``/``ss`` behind them (``batch_moments``); each trunk's
    pooled rows; each T-Net's fc1 rows (``relu_fc_bn_relu``, on the
    gathered global rows) and transform; the encoder's per-point
    feature; the seg head's log-probs; D's logits; the semi loss's mask
    and argmax pseudo-labels. ``augmented``
    (the global ``(x_l, y_l, x_u)`` after the augmentation chain) stands
    in for the chain's output; the chain's output is recorded as
    ``rec["_batch"]``. Streams are ``/a`` (labeled) and ``/b``."""
    from adversarial_learning_on_pointclouds_tpu_torch import losses
    from adversarial_learning_on_pointclouds_tpu_torch.data import augment
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        FCDiscriminator, PointNetDenseCls, core, encoder, tnet,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        pool_fc_epilogue, seg_head_train, trunk_train,
    )

    names: Dict[int, str] = {}
    seen: Dict[str, int] = {}
    moments: List[tuple] = []
    stn: List[str] = []
    saved = []

    def stream(name: str) -> str:
        seen[name] = seen.get(name, 0) + 1
        return f"{name}/{'ab'[seen[name] - 1]}"

    def patch(owner, attr, make):
        orig = getattr(owner, attr)
        saved.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def state(orig):
        def f(*args, **kw):
            out = orig(*args, **kw)
            names.update((id(m), k) for k, m in out[2].g_model.named_modules())
            return out
        return f

    def chain(orig):
        def f(gen, cfg, a, b, step=None):
            if augmented is None:
                out = orig(gen, cfg, a, b, step)
            else:
                x_l, y_l, x_u = (steps._local(v, dev, i == 1)
                                 for i, v in enumerate(augmented))
                out = ((x_l, y_l), x_u)
            (x_l, y_l), x_u = out
            rec["_batch"] = tuple(dist.gather_axis(t).to("cpu").numpy()
                                  for t in (x_l, y_l, x_u))
            return out
        return f

    def moments_tap(orig):
        def f(s, ss, m):
            mu, var, inv = orig(s, ss, m)
            for i in range(mu.reshape(-1, mu.shape[-1]).shape[0]):
                moments.append(tuple(t.reshape(-1, t.shape[-1])[i]
                                     for t in (s, ss, mu)))
            return mu, var, inv
        return f

    def running(orig):
        def f(bn, mean, var, m):
            name = names.get(id(bn))
            if name is not None:
                key = stream(name)
                base, s = key.split("/")
                rec[f"{base}.mean/{s}"] = _global_np(mean)
                rec[f"{base}.var/{s}"] = _global_np(var)
                if moments and torch.equal(moments[0][2], mean):
                    s_, ss_, _ = moments.pop(0)
                    rec[f"{base}.s/{s}"] = _global_np(s_)
                    rec[f"{base}.ss/{s}"] = _global_np(ss_)
            return orig(bn, mean, var, m)
        return f

    def trunk(orig):
        def f(module, *xs):
            g = orig(module, *xs)
            if len(xs) == 1:
                rec[stream(names[id(module)] + ".pooled")] = _rows_np(g)
            return g
        return f

    def fc1(orig):
        def f(g, *args, groups: int = 1, **kw):
            h1, mu, var = orig(g, *args, groups=groups, **kw)
            rows = _global_np(h1).reshape(groups, -1, h1.shape[-1])
            for i in range(groups):
                rec[stream(stn[-1] + ".fc1")] = rows[i]
            return h1, mu, var
        return f

    def tnet_pair(orig):
        def f(self, x_a, x_b, *args):
            stn.append(names[id(self)])
            t_a, t_b = orig(self, x_a, x_b, *args)
            for t in (t_a, t_b):
                rec[stream(stn[-1] + ".transform")] = _rows_np(t)
            return t_a, t_b
        return f

    def feat_pair(orig):
        def f(self, x_a, x_b, *args):
            out = orig(self, x_a, x_b, *args)
            for pf in (out[0], out[2]):
                rec[stream("feat.point_feature")] = _rows_np(pf)
            return out
        return f

    def seg_pair(orig):
        def f(self, x_a, x_b, *args):
            out = orig(self, x_a, x_b, *args)
            for logp in out[:2]:
                rec[stream("seg.log_probs")] = _rows_np(logp)
            return out
        return f

    def frozen(orig):
        def f(self, x):
            logits = orig(self, x)
            rec[stream("d.logits")] = _rows_np(logits)
            return logits
        return f

    def semi(orig):
        def f(log_probs, d_logits, threshold):
            rec["semi.pseudo/b"] = _rows_np(log_probs.detach().argmax(-1))
            rec["semi.mask/b"] = _rows_np(
                torch.sigmoid(d_logits.detach()[..., 0]) > threshold)
            return orig(log_probs, d_logits, threshold)
        return f

    patch(steps, "make_state", state)
    patch(augment, "chain_pair_from_cfg", chain)
    for mod in (trunk_train, seg_head_train):
        patch(mod, "batch_moments", moments_tap)
    patch(core, "update_running", running)
    for mod in (tnet, encoder):
        patch(mod, "train_trunk", trunk)
    patch(pool_fc_epilogue, "relu_fc_bn_relu", fc1)
    patch(tnet.STNkd, "forward_pair", tnet_pair)
    patch(encoder.PointNetfeat, "forward_pair", feat_pair)
    patch(PointNetDenseCls, "forward_pair", seg_pair)
    patch(FCDiscriminator, "frozen", frozen)
    patch(losses, "semi_loss", semi)
    try:
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def probe_step(cfg_kw: dict, batch: tuple, device="cpu", weights=None,
               augmented: Optional[tuple] = None) -> dict:
    """One config-4 ``train_step`` on this rank's rows of the global
    ``batch`` (``steps.run_steps``) with ``_taps``' record. ``augmented``
    replaces the augmentation chain's output (a float64 run, or another
    device, on a batch this run did not draw). Returns ``{"metrics",
    "record", "batch"}`` (the record and the augmented batch are the
    global batch's on every rank)."""
    rec: dict = {}
    with _taps(rec, augmented, dist.rank_device(device)):
        out = steps.run_steps("adversarial", cfg_kw, [batch], device,
                              weights)
    return {"metrics": out["metrics"][0], "record": rec,
            "batch": rec.pop("_batch")}


def initial_weights(cfg_kw: dict) -> dict:
    """The seeded G and D of config 4 under ``cfg_kw`` as numpy state
    dicts (the CPU's init, which every device's run loads)."""
    _, _, state = steps.make_state("adversarial", cfg_kw, "cpu")
    return {name: {k: v.detach().numpy().copy()
                   for k, v in net.state_dict().items()}
            for name, net in steps.models_of(state).items()}


def layer_runs(n: int = 2, device: str = "cuda",
               augmented: Optional[tuple] = None) -> Dict[str, dict]:
    """The dry run's ``"step"`` call (``calls(n)``) recorded layer by
    layer (``probe_step``) five ways, from the same weights: ``one`` and
    ``ranks`` (W = ``n`` gloo ranks) on ``device``; then, on the
    augmented batch ``one`` drew, the CPU's plain versions in fp32 at W =
    1 (``cpu``) and ``n`` (``cpu_ranks``) and in float64 (``f64``: the
    state dicts and the batch as ``.double()``). ``augmented`` (the
    global ``(x_l, y_l, x_u)``) replaces the augmentation in all five."""
    _, _, kw, _ = calls(n, device)[0]
    cfg_kw, batch = kw["cfg_kw"], kw["batches"][0]
    weights = initial_weights(cfg_kw)
    base = dict(cfg_kw=cfg_kw, batch=batch, weights=weights,
                augmented=augmented)
    one = steps.run_many([("p", probe_step, dict(base, device=device),
                           "float32")])["p"]
    ranks = dist.spawn(steps.run_many, n, rank_devices(n, device), "gloo",
                       args=([("p", probe_step, dict(base, device=device),
                               "float32")],))[0]["p"]
    cpu = dict(base, device="cpu", augmented=one["batch"])
    ref = steps.run_many([("cpu", probe_step, cpu, "float32"),
                          ("f64", probe_step, cpu, "float64")])
    cpu_ranks = dist.spawn(steps.run_many, n, ["cpu"] * n, "gloo",
                           args=([("p", probe_step, cpu, "float32")],))[0]
    return {"one": one, "ranks": ranks, "cpu": ref["cpu"],
            "cpu_ranks": cpu_ranks["p"], "f64": ref["f64"]}


def distance(name: str, got: np.ndarray, ref: np.ndarray) -> float:
    """``got``'s distance from ``ref`` by the quantity's kind (``KINDS``)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    kind = _kind(name)
    if kind == "count":
        return float(np.sum(got != ref))
    d = np.abs(got - ref)
    if kind == "rel":
        return float(np.max(d / np.maximum(np.abs(ref), 1e-30)))
    return float(d.max() / max(float(np.abs(ref).max()), 1e-30))


def layer_table(runs: Dict[str, dict]) -> List[dict]:
    """Per recorded quantity, in the step's order: each device result's
    distance from float64 (``one``, ``ranks``), the yardstick (the CPU
    fp32 plain path's distance from float64, ``cpu``), ``|ranks - one|``
    and the CPU's ``|cpu_ranks - cpu|``, and ``factor``: the larger
    device distance over the yardstick (counts: their difference)."""
    f64 = runs["f64"]["record"]
    rows = []
    for name, ref in f64.items():
        d = {k: distance(name, runs[k]["record"][name], ref)
             for k in ("one", "ranks", "cpu")}
        row = {"name": name, "kind": _kind(name), **d,
               "ranks_one": distance(name, runs["ranks"]["record"][name],
                                     runs["one"]["record"][name]),
               "cpu_ranks_cpu": distance(
                   name, runs["cpu_ranks"]["record"][name],
                   runs["cpu"]["record"][name])}
        worst = max(d["one"], d["ranks"])
        row["factor"] = (worst - d["cpu"] if row["kind"] == "count"
                         else worst / max(d["cpu"], 1e-12))
        rows.append(row)
    return rows


def fault_site(rows: List[dict]) -> Optional[str]:
    """The first quantity whose device result sits more than
    ``SITE_FACTOR`` times the yardstick from float64 (a count: more
    entries off than the CPU's), or None."""
    for row in rows:
        if row["kind"] == "count":
            if row["factor"] > 0:
                return row["name"]
        elif row["factor"] > SITE_FACTOR:
            return row["name"]
    return None


def layer_report(n: int = 2, device: str = "cuda") -> Tuple[List[str],
                                                            List[dict]]:
    """``layer_runs`` as report lines: each quantity's distances, the
    losses of the five runs, the site (``fault_site``)."""
    runs = layer_runs(n, device)
    rows = layer_table(runs)
    lines = [f"layer_record({n}, {device}): distance from float64 of "
             f"{device} W=1 / W={n}, CPU fp32 (yardstick); |W={n} - W=1| "
             f"on {device} / the CPU; factor"]
    for r in rows:
        lines.append(f"  {r['name']:<34} {r['kind']:<5} {r['one']:.3e} "
                     f"{r['ranks']:.3e} {r['cpu']:.3e} | {r['ranks_one']:.3e}"
                     f" {r['cpu_ranks_cpu']:.3e} | {r['factor']:.3g}")
    for k in ("one", "ranks", "cpu", "cpu_ranks", "f64"):
        lines.append(f"  metrics {k}: " + " ".join(
            f"{m}={v:.9g}" for m, v in runs[k]["metrics"].items()))
    semi = {k: r["metrics"]["loss_semi"] for k, r in runs.items()}
    lines.append(f"  loss_semi rel W={n} to W=1 on {device}: "
                 f"{rel(semi['ranks'], semi['one']):.3e}, on the CPU "
                 f"{rel(semi['cpu_ranks'], semi['cpu']):.3e}")
    lines.append(f"  site: {fault_site(rows)}")
    return lines, rows


def rank_devices(n: int, device: str) -> List[str]:
    """The ranks' devices: every rank on ``device``, a CUDA one on the
    first card."""
    return [device if device == "cpu" else "cuda:0"] * n


def run(n: int, device: str = "cuda") -> Tuple[dict, dict]:
    """The dry run's results ``(got, ref)``: W = ``n`` ranks' (rank 0's)
    and one device's, unchecked."""
    ref = steps.run_many(reference_calls(n, device))
    got = dist.spawn(steps.run_many, n, rank_devices(n, device), "gloo",
                     args=(calls(n, device),))[0]
    return got, ref


def worst(got: dict, ref: dict) -> Dict[str, float]:
    """Each check's worst relative error of ``run``'s results (every loss
    but ``acc``; the point-sharded eval's max |delta|)."""
    out = {}
    for name in ("step", "no_paired_heads", "paired_trunks",
                 "paired_conv1", "point_train"):
        m, r = got[name]["metrics"][0], ref[name]["metrics"][0]
        out[name] = max(rel(m[k], r[k]) for k in r if k != "acc")
    out["point_eval"] = float(np.abs(got["point_eval"]
                                     - ref["point_eval"]).max())
    return out


def dryrun_multichip(n: int, device: str = "cuda") -> List[str]:
    """Run the dry run at W = ``n`` ranks against one device; raises
    ``AssertionError`` on a failed check, else prints and returns the
    report lines."""
    got, ref = run(n, device)
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
