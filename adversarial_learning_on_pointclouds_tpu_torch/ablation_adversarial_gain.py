"""Adversarial-gain ablation: config-4 (adv + semi) against supervised-only
on the SAME labeled subset, through the port's runner.

The port's twin of ``scripts/ablation_adversarial_gain.py``: the same
flags, the same ``.partial`` resume sidecar and the same JSON schema, so
its artifacts pool with the JAX package's under ``ablation_digest
--merge``. For each labeled_ratio and seed it trains each of ``--modes``
with ``run_adversarial`` on one synthetic ShapeNet-part fixture
(``make_synthetic_shapenet``, npz layout: the JAX sweep's h5 arrays):
``sup`` the ``--supervised_only`` control,
``adv`` config 4 (adv + semi), ``geo`` adv + semi with ``--d_geometry``,
``st`` the D-free ``--self_training`` control; identical labeled split,
data pipeline, G architecture and optimizer. It reports each run's
best-epoch instance mIoU, per ratio the mean and std of each mode and the
paired per-seed deltas against the first mode. The runs take the card
unless ``--cpu`` asks for the CPU (the kernels' plain versions).

    python -m adversarial_learning_on_pointclouds_tpu_torch.ablation_adversarial_gain \\
        --seeds 10 --ratios 0.1 --nepoch 80 --batchSize 8 --num_points 512 \\
        --num_shapes 256 --eval_every 5 --modes sup geo --cluster_parts \\
        --cluster_sigma 0.3 --json ABLATION_torch_geo_sigma030.json

The artifact's ``device`` names the card (``nvidia-smi``'s name and power
limit) or the CPU the runs took.
"""

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig, add_cpu_flag, device_from_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part import (
    make_synthetic_shapenet,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import runner

# The sweep configuration's keys, as the JAX package's sweep records them.
CFG_KEYS = ("seeds", "seed_base", "ratios", "nepoch", "batchSize",
            "num_points", "num_shapes", "scan", "semi_start", "eval_every",
            "lambda_semi", "lambda_adv", "lambda_adv_unl", "threshold",
            "st_threshold", "d_geometry", "modes", "boundary_jitter",
            "cluster_parts", "cluster_sigma")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=3, help="seeds per cell")
    p.add_argument("--seed_base", type=int, default=0,
                   help="first seed (cells run seeds seed_base..+seeds); "
                        "lets a follow-on sweep EXTEND an earlier "
                        "artifact's N without re-running its seeds — pool "
                        "with ablation_digest --merge a.json b.json")
    p.add_argument("--ratios", type=float, nargs="+", default=[0.25, 0.5])
    p.add_argument("--nepoch", type=int, default=100)
    p.add_argument("--batchSize", type=int, default=16)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--num_shapes", type=int, default=512,
                   help="synthetic fixture size (384 train / 64 test)")
    p.add_argument("--scan", type=int, default=0,
                   help="K steps per call on K-stacked batches")
    p.add_argument("--eval_every", type=int, default=1,
                   help="eval every K-th epoch + the final one (best_miou "
                        "then selects over the evaluated epochs only — a "
                        "PROTOCOL change, keep it uniform across "
                        "artifacts you pool)")
    p.add_argument("--semi_start", type=int, default=0)
    p.add_argument("--lambda_semi", type=float, default=0.1)
    p.add_argument("--lambda_adv", type=float, default=0.01)
    p.add_argument("--lambda_adv_unl", type=float, default=None)
    p.add_argument("--threshold", type=float, default=0.2)
    p.add_argument("--st_threshold", type=float, default=None,
                   help="confidence cut for the 'st' cells only (default: "
                        "--threshold); the D threshold and the max-softmax "
                        "confidence live on different scales")
    p.add_argument("--d_geometry", action="store_true",
                   help="run the adv cells with the geometry-aware D "
                        "extension (xyz channels on the D input)")
    p.add_argument("--modes", type=str, nargs="+", default=["sup", "adv"],
                   choices=["sup", "adv", "geo", "st"],
                   help="paired cells per (ratio, seed): sup = "
                        "--supervised_only control, adv = config-4 "
                        "adv+semi, geo = adv+semi with --d_geometry, st = "
                        "D-free --self_training")
    p.add_argument("--boundary_jitter", type=float, default=0.0,
                   help="per-shape label-boundary jitter for the generated "
                        "fixture (fraction of a part width)")
    p.add_argument("--cluster_sigma", type=float, default=0.18,
                   help="blob std-dev for the --cluster_parts fixture "
                        "(vs ~1.1 inter-anchor distance); larger = more "
                        "boundary points whose label is ambiguous")
    p.add_argument("--cluster_parts", action="store_true",
                   help="cluster-assumption fixture: parts are "
                        "per-shape-jittered Gaussian blobs")
    p.add_argument("--dataset", type=str, default="",
                   help="fixture root ('' = build a dedicated synthetic "
                        "fixture of --num_shapes shapes)")
    p.add_argument("--json", type=str, default="ABLATION_torch.json")
    p.add_argument("--quick", action="store_true",
                   help="tiny smoke setting: 1 seed, 2 epochs, 96 shapes, "
                        "ratio 0.5")
    add_cpu_flag(p)
    a = p.parse_args(argv)
    if a.quick:
        a.seeds, a.nepoch, a.num_shapes = 1, 2, 96
        a.ratios = [0.5]
    return a


def fixture(a: argparse.Namespace) -> str:
    """The sweep's data root: ``--dataset``, or a synthetic fixture in the
    temporary directory named for its parameters, written once (into a
    fresh directory renamed into place). The fixture is in the npz
    layout, the JAX sweep's h5 arrays without ``h5py``: every cloud taken
    whole (the pts layout would resample each with replacement, another
    protocol)."""
    if a.dataset:
        return a.dataset
    tag = (f"pointtpu_torch_ablation_npz_{a.num_shapes}x{a.num_points}"
           + (f"_bj{a.boundary_jitter:g}" if a.boundary_jitter else "")
           + ("_cl" if a.cluster_parts else "")
           + (f"_cs{a.cluster_sigma:g}"
              if a.cluster_parts and a.cluster_sigma != 0.18 else ""))
    root = os.path.join(tempfile.gettempdir(), tag)
    if os.path.isdir(root) and os.listdir(root):
        return root
    tmp = tempfile.mkdtemp(prefix=tag + ".", dir=tempfile.gettempdir())
    make_synthetic_shapenet(tmp, num_shapes=a.num_shapes,
                            num_points=a.num_points, layout="npz",
                            boundary_jitter=a.boundary_jitter,
                            cluster_parts=a.cluster_parts,
                            cluster_sigma=a.cluster_sigma)
    try:
        os.rename(tmp, root)
    except OSError:  # another sweep put its fixture in place first
        shutil.rmtree(tmp, ignore_errors=True)
    return root


def device_name(device: str) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    if device == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def resumed_cells(a: argparse.Namespace, cfg_dict: dict):
    """The ``.partial`` sidecar beside ``--json`` (JSON lines: the sweep
    configuration's fingerprint, then one line per finished cell), opened
    for appending, and ``{(ratio, seed, mode): row}`` of its cells when
    its fingerprint is this sweep's (one written before ``cluster_sigma``,
    ``eval_every`` or ``seed_base`` existed counts where they sit at their
    defaults); else a fresh sidecar and no cells."""
    cfg_fp = json.dumps(cfg_dict, sort_keys=True)
    ok_fps = {cfg_fp}
    legacy = dict(cfg_dict)
    for key, default in (("cluster_sigma", 0.18), ("eval_every", 1),
                         ("seed_base", 0)):
        if legacy.get(key) != default:
            break
        del legacy[key]
        ok_fps.add(json.dumps(legacy, sort_keys=True))
    part_path = a.json + ".partial"
    done = {}
    if os.path.exists(part_path):
        with open(part_path) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        if lines and lines[0].get("config_fp") in ok_fps:
            done = {(r["ratio"], r["seed"], r["mode"]): r
                    for r in lines[1:]}
            print(f"[ablation] resuming {a.json}: {len(done)} cells "
                  f"already complete", flush=True)
        else:
            print(f"[ablation] stale partial {part_path} (different sweep "
                  f"config) — starting fresh", flush=True)
    part = open(part_path, "a" if done else "w")
    if not done:
        part.write(json.dumps({"config_fp": cfg_fp}) + "\n")
        part.flush()
    return part, done


def summarize(a: argparse.Namespace, runs: list) -> dict:
    """Per ratio: each mode's mean, std and runs, and the paired per-seed
    deltas of every other mode against the first (mean, SE, positive
    seeds)."""
    summary = {}
    for ratio in a.ratios:
        cell = {}
        for mode in a.modes:
            vals = [r["best_miou"] for r in runs
                    if r["ratio"] == ratio and r["mode"] == mode]
            cell[mode] = {"mean": round(float(np.mean(vals)), 5),
                          "std": round(float(np.std(vals)), 5),
                          "runs": vals}
        base = a.modes[0]
        for mode in a.modes[1:]:
            d = [x - y for x, y in zip(cell[mode]["runs"],
                                       cell[base]["runs"])]
            cell[f"{mode}-{base}"] = {
                "paired_mean": round(float(np.mean(d)), 5),
                "paired_se": round(float(np.std(d) / max(len(d) - 1, 1)
                                         ** 0.5), 5),
                "positive_seeds": int(sum(x > 0 for x in d)),
                "n": len(d)}
        summary[str(ratio)] = cell
    return summary


def main(argv=None) -> dict:
    a = parse_args(argv)
    device = device_from_args(a)
    root = fixture(a)
    cfg_dict = {k: getattr(a, k) for k in CFG_KEYS}
    part, done = resumed_cells(a, cfg_dict)
    runs = []
    with part:
        for ratio in a.ratios:
            for seed in range(a.seed_base, a.seed_base + a.seeds):
                for mode in a.modes:
                    key = (ratio, seed, mode)
                    if key in done:
                        runs.append(done[key])
                        continue
                    cfg = AdversarialConfig(
                        dataset=root, labeled_ratio=ratio, seed=seed,
                        supervised_only=(mode == "sup"),
                        self_training=(mode == "st"),
                        batch_size=a.batchSize, num_points=a.num_points,
                        epochs=a.nepoch, scan=a.scan,
                        semi_start=a.semi_start, eval_every=a.eval_every,
                        lambda_semi=a.lambda_semi, lambda_adv=a.lambda_adv,
                        lambda_adv_unl=a.lambda_adv_unl,
                        semi_threshold=(a.st_threshold
                                        if mode == "st"
                                        and a.st_threshold is not None
                                        else a.threshold),
                        d_geometry=(mode == "geo"
                                    or (mode == "adv" and a.d_geometry)),
                        ckpt_policy="none", quiet=True,
                        out_dir=os.path.join(tempfile.gettempdir(),
                                             f"abl_{ratio}_{seed}_{mode}"))
                    t0 = time.perf_counter()
                    res = runner.run_adversarial(cfg, device=device)
                    row = {"ratio": ratio, "seed": seed, "mode": mode,
                           "best_miou": round(float(res["best_miou"]), 5),
                           "wall_s": round(time.perf_counter() - t0, 1)}
                    runs.append(row)
                    part.write(json.dumps(row) + "\n")
                    part.flush()
                    print(f"[ablation] {row}", flush=True)

    summary = summarize(a, runs)
    out = {"config": cfg_dict, "runs": runs, "summary": summary,
           "device": device_name(device)}
    with open(a.json, "w") as f:
        json.dump(out, f, indent=1)
    os.remove(a.json + ".partial")
    print(f"\nwrote {a.json} ({out['device']})")
    head = " | ".join(f"{m} mIoU" for m in a.modes)
    print(f"\n| labeled_ratio | {head} | paired deltas |")
    print("|---" * (len(a.modes) + 2) + "|")
    for ratio in a.ratios:
        c = summary[str(ratio)]
        cols = " | ".join(f"{c[m]['mean']:.4f} ± {c[m]['std']:.4f}"
                          for m in a.modes)
        ds = "; ".join(
            f"{k}: {v['paired_mean']:+.4f} ± {v['paired_se']:.4f} "
            f"({v['positive_seeds']}/{v['n']}+)"
            for k, v in c.items() if "-" in k)
        print(f"| {ratio} | {cols} | {ds} |")
    return out


if __name__ == "__main__":
    main()
