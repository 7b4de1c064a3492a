"""Re-render the paired-delta tables from ABLATION_*.json artifacts.

The port's copy of ``scripts/ablation_digest.py`` (numpy only), for the
artifacts of ``ablation_adversarial_gain`` (the JAX package's or the
port's: they share one schema, so they pool). Every ablation sweep writes
a JSON artifact with per-run results; this digest reproduces the tables
from those artifacts (so recorded numbers are auditable), and can merge
several artifacts that share a protocol (e.g. the main sweep plus a
`--semi_start` variant) into one table keyed by an extra label.

    python -m adversarial_learning_on_pointclouds_tpu_torch.ablation_digest \\
        A.json
    ... main=A.json ss150=B.json              # side-by-side tables
    ... --merge seeds04.json seeds59.json      # POOLED table
    ... RUNNING.json.partial                   # in-flight sidecar

``--merge`` pools the runs of all given artifacts into ONE table —
for seed-extension sweeps (`--seed_base`) where the paired deltas
should use the union of seeds. Pairing is by seed (cells are
seed-sorted), so artifact order doesn't matter. ``.partial`` sidecars
(JSON-lines, config fingerprint header) are read natively, so a
mid-flight sweep can be digested without waiting for the final
artifact.
"""

import json
import sys

import numpy as np


def _load(path):
    """Artifact OR ``.partial`` sidecar -> ``(config_or_None, runs)``."""
    with open(path) as f:
        first = f.readline()
        try:  # sidecar: JSON-lines with a config-fingerprint header
            head = json.loads(first)
        except json.JSONDecodeError:  # pretty-printed artifact
            head = None
        if isinstance(head, dict) and "config_fp" in head:
            runs = [json.loads(ln) for ln in f if ln.strip()]
            return json.loads(head["config_fp"]), runs, {}
        f.seek(0)
        art = json.load(f)
        return art.get("config"), art["runs"], art


def _cells(runs, modes, ratio):
    cell = {}
    for mode in modes:
        rows = sorted((r for r in runs
                       if r["ratio"] == ratio and r["mode"] == mode),
                      key=lambda r: r.get("seed", 0))
        if rows:
            cell[mode] = [r["best_miou"] for r in rows]
    return cell


def _sign_test_p(pos: int, n: int) -> float:
    """Exact two-sided sign test: P(#positive as or more extreme than
    ``pos`` | fair coin, n trials). Zero deltas should be excluded by
    the caller (here: mIoU deltas are continuous, ties don't occur)."""
    from math import comb

    k = max(pos, n - pos)
    tail = sum(comb(n, i) for i in range(k, n + 1)) / 2.0 ** n
    return min(1.0, 2.0 * tail)


def _paired(a, b):
    d = [x - y for x, y in zip(a, b)]
    se = float(np.std(d) / max(len(d) - 1, 1) ** 0.5)
    return (float(np.mean(d)), se, sum(x > 0 for x in d), len(d))


def digest(label, path, pooled_runs=None, pooled_cfg=None):
    if pooled_runs is not None:
        art, cfg, runs = {}, pooled_cfg, pooled_runs
    else:
        cfg, runs, art = _load(path)
    for r in runs:  # hand-rolled early artifacts lack the ratio key
        r.setdefault("ratio", None)
    print(f"\n### {label or path}")
    if cfg is None:  # early artifact schema: free-text protocol only
        print(f"protocol: {art.get('protocol', '(unrecorded)')}")
        cfg = {"ratios": sorted({r["ratio"] for r in runs},
                                key=lambda v: (v is None, v))}
        modes = list(dict.fromkeys(r["mode"] for r in runs))
    else:
        modes = [m for m in cfg.get("modes", ["sup", "adv"])
                 if any(r["mode"] == m for r in runs)]
        fixture = ("cluster_parts" if cfg.get("cluster_parts")
                   else f"boundary_jitter={cfg['boundary_jitter']:g}"
                   if cfg.get("boundary_jitter") else "axis-quantized")
        g = cfg.get
        print(f"fixture: {fixture}; {g('num_shapes')}x"
              f"{g('num_points')}, batch {g('batchSize')}, "
              f"{g('nepoch')} epochs, {g('seeds')} seeds; "
              f"semi_start={g('semi_start')}, "
              f"lambda_semi={g('lambda_semi')}, "
              f"threshold={g('threshold')}"
              + (f", st_threshold={g('st_threshold')}"
                 if g("st_threshold") is not None else ""))
    head = " | ".join(f"{m} mIoU" for m in modes)
    print(f"\n| ratio | {head} | paired deltas (mean ± SE, +seeds) |")
    print("|---" * (len(modes) + 2) + "|")
    for ratio in cfg["ratios"]:
        c = _cells(runs, modes, ratio)
        cols = " | ".join(
            f"{np.mean(c[m]):.4f} ± {np.std(c[m]):.4f}" for m in modes)
        base = modes[0]
        parts = []
        for m in modes[1:]:
            if len(c.get(m, ())) != len(c[base]):
                continue
            mean, se, pos, n = _paired(c[m], c[base])
            parts.append(f"{m}−{base}: {mean:+.4f} ± {se:.4f} "
                         f"({pos}/{n}+, p={_sign_test_p(pos, n):.2f})")
        ds = "; ".join(parts)
        print(f"| {ratio} | {cols} | {ds} |")


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    merge = "--merge" in args
    if merge:
        args.remove("--merge")
    if not args:
        print(__doc__)
        sys.exit(1)
    if merge:
        cfg, runs, ratios = None, [], []
        for arg in args:
            _, _, path = arg.rpartition("=")
            c, r, _ = _load(path or arg)
            # Pooled paired deltas are only meaningful over ONE protocol:
            # refuse to merge artifacts whose configs differ on anything
            # but the seed window (silent cross-protocol pooling is the
            # manufactured-fake-delta failure the round-3 notes warn of).
            # ``ratios`` is exempt: every run records its own ratio and a
            # table row pools only runs AT that ratio, so an artifact
            # that extends seeds at a subset of the ratios (e.g. only the
            # informative one) merges soundly — its rows just carry a
            # larger N than the others.
            if c is not None:
                ratios.extend(v for v in c.get("ratios", ())
                              if v not in ratios)
                key = {k: v for k, v in c.items()
                       if k not in ("seeds", "seed_base", "ratios")}
                if cfg is None:
                    cfg = key
                elif key != cfg:
                    diff = sorted(k for k in set(key) | set(cfg)
                                  if key.get(k) != cfg.get(k))
                    sys.exit(f"--merge: {arg} was run under a different "
                             f"protocol (differs on {diff}) — pooling "
                             f"would pair across protocols")
            runs.extend(r)
        keys = [(r.get("ratio"), r.get("seed"), r.get("mode"))
                for r in runs]
        dups = sorted({k for k in keys if keys.count(k) > 1}, key=repr)
        if dups:
            sys.exit(f"--merge: duplicate (ratio, seed, mode) cells "
                     f"across artifacts (forgot --seed_base?): "
                     f"{dups[:4]}{'...' if len(dups) > 4 else ''}")
        seeds = sorted({r.get("seed") for r in runs},
                       key=lambda s: (s is None, s))
        if cfg is not None:
            cfg = dict(cfg, seeds=len(seeds),
                       ratios=sorted(ratios))  # union across artifacts
        digest(f"POOLED ({len(args)} artifacts, seeds {seeds})", None,
               pooled_runs=runs, pooled_cfg=cfg)
        return
    for arg in args:
        label, _, path = arg.rpartition("=")
        digest(label, path or arg)


if __name__ == "__main__":
    main()
