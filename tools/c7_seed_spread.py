#!/usr/bin/env python3
"""The spread over data and feature-map seeds of the port's Table 1
(MIMPS, MINCE with the paper's weighting, Uniform) and Table 2, at the JAX
scripts' ``--full`` sizes (n 20000, d 64, 100 queries, FMBE 16384
features), against the JAX package's own values.

    PYTHONPATH=src python3 tools/c7_seed_spread.py [--seeds 10] [--device cpu]

Table 1: each seed s draws its data, queries and tail samples from a
generator seeded with s (``paper_tables.run``'s scheme); a cell's per-seed
value is the mean over the queries, and the JAX script reports the mean of
three such values. The spread printed is the range of the per-seed values
and the range of the means of every three of them. Table 2: seed s draws
the data, the queries, their noise direction and the feature map; the JAX
script uses one such draw (its seed 0), so its value is one per-seed value.

A JAX value is "inside" when it lies within the range of the port's
per-seed values (Table 2) or of its three-seed means (Table 1). Exits 0 and
prints one JSON line with every cell.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.feature_maps import make_feature_map  # noqa: E402
from repro_torch.studies import paper_tables as pt  # noqa: E402
from repro_torch.studies.common import make_embeddings, make_queries  # noqa: E402,E501

# The JAX package's values (mu %), from its scripts run with --full on the
# CPU (``python -m benchmarks.run --full --only t1,t2``), as PERF.md lists
# them: Table 1's mean of seeds 0-2, Table 2's one draw.
JAX_TABLE1 = {
    ("MINCE", 1000, 1000): 96.94, ("MINCE", 1000, 100): 7438.10,
    ("MINCE", 1000, 10): 10890.54, ("MINCE", 100, 1000): 78.66,
    ("MINCE", 100, 100): 94.06, ("MINCE", 100, 10): 180.09,
    ("MINCE", 10, 1000): 66.38, ("MINCE", 10, 100): 192.93,
    ("MINCE", 10, 10): 331.64, ("MINCE", 1, 1000): 70.45,
    ("MINCE", 1, 100): 207.88, ("MINCE", 1, 10): 226.64,
}
JAX_TABLE2 = {
    ("Uniform", 0.0): 65.4, ("Uniform", 0.1): 65.0, ("Uniform", 0.2): 65.7,
    ("Uniform", 0.3): 66.7, ("MINCE", 0.0): 73.1, ("MINCE", 0.1): 74.4,
    ("MINCE", 0.2): 76.7, ("MINCE", 0.3): 78.6, ("FMBE", 0.0): 96.4,
    ("FMBE", 0.1): 96.5, ("FMBE", 0.2): 96.7, ("FMBE", 0.3): 96.8,
}


def table1_per_seed(seeds, dev):
    out = {}
    for s in seeds:
        g = torch.Generator(device=dev).manual_seed(s)
        v = make_embeddings(g, pt.N, pt.D, device=dev)
        q, _ = make_queries(g, v, pt.N_QUERIES)
        for key, e in pt.table1(v, q, generator=g).items():
            out.setdefault(key, []).append(float(np.mean(e)))
    return out


def table2_per_seed(seeds, dev):
    out = {}
    for s in seeds:
        g = torch.Generator(device=dev).manual_seed(s)
        v = make_embeddings(g, pt.N, pt.D, device=dev)
        _, idx = make_queries(g, v, pt.N_QUERIES)
        noise = torch.randn((pt.N_QUERIES, pt.D), generator=g, device=dev)
        fm = make_feature_map(g, pt.D, pt.FMBE_FEATURES, device=dev)
        for key, e in pt.table2(v, idx, noise, fm, generator=g).items():
            out.setdefault(key, []).append(float(np.mean(e)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--table2-seeds", type=int, default=5)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    t0 = time.time()
    t1 = table1_per_seed(range(args.seeds), dev)
    t2 = table2_per_seed(range(args.table2_seeds), dev)
    cells = []
    print(f"Table 1, {args.seeds} seeds: cell, JAX mu, port per-seed "
          f"min/median/max, range of 3-seed means, inside")
    for key, jax_mu in JAX_TABLE1.items():
        vals = t1[key]
        means = [float(np.mean(c)) for c in itertools.combinations(vals, 3)]
        inside = min(means) <= jax_mu <= max(means)
        cells.append({"table": 1, "cell": list(key), "jax": jax_mu,
                      "per_seed": vals, "mean3_min": min(means),
                      "mean3_max": max(means), "inside": inside})
        print(f"  {key}: {jax_mu:9.2f} | {min(vals):9.2f} "
              f"{float(np.median(vals)):9.2f} {max(vals):9.2f} | "
              f"[{min(means):9.2f}, {max(means):9.2f}] "
              f"{'inside' if inside else 'OUTSIDE'}")
    print(f"Table 2, {args.table2_seeds} seeds: cell, JAX mu, port "
          f"per-seed values, inside")
    for key, jax_mu in JAX_TABLE2.items():
        vals = t2[key]
        inside = min(vals) <= jax_mu <= max(vals)
        cells.append({"table": 2, "cell": list(key), "jax": jax_mu,
                      "per_seed": vals, "inside": inside})
        print(f"  {key}: {jax_mu:7.2f} | "
              + " ".join(f"{x:7.2f}" for x in vals)
              + f" {'inside' if inside else 'OUTSIDE'}")
    print(f"seconds {time.time() - t0:.1f}")
    print(json.dumps({"cells": cells}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
