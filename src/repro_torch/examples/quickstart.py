"""Quickstart: estimate the softmax partition function Z(q) sublinearly
(counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a word2vec-like class-vector set (``studies.common.make_embeddings``),
runs every estimator of the paper (exact, MIMPS, NMIMPS, uniform IS, MINCE,
FMBE) and the block-IVF MIMPS, and prints each one's relative error and
multiply-adds a query. ``main`` returns the rows.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from .. import resolve_device
from ..core.estimators import (exact_log_z, fmbe_log_z, mimps_ivf,
                               mimps_log_z, mince_log_z, nmimps_log_z,
                               relative_error, uniform_log_z)
from ..core.feature_maps import build_fmbe, make_feature_map
from ..core.mips import build_ivf, exact_top_k
from ..studies.common import make_embeddings


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--n", type=int, default=20000, help="vocabulary rows")
    ap.add_argument("--d", type=int, default=64, help="row width")
    ap.add_argument("--features", type=int, default=16384,
                    help="FMBE random features")
    ap.add_argument("--block-rows", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, d = args.n, args.d

    def gen(offset):
        return torch.Generator(device=dev).manual_seed(args.seed + offset)

    v = make_embeddings(gen(0), n, d, device=dev)
    q = v[137 % n]               # a mid-frequency "word" as the context
    log_z = exact_log_z(v, q)
    print(f"vocab N={n}, d={d}")
    print(f"exact    log Z = {float(log_z):.4f}   (cost: {n * d:,} MACs)")

    big, small = min(1000, n // 2), min(100, n // 4)
    rows = [
        ("exact", exact_log_z(v, q), n * d),
        (f"MIMPS k={big} l={big}", mimps_log_z(v, q, big, big, gen(1)),
         2 * big * d),
        (f"MIMPS k={small} l={small}",
         mimps_log_z(v, q, small, small, gen(2)), 2 * small * d),
        (f"NMIMPS k={small} (head only)", nmimps_log_z(v, q, small),
         small * d),
        (f"Uniform l={big}", uniform_log_z(v, q, big, gen(3)), big * d),
        (f"MINCE k={small} l={small} (Halley)",
         mince_log_z(v, q, small, small, gen(4)), 2 * small * d),
    ]
    fm = make_feature_map(gen(5), d, args.features, device=dev)
    rows.append((f"FMBE P={args.features}",
                 fmbe_log_z(build_fmbe(fm, v), q), args.features * 8))

    # the deployment path: block-IVF MIMPS (sublinear retrieval, not an
    # oracle sort)
    idx = build_ivf(v, block_rows=args.block_rows, generator=gen(6),
                    device=dev)
    probes = min(8, idx.n_blocks)
    tail = min(256, n // 4)
    r = mimps_ivf(idx, q, probes, tail, gen(7))
    ivf_cost = (idx.n_blocks + probes * idx.block_rows + tail) * d
    rows.append((f"IVF-MIMPS probe={probes} l={tail}", r.log_z, ivf_cost))

    print(f"\n{'estimator':32s} {'log Z_hat':>10s} {'rel err %':>10s} "
          f"{'MACs/query':>12s}")
    out = []
    for name, lz, cost in rows:
        err = float(relative_error(lz, log_z))
        out.append({"name": name, "log_z": float(lz), "rel_err": err,
                    "macs": cost})
        print(f"{name:32s} {float(lz):10.4f} {100 * err:10.2f} {cost:12,}")
    _, true_top = exact_top_k(v, q, 1)
    print(f"\nIVF-MIMPS scans {ivf_cost / (n * d) * 100:.1f}% of brute-force "
          f"MACs; retrieved argmax id {int(r.top_id)} (exact argmax "
          f"{int(true_top[0])})")
    return {"log_z": float(log_z), "rows": out, "ivf_top_id": int(r.top_id),
            "exact_top_id": int(true_top[0])}


if __name__ == "__main__":
    main()
