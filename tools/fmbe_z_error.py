#!/usr/bin/env python3
"""``fmbe_z``'s error against float64 on one GPU, beside the error of its
plain versions.

    python3 tools/fmbe_z_error.py       # from the repository root

Over ``SEEDS`` seeded draws of the inputs of the card test
``test_fmbe_z_matches_plain`` (degrees truncated-geometric with one of
degree 0 and one of degree 8, coef U(0, 0.01), x ~ N(0, 1) at d 2560, so
|x| is about 50 and a product of 8 projections about 1e13, lambda
N(0, 1)), at Q 13 and P 70 and 4096, lambda shared and per query, x bf16
and f32, it computes z in float64 from the pack and prints, for each
version, its largest error against float64 as a share of the tolerance
1e-4 * sum_j |phi_j lambda_j| + 1e-6 (the terms in float64): the kernel,
the plain version (``fmbe_z_plain``, f32 products) and the pack's
decomposition (``fmbe_z_pack_plain``; at f32 ``fmbe_z_planes_plain``),
and the kernel's largest difference from the plain version in the same
units. Prints the card's name and power limit
and writes everything to ``chiprun_out/fmbe_z_error.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

Q, D, SEEDS = 13, 2560, 20


def feature_map(torch, gen, p, m=8):
    """The card test's map: truncated-geometric degrees, feature 0 of
    degree 0 and feature 1 of degree m."""
    probs = torch.tensor([2.0 ** -(i + 1) for i in range(m + 1)],
                         device="cuda")
    degree = torch.multinomial(probs / probs.sum(), p, replacement=True,
                               generator=gen).to(torch.int32)
    degree[0], degree[1] = 0, m
    omega = (2 * torch.randint(0, 2, (p, m, D), generator=gen,
                               device="cuda") - 1).float()
    coef = torch.rand(p, generator=gen, device="cuda") * 0.01
    return omega, degree, coef


def z64(torch, pack, lam, x):
    """(z, terms) in float64 from the pack."""
    proj = x.double() @ pack.rows.double().T
    prod = torch.ones((x.shape[0], pack.start.shape[0]), dtype=torch.float64,
                      device=x.device)
    for m in range(8):
        use = pack.degree > m
        col = torch.where(use, pack.start + m, 0).long()
        prod = torch.where(use[None, :], prod * proj[:, col], prod)
    terms = prod * pack.coef.double() * lam.double()
    return terms.sum(-1), terms


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import (fmbe_pack, fmbe_z,
                                          fmbe_z_pack_plain,
                                          fmbe_z_planes_plain, fmbe_z_plain)
    if not torch.cuda.is_available():
        print("fmbe_z_error: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.build_all(["fmbe_z"])
    rows = []
    for p in (70, 4096):
        for shared in (True, False):
            for dtype in (torch.bfloat16, torch.float32):
                worst = {}
                for seed in range(SEEDS):
                    gen = torch.Generator(device="cuda").manual_seed(seed)
                    omega, degree, coef = feature_map(torch, gen, p)
                    pack = fmbe_pack(omega, degree, coef)
                    x = torch.randn(Q, D, generator=gen,
                                    device="cuda").to(dtype)
                    lam = torch.randn((p,) if shared else (Q, p),
                                      generator=gen, device="cuda")
                    want, terms = z64(torch, pack, lam, x)
                    tol = 1e-4 * terms.abs().sum(-1) + 1e-6
                    decomposition = (fmbe_z_planes_plain
                                     if dtype == torch.float32
                                     else fmbe_z_pack_plain)
                    got = {
                        "kernel": fmbe_z(omega, degree, coef, lam, x,
                                         pack=pack),
                        "plain": fmbe_z_plain(omega, degree, coef, lam, x),
                        "decomposition": decomposition(pack, lam, x),
                    }
                    for name, z in got.items():
                        r = ((z.double() - want).abs() / tol).max().item()
                        worst[name] = max(worst.get(name, 0.0), r)
                    r = ((got["kernel"].double() - got["plain"].double())
                         .abs() / tol).max().item()
                    worst["kernel - plain"] = max(
                        worst.get("kernel - plain", 0.0), r)
                row = dict(P=p, shared=shared, dtype=str(dtype), **worst)
                rows.append(row)
                print(f"P {p} lambda {'shared' if shared else 'per query'} "
                      f"{dtype}: largest error against float64, share of "
                      f"the tolerance, over {SEEDS} draws: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in worst.items())
                      + f" [{card}]", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fmbe_z_error.json").write_text(json.dumps(
        {"card": card, "Q": Q, "d": D, "seeds": SEEDS, "rows": rows},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
