"""The paper's SS5.2 on the training stack: train a small LM with the
self-normalisation penalty (so Z is near 1 at test time, the Devlin/NCE
heuristic), then show MIMPS beats the "assume Z = 1" shortcut on held-out
contexts: Table 4's conclusion on a transformer rather than the LBL
(counterpart of ``examples/train_selfnorm_vs_mimps.py``; the faithful LBL
version is ``studies.table4_lbl``).

    PYTHONPATH=src python -m repro_torch.examples.train_selfnorm_vs_mimps \\
        [--device cpu]

``main`` returns the losses and the per-context absolute errors of both.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs import reduced_config
from ..configs.base import TrainConfig
from ..core.estimators import exact_log_z, mimps_ivf
from ..core.mips import build_ivf
from ..data import DataIterator, SyntheticCorpus
from ..models import Model
from ..train import init_train_state, make_train_step


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="repro_torch.examples.train_selfnorm_vs_mimps")
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--block-rows", type=int, default=128)
    ap.add_argument("--probes", type=int, default=8)
    ap.add_argument("--l", type=int, default=256, help="tail samples")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(reduced_config("qwen1.5-4b"), vocab=args.vocab)
    model = Model(cfg)
    tc = TrainConfig(lr=2e-3, total_steps=args.steps, loss="selfnorm",
                     selfnorm_alpha=0.2,
                     warmup_steps=min(10, max(1, args.steps // 10)))
    state = init_train_state(model, tc, args.seed, dev)
    step = make_train_step(model, tc)
    it = DataIterator(SyntheticCorpus(vocab=cfg.vocab, seed=args.seed),
                      args.batch, args.seq)
    losses = []
    for i in range(args.steps):
        toks, labels = next(it)
        state, m = step(state, {"tokens": torch.from_numpy(toks).to(dev),
                                "labels": torch.from_numpy(labels).to(dev)})
        losses.append(float(m["loss_total"]))
        if i % 30 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.3f} "
                  f"mean logZ {float(m['mean_log_z']):+.3f}")

    # held-out evaluation: |Z_hat - Z| for MIMPS against the Z := 1 shortcut
    params = state.params
    toks, _ = next(it)
    with torch.no_grad():
        hidden, _ = model.forward(params, torch.from_numpy(toks).to(dev))
        h = hidden[:, -1].float()                 # (B, d) query contexts
        w = model.head_matrix(params).float()
        lz_true = exact_log_z(w, h)
        idx = build_ivf(w, block_rows=args.block_rows, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        lz_mips = mimps_ivf(idx, h, min(args.probes, idx.n_blocks), args.l,
                            torch.Generator(device=dev).manual_seed(2)).log_z
    z_true = np.exp(lz_true.double().cpu().numpy())
    z_mips = np.exp(lz_mips.double().cpu().numpy())
    abse_mips = np.abs(z_mips - z_true)
    abse_one = np.abs(1.0 - z_true)
    better = float(np.mean(abse_mips < abse_one))
    print(f"\nheld-out contexts ({h.shape[0]}):")
    print(f"  sum|Z_hat - Z|  MIMPS-IVF : {abse_mips.sum():9.3f}")
    print(f"  sum|1     - Z|  Z=1 heur. : {abse_one.sum():9.3f}")
    print(f"  MIMPS better on {100 * better:.1f}% of contexts (paper Table "
          f"4: 70.5% at k=l=100)")
    return {"losses": losses, "abs_err_mimps": abse_mips,
            "abs_err_one": abse_one, "better": better}


if __name__ == "__main__":
    main()
