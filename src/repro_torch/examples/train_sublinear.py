"""Sublinear-training quickstart: train with the estimator in the gradient,
then swap the checkpoint into a live traffic server (counterpart of
``examples/train_sublinear.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_sublinear \\
        [--device cpu]

1. Train a reduced model with ``mimps_ce``: every step's log Z and its
   gradient come from the IVF probe-union head and a uniform tail, so the
   forward's floats and the embedding gradient's rows are sublinear in the
   vocabulary. The index rides in ``TrainState`` and is refreshed
   (recluster and repack, every shape kept) as the embedding drifts.
2. Checkpoint, restore, and ``Engine.swap_index`` the trained params into
   a live server built on the initial params: the fixed-capacity index
   keeps every shape, so the next step serves the new model (on a GPU the
   step is captured once again: the graph read the old tensors).
``main`` returns the losses, the served tokens and the parity check.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional, Sequence

import torch

from .. import resolve_device
from ..configs import reduced_config
from ..configs.base import TrainConfig
from ..data import DataIterator, SyntheticCorpus
from ..models import Model
from ..serve import Engine, Request, Scheduler, Server, generate
from ..train import (CheckpointManager, init_train_state, make_index_refresh,
                     make_train_step)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.train_sublinear")
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--refresh-every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # -- model: mimps at the output layer for training and serving ---------
    cfg = reduced_config("qwen1.5-4b")
    cfg = dataclasses.replace(
        cfg, vocab=args.vocab, partition=dataclasses.replace(
            cfg.partition, method="mimps", block_rows=64, n_probe=4, l=128,
            n_clusters=16))
    model = Model(cfg)
    tc = TrainConfig(lr=1e-3, loss="mimps_ce", total_steps=args.steps,
                     index_refresh_every=args.refresh_every,
                     warmup_steps=max(1, args.steps // 10))

    # -- 1. train: estimator-backed CE, the index refreshed on a cadence ---
    print("== training with mimps_ce (sublinear forward and backward) ==")
    state = init_train_state(model, tc, args.seed, dev)
    print(f"   index: {state.index.n_blocks} blocks x "
          f"{state.index.v_blocks.shape[1]} rows (on the device, in "
          f"TrainState)")
    step = make_train_step(model, tc)
    refresh = make_index_refresh(model, tc)
    it = DataIterator(SyntheticCorpus(vocab=cfg.vocab, seed=args.seed),
                      args.batch, args.seq)
    losses = []
    for i in range(tc.total_steps):
        toks, labels = next(it)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        if i and i % tc.index_refresh_every == 0:
            state, rm = refresh(state)
            print(f"   step {i:3d}: index refresh, churn "
                  f"{float(rm['churn']):.3f}, drift {float(rm['drift']):.3f}")
        state, met = step(state, batch)
        losses.append(float(met["loss_total"]))
        if i % 10 == 0 or i == tc.total_steps - 1:
            print(f"   step {i:3d}: loss {losses[-1]:.4f} (head hit-rate "
                  f"{float(met['head_hit_rate']):.2f})")

    # -- checkpoint round trip (the index tensors ride along) --------------
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="sublinear_ckpt_")
    mgr = CheckpointManager(ckpt_dir, async_write=False)
    mgr.save(tc.total_steps, state)
    restored, _ = mgr.restore(None, like=state)
    print(f"== checkpoint saved and restored from {ckpt_dir} ==")

    # -- 2. serve: a live server on the initial params, then the swap ------
    p_init = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dev)
    engine = Engine(model, p_init, max_len=32, seed=args.seed, device=dev,
                    device_index=True)   # fixed-capacity index: swappable
    server = Server(Scheduler(engine, n_slots=4, seed=args.seed + 1))

    def serve_round(tag):
        reqs = [Request(prompt=[7 + i, 11, 13], max_new_tokens=5,
                        seed=100 + i) for i in range(3)]
        for r in reqs:
            server.submit(r)
        done = {c.request.req_id: c.tokens for c in server.run().completions}
        for r in reqs:
            print(f"   [{tag}] req {r.req_id}: {done[r.req_id]}")
        return [done[r.req_id] for r in reqs]

    print("== serving with the initial params ==")
    before = serve_round("init")
    captures = server.scheduler.captures
    print("== swap_index(trained checkpoint) into the live server ==")
    engine.swap_index(restored.params)
    after = serve_round("trained")
    print(f"   captures across the swap: {captures} -> "
          f"{server.scheduler.captures} (a GPU step is captured once again: "
          f"its graph read the old tensors)")

    # parity: a fresh engine built from the trained params gives the same
    # tokens
    eng2 = Engine(model, restored.params, max_len=32, seed=args.seed,
                  device=dev, device_index=True)
    solo = generate(eng2, torch.tensor([[7, 11, 13]], device=dev), 5,
                    generator=torch.Generator(device=dev).manual_seed(100))
    match = solo[0].tolist() == after[0]
    print(f"   swapped-server tokens == fresh-engine generate(): {match}")
    return {"losses": losses, "before": before, "after": after,
            "match": match}


if __name__ == "__main__":
    main()
