"""The training entry point (counterpart of ``repro.launch.train``): the
elastic mesh, checkpoints with auto-resume, the straggler watchdog and the
deterministic, resumable synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

On one process it trains on one device (``--device``, ``cuda`` by
default). Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank runs this
same script: it initialises the default process group (NCCL on ``cuda``,
gloo on ``cpu``; ``--dist-backend gloo`` for several ranks on one card)
and trains over ``make_elastic_mesh(--model-parallel)``: K x M ranks
with ``--model-parallel M`` make the (K, M) mesh. Each rank holds its
slices of the state and computes on them (``train.train_loop``: attention
heads, MLP columns, experts and vocab rows split over 'model'; RWKV6,
Mamba2 and the VLM's cross blocks gathered whole). A restart with fewer
ranks restores the same checkpoint onto the smaller mesh.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
        --reduced --steps 20 --model-parallel 2 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import torch

from .. import resolve_device
from ..configs import get_config, reduced_config
from ..configs.base import TrainConfig
from ..data import DataIterator, DataState, SyntheticCorpus
from ..models import Model
from ..models.transformer import torch_dtype
from ..train import (CheckpointManager, StragglerWatchdog,
                     harvest_train_metrics, init_train_metric_state,
                     init_train_state, make_elastic_mesh, make_index_refresh,
                     make_instrumented_step, make_train_step,
                     state_shardings)
from ..train.checkpoint import config_fingerprint
from ..train.losses import ESTIMATOR_LOSSES, LOSSES


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="laptop-scale config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    # choices from the registry, so a typo fails at parse time
    ap.add_argument("--loss", default="fused_ce", choices=sorted(LOSSES))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--index-refresh-every", type=int, default=100,
                    help="steps between index refreshes (estimator-backed "
                         "losses only; the index keeps its shapes; 0 "
                         "disables refreshes)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--harvest-every", type=int, default=10,
                    help="steps between device->host metric reads; the "
                         "loop synchronises only on this cadence (the "
                         "device counters accumulate loss and gradient "
                         "statistics in between)")
    ap.add_argument("--metrics-snapshot", default="", metavar="PATH",
                    help="write the harvested train metrics as JSON to "
                         "PATH at the end of the run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", default="", choices=("", "nccl",
                                                           "gloo"),
                    help="the process group's backend under torchrun "
                         "(default: nccl on cuda, gloo on cpu; gloo for "
                         "several ranks on one card)")
    return ap.parse_args(argv)


def _init_group(args) -> bool:
    """Initialise the default process group under ``torchrun``; returns
    whether this call did (and so must destroy it)."""
    import torch.distributed as dist
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return False
    cuda = torch.device(args.device).type == "cuda"
    backend = args.dist_backend or ("nccl" if cuda else "gloo")
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://")
    return True


def _device(args) -> torch.device:
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Train as the flags say; returns the harvested train metrics. Under
    an initialised default group (``torchrun``, or a caller's) every rank
    calls it."""
    import torch.distributed as dist
    args = parse_args(argv)
    owns_group = _init_group(args)
    try:
        return _train(args)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args) -> Dict[str, float]:
    import torch.distributed as dist
    dev = _device(args)
    rank = dist.get_rank() if dist.is_initialized() else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg)
    tc = TrainConfig(lr=args.lr, total_steps=args.steps, loss=args.loss,
                     microbatches=args.microbatches, seed=args.seed,
                     warmup_steps=max(1, args.steps // 10),
                     index_refresh_every=args.index_refresh_every)
    mesh = shardings = None
    shape = {"data": 1, "model": 1}
    if dist.is_initialized():
        mesh = make_elastic_mesh(model_parallel=args.model_parallel,
                                 device_type=dev.type)
        shape = {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
        shardings = state_shardings(model, mesh)
    say(f"mesh: {shape}  arch: {cfg.name}  "
        f"params: {cfg.param_count() / 1e6:.1f}M")

    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=args.seed)
    it = DataIterator(corpus, args.batch, args.seq,
                      n_codebooks=cfg.n_codebooks)
    state = init_train_state(model, tc, args.seed, dev, mesh=mesh)
    fingerprint = config_fingerprint(cfg)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        latest = mgr.latest_step()
        if latest is not None:
            state, manifest = mgr.restore(latest, like=state,
                                          config=fingerprint,
                                          shardings=shardings)
            start_step = manifest["step"]
            it.state = DataState.from_dict(manifest["data"] or
                                           {"step": start_step})
            say(f"resumed from step {start_step}")

    step_fn = make_instrumented_step(make_train_step(model, tc, mesh=mesh))
    refresh_fn = make_index_refresh(model, tc, mesh=mesh) \
        if tc.loss in ESTIMATOR_LOSSES and tc.index_refresh_every > 0 \
        else None
    wd = StragglerWatchdog()
    tm = init_train_metric_state(dev)
    sync_every = max(args.harvest_every, 1)

    def save(step):
        mgr.save(step, state, config=fingerprint,
                 data_state=it.state.to_dict(), shardings=shardings)

    for step in range(start_step, args.steps):
        toks, labels = next(it)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        if cfg.family == "vlm":
            batch["img"] = torch.zeros(
                (args.batch, cfg.n_image_tokens, cfg.d_model),
                dtype=torch_dtype(cfg.dtype), device=dev)
        wd.start_step()
        # the cadence keys on the GLOBAL step (not the resume offset), so a
        # resumed run refreshes at the steps an uninterrupted one does
        refreshed = ""
        if refresh_fn is not None and step > 0 and \
                step % tc.index_refresh_every == 0:
            state, rm = refresh_fn(state)
            refreshed = (f" [refresh churn {float(rm['churn']):.3f}"
                         f" drift {float(rm['drift']):.3f}]")
        state, tm, metrics = step_fn(state, tm, batch)
        # synchronise with the device only on the harvest/log cadence;
        # between, the device counters carry the per-step statistics
        log_now = (step % 10 == 0 or step == args.steps - 1
                   or bool(refreshed))
        if (log_now or (step + 1) % sync_every == 0) and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        slow = wd.end_step(step)
        if log_now:
            say(f"step {step:5d} loss {float(metrics['loss_total']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e}"
                + (" [straggler]" if slow else "") + refreshed)
        if mgr and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    th = harvest_train_metrics(tm)
    say(f"train metrics: loss mean {th['loss_mean']:.4f} "
        f"std {th['loss_std']:.4f} max {th['loss_max']:.4f}  "
        f"gnorm mean {th['grad_norm_mean']:.3f} "
        f"max {th['grad_norm_max']:.3f}  "
        f"nonfinite steps {th['nonfinite_steps']}/{th['steps']}")
    if args.metrics_snapshot and rank == 0:
        with open(args.metrics_snapshot, "w", encoding="utf-8") as fh:
            json.dump(th, fh, indent=1)
        say(f"train metrics snapshot: {args.metrics_snapshot}")
    if mgr:
        save(args.steps)
        mgr.wait()
        say(f"final checkpoint at {args.ckpt_dir}")
    return th


if __name__ == "__main__":
    main()
