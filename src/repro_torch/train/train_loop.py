"""Train-step factory (counterpart of ``repro.train.train_loop``):
gradient-accumulation microbatching, the loss registry, AdamW, and the
device-resident training counters.

The port runs eagerly: ``make_train_step`` returns a plain function that
takes gradients with ``torch.autograd.grad`` and updates the parameters in
place. The JAX key split becomes a ``torch.Generator`` carried in
``TrainState.rng`` and handed to the loss. Estimator-backed losses (their
IVF/LSH index in ``TrainState.index``, the index refresh) are not ported
yet (ROADMAP A12).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from .. import resolve_device
from ..configs.base import TrainConfig
from .losses import ESTIMATOR_LOSSES, get_loss
from .optimizer import OptState, adamw_update, init_opt_state, tree_leaves


class TrainState(NamedTuple):
    params: Any                 # the model's parameter dict (updated in place)
    opt: OptState
    rng: torch.Generator
    index: Any = None           # retrieval index of estimator-backed losses


class TrainMetricState(NamedTuple):
    """Device-resident training counters: accumulated on the device every
    step, read by the host only on its harvest cadence."""
    steps: torch.Tensor            # i32 scalar
    loss_sum: torch.Tensor         # f32 — running sum for the window mean
    loss_sq_sum: torch.Tensor      # f32 — running sum of squares (variance)
    loss_max: torch.Tensor         # f32
    grad_norm_sum: torch.Tensor    # f32
    grad_norm_max: torch.Tensor    # f32
    nonfinite: torch.Tensor        # i32 — steps whose loss was NaN/Inf


def init_train_metric_state(device="cuda") -> TrainMetricState:
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)
    return TrainMetricState(
        steps=i32(0), loss_sum=f32(0.0), loss_sq_sum=f32(0.0),
        loss_max=f32(-float("inf")), grad_norm_sum=f32(0.0),
        grad_norm_max=f32(0.0), nonfinite=i32(0))


def observe_train_step(tm: TrainMetricState,
                       metrics: Dict[str, Any]) -> TrainMetricState:
    """Fold one step's metrics into the counters without a host read.
    Non-finite losses are counted but left out of the running moments."""
    loss = metrics["loss_total"].float()
    gn = metrics.get("grad_norm", torch.zeros_like(loss)).float()
    ok = torch.isfinite(loss)
    safe = torch.where(ok, loss, torch.zeros_like(loss))
    return TrainMetricState(
        steps=tm.steps + 1,
        loss_sum=tm.loss_sum + safe,
        loss_sq_sum=tm.loss_sq_sum + safe * safe,
        loss_max=torch.maximum(tm.loss_max, torch.where(
            ok, loss, torch.full_like(loss, -float("inf")))),
        grad_norm_sum=tm.grad_norm_sum + gn,
        grad_norm_max=torch.maximum(tm.grad_norm_max, gn),
        nonfinite=tm.nonfinite + (~ok).to(torch.int32))


def harvest_train_metrics(tm: TrainMetricState) -> Dict[str, float]:
    """ONE host read of the counters, and the window statistics."""
    t = torch.stack([x.double() for x in tm]).tolist()
    c = TrainMetricState(*t)
    n = max(int(c.steps), 1)
    mean = c.loss_sum / n
    var = max(c.loss_sq_sum / n - mean * mean, 0.0)
    return {"steps": int(c.steps), "loss_mean": mean,
            "loss_std": var ** 0.5, "loss_max": c.loss_max,
            "grad_norm_mean": c.grad_norm_sum / n,
            "grad_norm_max": c.grad_norm_max,
            "nonfinite_steps": int(c.nonfinite)}


def init_train_state(model, train_cfg: TrainConfig, seed: int,
                     device="cuda") -> TrainState:
    """Seeded parameters (``Model.init`` from a generator seeded with
    ``seed``), zero f32 moments, and a training generator seeded with
    ``seed + 1``, all on ``device``."""
    if train_cfg.loss in ESTIMATOR_LOSSES:
        raise NotImplementedError(
            f"loss {train_cfg.loss!r} needs a retrieval index in TrainState, "
            f"which is not ported yet (ROADMAP A12)")
    dev = resolve_device(device)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    return TrainState(params=params, opt=init_opt_state(params),
                      rng=torch.Generator(device=dev).manual_seed(seed + 1))


def _batch_rows(batch: Dict[str, torch.Tensor], i: int, mb: int):
    """Microbatch ``i`` of ``mb``: rows i, i + mb, ... — the rows the JAX
    package's (B/mb, mb) reshape and swap give microbatch i."""
    return {k: v[i::mb] for k, v in batch.items()}


def make_train_step(model, train_cfg: TrainConfig, *, backend: str = "xla"):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` (B, S) on the parameters'
    device. ``microbatches > 1`` takes the gradient of each microbatch in
    turn and averages them in f32. ``backend`` is passed to the streaming
    losses for the JAX signature; the device picks the kernels."""
    loss_name = train_cfg.loss
    if loss_name in ESTIMATOR_LOSSES:
        raise NotImplementedError(
            f"loss {loss_name!r} is not ported yet (ROADMAP A12)")
    loss_fn = get_loss(loss_name)
    kwargs = {"backend": backend} if loss_name in ("fused_ce",
                                                    "selfnorm") else {}

    def grads_of(params, leaves, batch, gen):
        loss, metrics = loss_fn(model, params, batch, gen, train_cfg,
                                **kwargs)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        mb = train_cfg.microbatches
        if mb <= 1:
            loss, metrics, grads = grads_of(state.params, leaves, batch,
                                            state.rng)
        else:
            grads, loss = None, 0.0
            for i in range(mb):
                l_i, metrics, g = grads_of(state.params, leaves,
                                           _batch_rows(batch, i, mb),
                                           state.rng)
                if grads is None:
                    grads = [x.float() for x in g]
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x)
                loss = loss + l_i
            for acc in grads:
                acc.div_(mb)
            loss = loss / mb
        params, opt, opt_metrics = adamw_update(
            train_cfg, state.params, grads, state.opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss_total"] = loss
        return TrainState(params=params, opt=opt, rng=state.rng,
                          index=state.index), metrics

    return train_step
