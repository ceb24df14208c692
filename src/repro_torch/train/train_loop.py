"""Train-step factory (counterpart of ``repro.train.train_loop``):
gradient-accumulation microbatching, the loss registry, AdamW, and the
device-resident training counters.

The port runs eagerly: ``make_train_step`` returns a plain function that
takes gradients with ``torch.autograd.grad`` and updates the parameters in
place. The JAX key split becomes a ``torch.Generator`` carried in
``TrainState.rng`` and handed to the loss.

Estimator-backed losses (``losses.ESTIMATOR_LOSSES``) carry their
retrieval index in ``TrainState.index``: ``init_train_state`` builds it
from the initial output embedding (an ``IVFIndex`` through
``mips.build_ivf_device`` for mimps_ce/mince_ce, an ``LSHIndex`` through
``lsh.build_lsh_device`` for lsh_ce), every loss call plans through it,
and ``make_index_refresh`` re-clusters (or re-hashes) it from the current
embedding into tensors of the same shapes and dtypes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..configs.base import ModelConfig, TrainConfig
from ..core import lsh as _lsh
from ..core import mips as _mips
from .losses import DRAW_ARGS, ESTIMATOR_LOSSES, get_loss
from .optimizer import OptState, adamw_update, init_opt_state, tree_leaves

# added to the seed of init_train_state for the index build's generator
# (the JAX package folds 0x1DF into its key)
INDEX_SEED_OFFSET = 0x1DF


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


def make_instrumented_step(step_fn):
    """Wrap a ``train_step`` so it also folds a ``TrainMetricState``:
    ``(state, tm, batch) -> (state, tm, metrics)``."""
    def inst_step(state: TrainState, tm: TrainMetricState,
                  batch: Dict[str, torch.Tensor]):
        state, metrics = step_fn(state, batch)
        return state, observe_train_step(tm, metrics), metrics
    return inst_step


def _resolve_n_clusters(cfg: ModelConfig) -> int:
    pc = cfg.partition
    if pc.n_clusters > 0:
        return pc.n_clusters
    return max(1, cfg.vocab // (4 * pc.block_rows))


def init_train_state(model, train_cfg: TrainConfig, seed: int,
                     device="cuda") -> TrainState:
    """Seeded parameters (``Model.init`` from a generator seeded with
    ``seed``), zero f32 moments, and a training generator seeded with
    ``seed + 1``, all on ``device``. An estimator-backed loss also gets
    its index of the initial head matrix, drawn from a generator seeded
    with ``seed + INDEX_SEED_OFFSET`` (0x1DF): an ``LSHIndex`` (its
    hyperplanes) for lsh_ce, else the fixed-capacity ``IVFIndex`` (its
    k-means seeding)."""
    dev = resolve_device(device)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    index = None
    if train_cfg.loss in ESTIMATOR_LOSSES:
        if model.cfg.n_codebooks:
            raise NotImplementedError(
                "estimator-backed losses serve single-stream heads")
        pc = model.cfg.partition
        gen = torch.Generator(device=dev).manual_seed(seed + INDEX_SEED_OFFSET)
        w = model.head_matrix(params)
        if train_cfg.loss == "lsh_ce":
            index = _lsh.build_lsh_device(
                w, n_bits=pc.lsh_bits, n_tables=pc.lsh_tables,
                bucket_cap=pc.lsh_bucket_cap, mips_scale=pc.lsh_mips_scale,
                tail_beta=pc.lsh_tail_beta, generator=gen, device=dev)
        else:
            index = _mips.build_ivf_device(
                w, block_rows=pc.block_rows,
                n_clusters=_resolve_n_clusters(model.cfg), generator=gen,
                device=dev)
    return TrainState(params=params, opt=init_opt_state(params),
                      rng=torch.Generator(device=dev).manual_seed(seed + 1),
                      index=index)


def _layout(index):
    return [(f, tuple(t.shape), t.dtype) if torch.is_tensor(t) else (f, t)
            for f, t in zip(index._fields, index)]


def make_index_refresh(model, train_cfg: TrainConfig):
    """``refresh(state) -> (state, {"churn", "drift"})``: re-cluster and
    repack the IVF index from the current head matrix (``refresh_ivf``,
    warm-started from the index's assignment,
    ``train_cfg.index_refresh_kmeans_iters`` Lloyd steps), or for lsh_ce
    re-hash it keeping the hyperplanes (``rehash_lsh``). Every index
    tensor keeps its shape and dtype; a refresh that would change one
    raises and leaves the state as it was."""
    n_clusters = _resolve_n_clusters(model.cfg)
    iters = train_cfg.index_refresh_kmeans_iters
    lsh = train_cfg.loss == "lsh_ce"

    def refresh(state: TrainState):
        with torch.no_grad():
            w = model.head_matrix(state.params).detach()
            if lsh:
                new, metrics = _lsh.rehash_lsh(state.index, w)
            else:
                new, metrics = _mips.refresh_ivf(
                    state.index, w, n_clusters=n_clusters,
                    kmeans_iters=iters)
        if _layout(new) != _layout(state.index):
            raise RuntimeError(
                f"index refresh changed the index layout: "
                f"{_layout(state.index)} -> {_layout(new)}")
        return state._replace(index=new), metrics

    return refresh


def _batch_rows(batch: Dict[str, torch.Tensor], i: int, mb: int):
    """Microbatch ``i`` of ``mb``: rows i, i + mb, ... — the rows the JAX
    package's (B/mb, mb) reshape and swap give microbatch i."""
    return {k: v[i::mb] for k, v in batch.items()}


def make_train_step(model, train_cfg: TrainConfig, *, backend: str = "xla",
                    draw_source: Optional[Callable[[int, int], Any]] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` (B, S), or (B, S, C) for an
    audio model (``DataIterator(n_codebooks=C)``), on the parameters'
    device. ``microbatches > 1`` takes the gradient of each microbatch in
    turn and averages them in f32. ``backend`` is passed to the streaming
    losses for the JAX signature; the device picks the kernels. The
    estimator-backed losses get ``index=state.index``.

    The sampled losses draw from ``state.rng``, or, given
    ``draw_source(step, microbatch)``, take its return value as their draw
    (``losses.DRAW_ARGS`` names the argument: noise words or tail ids), so
    a test can replay the JAX package's draws; ``step`` is the optimizer's
    step count before the update."""
    loss_name = train_cfg.loss
    loss_fn = get_loss(loss_name)
    est_loss = loss_name in ESTIMATOR_LOSSES
    kwargs = {"backend": backend} if loss_name in ("fused_ce",
                                                    "selfnorm") else {}
    if draw_source is not None and loss_name not in DRAW_ARGS:
        raise ValueError(f"loss {loss_name!r} draws nothing to inject")

    def grads_of(params, leaves, batch, gen, index, draws):
        kw = dict(kwargs)
        if est_loss:
            kw["index"] = index
        if draws is not None:
            kw[DRAW_ARGS[loss_name]] = draws
        loss, metrics = loss_fn(model, params, batch, gen, train_cfg, **kw)
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

        def draws(i):
            return None if draw_source is None else draw_source(
                state.opt.step, i)
        if mb <= 1:
            loss, metrics, grads = grads_of(state.params, leaves, batch,
                                            state.rng, state.index, draws(0))
        else:
            grads, loss = None, 0.0
            for i in range(mb):
                l_i, metrics, g = grads_of(state.params, leaves,
                                           _batch_rows(batch, i, mb),
                                           state.rng, state.index, draws(i))
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
