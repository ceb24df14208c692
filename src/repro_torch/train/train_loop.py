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

Under a mesh (``launch.mesh``; ``init_train_state(mesh=)``,
``make_train_step(mesh=)``) each rank stores the slice of each parameter
leaf that ``param_spec`` gives its ``model`` coordinate, with its AdamW
moments. A step gathers the whole leaves over ``model`` exactly (bit
patterns), runs the one-device loss, autograd and kernels on the rank's
rows of the batch (contiguous rows over the data axes, as the JAX
package's ``batch_shardings``; the ranks of one replica compute the same
rows), averages the gradients over the data axes in f32 (the gradient of
the global batch's mean loss) or, over ``pod_axis``, sums them through
``compress_psum``, clips by the norm of the whole gradient and updates the
rank's slices. AdamW is elementwise, so at data 1 the slices equal the
one-device step's bit for bit. The compute is not split over ``model``:
a rank holds whole parameters and gradients during the step.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..configs.base import ModelConfig, TrainConfig
from ..core import lsh as _lsh
from ..core import mips as _mips
from ..launch import mesh as _mesh
from .compression import compress_psum
from .losses import DRAW_ARGS, ESTIMATOR_LOSSES, get_loss
from .optimizer import (OptState, adamw_update, global_norm, init_opt_state,
                        tree_leaves)

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


def params_placements(model, mesh):
    """The placement of every parameter leaf on ``mesh``
    (``launch.mesh.params_shardings`` of the whole leaves' shapes, from a
    ``meta`` init)."""
    return _mesh.params_shardings(mesh, model.init(torch.Generator(),
                                                   "meta"))


def state_shardings(model, mesh) -> TrainState:
    """The placements of a sharded ``TrainState``'s tensors, in its
    structure (the parameters' for the parameters and both moments; the
    step, generator and index whole), for ``CheckpointManager``."""
    ps = params_placements(model, mesh)
    return TrainState(params=ps, opt=OptState(step=None, m=ps, v=ps),
                      rng=None, index=None)


def init_train_state(model, train_cfg: TrainConfig, seed: int,
                     device="cuda", *, mesh=None) -> TrainState:
    """Seeded parameters (``Model.init`` from a generator seeded with
    ``seed``), zero f32 moments, and a training generator seeded with
    ``seed + 1``, all on ``device``. An estimator-backed loss also gets
    its index of the initial head matrix, drawn from a generator seeded
    with ``seed + INDEX_SEED_OFFSET`` (0x1DF): an ``LSHIndex`` (its
    hyperplanes) for lsh_ce, else the fixed-capacity ``IVFIndex`` (its
    k-means seeding). With ``mesh`` every rank draws the same whole state
    and keeps its slices of the parameters (``params_placements``) and
    moments of their shapes; the generator and the index stay whole."""
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
    if mesh is not None:
        params = _mesh.shard_tree(params, params_placements(model, mesh))
    return TrainState(params=params, opt=init_opt_state(params),
                      rng=torch.Generator(device=dev).manual_seed(seed + 1),
                      index=index)


def _layout(index):
    return [(f, tuple(t.shape), t.dtype) if torch.is_tensor(t) else (f, t)
            for f, t in zip(index._fields, index)]


def make_index_refresh(model, train_cfg: TrainConfig, *, mesh=None):
    """``refresh(state) -> (state, {"churn", "drift"})``: re-cluster and
    repack the IVF index from the current head matrix (``refresh_ivf``,
    warm-started from the index's assignment,
    ``train_cfg.index_refresh_kmeans_iters`` Lloyd steps), or for lsh_ce
    re-hash it keeping the hyperplanes (``rehash_lsh``). Every index
    tensor keeps its shape and dtype; a refresh that would change one
    raises and leaves the state as it was. With ``mesh`` the state is
    sharded and every rank gathers the whole head first."""
    n_clusters = _resolve_n_clusters(model.cfg)
    iters = train_cfg.index_refresh_kmeans_iters
    lsh = train_cfg.loss == "lsh_ce"
    placements = None if mesh is None else params_placements(model, mesh)

    def head(params):
        if placements is None:
            return model.head_matrix(params)
        keys = [k for k in ("embed", "lm_head") if k in params]
        return model.head_matrix(_mesh.gather_tree(
            {k: params[k] for k in keys}, {k: placements[k] for k in keys}))

    def refresh(state: TrainState):
        with torch.no_grad():
            w = head(state.params).detach()
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
                    draw_source: Optional[Callable[[int, int], Any]] = None,
                    mesh=None, pod_axis: Optional[str] = None):
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
    step count before the update.

    ``mesh`` takes the state of ``init_train_state(mesh=)`` and the whole
    batch on every rank (see the module's notes). Where the batch splits
    over the data axes, nce and sampled draw each microbatch's noise whole
    (from ``state.rng`` or ``draw_source``), as one device does, and keep
    the rank's rows, and the loss and the scalar metrics are averaged over
    the data axes. ``pod_axis`` names a mesh dim whose gradients are
    summed through ``compress_psum`` (``train_cfg.grad_compression``); the
    other data axes are averaged first. The estimator-backed losses plan
    one head union and one tail over the whole batch, so they refuse a
    mesh whose data axes hold more than one rank."""
    loss_name = train_cfg.loss
    loss_fn = get_loss(loss_name)
    est_loss = loss_name in ESTIMATOR_LOSSES
    kwargs = {"backend": backend} if loss_name in ("fused_ce",
                                                    "selfnorm") else {}
    if draw_source is not None and loss_name not in DRAW_ARGS:
        raise ValueError(f"loss {loss_name!r} draws nothing to inject")
    if pod_axis is not None and (
            mesh is None or pod_axis not in mesh.mesh_dim_names):
        raise ValueError(f"pod_axis {pod_axis!r} is not a dim of the mesh")

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

    def loss_and_grads(params, batch, gen, index, draws):
        """The one-device body: (loss, metrics, gradient leaves), the
        microbatches' averaged in f32; ``draws(i)`` is microbatch i's
        injected draw or None."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        mb = train_cfg.microbatches
        if mb <= 1:
            return grads_of(params, leaves, batch, gen, index, draws(0))
        grads, loss = None, 0.0
        for i in range(mb):
            l_i, metrics, g = grads_of(params, leaves,
                                       _batch_rows(batch, i, mb), gen, index,
                                       draws(i))
            if grads is None:
                grads = [x.float() for x in g]
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x)
            loss = loss + l_i
        for acc in grads:
            acc.div_(mb)
        return loss / mb, metrics, grads

    def injected(state):
        def draws(i):
            return None if draw_source is None else draw_source(
                state.opt.step, i)
        return draws

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        loss, metrics, grads = loss_and_grads(state.params, batch, state.rng,
                                              state.index, injected(state))
        params, opt, opt_metrics = adamw_update(
            train_cfg, state.params, grads, state.opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss_total"] = loss
        return TrainState(params=params, opt=opt, rng=state.rng,
                          index=state.index), metrics

    if mesh is None:
        return train_step
    if est_loss and _mesh.data_size(mesh) > 1:
        raise NotImplementedError(
            f"{loss_name} plans one head union and one tail over the whole "
            f"batch; at data {_mesh.data_size(mesh)} each rank holds only "
            f"its rows, and gathering the hidden states over 'data' is not "
            f"ported: train it at data 1")
    placement_tree = params_placements(model, mesh)
    d_axes = _mesh.data_axes(mesh)
    mean_axes = [a for a in d_axes if a != pod_axis]
    sampled = loss_name in ("nce", "sampled")
    n_head = model.cfg.vocab * max(model.cfg.n_codebooks, 1)

    def coord():
        """This rank's replica: its coordinate over the data axes."""
        c = 0
        for a in d_axes:
            c = c * _mesh.axis_size(mesh, a) + _mesh.axis_rank(mesh, a)
        return c

    def sum_over(t, axes):
        for a in axes:
            torch.distributed.all_reduce(t, group=_mesh.axis_group(mesh, a))
        return t

    def sharded_step(state: TrainState, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[TrainState, Dict[str, Any]]:
        n = batch["tokens"].shape[0]
        split = (_mesh.batch_axis_for(mesh, n) is not None
                 and _mesh.data_size(mesh) > 1)
        draws = injected(state)
        if split:
            d, mb = _mesh.data_size(mesh), max(train_cfg.microbatches, 1)
            if n % (d * mb):
                raise ValueError(f"batch {n} does not split into {mb} "
                                 f"microbatches on each of {d} replicas")
            rows = _mesh.shard_tree(batch, _mesh.batch_shardings(mesh,
                                                                 batch, n))
            if sampled:
                whole, c = draws, coord()

                def draws(i):
                    # microbatch i's draw over its whole rows, as one
                    # device draws it; the rank's rows are block c of it
                    t = batch["labels"].numel() // mb
                    got = whole(i)
                    if got is None:
                        got = torch.randint(
                            0, n_head, (t, train_cfg.nce_noise),
                            generator=state.rng,
                            device=batch["labels"].device)
                    got = torch.as_tensor(got)
                    return got[c * (t // d):(c + 1) * (t // d)]
        else:
            rows = batch
        full = _mesh.gather_tree(state.params, placement_tree)
        loss, metrics, grads = loss_and_grads(full, rows, state.rng,
                                              state.index, draws)
        del full
        if split and mean_axes:
            k = math.prod(_mesh.axis_size(mesh, a) for a in mean_axes)
            grads = [sum_over(g.float(), mean_axes).div_(k) for g in grads]
        if pod_axis is not None:
            grads = compress_psum(grads, _mesh.axis_group(mesh, pod_axis),
                                  mode=train_cfg.grad_compression)
        gnorm = global_norm(grads)
        local = [_mesh.local_view(g, p) for g, p in zip(
            grads, _mesh.placements_like(state.params, placement_tree))]
        params, opt, opt_metrics = adamw_update(
            train_cfg, state.params, local, state.opt, gnorm=gnorm)
        metrics = dict(metrics)
        metrics["loss_total"] = loss
        if split:
            keys = [k for k, v in metrics.items() if torch.is_tensor(v)
                    and v.dim() == 0 and v.is_floating_point()]
            vals = sum_over(torch.stack([metrics[k].float() for k in keys]),
                            d_axes) / _mesh.data_size(mesh)
            metrics.update(zip(keys, vals.unbind()))
        metrics.update(opt_metrics)
        return TrainState(params=params, opt=opt, rng=state.rng,
                          index=state.index), metrics

    return sharded_step
