"""AdamW + cosine schedule + global-norm clipping (counterpart of
``repro.train.optimizer``), not ``torch.optim.AdamW``, whose decay and
update are ordered differently.

Optimizer state is kept in f32 regardless of the (bf16) parameter dtype;
update math runs in f32 and casts back. Unlike the JAX package, the
parameters and moments are updated in place, leaf by leaf, so that the
update's f32 temporaries never exceed two of the largest leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..configs.base import TrainConfig


class OptState(NamedTuple):
    step: int          # updates taken (a host int: no device read per step)
    m: Any             # f32 first moments, the parameters' tree
    v: Any             # f32 second moments


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in insertion order."""
    out = []
    for value in tree.values():
        if isinstance(value, dict):
            out.extend(tree_leaves(value))
        else:
            out.append(value)
    return out


def _leaves_of(tree_or_leaves) -> List[torch.Tensor]:
    if isinstance(tree_or_leaves, dict):
        return tree_leaves(tree_or_leaves)
    return list(tree_or_leaves)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(step=0, m=tree_map(zeros, params),
                    v=tree_map(zeros, params))


def lr_schedule(cfg: TrainConfig, step: int) -> float:
    warm = min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
    prog = min(max((step - cfg.warmup_steps) /
                   max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


# elements of each f32 partial sum of squares in ``global_norm``
_NORM_CHUNK = 4096


def _sq_norm(g: torch.Tensor) -> torch.Tensor:
    """Sum of squares of g in float64, from f32 norms of rows of
    _NORM_CHUNK elements (one read of g, no float64 copy of it)."""
    flat = g.reshape(-1)
    m = flat.numel() - flat.numel() % _NORM_CHUNK
    sq = torch.linalg.vector_norm(flat[:m].view(-1, _NORM_CHUNK), dim=-1,
                                  dtype=torch.float32).double().square().sum()
    if m < flat.numel():
        sq = sq + torch.linalg.vector_norm(
            flat[m:], dtype=torch.float32).double().square()
    return sq


def leaf_squares(tree) -> List[torch.Tensor]:
    """Each leaf's sum of squares (``_sq_norm``), in leaf order."""
    return [_sq_norm(g) for g in _leaves_of(tree)]


def norm_of_squares(squares: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of the leaves' sums of squares, in f32."""
    return torch.sqrt(torch.stack(list(squares)).sum()).float()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (a tree, or its leaves),
    returned in f32. Each leaf is summed in chunks (``_sq_norm``): one
    f32 ``vector_norm`` of a whole leaf on the CPU was 1.6e-5 off on an
    estimator loss's gradient and 4e-4 off on a dense (4096, 2560) one,
    where the JAX package's f32 sum is exact to about 1e-7."""
    return norm_of_squares(leaf_squares(tree))


@torch.no_grad()
def adamw_update(cfg: TrainConfig, params, grads, state: OptState, *,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step with the JAX package's arithmetic: clip by the global
    norm, bias-corrected moments, ``delta = m_hat / (sqrt(v_hat) + 1e-8) +
    wd * p``, ``p - lr * delta`` cast back to p's dtype. ``grads`` is the
    parameters' tree or its leaves in tree order. ``params`` and the
    moments are updated in place and returned. ``gnorm`` is the global
    norm to clip by where ``grads`` are slices of the gradient (the
    sharded step passes the whole gradient's); by default, ``grads``'."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    lr = lr_schedule(cfg, state.step)
    for p, g, m, v in zip(tree_leaves(params), _leaves_of(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g32 = g.float() * scale
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        torch.div(v, bc2, out=g32).sqrt_().add_(1e-8)     # sqrt(v_hat) + eps
        delta = torch.div(m, bc1).div_(g32)
        del g32
        p32 = p.float()
        delta.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32.sub_(delta, alpha=lr))
    return params, OptState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
