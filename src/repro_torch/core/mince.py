"""MINCE: Z as the parameter of an NCE objective (paper SS4.2; counterpart
of ``repro.core.mince``).

Paper Eq. 7, negated to be minimised, in theta = log Z (strictly convex):

    f(theta)  = sum_i softplus(theta - alpha_i) + sum_j softplus(beta_j - theta)
    f'(theta) = sum_i sigma(theta - alpha_i) - sum_j sigma(beta_j - theta)

f', f'' and f''' are elementwise sigmoid products, which is what makes
Halley's method (cubic) as cheap as Newton's.

Every function is rank-polymorphic over leading batch axes, as in the JAX
package: ``alpha (..., A)``, ``beta (..., B)``, ``theta (...,)``, sums over
the trailing axis. Each ``lax.scan`` of the JAX module is a Python loop of
the same fixed length with no early exit, so every iterate is the JAX
one's. softplus is ``logaddexp(x, 0)``: ``torch.nn.functional.softplus``
turns into the identity above its threshold, where ``jax.nn.softplus`` does
not.

``anchored_atoms``/``solve_shared_atoms`` are the score-once form (data and
noise on one atom set, one sigmoid pass an iteration); ``mince_stats``
compresses weighted atoms into fixed-size histograms for a combine across
shards, and ``solve_from_stats`` solves on them inside a maintained bracket.
``anchored_solve`` is the scalar iteration the anchored equation reduces to
(its root is the Eq. 5 anchor: the collapse identity, documented in the JAX
module).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def nce_objective(theta: torch.Tensor, alpha: torch.Tensor,
                  beta: torch.Tensor, alpha_mask=None,
                  beta_mask=None) -> torch.Tensor:
    """-J(log Z = theta): alpha = log a_i (..., A), beta = log b_j (..., B),
    theta (...,) -> (...,). Masks (shaped like alpha/beta) drop samples."""
    ta = _softplus(theta[..., None] - alpha)
    tb = _softplus(beta - theta[..., None])
    if alpha_mask is not None:
        ta = ta * alpha_mask
    if beta_mask is not None:
        tb = tb * beta_mask
    return ta.sum(-1) + tb.sum(-1)


def derivative_sums(theta, alpha, beta, alpha_mask=None, beta_mask=None):
    """(f', f'', f''') of the NCE objective summed over the sample axis:
    theta (...,), alpha (..., A), beta (..., B) -> three (...,) tensors.
    Plain sums over samples, so disjoint slices of the sample sets add."""
    sa = torch.sigmoid(theta[..., None] - alpha)
    sb = torch.sigmoid(beta - theta[..., None])
    if alpha_mask is not None:
        sa = sa * alpha_mask
    if beta_mask is not None:
        sb = sb * beta_mask
    da = sa * (1.0 - sa)
    db = sb * (1.0 - sb)
    f1 = sa.sum(-1) - sb.sum(-1)
    f2 = da.sum(-1) + db.sum(-1)
    f3 = (da * (1.0 - 2.0 * sa)).sum(-1) - (db * (1.0 - 2.0 * sb)).sum(-1)
    return f1, f2, f3


def halley_step(f1, f2, f3, solver: str = "halley",
                max_step: float = 10.0, eps: float = 1e-12):
    """One step from the derivative sums, clipped to +-max_step. solver:
    'halley' (uses f''') or 'newton'; Halley falls back to Newton where its
    denominator is below ``eps`` (1e-12 rounded to f32, as in JAX)."""
    newton = f1 / (f2 + eps)
    if solver == "halley":
        denom = 2.0 * f2 * f2 - f1 * f3
        small = denom.abs() < eps
        halley = 2.0 * f1 * f2 / torch.where(small, torch.full_like(
            denom, eps), denom)
        step = torch.where(small, newton, halley)
    else:
        step = newton
    return torch.clamp(step, -max_step, max_step)


def solve_log_z(alpha: torch.Tensor, beta: torch.Tensor,
                theta0: torch.Tensor, iters: int = 25,
                solver: str = "halley", alpha_mask=None, beta_mask=None,
                max_step: float = 10.0) -> torch.Tensor:
    """Minimise -J over theta = log Z: ``iters`` trust-clamped steps from
    theta0 (...,), every leading-axis problem at once. Returns theta*."""
    theta = theta0
    for _ in range(iters):
        f1, f2, f3 = derivative_sums(theta, alpha, beta, alpha_mask,
                                     beta_mask)
        theta = theta - halley_step(f1, f2, f3, solver=solver,
                                    max_step=max_step)
    return theta


class MinceStats(NamedTuple):
    """Fixed-size sufficient statistics of one (batched) NCE problem: ``a_*``
    bucket representatives (weighted mean alpha), ``w_*`` bucket weight
    sums, ``lo``/``hi`` a bracket of the root. S is the bucket count."""
    a_data: torch.Tensor    # (..., S)
    w_data: torch.Tensor    # (..., S)
    a_noise: torch.Tensor   # (..., S)
    w_noise: torch.Tensor   # (..., S)
    lo: torch.Tensor        # (...,)
    hi: torch.Tensor        # (...,)


def anchored_atoms(scores, mult, n, k_virt, l_virt, log_anchor):
    """Sigmoid-argument atoms and consistent NCE weights from resident
    scores. scores (..., A); mult (..., A) each atom's importance
    multiplicity (1 for enumerated head rows, (N - k_eff) / n_accept for
    tail survivors, 0 for masked slots); n the population size; k_virt,
    l_virt (...,) virtual data/noise sample counts; log_anchor (...,) the
    plug-in log Ẑ. Returns (alpha, w_data, w_noise), each (..., A)."""
    k_virt = _f32(k_virt, scores)
    l_virt = _f32(l_virt, scores)
    log_anchor = _f32(log_anchor, scores)
    n = _f32(n, scores)
    log_r = (torch.log(torch.clamp(k_virt, min=1.0)) + torch.log(n) -
             torch.log(torch.clamp(l_virt, min=1.0)))
    alpha = scores + log_r[..., None]
    w_data = (k_virt[..., None] * mult *
              torch.exp(torch.clamp(scores - log_anchor[..., None],
                                    max=40.0)))
    w_noise = (l_virt / n)[..., None] * mult
    return alpha, w_data, w_noise


def mince_stats(alpha, w_data, w_noise, log_anchor, *, n_bins: int = 128,
                span: float = 20.0) -> MinceStats:
    """Weighted atoms compressed into S-bucket histograms around the
    anchor: uniform bins over [anchor - span, anchor + span], atoms outside
    clamped into the edge bins (where sigma has saturated). Stats of
    disjoint atom slices add.

    Each bucket's sum is taken over a (..., A, S) one-hot mask reduced over
    A, a fixed order: ``scatter_add_`` and ``index_put_(accumulate=True)``
    add with atomics on CUDA, whose bits change from run to run."""
    lo = _f32(log_anchor, alpha) - span
    width = (2.0 * span) / n_bins
    # clamped before the cast, so a far atom saturates into an edge bin
    pos = torch.clamp((alpha - lo[..., None]) / width, -1.0, float(n_bins))
    b = torch.clamp(pos.to(torch.int32), 0, n_bins - 1)
    onehot = b[..., None] == torch.arange(n_bins, dtype=torch.int32,
                                          device=alpha.device)

    def seg(w):
        return torch.where(onehot, w[..., None], torch.zeros_like(
            w[..., None])).sum(-2)

    wd, wn = seg(w_data), seg(w_noise)
    ad = seg(w_data * alpha) / torch.clamp(wd, min=1e-30)
    an = seg(w_noise * alpha) / torch.clamp(wn, min=1e-30)
    return MinceStats(a_data=ad, w_data=wd, a_noise=an, w_noise=wn,
                      lo=lo - 1.0, hi=_f32(log_anchor, alpha) + span + 1.0)


def stats_derivative_sums(theta, stats: MinceStats):
    """(f', f'', f''') from bucketed stats: O(S) a query an iteration."""
    sa = torch.sigmoid(theta[..., None] - stats.a_data)
    sb = torch.sigmoid(stats.a_noise - theta[..., None])
    da = stats.w_data * sa * (1.0 - sa)
    db = stats.w_noise * sb * (1.0 - sb)
    f1 = (stats.w_data * sa).sum(-1) - (stats.w_noise * sb).sum(-1)
    f2 = da.sum(-1) + db.sum(-1)
    f3 = (da * (1.0 - 2.0 * sa)).sum(-1) - (db * (1.0 - 2.0 * sb)).sum(-1)
    return f1, f2, f3


def solver_residual(theta, stats: MinceStats) -> torch.Tensor:
    """|f'(theta)|, the non-convergence diagnostic of a finished solve:
    round-off at a converged root, large (or non-finite, from non-finite
    stats) where the solve failed."""
    f1, _, _ = stats_derivative_sums(theta, stats)
    return f1.abs()


def _bracketed(theta, lo, hi, f1, step):
    """One bracket update: f' is non-decreasing, so f1 < 0 moves lo up to
    theta and f1 >= 0 moves hi down; a step that leaves the (inclusive)
    bracket becomes its midpoint."""
    lo = torch.where(f1 < 0, theta, lo)
    hi = torch.where(f1 < 0, hi, theta)
    cand = theta - step
    inside = (cand >= lo) & (cand <= hi)
    return torch.where(inside, cand, 0.5 * (lo + hi)), lo, hi


def solve_from_stats(stats: MinceStats, theta0, iters: int = 25,
                     solver: str = "halley"):
    """Bracket-safeguarded Halley/Newton root-find on bucketed stats."""
    theta = torch.minimum(torch.maximum(_f32(theta0, stats.lo), stats.lo),
                          stats.hi)
    lo, hi = stats.lo, stats.hi
    for _ in range(iters):
        f1, f2, f3 = stats_derivative_sums(theta, stats)
        step = halley_step(f1, f2, f3, solver=solver, max_step=float("inf"))
        theta, lo, hi = _bracketed(theta, lo, hi, f1, step)
    return theta


def anchored_solve(anchor, theta0, iters: int = 2, solver: str = "halley"):
    """Bracketed solve of the anchored NCE equation. Its f' is
    r (e^{theta - anchor} - 1) G(theta) with G > 0, so the root is the
    anchor and the damped steps reduce to scalar iterations:
    halley theta -= 2 tanh((theta - anchor) / 2), newton theta -= 1 -
    e^{-(theta - anchor)}, inside the bracket [anchor - 40, anchor + 40]."""
    anchor = _f32(anchor, torch.as_tensor(theta0))
    span = 40.0
    theta = torch.minimum(torch.maximum(_f32(theta0, anchor),
                                        anchor - span + 1.0),
                          anchor + span - 1.0)
    lo, hi = anchor - span, anchor + span
    for _ in range(iters):
        delta = torch.clamp(theta - anchor, -span, span)
        if solver == "halley":
            step = 2.0 * torch.tanh(0.5 * delta)
        else:
            step = 1.0 - torch.exp(-delta)
        theta, lo, hi = _bracketed(theta, lo, hi, delta, step)
    return theta


def solve_shared_atoms(alpha, w_data, w_noise, theta0, iters: int = 8,
                       solver: str = "halley", span: float = 40.0):
    """Bracketed Halley solve when data and noise share one atom set:
    sigma(alpha - theta) = 1 - sigma(theta - alpha) collapses the three
    sums to one sigmoid pass over (..., A) an iteration,

        u = w_data + w_noise,  c = sa (1 - sa)
        f1 = sum u sa - sum w_noise,  f2 = sum u c,  f3 = sum u c (1 - 2 sa)

    theta0 should be the anchor; the bracket is theta0 -+ span."""
    u = w_data + w_noise
    k_noise = w_noise.sum(-1)
    return _bracketed_shared_solve(alpha, u, k_noise, theta0, iters, solver,
                                   span=span)


def _bracketed_shared_solve(alpha, u, k_noise, theta0, iters, solver,
                            span: float = 40.0):
    theta = theta0
    lo, hi = theta0 - span, theta0 + span
    for _ in range(iters):
        sa = torch.sigmoid(theta[..., None] - alpha)
        c = u * sa * (1.0 - sa)
        f1 = (u * sa).sum(-1) - k_noise
        f2 = c.sum(-1)
        f3 = (c * (1.0 - 2.0 * sa)).sum(-1)
        step = halley_step(f1, f2, f3, solver=solver, max_step=float("inf"))
        theta, lo, hi = _bracketed(theta, lo, hi, f1, step)
    return theta


def solver_convergence_trace(alpha, beta, theta0, iters=25,
                             solver="halley") -> torch.Tensor:
    """|f'(theta)| before each of ``iters`` steps: (iters, ...), to compare
    Halley with Newton."""
    theta, trace = theta0, []
    for _ in range(iters):
        f1, f2, f3 = derivative_sums(theta, alpha, beta)
        trace.append(f1.abs())
        theta = theta - halley_step(f1, f2, f3, solver=solver)
    return torch.stack(trace)


__all__ = ["MinceStats", "anchored_atoms", "anchored_solve",
           "derivative_sums", "halley_step", "mince_stats", "nce_objective",
           "solve_from_stats", "solve_log_z", "solve_shared_atoms",
           "solver_convergence_trace", "solver_residual",
           "stats_derivative_sums"]
