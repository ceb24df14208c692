"""Estimator primitives (counterpart of ``repro.core.estimators``; the port
carries the exact log Z, the Eq. 5 head/tail combine and the FMBE log Ẑ)."""
from __future__ import annotations

import torch

from .feature_maps import FMBEState, fmbe_estimate_z

NEG_INF = -1e30


def exact_log_z(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """log Z = logsumexp_i (v_i . q). O(N d)."""
    return torch.logsumexp(v @ q, dim=-1)


def combine_head_tail_lse(log_head: torch.Tensor, log_tail: torch.Tensor,
                          n_tail_total: torch.Tensor,
                          n_tail_samples: torch.Tensor) -> torch.Tensor:
    """Eq. 5 combine from precomputed logsumexps:

        log( exp(log_head) + (n_tail_total / n_tail_samples) * exp(log_tail) )

    The tail term is dropped when the tail population is empty or no sample
    survived; log_tail == -inf goes through the same guard, so no NaN leaks
    out of -inf + finite.
    """
    log_scale = torch.log(torch.clamp(n_tail_total, min=1e-9)) - \
        torch.log(torch.clamp(n_tail_samples, min=1e-9))
    ok = (n_tail_total > 0) & (n_tail_samples > 0)
    tail = torch.clamp(log_tail, min=NEG_INF) + log_scale
    log_tail = torch.where(ok, tail, torch.full_like(tail, NEG_INF))
    return torch.logaddexp(log_head, log_tail)


def fmbe_log_z(state: FMBEState, q: torch.Tensor) -> torch.Tensor:
    """FMBE's Z estimate is signed; the log of its value clipped at 1e-30."""
    return torch.log(torch.clamp(fmbe_estimate_z(state, q), min=1e-30))
