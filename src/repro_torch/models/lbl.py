"""Log-bilinear language model (Mnih & Hinton 2008), the paper's SS5.2
model (counterpart of ``repro.models.lbl``).

q(context) = sum_i C_i . r_{w_i} over a fixed context window; the score of
the next word w is q . r_w + b_w. Trained with NCE while clamping Z := 1
(the heuristic the paper evaluates MIMPS against in Table 4).

``init_lbl`` draws from a ``torch.Generator``, so its parameters differ
from the JAX package's for any seed; ``interop.lbl_params_from_numpy``
carries JAX parameters across.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from .. import resolve_device
from .layers import _dense_init

Params = Dict[str, Any]


def init_lbl(generator: torch.Generator, vocab: int, d: int, context: int,
             dtype=torch.float32, device="cuda") -> Params:
    """Word vectors r (vocab, d) ~ 0.1 N(0, 1), position matrices c
    (context, d, d) ~ d^-1/2 N(0, 1) and zero biases b (vocab,), drawn from
    ``generator`` (which must live on ``device``) in that order."""
    dev = resolve_device(device)
    return {
        "r": _dense_init(generator, (vocab, d), dtype, dev, scale=0.1),
        "c": _dense_init(generator, (context, d, d), dtype, dev,
                         scale=d ** -0.5),
        "b": torch.zeros((vocab,), dtype=dtype, device=dev),
    }


def context_vector(p: Params, ctx_tokens: torch.Tensor) -> torch.Tensor:
    """ctx_tokens (B, n_ctx) -> q (B, d)."""
    r_ctx = p["r"][ctx_tokens.long()]                   # (B, n, d)
    return torch.einsum("bnd,nde->be", r_ctx, p["c"])


def scores(p: Params, q: torch.Tensor,
           words: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, d) -> scores over ``words`` (B, ...) or the full vocabulary."""
    if words is None:
        return q @ p["r"].T + p["b"]
    words = words.long()
    r = p["r"][words]                                   # (B, ..., d)
    return torch.einsum("bd,b...d->b...", q, r) + p["b"][words]


def class_vectors(p: Params) -> torch.Tensor:
    """The paper's v_i: (vocab, d + 1), the bias appended to r, so that
    with a 1 appended to q (``query_vector``) MIPS sees the whole score."""
    return torch.cat([p["r"], p["b"][:, None]], 1)


def query_vector(p: Params, ctx_tokens: torch.Tensor) -> torch.Tensor:
    q = context_vector(p, ctx_tokens)
    return torch.cat([q, torch.ones((*q.shape[:-1], 1), dtype=q.dtype,
                                    device=q.device)], -1)


def nce_loss(p: Params, ctx: torch.Tensor, target: torch.Tensor,
             noise: torch.Tensor,
             log_noise_prob: Tuple[torch.Tensor, torch.Tensor],
             n_noise: int) -> torch.Tensor:
    """NCE with Z clamped to 1 (the paper's SS5.2 training setup).

    ctx (B, n); target (B,); noise (B, k); log_noise_prob: log q(w) of the
    target and noise words, shapes (B,) and (B, k)."""
    q = context_vector(p, ctx)
    s_t = scores(p, q, target)                          # (B,)  log p_model
    s_n = scores(p, q, noise)                           # (B, k)
    log_k = math.log(float(n_noise))
    # P(data | w) = sigma(s - log k q(w))
    pos = torch.nn.functional.logsigmoid(s_t - log_k - log_noise_prob[0])
    neg = torch.nn.functional.logsigmoid(-(s_n - log_k - log_noise_prob[1]))
    return -(pos.mean() + neg.sum(1).mean())
