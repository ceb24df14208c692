"""Shared layers: norms, MLPs, embeddings, RoPE (counterpart of
``repro.models.layers``).

Parameters are plain dicts of tensors in the JAX package's layout
(``x @ W`` with ``W (d_in, d_out)``), so converted JAX params plug in as is.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..core.distributed import (from_model, from_model_exclusive,
                                model_rank, to_model)

Params = Dict[str, Any]


def _dense_init(gen: torch.Generator, shape, dtype, device, scale=None):
    """Normal init scaled by fan_in ** -0.5 (fan_in = shape[-2] of a stacked
    weight, i.e. the input dimension as in the JAX package)."""
    fan_in = shape[-2]
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def mlp(p: Params, x: torch.Tensor, act: str, d_ff: int = 0, *,
        reduce: bool = True) -> torch.Tensor:
    """The gated (silu, gelu) or squared-ReLU MLP. Where ``down`` holds
    fewer than ``d_ff`` rows (a d_ff slice of a train step's compute
    split), gate/up run column-parallel and down row-parallel: the output
    is summed over the ``model`` group, or left as this rank's partial sum
    with ``reduce=False``."""
    split = bool(d_ff) and p["down"].shape[-2] != d_ff
    if split:
        x = to_model(x)
    if act == "sqrelu":
        h = F.relu(x @ p["up"]).square()
    else:
        a = x @ p["gate"]
        # jax.nn.gelu's default is the tanh approximation
        a = F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")
        h = a * (x @ p["up"])
    out = h @ p["down"]
    return from_model(out) if split and reduce else out


def embed(p: Params, tokens: torch.Tensor, vocab: int = 0) -> torch.Tensor:
    """The table's rows of ``tokens``. Where the table holds fewer than
    ``vocab`` rows (a train step's vocab slice, rank r holding rows [r n,
    (r + 1) n)), each rank looks up the tokens on its rows, zeros
    elsewhere, and the ``model`` group sums the bit patterns: exactly the
    whole table's lookup."""
    table = p["table"]
    n = table.shape[0]
    if not vocab or n == vocab:
        return table[tokens]
    lo = model_rank() * n
    local = tokens - lo
    mine = (local >= 0) & (local < n)
    rows = table[torch.clamp(local, 0, n - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return from_model_exclusive(rows)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh). ``positions`` is an int tensor broadcastable to
    (..., S), as in the JAX package (a decode step passes its 0-d position
    as (1,) or its per-lane (B,) positions as (B, 1), the JAX ``posv``), or
    one absolute position as a Python int (training and prefill callers).
    Rotates the split halves (not interleaved pairs) with f32 angles; a
    Python int and the same position as a tensor give the same bits."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (Dh/2,)
    if isinstance(positions, int):
        angles = freqs * positions                              # f32 (Dh/2,)
    else:
        angles = (positions[..., None].to(torch.float32) * freqs
                  )[..., None, :]                               # (..., S, 1, Dh/2)
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
