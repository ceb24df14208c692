"""Synthetic word2vec-like embeddings and queries for the paper's studies
(the port's own copy of ``benchmarks/common.py``'s ``make_embeddings``,
``make_queries`` and ``pct_abs_rel_error``, and of
``benchmarks/fig1_cdf.py``'s ``neighbors_for_mass``).

The class vectors carry the two statistics behind the paper's phenomena:
cluster structure (words near topic centroids) and rank-correlated norms
(frequent, low-rank words have small norms and flat context distributions;
rare ones large norms and concentrated ones, the Fig. 1 effect).

Draws come from a ``torch.Generator``, so they differ from the JAX
package's for any seed; every draw can be passed in instead (numpy arrays
or tensors), which is how the tests rebuild the JAX data exactly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device


def _given(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(x) if not torch.is_tensor(x) else x,
                           device=device).to(dtype)


def make_embeddings(generator: Optional[torch.Generator], n: int, d: int,
                    n_centers: int = 64, spread: float = 0.6,
                    score_scale: float = 0.35, *, centers=None, assign=None,
                    noise=None, device="cuda") -> torch.Tensor:
    """(n, d) f32 class vectors: a centre each (``assign`` (n,) of
    ``centers`` (n_centers, d) N(0, 1)) plus ``spread`` times N(0, 1)
    ``noise`` (n, d), normalised, then scaled by 0.35 + 1.8 sqrt(rank / n)
    times sqrt(d) times ``score_scale``. The three draws come from
    ``generator`` in that order unless given."""
    dev = resolve_device(device)
    f32 = torch.float32
    centers = (torch.randn((n_centers, d), generator=generator, device=dev)
               if centers is None else _given(centers, dev))
    assign = (torch.randint(0, n_centers, (n,), generator=generator,
                            device=dev)
              if assign is None else _given(assign, dev, torch.int64))
    noise = (torch.randn((n, d), generator=generator, device=dev)
             if noise is None else _given(noise, dev))
    v = centers[assign.long()] + spread * noise
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    rank = torch.arange(n, dtype=f32, device=dev) / n
    norm = 0.35 + 1.8 * torch.sqrt(rank)
    return v * norm[:, None] * torch.sqrt(torch.tensor(
        float(d), dtype=f32, device=dev)) * score_scale


def make_queries(generator: Optional[torch.Generator], v: torch.Tensor,
                 n_queries: int, noise_rel: float = 0.0, *, idx=None,
                 noise=None):
    """Queries = distinct class vectors ``idx`` (n_queries,), plus, where
    ``noise_rel`` > 0, a random direction ``noise`` (n_queries, d) scaled
    to ``noise_rel`` of each query's norm (SS5.1's construction). Returns
    (q (n_queries, d), idx)."""
    v = _given(v, v.device if torch.is_tensor(v) else "cpu")
    dev = v.device
    if idx is None:
        idx = torch.randperm(v.shape[0], generator=generator,
                             device=dev)[:n_queries]
    idx = _given(idx, dev, torch.int64)
    q = v[idx]
    if noise_rel > 0:
        noise = (torch.randn(q.shape, generator=generator, device=dev)
                 if noise is None else _given(noise, dev))
        noise = noise / torch.linalg.vector_norm(noise, dim=1, keepdim=True)
        q = q + noise * noise_rel * torch.linalg.vector_norm(
            q, dim=1, keepdim=True)
    return q, idx


def pct_abs_rel_error(log_z_hat, log_z_true) -> np.ndarray:
    """The paper's mu = 100 |Z_hat - Z| / Z, in float64 from the log
    domain."""
    def f64(x):
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float64)
    return 100.0 * np.abs(1.0 - np.exp(f64(log_z_hat) - f64(log_z_true)))


def neighbors_for_mass(v, q, mass: float = 0.8):
    """Rows of v needed, largest contributions first, for ``mass`` of
    Z(q) = sum_i exp(v_i . q): q (d,) -> int, q (B, d) -> (B,) int64.
    The contributions are f32 scores taken to float64, as in the JAX
    script; each query's running mass is a scan along its row (a lone
    query gets a zero row beside it: a one-row scan on CUDA is a
    device-wide scan whose bits change from run to run)."""
    v = _given(v, v.device if torch.is_tensor(v) else "cpu")
    q = _given(q, v.device)
    rows = q.reshape(-1, q.shape[-1])
    s = (rows @ v.T).double()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    e = torch.sort(e, dim=-1, descending=True).values
    pad = e.shape[0] == 1
    if pad:
        e = torch.cat([e, torch.zeros_like(e)])
    c = torch.cumsum(e, -1)
    if pad:
        c, e = c[:1], e[:1]
    c = c / e.sum(-1, keepdim=True)
    target = torch.full((c.shape[0], 1), mass, dtype=c.dtype,
                        device=c.device)
    k = torch.searchsorted(c, target)[:, 0] + 1
    return int(k[0]) if q.dim() == 1 else k
