"""Lloyd's k-means for the block-IVF index (counterpart of
``repro.core.kmeans``), with farthest-point reseeding of empty clusters.

The initial centroids are drawn with a ``torch.Generator``; they cannot
reproduce ``jax.random.choice``, so parity with the JAX index goes through
an injected assignment (``mips.build_ivf(..., assign=...)``).
"""
from __future__ import annotations

from typing import Tuple

import torch


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment by squared Euclidean distance."""
    # ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2 ; ||x||^2 constant per row.
    d2 = -2.0 * (x.float() @ c.float().T) + (c.float() * c.float()).sum(-1)
    return torch.argmin(d2, dim=-1).to(torch.int32)


def centroids_from_assign(x: torch.Tensor, assign: torch.Tensor,
                          n_clusters: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centroids (C, d) f32, counts (C,) f32) of an assignment. Empty
    clusters get a zero centroid (``kmeans_step`` repairs them)."""
    idx = assign.long()
    sums = torch.zeros((n_clusters, x.shape[1]), dtype=torch.float32,
                       device=x.device).index_add_(0, idx, x.float())
    counts = torch.zeros((n_clusters,), dtype=torch.float32,
                         device=x.device).index_add_(
        0, idx, torch.ones(x.shape[:1], dtype=torch.float32, device=x.device))
    return sums / torch.clamp(counts, min=1.0)[:, None], counts


def kmeans_step(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration; c (C, d) -> (C, d). Clusters left empty are
    reseeded to the points farthest from their assigned centroid (empty
    cluster #j in cluster order takes the j-th farthest point)."""
    n_clusters = c.shape[0]
    assign = _assign(x, c)
    mean_c, counts = centroids_from_assign(x, assign, n_clusters)
    xf = x.float()
    d2 = (xf - c.float()[assign.long()]).square().sum(-1)
    far_idx = torch.topk(d2, n_clusters).indices
    empty = counts == 0
    rank = torch.clamp(torch.cumsum(empty.int(), 0) - 1, 0, n_clusters - 1)
    reseed = xf[far_idx[rank]]
    return torch.where(empty[:, None], reseed, mean_c)


def kmeans(x: torch.Tensor, n_clusters: int, iters: int = 15, *,
           generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (centroids (C, d) f32, assignments (N,) int32)."""
    n = x.shape[0]
    init_idx = torch.randperm(n, generator=generator,
                              device=generator.device)[:n_clusters]
    c = x[init_idx.to(x.device)].float()
    for _ in range(iters):
        c = kmeans_step(x, c)
    return c, _assign(x, c)
