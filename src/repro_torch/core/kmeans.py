"""Lloyd's k-means for the block-IVF index (counterpart of
``repro.core.kmeans``), with farthest-point reseeding of empty clusters.

The initial centroids are drawn with a ``torch.Generator``; they cannot
reproduce ``jax.random.choice``, so parity with the JAX index goes through
an injected assignment (``mips.build_ivf(..., assign=...)``).
"""
from __future__ import annotations

from typing import Tuple

import torch

# rows a block of segment_sums adds at a time
_SEGMENT_ROWS = 64


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment by squared Euclidean distance."""
    # ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2 ; ||x||^2 constant per row.
    d2 = -2.0 * (x.float() @ c.float().T) + (c.float() * c.float()).sum(-1)
    return torch.argmin(d2, dim=-1).to(torch.int32)


def segment_sums(x: torch.Tensor, seg: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """Sums (n_seg, d) f32 of the rows of x (N, d) by segment id seg (N,),
    added in an order fixed by seg alone: each segment's rows, in row
    order, are laid into blocks of ``_SEGMENT_ROWS`` (zero-padded) and
    each block summed, and the blocks' sums go round again until a segment
    holds one block. ``index_add_`` adds with atomics on CUDA, in an order
    that changes from run to run."""
    dev = x.device
    seg = seg.long()
    n_rows = torch.bincount(seg, minlength=n_seg)
    rows = x.float()
    while True:
        n_blk = (n_rows + _SEGMENT_ROWS - 1) // _SEGMENT_ROWS
        if int(n_blk.max()) <= 1 and rows.shape[0] == int(n_blk.sum()):
            break                        # one row a segment: the sums
        order = torch.argsort(seg, stable=True)
        rank = torch.empty_like(order)
        rank[order] = (torch.arange(seg.shape[0], device=dev)
                       - (torch.cumsum(n_rows, 0) - n_rows)[seg[order]])
        first = torch.cumsum(n_blk, 0) - n_blk          # a segment's block
        slot = (first[seg] * _SEGMENT_ROWS + rank)
        buf = rows.new_zeros((int(n_blk.sum()) * _SEGMENT_ROWS,
                              rows.shape[1]))
        buf[slot] = rows
        rows = buf.view(-1, _SEGMENT_ROWS, rows.shape[1]).sum(1)
        seg = torch.repeat_interleave(torch.arange(n_seg, device=dev), n_blk)
        n_rows = n_blk
    out = rows.new_zeros((n_seg, rows.shape[1]))
    out[seg] = rows
    return out


def centroids_from_assign(x: torch.Tensor, assign: torch.Tensor,
                          n_clusters: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centroids (C, d) f32, counts (C,) f32) of an assignment, the same
    bits in every process (``segment_sums``). Empty clusters get a zero
    centroid (``kmeans_step`` repairs them)."""
    sums = segment_sums(x, assign, n_clusters)
    counts = torch.bincount(assign.long(), minlength=n_clusters).float()
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
