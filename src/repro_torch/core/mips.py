"""Block-IVF MIPS index (counterpart of ``repro.core.mips``).

Layout (the JAX package's host build, ``build_ivf``): class vectors are
k-means clustered, permuted cluster-contiguously and each cluster is padded
to a multiple of ``block_rows`` (at least one block), so every block is
cluster-pure. Packing runs on the device with a stable argsort; given the
same assignment it gives the JAX build's ``v_blocks``, ``valid``,
``row_id`` and ``slot_of_row`` bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from .kmeans import kmeans


class IVFIndex(NamedTuple):
    v_blocks: torch.Tensor         # (n_blocks, block_rows, d) permuted+padded rows
    valid: torch.Tensor            # (n_blocks, block_rows) bool — pad rows False
    row_id: torch.Tensor           # (n_blocks, block_rows) int32 original row id (-1 pad)
    slot_of_row: torch.Tensor      # (N,) int32 padded slot of each original row
    block_centroids: torch.Tensor  # (n_blocks, d)
    block_radius: torch.Tensor     # (n_blocks,) f32 max ||v - centroid|| over block
    n: int                         # true N
    block_rows: int
    assign: Optional[torch.Tensor] = None  # (N,) int32 k-means cluster of each row

    @property
    def n_blocks(self) -> int:
        return self.v_blocks.shape[0]


def build_ivf(v: torch.Tensor, block_rows: int = 512, n_clusters: int = 0,
              kmeans_iters: int = 20, *,
              generator: Optional[torch.Generator] = None,
              assign: Optional[torch.Tensor] = None,
              device="cuda") -> IVFIndex:
    """Build the block-IVF index of ``v (N, d)`` on ``device``. The cluster
    assignment comes from ``kmeans`` with ``generator``, or is injected as
    ``assign (N,)``."""
    dev = resolve_device(device)
    v = v.to(dev)
    n, d = v.shape
    br = block_rows
    if n_clusters <= 0:
        n_clusters = max(1, n // (4 * br))
    if assign is None:
        if generator is None:
            raise ValueError("build_ivf needs a generator or an assignment")
        _, assign = kmeans(v, n_clusters, iters=kmeans_iters,
                           generator=generator)
    assign = torch.as_tensor(assign, device=dev).to(torch.int64)

    sizes = torch.bincount(assign, minlength=n_clusters)
    padded = torch.clamp((sizes + br - 1) // br * br, min=br)
    offsets = torch.cumsum(padded, 0) - padded
    cluster_start = torch.cumsum(sizes, 0) - sizes
    n_total = int(padded.sum())
    order = torch.sort(assign, stable=True).indices
    sorted_assign = assign[order]
    rank = torch.arange(n, device=dev) - cluster_start[sorted_assign]
    slots = offsets[sorted_assign] + rank                    # (n,) unique
    row_id_flat = torch.full((n_total,), -1, dtype=torch.int32, device=dev)
    row_id_flat[slots] = order.to(torch.int32)
    v_flat = torch.zeros((n_total, d), dtype=v.dtype, device=dev)
    v_flat[slots] = v[order]
    slot_of_row = torch.zeros((n,), dtype=torch.int32, device=dev)
    slot_of_row[order] = slots.to(torch.int32)

    nb = n_total // br
    v_blocks = v_flat.reshape(nb, br, d)
    valid = (row_id_flat >= 0).reshape(nb, br)
    row_id = row_id_flat.reshape(nb, br)
    vf = v_blocks.float()
    counts = torch.clamp(valid.sum(1, keepdim=True), min=1).float()
    centroids = (vf * valid[..., None]).sum(1) / counts
    dist = torch.linalg.vector_norm(vf - centroids[:, None, :], dim=-1)
    radius = torch.where(valid, dist, torch.zeros_like(dist)).amax(1)
    return IVFIndex(v_blocks=v_blocks, valid=valid, row_id=row_id,
                    slot_of_row=slot_of_row,
                    block_centroids=centroids.to(v.dtype),
                    block_radius=radius.float(), n=n, block_rows=br,
                    assign=assign.to(torch.int32))


def probe_batch(index: IVFIndex, q: torch.Tensor, n_probe: int,
                bound: bool = True) -> torch.Tensor:
    """Batched coarse probe: q (Q, d) -> (Q, p) int32 block ids, ranked by
    the ball upper bound c.q + r ||q|| (Cauchy-Schwarz); dead (all-pad)
    blocks rank at -inf."""
    c_scores = (q @ index.block_centroids.T).float()           # (Q, nb)
    if bound:
        qn = torch.linalg.vector_norm(q.float(), dim=-1, keepdim=True)
        c_scores = c_scores + index.block_radius[None, :] * qn
    live = index.valid.any(-1)[None, :]
    c_scores = torch.where(live, c_scores,
                           torch.full_like(c_scores, float("-inf")))
    return torch.topk(c_scores, n_probe, dim=-1).indices.to(torch.int32)


def head_count(index: IVFIndex, block_ids: torch.Tensor) -> torch.Tensor:
    """Real (non-pad) rows covered by the probed blocks: (p,) -> scalar or
    (Q, p) -> (Q,). The per-query head size Eq. 5 subtracts from N."""
    return index.valid[block_ids.long()].sum(dim=(-2, -1))
