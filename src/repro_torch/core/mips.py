"""Block-IVF MIPS index (counterpart of ``repro.core.mips``).

Layout: class vectors are k-means clustered, permuted cluster-contiguously
and each cluster is padded to a multiple of ``block_rows`` (at least one
block), so every block is cluster-pure. ``build_ivf`` packs into exactly the
blocks the clusters need (the JAX package's host build); ``build_ivf_device``
and ``refresh_ivf`` pack through ``pack_ivf`` into the fixed capacity
``ivf_capacity_blocks``, whose trailing blocks are dead. One packer serves
both, on the device with a stable argsort; given the same assignment it
gives the JAX builds' ``v_blocks``, ``valid``, ``row_id`` and
``slot_of_row`` bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from .kmeans import _assign, centroids_from_assign, kmeans, kmeans_step


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


def ivf_capacity_blocks(n: int, block_rows: int, n_clusters: int) -> int:
    """Blocks that hold any assignment of n rows to n_clusters cluster-pure
    padded blocks: a cluster wastes under one block of padding (an empty
    one exactly one), so ceil(n / block_rows) + n_clusters always do."""
    return -(-n // block_rows) + n_clusters


def _pack(v: torch.Tensor, assign: torch.Tensor, n_clusters: int,
          block_rows: int, n_blocks: Optional[int] = None) -> IVFIndex:
    """Packs rows cluster by cluster with a stable sort, each cluster padded
    to a multiple of ``block_rows`` (at least one block), into ``n_blocks``
    blocks, or into exactly the blocks the clusters need (read back to the
    host) when ``n_blocks`` is None. Blocks past the packed rows are dead
    (all pad)."""
    dev = v.device
    n, d = v.shape
    br = block_rows
    assign = assign.to(device=dev, dtype=torch.int64)
    sizes = torch.bincount(assign, minlength=n_clusters)
    padded = torch.clamp((sizes + br - 1) // br * br, min=br)
    offsets = torch.cumsum(padded, 0) - padded
    cluster_start = torch.cumsum(sizes, 0) - sizes
    if n_blocks is None:
        n_blocks = int(padded.sum()) // br
    n_total = n_blocks * br
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

    v_blocks = v_flat.reshape(n_blocks, br, d)
    valid = (row_id_flat >= 0).reshape(n_blocks, br)
    row_id = row_id_flat.reshape(n_blocks, br)
    # a copy at f32 too, where .float() would alias the blocks
    vf = v_blocks.to(torch.float32, copy=True)   # 2.9 GB at qwen1.5-4b's head
    counts = torch.clamp(valid.sum(1, keepdim=True), min=1).float()
    # the masked rows, then the rows less their centroid, overwrite vf in
    # place (the same values as the out-of-place products; a dead row's
    # distance is dropped below), so one f32 copy of the blocks is alive:
    # 8.5 GB at llama-3.2-vision-90b's head, where a second would not fit
    # beside its 55.5 GB of weights
    centroids = vf.mul_(valid[..., None]).sum(1) / counts
    dist = torch.linalg.vector_norm(vf.sub_(centroids[:, None, :]), dim=-1)
    del vf
    radius = torch.where(valid, dist, torch.zeros_like(dist)).amax(1)
    return IVFIndex(v_blocks=v_blocks, valid=valid, row_id=row_id,
                    slot_of_row=slot_of_row,
                    block_centroids=centroids.to(v.dtype),
                    block_radius=radius.float(), n=n, block_rows=br,
                    assign=assign.to(torch.int32))


def _assignment(v: torch.Tensor, n_clusters: int, kmeans_iters: int,
                generator: Optional[torch.Generator],
                assign: Optional[torch.Tensor], name: str) -> torch.Tensor:
    if assign is not None:
        return torch.as_tensor(assign, device=v.device)
    if generator is None:
        raise ValueError(f"{name} needs a generator or an assignment")
    return kmeans(v, n_clusters, iters=kmeans_iters, generator=generator)[1]


def build_ivf(v: torch.Tensor, block_rows: int = 512, n_clusters: int = 0,
              kmeans_iters: int = 20, *,
              generator: Optional[torch.Generator] = None,
              assign: Optional[torch.Tensor] = None,
              device="cuda") -> IVFIndex:
    """Build the block-IVF index of ``v (N, d)`` on ``device`` with exactly
    the blocks its clusters need (the JAX host build's layout). The cluster
    assignment comes from ``kmeans`` with ``generator``, or is injected as
    ``assign (N,)``."""
    v = v.to(resolve_device(device))
    if n_clusters <= 0:
        n_clusters = max(1, v.shape[0] // (4 * block_rows))
    assign = _assignment(v, n_clusters, kmeans_iters, generator, assign,
                         "build_ivf")
    return _pack(v, assign, n_clusters, block_rows)


def pack_ivf(v: torch.Tensor, assign: torch.Tensor, n_clusters: int,
             block_rows: int) -> IVFIndex:
    """(v, assignment) -> block-IVF index of ``ivf_capacity_blocks`` blocks,
    whatever the assignment: every pack of one (N, block_rows, n_clusters)
    has the same shapes, so a repacked index can replace the old one under
    anything that took the old one's tensors. Dead blocks rank at -inf in
    ``probe``/``probe_batch``. No host read."""
    nb = ivf_capacity_blocks(v.shape[0], block_rows, n_clusters)
    return _pack(v, assign, n_clusters, block_rows, nb)


def build_ivf_device(v: torch.Tensor, block_rows: int = 512,
                     n_clusters: int = 0, kmeans_iters: int = 20, *,
                     generator: Optional[torch.Generator] = None,
                     assign: Optional[torch.Tensor] = None,
                     device="cuda") -> IVFIndex:
    """The fixed-capacity build: the same k-means as ``build_ivf`` (so the
    same clusters and packing order), packed by ``pack_ivf`` into
    ``ivf_capacity_blocks`` blocks."""
    v = v.to(resolve_device(device))
    if n_clusters <= 0:
        n_clusters = max(1, v.shape[0] // (4 * block_rows))
    assign = _assignment(v, n_clusters, kmeans_iters, generator, assign,
                         "build_ivf_device")
    return pack_ivf(v, assign, n_clusters, block_rows)


def refresh_ivf(index: IVFIndex, w: torch.Tensor, *, n_clusters: int,
                kmeans_iters: int = 1):
    """Index maintenance under embedding drift: warm-starts the centroids
    from ``index.assign`` over the current ``w``, runs ``kmeans_iters``
    Lloyd steps (``kmeans_step``, empty clusters reseeded), reassigns every
    row and repacks with ``pack_ivf``. The sums are ``segment_sums``', so a
    refresh gives the same bits in every process.

    Returns ``(new_index, {"churn", "drift"})``: the share of rows whose
    cluster changed, and mean ||w_row - stored_row|| / mean ||w_row||, the
    staleness of the index's row copies at call time (0-d f32 tensors)."""
    d = w.shape[1]
    assign_old = index.assign.to(w.device)
    c, _ = centroids_from_assign(w, assign_old, n_clusters)
    for _ in range(kmeans_iters):
        c = kmeans_step(w, c)
    assign_new = _assign(w, c)
    churn = (assign_new != assign_old).float().mean()
    stale = index.v_blocks.reshape(-1, d)[index.slot_of_row.long()]
    wf = w.float()
    drift = torch.linalg.vector_norm(wf - stale.float(), dim=-1).mean() / \
        torch.clamp(torch.linalg.vector_norm(wf, dim=-1).mean(), min=1e-9)
    new_index = pack_ivf(w, assign_new, n_clusters, index.block_rows)
    return new_index, {"churn": churn, "drift": drift}


def probe(index: IVFIndex, q: torch.Tensor, n_probe: int,
          bound: bool = True) -> torch.Tensor:
    """Top-n_probe block ids of one query: q (d,) -> (p,) int32."""
    return probe_batch(index, q[None], n_probe, bound)[0]


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


def gather_scores(index: IVFIndex, q: torch.Tensor, block_ids: torch.Tensor):
    """Scores of the rows of the probed blocks (the plain gather):
    q (d,), block_ids (p,) -> (scores (p * block_rows,), valid (same))."""
    ids = block_ids.long()
    scores = torch.einsum("pbd,d->pb", index.v_blocks[ids], q)
    return scores.reshape(-1), index.valid[ids].reshape(-1)


def exact_top_k(v: torch.Tensor, q: torch.Tensor, k: int):
    """Oracle S_k(q): exact top-k of v (N, d) by inner product with q (d,),
    ties to the lowest id -> (values (k,), ids (k,) int32). O(N d)."""
    s = v @ q
    order = torch.sort(s, descending=True, stable=True).indices[:k]
    return s[order], order.to(torch.int32)


def pad_ivf_blocks(index: IVFIndex, multiple: int) -> IVFIndex:
    """Dead (all-pad) blocks appended so n_blocks % multiple == 0. Rows keep
    their slots, so ``slot_of_row`` and every live block are unchanged."""
    nb, br, d = index.v_blocks.shape
    pad = (-nb) % multiple
    if pad == 0:
        return index
    vb, dev = index.v_blocks, index.v_blocks.device
    return index._replace(
        v_blocks=torch.cat([vb, vb.new_zeros((pad, br, d))]),
        valid=torch.cat([index.valid,
                         torch.zeros((pad, br), dtype=torch.bool,
                                     device=dev)]),
        row_id=torch.cat([index.row_id,
                          torch.full((pad, br), -1, dtype=index.row_id.dtype,
                                     device=dev)]),
        block_centroids=torch.cat([
            index.block_centroids,
            index.block_centroids.new_zeros((pad, d))]),
        block_radius=torch.cat([index.block_radius,
                                index.block_radius.new_zeros((pad,))]))
