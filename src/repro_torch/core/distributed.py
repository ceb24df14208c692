"""Vocab-sharded partition estimation over ``torch.distributed``
(counterpart of ``repro.core.distributed``).

The output embedding V (N, d) is split by rows over the ranks of a process
group (the serving mesh's ``model`` group, ``launch.mesh``): rank r holds
rows ``[r * n_local, (r + 1) * n_local)``. Each rank computes its local
head and tail terms and the combine is

  * log Z        : an all-reduce MAX, then an all-reduce SUM of exp(x - m)
  * global top-k : a gather of k candidates a rank, then a merge

so the traffic is sublinear in N. Every function takes the process group
where the JAX package takes an ``axis_name``; JAX's ``shard_map`` shim has
no counterpart.

Gathers are all-reduce SUMs of bit patterns (``bitsum_``): each rank
writes its part into a zero buffer, viewed as 32-bit words, and every
other rank adds 0 there, so the sum is exact and keeps -0.0 and NaN
payloads, whatever dtypes the backend can reduce. One collective type
serves NCCL, gloo on the CPU and gloo on CUDA tensors alike.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels.topk_z import select_topk

NEG_INF = -1e30


def _dist():
    import torch.distributed as dist
    return dist


def group_rank(group) -> int:
    return _dist().get_rank(group)


def group_size(group) -> int:
    return _dist().get_world_size(group)


def _words(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as int32 words (uint8 where its byte
    count is not a multiple of 4)."""
    b = t.view(-1).view(torch.uint8)
    return b.view(torch.int32) if b.numel() % 4 == 0 else b


def bitsum_(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM of ``t``'s bit patterns over ``group``, in place.
    Exact where at most one rank holds a nonzero word at each position.
    (int32 words: NCCL has no 16-bit integer type.)"""
    if not t.is_contiguous():
        raise ValueError("bitsum_ needs a contiguous tensor")
    _dist().all_reduce(_words(t), op=_dist().ReduceOp.SUM, group=group)
    return t


def gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(m, *x.shape): every rank's ``x`` in rank order, through
    ``bitsum_``."""
    m, r = group_size(group), group_rank(group)
    buf = x.new_zeros((m,) + tuple(x.shape))
    buf[r].copy_(x)
    return bitsum_(buf, group)


def logspace_psum(x: torch.Tensor, group) -> torch.Tensor:
    """log of the sum over ``group`` of exp(x), -inf-safe: the one
    cross-shard combine of partial log-Z terms (head, tail and anchored
    LSEs)."""
    dist = _dist()
    m = x.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    ok = torch.isfinite(m)
    safe = torch.where(ok, m, torch.zeros_like(m))
    s = torch.exp(x - safe)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return torch.where(ok, safe + torch.log(s), m)


def merge_topk(values: torch.Tensor, ids: torch.Tensor, k: int,
               group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k from each rank's (Q, k_local) candidates with global
    ids: one gather of both (scores as their bits), then the top-k of the
    m * k_local candidates, score descending and the lowest id on ties
    (``lax.top_k``'s rule). Every rank's ids lie above the previous
    rank's and each list has its ties in ascending id order, so a stable
    sort of the rank-ordered lists gives that order. Entries at or below
    NEG/2 are the filler ``(NEG, 0)``."""
    q, kl = values.shape
    packed = torch.cat([values.float().contiguous().view(torch.int32),
                        ids.to(torch.int32)], 1)
    both = gather_stack(packed, group)                   # (m, Q, 2 kl)
    av = both[..., :kl].contiguous().view(torch.float32)
    ai = both[..., kl:]
    av = av.permute(1, 0, 2).reshape(q, -1)
    ai = ai.permute(1, 0, 2).reshape(q, -1)
    return select_topk(av, ai, k)


def _scores(v_local: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(Q, n_local) f32 logits in the input dtype, then f32 (the exact
    decode's reference arithmetic)."""
    return (q @ v_local.T).float()


def sharded_exact_log_z(v_local: torch.Tensor, q: torch.Tensor,
                        group) -> torch.Tensor:
    """Exact log Z with V row-sharded over ``group``; q replicated, (d,)
    or (B, d)."""
    one = q.dim() == 1
    qq = q[None] if one else q
    local = torch.logsumexp(_scores(v_local, qq), -1)
    out = logspace_psum(local, group)
    return out[0] if one else out


class ShardedTopK(NamedTuple):
    scores: torch.Tensor   # (..., k) global top-k scores (descending)
    ids: torch.Tensor      # (..., k) global row ids


def sharded_top_k(v_local: torch.Tensor, q: torch.Tensor, k: int,
                  group) -> ShardedTopK:
    """Global top-k: the local top-k with global ids ``li + rank *
    n_local``, a gather of the k candidates and a merge."""
    one = q.dim() == 1
    qq = q[None] if one else q
    n_local = v_local.shape[0]
    r = group_rank(group)
    scores = _scores(v_local, qq)
    lv, li = select_topk(scores, torch.arange(n_local, device=q.device),
                         min(k, n_local))
    mv, mi = merge_topk(lv, li + r * n_local, k, group)
    if one:
        mv, mi = mv[0], mi[0]
    return ShardedTopK(scores=mv, ids=mi)


def sharded_mimps_log_z(v_local: torch.Tensor, q: torch.Tensor,
                        k_local: int, l_local: int, group, *,
                        generator: Optional[torch.Generator] = None,
                        tail_pos: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ShardedTopK]:
    """MIMPS with V row-sharded (``k_local``/``l_local`` per shard), q
    (d,): a per-shard head of the k_local best rows and a per-shard tail of
    l_local uniform samples of the local rows ranked past k_local, combined
    in log domain. ``tail_pos`` (l_local,) injects this rank's draws
    (offsets into ranks [k_local, n_local), JAX's ``randint`` under its
    shard-folded key); else ``generator`` draws them. Returns (log Z, the
    merged top-k_local candidates)."""
    n_local = v_local.shape[0]
    r = group_rank(group)
    scores = (v_local @ q).float()                           # (n_local,)
    hv, hi = select_topk(scores[None], torch.arange(n_local,
                                                    device=q.device),
                         k_local)
    order = torch.sort(-scores, stable=True).indices
    if tail_pos is None:
        tail_pos = torch.randint(0, n_local - k_local, (l_local,),
                                 generator=generator, device=q.device)
    pos = k_local + torch.as_tensor(tail_pos, device=q.device).long()
    tail = scores[order[pos]]
    log_head = torch.logsumexp(hv[0], -1)
    log_tail = (torch.log(torch.tensor(float(n_local - k_local)))
                - torch.log(torch.tensor(float(l_local)))).to(q.device) \
        + torch.logsumexp(tail, -1)
    local = torch.logaddexp(log_head, log_tail)
    log_z = logspace_psum(local.reshape(1), group)[0]
    mv, mi = merge_topk(hv, hi + r * n_local, k_local, group)
    return log_z, ShardedTopK(scores=mv[0], ids=mi[0])


# ---------------------------------------------------------------------------
# training's compute split over the mesh's 'model' group
# ---------------------------------------------------------------------------
#
# A train step under a mesh runs its column-parallel products (the fan-out
# of wq/wk/wv/gate/up), its row-parallel products (the fan-in of wo/down),
# its experts and its vocabulary rows on the rank's slices of the leaves.
# The step opens ``split_compute`` with its groups; a block that finds a
# sliced leaf (fewer heads, d_ff columns, experts or vocab rows than the
# config's) reads the group from ``model_group()`` and places the
# operators below around its products, Megatron's f and g:
#
#   to_model    identity forward, sum of the gradient over 'model' backward
#               (before a column-parallel product: each rank's dx is the
#               part from its slice);
#   from_model  sum over 'model' forward, identity backward (after a
#               row-parallel product: each rank's output is a partial sum).
#
# Sums of activations run in f32 and are rounded once to the input's dtype.
# A whole leaf needs no collective, so a block with no sliced leaf computes
# as on one device, bit for bit.

_SPLIT = {"model": None, "data": ()}


@contextlib.contextmanager
def split_compute(model=None, data=()):
    """The step's ``model`` group and its data groups (the gather order of
    ``gather_data``: the innermost mesh dim first), for the blocks and
    losses inside the block. A group of one rank counts as none. A module
    global, not a thread's: the backward (and a checkpoint's recompute)
    may run on autograd's device thread."""
    prev = dict(_SPLIT)
    _SPLIT.update(model=model if model is not None
                  and group_size(model) > 1 else None,
                  data=tuple(g for g in data if group_size(g) > 1))
    try:
        yield
    finally:
        _SPLIT.update(prev)


def model_group():
    """The ``model`` group of the open ``split_compute``, or None."""
    return _SPLIT["model"]


def data_groups() -> tuple:
    """The data groups of the open ``split_compute`` (innermost first),
    or ()."""
    return _SPLIT["data"]


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    s = x.to(torch.float32, copy=True).contiguous()
    _dist().all_reduce(s, op=_dist().ReduceOp.SUM, group=group)
    return s.to(x.dtype)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FromModelExclusive(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return bitsum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def split_group():
    """The open ``split_compute``'s 'model' group; raises outside one."""
    g = model_group()
    if g is None:
        raise RuntimeError("a block holds a slice of its leaves outside a "
                           "split_compute over 'model' (the sharded train "
                           "step opens one)")
    return g


def model_rank() -> int:
    """This rank's coordinate in the open ``split_compute``'s 'model'
    group; raises outside one."""
    return group_rank(split_group())


def to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the gradient summed over the 'model' group
    backward. Placed before a column-parallel product."""
    return _ToModel.apply(x, split_group())


def from_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the 'model' group in f32, rounded to x's dtype;
    identity backward. Placed after a row-parallel product."""
    return _FromModel.apply(x, split_group())


def from_model_exclusive(x: torch.Tensor) -> torch.Tensor:
    """``from_model`` where at most one rank holds a nonzero at each
    position (the others +0.0): the sum of bit patterns (``bitsum_``),
    exact. The vocab-parallel lookup's combine."""
    return _FromModelExclusive.apply(x, split_group())


def gather_data(x: torch.Tensor) -> torch.Tensor:
    """Every data replica's rows of ``x``, detached, in the replicas'
    order (the mesh's data coordinate, its first dim major): the whole
    batch's rows where each replica holds a contiguous block. ``x`` itself
    outside a ``split_compute`` with data groups."""
    out = x.detach()
    for g in data_groups():
        out = gather_stack(out.contiguous(), g).reshape(
            -1, *out.shape[1:])
    return out


def data_coord() -> int:
    """This rank's replica among the data groups of the open
    ``split_compute`` (its rows are block ``data_coord()`` of
    ``gather_data``'s), 0 outside one."""
    c, mult = 0, 1
    for g in data_groups():
        c += group_rank(g) * mult
        mult *= group_size(g)
    return c
