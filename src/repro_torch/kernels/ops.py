"""Public wrappers around the kernels (counterpart of
``repro.kernels.ops``): the fused cross-entropy as a differentiable
function and its full-logits oracle, the exact log Z plus top-k and its
oracle, the probed-block scores and their oracle, and the FMBE features
and estimate."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import fmbe as _fmbe
from . import fused_ce as _fce
from . import ivf_score as _ivf
from . import topk_z as _tkz


class FusedCrossEntropy(torch.autograd.Function):
    """(nll (T,), lse (T,)) of h (T, d), w (V, d), labels (T,) through the
    streaming kernels, differentiable in h and w. Both outputs take a
    cotangent (lse's is nonzero under the selfnorm loss); autograd hands an
    unused output's cotangent in as zeros."""

    @staticmethod
    def forward(ctx, h, w, labels):
        nll, lse = _fce.fused_ce_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        return nll, lse

    @staticmethod
    def backward(ctx, g_nll, g_lse):
        h, w, labels, lse = ctx.saved_tensors
        dh, dw = _fce.fused_ce_bwd(h, w, labels, lse, g_nll, g_lse)
        return dh, dw, None


class VocabParallelCrossEntropy(torch.autograd.Function):
    """``FusedCrossEntropy`` with w's rows split over a process group (the
    train step's 'model' group): rank r holds rows [r n, (r + 1) n) of the
    V = m n, h and labels are every rank's. Forward: ``fused_ce_fwd`` on
    the local rows with the labels shifted by r n (a label off the shard
    leaves the kernel's label score at NEG), the ranks' LSEs combined by
    ``logspace_psum``, the label's score taken from its owning shard and
    summed over the group. Backward: ``fused_ce_bwd`` on the local rows
    with the combined lse, so dW is exactly this shard's rows of the whole
    dW and dh a partial sum, summed over the group in f32."""

    @staticmethod
    def forward(ctx, h, w, labels, group):
        from ..core.distributed import (bitsum_, group_rank, group_size,
                                        logspace_psum)
        n = w.shape[0]
        v = n * group_size(group)
        lab = labels.long()
        local = (lab - group_rank(group) * n).to(torch.int32)
        nll_l, lse_l = _fce.fused_ce_fwd(h, w, local)
        mine = (local >= 0) & (local < n)
        picked = torch.where(mine, lse_l - nll_l, torch.zeros_like(lse_l))
        picked = bitsum_(picked.contiguous(), group)
        picked = torch.where((lab >= 0) & (lab < v), picked,
                             torch.full_like(picked, _fce.NEG))
        lse = logspace_psum(lse_l, group)
        ctx.group = group
        ctx.save_for_backward(h, w, local, lse)
        return lse - picked, lse

    @staticmethod
    def backward(ctx, g_nll, g_lse):
        import torch.distributed as dist
        h, w, local, lse = ctx.saved_tensors
        dh, dw = _fce.fused_ce_bwd(h, w, local, lse, g_nll, g_lse,
                                   cast=False)
        dh = dh.contiguous()
        dist.all_reduce(dh, op=dist.ReduceOp.SUM, group=ctx.group)
        return dh.to(h.dtype), dw.to(w.dtype), None, None


def fused_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                        labels: torch.Tensor, group=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll (T,), lse (T,)) = streaming softmax CE; dh in h.dtype and dw in
    w.dtype from the backward kernel. With ``group``, w is this rank's
    slice of the vocabulary rows (``VocabParallelCrossEntropy``)."""
    if group is not None:
        return VocabParallelCrossEntropy.apply(h, w, labels, group)
    return FusedCrossEntropy.apply(h, w, labels)


def fused_ce_ref(h: torch.Tensor, w: torch.Tensor,
                 labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-softmax CE oracle (materialises the (T, V) logits):
    -> (nll (T,), lse (T,))."""
    logits = (h @ w.T).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return lse - picked, lse


def fused_topk_z(h: torch.Tensor, w: torch.Tensor, k: int = 8):
    """(lse (Q,), topv (Q, k), topi (Q, k)) in one fused pass over w."""
    return _tkz.topk_z(h, w, k)


def topk_z_ref(h: torch.Tensor, w: torch.Tensor, k: int):
    """Exact log Z and top-k oracle (materialises the (Q, V) logits, in
    the inputs' dtype, then f32): -> (lse (Q,), topv (Q, k), topi (Q, k)
    int32), ties to the lowest id."""
    logits = (h @ w.T).float()
    topv, topi = _tkz.select_topk(
        logits, torch.arange(w.shape[0], device=h.device), k)
    return torch.logsumexp(logits, -1), topv, topi


def ivf_block_scores(w_blocks: torch.Tensor, h: torch.Tensor,
                     block_ids: torch.Tensor) -> torch.Tensor:
    """(Q, p, block_rows) f32 scores for the probed blocks only."""
    return _ivf.ivf_score(w_blocks, h, block_ids)


def fused_fmbe_phi(omega: torch.Tensor, degree: torch.Tensor,
                   coef: torch.Tensor, x: torch.Tensor, *,
                   pack: Optional[_fmbe.FmbePack] = None) -> torch.Tensor:
    """(Q, P) Kar-Karnick features without the (Q, P, max_degree)
    projection tensor (``pack``: as ``kernels.fmbe.fmbe_phi``)."""
    return _fmbe.fmbe_phi(omega, degree, coef, x, pack=pack)


def fused_fmbe_z(omega: torch.Tensor, degree: torch.Tensor,
                 coef: torch.Tensor, lam: torch.Tensor, x: torch.Tensor, *,
                 pack: Optional[_fmbe.FmbePack] = None) -> torch.Tensor:
    """(Q,) signed FMBE Ẑ; the (Q, P) features never reach device memory
    (``pack``: as ``kernels.fmbe.fmbe_z``)."""
    return _fmbe.fmbe_z(omega, degree, coef, lam, x, pack=pack)


# re-exported oracle for benches and tests
ivf_score_ref = _ivf.ivf_score_plain
