"""Scoring of probed IVF blocks (counterpart of ``repro.kernels.ivf_score``:
``ivf_score``, ``union_scores`` and ``ivf_decode``).

Each wrapper launches its CUDA kernel (``csrc/ivf_score.cu``,
``csrc/union_scores.cu``, ``csrc/ivf_decode.cu``) on CUDA tensors and runs
its plain version on CPU tensors. ``ivf_score`` writes every probed
block's scores per query. For the other two the contract is the TPU
kernels': union slots at or past
``head_live`` are skipped (``union_scores`` writes zeros there), cluster-pad
rows carry ``row_logw = NEG``, a score counts only where it is above NEG/2,
an empty head or tail gives a genuine ``-inf`` LSE, and the top-k is taken
over global slot ids ``block * br + row`` with the lowest id winning ties
and ``(NEG, 0)`` filling missing entries.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .topk_z import MAX_K, NEG, select_topk


def _masked_lse(eff: torch.Tensor) -> torch.Tensor:
    """m + log(s) over entries above NEG/2: -inf where there are none."""
    ok = eff > NEG * 0.5
    m = torch.where(ok, eff, torch.full_like(eff, NEG)).amax(-1, keepdim=True)
    s = torch.where(ok, torch.exp(eff - m), torch.zeros_like(eff)).sum(-1)
    return m[:, 0] + torch.log(s)


def _check(cond: bool, msg: str, name: str = "ivf_decode") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def ivf_score_plain(w_blocks, h, block_ids):
    """Plain PyTorch version of ``ivf_score``: f32 scores of every probed
    block of every query."""
    return torch.einsum("qd,qpbd->qpb", h.float(),
                        w_blocks[block_ids.long()].float())


@_build.counted
def ivf_score(w_blocks, h, block_ids):
    """Per-query gather-score of probed blocks.

      w_blocks  (nb, br, d)  block-IVF rows
      h         (Q, d)       query batch
      block_ids (Q, p) int32 probed block of each query; an id outside
                             [0, nb) gives NaN scores on the GPU

    Returns scores (Q, p, br) f32."""
    args = (w_blocks, h, block_ids)
    if all(t.device.type == "cpu" for t in args):
        return ivf_score_plain(*args)
    dev = h.device
    _check(all(t.device == dev for t in args) and dev.type == "cuda",
           "every input must be on one GPU", "ivf_score")
    is_f32 = _build.f32_flag("ivf_score", w_blocks=w_blocks, h=h)
    _check(block_ids.dtype == torch.int32, "block_ids must be int32",
           "ivf_score")
    nb, br, d = w_blocks.shape
    q = h.shape[0]
    _check(h.shape == (q, d) and block_ids.dim() == 2
           and block_ids.shape[0] == q, "shapes", "ivf_score")
    _check(all(t.is_contiguous() for t in args), "inputs not contiguous",
           "ivf_score")
    _check(d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (w_blocks, h)),
           "rows must be 16-byte aligned (d % 8 == 0)", "ivf_score")
    n_probe = block_ids.shape[1]
    _check(q >= 1 and n_probe >= 1 and br >= 1, "empty input", "ivf_score")
    lib = _build.load("ivf_score")
    out = torch.empty((q, n_probe, br), dtype=torch.float32, device=dev)
    p = ctypes.c_void_p
    err = lib.ivf_score_launch(
        *[p(t.data_ptr()) for t in args], q, n_probe, nb, br, d,
        p(out.data_ptr()), is_f32,
        p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check("ivf_score", err)
    _build.count(ivf_score, is_f32)
    return out


def union_scores_plain(w_blocks, h, head_ids, head_live):
    """Plain PyTorch version of ``union_scores``: f32 scores of every union
    slot, zeros at slots at or past ``head_live``."""
    scores = torch.einsum("qd,ubd->qub", h.float(),
                          w_blocks[head_ids.long()].float())
    live = torch.arange(head_ids.shape[0], device=h.device) < head_live
    return torch.where(live[None, :, None], scores,
                       torch.zeros_like(scores))


@_build.counted
def union_scores(w_blocks, h, head_ids, head_live):
    """Scores of a deduplicated block union for a whole query batch.

      w_blocks  (nb, br, d)  block-IVF rows
      h         (Q, d)       query batch
      head_ids  (U,) int32   sorted union of probed blocks (pad slots
                             repeat the last id)
      head_live () int32     number of real union slots, left on the
                             device (the kernel reads it; no host sync)

    Returns scores (Q, U, br) f32; slots at or past ``head_live`` are 0
    (callers mask them through the plan's membership)."""
    args = (w_blocks, h, head_ids, head_live)
    if all(t.device.type == "cpu" for t in args):
        return union_scores_plain(*args)
    out = union_launch(*args)
    _build.count(union_scores, _build.KERNEL_DTYPES[h.dtype])
    return out


def union_launch(w_blocks, h, head_ids, head_live, *, lib=None,
                 grid_x=None):
    """``union_scores``'s kernel on CUDA tensors, without its launch count.
    ``lib`` is the built library to call (default: the package's build of
    ``csrc/union_scores.cu``) and ``grid_x`` its grid (default:
    ``_build.stream_grid``); both are for timing variant builds."""
    args = (w_blocks, h, head_ids, head_live)
    dev = h.device
    _check(all(t.device == dev for t in args) and dev.type == "cuda",
           "every input must be on one GPU", "union_scores")
    is_f32 = _build.f32_flag("union_scores", w_blocks=w_blocks, h=h)
    _check(head_ids.dtype == torch.int32 and head_live.dtype == torch.int32,
           "head_ids and head_live must be int32", "union_scores")
    nb, br, d = w_blocks.shape
    q = h.shape[0]
    u = head_ids.shape[0]
    _check(h.shape == (q, d) and head_ids.shape == (u,)
           and head_live.numel() == 1, "shapes", "union_scores")
    _check(all(t.is_contiguous() for t in args), "inputs not contiguous",
           "union_scores")
    _check(d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (w_blocks, h)),
           "rows must be 16-byte aligned (d % 8 == 0)", "union_scores")
    _check(q >= 1 and u >= 1, "empty input", "union_scores")
    lib = _build.load("union_scores") if lib is None else lib
    grid_x = _build.stream_grid(dev) if grid_x is None else grid_x
    out = torch.empty((q, u, br), dtype=torch.float32, device=dev)
    p = ctypes.c_void_p
    err = lib.union_scores_launch(
        *[p(t.data_ptr()) for t in args], q, u, br, d, grid_x,
        p(out.data_ptr()), is_f32,
        p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check("union_scores", err)
    return out


def ivf_decode_plain(w_blocks, h, head_ids, head_live, head_member, row_logw,
                     tail_rows, tail_accept, *, k: int = 1):
    """Plain PyTorch version of ``ivf_decode`` (same arguments and outputs),
    scores accumulated in f32."""
    nb, br, d = w_blocks.shape
    q = h.shape[0]
    ids = head_ids.long()
    hf = h.float()
    scores = torch.einsum("qd,ubd->qub", hf, w_blocks[ids].float())
    scores = scores + row_logw[ids][None]
    live = torch.arange(ids.shape[0], device=h.device) < head_live
    keep = (head_member & live[None, :])[:, :, None]
    eff = torch.where(keep, scores, torch.full_like(scores, NEG)).reshape(q, -1)
    slot_ids = (ids[:, None] * br + torch.arange(br, device=h.device)
                ).reshape(-1)
    head_lse = _masked_lse(eff)
    topv, topi = select_topk(eff, slot_ids, k)
    ts = hf @ tail_rows.float().T
    teff = torch.where(tail_accept, ts, torch.full_like(ts, NEG))
    tail_lse = _masked_lse(teff)
    return head_lse, tail_lse, topv, topi


@_build.counted
def ivf_decode(w_blocks, h, head_ids, head_live, head_member, row_logw,
               tail_rows, tail_accept, *, k: int = 1):
    """Fused batched MIMPS decode.

      w_blocks    (nb, br, d)  block-IVF rows
      h           (Q, d)       query batch
      head_ids    (U,) int32   sorted union of probed blocks (pad slots
                               repeat the last id)
      head_live   () int32     number of real union slots, left on the
                               device (the kernel reads it; no host sync)
      head_member (Q, U) bool  query q probes union slot u
      row_logw    (nb, br) f32 0 for real rows, NEG for cluster-pad rows
      tail_rows   (l, d)       shared tail sample rows, staged dense
      tail_accept (Q, l) bool  sample j survives rejection for query q

    Returns (head_lse (Q,), tail_lse (Q,), topv (Q, k), topi (Q, k) int32
    global slot ids)."""
    args = (w_blocks, h, head_ids, head_live, head_member, row_logw,
            tail_rows, tail_accept)
    if all(t.device.type == "cpu" for t in args):
        return ivf_decode_plain(*args, k=k)
    dev = h.device
    _check(all(t.device == dev for t in args) and dev.type == "cuda",
           "every input must be on one GPU")
    is_f32 = _build.f32_flag("ivf_decode", w_blocks=w_blocks, h=h,
                          tail_rows=tail_rows)
    _check(head_ids.dtype == torch.int32 and head_live.dtype == torch.int32
           and row_logw.dtype == torch.float32
           and head_member.dtype == torch.bool
           and tail_accept.dtype == torch.bool, "index/mask dtypes")
    nb, br, d = w_blocks.shape
    q = h.shape[0]
    u = head_ids.shape[0]
    l = tail_rows.shape[0]
    _check(h.shape == (q, d) and head_ids.shape == (u,)
           and head_live.numel() == 1 and head_member.shape == (q, u)
           and row_logw.shape == (nb, br) and tail_rows.shape == (l, d)
           and tail_accept.shape == (q, l), "shapes")
    _check(all(t.is_contiguous() for t in args), "inputs not contiguous")
    _check(d % 8 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (w_blocks, h, tail_rows)),
           "rows must be 16-byte aligned (d % 8 == 0)")
    _check(1 <= k <= MAX_K, f"k={k} outside [1, {MAX_K}]")
    _check(q >= 1 and u >= 1 and l >= 1, "empty input")
    lib = _build.load("ivf_decode")
    grid_x = _build.stream_grid(dev)                 # one partial a CTA
    f32, i32 = torch.float32, torch.int32
    part = [torch.empty((q, grid_x), dtype=f32, device=dev) for _ in range(4)]
    part_v = torch.empty((q, grid_x, k), dtype=f32, device=dev)
    part_i = torch.empty((q, grid_x, k), dtype=i32, device=dev)
    head_lse = torch.empty((q,), dtype=f32, device=dev)
    tail_lse = torch.empty((q,), dtype=f32, device=dev)
    topv = torch.empty((q, k), dtype=f32, device=dev)
    topi = torch.empty((q, k), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = ctypes.c_void_p
    err = lib.ivf_decode_launch(
        *[p(t.data_ptr()) for t in args], q, u, br, d, l, k, grid_x,
        p(part[0].data_ptr()), p(part[1].data_ptr()), p(part_v.data_ptr()),
        p(part_i.data_ptr()), p(part[2].data_ptr()), p(part[3].data_ptr()),
        p(head_lse.data_ptr()), p(tail_lse.data_ptr()), p(topv.data_ptr()),
        p(topi.data_ptr()), is_f32, p(stream))
    _build.check("ivf_decode", err)
    _build.count(ivf_decode, is_f32)
    return head_lse, tail_lse, topv, topi
