"""Scoring of probed IVF blocks (counterpart of ``repro.kernels.ivf_score``:
``ivf_score``, ``union_scores`` and ``ivf_decode``).

Each wrapper launches its CUDA kernel (``csrc/ivf_score.cu``,
``csrc/union_scores.cu``, ``csrc/ivf_decode.cu``) on CUDA tensors and runs
its plain version on CPU tensors. ``ivf_score`` writes every probed
block's scores per query, deduplicating each query tile's probes on the
device first (``tile_unions_plain`` is that step's plain version). For the
other two the contract is the TPU kernels': union slots at or past
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

QT = 8                   # queries a CTA scores (gather_stream.cuh's QT)
MAX_BLOCKS = 1 << 19     # ivf_score's blocks: its prologue's bitmap, 128 KB


def _masked_lse(eff: torch.Tensor) -> torch.Tensor:
    """m + log(s) over entries above NEG/2: -inf where there are none, NaN
    where an entry is NaN (as the kernels' merge gives it)."""
    ok = eff > NEG * 0.5
    m = torch.where(ok, eff, torch.full_like(eff, NEG)).amax(-1, keepdim=True)
    s = torch.where(ok, torch.exp(eff - m), torch.zeros_like(eff)).sum(-1)
    lse = m[:, 0] + torch.log(s)
    return torch.where(eff.isnan().any(-1), torch.full_like(lse, float("nan")),
                       lse)


def _check(cond: bool, msg: str, name: str = "ivf_decode") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def ivf_score_plain(w_blocks, h, block_ids):
    """Plain PyTorch version of ``ivf_score``: f32 scores of every probed
    block of every query."""
    return torch.einsum("qd,qpbd->qpb", h.float(),
                        w_blocks[block_ids.long()].float())


def tile_unions_plain(block_ids, nb: int):
    """Plain version of ``ivf_score``'s prologue, which deduplicates the
    probes of each tile of ``QT`` queries. Per tile: the sorted union of its
    ids in [0, nb) in U = min(QT * p, nb) slots (pad slots repeat the last
    id; 0 if there is none), its live count, and for each slot and query of
    the tile the probe slots that name the block, as W = ceil(p / 32) int32
    words (bit j % 32 of word j // 32 for probe slot j; 0 at pad slots and
    absent queries).

    Returns (ids (T, U) int32, live (T,) int32, masks (T, U, QT, W) int32),
    T = ceil(Q / QT)."""
    q, p = block_ids.shape
    n_tiles, u, words = -(-q // QT), min(QT * p, nb), -(-p // 32)
    dev = block_ids.device
    ids = torch.zeros((n_tiles, u), dtype=torch.int32, device=dev)
    live = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    masks = torch.zeros((n_tiles, u, QT, words), dtype=torch.int64,
                        device=dev)
    for t in range(n_tiles):
        tb = block_ids[t * QT:(t + 1) * QT].long()
        ok = (tb >= 0) & (tb < nb)
        uniq = torch.unique(tb[ok])                         # sorted
        n = uniq.numel()
        live[t] = n
        if n == 0:
            continue
        ids[t, :n] = uniq.to(torch.int32)
        ids[t, n:] = int(uniq[-1])
        qi, pi = torch.nonzero(ok, as_tuple=True)
        slot = torch.searchsorted(uniq, tb[qi, pi])
        masks[t].index_put_((slot, qi, pi // 32), torch.bitwise_left_shift(
            torch.ones_like(pi), pi % 32), accumulate=True)   # distinct bits
    masks = torch.where(masks >= 2 ** 31, masks - 2 ** 32, masks)
    return ids, live, masks.to(torch.int32)


def scatter_tiles(tile_scores, masks, q: int, p: int):
    """``ivf_score``'s (q, p, br) output from each tile's union scores
    ``tile_scores`` (a list of (nq, U, br) f32, one a tile) and
    ``tile_unions_plain``'s masks: out[q, j] = the score of query q's slot
    whose mask holds probe slot j, and NaN rows where no mask holds it (an
    id outside [0, nb))."""
    br = tile_scores[0].shape[-1]
    out = torch.full((q, p, br), float("nan"), device=masks.device)
    shifts = torch.arange(32, device=masks.device)
    for t, scores in enumerate(tile_scores):
        nq = scores.shape[0]
        m = masks[t, :, :nq].long()                         # (U, nq, W)
        bits = (m[..., None] >> shifts) & 1
        slot, qi, j = torch.nonzero(
            bits.reshape(*m.shape[:2], -1)[..., :p], as_tuple=True)
        out[t * QT + qi, j] = scores[qi, slot]
    return out


def ivf_score_tiles_plain(w_blocks, h, block_ids):
    """``ivf_score`` as its kernels decompose it, in plain PyTorch: each
    tile's union (``tile_unions_plain``) scored once against the tile
    (``union_scores_plain``), each score written to every probe slot of its
    query's mask (``scatter_tiles``); NaN rows at ids outside [0, nb)."""
    nb = w_blocks.shape[0]
    ids, live, masks = tile_unions_plain(block_ids, nb)
    scores = [union_scores_plain(w_blocks, h[t * QT:(t + 1) * QT], ids[t],
                                 live[t]) for t in range(ids.shape[0])]
    return scatter_tiles(scores, masks, *block_ids.shape)


@_build.counted
def ivf_score(w_blocks, h, block_ids):
    """Per-query gather-score of probed blocks.

      w_blocks  (nb, br, d)  block-IVF rows
      h         (Q, d)       query batch
      block_ids (Q, p) int32 probed block of each query; an id outside
                             [0, nb) gives NaN scores on the GPU

    Returns scores (Q, p, br) f32. On the GPU each tile of ``QT`` queries
    reads each block its queries probe once (``score_launch``)."""
    args = (w_blocks, h, block_ids)
    if all(t.device.type == "cpu" for t in args):
        return ivf_score_plain(*args)
    out = score_launch(*args)[0]
    _build.count(ivf_score, _build.KERNEL_DTYPES[h.dtype])
    return out


def score_launch(w_blocks, h, block_ids):
    """``ivf_score``'s kernels on CUDA tensors, without its launch count:
    the prologue, which writes ``tile_unions_plain``'s three tensors on the
    device, and the scores it feeds. Returns (scores (Q, p, br) f32, ids,
    live, masks), the last three as ``tile_unions_plain`` gives them."""
    args = (w_blocks, h, block_ids)
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
    _check(nb <= MAX_BLOCKS, f"nb={nb} exceeds MAX_BLOCKS={MAX_BLOCKS} "
           "(the prologue's bitmap of the blocks)", "ivf_score")
    lib = _build.load("ivf_score")
    n_tiles, u, words = -(-q // QT), min(QT * n_probe, nb), -(-n_probe // 32)
    i32 = torch.int32
    ids = torch.empty((n_tiles, u), dtype=i32, device=dev)
    live = torch.empty((n_tiles,), dtype=i32, device=dev)
    masks = torch.empty((n_tiles, u, QT, words), dtype=i32, device=dev)
    out = torch.empty((q, n_probe, br), dtype=torch.float32, device=dev)
    p = ctypes.c_void_p
    err = lib.ivf_score_launch(
        *[p(t.data_ptr()) for t in args], q, n_probe, nb, br, d, u, words,
        _build.stream_grid(dev), p(ids.data_ptr()), p(live.data_ptr()),
        p(masks.data_ptr()), p(out.data_ptr()), is_f32,
        p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check("ivf_score", err)
    return out, ids, live, masks


def union_scores_plain(w_blocks, h, head_ids, head_live):
    """Plain PyTorch version of ``union_scores``: f32 scores of every union
    slot, zeros at slots at or past ``head_live``."""
    scores = torch.einsum("qd,ubd->qub", h.float(),
                          w_blocks[head_ids.long()].float())
    live = torch.arange(head_ids.shape[0], device=h.device) < head_live
    return torch.where(live[None, :, None], scores,
                       torch.zeros_like(scores))


@_build.counted
def union_scores(w_blocks, h, head_ids, head_live, *, grid_x=None):
    """Scores of a deduplicated block union for a whole query batch.

      w_blocks  (nb, br, d)  block-IVF rows
      h         (Q, d)       query batch
      head_ids  (U,) int32   sorted union of probed blocks (pad slots
                             repeat the last id)
      head_live () int32     number of real union slots, left on the
                             device (the kernel reads it; no host sync)

    Returns scores (Q, U, br) f32; slots at or past ``head_live`` are 0
    (callers mask them through the plan's membership). ``grid_x`` is the
    launch knob (``kernels.autotune``; None gives the default launch); CPU
    tensors ignore it."""
    args = (w_blocks, h, head_ids, head_live)
    if all(t.device.type == "cpu" for t in args):
        return union_scores_plain(*args)
    out = union_launch(*args, grid_x=grid_x)
    _build.count(union_scores, _build.KERNEL_DTYPES[h.dtype])
    return out


def union_launch(w_blocks, h, head_ids, head_live, *, lib=None,
                 grid_x=None):
    """``union_scores``'s kernel on CUDA tensors, without its launch count.
    ``lib`` is the built library to call (default: the package's build of
    ``csrc/union_scores.cu``, for timing variant builds) and ``grid_x`` its
    grid (default: ``_build.stream_grid``)."""
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
    grid_x = _build.grid_knob("union_scores", dev, grid_x)
    lib = _build.load("union_scores") if lib is None else lib
    out = torch.empty((q, u, br), dtype=torch.float32, device=dev)
    p = ctypes.c_void_p
    err = lib.union_scores_launch(
        *[p(t.data_ptr()) for t in args], q, u, br, d, grid_x,
        p(out.data_ptr()), is_f32,
        p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check("union_scores", err)
    return out


def stream_geometry(kernel: str, d: int, dtype: torch.dtype, *, u: int = 0,
                    l: int = 0, grid_x: int = 0) -> dict:
    """The ring geometry ``gather_stream.cuh``'s ``layout`` picks on the
    host for ``kernel`` at row width ``d``: "ivf_decode" at ``u`` union
    slots, ``l`` tail rows and ``grid_x`` CTAs, or "union_scores" (whose
    rows ``ivf_score`` shares). Returns {rows a stage, stages, row pitch
    and dynamic shared memory in bytes}; launches nothing, but builds and
    loads the kernel's library, so it needs the GPU toolchain."""
    if kernel not in ("ivf_decode", "union_scores"):
        raise ValueError(f"no ring geometry query for {kernel!r}")
    f32 = _build.KERNEL_DTYPES[dtype]
    out = (ctypes.c_int * 4)()
    lib = _build.load(kernel)
    if kernel == "ivf_decode":
        err = lib.ivf_decode_geometry(u, l, d, grid_x, f32, out)
    else:
        err = lib.union_scores_geometry(d, f32, out)
    _build.check(f"{kernel} geometry", err)
    return dict(zip(("rows", "stages", "pitch", "smem"), out))


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
               tail_rows, tail_accept, *, k: int = 1, grid_x=None):
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
    global slot ids). ``grid_x`` (None: ``_build.stream_grid``) is the
    launch knob (``kernels.autotune``); another grid splits the rows
    otherwise, so the f32 partials may merge in another order. CPU tensors
    ignore it."""
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
    grid_x = _build.grid_knob("ivf_decode", dev, grid_x)
    lib = _build.load("ivf_decode")                  # one partial a CTA
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
