"""Streaming fused cross-entropy over the vocabulary (counterpart of
``repro.kernels.fused_ce``): the training-time form of the normaliser,
computed without writing the [T, V] logits to device memory.

``fused_ce_fwd`` and ``fused_ce_bwd`` launch CUDA kernels on CUDA tensors
and run ``fused_ce_fwd_plain`` / ``fused_ce_bwd_plain`` on CPU tensors. On
the GPU they dispatch on the inputs' dtype, with no other route. The
forward runs ``csrc/fused_ce_fwd.cu`` and the backward
``csrc/fused_ce_bwd.cu``, both on the tensor cores at both dtypes: bf16
operands as they are, f32 ones as three exact bf16 planes each
(``split_planes``), whose six largest plane products (``PAIRS``) sum to an
f32-accurate product (``fused_ce_fwd_planes_plain`` is the forward's
decomposition in plain PyTorch). At f32 no tensor-core sum is deeper than
``F32_MAX_DEPTH``, so d is at most that. Both keep the TPU kernels'
contract: scores accumulate in f32, a
label outside [0, V) leaves the label score at NEG (so its nll is about
1e30, not NaN), and the backward rounds its coefficient ``coef = (g_nll +
g_lse) p - g_nll onehot`` to the inputs' dtype before both products (a
no-op at f32, where the coefficient is split into planes instead),
accumulating dh and dW in f32.

The backward walks the vocabulary in chunks of ``C`` columns
(``bwd_schedule``): the chunk's coefficient is computed once into a
(planes, T, C) bf16 scratch buffer, then feeds the chunk's dW rows and
adds to dh. At f32 it does so for each slice of at most ``F32_MAX_DEPTH``
tokens in turn (``token_slices``), adding each slice's dW to the earlier
slices' in f32. ``fused_ce_bwd_chunked_plain`` is that decomposition in
plain PyTorch, planes included.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
from typing import Dict, List, Tuple

import torch

from . import _build

NEG = -1e30

# tiles of csrc/hopper_gemm.cuh
BM = 128             # rows of an output tile
BN = 128             # columns of an output tile
BK = 64              # depth of a pipeline stage
SCRATCH_BYTES = 32 << 20   # the backward's (planes, T, C) coefficient buffer
# f32: the most terms K of one tensor-core sum, both dh's (the columns of a
# chunk) and dW's (the tokens of a slice). Those sums lose low bits at each
# 16-deep step with a bias that grows with K (on the card: dh's mean error
# about 4e-10 of its terms a column of K)
F32_MAX_DEPTH = 8192
# bf16 planes of an operand of the backward, by input dtype
PLANES = {torch.bfloat16: 1, torch.float32: 3}
# the plane pairs (i, j) of a three-plane product, in the kernel's order:
# terms of order 2**-16 of |a||b| first, (0, 0) last, each over all of K
PAIRS = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))


def fused_ce_fwd_plain(h: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: h (T, d), w (V, d), labels (T,) -> (nll (T,),
    lse (T,)), both f32, from the full f32 logits."""
    return _nll_lse(h.float() @ w.float().T, labels)


def fused_ce_fwd_planes_plain(h: torch.Tensor, w: torch.Tensor,
                              labels: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 forward kernel's decomposition in plain PyTorch: the logits
    as ``plane_product`` of ``split_planes`` of h and of w, then the LSE and
    the label's score as in ``fused_ce_fwd_plain``. For tests and
    ``chip_smoke.py``, never on the main path."""
    return _nll_lse(plane_product(split_planes(h),
                                  [x.T for x in split_planes(w)]), labels)


def _nll_lse(logits, labels):
    """(nll, lse) of f32 (T, V) logits; a label outside [0, V) leaves the
    label score at NEG."""
    lse = torch.logsumexp(logits, dim=-1)
    v = logits.shape[1]
    lab = labels.long()
    ok = (lab >= 0) & (lab < v)
    picked = torch.gather(logits, 1, lab.clamp(0, v - 1)[:, None])[:, 0]
    picked = torch.where(ok, picked, torch.full_like(picked, NEG))
    return lse - picked, lse


def ce_coef(h, w, labels, lse, g_nll, g_lse) -> torch.Tensor:
    """The backward's (T, V) f32 coefficient ``(g_nll + g_lse) softmax -
    g_nll onehot(labels)``, before rounding (plain PyTorch)."""
    logits = h.float() @ w.float().T
    coef = torch.exp(logits - lse.float()[:, None]) \
        * (g_nll + g_lse).float()[:, None]
    v = w.shape[0]
    lab = labels.long()
    hit = torch.where((lab >= 0) & (lab < v), -g_nll.float(), 0.0)
    return coef.scatter_add_(1, lab.clamp(0, v - 1)[:, None], hit[:, None])


def split_planes(x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three bf16 planes of finite f32 ``x`` with x0 + x1 + x2 == x exactly
    (summed in f32, in that order, bit for bit): x0 = bf16(x), x1 =
    bf16(x - x0), x2 = bf16(x - x0 - x1), each rounded to nearest. A zero
    residual takes the sign of x, so that -0 comes back as -0. The split
    kernel of ``csrc/fused_ce_bwd.cu`` computes the same bits."""
    x = x.float()
    zero = torch.copysign(torch.zeros_like(x), x)
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    r = torch.where(r == 0, zero, r)
    x1 = r.to(torch.bfloat16)
    r = r - x1.float()
    return x0, x1, torch.where(r == 0, zero, r).to(torch.bfloat16)


def plane_product(a, b) -> torch.Tensor:
    """sum over ``PAIRS`` (i, j) of a[i] @ b[j] in f32, for the three bf16
    planes ``a`` (M, K) and ``b`` (K, N) of two f32 operands: the dropped
    pairs are of order 2**-24 of |a||b|."""
    out = None
    for i, j in PAIRS:
        term = a[i].float() @ b[j].float()
        out = term if out is None else out + term
    return out


def fused_ce_bwd_plain(h, w, labels, lse, g_nll, g_lse, *, cast=True):
    """Plain PyTorch version of the backward: (dh (T, d), dw (V, d)) in
    h.dtype / w.dtype, or the f32 accumulators with ``cast=False``."""
    coef = ce_coef(h, w, labels, lse, g_nll, g_lse)
    dh = coef.to(w.dtype).float() @ w.float()
    dw = coef.to(h.dtype).float().T @ h.float()
    if cast:
        return dh.to(h.dtype), dw.to(w.dtype)
    return dh, dw


def fused_ce_bwd_chunked_plain(h, w, labels, lse, g_nll, g_lse, *,
                               cast=True, chunk=None, depth=None):
    """The backward kernel's decomposition in plain PyTorch: for each token
    slice in order (``token_slices``; ``depth`` tokens at most, default
    F32_MAX_DEPTH at f32), for each chunk of ``chunk`` vocab rows in order
    (default: ``bwd_schedule``'s C for the slice), the chunk's coefficient
    rounded to the inputs' dtype, the chunk's dW rows written by the first
    slice and added to by the others, and dh accumulated in f32 in chunk
    order. At f32 every product is ``plane_product`` of ``split_planes`` of
    its operands: h once a slice, each chunk of w, and the chunk's
    coefficient unrounded. For tests and ``chip_smoke.py``."""
    t, d = h.shape
    v = w.shape[0]
    dh = torch.zeros((t, d), dtype=torch.float32, device=h.device)
    dw = torch.zeros((v, d), dtype=torch.float32, device=h.device)
    for t0, t1 in token_slices(t, h.dtype, depth):
        part = slice(t0, t1)
        dh[part] = _chunked_slice(
            h[part], w, labels[part], lse[part], g_nll[part], g_lse[part], dw,
            chunk or bwd_schedule(t1 - t0, v, h.dtype)["chunk"])
    if cast:
        return dh.to(h.dtype), dw.to(w.dtype)
    return dh, dw


def _chunked_slice(h, w, labels, lse, g_nll, g_lse, dw, chunk):
    """One token slice of ``fused_ce_bwd_chunked_plain``: adds the slice's
    dW rows to ``dw`` chunk by chunk and returns its f32 dh."""
    t, d = h.shape
    v = w.shape[0]
    planes = h.dtype == torch.float32
    hf = h.float()
    hp = split_planes(h) if planes else None
    lab = labels.long()
    gn = (g_nll + g_lse).float()[:, None]
    dh = torch.zeros((t, d), dtype=torch.float32, device=h.device)
    rows = torch.arange(t, device=h.device)
    for c0 in range(0, v, chunk):
        wc = w[c0:c0 + chunk].float()
        if planes:
            wp = split_planes(wc)
            scores = plane_product(hp, [x.T for x in wp])
        else:
            scores = hf @ wc.T
        coef = torch.exp(scores - lse.float()[:, None]) * gn
        hit = (lab >= c0) & (lab < c0 + wc.shape[0])
        coef[rows[hit], lab[hit] - c0] -= g_nll.float()[hit]
        if planes:
            cp = split_planes(coef)
            dw[c0:c0 + wc.shape[0]] += plane_product([x.T for x in cp], hp)
            dh += plane_product(cp, wp)
        else:
            dw[c0:c0 + wc.shape[0]] += coef.to(h.dtype).float().T @ hf
            dh += coef.to(w.dtype).float() @ wc
    return dh


def fwd_schedule(t: int, v: int, sms: int) -> Dict[str, int]:
    """The forward kernel's work: units of (128-token tile, vocab split),
    about two a CTA, each split ``per`` 128-column vocab tiles; each unit
    leaves two partials (one per consumer warpgroup)."""
    n_tt, n_vt = -(-t // BM), -(-v // BN)
    n_split = max(1, min(n_vt, -(-2 * sms // n_tt)))
    per = -(-n_vt // n_split)
    n_split = -(-n_vt // per)
    return dict(n_tt=n_tt, n_vt=n_vt, n_split=n_split, per=per,
                n_part=2 * n_split, grid=min(sms, n_tt * n_split))


def grad_items(t: int, d: int, valid: int) -> List[int]:
    """Stages of each item of a chunk's dh + dW launch, by item id: the dh
    items (token tile fastest, then d tile; K = the chunk's ``valid``
    columns), then the dW items (d tile fastest, then vocab tile; K = T),
    as the kernel decodes them. At f32 every item runs each of its stages
    once for each of the six ``PAIRS``: all costs scale by 6, so the deal
    (``grad_order``) is the same, and these counts serve both dtypes."""
    n_tt, n_dt = -(-t // BM), -(-d // BN)
    return ([-(-valid // BK)] * (n_tt * n_dt)
            + [-(-t // BK)] * (-(-valid // BM) * n_dt))


@functools.lru_cache(maxsize=16)
def grad_order(t: int, d: int, valid: int, sms: int,
               longest_first: bool = True
               ) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                          Tuple[int, ...]]:
    """Deals a chunk's dh + dW items to min(sms, items) CTAs: longest first,
    each to the least loaded CTA (the lowest index on a tie), or with
    ``longest_first=False`` round-robin in item order, as a strided loop
    would walk them. Returns (order: the item ids CTA by CTA, start: CTA b
    takes order[start[b]:start[b + 1]], loads: each CTA's stages)."""
    cost = grad_items(t, d, valid)
    n_cta = min(sms, len(cost))
    lists = [[] for _ in range(n_cta)]
    if longest_first:
        heap = [(0, b) for b in range(n_cta)]
        for p in sorted(range(len(cost)), key=lambda p: (-cost[p], p)):
            load, b = heapq.heappop(heap)
            lists[b].append(p)
            heapq.heappush(heap, (load + cost[p], b))
    else:
        for p in range(len(cost)):
            lists[p % n_cta].append(p)
    start = [0]
    for ids in lists:
        start.append(start[-1] + len(ids))
    loads = tuple(sum(cost[p] for p in ids) for ids in lists)
    return tuple(p for ids in lists for p in ids), tuple(start), loads


def token_slices(t: int, dtype=torch.bfloat16, depth: int = None
                 ) -> List[Tuple[int, int]]:
    """The backward's token slices (t0, t1), in order: all of T at bf16;
    at f32 as few slices as keep each within ``depth`` tokens (default
    F32_MAX_DEPTH: dW's depth in one tensor-core sum), of one size but for
    a shorter last one."""
    if dtype != torch.float32:
        return [(0, t)]
    n = -(-t // (depth or F32_MAX_DEPTH))
    step = -(-t // n)
    return [(t0, min(t, t0 + step)) for t0 in range(0, t, step)]


def bwd_schedule(t: int, v: int, dtype=torch.bfloat16) -> Dict[str, int]:
    """The backward kernel's chunks for T tokens (a token slice at f32):
    ``chunk`` vocab columns each, a multiple of the kernel's 128-column
    tile, the largest whose (planes, T, C) bf16 coefficient scratch (2
    bytes an element at bf16, 6 at f32) stays within SCRATCH_BYTES, at
    least one tile, and at f32 at most F32_MAX_DEPTH."""
    size = 2 * PLANES[dtype]
    fit = SCRATCH_BYTES // (size * t) // BN * BN
    if dtype == torch.float32:
        fit = min(fit, F32_MAX_DEPTH)
    chunk = min(max(BN, fit), -(-v // BN) * BN)
    return dict(chunk=chunk, n_chunks=-(-v // chunk),
                scratch_bytes=size * t * chunk)


@functools.lru_cache(maxsize=16)
def _device_order(t, d, valid, sms, longest_first, dev):
    """``grad_order``'s lists as int32 tensors on ``dev``, with the CTA
    count."""
    order, start, _ = grad_order(t, d, valid, sms, longest_first)
    return (torch.tensor(order, dtype=torch.int32, device=dev),
            torch.tensor(start, dtype=torch.int32, device=dev),
            len(start) - 1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_ce: {msg}")


def _check_inputs(h, w, labels, *vectors) -> int:
    """Checks the inputs; returns the kernels' f32 flag (1: the f32 pair,
    0: the bf16 pair)."""
    _check(h.is_cuda and w.is_cuda and h.device == w.device,
           f"h on {h.device} and w on {w.device}: both must be on one GPU")
    f32 = _build.f32_flag("fused_ce", h=h, w=w)
    _check(h.dim() == 2 and w.dim() == 2 and h.shape[1] == w.shape[1],
           f"shapes h {tuple(h.shape)} w {tuple(w.shape)}")
    _check(h.is_contiguous() and w.is_contiguous(), "inputs not contiguous")
    t, d = h.shape
    _check(t >= 1 and w.shape[0] >= 1, "empty input")
    width = 4 if f32 else 32
    _check(d % width == 0 and h.data_ptr() % 16 == 0
           and w.data_ptr() % 16 == 0,
           f"d={d}: rows must be a multiple of {width} wide and 16-byte "
           f"aligned")
    _check(not f32 or d <= F32_MAX_DEPTH,
           f"f32 d={d} exceeds F32_MAX_DEPTH={F32_MAX_DEPTH}, the deepest "
           f"tensor-core sum the f32 scores take")
    for x in (labels,) + vectors:
        _check(x.device == h.device and tuple(x.shape) == (t,),
               f"per-token input of shape {tuple(x.shape)} on {x.device}, "
               f"want ({t},) on {h.device}")
    return f32


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@_build.counted
def fused_ce_fwd(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (T, d), w (V, d), labels (T,) -> (nll (T,) f32, lse (T,) f32).

    CUDA tensors launch the kernels on the current stream (h and w both
    bf16, or both f32 and then as three bf16 planes each; f32
    accumulation); CPU tensors run ``fused_ce_fwd_plain``."""
    if h.device.type == "cpu" and w.device.type == "cpu":
        return fused_ce_fwd_plain(h, w, labels)
    nll, lse, _ = fwd_launch(h, w, labels)
    _build.count(fused_ce_fwd, int(h.dtype == torch.float32))
    return nll, lse


def fwd_launch(h, w, labels, *, lib=None):
    """``fused_ce_fwd``'s kernels on CUDA tensors, without its launch
    count: (nll, lse, planes). f32 inputs are first split by the ``ce_split``
    kernel into (3, T, dp) planes of h and (3, V, dp) planes of w, dp = d
    rounded up to 64 columns; ``planes`` is that pair, for holding the split
    to ``split_planes``, and None at bf16. ``lib`` is the built library to
    launch (default: the package's ``csrc/fused_ce_fwd.cu``), for tools."""
    is_f32 = _check_inputs(h, w, labels)
    t, d = h.shape
    v = w.shape[0]
    dev = h.device
    lab = labels.to(torch.int32).contiguous()
    f32 = torch.float32
    nll = torch.empty((t,), dtype=f32, device=dev)
    lse = torch.empty((t,), dtype=f32, device=dev)
    sch = fwd_schedule(t, v, _sms(dev))
    part = torch.empty((3, sch["n_part"], t), dtype=f32, device=dev)
    p = ctypes.c_void_p
    planes, ptrs = None, [p(None)] * 2
    if is_f32:
        dp = planes_width(d)
        planes = tuple(torch.empty((3, n, dp), dtype=torch.bfloat16,
                                   device=dev) for n in (t, v))
        ptrs = [p(x.data_ptr()) for x in planes]
    lib = _build.load("fused_ce_fwd") if lib is None else lib
    err = lib.fused_ce_fwd_launch(
        p(h.data_ptr()), p(w.data_ptr()), p(lab.data_ptr()), t, v, d,
        sch["n_split"], sch["per"], sch["grid"], p(part[0].data_ptr()),
        p(part[1].data_ptr()), p(part[2].data_ptr()), p(nll.data_ptr()),
        p(lse.data_ptr()), *ptrs, int(is_f32),
        p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check("fused_ce_fwd", err)
    return nll, lse, planes


@_build.counted
def fused_ce_bwd(h, w, labels, lse, g_nll, g_lse, *, cast=True):
    """(dh (T, d), dw (V, d)) of ``g_nll . nll + g_lse . lse``, in h.dtype /
    w.dtype, or the f32 accumulators before that cast with ``cast=False``
    (the same tensors at f32).

    CUDA tensors launch the kernels on the current stream, chunk by chunk
    (``bwd_schedule``): the chunk's coefficient (rounded to bf16, or split
    into three bf16 planes at f32) into a scratch buffer, then the chunk's
    dW rows (written once, in the output dtype) and its share of dh,
    accumulated in f32 in chunk order; no float atomics, so two calls are
    bit-equal. CPU tensors run ``fused_ce_bwd_plain``."""
    if h.device.type == "cpu" and w.device.type == "cpu":
        return fused_ce_bwd_plain(h, w, labels, lse, g_nll, g_lse, cast=cast)
    out = bwd_launch(h, w, labels, lse, g_nll, g_lse, cast=cast)
    _build.count(fused_ce_bwd, int(h.dtype == torch.float32))
    return out


def planes_width(d: int) -> int:
    """Columns of a plane: d rounded up to whole 64-column TMA boxes."""
    return -(-d // BK) * BK


def bwd_launch(h, w, labels, lse, g_nll, g_lse, *, cast=True,
               longest_first=True, lib=None, depth=None):
    """``fused_ce_bwd``'s kernels on CUDA tensors, without its launch
    count. ``longest_first=False`` deals the dh and dW items round-robin
    instead (``grad_order``), for timing the two deals against each other;
    the results are the same bits either way. f32 inputs take the
    three-plane route of the same kernels, once for each token slice
    (``token_slices``): the slice of h split into (3, T, dp) planes, each
    chunk of w into (3, C, dp) before the chunk's coefficient, dp = d
    rounded up to 64 columns, and the slice's dW added to the earlier
    slices'. ``depth`` sets the most tokens a slice (default
    F32_MAX_DEPTH), and ``lib`` the built library to launch (default: the
    package's ``csrc/fused_ce_bwd.cu``); both are for tests and tools."""
    is_f32 = _check_inputs(h, w, labels, lse, g_nll, g_lse)
    t, d = h.shape
    v = w.shape[0]
    dev = h.device
    f32 = torch.float32
    lab = labels.to(torch.int32).contiguous()
    lse32 = lse.to(f32).contiguous()
    gn = (g_nll.to(f32) + g_lse.to(f32)).contiguous()
    go = g_nll.to(f32).contiguous()
    cast = cast and not is_f32
    out = h.dtype if cast else f32
    dh32 = torch.empty((t, d), dtype=f32, device=dev)
    dh = torch.empty((t, d), dtype=out, device=dev) if cast else dh32
    dw = torch.empty((v, d), dtype=out, device=dev)
    lib = _build.load("fused_ce_bwd") if lib is None else lib
    for t0, t1 in token_slices(t, h.dtype, depth):
        part = slice(t0, t1)
        _launch_slice(lib, h[part], w, lab[part], lse32[part], gn[part],
                      go[part], dh32[part], dh[part], dw, cast, t0 > 0,
                      longest_first)
    return dh, dw


def _launch_slice(lib, h, w, lab, lse32, gn, go, dh32, dh, dw, cast, dw_add,
                  longest_first):
    """One launch of the backward over the tokens of ``h`` (a slice at
    f32): dh32/dh are the slice's rows; dW is written, or added to with
    ``dw_add``."""
    t, d = h.shape
    v = w.shape[0]
    dev = h.device
    is_f32 = h.dtype == torch.float32
    bf16 = torch.bfloat16
    sch = bwd_schedule(t, v, h.dtype)
    sms = _sms(dev)
    scratch = torch.empty((PLANES[h.dtype], t, sch["chunk"]), dtype=bf16,
                          device=dev)
    if is_f32:
        dp = planes_width(d)
        h_planes = torch.empty((3, t, dp), dtype=bf16, device=dev)
        w_planes = torch.empty((3, sch["chunk"], dp), dtype=bf16, device=dev)
    last = v - (sch["n_chunks"] - 1) * sch["chunk"]
    lists = [_device_order(t, d, valid, sms, longest_first, dev)
             for valid in (sch["chunk"], last)]
    p = ctypes.c_void_p
    err = lib.fused_ce_bwd_launch(
        p(h.data_ptr()), p(w.data_ptr()), p(lab.data_ptr()),
        p(lse32.data_ptr()), p(gn.data_ptr()), p(go.data_ptr()), t, v, d,
        sch["chunk"], sms, int(cast), int(dw_add),
        *[x for o, st, g in lists for x in (p(o.data_ptr()),
                                            p(st.data_ptr()), g)],
        p(scratch.data_ptr()), p(dh32.data_ptr()), p(dh.data_ptr()),
        p(dw.data_ptr()), p(h_planes.data_ptr() if is_f32 else None),
        p(w_planes.data_ptr() if is_f32 else None), int(is_f32),
        p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check("fused_ce_bwd", err)


def planes_launch(x: torch.Tensor, rows: int = None) -> torch.Tensor:
    """The backward's split kernel alone on a CUDA f32 (R, d) tensor, d a
    multiple of 4: (3, rows, dp) bf16 planes, ``split_planes`` of x in the
    first R rows and d columns and zeros past them (rows defaults to R).
    The backward runs this kernel inside ``fused_ce_bwd``; this entry is for
    holding it to ``split_planes`` and timing it, and counts no launch."""
    r, d = x.shape
    rows = r if rows is None else rows
    _check(x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
           and d % 4 == 0 and x.data_ptr() % 16 == 0 and rows >= r,
           f"split: want a contiguous 16-byte aligned CUDA f32 (R, d), d a "
           f"multiple of 4, rows >= R; got {x.dtype} {tuple(x.shape)} on "
           f"{x.device}, rows {rows}")
    dp = planes_width(d)
    out = torch.empty((3, rows, dp), dtype=torch.bfloat16, device=x.device)
    err = _build.load("fused_ce_bwd").ce_split_launch(
        ctypes.c_void_p(x.data_ptr()), r, d, rows, dp,
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check("ce_split", err)
    return out
