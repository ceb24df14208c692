"""Streaming fused cross-entropy over the vocabulary (counterpart of
``repro.kernels.fused_ce``): the training-time form of the normaliser,
computed without writing the [T, V] logits to device memory.

``fused_ce_fwd`` and ``fused_ce_bwd`` launch the CUDA kernels in
``csrc/fused_ce_fwd.cu`` and ``csrc/fused_ce_bwd.cu`` on CUDA tensors and
run ``fused_ce_fwd_plain`` / ``fused_ce_bwd_plain`` on CPU tensors. Both
keep the TPU kernels' contract: scores accumulate in f32, a label outside
[0, V) leaves the label score at NEG (so its nll is about 1e30, not NaN),
and the backward rounds its coefficient ``coef = (g_nll + g_lse) p -
g_nll onehot`` to the inputs' dtype before both products, accumulating dh
and dW in f32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

NEG = -1e30

# tile sizes shared with csrc/fused_ce_tile.cuh
BX = 64          # rows of h (forward, dh) or of w (dW) a CTA owns
BY = 128         # width of one score sub-tile
CHUNK = 1024     # coefficient columns a backward CTA keeps in shared memory
FWD_CTAS = 24    # forward CTAs per SM aimed at (3 resident, about 8 waves)
BWD_CTAS = 8     # dh CTAs per SM aimed at (1 resident, about 8 waves)


def fused_ce_fwd_plain(h: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: h (T, d), w (V, d), labels (T,) -> (nll (T,),
    lse (T,)), both f32, from the full f32 logits."""
    logits = h.float() @ w.float().T
    lse = torch.logsumexp(logits, dim=-1)
    v = w.shape[0]
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


def fused_ce_bwd_plain(h, w, labels, lse, g_nll, g_lse, *, cast=True):
    """Plain PyTorch version of the backward: (dh (T, d), dw (V, d)) in
    h.dtype / w.dtype, or the f32 accumulators with ``cast=False``."""
    coef = ce_coef(h, w, labels, lse, g_nll, g_lse)
    dh = coef.to(w.dtype).float() @ w.float()
    dw = coef.to(h.dtype).float().T @ h.float()
    if cast:
        return dh.to(h.dtype), dw.to(w.dtype)
    return dh, dw


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_ce: {msg}")


def _check_inputs(h, w, labels, *vectors):
    _check(h.is_cuda and w.is_cuda and h.device == w.device,
           f"h on {h.device} and w on {w.device}: both must be on one GPU")
    _check(h.dtype == torch.bfloat16 and w.dtype == torch.bfloat16,
           f"kernel takes bf16, got h {h.dtype} and w {w.dtype}")
    _check(h.dim() == 2 and w.dim() == 2 and h.shape[1] == w.shape[1],
           f"shapes h {tuple(h.shape)} w {tuple(w.shape)}")
    _check(h.is_contiguous() and w.is_contiguous(), "inputs not contiguous")
    t, d = h.shape
    _check(t >= 1 and w.shape[0] >= 1, "empty input")
    _check(d % 32 == 0 and h.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
           f"d={d}: rows must be a multiple of 32 wide and 16-byte aligned")
    for x in (labels,) + vectors:
        _check(x.device == h.device and tuple(x.shape) == (t,),
               f"per-token input of shape {tuple(x.shape)} on {x.device}, "
               f"want ({t},) on {h.device}")


def _splits(n_rows: int, n_cols: int, unit: int, target: int):
    """Split ``n_cols`` columns into ranges of whole ``unit``s so that about
    ``target`` CTAs run over ``ceil(n_rows / BX)`` row tiles.
    Returns (n_split, cols_per_split)."""
    n_units = -(-n_cols // unit)
    n_x = -(-n_rows // BX)
    n_split = max(1, min(n_units, -(-target // n_x)))
    per = -(-n_units // n_split) * unit
    return -(-n_cols // per), per


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_ce_fwd(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (T, d), w (V, d), labels (T,) -> (nll (T,) f32, lse (T,) f32).

    CUDA tensors launch the kernel (bf16 inputs, f32 accumulation) on the
    current stream; CPU tensors run ``fused_ce_fwd_plain``."""
    if h.device.type == "cpu" and w.device.type == "cpu":
        return fused_ce_fwd_plain(h, w, labels)
    _check_inputs(h, w, labels)
    t, d = h.shape
    v = w.shape[0]
    dev = h.device
    lab = labels.to(torch.int32).contiguous()
    n_split, per = _splits(t, v, BY, FWD_CTAS * _sms(dev))
    f32 = torch.float32
    part = torch.empty((3, n_split, t), dtype=f32, device=dev)
    nll = torch.empty((t,), dtype=f32, device=dev)
    lse = torch.empty((t,), dtype=f32, device=dev)
    lib = _build.load("fused_ce_fwd")
    p = ctypes.c_void_p
    err = lib.fused_ce_fwd_launch(
        p(h.data_ptr()), p(w.data_ptr()), p(lab.data_ptr()), t, v, d,
        n_split, per, p(part[0].data_ptr()), p(part[1].data_ptr()),
        p(part[2].data_ptr()), p(nll.data_ptr()), p(lse.data_ptr()),
        p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check("fused_ce_fwd", err)
    fused_ce_fwd.launches += 1
    return nll, lse


fused_ce_fwd.launches = 0


def fused_ce_bwd(h, w, labels, lse, g_nll, g_lse, *, cast=True):
    """(dh (T, d), dw (V, d)) of ``g_nll . nll + g_lse . lse``, in h.dtype /
    w.dtype, or the f32 accumulators before that cast with ``cast=False``.

    CUDA tensors launch the kernels on the current stream: a dh pass whose
    CTAs own a token tile and a vocab split, a fixed-order sum of the
    splits, and a dW pass whose CTAs own a vocab tile; no float atomics, so
    two calls are bit-equal. CPU tensors run ``fused_ce_bwd_plain``."""
    if h.device.type == "cpu" and w.device.type == "cpu":
        return fused_ce_bwd_plain(h, w, labels, lse, g_nll, g_lse, cast=cast)
    _check_inputs(h, w, labels, lse, g_nll, g_lse)
    t, d = h.shape
    v = w.shape[0]
    dev = h.device
    f32 = torch.float32
    lab = labels.to(torch.int32).contiguous()
    lse32 = lse.to(f32).contiguous()
    gn = (g_nll.to(f32) + g_lse.to(f32)).contiguous()
    go = g_nll.to(f32).contiguous()
    n_split, v_per = _splits(t, v, CHUNK, BWD_CTAS * _sms(dev))
    t_pad = -(-t // BX) * BX
    v_pad = -(-v // BX) * BX
    t_per = -(-t // CHUNK) * CHUNK
    part = torch.empty((n_split, t_pad, d), dtype=f32, device=dev)
    dh = torch.empty((t, d), dtype=f32, device=dev)
    dw = torch.empty((v_pad, d), dtype=f32, device=dev)
    lib = _build.load("fused_ce_bwd")
    p = ctypes.c_void_p
    err = lib.fused_ce_bwd_launch(
        p(h.data_ptr()), p(w.data_ptr()), p(lab.data_ptr()),
        p(lse32.data_ptr()), p(gn.data_ptr()), p(go.data_ptr()), t, v, d,
        n_split, v_per, t_per, p(part.data_ptr()), p(dh.data_ptr()),
        p(dw.data_ptr()), p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check("fused_ce_bwd", err)
    fused_ce_bwd.launches += 1
    dw = dw[:v]
    if cast:
        return dh.to(h.dtype), dw.to(w.dtype)
    return dh, dw


fused_ce_bwd.launches = 0
