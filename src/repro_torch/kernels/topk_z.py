"""Exact log Z plus top-k candidates in one pass over the vocabulary
(counterpart of ``repro.kernels.topk_z``).

``topk_z`` launches the CUDA kernel in ``csrc/topk_z.cu`` on CUDA tensors
and runs ``topk_z_plain`` on CPU tensors. Both keep the TPU kernel's rule:
among equal scores the lowest vocab id wins, and when fewer than k real
candidates exist the missing entries are ``(NEG, 0)``. Both take an
optional gate ``rows (Q,)``: only the queries whose entry is nonzero are
scored, and the others get the filler (lse -inf, top-k ``(NEG, 0)``); the
health guard passes its flags, so a healthy batch costs one launch that
exits at once.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG = -1e30


def select_topk(scores: torch.Tensor, ids: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of ``scores (Q, N)`` with ``ids`` (N,) or (Q, N),
    ordered by score descending, ties to the lowest id; entries at or below
    NEG/2 (masked) become the filler ``(NEG, 0)``. ``ids`` must increase
    along the row wherever scores are unmasked, so a stable sort gives the
    lowest id on ties."""
    q, n = scores.shape
    if n < k:
        scores = torch.cat([scores, scores.new_full((q, k - n), NEG)], 1)
        pad = torch.zeros(ids.shape[:-1] + (k - n,), dtype=ids.dtype,
                          device=ids.device)
        ids = torch.cat([ids, pad], -1)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    pos = order[:, :k]
    topv = torch.gather(scores, 1, pos)
    ids = ids.expand(q, -1) if ids.dim() == 1 else ids
    topi = torch.gather(ids, 1, pos).to(torch.int32)
    real = topv > NEG * 0.5
    topv = torch.where(real, topv, torch.full_like(topv, NEG))
    topi = torch.where(real, topi, torch.zeros_like(topi))
    return topv, topi


def topk_z_plain(h: torch.Tensor, w: torch.Tensor, k: int,
                 rows: Optional[torch.Tensor] = None):
    """Plain PyTorch version: h (Q, d), w (V, d) -> (lse (Q,) f32,
    topv (Q, k) f32, topi (Q, k) int32), scores accumulated in f32; the
    filler in the queries whose ``rows`` entry is 0."""
    logits = h.float() @ w.float().T
    lse = torch.logsumexp(logits, dim=-1)
    ids = torch.arange(w.shape[0], device=h.device)
    topv, topi = select_topk(logits, ids, k)
    if rows is not None:
        on = rows.to(h.device) != 0
        lse = torch.where(on, lse, torch.full_like(lse, float("-inf")))
        topv = torch.where(on[:, None], topv, torch.full_like(topv, NEG))
        topi = torch.where(on[:, None], topi, torch.zeros_like(topi))
    return lse, topv, topi


MAX_K = 32
QT = 8                   # queries a CTA holds in shared memory (streaming.cuh)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"topk_z: {msg}")


def check_tile(d: int, dtype: torch.dtype, limit: int) -> None:
    """Raises a ValueError unless the kernel's query tile of ``QT`` rows of
    width ``d`` in ``dtype`` fits the ``limit`` bytes of dynamic shared
    memory a block may take beside the kernel's own (``topk_z_tile_limit``
    on the device: 215,552 on an H100 at k > 8). The tile is kept in the
    inputs' dtype, so bf16 fits up to d 13,472 there and f32 up to 6,736."""
    need = QT * d * dtype.itemsize
    _check(need <= limit,
           f"the query tile of {QT} rows of d {d} in {dtype} takes {need} "
           f"bytes of shared memory, over the {limit} a block of this "
           f"kernel may take on this device")


_TILE_LIMITS: dict = {}


def _tile_limit(lib, dev: torch.device, k: int, f32: int) -> int:
    """``topk_z_tile_limit`` of the kernel instance for (k, dtype) on
    ``dev``, cached."""
    key = (dev, k <= 8, f32)
    if key not in _TILE_LIMITS:
        fn = lib.topk_z_tile_limit
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int()
        with torch.cuda.device(dev):
            _build.check("topk_z tile limit", fn(k, f32, ctypes.byref(out)))
        _TILE_LIMITS[key] = out.value
    return _TILE_LIMITS[key]


@_build.counted
def topk_z(h: torch.Tensor, w: torch.Tensor, k: int, *,
           rows: Optional[torch.Tensor] = None):
    """h (Q, d), w (V, d) -> (lse (Q,), topv (Q, k), topi (Q, k)); with
    ``rows (Q,)`` int32 only the queries whose entry is nonzero, the filler
    in the others.

    CUDA tensors launch the kernel (bf16 or f32 inputs, both of one dtype;
    f32 accumulation) on the current stream, reading ``rows`` on the device
    (no host read, so a gated call can be captured in a CUDA graph); a
    query tile too wide for the block's shared memory raises a ValueError
    first (``check_tile``: f32 at d 8192). CPU tensors run
    ``topk_z_plain``. A gated launch counts in ``topk_z.gated``
    as well."""
    if h.device.type == "cpu" and w.device.type == "cpu":
        return topk_z_plain(h, w, k, rows)
    _check(h.is_cuda and w.is_cuda and h.device == w.device,
           f"h on {h.device} and w on {w.device}: both must be on one GPU")
    is_f32 = _build.f32_flag("topk_z", h=h, w=w)
    _check(h.dim() == 2 and w.dim() == 2 and h.shape[1] == w.shape[1],
           f"shapes h {tuple(h.shape)} w {tuple(w.shape)}")
    _check(h.is_contiguous() and w.is_contiguous(), "inputs not contiguous")
    q, d = h.shape
    v = w.shape[0]
    _check(d % 8 == 0 and w.data_ptr() % 16 == 0 and h.data_ptr() % 16 == 0,
           "rows must be 16-byte aligned (d % 8 == 0)")
    _check(1 <= k <= MAX_K, f"k={k} outside [1, {MAX_K}]")
    _check(q >= 1 and v >= 1, "empty input")
    if rows is not None:
        _check(rows.device == h.device and rows.dtype == torch.int32
               and rows.shape == (q,) and rows.is_contiguous(),
               f"rows must be a contiguous ({q},) int32 tensor on {h.device}")
    lib = _build.load("topk_z")
    dev = h.device
    check_tile(d, h.dtype, _tile_limit(lib, dev, k, is_f32))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_per_cta_step = 32
    grid_x = max(1, min(2 * sms, -(-v // rows_per_cta_step)))
    n_part = grid_x                                      # one per CTA
    f32, i32 = torch.float32, torch.int32
    part_m = torch.empty((q, n_part), dtype=f32, device=dev)
    part_s = torch.empty((q, n_part), dtype=f32, device=dev)
    part_v = torch.empty((q, n_part, k), dtype=f32, device=dev)
    part_i = torch.empty((q, n_part, k), dtype=i32, device=dev)
    lse = torch.empty((q,), dtype=f32, device=dev)
    topv = torch.empty((q, k), dtype=f32, device=dev)
    topi = torch.empty((q, k), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = ctypes.c_void_p
    err = lib.topk_z_launch(
        p(h.data_ptr()), p(w.data_ptr()), q, v, d, k, grid_x,
        p(part_m.data_ptr()), p(part_s.data_ptr()), p(part_v.data_ptr()),
        p(part_i.data_ptr()), p(lse.data_ptr()), p(topv.data_ptr()),
        p(topi.data_ptr()), p(None if rows is None else rows.data_ptr()),
        is_f32, p(stream))
    _build.check("topk_z", err)
    _build.count(topk_z, is_f32, gated=rows is not None)
    return lse, topv, topi
