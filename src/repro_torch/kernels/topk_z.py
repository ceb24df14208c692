"""Exact log Z plus top-k candidates in one pass over the vocabulary
(counterpart of ``repro.kernels.topk_z``).

``topk_z`` launches the CUDA kernel in ``csrc/topk_z.cu`` on CUDA tensors
(bf16: W streamed by TMA into the tensor cores against up to 16 queries;
f32: the CUDA cores against an 8-query tile in shared memory) and runs
``topk_z_plain`` on CPU tensors. Both keep the TPU kernel's rule:
among equal scores the lowest vocab id wins, and when fewer than k real
candidates exist the missing entries are ``(NEG, 0)``. Both take an
optional gate ``rows (Q,)``: only the queries whose entry is nonzero are
scored, and the others get the filler (lse -inf, top-k ``(NEG, 0)``); the
health guard passes its flags, so a healthy batch costs two launches (the
kernel and its merge) that exit at once.
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
QT = 8                   # queries of the f32 kernel's tile (streaming.cuh)
# the bf16 kernel (csrc/topk_z.cu, namespace tc): W in boxes of BOX_ROWS
# rows, streamed BOX_COLS columns a stage through a ring of STAGES[n]
# stages beside the n queries' slice; n is 8 for Q <= 8 and 16 above
BOX_ROWS, BOX_COLS = 128, 64
QTILE = 16
STAGES = {8: 12, 16: 11}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"topk_z: {msg}")


def geometry(q: int, v: int, d: int, dtype: torch.dtype, sms: int) -> dict:
    """The launch geometry of ``topk_z`` for Q queries over V rows of width
    d in ``dtype`` on a card of ``sms`` SMs.

    bf16 (the tensor-core kernel): ``n`` queries a grid row (8 for Q <= 8,
    else 16), ``tiles`` grid rows, ``grid_x`` CTAs a row (one an SM, at most
    one a box), ``boxes`` of ``box_rows`` rows, each CTA's contiguous
    ``ranges`` of boxes [b0, b1) (sizes within one of each other), the
    ring's ``stages`` of ``stage_bytes`` (W's box slice and the queries'),
    ``in_flight`` bytes of W an SM and the dynamic ``smem``; d enters only
    through the stages a box takes, ``ceil(d / box_cols)``.
    f32 (the CUDA-core kernel): ``n`` = QT, ``tiles`` and ``grid_x`` (up to
    2 CTAs an SM, one a 32-row group)."""
    if dtype == torch.float32:
        return dict(tensor_cores=False, n=QT, tiles=-(-q // QT),
                    grid_x=max(1, min(2 * sms, -(-v // 32))))
    n = 8 if q <= 8 else QTILE
    boxes = -(-v // BOX_ROWS)
    grid_x = max(1, min(sms, boxes))
    stage = BOX_ROWS * BOX_COLS * 2 + n * BOX_COLS * 2
    return dict(tensor_cores=True, n=n, tiles=-(-q // n), grid_x=grid_x,
                box_rows=BOX_ROWS, box_cols=BOX_COLS, boxes=boxes,
                stages_per_box=-(-d // BOX_COLS),
                ranges=[(x * boxes // grid_x, (x + 1) * boxes // grid_x)
                        for x in range(grid_x)],
                stages=STAGES[n], stage_bytes=stage,
                in_flight=STAGES[n] * BOX_ROWS * BOX_COLS * 2,
                smem=STAGES[n] * stage + 1024)


def library_ring(n: int) -> Tuple[int, int, int]:
    """(stages, stage bytes, dynamic shared memory) of the built bf16
    kernel at query tile ``n``, for holding ``geometry`` to the source."""
    lib = _build.load("topk_z")
    fn = lib.topk_z_ring
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(3)]
    _build.check("topk_z ring", fn(n, *(ctypes.byref(o) for o in out)))
    return tuple(o.value for o in out)


def check_tile(d: int, dtype: torch.dtype, limit: int) -> None:
    """Raises a ValueError unless the f32 kernel's query tile of ``QT``
    rows of width ``d`` fits the ``limit`` bytes of dynamic shared memory a
    block may take beside the kernel's own (``topk_z_tile_limit`` on the
    device: 215,552 on an H100 at k > 8), so f32 fits up to d 6,736 there.
    The bf16 kernel keeps no query tile: it takes any d % 8 == 0."""
    if dtype != torch.float32:
        return
    need = QT * d * dtype.itemsize
    _check(need <= limit,
           f"the query tile of {QT} rows of d {d} in {dtype} takes {need} "
           f"bytes of shared memory, over the {limit} a block of this "
           f"kernel may take on this device")


_TILE_LIMITS: dict = {}


def _tile_limit(lib, dev: torch.device, k: int) -> int:
    """``topk_z_tile_limit`` of the f32 kernel instance for k on ``dev``,
    cached."""
    key = (dev, k <= 8)
    if key not in _TILE_LIMITS:
        fn = lib.topk_z_tile_limit
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int()
        with torch.cuda.device(dev):
            _build.check("topk_z tile limit", fn(k, ctypes.byref(out)))
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
    (no host read, so a gated call can be captured in a CUDA graph): bf16
    the tensor-core kernel, f32 the CUDA-core one, whose query tile too
    wide for the block's shared memory raises a ValueError first
    (``check_tile``: f32 at d 8192). CPU tensors run ``topk_z_plain``. A
    gated launch counts in ``topk_z.gated`` as well, and a launch of the
    bf16 kernel's 16-query instance (Q > 8) in ``by_variant["bf16 n16"]``."""
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
    if is_f32:
        check_tile(d, h.dtype, _tile_limit(lib, dev, k))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid_x = geometry(q, v, d, h.dtype, sms)["grid_x"]
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
    _build.count(topk_z, is_f32, gated=rows is not None,
                 variant=None if is_f32 or q <= 8 else "bf16 n16")
    return lse, topv, topi
