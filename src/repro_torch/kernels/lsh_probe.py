"""Fused Hamming-probe decode of the LSH backend (counterpart of
``repro.kernels.lsh_probe``).

``lsh_probe`` launches the CUDA kernel in ``csrc/lsh_probe.cu`` on CUDA
tensors and runs ``lsh_probe_plain`` on CPU tensors. Both take the index's
own tables and read every candidate and tail row by id from the output
embedding ``w`` (bf16 or f32, as the queries; no staged ``w[rows]`` copy,
which at the dense fallback would be the whole vocabulary in f32). The contract is the TPU kernel's:

* query codes are made from ``h`` and ``proj`` (the hyperplanes' trailing
  MIPS column is dropped: queries hash with that coordinate 0);
* ``counts[q, j]`` is the number of tables where candidate ``j`` collides
  with query ``q`` and is routed (``slot_of_row >= 0``), 0 at ``j >=
  cand_live``; membership is ``counts > 0``;
* the head LSE and top-k run over members, top-k ids are original row ids
  in the total order (score descending, id ascending), missing entries are
  ``(NEG, 0)``, and an empty head gives ``-inf``;
* the tail LSE runs over accepted samples with each sample's importance
  bias added to its score, ``-inf`` when none is accepted.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ivf_score import _masked_lse
from .topk_z import MAX_K, NEG, select_topk

MAX_TABLES = 64        # query codes of an 8-query tile live in shared memory
MAX_BITS = 24          # packed codes stay exact in f32 on the TPU side


def _check(cond: bool, msg: str, name: str = "lsh_probe") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def hash_codes(proj: torch.Tensor, x: torch.Tensor,
               aug: torch.Tensor | None = None) -> torch.Tensor:
    """Packed SimHash codes of x (N, d) -> (N, L) int32 in [0, 2**K).

    ``proj`` is (L, K, d+1); its last column meets the MIPS-augmented
    coordinate, given per row by ``aug`` (index rows) or 0 (queries).

    The projections are taken in float64: the sign bits must not depend on
    whether TF32 is allowed for f32 products, and the CUDA kernel's f32 dot
    products can then differ from these only where a projection lies within
    f32 rounding of 0. The K sign bits of each table are packed with integer
    shifts."""
    ltab, k, dp = proj.shape
    pm = proj.reshape(ltab * k, dp).double()
    s = x.double() @ pm[:, :x.shape[-1]].T                     # (N, L*K)
    if aug is not None:
        s = s + aug.double()[:, None] * pm[:, -1][None, :]
    bits = (s > 0).to(torch.int32).reshape(-1, ltab, k)
    shifts = torch.arange(k, dtype=torch.int32, device=x.device)
    return (bits << shifts).sum(-1, dtype=torch.int32)


def lsh_probe_plain(w, h, proj, cand_rows, cand_live, codes, slot_of_row,
                    tail_ids, tail_accept, tail_bias, *, k: int = 1):
    """Plain PyTorch version of ``lsh_probe`` (same arguments and outputs),
    scores accumulated in f32."""
    qcodes = hash_codes(proj, h)                               # (Q, L)
    rows = cand_rows.long()
    hit = ((qcodes[:, None, :] == codes[rows][None]) &
           (slot_of_row[rows] >= 0)[None])
    col_live = torch.arange(rows.shape[0], device=h.device) < cand_live
    counts = torch.where(col_live[None, :], hit.sum(-1, dtype=torch.int32),
                         torch.zeros((), dtype=torch.int32, device=h.device))
    hf = h.float()
    scores = hf @ w[rows].float().T
    eff = torch.where(counts > 0, scores, torch.full_like(scores, NEG))
    head_lse = _masked_lse(eff)
    topv, topi = select_topk(eff, rows, k)
    ts = hf @ w[tail_ids.long()].float().T + tail_bias.float()[None, :]
    tail_lse = _masked_lse(torch.where(tail_accept, ts,
                                       torch.full_like(ts, NEG)))
    return head_lse, tail_lse, topv, topi, counts


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


@_build.counted
def lsh_query_codes(h: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """The kernel's query codes: h (Q, d), proj (L, K, d+1) f32 -> (Q, L)
    int32. On CUDA tensors this launches the code stage of ``lsh_probe``
    alone (f32 dot products on the CUDA cores, no TF32, bits packed by
    shifts); on CPU tensors it is ``hash_codes``."""
    if h.device.type == "cpu" and proj.device.type == "cpu":
        return hash_codes(proj, h)
    _check_codes_inputs(h, proj, "lsh_query_codes")
    q, d = h.shape
    ltab, kbits, _ = proj.shape
    lib = _build.load("lsh_probe")
    qcodes = torch.empty((q, ltab), dtype=torch.int32, device=h.device)
    p = ctypes.c_void_p
    is_f32 = _build.KERNEL_DTYPES[h.dtype]
    err = lib.lsh_codes_launch(p(h.data_ptr()), p(proj.data_ptr()), q, d,
                               ltab, kbits, p(qcodes.data_ptr()), is_f32,
                               _stream(h.device))
    _build.check("lsh_codes", err)
    _build.count(lsh_query_codes, is_f32)
    return qcodes


def _check_codes_inputs(h, proj, name):
    _check(h.is_cuda and proj.device == h.device,
           "h and proj must be on one GPU", name)
    _check(h.dtype in _build.KERNEL_DTYPES and proj.dtype == torch.float32,
           f"kernel takes bf16 or f32 h and f32 proj, got {h.dtype}, "
           f"{proj.dtype}", name)
    _check(h.dim() == 2 and proj.dim() == 3
           and proj.shape[2] == h.shape[1] + 1, "shapes", name)
    _check(h.is_contiguous() and proj.is_contiguous(),
           "inputs not contiguous", name)
    _check(1 <= proj.shape[1] <= MAX_BITS
           and 1 <= proj.shape[0] <= MAX_TABLES,
           f"K={proj.shape[1]} must be in [1, {MAX_BITS}] and "
           f"L={proj.shape[0]} in [1, {MAX_TABLES}]", name)
    _check(h.shape[0] >= 1, "empty input", name)


@_build.counted
def lsh_probe(w, h, proj, cand_rows, cand_live, codes, slot_of_row,
              tail_ids, tail_accept, tail_bias, *, k: int = 1, grid_x=None):
    """Fused LSH probe-and-decode over a candidate set read by id.

      w           (V, d)        output embedding (bf16 or f32, as h)
      h           (Q, d)        query batch
      proj        (L, K, d+1)   the index's hyperplanes, f32
      cand_rows   (C,) int32    row id per candidate column (the trimmed
                                union, pads 0; or ``arange(V)``)
      cand_live   () int32      live leading columns, left on the device
      codes       (V, L) int32  the index's packed row codes
      slot_of_row (V, L) int32  the index's slots; < 0 = not routed there
      tail_ids    (l,) int32    shared tail sample row ids
      tail_accept (Q, l) bool   sample survives rejection for query q
      tail_bias   (l,) f32      per-sample importance bias -log(n p_j),
                                added to the sample's score

    Returns (head_lse (Q,), tail_lse (Q,), topv (Q, k), topi (Q, k) int32
    original row ids, counts (Q, C) int32). Ids must lie in [0, V).
    ``grid_x`` (None: ``_build.stream_grid``) is the probe's launch knob
    (``kernels.autotune``); CPU tensors ignore it."""
    args = (w, h, proj, cand_rows, cand_live, codes, slot_of_row, tail_ids,
            tail_accept, tail_bias)
    if all(t.device.type == "cpu" for t in args):
        return lsh_probe_plain(*args, k=k)
    out = probe_launch(*args, k=k, grid_x=grid_x)
    _build.count(lsh_probe, _build.KERNEL_DTYPES[h.dtype])
    return out


def probe_launch(w, h, proj, cand_rows, cand_live, codes, slot_of_row,
                 tail_ids, tail_accept, tail_bias, *, k: int = 1, lib=None,
                 grid_x=None):
    """``lsh_probe``'s kernels on CUDA tensors, without its launch count.
    ``lib`` is the built library to call (default: the package's build of
    ``csrc/lsh_probe.cu``, for timing variant builds) and ``grid_x`` its
    probe's grid (default: ``_build.stream_grid``)."""
    args = (w, h, proj, cand_rows, cand_live, codes, slot_of_row, tail_ids,
            tail_accept, tail_bias)
    dev = h.device
    _check(all(t.device == dev for t in args) and dev.type == "cuda",
           "every input must be on one GPU")
    _check_codes_inputs(h, proj, "lsh_probe")
    is_f32 = _build.f32_flag("lsh_probe", w=w, h=h)
    _check(all(t.dtype == torch.int32
               for t in (cand_rows, cand_live, codes, slot_of_row, tail_ids))
           and tail_accept.dtype == torch.bool
           and tail_bias.dtype == torch.float32, "index/mask dtypes")
    v, d = w.shape
    q = h.shape[0]
    ltab, kbits, _ = proj.shape
    c = cand_rows.shape[0]
    l = tail_ids.shape[0]
    _check(h.shape == (q, d) and cand_rows.shape == (c,)
           and cand_live.numel() == 1 and codes.shape == (v, ltab)
           and slot_of_row.shape == (v, ltab) and tail_ids.shape == (l,)
           and tail_accept.shape == (q, l) and tail_bias.shape == (l,),
           "shapes")
    _check(all(t.is_contiguous() for t in args), "inputs not contiguous")
    _check(d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (w, h)),
           "rows must be 16-byte aligned (d % 8 == 0)")
    _check(1 <= k <= MAX_K, f"k={k} outside [1, {MAX_K}]")
    _check(c >= 1 and l >= 1, "empty input")
    grid_x = _build.grid_knob("lsh_probe", dev, grid_x)
    lib = _build.load("lsh_probe") if lib is None else lib
    f32, i32 = torch.float32, torch.int32
    qcodes = torch.empty((q, ltab), dtype=i32, device=dev)
    counts = torch.empty((q, c), dtype=i32, device=dev)
    part = [torch.empty((q, grid_x), dtype=f32, device=dev) for _ in range(4)]
    part_v = torch.empty((q, grid_x, k), dtype=f32, device=dev)
    part_i = torch.empty((q, grid_x, k), dtype=i32, device=dev)
    head_lse = torch.empty((q,), dtype=f32, device=dev)
    tail_lse = torch.empty((q,), dtype=f32, device=dev)
    topv = torch.empty((q, k), dtype=f32, device=dev)
    topi = torch.empty((q, k), dtype=i32, device=dev)
    p = ctypes.c_void_p
    err = lib.lsh_probe_launch(
        *[p(t.data_ptr()) for t in args], q, c, d, ltab, kbits, l, k, grid_x,
        p(qcodes.data_ptr()), p(counts.data_ptr()), p(part[0].data_ptr()),
        p(part[1].data_ptr()), p(part_v.data_ptr()), p(part_i.data_ptr()),
        p(part[2].data_ptr()), p(part[3].data_ptr()), p(head_lse.data_ptr()),
        p(tail_lse.data_ptr()), p(topv.data_ptr()), p(topi.data_ptr()),
        is_f32, _stream(dev))
    _build.check("lsh_probe", err)
    return head_lse, tail_lse, topv, topi, counts
