"""Kar-Karnick feature-map kernels, the FMBE substrate (paper Eq. 9/10;
counterpart of ``repro.kernels.fmbe``).

    phi_j(x) = coef_j * prod_{m < degree_j} (omega_{j,m} . x)

``fmbe_phi`` writes the (Q, P) feature matrix (the build-time kernel that
forms the sketch sums); ``fmbe_z`` folds it straight into
``z = phi(x) . lambda`` (the decode kernel), so no (Q, P) tensor reaches
device memory. Each wrapper launches its CUDA kernel (``csrc/fmbe_phi.cu``,
``csrc/fmbe_z.cu``, sharing ``csrc/fmbe_tile.cuh``) on CUDA tensors and runs
its plain version on CPU tensors. The kernels compute only the projections
with ``m < degree_j``; the plain versions, like the TPU kernels, compute
all ``max_degree`` and multiply by 1 past the degree, which gives the same
result.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_DEGREE = 8              # fmbe_tile.cuh's MMAX
Z_FEATURES_PER_CTA = 16     # fmbe_z.cu's FP
QUERY_TILE = 8              # streaming.cuh's QT


def fmbe_phi_plain(omega, degree, coef, x):
    """Plain PyTorch version of ``fmbe_phi``: factors multiplied in m
    order, then ``coef``, all in f32."""
    xf = x.float()
    prod = torch.ones((x.shape[0], omega.shape[0]), dtype=torch.float32,
                      device=x.device)
    for m in range(omega.shape[1]):
        proj = xf @ omega[:, m, :].float().T
        prod = prod * torch.where(degree[None, :] > m, proj,
                                  torch.ones_like(proj))
    return prod * coef.float()


def fmbe_z_plain(omega, degree, coef, lam, x):
    """Plain PyTorch version of ``fmbe_z``."""
    phi = fmbe_phi_plain(omega, degree, coef, x)
    return (phi * lam.float()).sum(-1)


def _check(cond: bool, msg: str, name: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_inputs(name, omega, degree, coef, x, extra=()):
    tensors = (omega, degree, coef, x) + tuple(extra)
    dev = x.device
    _check(all(t.device == dev for t in tensors) and dev.type == "cuda",
           "every input must be on one GPU", name)
    _check(omega.dtype == torch.float32 and coef.dtype == torch.float32
           and degree.dtype == torch.int32 and x.dtype == torch.bfloat16,
           f"kernel takes f32 omega/coef, int32 degree and bf16 x, got "
           f"{omega.dtype}, {coef.dtype}, {degree.dtype}, {x.dtype}", name)
    _check(omega.dim() == 3 and x.dim() == 2, "shapes", name)
    p, m, d = omega.shape
    q = x.shape[0]
    _check(degree.shape == (p,) and coef.shape == (p,) and x.shape == (q, d),
           f"shapes omega {tuple(omega.shape)} degree {tuple(degree.shape)} "
           f"coef {tuple(coef.shape)} x {tuple(x.shape)}", name)
    _check(1 <= m <= MAX_DEGREE, f"max_degree {m} outside [1, {MAX_DEGREE}]",
           name)
    _check(all(t.is_contiguous() for t in tensors), "inputs not contiguous",
           name)
    _check(d % 8 == 0 and omega.data_ptr() % 16 == 0
           and x.data_ptr() % 16 == 0,
           "rows must be 16-byte aligned (d % 8 == 0)", name)
    _check(q >= 1 and p >= 1, "empty input", name)
    return q, p, m, d


def fmbe_phi(omega, degree, coef, x):
    """phi(x) without the (Q, P, max_degree) projection tensor.

      omega  (P, M, d) f32 +-1   degree (P,) int32   coef (P,) f32
      x      (Q, d)

    Returns (Q, P) f32."""
    if all(t.device.type == "cpu" for t in (omega, degree, coef, x)):
        return fmbe_phi_plain(omega, degree, coef, x)
    q, p, m, d = _check_inputs("fmbe_phi", omega, degree, coef, x)
    _check(-(-q // QUERY_TILE) <= 65535, f"Q={q}: chunk the rows",
           "fmbe_phi")
    lib = _build.load("fmbe_phi")
    out = torch.empty((q, p), dtype=torch.float32, device=x.device)
    ptr = ctypes.c_void_p
    err = lib.fmbe_phi_launch(
        *[ptr(t.data_ptr()) for t in (omega, degree, coef, x)], q, p, m, d,
        ptr(out.data_ptr()),
        ptr(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check("fmbe_phi", err)
    fmbe_phi.launches += 1
    return out


fmbe_phi.launches = 0


def fmbe_z(omega, degree, coef, lam, x):
    """Fused decode estimate z(x) = phi(x) . lambda, (Q,) signed f32.

    ``lam`` is (P,), one shared sketch sum (the global-Z path), or (Q, P),
    a per-query lambda (the block-partitioned complement path,
    ``core.feature_maps.fmbe_tail_z``)."""
    if all(t.device.type == "cpu" for t in (omega, degree, coef, lam, x)):
        return fmbe_z_plain(omega, degree, coef, lam, x)
    q, p, m, d = _check_inputs("fmbe_z", omega, degree, coef, x, (lam,))
    _check(lam.dtype == torch.float32 and lam.shape in ((p,), (q, p)),
           f"lam must be f32 (P,) or (Q, P), got {lam.dtype} "
           f"{tuple(lam.shape)}", "fmbe_z")
    lib = _build.load("fmbe_z")
    n_part = -(-p // Z_FEATURES_PER_CTA)
    part = torch.empty((q, n_part), dtype=torch.float32, device=x.device)
    z = torch.empty((q,), dtype=torch.float32, device=x.device)
    ptr = ctypes.c_void_p
    err = lib.fmbe_z_launch(
        *[ptr(t.data_ptr()) for t in (omega, degree, coef, lam)],
        p if lam.dim() == 2 else 0, ptr(x.data_ptr()), q, p, m, d, n_part,
        ptr(part.data_ptr()), ptr(z.data_ptr()),
        ptr(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check("fmbe_z", err)
    fmbe_z.launches += 1
    return z


fmbe_z.launches = 0
