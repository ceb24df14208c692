"""FMBE substrate: Kar-Karnick random feature maps for the exp dot-product
kernel (counterpart of ``repro.core.feature_maps``).

Paper Eq. 9/10:  phi_j(x) = sqrt(a_M p^{M+1}) prod_{r=1..M} (omega_r . x),
with M ~ Geometric (P[M=m] = p^-(m+1)), omega Rademacher, a_m = 1/m!, so
exp(x.y) ~= sum_j phi_j(x) phi_j(y). M is capped at ``max_degree`` and the
truncated geometric renormalised.

Block-partitioned sketch: besides ``lambda_tilde = sum_i phi(v_i)`` the
serving build keeps the per-IVF-block sums ``lambda_blocks[b]``, and the
decode asks the sketch only for the complement of the probed head,

    Z_tail_hat(q) = phi(q) . (lambda_tilde - sum_{b probed} lambda_blocks[b]).

The builds compute phi through ``kernels.fmbe.fmbe_phi`` (a CUDA kernel on
a GPU tensor, its plain version on a CPU tensor). Where that kernel reads
the feature map's live rows packed (``kernels.fmbe.pack_if_needed``), each
build packs once and passes the pack to all its chunks; the state keeps it
(``FMBEState.pack``) for ``kernels.fmbe.fmbe_z``, which reads the same pack
at decode (packing reads ``degree`` to the host, so a decode never packs).
``apply_feature_map`` is the plain reference the
``use_kernel=False`` branches take.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from ..kernels.fmbe import FmbePack, fmbe_phi, fmbe_z, pack_if_needed


class FeatureMap(NamedTuple):
    omega: torch.Tensor    # (P, max_degree, d) f32 Rademacher +-1
    degree: torch.Tensor   # (P,) int32, sampled M_j in [0, max_degree]
    coef: torch.Tensor     # (P,) f32 sqrt(a_M / P_hat[M]) / sqrt(P)
    p: float


class FMBEState(NamedTuple):
    fm: FeatureMap
    lambda_tilde: torch.Tensor                    # (P,) = sum_i phi(v_i)
    lambda_blocks: Optional[torch.Tensor] = None  # (nb, P) per-block sums
    pack: Optional[FmbePack] = None               # fm's fmbe_pack, if read


def make_feature_map(generator: torch.Generator, d: int, n_features: int,
                     max_degree: int = 8, p: float = 2.0,
                     device="cuda") -> FeatureMap:
    """Draw a feature map from ``generator`` (which must live on
    ``device``). The draws differ from the JAX package's for any seed; tests
    inject a JAX feature map through ``interop.feature_map_from_numpy``."""
    device = resolve_device(device)
    logits = torch.tensor([-(m + 1) * math.log(p)
                           for m in range(max_degree + 1)], device=device)
    probs = torch.softmax(logits, 0)
    degree = torch.multinomial(probs, n_features, replacement=True,
                               generator=generator)
    a = torch.tensor([1.0 / math.gamma(m + 1) for m in range(max_degree + 1)],
                     device=device)
    coef_table = torch.sqrt(a / probs) / math.sqrt(n_features)
    omega = torch.randint(0, 2, (n_features, max_degree, d),
                          generator=generator, device=device)
    return FeatureMap(omega=(2 * omega - 1).float(),
                      degree=degree.to(torch.int32),
                      coef=coef_table[degree].float(), p=p)


def apply_feature_map(fm: FeatureMap, x: torch.Tensor) -> torch.Tensor:
    """phi(x): x (..., d) -> (..., P), the reference form (one projection
    tensor (..., P, max_degree), a masked product)."""
    proj = torch.einsum("pmd,...d->...pm", fm.omega, x.float())
    m_idx = torch.arange(fm.omega.shape[1], device=x.device)
    mask = m_idx[None, :] < fm.degree[:, None]           # (P, max_degree)
    factors = torch.where(mask, proj, torch.ones_like(proj))
    return torch.prod(factors, -1) * fm.coef


def build_fmbe(fm: FeatureMap, v: torch.Tensor, chunk: int = 2048,
               pack: Optional[FmbePack] = None) -> FMBEState:
    """lambda_tilde = sum_i phi(v_i), in row chunks (bounded memory).
    ``pack``: the map's ``fmbe_pack``, made here when ``fmbe_phi`` needs
    one and none is given."""
    if pack is None:
        pack = pack_if_needed(fm.omega, fm.degree, fm.coef, v)
    lam = torch.zeros(fm.omega.shape[0], dtype=torch.float32,
                      device=v.device)
    for r0 in range(0, v.shape[0], chunk):
        lam += fmbe_phi(fm.omega, fm.degree, fm.coef,
                        v[r0:r0 + chunk].contiguous(), pack=pack).sum(0)
    return FMBEState(fm=fm, lambda_tilde=lam, pack=pack)


def build_fmbe_blocks(fm: FeatureMap, v_blocks: torch.Tensor,
                      valid: torch.Tensor, chunk_blocks: int = 16,
                      pack: Optional[FmbePack] = None) -> torch.Tensor:
    """Per-IVF-block partial lambdas: (nb, br, d) -> (nb, P), cluster-pad
    rows masked out. ``chunk_blocks`` blocks go through ``fmbe_phi`` at a
    time (16 blocks of 512 rows and P = 4096: a 134 MB phi). ``pack``: the
    map's ``fmbe_pack``, made here when ``fmbe_phi`` needs one and none is
    given."""
    if pack is None:
        pack = pack_if_needed(fm.omega, fm.degree, fm.coef, v_blocks)
    nb, br, d = v_blocks.shape
    lam = torch.empty((nb, fm.omega.shape[0]), dtype=torch.float32,
                      device=v_blocks.device)
    for b0 in range(0, nb, chunk_blocks):
        b1 = min(b0 + chunk_blocks, nb)
        phi = fmbe_phi(fm.omega, fm.degree, fm.coef,
                       v_blocks[b0:b1].reshape(-1, d), pack=pack)
        phi = phi.reshape(b1 - b0, br, -1) * valid[b0:b1, :, None]
        lam[b0:b1] = phi.sum(1)
    return lam


def fmbe_tail_z(state: FMBEState, x: torch.Tensor,
                probed_blocks: torch.Tensor, use_kernel: bool = True,
                kernel_cfg: Optional[dict] = None) -> torch.Tensor:
    """Signed sketch estimate of the complement mass per query: x (Q, d),
    probed_blocks (Q, p) -> (Q,)
    phi(x_q) . (lambda_tilde - sum_{b in probed_q} lambda_blocks[b]);
    ``kernel_cfg``: ``fmbe_z``'s launch knobs."""
    if state.lambda_blocks is None:
        raise ValueError("fmbe_tail_z needs a block-partitioned build "
                         "(build_fmbe_blocks)")
    lam_rest = (state.lambda_tilde[None, :] -
                state.lambda_blocks[probed_blocks.long()].sum(1))  # (Q, P)
    fm = state.fm
    if use_kernel:
        return fmbe_z(fm.omega, fm.degree, fm.coef, lam_rest, x,
                      pack=state.pack, **(kernel_cfg or {}))
    return (apply_feature_map(fm, x) * lam_rest).sum(-1)


def fmbe_estimate_z(state: FMBEState, q: torch.Tensor) -> torch.Tensor:
    """Z_hat(q) = phi(q) . lambda_tilde. Random-feature estimates can be
    negative; callers clip where a log is needed."""
    return torch.einsum("...p,p->...", apply_feature_map(state.fm, q),
                        state.lambda_tilde)


def fmbe_z_batch(state: FMBEState, x: torch.Tensor,
                 use_kernel: bool = True,
                 kernel_cfg: Optional[dict] = None) -> torch.Tensor:
    """Batched signed Z_hat for a decode batch: x (Q, d) -> (Q,), through
    ``kernels.fmbe.fmbe_z`` (with ``kernel_cfg``'s launch knobs) or the
    reference feature map."""
    fm = state.fm
    if use_kernel:
        return fmbe_z(fm.omega, fm.degree, fm.coef, state.lambda_tilde, x,
                      pack=state.pack, **(kernel_cfg or {}))
    return apply_feature_map(fm, x) @ state.lambda_tilde
