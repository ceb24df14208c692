"""Estimator-backend registry (counterpart of ``repro.core.backends``; the
port carries ``exact``, ``selfnorm``, ``mimps``, ``mince``, ``topk``,
``fmbe`` and ``lsh``).

A backend has two obligations: ``build`` derives its retrieval state from
the output embedding ``w (V, d)`` once, and ``decode`` runs one batched
decode step returning the uniform ``DecodeOut``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import resolve_device
from ..configs.base import PartitionConfig
from . import lsh as _lsh
from . import mips as _mips
from .decode import (DecodeOut, exact_topk_decode, fmbe_decode, mimps_decode,
                     mince_decode, selfnorm_decode, topk_head_decode)
from .feature_maps import (FeatureMap, FMBEState, build_fmbe,
                           build_fmbe_blocks, fmbe_z_batch, make_feature_map)


@dataclasses.dataclass
class BackendState:
    """Retrieval state built once per engine."""
    w: torch.Tensor
    index: Optional[_mips.IVFIndex] = None
    fmbe: Optional[FMBEState] = None
    lsh: Optional[_lsh.LSHIndex] = None


def _build_index(cfg: PartitionConfig, w: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 assign: Optional[torch.Tensor] = None,
                 device="cuda") -> Optional[_mips.IVFIndex]:
    """Block-IVF over the output embedding; skipped for vocabularies below
    4 blocks (the exact pass is already cheaper than a probe there)."""
    if w.shape[0] >= 4 * cfg.block_rows:
        return _mips.build_ivf(w, block_rows=cfg.block_rows,
                               n_clusters=cfg.n_clusters,
                               generator=generator, assign=assign,
                               device=device)
    return None


class EstimatorBackend:
    method: str = ""

    def build(self, cfg: PartitionConfig, w: torch.Tensor, *,
              generator: Optional[torch.Generator] = None,
              assign: Optional[torch.Tensor] = None,
              feature_map: Optional[FeatureMap] = None,
              lsh_proj: Optional[torch.Tensor] = None,
              device="cuda") -> BackendState:
        """``assign`` (V,) injects the k-means assignment of an index build,
        ``feature_map`` the FMBE feature map and ``lsh_proj`` the LSH
        hyperplanes (parity with state built elsewhere); ``generator`` draws
        them otherwise."""
        return BackendState(w=w.to(resolve_device(device)))

    def decode(self, state: BackendState, h: torch.Tensor,
               cfg: PartitionConfig, *, k: int = 1, use_kernel: bool = True,
               generator: Optional[torch.Generator] = None,
               tail_idx: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None) -> DecodeOut:
        raise NotImplementedError


BACKENDS: Dict[str, EstimatorBackend] = {}


def register_backend(cls):
    inst = cls()
    if not inst.method:
        raise ValueError("backend must set a method name")
    BACKENDS[inst.method] = inst
    return cls


def get_backend(method: str) -> EstimatorBackend:
    try:
        return BACKENDS[method]
    except KeyError:
        raise ValueError(
            f"no serving backend registered for method {method!r}; serving "
            f"methods: {sorted(BACKENDS)}") from None


@register_backend
class ExactBackend(EstimatorBackend):
    method = "exact"

    def decode(self, state, h, cfg, *, k=1, use_kernel=True, generator=None,
               tail_idx=None, active=None):
        return exact_topk_decode(state.w, h, k=k, use_kernel=use_kernel)


@register_backend
class SelfnormBackend(EstimatorBackend):
    method = "selfnorm"

    def decode(self, state, h, cfg, *, k=1, use_kernel=True, generator=None,
               tail_idx=None, active=None):
        return selfnorm_decode(state.w, h, k=k, use_kernel=use_kernel)


class _IndexedBackend(EstimatorBackend):
    """A backend whose state is the block-IVF index."""

    def build(self, cfg, w, *, generator=None, assign=None, feature_map=None,
              lsh_proj=None, device="cuda"):
        state = super().build(cfg, w, device=device)
        state.index = _build_index(cfg, state.w, generator=generator,
                                   assign=assign, device=device)
        return state


@register_backend
class MimpsBackend(_IndexedBackend):
    method = "mimps"

    def decode(self, state, h, cfg, *, k=1, use_kernel=True, generator=None,
               tail_idx=None, active=None):
        if state.index is None:
            return exact_topk_decode(state.w, h, k=k, use_kernel=use_kernel)
        return mimps_decode(state.index, h, n_probe=cfg.n_probe, l=cfg.l,
                            k=k, use_kernel=use_kernel, generator=generator,
                            tail_idx=tail_idx, active=active)


@register_backend
class MinceBackend(_IndexedBackend):
    method = "mince"

    def decode(self, state, h, cfg, *, k=1, use_kernel=True, generator=None,
               tail_idx=None, active=None):
        if state.index is None:
            return exact_topk_decode(state.w, h, k=k, use_kernel=use_kernel)
        return mince_decode(state.index, h, n_probe=cfg.n_probe, l=cfg.l,
                            k=k, iters=cfg.mince_iters,
                            solver=cfg.mince_solver, use_kernel=use_kernel,
                            generator=generator, tail_idx=tail_idx,
                            active=active)


@register_backend
class TopkBackend(_IndexedBackend):
    """Head-only retrieval: MIMPS's candidates, log Ẑ the probed head's LSE
    (no tail)."""
    method = "topk"

    def decode(self, state, h, cfg, *, k=1, use_kernel=True, generator=None,
               tail_idx=None, active=None):
        if state.index is None:
            return exact_topk_decode(state.w, h, k=k, use_kernel=use_kernel)
        return topk_head_decode(state.index, h, n_probe=cfg.n_probe, k=k,
                                use_kernel=use_kernel, active=active)


@register_backend
class FmbeBackend(EstimatorBackend):
    method = "fmbe"

    def build(self, cfg, w, *, generator=None, assign=None, feature_map=None,
              lsh_proj=None, device="cuda"):
        """The feature map (drawn first, or injected), the index, and the
        per-block sketch sums, whose sum is lambda_tilde: one phi pass over
        the embedding. Without an index, the global sketch alone."""
        state = super().build(cfg, w, device=device)
        fm = feature_map
        if fm is None:
            fm = make_feature_map(generator, w.shape[-1], cfg.fmbe_features,
                                  max_degree=cfg.fmbe_max_degree,
                                  p=cfg.fmbe_p, device=state.w.device)
        state.index = _build_index(cfg, state.w, generator=generator,
                                   assign=assign, device=device)
        if state.index is not None:
            lam_b = build_fmbe_blocks(fm, state.index.v_blocks,
                                      state.index.valid)
            state.fmbe = FMBEState(fm=fm, lambda_tilde=lam_b.sum(0),
                                   lambda_blocks=lam_b)
        else:
            state.fmbe = build_fmbe(fm, state.w)
        return state

    def decode(self, state, h, cfg, *, k=1, use_kernel=True, generator=None,
               tail_idx=None, active=None):
        if state.index is None:
            out = exact_topk_decode(state.w, h, k=k, use_kernel=use_kernel)
            z = fmbe_z_batch(state.fmbe, h, use_kernel)
            return out._replace(log_z=torch.log(torch.clamp(z, min=1e-30)))
        return fmbe_decode(state.fmbe, state.index, h, n_probe=cfg.n_probe,
                           k=k, use_kernel=use_kernel, active=active)


@register_backend
class LshBackend(EstimatorBackend):
    """SimHash collision head + Eq. 5 tail combine (``core.lsh``). The index
    supplies routing only: candidate and tail rows are read from
    ``state.w``. ``cfg.head_cap`` counts candidate rows of the trimmed
    union (0 = auto, ``lsh.resolve_cand_cap``)."""
    method = "lsh"

    def build(self, cfg, w, *, generator=None, assign=None, feature_map=None,
              lsh_proj=None, device="cuda"):
        """The index, skipped below 4 rows per bucket (the exact pass is
        cheaper there)."""
        state = super().build(cfg, w, device=device)
        if state.w.shape[0] >= 4 * (1 << cfg.lsh_bits):
            state.lsh = _lsh.build_lsh_device(
                state.w, n_bits=cfg.lsh_bits, n_tables=cfg.lsh_tables,
                bucket_cap=cfg.lsh_bucket_cap, mips_scale=cfg.lsh_mips_scale,
                tail_beta=cfg.lsh_tail_beta, generator=generator,
                proj=lsh_proj, device=device)
        return state

    def decode(self, state, h, cfg, *, k=1, use_kernel=True, generator=None,
               tail_idx=None, active=None):
        if state.lsh is None:
            return exact_topk_decode(state.w, h, k=k, use_kernel=use_kernel)
        return _lsh.lsh_decode(state.lsh, state.w, h, l=cfg.l, k=k,
                               cand_cap=cfg.head_cap, use_kernel=use_kernel,
                               generator=generator, tail_ids=tail_idx,
                               active=active)

    def embedding_floats(self, state, cfg, q, u=None):
        """Embedding floats one decode step of ``q`` queries touches:
        hyperplanes, ``u`` unique candidate rows (default: every probed
        bucket slot), the shared tail rows and the queries."""
        v, d = state.w.shape
        lsh = state.lsh
        if lsh is None:
            return v * d + q * d
        if u is None:        # worst case: every probed bucket slot unique
            u = min(q * lsh.n_tables * lsh.bucket_cap, v)
        return lsh.n_tables * lsh.n_bits * d + u * d + cfg.l * d + q * d
