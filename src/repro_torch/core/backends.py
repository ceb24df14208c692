"""Estimator-backend registry (counterpart of ``repro.core.backends``; the
slice carries ``exact`` and ``mimps``).

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
from . import mips as _mips
from .decode import DecodeOut, exact_topk_decode, mimps_decode


@dataclasses.dataclass
class BackendState:
    """Retrieval state built once per engine."""
    w: torch.Tensor
    index: Optional[_mips.IVFIndex] = None


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
              device="cuda") -> BackendState:
        """``assign`` (V,) injects the k-means assignment of an index build
        (parity with an index built elsewhere); ``generator`` seeds k-means
        otherwise."""
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
class MimpsBackend(EstimatorBackend):
    method = "mimps"

    def build(self, cfg, w, *, generator=None, assign=None, device="cuda"):
        state = super().build(cfg, w, device=device)
        state.index = _build_index(cfg, state.w, generator=generator,
                                   assign=assign, device=device)
        return state

    def decode(self, state, h, cfg, *, k=1, use_kernel=True, generator=None,
               tail_idx=None, active=None):
        if state.index is None:
            return exact_topk_decode(state.w, h, k=k, use_kernel=use_kernel)
        return mimps_decode(state.index, h, n_probe=cfg.n_probe, l=cfg.l,
                            k=k, use_kernel=use_kernel, generator=generator,
                            tail_idx=tail_idx, active=active)
