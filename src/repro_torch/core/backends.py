"""Estimator-backend registry (counterpart of ``repro.core.backends``; the
port carries ``exact``, ``selfnorm``, ``mimps``, ``mince``, ``topk``,
``fmbe`` and ``lsh``).

A backend has two obligations: ``build`` derives its retrieval state from
the output embedding ``w (V, d)`` once (``refresh`` rebuilds it from a new
one), and ``decode`` runs one batched decode step returning the uniform
``DecodeOut``. Backends also own their byte accounting
(``embedding_floats`` / ``floats_bound``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import resolve_device
from ..configs.base import PartitionConfig
from . import lsh as _lsh
from . import mips as _mips
from .decode import (DecodeOut, draw_tail_idx, exact_topk_decode,
                     fmbe_decode, mimps_decode, mince_decode,
                     selfnorm_decode, topk_head_decode)
from ..kernels.fmbe import pack_if_needed
from ..kernels.topk_z import topk_z
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
                 device="cuda", device_index: bool = False,
                 block_multiple: int = 1) -> Optional[_mips.IVFIndex]:
    """Block-IVF over the output embedding; skipped for vocabularies below
    4 blocks (the exact pass is already cheaper than a probe there).
    ``device_index=True`` packs into the fixed capacity
    (``mips.build_ivf_device``), whose shapes depend only on (V,
    block_rows, n_clusters). ``block_multiple`` pads the block axis with
    dead blocks (``mips.pad_ivf_blocks``) here, before anything indexed by
    block id is derived from it."""
    if w.shape[0] < 4 * cfg.block_rows:
        return None
    build = _mips.build_ivf_device if device_index else _mips.build_ivf
    index = build(w, block_rows=cfg.block_rows, n_clusters=cfg.n_clusters,
                  generator=generator, assign=assign, device=device)
    if block_multiple > 1:
        index = _mips.pad_ivf_blocks(index, block_multiple)
    return index


def _head_floats(state: BackendState, cfg: PartitionConfig, q: int,
                 u: Optional[int]) -> int:
    """Centroid scan + deduplicated head blocks + query rows."""
    idx = state.index
    d = state.w.shape[1]
    if idx is None:
        return state.w.shape[0] * d + q * d
    if u is None:
        u = min(q * cfg.n_probe, idx.n_blocks)
    return idx.n_blocks * d + u * idx.block_rows * d + q * d


class EstimatorBackend:
    method: str = ""

    def build(self, cfg: PartitionConfig, w: torch.Tensor, *,
              generator: Optional[torch.Generator] = None,
              assign: Optional[torch.Tensor] = None,
              feature_map: Optional[FeatureMap] = None,
              lsh_proj: Optional[torch.Tensor] = None,
              device="cuda", device_index: bool = False,
              block_multiple: int = 1,
              with_index: bool = True) -> BackendState:
        """``assign`` (V,) injects the k-means assignment of an index build,
        ``feature_map`` the FMBE feature map and ``lsh_proj`` the LSH
        hyperplanes (parity with state built elsewhere); ``generator`` draws
        them otherwise. ``device_index=True`` selects the fixed-capacity
        index build; ``block_multiple`` pads its block axis.
        ``with_index=False`` builds no index (the IVF or the LSH one), for
        callers that need only the estimate (the per-query accuracy
        studies, ``PartitionLayer``); serving always builds it, since it
        supplies the sampling candidates."""
        return BackendState(w=w.to(resolve_device(device)))

    def refresh(self, state: BackendState, cfg: PartitionConfig,
                w: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                assign: Optional[torch.Tensor] = None,
                feature_map: Optional[FeatureMap] = None,
                lsh_proj: Optional[torch.Tensor] = None,
                device="cuda", device_index: bool = True,
                block_multiple: int = 1) -> BackendState:
        """The retrieval state rebuilt from a new embedding ``w`` (the
        ``Engine.swap_index`` entry point). With ``device_index=True`` every
        tensor of the result has the shape and dtype of a same-config
        ``build``'s, so whatever took the old state's tensors can take the
        new one's."""
        del state
        return self.build(cfg, w, generator=generator, assign=assign,
                          feature_map=feature_map, lsh_proj=lsh_proj,
                          device=device, device_index=device_index,
                          block_multiple=block_multiple)

    def decode(self, state: BackendState, h: torch.Tensor,
               cfg: PartitionConfig, *, k: int = 1, use_kernel: bool = True,
               generator: Optional[torch.Generator] = None,
               tail_idx: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None) -> DecodeOut:
        raise NotImplementedError

    def has_tail(self, state: BackendState) -> bool:
        """Whether ``decode`` on this state samples a shared tail (and so
        reads ``tail_idx`` or draws from ``generator``)."""
        return False

    def draw_tail(self, state: BackendState, cfg: PartitionConfig,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """The ``tail_idx`` that ``decode`` would draw from ``generator``
        for one step, where ``has_tail``. Drawn ahead of the step, it lets
        a captured step draw nothing."""
        raise ValueError(f"{self.method}: this state samples no tail")

    def embedding_floats(self, state: BackendState, cfg: PartitionConfig,
                         q: int, u: Optional[int] = None) -> int:
        """Embedding floats one decode step of ``q`` queries touches (``u``:
        the measured deduplicated probed blocks, where they apply)."""
        v, d = state.w.shape
        return v * d + q * d

    def floats_bound(self, state: BackendState, cfg: PartitionConfig,
                     q: int) -> int:
        """The ceiling ``embedding_floats`` is held to (worst-case u =
        min(Q * n_probe, n_blocks))."""
        return self.embedding_floats(state, cfg, q)


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
    samples_tail = True          # draws the plan's shared uniform tail

    def build(self, cfg, w, *, generator=None, assign=None, feature_map=None,
              lsh_proj=None, device="cuda", device_index=False,
              block_multiple=1, with_index=True):
        state = super().build(cfg, w, device=device)
        if with_index:
            state.index = _build_index(cfg, state.w, generator=generator,
                                       assign=assign, device=device,
                                       device_index=device_index,
                                       block_multiple=block_multiple)
        return state

    def has_tail(self, state):
        return self.samples_tail and state.index is not None

    def draw_tail(self, state, cfg, generator=None):
        return draw_tail_idx(state.index, cfg.l, generator)

    def embedding_floats(self, state, cfg, q, u=None):
        """Centroids, the deduplicated head blocks, the shared tail rows
        and the queries."""
        base = _head_floats(state, cfg, q, u)
        d = state.w.shape[1]
        return base + (cfg.l * d if state.index is not None else 0)


@register_backend
class MimpsBackend(_IndexedBackend):
    method = "mimps"

    def decode(self, state, h, cfg, *, k=1, use_kernel=True, generator=None,
               tail_idx=None, active=None):
        if state.index is None:
            return exact_topk_decode(state.w, h, k=k, use_kernel=use_kernel)
        return mimps_decode(state.index, h, n_probe=cfg.n_probe, l=cfg.l,
                            k=k, use_kernel=use_kernel,
                            head_cap=cfg.head_cap, generator=generator,
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
                            head_cap=cfg.head_cap, generator=generator,
                            tail_idx=tail_idx, active=active)


@register_backend
class TopkBackend(_IndexedBackend):
    """Head-only retrieval: MIMPS's candidates, log Ẑ the probed head's LSE
    (no tail)."""
    method = "topk"
    samples_tail = False

    def decode(self, state, h, cfg, *, k=1, use_kernel=True, generator=None,
               tail_idx=None, active=None):
        if state.index is None:
            return exact_topk_decode(state.w, h, k=k, use_kernel=use_kernel)
        return topk_head_decode(state.index, h, n_probe=cfg.n_probe, k=k,
                                use_kernel=use_kernel, head_cap=cfg.head_cap,
                                active=active)

    def embedding_floats(self, state, cfg, q, u=None):
        return _head_floats(state, cfg, q, u)


@register_backend
class FmbeBackend(EstimatorBackend):
    method = "fmbe"

    def build(self, cfg, w, *, generator=None, assign=None, feature_map=None,
              lsh_proj=None, device="cuda", device_index=False,
              block_multiple=1, with_index=True):
        """The feature map (drawn first, or injected), the index, and the
        per-block sketch sums, whose sum is lambda_tilde: one phi pass over
        the embedding. Without an index (``with_index=False``, or a
        vocabulary under 4 blocks), the global sketch alone."""
        state = super().build(cfg, w, device=device)
        fm = feature_map
        if fm is None:
            fm = make_feature_map(generator, w.shape[-1], cfg.fmbe_features,
                                  max_degree=cfg.fmbe_max_degree,
                                  p=cfg.fmbe_p, device=state.w.device)
        if with_index:
            state.index = _build_index(cfg, state.w, generator=generator,
                                       assign=assign, device=device,
                                       device_index=device_index,
                                       block_multiple=block_multiple)
        if state.index is not None:
            state.fmbe = fmbe_block_state(fm, state.index, state.w)
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
                           k=k, use_kernel=use_kernel, head_cap=cfg.head_cap,
                           active=active)

    def embedding_floats(self, state, cfg, q, u=None):
        """The feature sketch (omega and lambda), the candidate head and the
        per-query probed-block lambda gather of the tail hybrid."""
        fm = state.fmbe.fm
        p_feat, max_deg, d = fm.omega.shape
        lam_gather = (q * cfg.n_probe * p_feat
                      if state.fmbe.lambda_blocks is not None else 0)
        return (p_feat * max_deg * d + p_feat + lam_gather +
                _head_floats(state, cfg, q, u))


@register_backend
class LshBackend(EstimatorBackend):
    """SimHash collision head + Eq. 5 tail combine (``core.lsh``). The index
    supplies routing only: candidate and tail rows are read from
    ``state.w``. ``cfg.head_cap`` counts candidate rows of the trimmed
    union (0 = auto, ``lsh.resolve_cand_cap``)."""
    method = "lsh"

    def build(self, cfg, w, *, generator=None, assign=None, feature_map=None,
              lsh_proj=None, device="cuda", device_index=False,
              block_multiple=1, with_index=True):
        """The index, skipped below 4 rows per bucket (the exact pass is
        cheaper there); its build is shape-stable whatever
        ``device_index``."""
        state = super().build(cfg, w, device=device)
        if with_index and state.w.shape[0] >= 4 * (1 << cfg.lsh_bits):
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

    def has_tail(self, state):
        return state.lsh is not None

    def draw_tail(self, state, cfg, generator=None):
        return _lsh.draw_tail_ids(state.lsh, cfg.l, generator)

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


def fmbe_block_state(fm: FeatureMap, index: _mips.IVFIndex,
                     w: torch.Tensor) -> FMBEState:
    """The block-partitioned sketch of ``fm`` over ``index``: the pack (if
    ``fmbe_phi`` reads one), one phi pass giving the per-block lambdas, and
    lambda_tilde, their sum."""
    pack = pack_if_needed(fm.omega, fm.degree, fm.coef, w)
    lam_b = build_fmbe_blocks(fm, index.v_blocks, index.valid, pack=pack)
    return FMBEState(fm=fm, lambda_tilde=lam_b.sum(0), lambda_blocks=lam_b,
                     pack=pack)


def verify_decode(backend: EstimatorBackend, state: BackendState,
                  h: torch.Tensor, cfg: PartitionConfig, *, k: int = 1,
                  active: Optional[torch.Tensor] = None,
                  use_kernel: bool = True,
                  generator: Optional[torch.Generator] = None,
                  tail_idx: Optional[torch.Tensor] = None) -> DecodeOut:
    """k-position verification in one decode: the (S, k_pos, d) stack of
    drafted hidden states is flattened lane-major to (S * k_pos, d) and
    decoded by the backend; ``active`` is per lane (S,) and expanded to
    rows. Every probe path computes candidates per query, so each row's
    output is what a separate one-position step would give. Leaves come
    back flat; callers reshape to (S, k_pos, ...)."""
    s_lanes, kpos, d = h.shape
    hf = h.reshape(s_lanes * kpos, d)
    act = None if active is None else \
        active[:, None].expand(-1, kpos).reshape(-1)
    return backend.decode(state, hf, cfg, k=k, use_kernel=use_kernel,
                          generator=generator, tail_idx=tail_idx, active=act)


def shadow_exact_log_z(state: BackendState, h: torch.Tensor, *, k: int = 1,
                       use_kernel: bool = True,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ground-truth log Z for the shadow-telemetry oracle: the ``exact``
    backend's log Z reproduced term for term, through the same
    ``exact_topk_decode`` route (``topk_z`` at ``k`` on the card), so the
    exact tier's shadow error is zero bit for bit. Every state carries the
    dense ``w``.

    ``rows`` (Q,) int32 scores only the queries whose entry is nonzero (the
    gated ``topk_z``, no host read) and gives -inf in the others: the
    scheduler's shadow cadence, where JAX takes a ``lax.cond``. A gated
    row's log Z is the ungated one's bit for bit."""
    if rows is None:
        return exact_topk_decode(state.w, h, k=k, use_kernel=use_kernel).log_z
    if use_kernel:
        return topk_z(h, state.w, k, rows=rows)[0]
    lse = exact_topk_decode(state.w, h, k=k, use_kernel=False).log_z
    return torch.where(rows != 0, lse, torch.full_like(lse, float("-inf")))
