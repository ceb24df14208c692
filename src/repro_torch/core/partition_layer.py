"""Output-layer integration of the paper's estimators (counterpart of
``repro.core.partition_layer``).

``PartitionLayer`` owns the estimator choice and the retrieval state the
per-query estimators read (the IVF index for ``mimps``, the global FMBE
sketch for ``fmbe``), built from the output embedding ``w_out (V, d)``.

Its batched entry points take the port's kernels where one computes the
same function (``use_kernel=True``, the default): the exact log Z is
``topk_z``'s LSE at k = 1; ``mimps``'s head scores and ``top_candidates``
with an index are ``ivf_score``'s; the fmbe estimate is ``fmbe_z``'s, on
the sketch ``fmbe_phi`` built. On CPU tensors each kernel wrapper runs its
plain version; ``use_kernel=False`` is the plain path, and a kernel that
fails raises: nothing gives way to the plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import PartitionConfig
from ..kernels.ivf_score import ivf_score, ivf_score_plain
from ..kernels.topk_z import MAX_K, select_topk, topk_z
from . import backends as _backends
from . import estimators as est
from . import mips
from .feature_maps import FeatureMap, FMBEState


@dataclasses.dataclass
class PartitionLayer:
    cfg: PartitionConfig
    index: Optional[mips.IVFIndex] = None
    fmbe_state: Optional[FMBEState] = None

    @staticmethod
    def build(cfg: PartitionConfig, w_out: torch.Tensor,
              generator: Optional[torch.Generator] = None, *,
              assign: Optional[torch.Tensor] = None,
              feature_map: Optional[FeatureMap] = None,
              device="cuda") -> "PartitionLayer":
        """The retrieval state of ``cfg.method`` from the output embedding
        (its rows are the class vectors v_i), through the method's backend
        (``core.backends``). Only the state the per-query estimators read:
        mimps gets its index, fmbe the global sketch (no index), so
        ``top_candidates`` stays exact for the accuracy studies.
        ``generator`` draws the k-means start and the feature map, or
        ``assign`` / ``feature_map`` inject them."""
        cfg.validate()
        index = fmbe_state = None
        if cfg.method in _backends.BACKENDS:
            state = _backends.get_backend(cfg.method).build(
                cfg, w_out, generator=generator, assign=assign,
                feature_map=feature_map, device=device,
                with_index=(cfg.method == "mimps"))
            index, fmbe_state = state.index, state.fmbe
        return PartitionLayer(cfg=cfg, index=index, fmbe_state=fmbe_state)

    def log_z(self, w_out: torch.Tensor, h: torch.Tensor,
              generator: Optional[torch.Generator] = None, *,
              draws: Optional[torch.Tensor] = None,
              use_kernel: bool = True) -> torch.Tensor:
        """Batched log Ẑ: h (B, d) -> (B,). ``draws (B, l)`` injects each
        query's uniform draws (``estimators.estimate_log_z``); else
        ``generator`` draws them."""
        cfg = self.cfg
        return est.estimate_log_z(
            cfg.method, w_out, h, generator, k=cfg.k, l=cfg.l,
            index=self.index, n_probe=cfg.n_probe,
            fmbe_state=self.fmbe_state, mince_iters=cfg.mince_iters,
            mince_solver=cfg.mince_solver, draws=draws,
            use_kernel=use_kernel)

    def top_candidates(self, w_out: torch.Tensor, h: torch.Tensor, k: int,
                       generator: Optional[torch.Generator] = None, *,
                       use_kernel: bool = True):
        """(scores (B, k) f32, ids (B, k) int32) of the retrieved head,
        best first, ties to the lower id. With an index: the probed blocks'
        rows (``ivf_score``), pad rows masked. Without: every row, through
        ``topk_z`` for k <= ``MAX_K``; past it, the plain product
        ``h @ w_out.T`` (which the JAX package also computes outside any
        kernel) and a sort: a rule by shape, not a fallback."""
        del generator                          # nothing is drawn
        if self.index is None:
            if use_kernel and k <= MAX_K:
                _, vals, ids = topk_z(h, w_out, k)
                return vals, ids
            scores = est._scores(w_out, h)
            return select_topk(scores, torch.arange(
                w_out.shape[0], device=scores.device), k)
        index = self.index
        blocks = mips.probe_batch(index, h, self.cfg.n_probe)
        score = ivf_score if use_kernel else ivf_score_plain
        s = score(index.v_blocks, h, blocks).reshape(h.shape[0], -1)
        valid = index.valid[blocks.long()].reshape(h.shape[0], -1)
        s = torch.where(valid, s, torch.full_like(s, est.NEG_INF))
        pos = torch.sort(s, dim=-1, descending=True, stable=True).indices
        pos = pos[:, :k]
        br = index.block_rows
        rid = index.row_id[torch.gather(blocks.long(), 1, pos // br),
                           pos % br]
        return torch.gather(s, 1, pos), rid

    def normalized_top_prob(self, w_out: torch.Tensor, h: torch.Tensor,
                            generator: Optional[torch.Generator] = None, *,
                            draws: Optional[torch.Tensor] = None,
                            use_kernel: bool = True):
        """The paper's Eq. 2/3: (argmax id (B,), p(i_hat) (B,)) under the
        estimated Z."""
        vals, ids = self.top_candidates(w_out, h, 1, use_kernel=use_kernel)
        log_z = self.log_z(w_out, h, generator, draws=draws,
                           use_kernel=use_kernel)
        return ids[:, 0], torch.exp(vals[:, 0] - log_z)
