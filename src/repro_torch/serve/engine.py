"""Serving engine: cached decode with partition-estimated probabilities
(counterpart of ``repro.serve.engine``; the port carries ``Engine``,
``decode_step``, ``next_token_distribution`` and ``generate``).

Every method dispatches through the estimator-backend registry: one batched
decode returns log Ẑ plus the retrieved top ``sample_k`` candidates, and
sampling (greedy, or Gumbel-max at temperature T over the candidates)
happens once on top.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from .. import resolve_device
from ..core.backends import BACKENDS, get_backend
from ..core.decode import DecodeOut
from ..core.feature_maps import FeatureMap
from ..models import Model


@dataclasses.dataclass
class ServeState:
    cache: Any                   # KV cache dict, updated in place
    pos: int                     # next position to write
    last_token: torch.Tensor     # (B,)


class Engine:
    """Batched serving for one model. The retrieval state (IVF index, FMBE
    sketch, LSH index) is built once from the output embedding by the
    method's backend; training-only methods serve through ``exact``.

    ``seed`` seeds the engine's generator on ``device``, which draws the
    FMBE feature map, the k-means initialisation, the LSH hyperplanes, the
    tail samples and the Gumbel noise; ``index_assign`` injects the index's
    k-means assignment, ``feature_map`` the feature map and ``lsh_proj`` the
    (L, K, d+1) hyperplanes instead."""

    def __init__(self, model: Model, params, max_len: int, *, seed: int = 0,
                 use_kernel: bool = True, device="cuda",
                 index_assign: Optional[torch.Tensor] = None,
                 feature_map: Optional[FeatureMap] = None,
                 lsh_proj: Optional[torch.Tensor] = None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.max_len = max_len
        self.use_kernel = use_kernel
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        pc = self.cfg.partition
        method = pc.method if pc.method in BACKENDS else "exact"
        self.backend = get_backend(method)
        self.state = self.backend.build(
            pc, model.head_matrix(params), generator=self.generator,
            assign=index_assign, feature_map=feature_map, lsh_proj=lsh_proj,
            device=self.device)
        self.index = self.state.index

    def decode_step(self, state: ServeState, temperature: float = 0.0,
                    tail_idx: Optional[torch.Tensor] = None
                    ) -> tuple[Dict[str, torch.Tensor], ServeState]:
        """One token for every stream; returns sampling outputs + new state.
        A position past ``max_len`` raises: the KV write would clobber."""
        if state.pos >= self.max_len:
            raise ValueError(
                f"decode position {state.pos} is past the KV-cache capacity "
                f"max_len={self.max_len}; the write would wrap/clobber "
                f"earlier positions")
        h = self.model.decode_step(self.params, state.cache,
                                   state.last_token, state.pos)
        out = self.next_token_distribution(h, temperature, tail_idx=tail_idx)
        return out, ServeState(cache=state.cache, pos=state.pos + 1,
                               last_token=out["token"])

    def next_token_distribution(self, h: torch.Tensor,
                                temperature: float = 0.0, *,
                                tail_idx: Optional[torch.Tensor] = None
                                ) -> Dict[str, torch.Tensor]:
        """Sample one token per stream: greedy at temperature 0, else
        Gumbel-max over the retrieved candidates; the reported probability
        is normalised by the estimated log Ẑ."""
        pc = self.cfg.partition
        out = self.backend.decode(self.state, h, pc, k=pc.sample_k,
                                  use_kernel=self.use_kernel,
                                  generator=self.generator,
                                  tail_idx=tail_idx)
        return _sample_candidates(out, temperature, self.generator)


def _sample_candidates(out: DecodeOut, temperature: float,
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Gumbel-max over retrieved candidates: token ~ softmax(s/T) restricted
    to the head (filler candidates at NEG are never drawn). log_prob is the
    T=1 probability of the chosen token, normalised with the estimated
    log Ẑ. At temperature 0 the pick is candidate 0, the top score."""
    q = out.top_score.shape[0]
    if temperature > 0.0:
        e = torch.empty(out.top_score.shape, dtype=torch.float32,
                        device=out.top_score.device)
        gumbel = -torch.log(e.exponential_(generator=generator)
                            .clamp_min(1e-30))
        pick = torch.argmax(out.top_score / temperature + gumbel, dim=-1)
    else:
        pick = torch.zeros((q,), dtype=torch.long,
                           device=out.top_score.device)
    tok = torch.gather(out.top_id, 1, pick[:, None])[:, 0]
    score = torch.gather(out.top_score, 1, pick[:, None])[:, 0]
    return {"token": tok.long(), "log_prob": score - out.log_z,
            "log_z": out.log_z}


def generate(engine: Engine, prompt, n_tokens: int, *,
             temperature: float = 0.0,
             tail_source: Optional[Callable[[int], Any]] = None,
             return_aux: bool = False):
    """Generation loop; returns (B, n_tokens) token ids on the engine's
    device. The prompt is replayed through the decode cache one step per
    token, and the last replay step emits the first sample.

    ``tail_source(step_id)`` optionally supplies the tail sample indices of
    each step, where ``step_id`` is ``t`` for replay step ``t`` and
    ``10_000 + t`` for generation step ``t`` (the JAX engine's key
    schedule); without it the engine's generator draws them."""
    prompt = torch.as_tensor(prompt, device=engine.device).long()
    if prompt.shape[1] == 0:
        raise ValueError(
            "generate() needs a non-empty prompt: the first sample is "
            "emitted by the last prompt-replay step")
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    t_replay = prompt.shape[1]
    if t_replay + n_tokens - 1 > engine.max_len:
        raise ValueError(
            f"prompt length {t_replay} + {n_tokens} generated tokens needs "
            f"{t_replay + n_tokens - 1} cache positions but the engine was "
            f"built with max_len={engine.max_len}")

    def tail(step_id):
        if tail_source is None:
            return None
        return torch.as_tensor(tail_source(step_id), device=engine.device)

    batch = prompt.shape[0]
    state = ServeState(
        cache=engine.model.init_decode_state(batch, engine.max_len,
                                             engine.device),
        pos=0, last_token=prompt[:, 0])
    outs = []
    out = None
    for t in range(t_replay):
        state = dataclasses.replace(state, last_token=prompt[:, t])
        out, state = engine.decode_step(state, temperature, tail_idx=tail(t))
    outs.append(out)
    for t in range(n_tokens - 1):
        out, state = engine.decode_step(state, temperature,
                                        tail_idx=tail(10_000 + t))
        outs.append(out)
    toks = torch.stack([o["token"] for o in outs], dim=1)
    if return_aux:
        return toks, {
            "log_prob": torch.stack([o["log_prob"] for o in outs], dim=1),
            "log_z": torch.stack([o["log_z"] for o in outs], dim=1)}
    return toks
