"""Transformer: full-sequence forward (training) and cached decode
(counterpart of ``repro.models.transformer``; the dense and MoE families).

Parameters keep the JAX package's pytree layout — a dict whose per-layer
leaves are stacked on a leading layer axis — so ``interop.params_from_numpy``
is a leaf-wise conversion. A Python loop over layers takes the place of
``lax.scan``, and ``torch.utils.checkpoint`` that of ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from .attention import (KVCache, decode_position, decode_self_attention,
                        self_attention)
from .layers import _dense_init, embed, mlp, rmsnorm
from .moe import init_moe, moe_block

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind(tree: Params) -> Params:
    """Each stacked leaf as a tuple of per-layer views, for ``_layer``.
    ``unbind`` has one backward node that stacks every layer's gradient at
    once; indexing each layer would add a zero-filled full-size gradient
    per layer."""
    return {k: _unbind(v) if isinstance(v, dict) else torch.unbind(v, 0)
            for k, v in tree.items()}


# the dense family's aux losses, all zero (the JAX package's ZERO_AUX)
ZERO_AUX = {"moe_balance": 0.0, "moe_zloss": 0.0, "moe_drop_frac": 0.0}


def _add_aux(a: Dict, b: Dict) -> Dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + v
    return out


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe") or cfg.local_global_ratio \
            or cfg.n_codebooks:
        raise NotImplementedError(
            f"the port serves the dense and moe families only; {cfg.name!r} "
            f"is family {cfg.family!r} (repro.models.transformer's "
            f"{cfg.family} plan is not ported)")


def _ffn(p: Params, y, cfg, kind: str):
    if kind == "moe":
        return moe_block(p, y, cfg)
    return mlp(p, y, cfg.act), ZERO_AUX


def tblock_fwd(p: Params, x, cfg, *, kind="dense", window=0):
    """One block over a full sequence x (B, S, d): (x, aux)."""
    h = self_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                       window=window)
    x = x + h
    f, aux = _ffn(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, kind)
    return x + f, aux


def tblock_decode(p: Params, x, cache: KVCache, pos, cfg, *, kind="dense",
                  window=0):
    """One block at one decode position: ``pos`` a 0-d or (B,) int
    tensor, or its ``attention.DecodePosition``."""
    h = decode_self_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                              cache, pos, cfg, window=window)
    x = x + h
    f, _ = _ffn(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, kind)
    return x + f


class Model:
    """Functional model for one ModelConfig of the dense or MoE family."""

    def __init__(self, cfg: ModelConfig):
        _check_family(cfg)
        self.cfg = cfg
        self.kind = "moe" if cfg.family == "moe" else "dense"

    def init(self, gen: torch.Generator, device="cuda") -> Params:
        """Seeded random init at the config's widths, on ``device`` (the
        generator must live there too). Same shapes and scales as the JAX
        package's ``Model.init``; the random numbers differ."""
        dev = resolve_device(device)
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        d, L, hd = cfg.d_model, cfg.n_layers, cfg.resolved_head_dim
        nh, nkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

        def dense(shape, scale=None):
            return _dense_init(gen, shape, dt, dev, scale)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        attn = {"wq": dense((L, d, nh * hd)), "wk": dense((L, d, nkv * hd)),
                "wv": dense((L, d, nkv * hd)), "wo": dense((L, nh * hd, d))}
        if cfg.qkv_bias:
            for name, width in (("bq", nh), ("bk", nkv), ("bv", nkv)):
                attn[name] = torch.zeros((L, width * hd), dtype=dt,
                                         device=dev)
        if self.kind == "moe":
            ffn = init_moe(gen, cfg, L, dt, dev)
        else:
            ffn = {"down": dense((L, ff, d))}
            if cfg.act == "sqrelu":
                ffn["up"] = dense((L, d, ff))
            else:
                ffn["gate"] = dense((L, d, ff))
                ffn["up"] = dense((L, d, ff))
        p: Params = {
            "embed": {"table": dense((cfg.vocab, d), scale=1.0)},
            "final_norm": {"scale": ones(d)},
            "blocks": {"ln1": {"scale": ones(L, d)}, "attn": attn,
                       "ln2": {"scale": ones(L, d)}, "ffn": ffn},
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = dense((cfg.vocab, d))
        return p

    def embed_tokens(self, p: Params, tokens: torch.Tensor) -> torch.Tensor:
        return embed(p["embed"], tokens)

    def head_matrix(self, p: Params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return p["embed"]["table"]
        return p["lm_head"]

    def logits(self, p: Params, hidden: torch.Tensor) -> torch.Tensor:
        """Full logits — small-vocab path / tests only (O(T V) memory)."""
        return hidden @ self.head_matrix(p).T

    def forward(self, p: Params, tokens: torch.Tensor, *,
                img=None) -> Tuple[torch.Tensor, Dict[str, float]]:
        """tokens (B, S) -> (hidden (B, S, d), aux). With ``cfg.remat`` other
        than "none" each block runs under a non-reentrant checkpoint: its
        activations are recomputed in the backward, as under
        ``jax.checkpoint``."""
        if img is not None:
            raise NotImplementedError(
                "the port's families take no image (the vlm family's "
                "cross_block_fwd is not ported)")
        cfg = self.cfg
        x = self.embed_tokens(p, tokens)
        remat = cfg.remat != "none"
        blocks = _unbind(p["blocks"])
        aux = ZERO_AUX
        for i in range(cfg.n_layers):
            layer = _layer(blocks, i)
            if remat:
                x, a = checkpoint(tblock_fwd, layer, x, cfg, kind=self.kind,
                                  window=cfg.sliding_window,
                                  use_reentrant=False)
            else:
                x, a = tblock_fwd(layer, x, cfg, kind=self.kind,
                                  window=cfg.sliding_window)
            aux = _add_aux(aux, a)
        return rmsnorm(p["final_norm"], x, cfg.norm_eps), aux

    def init_decode_state(self, batch: int, max_len: int,
                          device) -> Dict[str, torch.Tensor]:
        """KV cache {"k", "v"}: (L, B, S, n_kv, hd) each."""
        cfg = self.cfg
        length = min(max_len, cfg.sliding_window) if cfg.sliding_window \
            else max_len
        shape = (cfg.n_layers, batch, length, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        dt = torch_dtype(cfg.dtype)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def decode_step(self, p: Params, state: Dict[str, torch.Tensor],
                    token: torch.Tensor, pos) -> torch.Tensor:
        """token (B,) at position ``pos`` -> hidden of that position (B, d).
        ``pos`` is an int tensor on the device, 0-d (shared by the batch)
        or (B,) (one a lane), or a Python int (copied to the device).
        ``state`` (the KV cache) is updated in place; with a tensor
        position nothing is read to the host."""
        cfg = self.cfg
        if not isinstance(pos, torch.Tensor):
            pos = torch.tensor(pos, dtype=torch.int32, device=token.device)
        dpos = decode_position(pos, state["k"].shape[2], cfg.sliding_window)
        x = embed(p["embed"], token[:, None])                  # (B, 1, d)
        for i in range(cfg.n_layers):
            cache = KVCache(k=state["k"][i], v=state["v"][i])
            x = tblock_decode(_layer(p["blocks"], i), x, cache, dpos, cfg,
                              kind=self.kind, window=cfg.sliding_window)
        h = rmsnorm(p["final_norm"], x, cfg.norm_eps)
        return h[:, 0]
