"""Cached decode self-attention (counterpart of ``repro.models.attention``,
decode path only). GQA stays grouped: query heads are viewed as
``(n_kv, g, hd)`` and KV heads are never repeated."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from .layers import apply_rope

Params = Dict[str, Any]
NEG = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, n_kv, Dh)
    v: torch.Tensor


def _project_qkv(p: Params, x: torch.Tensor, kv_x: torch.Tensor, cfg):
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"]
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    g = nh // nkv
    q = q.reshape(*x.shape[:-1], nkv, g, hd)       # grouped query heads
    k = k.reshape(*kv_x.shape[:-1], nkv, hd)
    v = v.reshape(*kv_x.shape[:-1], nkv, hd)
    return q, k, v


def _dyn_update(buf: torch.Tensor, row: torch.Tensor, slot: int) -> None:
    """Write one token's KV (B, 1, n_kv, Dh) at ``slot`` of ``buf`` (B, S,
    n_kv, Dh). In place, where the JAX package returns a new buffer: the
    cache is the largest per-request state and is never read after the
    write by anything but the next step."""
    buf[:, slot:slot + 1] = row.to(buf.dtype)


def decode_self_attention(p: Params, x: torch.Tensor, cache: KVCache,
                          pos: int, cfg, *, window: int = 0) -> torch.Tensor:
    """Single-token decode at the absolute position ``pos`` shared by the
    batch. x (B, 1, d) -> out (B, 1, d); ``cache`` is updated in place."""
    q, k, v = _project_qkv(p, x, x, cfg)             # q (B,1,Kv,G,Dh)
    b = x.shape[0]
    qf = apply_rope(q.reshape(b, 1, -1, q.shape[-1]), pos, cfg.rope_theta)
    q = qf.reshape(q.shape)
    k = apply_rope(k, pos, cfg.rope_theta)
    s_max = cache.k.shape[1]
    slot = (pos % window) if window else pos
    _dyn_update(cache.k, k, slot)
    _dyn_update(cache.v, v, slot)
    valid = min(pos + 1, s_max)
    scale = cfg.resolved_head_dim ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), cache.k.float()) * scale
    mask = torch.arange(s_max, device=x.device) < valid
    s = torch.where(mask, s, torch.full_like(s, NEG))
    a = torch.softmax(s, dim=-1).to(cache.v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", a, cache.v)
    return o.reshape(*x.shape[:-1], -1) @ p["wo"]
