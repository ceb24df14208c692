"""Self-attention (counterpart of ``repro.models.attention``, without the
cross-attention and lane-window paths): the chunked causal attention of
training and prefill, and the cached decode step. GQA stays grouped: query
heads are viewed as ``(n_kv, g, hd)`` and KV heads are never repeated."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

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


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, block_kv: int = 1024) -> torch.Tensor:
    """Chunked attention with an online softmax, GQA-grouped, the same
    arithmetic as the JAX package's: f32 scores, probabilities rounded to
    v's dtype before the f32-accumulated product with v.

    q (B, Sq, Kv, G, Dh); k, v (B, Skv, Kv, Dh). ``window > 0`` limits
    attention to the last ``window`` positions. Returns (B, Sq, Kv, G, Dh).
    The JAX package rematerialises each chunk in the backward; here the
    caller's block checkpoint does that."""
    b, sq, kv_h, g, hd = q.shape
    skv = k.shape[1]
    block_kv = min(block_kv, skv)
    dev = q.device
    scale = hd ** -0.5
    q_pos = q_offset + torch.arange(sq, device=dev)
    qf = q.float()
    m = torch.full((b, kv_h, g, sq), NEG, dtype=torch.float32, device=dev)
    s_sum = torch.zeros((b, kv_h, g, sq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, kv_h, g, sq, hd), dtype=torch.float32, device=dev)
    for start in range(0, skv, block_kv):
        kc = k[:, start:start + block_kv]
        vc = v[:, start:start + block_kv]
        kv_pos = start + torch.arange(kc.shape[1], device=dev)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kc.float()) * scale
        mask = torch.ones((sq, kc.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window:
            mask &= q_pos[:, None] - kv_pos[None, :] < window
        s = torch.where(mask, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        s_sum = s_sum * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = o / torch.clamp(s_sum, min=1e-30)[..., None]   # (B, Kv, G, Sq, Dh)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)        # (B, Sq, Kv, G, Dh)


def self_attention(p: Params, x: torch.Tensor, cfg, *, window: int = 0,
                   positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / prefill self-attention (causal). x (B, S, d)."""
    q, k, v = _project_qkv(p, x, x, cfg)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    b, s = x.shape[:2]
    qf = q.reshape(b, s, -1, q.shape[-1])            # (B,S,H,Dh) for rope
    qf = apply_rope(qf, positions, cfg.rope_theta)
    q = qf.reshape(q.shape)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, window=window)
    return o.reshape(*x.shape[:-1], -1) @ p["wo"]


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
