"""Attention (counterpart of ``repro.models.attention``): the chunked
causal attention of training and prefill, the VLM's cross attention from
the text stream to the image embeddings, the cached decode step at a shared
or a per-lane position, and the lane-window KV ops of the prefix cache. GQA
stays grouped: query heads are viewed as ``(n_kv, g, hd)`` and KV heads are
never repeated."""
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


def cross_attention(p: Params, x: torch.Tensor, kv_feats: torch.Tensor,
                    cfg) -> torch.Tensor:
    """VLM cross attention: queries from the text stream x (B, S, d), keys
    and values projected from the image embeddings ``kv_feats`` (B, N, d)
    in the same dtype; no mask and no RoPE. At decode S is 1 and the
    image's K and V are projected again every step, as the JAX package
    does (it keeps no cross-KV cache)."""
    q, k, v = _project_qkv(p, x, kv_feats, cfg)
    o = flash_attention(q, k, v, causal=False)
    return o.reshape(*x.shape[:-1], -1) @ p["wo"]


class DecodePosition(NamedTuple):
    """One decode step's position, made once a step and read by every
    layer (``decode_position``)."""
    pos: torch.Tensor    # 0-d or (B,) int: the absolute position
    rope: torch.Tensor   # (1,) | (B, 1): positions for ``apply_rope``
    slot: torch.Tensor   # 0-d or (B,) int64: the KV slot written
    mask: torch.Tensor   # (S,) | (B, 1, 1, 1, S) bool: the slots attended


def decode_position(pos: torch.Tensor, s_max: int,
                    window: int = 0) -> DecodePosition:
    """The device tensors a decode step derives from its position ``pos``
    (0-d, shared by the batch, or (B,), one a lane) for a cache of
    ``s_max`` slots: the ring slot ``pos % window`` of a sliding-window
    cache, clamped into the cache as ``lax.dynamic_update_slice`` clamps,
    and the mask of the ``min(pos + 1, s_max)`` valid slots. Nothing is
    read to the host."""
    per_lane = pos.dim() == 1
    slot = (pos % window) if window else pos
    slot = torch.clamp(slot.long(), 0, s_max - 1)
    valid = torch.clamp(pos + 1, max=s_max)
    kv_idx = torch.arange(s_max, device=pos.device)
    if per_lane:
        mask = (kv_idx[None, :] < valid[:, None])[:, None, None, None, :]
    else:
        mask = kv_idx < valid
    return DecodePosition(pos=pos, rope=pos[:, None] if per_lane
                          else pos[None], slot=slot, mask=mask)


def _dyn_update(buf: torch.Tensor, row: torch.Tensor,
                slot: torch.Tensor) -> None:
    """Write one token's KV (B, 1, n_kv, Dh) at ``slot`` of ``buf`` (B, S,
    n_kv, Dh): a 0-d int64 slot for the whole batch, or a (B,) slot vector,
    one slot a lane. In place, where the JAX package returns a new buffer:
    the cache is the largest per-request state and is never read after the
    write by anything but the next step."""
    row = row.to(buf.dtype)
    if slot.dim() == 0:
        buf.index_copy_(1, slot.view(1), row)
    else:
        lanes = torch.arange(buf.shape[0], device=buf.device)
        buf.index_put_((lanes, slot), row[:, 0])


def decode_self_attention(p: Params, x: torch.Tensor, cache: KVCache, pos,
                          cfg, *, window: int = 0) -> torch.Tensor:
    """Single-token decode. x (B, 1, d) -> out (B, 1, d); ``cache`` is
    updated in place. ``pos`` is the absolute position as an int tensor on
    the device, 0-d (shared by the batch: ``generate``'s lock-step loop) or
    (B,) (one a lane, each at its own depth), or the ``DecodePosition`` made
    from it once a step. Nothing is read to the host, so the step can be
    captured in a CUDA graph. For sliding-window layers the cache is a ring
    buffer of length ``window``."""
    if not isinstance(pos, DecodePosition):
        pos = decode_position(pos, cache.k.shape[1], window)
    q, k, v = _project_qkv(p, x, x, cfg)             # q (B,1,Kv,G,Dh)
    b = x.shape[0]
    qf = apply_rope(q.reshape(b, 1, -1, q.shape[-1]), pos.rope,
                    cfg.rope_theta)
    q = qf.reshape(q.shape)
    k = apply_rope(k, pos.rope, cfg.rope_theta)
    _dyn_update(cache.k, k, pos.slot)
    _dyn_update(cache.v, v, pos.slot)
    scale = cfg.resolved_head_dim ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), cache.k.float()) * scale
    s = torch.where(pos.mask, s, torch.full_like(s, NEG))
    a = torch.softmax(s, dim=-1).to(cache.v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", a, cache.v)
    return o.reshape(*x.shape[:-1], -1) @ p["wo"]


# -- lane-window KV block ops (the prefix cache) ------------------------------
#
# Every k/v leaf keeps the lane batch at axis -4 and token positions at
# axis -3 (the model's stacked layers add leading axes). The lane and the
# start are int tensors on the device, so one captured graph serves every
# (lane, offset) pair; the window's length is a Python int. Starts are
# clamped so the window lies inside the leaf, as ``lax.dynamic_slice`` and
# ``lax.dynamic_update_slice`` clamp them.


def _lane_window_index(leaf: torch.Tensor, lane, start,
                       length: int) -> torch.Tensor:
    """Flat (lane, position) indices of the window into ``leaf`` viewed as
    (*stack, lanes * positions, n_kv, Dh)."""
    n_lanes, n_pos = leaf.shape[-4], leaf.shape[-3]
    lane = torch.clamp(torch.as_tensor(lane, device=leaf.device).long(),
                       0, n_lanes - 1)
    start = torch.clamp(torch.as_tensor(start, device=leaf.device).long(),
                        0, n_pos - length)
    return lane * n_pos + start + torch.arange(length, device=leaf.device)


def _flat_lanes(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.view(*leaf.shape[:-4], leaf.shape[-4] * leaf.shape[-3],
                     *leaf.shape[-2:])


def slice_lane_window(leaf: torch.Tensor, lane, start,
                      length: int) -> torch.Tensor:
    """Read ``length`` consecutive KV rows of one lane: leaf (*stack, S, L,
    n_kv, Dh) -> (*stack, 1, length, n_kv, Dh), a copy."""
    idx = _lane_window_index(leaf, lane, start, length)
    rows = _flat_lanes(leaf).index_select(-3, idx)
    return rows.view(*leaf.shape[:-4], 1, length, *leaf.shape[-2:])


def write_lane_window(leaf: torch.Tensor, rows: torch.Tensor, lane,
                      start) -> torch.Tensor:
    """Multi-token append: write ``rows`` (*stack, 1, length, n_kv, Dh) into
    one lane of ``leaf`` at positions [start, start + length), in place
    (``_dyn_update`` widened to a window); returns ``leaf``."""
    length = rows.shape[-3]
    idx = _lane_window_index(leaf, lane, start, length)
    src = rows.to(leaf.dtype).reshape(*leaf.shape[:-4], length,
                                      *leaf.shape[-2:])
    _flat_lanes(leaf).index_copy_(-3, idx, src)
    return leaf
