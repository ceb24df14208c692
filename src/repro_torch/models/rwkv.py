"""RWKV6 "Finch" block (counterpart of ``repro.models.rwkv``): token-shift
time mix with a data-dependent decay, then a squared-ReLU channel mix.
Attention-free: the per-head (head_size x head_size) state makes decode
O(1) in context.

The recurrence, per head, with decay w_t = exp(-exp(w0 + lora(x_t))) and
the bonus ``u`` of the current token:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

``wkv_scan`` runs it as a Python loop over time (the JAX ``lax.scan``);
decode is one step of it. The JAX package's dtype order is kept: r, k and
v stay in the model dtype, the state math is f32, the decay is summed in
the model dtype and exponentiated in f32, and the per-head norm is f32
(eps 1e-5) with its output cast back before the gate.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import _dense_init

Params = Dict[str, Any]

LORA = 64          # rank of the decay's LoRA


def _heads(cfg):
    hs = cfg.ssm.wkv_head_size if cfg.ssm else 64
    return cfg.d_model // hs, hs


def init_rwkv_block(gen: torch.Generator, cfg, dtype, device) -> Params:
    """One block's parameters, the JAX package's shapes and scales (the
    random numbers differ)."""
    d = cfg.d_model
    n_h, hs = _heads(cfg)

    def dense(shape):
        return _dense_init(gen, shape, dtype, device)

    def mu(n):
        u = torch.rand((n, d), generator=gen, dtype=torch.float32,
                       device=device)
        return (u * 0.5 + 0.25).to(dtype)

    mix = {
        "mu": mu(5),
        "wr": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
        "wg": dense((d, d)), "wo": dense((d, d)),
        "decay_w0": torch.full((d,), -6.0, dtype=dtype, device=device),
        "decay_a": dense((d, LORA)),
        "decay_b": dense((LORA, d)),
        "bonus_u": (torch.randn((n_h, hs), generator=gen,
                                dtype=torch.float32, device=device)
                    * 0.1).to(dtype),
        "ln_x": {"scale": torch.ones((d,), dtype=dtype, device=device)},
    }
    cmix = {"mu": mu(2), "wk": dense((d, cfg.d_ff)),
            "wv": dense((cfg.d_ff, d)), "wr": dense((d, d))}
    return {"mix": mix, "cmix": cmix}


def _token_shift(x: torch.Tensor, x_last: torch.Tensor) -> torch.Tensor:
    """Shift right by one along time; ``x_last`` fills position 0."""
    return torch.cat([x_last[:, None], x[:, :-1]], dim=1)


def wkv_scan(r, k, v, w, u, state0):
    """The recurrence over time. r, k, v (B, S, H, hs) in the model dtype,
    w (B, S, H, hs) f32 decay in (0, 1), u (H, hs) f32, state (B, H, hs,
    hs) f32. Returns (out (B, S, H, hs) f32, state)."""
    s = state0
    outs = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t].float(), v[:, t].float())
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                                 s + u[None, :, :, None] * kv))
        s = s * w[:, t][..., None] + kv
    return torch.stack(outs, 1), s


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg, x_last, state0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d). Returns (out, new x_last, new wkv state)."""
    n_h, hs = _heads(cfg)
    b, s, d = x.shape
    xs = _token_shift(x, x_last)
    mu = p["mu"]
    xr, xk, xv, xg, xw = (x + (xs - x) * mu[i] for i in range(5))
    r = (xr @ p["wr"]).reshape(b, s, n_h, hs)
    k = (xk @ p["wk"]).reshape(b, s, n_h, hs)
    v = (xv @ p["wv"]).reshape(b, s, n_h, hs)
    g = F.silu(xg @ p["wg"])
    decay = p["decay_w0"] + (xw @ p["decay_a"]) @ p["decay_b"]
    w = torch.exp(-torch.exp(decay.float())).reshape(b, s, n_h, hs)
    out, state = wkv_scan(r, k, v, w, p["bonus_u"].float(), state0)
    # per-head group norm (RWKV6's GroupNorm(n_heads)), in f32
    var = out.square().mean(-1, keepdim=True)
    out = out * torch.rsqrt(var + 1e-5)
    out = out * p["ln_x"]["scale"].float().reshape(n_h, hs)
    out = out.reshape(b, s, d).to(x.dtype) * g
    return out @ p["wo"], x[:, -1], state


def rwkv_channel_mix(p: Params, x: torch.Tensor, x_last):
    xs = _token_shift(x, x_last)
    mu = p["mu"]
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = F.relu(xk @ p["wk"]).square()
    return (k @ p["wv"]) * torch.sigmoid(xr @ p["wr"]), x[:, -1]


class RWKVState:
    """Decode-time state of one layer: the time mix's and the channel
    mix's last input, and the f32 wkv state."""

    @staticmethod
    def init(batch: int, cfg, dtype, device) -> Dict[str, torch.Tensor]:
        n_h, hs = _heads(cfg)
        return {
            "tm_last": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                   device=device),
            "cm_last": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                   device=device),
            "wkv": torch.zeros((batch, n_h, hs, hs), dtype=torch.float32,
                               device=device),
        }


def rwkv_block(p: Params, x: torch.Tensor, cfg, state=None):
    """The block (residual around each mix) over x (B, S, d): (out, new
    state). ``state`` None starts from zeros (training and prefill)."""
    if state is None:
        state = RWKVState.init(x.shape[0], cfg, x.dtype, x.device)
    tm_out, tm_last, wkv = rwkv_time_mix(
        p["mix"], x, cfg, state["tm_last"], state["wkv"])
    x = x + tm_out
    cm_out, cm_last = rwkv_channel_mix(p["cmix"], x, state["cm_last"])
    x = x + cm_out
    return x, {"tm_last": tm_last, "cm_last": cm_last, "wkv": wkv}
