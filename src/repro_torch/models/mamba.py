"""Mamba2 (SSD) block, the Zamba2 hybrid's backbone (counterpart of
``repro.models.mamba``).

Separate z/x/BC/dt projections, a depthwise causal conv over time on x and
on (B, C), and a scalar-per-head decay a_t = exp(-dt_t * exp(A_log)):

    h_t = a_t h_{t-1} + dt_t * (x_t outer B_t)      h: (B, H, P, N)
    y_t = C_t . h_t + D x_t

``ssm_scan`` runs the recurrence as a Python loop over time (the JAX
``lax.scan``); decode is one step of it. As in the JAX package the block
has no residual of its own and the state math is f32.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from .layers import _dense_init, rmsnorm

Params = Dict[str, Any]

HEAD_P = 64        # channels a head


def _dims(cfg):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // HEAD_P
    return d_inner, n_heads, HEAD_P, ssm.state_dim, ssm.conv_dim


def init_mamba_block(gen: torch.Generator, cfg, dtype, device) -> Params:
    """One block's parameters, the JAX package's shapes, scales and dtypes
    (``a_log`` f32 whatever ``dtype`` is; the random numbers differ)."""
    d = cfg.d_model
    d_inner, n_h, _, n_state, conv = _dims(cfg)

    def dense(shape):
        return _dense_init(gen, shape, dtype, device)

    def normal01(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * 0.1).to(dtype)

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "wz": dense((d, d_inner)),
        "wx": dense((d, d_inner)),
        "wbc": dense((d, 2 * n_state)),
        "wdt": dense((d, n_h)),
        "conv_x_w": normal01((conv, d_inner)),
        "conv_x_b": full((d_inner,), 0.0),
        "conv_bc_w": normal01((conv, 2 * n_state)),
        "conv_bc_b": full((2 * n_state,), 0.0),
        "a_log": full((n_h,), 0.0, torch.float32),
        "d_skip": full((n_h,), 1.0),
        "dt_bias": full((n_h,), 0.0),
        "norm": {"scale": full((d_inner,), 1.0)},
        "out_proj": dense((d_inner, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state=None):
    """Depthwise causal conv over time: x (B, S, C), w (K, C). ``state``
    (B, K-1, C) holds the last K-1 inputs. Returns (silu(conv + b), new
    state); the taps are summed in the JAX package's order."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    out = xp[:, :s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return F.silu(out + b), new_state


def ssm_scan(x, b_in, c_in, a, dt, h0):
    """The recurrence over time, in f32: x (B, S, H, P), b_in and c_in (B,
    S, N), a and dt (B, S, H), h0 (B, H, P, N). Returns (y (B, S, H, P),
    the last state)."""
    h = h0
    ys = []
    for t in range(x.shape[1]):
        upd = torch.einsum("bhp,bn->bhpn", dt[:, t, :, None] * x[:, t],
                           b_in[:, t])
        h = h * a[:, t, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, c_in[:, t]))
    return torch.stack(ys, 1), h


def mamba_block(p: Params, x: torch.Tensor, cfg, state=None):
    """x (B, S, d) -> (out, new state {conv_x, conv_bc, ssm}); ``state``
    None starts from zeros (training and prefill)."""
    b, s, _ = x.shape
    d_inner, n_h, p_dim, n_state, _ = _dims(cfg)
    z = x @ p["wz"]
    xin = x @ p["wx"]
    bc = x @ p["wbc"]
    dt_raw = x @ p["wdt"]
    cx = state["conv_x"] if state is not None else None
    cb = state["conv_bc"] if state is not None else None
    xconv, new_cx = _causal_conv(xin, p["conv_x_w"], p["conv_x_b"], cx)
    bcconv, new_cb = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"], cb)
    xc = xconv.reshape(b, s, n_h, p_dim)
    b_in = bcconv[..., :n_state].float()                    # (B, S, N)
    c_in = bcconv[..., n_state:].float()
    # softplus as jax.nn.softplus computes it: logaddexp(x, 0)
    dt_in = dt_raw.float() + p["dt_bias"].float()
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))     # (B, S, H)
    a = torch.exp(-dt * torch.exp(p["a_log"]))
    h0 = (state["ssm"] if state is not None else
          torch.zeros((b, n_h, p_dim, n_state), dtype=torch.float32,
                      device=x.device))
    xf = xc.float()
    y, h = ssm_scan(xf, b_in, c_in, a, dt, h0)               # (B, S, H, P)
    y = y + xf * p["d_skip"].float()[:, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rmsnorm(p["norm"], y) * F.silu(z)
    return y @ p["out_proj"], {"conv_x": new_cx, "conv_bc": new_cb,
                               "ssm": h}


def init_mamba_state(batch: int, cfg, dtype, device
                     ) -> Dict[str, torch.Tensor]:
    d_inner, n_h, p_dim, n_state, conv = _dims(cfg)
    return {
        "conv_x": torch.zeros((batch, conv - 1, d_inner), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, conv - 1, 2 * n_state), dtype=dtype,
                               device=device),
        "ssm": torch.zeros((batch, n_h, p_dim, n_state), dtype=torch.float32,
                           device=device),
    }
