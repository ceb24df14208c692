"""Fine-grained MoE (DeepSeek-MoE family): shared experts plus top-k routed
experts with capacity-based dispatch (counterpart of ``repro.models.moe``).

The block computes what the JAX package's ``moe_block`` computes, in a form
that keeps a decode step inside one CUDA graph: no boolean-mask indexing, no
``nonzero``, no host read, and every shape fixed by the input's static
shape. Where JAX's scatter-add and ``lax.top_k`` fix an order, the port
fixes the same one without atomics:

* the router product runs in f32 with TF32 off whatever the caller's
  global flag (``_no_tf32``);
* the top-k is a stable descending sort, so a tie keeps the lower expert
  index first, as ``lax.top_k`` does;
* dispatch writes each kept (token, choice) into its unique slot of an
  (E, C + 1, d) buffer; the dropped ones land in the sink row C, which is
  sliced off (JAX adds their zeros into slot C - 1: the same buffer);
* the combine sums each token's k choices in choice order from zeros
  (JAX's scatter-add order; ``index_add_`` adds with atomics on CUDA).

The experts run densely over the (E, C, d) buffer, every expert every
call, as the JAX package's ``vmap`` does.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch

from ..core.distributed import from_model, model_rank, to_model
from .layers import _dense_init, mlp

Params = Dict[str, Any]


def _stacked_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """``_dense_init`` of a stacked leaf drawn one leading index at a time:
    the f32 draw of one slice is alive at once, not of the whole leaf (an
    expert leaf of deepseek-moe-16b is 5.17 G elements). Same shape and
    scale as ``_dense_init``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = _dense_init(gen, shape[1:], dtype, device)
    return out


def init_moe(gen: torch.Generator, cfg, n_layers: int, dtype,
             device) -> Params:
    """The MoE FFN of ``n_layers`` blocks, stacked on a leading layer axis
    in the JAX tree: ``router`` (L, d, E) in f32 whatever ``dtype`` is,
    ``experts`` {gate, up, down} (L, E, ...) and, with shared experts,
    ``shared`` (L, n_shared, ...). Expert leaves are drawn a layer at a
    time."""
    m = cfg.moe
    d, ff, L = cfg.d_model, m.expert_d_ff, n_layers

    def mlp_leaves(n, draw):
        p = {"down": draw((L, n, ff, d))}
        if cfg.act == "sqrelu":
            p["up"] = draw((L, n, d, ff))
        else:
            p["gate"] = draw((L, n, d, ff))
            p["up"] = draw((L, n, d, ff))
        return p

    p: Params = {
        "router": _dense_init(gen, (L, d, m.n_experts), torch.float32,
                              device),
        "experts": mlp_leaves(m.n_experts, lambda s: _stacked_init(
            gen, s, dtype, device)),
    }
    if m.n_shared:
        p["shared"] = mlp_leaves(m.n_shared, lambda s: _dense_init(
            gen, s, dtype, device))
    return p


@contextlib.contextmanager
def _no_tf32():
    """Products inside run in full f32 (no TF32), whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says outside; the flag is
    restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def route(router: torch.Tensor, xf: torch.Tensor, top_k: int):
    """Router logits (T, E) f32, softmax probabilities, and the top-k
    (values, expert ids) in ``lax.top_k``'s order: descending, the lower
    expert first on a tie."""
    with _no_tf32():
        logits = xf.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return logits, probs, top_p[:, :top_k], top_e[:, :top_k]


def capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens, from the static shape with the
    JAX package's arithmetic."""
    m = cfg.moe
    return max(int(m.capacity_factor * t * m.top_k / m.n_experts), 4)


def moe_block(p: Params, x: torch.Tensor,
              cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d), aux losses): ``moe_balance``,
    ``moe_zloss`` and ``moe_drop_frac``, 0-d f32 tensors."""
    m = cfg.moe
    b, s, d = x.shape
    t, k, n_exp = b * s, m.top_k, m.n_experts
    xf = x.reshape(t, d)
    logits, probs, top_p, top_e = route(p["router"], xf, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(cfg, t)

    # slot of each (token, choice) within its expert, in flat order
    flat_e = top_e.reshape(-1)                                 # (T k,)
    onehot = (flat_e[:, None] == torch.arange(
        n_exp, device=x.device)[None, :]).to(torch.int32)      # (T k, E)
    slot = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    keep = slot < cap

    # dispatch: kept slots are unique; dropped entries go to sink row cap
    tok_idx = torch.arange(t, device=x.device)[:, None].expand(t, k) \
        .reshape(-1)
    buf = torch.zeros((n_exp, cap + 1, d), dtype=x.dtype, device=x.device)
    # expert parallelism: a train step's split holds E / model experts a
    # rank, [lo, lo + n_local); their dispatch rows come from every rank's
    # copy of x, so x's gradient through them is summed over 'model'
    n_local = p["experts"]["down"].shape[-3]
    split_e = n_local != n_exp
    lo = model_rank() * n_local if split_e else 0
    xe = to_model(xf) if split_e else xf
    buf[flat_e, torch.where(keep, slot, torch.full_like(slot, cap))] = \
        xe[tok_idx]
    out_buf = mlp(p["experts"], buf[lo:lo + n_local, :cap],
                  cfg.act)                                     # (E, C, d)

    # combine: the k choices of a token summed in choice order from zeros
    # (under the split, this rank's experts' choices, then summed over
    # 'model'; the router's gradient through top_p likewise)
    mine = keep
    if split_e:
        mine = keep & (flat_e >= lo) & (flat_e < lo + n_local)
        top_p = to_model(top_p)
    gathered = out_buf[torch.clamp(flat_e - lo, 0, n_local - 1),
                       torch.clamp(slot, 0, cap - 1)]
    gathered = torch.where(mine[:, None], gathered,
                           torch.zeros_like(gathered))
    contrib = (gathered * top_p.reshape(-1)[:, None].to(x.dtype)
               ).reshape(t, k, d)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + contrib[:, j]

    partial = split_e          # out is this rank's part of the sum
    if m.n_shared:
        # the shared experts column/row split over their d_ff
        split_s = p["shared"]["down"].shape[-2] != m.expert_d_ff
        shared = mlp(p["shared"], xf, cfg.act, m.expert_d_ff,
                     reduce=False).sum(0)
        if split_s and not partial:
            shared = from_model(shared)
        elif partial and not split_s:
            out, partial = from_model(out), False
        out = out + shared
    if partial:
        out = from_model(out)

    # aux losses: load balance (Switch-style) and the router z-loss
    me = probs.mean(0)
    ce = (top_e[:, :1] == torch.arange(n_exp, device=x.device)[None, :]
          ).float().mean(0)
    aux = {
        "moe_balance": n_exp * torch.sum(me * ce) * m.aux_loss,
        "moe_zloss": torch.mean(torch.logsumexp(logits, -1) ** 2)
        * m.router_z_loss,
        "moe_drop_frac": 1.0 - keep.float().mean(),
    }
    return out.reshape(b, s, d), aux
