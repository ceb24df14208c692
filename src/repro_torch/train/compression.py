"""Gradient compression for the pod axis (counterpart of
``repro.train.compression``).

Int8 quantisation with one scale a tensor: the all-reduce over the pod
axis is the one collective that crosses the slow links between pods, so
sending int8 payloads (summed in int32) cuts its bytes. All ranks quantise
with the all-reduced max scale, so the integer payloads sum exactly.
``compress_psum`` sums over the group; it does not average, as in JAX.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

def _dist():
    import torch.distributed as dist
    return dist


def _scale(amax: torch.Tensor) -> torch.Tensor:
    # a true division: CUDA divides by a host scalar as a product with its
    # reciprocal, which is not JAX's amax / 127
    return (amax + 1e-12) / amax.new_tensor(127.0)


def _quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 with an f32 scale."""
    xf = x.float()
    scale = _scale(xf.abs().max())
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_psum(grads: Sequence[torch.Tensor], group,
                  mode: str = "none") -> List[torch.Tensor]:
    """Each gradient summed over ``group``; ``mode='int8'`` quantises it
    first: an all-reduce MAX of max |g| in f32, + 1e-12, scale = amax / 127,
    q = clip(round(g / scale), -127, 127) (half to even), an int32
    all-reduce SUM of q, and the sum times scale in g's dtype. ``none``
    sums in g's dtype. Returns new tensors."""
    dist = _dist()
    if mode == "none":
        out = []
        for g in grads:
            s = g.clone()
            dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
            out.append(s)
        return out
    if mode != "int8":
        raise ValueError(f"unknown grad compression {mode!r}")
    out = []
    for g in grads:
        gf = g.float()
        amax = gf.abs().max().reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = _scale(amax)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int32)
        del gf
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        out.append((q.float() * scale).to(g.dtype))
    return out
