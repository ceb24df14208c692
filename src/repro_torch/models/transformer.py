"""Transformer: full-sequence forward (training and prefill) and cached
decode (counterpart of ``repro.models.transformer``) for the dense, MoE,
gemma3 local/global, RWKV6 (``ssm``), Zamba2 (``hybrid``), VLM and audio
families. A VLM takes its image embeddings ``img`` (B, n_image_tokens, d)
in the model's dtype beside the tokens, in ``forward`` and in every
``decode_step``. An audio config (``n_codebooks`` C > 0, musicgen) takes tokens
(B, S, C): its embedding is the sum of C per-codebook tables (C, V, d) and
its head a (C, V, d) stack, one V-way output a codebook.

Parameters keep the JAX package's pytree layout — a dict whose per-layer
leaves are stacked on a leading layer axis, or on (group, member) axes for
a grouped plan — so ``interop.params_from_numpy`` is a leaf-wise
conversion. A Python loop over layers takes the place of ``lax.scan``, and
``torch.utils.checkpoint`` that of ``jax.checkpoint``. The plans:

  gemma3-4b : 5 groups of [5 local + 1 global] + a tail of 4 local
  llama-vision : 20 groups of [4 self + 1 cross-attention to the image]
  zamba2-7b : 13 groups of [6 mamba] each followed by the one shared
              attention block (one weight copy) + a tail of 3 mamba
  others    : one homogeneous stack

Decode states are trees stacked the same way. The dense and MoE families
keep one flat KV pair ``{"k", "v"}``; gemma3's is ``{"local", "global",
"tail"}`` (a ring of ``min(max_len, sliding_window)`` slots in each local
layer), the VLM's ``{"self": {"k", "v"}}`` (its cross blocks keep no
cache), RWKV6's ``{"rwkv": {"tm_last", "cm_last", "wkv"}}`` and Zamba2's
``{"mamba", "shared_kv", "mamba_tail"}``. ``decode_step`` updates every
leaf in place, so a captured CUDA graph keeps its storage.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from .attention import (KVCache, cross_attention, decode_position,
                        decode_self_attention, self_attention)
from .layers import _dense_init, embed, mlp, rmsnorm
from .mamba import init_mamba_block, init_mamba_state, mamba_block
from .moe import init_moe, moe_block
from .rwkv import RWKVState, init_rwkv_block, rwkv_block

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


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) of every tensor of a nested dict, in insertion order;
    a path reads like ``['rwkv']['wkv']``."""
    for k, v in tree.items():
        path = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            yield from tree_paths(v, path)
        else:
            yield path, v


def tree_leaves(tree) -> List[torch.Tensor]:
    """Every tensor of a nested dict (a decode state), in insertion order."""
    return [leaf for _, leaf in tree_paths(tree)]


def _tree_map(fn: Callable, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _copy_into(dst, src) -> None:
    """``dst``'s leaves overwritten in place by ``src``'s (same tree)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def _stack(n: int, make: Callable[[], Params]) -> Params:
    """``n`` draws of ``make()`` stacked on a new leading axis, drawn one at
    a time: one draw's tensors (and its f32 draws) are alive at once, not
    the whole stack's."""
    first = make()
    out = _tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    _copy_into(_layer(out, 0), first)
    del first
    for i in range(1, n):
        _copy_into(_layer(out, i), make())
    return out


# the dense family's aux losses, all zero (the JAX package's ZERO_AUX)
ZERO_AUX = {"moe_balance": 0.0, "moe_zloss": 0.0, "moe_drop_frac": 0.0}


def _add_aux(a: Dict, b: Dict) -> Dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + v
    return out


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "audio", "moe", "ssm", "hybrid", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")


def _plan(cfg: ModelConfig) -> str:
    if cfg.local_global_ratio:
        return "gemma"
    if cfg.family in ("ssm", "hybrid", "vlm"):
        return cfg.family
    return "stack"


def _gemma_plan(cfg):
    """(n_groups, locals_per_group, tail_locals)."""
    r = cfg.local_global_ratio                       # 5 locals : 1 global
    group = r + 1
    n_groups = cfg.n_layers // group
    tail = cfg.n_layers - n_groups * group
    return n_groups, r, tail


def _vlm_plan(cfg):
    """(n_groups, self_blocks_per_group): each group is its self-attention
    blocks, then one cross-attention block."""
    group = cfg.cross_attn_every                     # 4 self + 1 cross
    n_groups = cfg.n_layers // group
    if n_groups * group != cfg.n_layers:
        raise ValueError(f"vlm layers must divide evenly: {cfg.n_layers} "
                         f"layers in groups of {group}")
    return n_groups, group - 1


def _hybrid_plan(cfg):
    """(n_groups, mamba_per_group, tail_mamba)."""
    group = cfg.shared_attn_every
    n_groups = cfg.n_layers // group
    tail = cfg.n_layers - n_groups * group
    return n_groups, group, tail


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


def cross_block_fwd(p: Params, x, img, cfg):
    """One cross-attention block: x (B, S, d) attends to the image
    embeddings ``img`` (B, N, d), then the MLP."""
    x = x + cross_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                            img, cfg)
    return x + mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)


def _check_img(cfg: ModelConfig, img) -> None:
    """A VLM needs its image; every other family takes none."""
    if cfg.family == "vlm" and img is None:
        raise ValueError(f"{cfg.name!r} is a VLM: pass its image "
                         f"embeddings img (B, {cfg.n_image_tokens}, "
                         f"{cfg.d_model})")
    if cfg.family != "vlm" and img is not None:
        raise ValueError(f"{cfg.name!r} is family {cfg.family!r}, which "
                         f"takes no image (only a VLM cross-attends to one)")


def _init_tblocks(gen: torch.Generator, cfg, pre: tuple, dt,
                  dev) -> Params:
    """Attention + FFN blocks stacked on the leading axes ``pre`` ((L,)
    for one stack, () for a single block), each leaf drawn whole."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def dense(shape):
        return _dense_init(gen, pre + shape, dt, dev)

    def ones(n):
        return torch.ones(pre + (n,), dtype=dt, device=dev)

    attn = {"wq": dense((d, nh * hd)), "wk": dense((d, nkv * hd)),
            "wv": dense((d, nkv * hd)), "wo": dense((nh * hd, d))}
    if cfg.qkv_bias:
        for name, width in (("bq", nh), ("bk", nkv), ("bv", nkv)):
            attn[name] = torch.zeros(pre + (width * hd,), dtype=dt,
                                     device=dev)
    if cfg.family == "moe":
        ffn = init_moe(gen, cfg, pre[0], dt, dev)
    else:
        ffn = {"down": dense((ff, d))}
        if cfg.act == "sqrelu":
            ffn["up"] = dense((d, ff))
        else:
            ffn["gate"] = dense((d, ff))
            ffn["up"] = dense((d, ff))
    return {"ln1": {"scale": ones(d)}, "attn": attn,
            "ln2": {"scale": ones(d)}, "ffn": ffn}


class Model:
    """Functional model for one ModelConfig of a ported family."""

    def __init__(self, cfg: ModelConfig):
        _check_family(cfg)
        self.cfg = cfg
        self.kind = "moe" if cfg.family == "moe" else "dense"
        self.plan = _plan(cfg)

    def init(self, gen: torch.Generator, device="cuda") -> Params:
        """Seeded random init at the config's widths, on ``device`` (the
        generator must live there too). Same shapes, scales and dtypes as
        the JAX package's ``Model.init``; the random numbers differ. The
        grouped and recurrent plans draw one block (one group of a grouped
        stack) at a time."""
        dev = resolve_device(device)
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        d = cfg.d_model

        def block():
            return _init_tblocks(gen, cfg, (), dt, dev)

        p: Params = {}
        if self.plan == "stack":
            p["blocks"] = _init_tblocks(gen, cfg, (cfg.n_layers,), dt, dev)
        elif self.plan == "gemma":
            g, r, tail = _gemma_plan(cfg)
            p["local_groups"] = _stack(g, lambda: _stack(r, block))
            p["global_groups"] = _stack(g, block)
            if tail:
                p["local_tail"] = _stack(tail, block)
        elif self.plan == "vlm":
            g, n_self = _vlm_plan(cfg)
            p["self_groups"] = _stack(g, lambda: _stack(n_self, block))
            p["cross_groups"] = _stack(g, block)
        elif self.plan == "ssm":
            p["blocks"] = _stack(cfg.n_layers, lambda: init_rwkv_block(
                gen, cfg, dt, dev))
        else:
            g, per, tail = _hybrid_plan(cfg)

            def mamba():
                return init_mamba_block(gen, cfg, dt, dev)
            p["mamba_groups"] = _stack(g, lambda: _stack(per, mamba))
            p["shared_attn"] = block()                # ONE weight copy
            if tail:
                p["mamba_tail"] = _stack(tail, mamba)
        head = ((cfg.n_codebooks,) if cfg.n_codebooks else ()) + (cfg.vocab,
                                                                   d)
        p["embed"] = {"table": _dense_init(gen, head, dt, dev, scale=1.0)}
        p["final_norm"] = {"scale": torch.ones((d,), dtype=dt, device=dev)}
        if not cfg.tie_embeddings:
            # the JAX package's fan_in is shape[0]: V for a (V, d) head,
            # C for the (C, V, d) codebook head
            p["lm_head"] = _dense_init(gen, head, dt, dev,
                                       scale=head[0] ** -0.5)
        return p

    def embed_tokens(self, p: Params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (..., ) -> (..., d); with codebooks tokens (..., C) ->
        the sum of the C per-codebook rows, added as the JAX package adds
        them (Python's ``sum``: 0 + e0 + e1 + ...; in bf16 every add
        rounds, so the order is part of the result)."""
        if self.cfg.n_codebooks:
            tabs = p["embed"]["table"]                         # (C, V, d)
            x = 0
            for c in range(self.cfg.n_codebooks):
                x = x + tabs[c][tokens[..., c]]
            return x
        return embed(p["embed"], tokens)

    def head_matrix(self, p: Params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return p["embed"]["table"]
        return p["lm_head"]

    def logits(self, p: Params, hidden: torch.Tensor) -> torch.Tensor:
        """Full logits — small-vocab path / tests only (O(T V) memory):
        (..., V), or (..., C, V) with codebooks."""
        w = self.head_matrix(p)
        if self.cfg.n_codebooks:
            return torch.einsum("...d,cvd->...cv", hidden, w)
        return hidden @ w.T

    def forward(self, p: Params, tokens: torch.Tensor, *,
                img=None) -> Tuple[torch.Tensor, Dict[str, float]]:
        """tokens (B, S), or (B, S, C) with codebooks -> (hidden (B, S, d),
        aux); a VLM also takes ``img`` (B, n_image_tokens, d), which every
        other family refuses. With ``cfg.remat`` other
        than "none" each block (each group of a grouped plan) runs under a
        non-reentrant checkpoint: its activations are recomputed in the
        backward, as under ``jax.checkpoint``."""
        cfg = self.cfg
        _check_img(cfg, img)
        x = self.embed_tokens(p, tokens)
        remat = cfg.remat != "none"

        def run(fn, layer, x_):
            if remat:
                return checkpoint(fn, layer, x_, use_reentrant=False)
            return fn(layer, x_)

        aux = ZERO_AUX
        win = cfg.sliding_window
        if self.plan == "stack":
            blocks = _unbind(p["blocks"])
            for i in range(cfg.n_layers):
                x, a = run(lambda px, x_: tblock_fwd(
                    px, x_, cfg, kind=self.kind, window=win),
                    _layer(blocks, i), x)
                aux = _add_aux(aux, a)
        elif self.plan == "gemma":
            g, r, tail = _gemma_plan(cfg)

            def group(pg, x_):
                for i in range(r):
                    x_, _ = tblock_fwd(_layer(pg["local"], i), x_, cfg,
                                       window=win)
                return tblock_fwd(pg["global"], x_, cfg, window=0)[0]
            loc, glob = _unbind(p["local_groups"]), _unbind(
                p["global_groups"])
            for gi in range(g):
                x = run(group, {"local": _layer(loc, gi),
                                "global": _layer(glob, gi)}, x)
            if tail:
                lt = _unbind(p["local_tail"])
                for i in range(tail):
                    x = run(lambda px, x_: tblock_fwd(px, x_, cfg,
                                                      window=win)[0],
                            _layer(lt, i), x)
        elif self.plan == "vlm":
            g, n_self = _vlm_plan(cfg)

            def group(pg, x_):
                for i in range(n_self):
                    x_, _ = tblock_fwd(_layer(pg["self"], i), x_, cfg)
                return cross_block_fwd(pg["cross"], x_, img, cfg)
            sg, cg = _unbind(p["self_groups"]), _unbind(p["cross_groups"])
            for gi in range(g):
                x = run(group, {"self": _layer(sg, gi),
                                "cross": _layer(cg, gi)}, x)
        elif self.plan == "ssm":
            blocks = _unbind(p["blocks"])
            for i in range(cfg.n_layers):
                x = run(lambda px, x_: rwkv_block(px, x_, cfg)[0],
                        _layer(blocks, i), x)
        else:
            g, per, tail = _hybrid_plan(cfg)
            shared = p["shared_attn"]

            def group(pg, x_):
                for i in range(per):
                    x_, _ = mamba_block(_layer(pg["mamba"], i), x_, cfg)
                return tblock_fwd(pg["shared"], x_, cfg)[0]
            mg = _unbind(p["mamba_groups"])
            for gi in range(g):
                x = run(group, {"mamba": _layer(mg, gi), "shared": shared},
                        x)
            if tail:
                mt = _unbind(p["mamba_tail"])
                for i in range(tail):
                    x = run(lambda px, x_: mamba_block(px, x_, cfg)[0],
                            _layer(mt, i), x)
        return rmsnorm(p["final_norm"], x, cfg.norm_eps), aux

    def init_decode_state(self, batch: int, max_len: int,
                          device) -> Dict[str, Any]:
        """The decode state of ``batch`` lanes of ``max_len`` positions,
        zeros: the dense and MoE families' KV pair {"k", "v"} (L, B, S,
        n_kv, hd); gemma3's {"local", "global", "tail"}; the VLM's {"self":
        {"k", "v"}} (G, self blocks a group, B, S, n_kv, hd); RWKV6's {"rwkv":
        ...} and Zamba2's {"mamba", "shared_kv", "mamba_tail"}, each leaf
        stacked as its parameters are (the JAX package's trees)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads

        def kv(*lead):
            shape = lead + (nkv, hd)
            return {"k": torch.zeros(shape, dtype=dt, device=device),
                    "v": torch.zeros(shape, dtype=dt, device=device)}

        def stacked(lead, make):
            return _tree_map(lambda t: t.new_zeros(lead + tuple(t.shape)),
                             make())

        if self.plan == "stack":
            length = min(max_len, cfg.sliding_window) \
                if cfg.sliding_window else max_len
            return kv(cfg.n_layers, batch, length)
        if self.plan == "gemma":
            g, r, tail = _gemma_plan(cfg)
            w = min(max_len, cfg.sliding_window)
            st = {"local": kv(g, r, batch, w), "global": kv(g, batch,
                                                            max_len)}
            if tail:
                st["tail"] = kv(tail, batch, w)
            return st
        if self.plan == "vlm":
            g, n_self = _vlm_plan(cfg)
            return {"self": kv(g, n_self, batch, max_len)}
        if self.plan == "ssm":
            return {"rwkv": stacked((cfg.n_layers,), lambda: RWKVState.init(
                batch, cfg, dt, device))}
        g, per, tail = _hybrid_plan(cfg)

        def m0():
            return init_mamba_state(batch, cfg, dt, device)
        st = {"mamba": stacked((g, per), m0),
              "shared_kv": kv(g, batch, max_len)}
        if tail:
            st["mamba_tail"] = stacked((tail,), m0)
        return st

    def decode_step(self, p: Params, state: Dict[str, Any],
                    token: torch.Tensor, pos, *, img=None) -> torch.Tensor:
        """token (B,), or (B, C) with codebooks, at position ``pos`` ->
        hidden of that position (B, d). A VLM takes its image ``img`` (B,
        n_image_tokens, d) at every step: its cross blocks project the
        image's K and V again each step, as the JAX package's do.
        ``pos`` is an int tensor on the device, 0-d (shared by the batch)
        or (B,) (one a lane), or a Python int (copied to the device).
        Every leaf of ``state`` is updated in place (KV rows at their slot,
        recurrent leaves whole); with a tensor position nothing is read to
        the host. Each cache length gets one ``decode_position`` a step."""
        cfg = self.cfg
        _check_img(cfg, img)
        if not isinstance(pos, torch.Tensor):
            pos = torch.tensor(pos, dtype=torch.int32, device=token.device)
        x = self.embed_tokens(p, token[:, None])               # (B, 1, d)
        win = cfg.sliding_window

        def cache(st, *idx):
            return KVCache(k=st["k"][idx], v=st["v"][idx])

        if self.plan == "stack":
            dpos = decode_position(pos, state["k"].shape[2], win)
            for i in range(cfg.n_layers):
                x = tblock_decode(_layer(p["blocks"], i), x,
                                  cache(state, i), dpos, cfg,
                                  kind=self.kind, window=win)
        elif self.plan == "gemma":
            g, r, tail = _gemma_plan(cfg)
            lpos = decode_position(pos, state["local"]["k"].shape[-3], win)
            gpos = decode_position(pos, state["global"]["k"].shape[-3], 0)
            for gi in range(g):
                loc = _layer(p["local_groups"], gi)
                for i in range(r):
                    x = tblock_decode(_layer(loc, i), x,
                                      cache(state["local"], gi, i), lpos,
                                      cfg, window=win)
                x = tblock_decode(_layer(p["global_groups"], gi), x,
                                  cache(state["global"], gi), gpos, cfg,
                                  window=0)
            for i in range(tail):
                x = tblock_decode(_layer(p["local_tail"], i), x,
                                  cache(state["tail"], i), lpos, cfg,
                                  window=win)
        elif self.plan == "vlm":
            g, n_self = _vlm_plan(cfg)
            spos = decode_position(pos, state["self"]["k"].shape[-3], 0)
            for gi in range(g):
                sg = _layer(p["self_groups"], gi)
                for i in range(n_self):
                    x = tblock_decode(_layer(sg, i), x,
                                      cache(state["self"], gi, i), spos, cfg)
                x = cross_block_fwd(_layer(p["cross_groups"], gi), x, img,
                                    cfg)
        elif self.plan == "ssm":
            st = state["rwkv"]
            for i in range(cfg.n_layers):
                x = _recur(rwkv_block, _layer(p["blocks"], i), x, cfg,
                           _layer(st, i))
        else:
            g, per, tail = _hybrid_plan(cfg)
            spos = decode_position(pos, state["shared_kv"]["k"].shape[-3], 0)
            for gi in range(g):
                pg, sg = _layer(p["mamba_groups"], gi), _layer(
                    state["mamba"], gi)
                for i in range(per):
                    x = _recur(mamba_block, _layer(pg, i), x, cfg,
                               _layer(sg, i))
                x = tblock_decode(p["shared_attn"], x,
                                  cache(state["shared_kv"], gi), spos, cfg)
            for i in range(tail):
                x = _recur(mamba_block, _layer(p["mamba_tail"], i), x, cfg,
                           _layer(state["mamba_tail"], i))
        h = rmsnorm(p["final_norm"], x, cfg.norm_eps)
        return h[:, 0]


def _recur(block, p: Params, x, cfg, st: Dict[str, torch.Tensor]):
    """One step of a recurrent block on its state views ``st``, written
    back in place; returns the block's output."""
    x, new = block(p, x, cfg, st)
    _copy_into(st, new)
    return x
