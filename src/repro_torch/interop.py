"""Carry state built by the JAX package into the port, through numpy.

Every function takes numpy arrays only; nothing here imports JAX. Like
every entry point, each puts its tensors on ``device="cuda"`` unless the
caller asks for the CPU, and raises without a GPU. The
parameter tree keeps the JAX layout (``x @ W``, ``wq (d, nh*hd)``, per-layer
leaves stacked on a leading layer axis), which is also the port's layout.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from . import resolve_device
from .core.feature_maps import FeatureMap
from .core.lsh import LSHIndex
from .core.mips import IVFIndex
from .models.transformer import _gemma_plan, _vlm_plan
from .train.optimizer import OptState


def to_tensor(a, device="cuda") -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> torch tensor on ``device``."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _wq_sites(cfg):
    """(path, leading axes) of every ``attn`` node of the config's tree:
    its ``wq`` is (*lead, d, n_heads * head_dim)."""
    if cfg.local_global_ratio:
        g, r, tail = _gemma_plan(cfg)
        sites = [(("local_groups", "attn"), (g, r)),
                 (("global_groups", "attn"), (g,))]
        return sites + ([(("local_tail", "attn"), (tail,))] if tail else [])
    if cfg.family == "vlm":
        g, n_self = _vlm_plan(cfg)
        return [(("self_groups", "attn"), (g, n_self)),
                (("cross_groups", "attn"), (g,))]
    if cfg.family == "hybrid":
        return [(("shared_attn", "attn"), ())]
    if cfg.family == "ssm":
        return []
    return [(("blocks", "attn"), (cfg.n_layers,))]


def _node(tree, path):
    for key in path:
        if not isinstance(tree, Mapping) or key not in tree:
            return None
        tree = tree[key]
    return tree


def params_from_numpy(tree: Mapping[str, Any], cfg, device="cuda"):
    """The JAX ``Model.init`` tree (leaves as numpy arrays) as the port's
    parameter dict, every leaf in its own dtype (an MoE router and a Mamba
    ``a_log`` stay f32, bf16 leaves keep their bits). ``cfg`` is checked
    against the tree's widths: every ``wq`` the tree has (``blocks.attn``,
    ``local_groups.attn``, ``global_groups.attn``, ``local_tail.attn``,
    ``self_groups.attn``, ``cross_groups.attn``, ``shared_attn.attn``), an
    RWKV tree's ``blocks.mix.wr`` (L, d, d),
    for an MoE tree the router and every expert leaf against ``cfg.moe``,
    and a codebook tree's (or a codebook config's) ``embed.table`` and
    untied ``lm_head`` against (n_codebooks, vocab, d)."""
    out = {k: params_from_numpy(v, cfg, device) if isinstance(v, Mapping)
           else to_tensor(v, device) for k, v in tree.items()}
    L, d = cfg.n_layers, cfg.d_model
    got, want = {}, {}
    for path, lead in _wq_sites(cfg):
        attn = _node(out, path)
        if attn is not None:
            name = ".".join(path) + ".wq"
            got[name] = attn["wq"]
            want[name] = lead + (d, cfg.n_heads * cfg.resolved_head_dim)
    wr = _node(out, ("blocks", "mix", "wr"))
    if wr is not None:
        got["blocks.mix.wr"], want["blocks.mix.wr"] = wr, (L, d, d)
    table = _node(out, ("embed", "table"))
    if table is not None and (cfg.n_codebooks or table.dim() == 3):
        heads = {"embed.table": table}
        if not cfg.tie_embeddings and "lm_head" in out:
            heads["lm_head"] = out["lm_head"]
        for name, leaf in heads.items():
            got[name], want[name] = leaf, (cfg.n_codebooks, cfg.vocab, d)
    ffn = _node(out, ("blocks", "ffn"))
    if ffn is not None and "experts" in ffn:
        m = cfg.moe
        if m is None:
            raise ValueError("the tree holds MoE experts but the config "
                             f"{cfg.name!r} has no moe")
        got["router"] = ffn["router"]
        want["router"] = (L, d, m.n_experts)
        for group, n in (("experts", m.n_experts), ("shared", m.n_shared)):
            for name, leaf in ffn.get(group, {}).items():
                got[f"{group}.{name}"] = leaf
                want[f"{group}.{name}"] = (
                    (L, n, m.expert_d_ff, d) if name == "down"
                    else (L, n, d, m.expert_d_ff))
    for name, leaf in got.items():
        if tuple(leaf.shape) != want[name]:
            raise ValueError(f"{name} {tuple(leaf.shape)} does not match "
                             f"the config's {want[name]}")
    return out


def decode_state_from_numpy(tree: Mapping[str, Any], device="cuda"):
    """A JAX decode state (leaves as numpy arrays) as the port's, leaf by
    leaf in its own dtype. The one layout that differs: the JAX dense and
    MoE state ``{"kv": {"k", "v"}}`` is the port's flat ``{"k", "v"}``;
    every other tree (gemma3's, the VLM's ``{"self": {"k", "v"}}``, the
    recurrent families') carries across as it is."""
    if set(tree) == {"kv"}:
        tree = tree["kv"]
    return {k: decode_state_from_numpy(v, device) if isinstance(v, Mapping)
            else to_tensor(v, device) for k, v in tree.items()}


def decode_state_to_numpy(tree: Mapping[str, Any]):
    """A port decode state as numpy, leaf by leaf (bf16 leaves as f32,
    which holds them exactly), so states compare leaf by leaf."""
    return {k: decode_state_to_numpy(v) if isinstance(v, Mapping)
            else (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in tree.items()}


def opt_state_from_numpy(step, m: Mapping[str, Any], v: Mapping[str, Any],
                         device="cuda") -> OptState:
    """A JAX ``OptState`` (step and the f32 moment trees as numpy) as the
    port's, so a JAX ``TrainState`` carries across with
    ``params_from_numpy``."""
    def tree(t):
        return {k: tree(x) if isinstance(x, Mapping)
                else to_tensor(x, device).float() for k, x in t.items()}
    return OptState(step=int(step), m=tree(m), v=tree(v))


def ivf_from_numpy(v_blocks, valid, row_id, slot_of_row, block_centroids,
                   block_radius, n: int, block_rows: int, assign=None,
                   device="cuda") -> IVFIndex:
    """A JAX ``IVFIndex``'s fields (numpy arrays) as the port's index."""
    return IVFIndex(
        v_blocks=to_tensor(v_blocks, device),
        valid=to_tensor(valid, device).bool(),
        row_id=to_tensor(row_id, device).to(torch.int32),
        slot_of_row=to_tensor(slot_of_row, device).to(torch.int32),
        block_centroids=to_tensor(block_centroids, device),
        block_radius=to_tensor(block_radius, device).float(),
        n=int(n), block_rows=int(block_rows),
        assign=None if assign is None
        else to_tensor(assign, device).to(torch.int32))


def feature_map_from_numpy(omega, degree, coef, p: float,
                           device="cuda") -> FeatureMap:
    """A JAX ``FeatureMap``'s fields (numpy arrays) as the port's feature
    map: torch cannot reproduce the JAX package's Rademacher and
    categorical draws, so parity tests inject them."""
    return FeatureMap(omega=to_tensor(omega, device).float(),
                      degree=to_tensor(degree, device).to(torch.int32),
                      coef=to_tensor(coef, device).float(), p=float(p))


def lsh_from_numpy(proj, aug_scale, tail_scale, tail_logits, codes, buckets,
                   slot_of_row, device="cuda") -> LSHIndex:
    """A JAX ``LSHIndex``'s fields (numpy arrays) as the port's index: the
    hyperplanes are ``jax.random.normal`` draws, so parity tests inject
    them (or the whole index) from the JAX package."""
    return LSHIndex(proj=to_tensor(proj, device).float(),
                    aug_scale=to_tensor(aug_scale, device).float(),
                    tail_scale=to_tensor(tail_scale, device).float(),
                    tail_logits=to_tensor(tail_logits, device).float(),
                    codes=to_tensor(codes, device).to(torch.int32),
                    buckets=to_tensor(buckets, device).to(torch.int32),
                    slot_of_row=to_tensor(slot_of_row, device).to(torch.int32))


def lbl_params_from_numpy(r, c, b, device="cuda"):
    """A JAX ``repro.models.lbl`` parameter dict's leaves (numpy ``r``
    (vocab, d), ``c`` (context, d, d), ``b`` (vocab,)) as the port's."""
    return {"r": to_tensor(r, device), "c": to_tensor(c, device),
            "b": to_tensor(b, device)}
