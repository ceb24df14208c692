"""The process mesh and its sharding rules (counterpart of
``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the dims
``("data", "model")``, or ``("pod", "data", "model")``, over the ranks of
an initialised default process group (NCCL on ``cuda``, gloo on ``cpu``,
or gloo on ``cuda`` for several ranks sharing one card). Rank ``r`` of a
(data, model) mesh sits at ``(r // model, r % model)``.

Serving shards only the output layer over ``model`` (embedding rows and
the IVF ``v_blocks``) and the slot lanes over ``data``; the parameters
stay replicated, so the trunk's decode step runs with no collective.

Training places each parameter leaf by its path and shape
(``param_spec``, the JAX package's rules in its order):

  batch dims                  -> ('pod', 'data')  [replicated if indivisible]
  vocab / embedding rows      -> 'model'
  attention/projection fan-out (heads*hd, d_ff, d_inner) -> 'model'
  projection fan-in of the return matmuls (wo/down/out_proj) -> 'model'
  experts (MoE)               -> 'model'
  KV-cache sequence dim       -> 'model'  (``decode_state_spec``)
  norms, routers, small LoRA  -> replicated

A spec is a tuple with one entry a dim of the leaf: None, a mesh dim's
name, or a tuple of names (the dim splits over their product, the first
name major), as a ``PartitionSpec`` is. A ``Placement`` pairs a spec with
its mesh, as a ``NamedSharding`` does; ``shard_tree`` cuts each rank's
slice of a tree and ``gather_tree`` puts the whole leaves back together
from the slices, exactly (all-reduces of bit patterns, ``bitsum_``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional, Sequence, Tuple

import torch

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def best_mesh_shape(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """(data, model) factorisation of ``n_devices``: the model axis is the
    requested degree, shrunk only until it divides the device count. The
    one topology rule: the elastic training mesh and the serving mesh
    both factor through here."""
    mp = min(model_parallel, n_devices)
    while n_devices % mp:
        mp -= 1
    return n_devices // mp, mp


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: Optional[str] = None):
    """A mesh of dims ``names`` and sizes ``shape`` over every rank of the
    default process group, which the caller has initialised with
    ``prod(shape)`` ranks (every rank calls this). ``device_type``
    defaults to ``cuda`` for an NCCL group and ``cpu`` otherwise; pass
    ``cuda`` for a gloo group whose ranks run on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group)")
    need, world = math.prod(shape), dist.get_world_size()
    if need != world:
        dims = ",".join(f"{n}={s}" for n, s in zip(names, shape))
        raise ValueError(f"mesh {dims} needs {need} ranks but the process "
                         f"group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_mesh_2d(shape: Tuple[int, int], device_type: Optional[str] = None):
    """The one (data, model) mesh constructor."""
    return make_mesh(shape, AXES, device_type)


def make_serving_mesh(data: int = 1, model: int = 1,
                      device_type: Optional[str] = None):
    """The serving mesh: (data, model) over every rank of the default
    group (the engine's start-up check runs over the whole group)."""
    return make_mesh_2d((data, model), device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with ``multi_pod``: a group of 256 or 512 ranks."""
    if multi_pod:
        return make_mesh((2, 16, 16), POD_AXES, device_type)
    return make_mesh_2d((16, 16), device_type)


def axis_size(mesh, name: str) -> int:
    """Ranks along mesh dim ``name``."""
    return int(mesh.size(list(mesh.mesh_dim_names).index(name)))


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along mesh dim ``name``."""
    return int(mesh.get_local_rank(name))


def axis_group(mesh, name: str):
    """The process group of this rank's line along mesh dim ``name``."""
    return mesh.get_group(name)


def data_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def data_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in data_axes(mesh))


def batch_axis_for(mesh, batch: int):
    """'data' (or ('pod', 'data')) if the batch divides the data extent,
    else None (replicated)."""
    if batch % data_size(mesh) == 0:
        ax = data_axes(mesh)
        return ax if len(ax) > 1 else ax[0]
    return None


# ---------------------------------------------------------------------------
# parameter specs by tree path
# ---------------------------------------------------------------------------

_COL = {"wq", "wk", "wv", "gate", "up", "wg", "wz", "wx", "decay_b"}
_ROW = {"wo", "down", "out_proj"}
_SHARD_BIAS = {"bq", "bk", "bv", "conv_x_b"}
_REPL = {"scale", "router", "mu", "bonus_u", "decay_w0", "decay_a", "wbc",
         "wdt", "conv_bc_w", "conv_bc_b", "a_log", "d_skip", "dt_bias", "b",
         "c"}

_KEY = re.compile(r"\[(?:'([^']*)'|\"([^\"]*)\"|(\d+))\]")


def path_keys(path) -> Tuple[str, ...]:
    """The keys of a tree path: a ``models.tree_paths`` string such as
    ``['blocks']['attn']['wq']``, or a sequence of keys."""
    if isinstance(path, str):
        return tuple(a or b or c for a, b, c in _KEY.findall(path))
    return tuple(str(k) for k in path)


def _pad(nd: int, tail) -> Tuple:
    return tuple([None] * (nd - len(tail)) + list(tail))


def param_spec(path, leaf, model_axis_size: int = 16) -> Tuple:
    """The spec of one parameter leaf (stack dims lead; the rules apply to
    the trailing semantic dims). Falls back to replication wherever the
    preferred axis does not divide."""
    s = "/".join(path_keys(path))
    name = s.split("/")[-1]
    nd = leaf.dim()
    shape = leaf.shape

    def ok(dim_from_end: int) -> bool:
        return shape[nd - dim_from_end] % model_axis_size == 0

    if "experts" in s and "shared" not in s:
        # (L, E, d, ff)-style: shard the expert dim (-3)
        if nd >= 3 and ok(3):
            return _pad(nd, ["model", None, None])
        return _pad(nd, [None] * min(nd, 3))
    if "shared" in s:
        # MoE shared experts, and zamba2's shared_attn block: only its
        # gate/up/down split, its attention stays replicated (as in JAX)
        if name in ("gate", "up") and ok(1):
            return _pad(nd, [None, "model"])
        if name == "down" and ok(2):
            return _pad(nd, ["model", None])
        return _pad(nd, [])
    if name == "table" or name == "lm_head":
        # (V, d) or (C, V, d): vocab at -2
        return _pad(nd, ["model", None]) if ok(2) else _pad(nd, [])
    # rwkv channel-mix rules precede the generic _COL/_ROW names: cmix/wv
    # is the row (down) projection though "wv" is a _COL name elsewhere
    if "cmix" in s:
        if name in ("wk", "wr"):
            return _pad(nd, [None, "model"]) if ok(1) else _pad(nd, [])
        if name == "wv":
            return _pad(nd, ["model", None]) if ok(2) else _pad(nd, [])
    if name in _COL or (name == "wr" and nd >= 2):
        return _pad(nd, [None, "model"]) if ok(1) else _pad(nd, [])
    if name in _ROW:
        return _pad(nd, ["model", None]) if ok(2) else _pad(nd, [])
    if name == "conv_x_w":
        return _pad(nd, [None, "model"]) if ok(1) else _pad(nd, [])
    if name in _SHARD_BIAS:
        return _pad(nd, ["model"]) if ok(1) else _pad(nd, [])
    return _pad(nd, [])        # norms, routers, mu, ... replicated


# ---------------------------------------------------------------------------
# the train step's compute split
# ---------------------------------------------------------------------------

# losses whose output layer runs on the rank's vocab rows (the
# vocab-parallel fused CE pair); the others score against the whole head
SPLIT_HEAD_LOSSES = ("fused_ce", "selfnorm")
_ATTN = {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
_MLP = {"gate", "up", "down"}


def split_kind(path, spec, cfg, loss: str, model_axis_size: int) -> str:
    """How the train step computes on one parameter leaf of spec ``spec``
    (``param_spec``): ``"whole"`` where nothing is split over 'model',
    ``"split"`` where its block computes on the rank's slice, ``"gather"``
    where the slice is not one its block can compute on, so that the step
    gathers the leaf whole first:

      attention  wq/wk/wv/wo and their biases split where the KV heads
                 divide over 'model' (a slice then holds whole heads, the
                 q heads with their KV group); else gathered (gemma3's wq
                 at model 16 would cut a 256-wide head in half)
      MLP        gate/up (column) and down (row), the dense blocks', MoE's
                 shared experts' and zamba2's shared block's
      experts    the MoE experts (E / model of them a rank)
      vocab      the embedding rows (a masked local lookup), and the head
                 rows under ``SPLIT_HEAD_LOSSES``; an untied head, or a
                 tied table, is gathered for every other loss and for a
                 codebook (audio) head
      gathered   RWKV6 blocks, Mamba2 blocks and the VLM's cross blocks
    """
    if "model" not in [n for e in spec for n in _names(e)]:
        return "whole"
    keys = path_keys(path)
    name = keys[-1]
    if cfg.family in ("ssm", "hybrid") and keys[0] in (
            "blocks", "mamba_groups", "mamba_tail"):
        return "gather"
    if "cross_groups" in keys:
        return "gather"
    if name in ("table", "lm_head"):
        whole_head = cfg.n_codebooks or loss not in SPLIT_HEAD_LOSSES
        if name == "lm_head" or cfg.tie_embeddings:
            return "gather" if whole_head else "split"
        return "gather" if cfg.n_codebooks else "split"
    if "experts" in keys or ("ffn" in keys and name in _MLP):
        return "split"
    if "attn" in keys and name in _ATTN:
        return ("split" if cfg.n_kv_heads % model_axis_size == 0
                else "gather")
    return "gather"


def split_plan(cfg, params_struct, model_axis_size: int, loss: str):
    """{tree path: ``split_kind``} of every parameter leaf."""
    from ..models.transformer import tree_paths
    return {p: split_kind(p, param_spec(p, x, model_axis_size), cfg, loss,
                          model_axis_size)
            for p, x in tree_paths(params_struct)}


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf's spec on a mesh (the counterpart of ``NamedSharding``)."""
    mesh: Any
    spec: Tuple


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    return {k: _map_paths(fn, v, f"{prefix}[{k!r}]") if isinstance(v, dict)
            else fn(f"{prefix}[{k!r}]", v) for k, v in tree.items()}


def params_shardings(mesh, params_struct) -> Any:
    """The placement of every parameter leaf (``param_spec``) on
    ``mesh``; ``params_struct`` holds tensors of the whole leaves' shapes
    (``meta`` tensors will do)."""
    m = axis_size(mesh, "model")
    return _map_paths(lambda p, x: Placement(mesh, param_spec(p, x, m)),
                      params_struct)


# ---------------------------------------------------------------------------
# decode-state specs by tree path
# ---------------------------------------------------------------------------

def decode_state_spec(path, leaf, mesh, batch: int) -> Tuple:
    """The spec of one decode-state leaf: the batch over the data axes, the
    KV sequence (flash-decoding style), RWKV and SSM heads and the conv
    channels over 'model' where they divide."""
    name = path_keys(path)[-1]
    nd = leaf.dim()
    dp = batch_axis_for(mesh, batch)
    model = axis_size(mesh, "model")

    if name in ("k", "v"):
        # (..., B, S, nkv, hd): seq -> model
        seq = leaf.shape[nd - 3]
        sm = "model" if seq % model == 0 else None
        return _pad(nd, [dp, sm, None, None])
    if name in ("tm_last", "cm_last"):
        return _pad(nd, [dp, None])
    if name == "wkv":
        heads = leaf.shape[nd - 3]
        hm = "model" if heads % model == 0 else None
        return _pad(nd, [dp, hm, None, None])
    if name == "conv_x":
        ch = leaf.shape[nd - 1]
        cm = "model" if ch % model == 0 else None
        return _pad(nd, [dp, None, cm])
    if name == "conv_bc":
        return _pad(nd, [dp, None, None])
    if name == "ssm":
        heads = leaf.shape[nd - 3]
        hm = "model" if heads % model == 0 else None
        return _pad(nd, [dp, hm, None, None])
    return _pad(nd, [])


def decode_state_shardings(mesh, struct, batch: int) -> Any:
    return _map_paths(
        lambda p, x: Placement(mesh, decode_state_spec(p, x, mesh, batch)),
        struct)


# ---------------------------------------------------------------------------
# serving (slot-scheduler) cache specs
# ---------------------------------------------------------------------------

def serve_cache_spec(path: str, leaf: torch.Tensor) -> Optional[int]:
    """The dim of one slot-table decode-state leaf that splits over
    'data' (its lane axis), or None for a replicated leaf. Nothing splits
    over 'model': each model shard holds its replica's whole cache, so the
    decode step needs no collective. Layouts as in the JAX package: the
    lane axis at -4 for k, v, wkv and ssm, -2 for the token shifts, -3 for
    the conv states. ``path`` is the leaf's tree path (``models.
    tree_paths``), the name its last key."""
    name = path.rsplit("[", 1)[-1].strip("'\"]")
    nd = leaf.dim()
    if name in ("k", "v", "wkv", "ssm"):
        return nd - 4
    if name in ("tm_last", "cm_last"):
        return nd - 2
    if name in ("conv_x", "conv_bc"):
        return nd - 3
    return None


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------

def batch_shardings(mesh, batch_struct, batch: int) -> Any:
    """Each batch leaf's rows over the data axes (contiguous rows a
    replica), or replicated where the batch does not divide."""
    dp = batch_axis_for(mesh, batch)

    def one(_, x):
        return Placement(mesh, _pad(x.dim(), []) if dp is None
                         else (dp,) + (None,) * (x.dim() - 1))
    return _map_paths(one, batch_struct)


def replicated(mesh, struct) -> Any:
    return _map_paths(lambda _, x: Placement(mesh, (None,) * x.dim()),
                      struct)


# ---------------------------------------------------------------------------
# slicing and gathering
# ---------------------------------------------------------------------------

def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_view(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's slice of the whole leaf ``x``, a view of it."""
    mesh, out = placement.mesh, x
    for dim, entry in enumerate(placement.spec):
        names = _names(entry)
        if not names:
            continue
        parts, coord = 1, 0
        for a in names:                      # the first name major
            coord = coord * axis_size(mesh, a) + axis_rank(mesh, a)
            parts *= axis_size(mesh, a)
        if out.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {names} ({parts} parts)")
        n = out.shape[dim] // parts
        out = out.narrow(dim, coord * n, n)
    return out


def shard_leaf(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's slice of the whole leaf ``x``, in storage of its own
    (the whole leaf can be freed)."""
    return local_view(x, placement).clone(
        memory_format=torch.contiguous_format)


def gather_leaf(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The whole leaf from every rank's slice ``x``: for each split dim and
    each of its mesh dims, innermost first, a zero buffer with this rank's
    slice in place, summed over that mesh dim's group as bit patterns, so
    the result holds the slices' bits. A fresh tensor, also where nothing
    is split."""
    from ..core.distributed import bitsum_
    mesh, out = placement.mesh, x
    for dim, entry in enumerate(placement.spec):
        for a in reversed(_names(entry)):
            size, r = axis_size(mesh, a), axis_rank(mesh, a)
            n = out.shape[dim]
            shape = list(out.shape)
            shape[dim] = n * size
            buf = out.new_zeros(shape)
            buf.narrow(dim, r * n, n).copy_(out)
            out = bitsum_(buf, axis_group(mesh, a))
    return out if out is not x else x.clone()


def shard_tree(tree, placements) -> Any:
    """Every leaf's slice on this rank (``shard_leaf``); ``placements`` has
    the tree's structure."""
    return {k: shard_tree(v, placements[k]) if isinstance(v, dict)
            else shard_leaf(v, placements[k]) for k, v in tree.items()}


def placements_like(tree, placements) -> list:
    """The placements of ``tree``'s leaves, in ``tree``'s leaf order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(placements_like(v, placements[k]))
        else:
            out.append(placements[k])
    return out


def gather_tree(tree, placements) -> Any:
    """The whole leaves from the ranks' slices (``gather_leaf``), the exact
    inverse of ``shard_tree``. Every rank of the mesh calls it."""
    return {k: gather_tree(v, placements[k]) if isinstance(v, dict)
            else gather_leaf(v, placements[k]) for k, v in tree.items()}


def check_replicated(values: Sequence[float], group=None,
                     what: str = "state") -> None:
    """Raise unless every rank of ``group`` holds the same ``values``
    (one all-reduce MAX of the values and one of their negations: MAX -
    MIN = 0). Serving ranks build their parameters and index from one
    seed; this is the start-up check that they did."""
    import torch.distributed as dist
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    v = torch.tensor([float(x) for x in values], dtype=torch.float64,
                     device=dev)
    hi, lo = v.clone(), -v
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=group)
    spread = (hi + lo).abs().max().item()
    if not spread == 0.0:
        raise RuntimeError(
            f"the ranks' {what} differ (digest MAX - MIN = {spread}): every "
            f"rank must build the same parameters and index from one seed")
