"""The serving mesh (counterpart of the serving part of
``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the dims
``("data", "model")`` over the ranks of an initialised default process
group (NCCL on ``cuda``, gloo on ``cpu``, or gloo on ``cuda`` for several
ranks sharing one card). Rank ``r`` sits at ``(r // model, r % model)``.
The serving mesh shards only the output layer over ``model`` (embedding
rows and the IVF ``v_blocks``) and the slot lanes over ``data``; the
parameters stay replicated, so the trunk's decode step runs with no
collective.

The training mesh's rules (``param_spec``, ``params_shardings``,
``decode_state_spec``, ``make_production_mesh``) are not ported.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

AXES = ("data", "model")


def best_mesh_shape(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """(data, model) factorisation of ``n_devices``: the model axis is the
    requested degree, shrunk only until it divides the device count."""
    mp = min(model_parallel, n_devices)
    while n_devices % mp:
        mp -= 1
    return n_devices // mp, mp


def make_serving_mesh(data: int = 1, model: int = 1,
                      device_type: Optional[str] = None):
    """The (data, model) mesh over every rank of the default process
    group, which the caller has initialised with ``data * model`` ranks
    (every rank calls this; the engine's start-up check runs over the
    whole group). ``device_type`` defaults to ``cuda`` for an NCCL group
    and ``cpu`` otherwise; pass ``cuda`` for a gloo group whose ranks serve
    from the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    need, world = data * model, dist.get_world_size()
    if need != world:
        raise ValueError(f"mesh data={data},model={model} needs {need} "
                         f"ranks but the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.arange(need).reshape(data, model),
                      mesh_dim_names=AXES)


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
    return ("data",)


def data_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in data_axes(mesh))


def batch_axis_for(mesh, batch: int) -> Optional[str]:
    """'data' if the batch divides the data extent, else None
    (replicated)."""
    return "data" if batch % data_size(mesh) == 0 else None


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
