"""Where a dry-run cell's counts come from, and where a step's device time
goes (counterpart of ``repro.launch.breakdown``).

``run`` counts one rank's step of a cell (``dryrun.build_step`` on fake
tensors and a fake process group) and ranks its collective bytes, bytes
or FLOPs by (tag, op). The tag stands where the JAX package reads HLO's
``op_name`` metadata: the last three ``repro_torch`` frames
(``module.function``) of the Python stack that issued the op.

  PYTHONPATH=src python -m repro_torch.launch.breakdown --arch rwkv6-7b \\
      --shape train_4k [--top 20] [--kind collective|bytes|flops]

``measure_step`` is for the card: it counts a built step on fake tensors
of its shapes, replays the step under ``torch.profiler`` and prints the
device milliseconds of each kind of work beside the FLOPs and bytes
counted for that kind. A kernel or an op that fits no kind is listed as
unmatched, never dropped.
"""
from __future__ import annotations

import argparse
import collections
import re
from typing import Callable, Dict, Optional, Tuple

from .hlo_analysis import CostCounter

# kinds of work: (kind, device kernel name pattern, ATen/c10d op names).
# The hand-written kernels are their own kinds, counted as the kernels.
KINDS: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = (
    ("kernel:topk_z", r"topk_z", ("kernel:topk_z",)),
    ("kernel:ivf_decode", r"ivf_decode", ("kernel:ivf_decode",)),
    ("kernel:union_scores", r"union_scores", ("kernel:union_scores",)),
    ("kernel:ivf_score", r"ivf_score", ("kernel:ivf_score",)),
    ("kernel:fmbe", r"fmbe", ("kernel:fmbe_z", "kernel:fmbe_phi")),
    ("kernel:fused_ce", r"fused_ce|ce_split|ce_coef|ce_grad|dw_add",
     ("kernel:fused_ce_fwd", "kernel:fused_ce_bwd")),
    ("kernel:lsh", r"lsh", ("kernel:lsh_probe", "kernel:lsh_query_codes")),
    # the second launch of topk_z, ivf_decode and lsh_probe alike: its time
    # stands apart, their counted bytes under their own kinds
    ("kernel:merge_partials", r"merge_partials", ()),
    ("collective", r"nccl|gloo",
     ("c10d.allreduce_", "c10d._allgather_base_", "c10d.allgather_",
      "c10d.reduce_scatter_", "c10d._reduce_scatter_base_",
      "c10d.alltoall_base_", "c10d.broadcast_")),
    ("matmul", r"gemm|gemv|cutlass|xmma|nvjet|sm90_|cublas|wgmma|splitK",
     ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.addbmm",
      "aten._scaled_mm", "aten.convolution")),
    ("reduction", r"reduce|softmax|norm|argmax|topk|sort|scan|cumsum",
     ("aten.sum", "aten.mean", "aten.amax", "aten.amin", "aten.max",
      "aten.min", "aten.argmax", "aten.argmin", "aten.logsumexp",
      "aten._softmax", "aten._log_softmax", "aten.topk", "aten.sort",
      "aten.cumsum", "aten.any", "aten.all", "aten.linalg_vector_norm",
      "aten.var_mean", "aten.prod", "aten.norm")),
    ("copy", r"copy|cat|index|gather|scatter|embedding|fill|memset|Memcpy"
             r"|Memset|triu|tril|arange|put|take",
     ("aten._to_copy", "aten.copy_", "aten.clone", "aten.cat",
      "aten.index", "aten.index_select", "aten.gather", "aten.scatter",
      "aten.scatter_", "aten.index_put_", "aten.index_put",
      "aten._index_put_impl_", "aten.embedding", "aten.fill_",
      "aten.zero_", "aten.zeros", "aten.ones", "aten.full",
      "aten.arange", "aten.stack", "aten.slice_scatter",
      "aten.select_scatter", "aten.index_add_", "aten.scatter_add_",
      "aten.new_zeros", "aten.new_full", "aten.zeros_like",
      "aten.ones_like", "aten.full_like", "aten.triu", "aten.tril",
      "aten.constant_pad_nd", "aten.repeat", "aten.flip", "aten.roll",
      "aten.randint", "aten.random_", "aten.randn", "aten.rand",
      "aten.normal_", "aten.uniform_", "aten.lift_fresh_copy")),
    ("elementwise", r"elementwise|vectorized|unrolled|pointwise|kernel_impl",
     ()),
)
# every other ATen op is elementwise (``op_kind``)
_OP_KIND = {op: kind for kind, _, ops in KINDS for op in ops}


def op_kind(op: str) -> Optional[str]:
    """The kind of a counted op (``CostCounter.by_op``'s key), or None."""
    if op in _OP_KIND:
        return _OP_KIND[op]
    if op.startswith("aten."):
        return "elementwise"
    return None


def kernel_kind(name: str) -> Optional[str]:
    """The kind of a device kernel by its name, or None."""
    for kind, pattern, _ in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return None


def meta_tag_counts(counter: CostCounter, kind: str) -> collections.Counter:
    """(tag, op) -> collective bytes, bytes or flops of a tagged count."""
    key = {"collective": "collective_bytes", "bytes": "bytes",
           "flops": "flops"}[kind]
    agg = collections.Counter()
    for (tag, op), row in counter.by_tag.items():
        if row[key]:
            agg[(tag or "(kernel)", op)] += row[key]
    return agg


def run(arch, shape, mesh_kind="single", output_mode="exact", top=20,
        kind="collective"):
    """Prints the top ``top`` (tag, op) pairs of one rank's step of the
    cell by ``kind``, in GB or GFLOP, and their total."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs import get_config
    from ..configs.base import get_shape
    from .dryrun import MESH_SHAPES, build_step, fake_mesh
    cfg, sc = get_config(arch), get_shape(shape)
    mshape, names = MESH_SHAPES[mesh_kind]
    with fake_mesh(mshape, names) as mesh:
        with FakeTensorMode():
            step = build_step(cfg, sc, mesh, output_mode)
            with CostCounter(tags=True, trips=True) as c:
                step.run()
    agg = meta_tag_counts(c, kind)
    unit = 1e9
    print(f"\n== {kind} breakdown: {arch} x {shape} x {mesh_kind} "
          f"[{output_mode}] (GB or GFLOP per device per step, "
          f"{step.meta.get('microbatches', 1)} microbatches counted as "
          f"traced: {step.meta}) ==")
    for (tag, op), v in agg.most_common(top):
        print(f"{v / unit:12.3f}  {op:26s} {tag}")
    print(f"{sum(agg.values()) / unit:12.3f}  TOTAL")
    return agg


def count_by_kind(counter: CostCounter) -> Dict[str, collections.Counter]:
    """A count's FLOPs and bytes by kind (``op_kind``); ops of no kind
    under "unmatched:<op>"."""
    out: Dict[str, collections.Counter] = {}
    for op, row in counter.by_op.items():
        k = op_kind(op) or f"unmatched:{op}"
        c = out.setdefault(k, collections.Counter())
        c["flops"] += row["flops"]
        c["bytes"] += row["bytes"]
    return out


def profile_by_kind(replay: Callable[[], None], reps: int = 3):
    """Device milliseconds a call of ``replay`` by kind (``kernel_kind``),
    the mean of ``reps`` calls under ``torch.profiler``; kernels of no kind
    under "unmatched:<name>"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            replay()
        torch.cuda.synchronize()
    ms: Dict[str, float] = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        k = kernel_kind(e.name) or f"unmatched:{e.name[:60]}"
        ms[k] += e.time_range.elapsed_us() / 1e3 / reps
    return dict(ms)


def measure_step(replay: Callable[[], None], count_fn: Callable[[], None],
                 *, fake_mode=None, flops_per_s: float = 989e12,
                 bytes_per_s: float = 3.35e12, reps: int = 3, log=print):
    """Device ms of a call of ``replay`` (a built step, e.g. a CUDA graph's
    replay) by kind beside what ``count_fn`` counts by kind: ``count_fn``
    runs the same step on fake tensors of the same shapes, under
    ``fake_mode`` (``hlo_analysis.fake_copy`` makes its objects). Logs one
    line a kind (ms, GFLOP, GB, the kind's bound ms at ``flops_per_s`` and
    ``bytes_per_s``) and returns ({kind: ms}, {kind: counts}, the
    counter)."""
    import contextlib
    with fake_mode or contextlib.nullcontext():
        with CostCounter() as c:
            count_fn()
    counted = count_by_kind(c)
    ms = profile_by_kind(replay, reps)
    for k in sorted(set(ms) | set(counted),
                    key=lambda k: -ms.get(k, 0.0)):
        row = counted.get(k, collections.Counter())
        bound = max(row["flops"] / flops_per_s,
                    row["bytes"] / bytes_per_s) * 1e3
        log(f"  {k:28s} {ms.get(k, 0.0):9.4f} ms  "
            f"{row['flops'] / 1e9:10.4f} GFLOP  {row['bytes'] / 1e9:9.4f} GB"
            f"  bound {bound:8.4f} ms")
    return ms, counted, c


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--output-mode", default="exact")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--kind", default="collective",
                    choices=["collective", "bytes", "flops"])
    a = ap.parse_args()
    run(a.arch, a.shape, a.mesh, a.output_mode, a.top, a.kind)
