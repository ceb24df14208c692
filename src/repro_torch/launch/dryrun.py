"""Dry run: count one rank's step of every (arch x shape x mesh) cell with
no device and no weights (counterpart of ``repro.launch.dryrun``).

Each cell runs one rank's program under ``FakeTensorMode``, on a fake
process group of 256 ranks (``single``, mesh (16, 16)) or 512 (``multi``,
(2, 16, 16)) behind ``launch.mesh.make_production_mesh``; every rank runs
the same program, so rank 0 stands for all. ``hlo_analysis.CostCounter``
counts the step's products, bytes, transcendentals, collectives and peak
live storage. The steps are the ones the port runs:

  * train   ``make_train_step(mesh=)`` with ``fused_ce``, JAX's
            ``max(1, global_batch // data)`` microbatches of the rank's
            rows. Every microbatch is the same program, so a step of more
            than 2 is traced at 2 (the record's ``traced_microbatches``)
            and its second microbatch's counts (the section
            ``train_loop`` marks) added for each further one, as JAX
            multiplies a loop body by its trip count; the peak is the
            traced step's.
  * prefill ``Model.forward`` on the rank's rows, then the exact head on
            the last position over the rank's vocabulary rows.
  * decode  the serving mesh's lanes of the rank (``global_batch //
            data``, the batch whole where it does not split) through
            ``Model.decode_step``; the trunk runs whole on every rank of a
            model group (the serving mesh splits only the O(V d)
            payloads). The output is ``streaming_logz_argmax`` (``topk_z``
            at k 1) on the rank's vocabulary rows with ``logspace_psum``
            and a top-1 merge (``exact``), or ``serve.output_layer.
            sharded_decode`` on the rank's IVF blocks (``mimps``, for the
            archs whose partition method probes an IVF index).

The kernel wrappers run their plain versions (fake tensors have no data
pointer), counted as the kernels (``hlo_analysis``). Nothing here runs
when the module is imported.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
      --shape decode_32k --mesh single [--output-mode mimps]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

Records land in ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>[__mode]
.json``; the products, bytes and memory are counts of the traced program,
not measurements.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional

import torch

from ..configs import ASSIGNED_ARCHS, get_config
from ..configs.base import SHAPES, ShapeConfig, TrainConfig, get_shape
from ..models import Model
from ..models.transformer import torch_dtype
from . import mesh as mesh_lib
from .hlo_analysis import CostCounter

OUT_DIR = "artifacts/dryrun_torch"
MESH_SHAPES = {"single": ((16, 16), mesh_lib.AXES),
               "multi": ((2, 16, 16), mesh_lib.POD_AXES)}
IVF_METHODS = ("mimps", "mince")


# ---------------------------------------------------------------------------
# the fake process group
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_mesh(shape, names):
    """A mesh of dims ``names`` and sizes ``shape`` over a fake process
    group of ``prod(shape)`` ranks, this process rank 0; the group is
    destroyed on exit. Raises if a default group already exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield mesh_lib.make_mesh(shape, names, device_type="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# input specs per (arch, shape)
# ---------------------------------------------------------------------------

def token_struct(cfg, batch: int, seq: int, device):
    shape = (batch, seq, cfg.n_codebooks) if cfg.n_codebooks else \
        (batch, seq)
    return torch.zeros(shape, dtype=torch.long, device=device)


def image_struct(cfg, batch: int, device):
    return torch.zeros((batch, cfg.n_image_tokens, cfg.d_model),
                       dtype=torch_dtype(cfg.dtype), device=device)


def train_batch_struct(cfg, batch: int, seq: int, device):
    out = {"tokens": token_struct(cfg, batch, seq, device),
           "labels": token_struct(cfg, batch, seq, device)}
    if cfg.family == "vlm":
        out["img"] = image_struct(cfg, batch, device)
    return out


def rank_rows(mesh, batch: int) -> int:
    """The rows a rank holds of a batch: its share over the data axes,
    or the whole batch where it does not split."""
    if mesh_lib.batch_axis_for(mesh, batch) is None:
        return batch
    return batch // mesh_lib.data_size(mesh)


def input_specs(cfg, sc: ShapeConfig, mesh, device):
    """Tensors on ``device`` of every model input of one rank's cell on
    ``mesh``: the global batch for train (each rank takes its rows); for
    prefill and decode the rank's rows, with a decode's state, token,
    position and, for a VLM, image."""
    if sc.kind == "train":
        return {"batch": train_batch_struct(cfg, sc.global_batch, sc.seq_len,
                                            device)}
    rows = rank_rows(mesh, sc.global_batch)
    if sc.kind == "prefill":
        out = {"tokens": token_struct(cfg, rows, sc.seq_len, device)}
    else:
        tok = token_struct(cfg, rows, 1, device)
        out = {"state": Model(cfg).init_decode_state(rows, sc.seq_len,
                                                     device),
               "token": tok[:, 0],
               "pos": torch.full((), sc.seq_len - 1, dtype=torch.int32,
                                 device=device)}
    if cfg.family == "vlm":
        out["img"] = image_struct(cfg, rows, device)
    return out


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Step:
    """One rank's step: ``run()`` makes it once; ``inputs`` are the
    tensors alive before it (params, state, batch) for the memory count;
    ``meta`` goes into the record."""
    run: Callable[[], Any]
    inputs: Any
    meta: Dict[str, Any]


def exact_head(mesh, h: torch.Tensor, w: torch.Tensor):
    """Exact log Z and top-1 of h (B, d) over the rank's rows of ``w``
    (V, d), or (C, V, d) with codebooks (each codebook's (B,) stacked to
    (B, C)): ``streaming_logz_argmax`` (``topk_z`` at k 1) on the rank's
    rows, ``logspace_psum`` and the top-1 merge over the model group."""
    from ..core.distributed import group_rank, logspace_psum, merge_topk
    from ..serve.output_layer import streaming_logz_argmax
    group = mesh_lib.axis_group(mesh, "model")
    spec = (("model", None) if w.dim() == 2 else (None, "model", None))
    if w.shape[-2] % mesh_lib.axis_size(mesh, "model"):
        spec = (None,) * w.dim()
    w_loc = mesh_lib.local_view(w, mesh_lib.Placement(mesh, spec))
    split = spec[-2] is not None
    off = group_rank(group) * w_loc.shape[-2] if split else 0
    outs = []
    for wc in ([w_loc] if w.dim() == 2 else w_loc.unbind(0)):
        lse, top_id, top_s = streaming_logz_argmax(h, wc.contiguous(),
                                                   use_kernel=True)
        if split:
            lse = logspace_psum(lse, group)
            top_s, top_id = merge_topk(top_s[:, None], (top_id + off)[:, None],
                                       1, group)
            top_s, top_id = top_s[:, 0], top_id[:, 0]
        outs.append((lse, top_id, top_s))
    if w.dim() == 2:
        return outs[0]
    return tuple(torch.stack(x, 1) for x in zip(*outs))


def build_step(cfg, sc: ShapeConfig, mesh, output_mode: str = "exact", *,
               microbatches: Optional[int] = None, seed: int = 0) -> Step:
    """One rank's step of the cell (counterpart of JAX's
    ``build_lowering``), its tensors made on the CPU: call it under
    ``FakeTensorMode`` for a full-size cell. ``microbatches`` overrides
    the train step's count (the rank then holds that many rows, one a
    microbatch, as at the JAX rule's count)."""
    from ..train import init_train_state, make_train_step
    model = Model(cfg)
    dsize = mesh_lib.data_size(mesh)
    dev = "cpu"

    if sc.kind == "train":
        rule = max(1, sc.global_batch // dsize)
        mb = rule if microbatches is None else microbatches
        tc = TrainConfig(loss="fused_ce", microbatches=mb)
        n = sc.global_batch if microbatches is None else \
            mb * sc.global_batch // rule
        state = init_train_state(model, tc, seed, dev, mesh=mesh)
        batch = train_batch_struct(cfg, n, sc.seq_len, dev)
        step = make_train_step(model, tc, mesh=mesh)
        return Step(lambda: step(state, batch), (state, batch),
                    {"step": "train_step", "microbatches": rule,
                     "rows_per_rank": rank_rows(mesh, sc.global_batch)})

    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    w = model.head_matrix(params)
    specs = input_specs(cfg, sc, mesh, dev)
    img = specs.get("img")
    rows = specs["tokens" if sc.kind == "prefill" else "token"].shape[0]

    if sc.kind == "prefill":
        def prefill_step():
            from .hlo_analysis import section
            with section("trunk"):
                hidden, _ = model.forward(params, specs["tokens"], img=img)
            with section("head"):
                log_z, top_id, top_s = exact_head(mesh, hidden[:, -1], w)
            return {"log_z": log_z, "token": top_id, "top": top_s}
        return Step(prefill_step, (params, specs),
                    {"step": "prefill_step", "rows_per_rank": rows})

    pc = cfg.partition
    use_ivf = (output_mode == "mimps" and pc.method in IVF_METHODS
               and not cfg.n_codebooks)
    ivf, gen = None, None
    if use_ivf:
        from ..serve.output_layer import ivf_partition_specs, ivf_specs_for
        m = mesh_lib.axis_size(mesh, "model")
        whole = ivf_specs_for(cfg.vocab, cfg.d_model, pc.block_rows,
                              torch_dtype(cfg.dtype), shard_multiple=m,
                              device=dev)
        ivf = type(whole)(*[mesh_lib.local_view(
            t, mesh_lib.Placement(mesh, s))
            for t, s in zip(whole, ivf_partition_specs())])
        gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def serve_step():
        from .hlo_analysis import section
        with section("trunk"):
            h = model.decode_step(params, specs["state"], specs["token"],
                                  specs["pos"], img=img)
        with section("head"):
            if ivf is not None:
                from ..serve.output_layer import sharded_decode
                m = mesh_lib.axis_size(mesh, "model")
                kw = ({"iters": pc.mince_iters, "solver": pc.mince_solver}
                      if pc.method == "mince" else {})
                log_z, top_id, top_s = sharded_decode(
                    mesh, pc.method, ivf, h,
                    n_probe_local=max(1, pc.n_probe // m),
                    l_local=max(8, pc.l // m), generator=gen, **kw)
            else:
                log_z, top_id, top_s = exact_head(mesh, h, w)
        return {"log_z": log_z, "token": top_id, "log_prob": top_s - log_z}

    return Step(serve_step, (params, specs, ivf),
                {"step": f"serve_step[{'mimps' if use_ivf else 'exact'}]",
                 "lanes_per_rank": rows})


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def count_step(step: Step) -> Dict[str, Any]:
    """``CostCounter``'s summary of one ``step.run()``, with its sections
    and ``trace_s``."""
    t0 = time.time()
    with CostCounter(trips=True) as c:
        c.track(step.inputs)
        step.run()
    out = c.summary()
    out["sections"] = {k: dict(v) for k, v in c.sections.items()}
    out["trace_s"] = time.time() - t0
    return out


def _extrapolate(c: Dict[str, Any], rule: int) -> Dict[str, Any]:
    """Counts at ``rule`` microbatches from a step traced at 2: the step's
    counts plus ``rule - 2`` times its second microbatch's (the section
    ``train_loop`` marks, its gradient accumulation and, under the compute
    split, its collectives over 'model' included)."""
    one = c["sections"]["microbatch 1"]
    out = dict(c)
    for k in ("flops", "bytes", "transcendentals"):
        out[k] = c[k] + (rule - 2) * one[k]
    coll = dict(c["collectives"])
    for k, v in one.items():
        if k.startswith("collective:"):
            kind = k.split(":", 1)[1]
            coll[kind] = coll.get(kind, 0) + (rule - 2) * v
    out["collectives"] = coll
    return out


def count_cell(cfg, sc: ShapeConfig, mesh, output_mode: str = "exact"
               ) -> Dict[str, Any]:
    """One rank's counts of the cell on ``mesh``, on fake tensors; the
    build's ``meta`` merged in."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        step = build_step(cfg, sc, mesh, output_mode)
        rule = step.meta.get("microbatches", 1)
        meta = dict(step.meta)
        if sc.kind == "train" and rule > 2:
            del step
            counts = _extrapolate(count_step(build_step(
                cfg, sc, mesh, output_mode, microbatches=2)), rule)
            meta["traced_microbatches"] = 2
        else:
            counts = count_step(step)
    return {**meta, **counts}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             output_mode: str = "exact", out_dir: str = OUT_DIR
             ) -> Dict[str, Any]:
    """Counts the cell on a fake production mesh and writes its record to
    ``<out_dir>/<mesh>/<arch>__<shape>[__mode].json``."""
    cfg = get_config(arch)
    sc = get_shape(shape_name)
    if shape_name == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": "pure full-attention arch (DESIGN.md SS5)"}
    shape, names = MESH_SHAPES[mesh_kind]
    with fake_mesh(shape, names) as mesh:
        c = count_cell(cfg, sc, mesh, output_mode)
    sections = c.pop("sections")
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "output_mode": output_mode,
        **{k: v for k, v in c.items() if k not in (
            "flops", "bytes", "transcendentals", "collectives",
            "peak_bytes", "trace_s")},
        "n_chips": math.prod(shape),
        "trace_s": round(c["trace_s"], 2),
        "flops_per_device": c["flops"],
        "bytes_per_device": c["bytes"],
        "transcendentals_per_device": c["transcendentals"],
        "collective_bytes": c["collectives"],
        "peak_bytes_per_device": c["peak_bytes"],
        "sections": sections,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "global_tokens": sc.global_batch * (sc.seq_len if sc.kind == "train"
                                            else 1),
    }
    os.makedirs(f"{out_dir}/{mesh_kind}", exist_ok=True)
    suffix = "" if output_mode == "exact" else f"__{output_mode}"
    with open(f"{out_dir}/{mesh_kind}/{arch}__{shape_name}{suffix}.json",
              "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--output-mode", default="exact",
                    choices=["exact", "mimps"])
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape on --mesh at --output-mode")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s.name) for a in ASSIGNED_ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    torch.set_num_threads(1)
    failures = 0
    for a, s in cells:
        try:
            r = run_cell(a, s, args.mesh, args.output_mode, args.out)
            if "skipped" in r:
                print(f"[SKIP] {a} x {s} x {args.mesh}: {r['skipped']}",
                      flush=True)
            else:
                cb = sum(r["collective_bytes"].values())
                print(f"[OK]   {a} x {s} x {args.mesh} ({r['step']}): "
                      f"trace {r['trace_s']}s flops/dev "
                      f"{r['flops_per_device']:.4e} bytes/dev "
                      f"{r['bytes_per_device']:.4e} coll/dev "
                      f"{cb / 1e9:.3f} GB peak/dev "
                      f"{r['peak_bytes_per_device'] / 1e9:.2f} GB",
                      flush=True)
        except Exception:                                   # noqa: BLE001
            failures += 1
            print(f"[FAIL] {a} x {s} x {args.mesh}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
