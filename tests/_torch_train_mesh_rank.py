"""One rank of the sharded-training tests (``tests/test_torch_train_mesh.py``):
a gloo group of ``world`` ranks from a ``FileStore``, every rank running
this script with the same seeds. Imports no JAX: the pytest process writes
the JAX package's parameters and batch to ``<out>/inputs.npz`` first and
computes JAX's references from what the ranks write, ``<out>/rank<r>.pt``.

    python tests/_torch_train_mesh_rank.py RANK WORLD STORE OUT

Over the same four ranks, on the reduced qwen1.5-4b in f32:

* (1, 4): fused_ce, ce and mimps_ce, 2 steps each from seed 0, the
  gathered state and each step's loss and grad_norm beside the one-device
  run's; mimps_ce's index refresh after a step beside one device's;
* (2, 2) and (4, 1): fused_ce and nce, 2 steps; and (2, 2) fused_ce with 2
  microbatches, 1 step: what the tolerances read (each step's loss and
  grad_norm, each leaf's gradient as m / (1 - b1) after step 1); (2, 2)
  fused_ce, 2 steps, beside one device's with 2 microbatches holding the
  replicas' rows; (2, 1, 2) with the pod axis summing;
* compress_psum over the four ranks on seeded numpy gradients, int8 and
  none, bf16 and f32;
* (2, 2) with pod_axis="data" and int8 from the JAX package's parameters:
  the compressor's inputs and outputs, m after one step, every rank's
  digest of the gathered state;
* a checkpoint saved at (2, 2) after one step, restored at (2, 2), at
  (1, 4) and on one device, and the step after each;
* ``launch.train.main`` at (2, 2): 3 steps with a checkpoint at 2, then a
  run resumed from that checkpoint alone.
"""
import dataclasses
import datetime
import os
import shutil
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import TrainConfig, reduced_config  # noqa: E402
from repro_torch.data import DataIterator, SyntheticCorpus  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import (CheckpointManager, TrainState,  # noqa: E402
                               compress_psum, init_opt_state,
                               init_train_state, make_train_step,
                               params_placements, state_shardings,
                               train_loop)

B, S = 8, 16
SEED = 0
BIT_LOSSES = ("fused_ce", "ce", "mimps_ce")
TOL_LOSSES = ("fused_ce", "nce")
TOL_MESHES = ((2, 2), (4, 1))
# compress_psum's numpy inputs: rank r's gradients of these shapes
CP_SHAPES = ((37,), (5, 8))
B1 = TrainConfig().beta1


def cfg():
    return dataclasses.replace(reduced_config("qwen1.5-4b"), dtype="float32")


def tcfg(loss, **kw):
    return TrainConfig(loss=loss, lr=1e-3, warmup_steps=1, total_steps=10,
                       **kw)


def batches(vocab, n, b=B):
    it = DataIterator(SyntheticCorpus(vocab, seed=5), b, S)
    out = []
    for _ in range(n):
        toks, labels = next(it)
        out.append({"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(labels)})
    return out


def cp_inputs(rank):
    """Rank ``rank``'s compress_psum inputs (the pytest process makes the
    same ones)."""
    rng = np.random.default_rng(100 + rank)
    return [(rng.standard_normal(s) * (1 + i)).astype(np.float32)
            for i, s in enumerate(CP_SHAPES)]


def whole(model, state, mesh=None):
    """The state's parameters and moments as whole leaves, by name."""
    from repro_torch.models.transformer import tree_paths
    out = {}
    for part, tree in (("params", state.params), ("m", state.opt.m),
                       ("v", state.opt.v)):
        if mesh is not None:
            tree = M.gather_tree(tree, params_placements(model, mesh))
        for path, leaf in tree_paths(tree):
            out[part + path] = leaf.detach().clone()
    return out


def bits(t):
    return t.contiguous().view(torch.uint8)


def same_bits(a, b):
    """Names of the leaves whose bits differ (empty: every leaf equal)."""
    assert a.keys() == b.keys()
    return [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]


def digest(state_whole):
    return {k: int(bits(v).view(torch.int32).long().sum())
            for k, v in state_whole.items()}


def run(model, tc, bs, mesh=None, **kw):
    """Steps from seed 0 on ``bs``: the state after step 1 and after the
    last as whole leaves, and each step's (loss, grad_norm)."""
    state = init_train_state(model, tc, SEED, "cpu", mesh=mesh)
    step = make_train_step(model, tc, mesh=mesh, **kw)
    logs, first = [], None
    for b in bs:
        state, met = step(state, b)
        logs.append((met["loss_total"].item(), met["grad_norm"].item()))
        if first is None:
            first = whole(model, state, mesh)
    return first, whole(model, state, mesh), logs


def grad_errors(got, ref, scale=1.0):
    """Per leaf, the gradient read back as m / (1 - b1) after step 1
    (``got``'s times ``scale``): (max |got - ref|, max |ref|,
    ||got - ref||, ||ref||)."""
    out = {}
    for k in ref:
        if not k.startswith("m["):
            continue
        g, r = got[k] * scale / (1 - B1), ref[k] / (1 - B1)
        out[k] = ((g - r).abs().max().item(), r.abs().max().item(),
                  (g - r).norm().item(), r.norm().item())
    return out


def bit_runs(model, vocab, rank, res):
    mesh = M.make_mesh_2d((1, 4))
    bs = batches(vocab, 2)
    for loss in BIT_LOSSES:
        tc = tcfg(loss)
        _, got, logs = run(model, tc, bs, mesh)
        _, ref, ref_logs = run(model, tc, bs)
        res[("bits", loss)] = (same_bits(got, ref), logs, ref_logs)


def refresh_run(model, res):
    """The index refresh of a (1, 4) mimps_ce state (the head gathered)
    beside one device's, after one step."""
    mesh = M.make_mesh_2d((1, 4))
    tc = tcfg("mimps_ce")
    b = batches(model.cfg.vocab, 1)[0]
    out = []
    for m in (mesh, None):
        state = init_train_state(model, tc, SEED, "cpu", mesh=m)
        state, _ = make_train_step(model, tc, mesh=m)(state, b)
        state, met = train_loop.make_index_refresh(model, tc, mesh=m)(state)
        out.append(([t.clone() if torch.is_tensor(t) else t
                     for t in state.index], met))
    res["refresh"] = out


def tol_runs(model, vocab, rank, res):
    bs = batches(vocab, 2)
    for shape in TOL_MESHES:
        mesh = M.make_mesh_2d(shape)
        for loss in TOL_LOSSES:
            tc = tcfg(loss)
            first, _, logs = run(model, tc, bs, mesh)
            ref_first, _, ref_logs = run(model, tc, bs)
            res[("tol", shape, loss)] = (grad_errors(first, ref_first), logs,
                                         ref_logs)
    # at (2, 2) the mesh sums the partial gradients that one device sums
    # with two microbatches holding the replicas' rows (rows i::2 of the
    # reordered batch are replica i's)
    mesh = M.make_mesh_2d((2, 2))
    perm = torch.stack([torch.arange(B // 2), torch.arange(B // 2, B)],
                       1).reshape(-1)
    tc = tcfg("fused_ce")
    _, got, logs = run(model, tc, bs, mesh)
    _, ref, ref_logs = run(model, tcfg("fused_ce", microbatches=2),
                           [{k: v[perm] for k, v in b.items()} for b in bs])
    res[("mb bits", (2, 2))] = (same_bits(got, ref), logs, ref_logs)
    # a (pod, data, model) mesh whose pod axis sums: twice the gradient
    mesh = M.make_mesh((2, 1, 2), M.POD_AXES)
    tc = tcfg("fused_ce", grad_clip=1e9)
    first, _, logs = run(model, tc, bs[:1], mesh, pod_axis="pod")
    ref_first, _, ref_logs = run(model, tc, bs[:1])
    res[("tol", (2, 1, 2), "fused_ce pod sum")] = (
        grad_errors(first, ref_first, 0.5), logs, ref_logs)
    mesh = M.make_mesh_2d((2, 2))
    tc = tcfg("fused_ce", microbatches=2)
    first, _, logs = run(model, tc, bs[:1], mesh)
    ref_first, _, ref_logs = run(model, tc, bs[:1])
    res[("tol", (2, 2), "fused_ce mb2")] = (grad_errors(first, ref_first),
                                            logs, ref_logs)


def compress_runs(rank, res):
    group = dist.group.WORLD
    for dtype in (torch.float32, torch.bfloat16):
        grads = [torch.from_numpy(g).to(dtype)
                 for g in cp_inputs(rank)]
        for mode in ("int8", "none"):
            res[("compress", mode, str(dtype))] = compress_psum(
                [g.clone() for g in grads], group, mode)


def int8_run(model, out, rank, res):
    """pod_axis='data' at (2, 2), int8, from the JAX package's parameters
    and batch: the compressor's inputs and outputs, m after one step and
    the gathered state's digest."""
    data = np.load(os.path.join(out, "inputs.npz"))
    tree = {}
    for key in data.files:
        if key.startswith("p/"):
            node = tree
            *parts, last = key[2:].split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = data[key]
    mesh = M.make_mesh_2d((2, 2))
    full = params_from_numpy(tree, model.cfg, "cpu")
    params = M.shard_tree(full, params_placements(model, mesh))
    state = TrainState(params=params, opt=init_opt_state(params),
                       rng=torch.Generator().manual_seed(1))
    tc = tcfg("fused_ce", grad_compression="int8", grad_clip=1e9)
    step = make_train_step(model, tc, mesh=mesh, pod_axis="data")
    rec, real_cp, real_ar = {"int32": []}, train_loop.compress_psum, \
        dist.all_reduce

    def recording_cp(grads, group, mode):
        rec["in"] = [g.detach().clone() for g in grads]
        rec["inside"] = True
        got = real_cp(grads, group, mode)
        rec["inside"] = False
        rec["out"] = [g.clone() for g in got]
        return got

    def counting_ar(t, *args, **kwargs):
        if t.dtype == torch.int32 and rec.get("inside"):
            rec["int32"].append(t.numel())
        return real_ar(t, *args, **kwargs)
    train_loop.compress_psum = recording_cp
    dist.all_reduce = counting_ar
    try:
        batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
        state, met = step(state, batch)
    finally:
        train_loop.compress_psum = real_cp
        dist.all_reduce = real_ar
    got = whole(model, state, mesh)
    res["int8"] = {"in": rec["in"], "out": rec["out"],
                   "m": {k: v for k, v in got.items() if k.startswith("m[")},
                   "loss": met["loss_total"].item(),
                   "digest": digest(got), "int32_sums": rec["int32"],
                   "data_rank": M.axis_rank(mesh, "data")}


def checkpoint_run(model, vocab, out, rank, res):
    tc = tcfg("fused_ce")
    b1, b2 = batches(vocab, 2)
    m22, m14 = M.make_mesh_2d((2, 2)), M.make_mesh_2d((1, 4))
    step22 = make_train_step(model, tc, mesh=m22)
    state = init_train_state(model, tc, SEED, "cpu", mesh=m22)
    state, _ = step22(state, b1)
    mgr = CheckpointManager(os.path.join(out, "ckpt"), keep=3,
                            async_write=False)
    mgr.save(1, state, shardings=state_shardings(model, m22))
    saved = whole(model, state, m22)
    state, _ = step22(state, b2)
    uninterrupted = whole(model, state, m22)

    def restored(mesh):
        like = init_train_state(model, tc, SEED, "cpu", mesh=mesh)
        st, man = mgr.restore(None, like, shardings=None if mesh is None
                              else state_shardings(model, mesh))
        got = whole(model, st, mesh)
        st, _ = make_train_step(model, tc, mesh=mesh)(st, b2)
        return got, whole(model, st, mesh), man["step"]

    r22, n22, s22 = restored(m22)
    r14, n14, s14 = restored(m14)
    r1, n1, s1 = restored(None)
    res["ckpt"] = {
        "steps": (s22, s14, s1),
        "restored": [same_bits(r, saved) for r in (r22, r14, r1)],
        "next 2x2": same_bits(n22, uninterrupted),
        "next 1x4": same_bits(n14, n1)}


def cli_run(out, rank, res):
    from repro_torch.launch import train as L
    a, b = os.path.join(out, "cli_a"), os.path.join(out, "cli_b")
    flags = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4",
             "--seq", "16", "--model-parallel", "2", "--ckpt-every", "2",
             "--harvest-every", "1"]
    L.main(flags + ["--ckpt-dir", a])
    if rank == 0:
        os.makedirs(b)
        shutil.copytree(os.path.join(a, "step_0000000002"),
                        os.path.join(b, "step_0000000002"))
    dist.barrier()
    res["cli"] = L.main(flags + ["--ckpt-dir", b])


def main(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    t0 = time.time()
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    res = {}
    c = cfg()
    model = Model(c)
    bit_runs(model, c.vocab, rank, res)
    refresh_run(model, res)
    tol_runs(model, c.vocab, rank, res)
    compress_runs(rank, res)
    int8_run(model, out, rank, res)
    checkpoint_run(model, c.vocab, out, rank, res)
    cli_run(out, rank, res)
    try:
        M.make_production_mesh()
    except ValueError as e:
        res["production"] = str(e)
    res["seconds"] = time.time() - t0
    dist.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
