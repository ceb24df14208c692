"""One rank of the sharded-training tests (``tests/test_torch_train_mesh.py``):
a gloo group of ``world`` ranks from a ``FileStore``, every rank running
this script with the same seeds. Imports no JAX: the pytest process writes
the JAX package's parameters and batch to ``<out>/inputs.npz`` first and
computes JAX's references from what the ranks write, ``<out>/rank<r>.pt``.

    python tests/_torch_train_mesh_rank.py RANK WORLD STORE OUT

Over the same four ranks, on reduced configs in f32 (qwen1.5-4b unless
named):

* (1, 4): fused_ce, ce and mimps_ce, 2 steps each from seed 0, on reduced
  rwkv6 (which the compute split gathers whole: the state's bits) and on
  qwen1.5-4b (the split: what the tolerances read), each beside the
  one-device run; mimps_ce's index refresh after a (1, 4) step beside one
  device's refresh of the same (gathered) parameters;
* (2, 2) and (4, 1): fused_ce and nce, 2 steps; and (2, 2) fused_ce with 2
  microbatches, 1 step: what the tolerances read (each step's loss and
  grad_norm, each leaf's gradient as m / (1 - b1) after step 1); (2, 2),
  2 steps, beside one device's with 2 microbatches holding the replicas'
  rows (rwkv6 with ce: bits; qwen with fused_ce: the tolerances);
  (2, 1, 2) with the pod axis summing;
* the compute split from the JAX package's qwen1.5-4b and
  deepseek-moe-16b parameters (``inputs.npz``): fused_ce, ce, selfnorm
  and the MoE at (1, 4) and (2, 2), one step, the state whole for JAX's
  references, each rank's slices and mesh coordinates, the leaves
  gathered; mimps_ce, mince_ce and lsh_ce at (2, 2) beside one device on
  the whole batch; the vocab-parallel lookup and CE pair at model 4;
* compress_psum over the four ranks on seeded numpy gradients, int8 and
  none, bf16 and f32;
* (2, 2) with pod_axis="data" and int8 from the JAX package's parameters:
  the compressor's inputs and outputs (gathered whole over 'model'), m
  after one step, every rank's digest of the gathered state;
* a checkpoint saved at (2, 2) after one step, restored at (2, 2), at
  (1, 4) and on one device, and the step after each (the split qwen1.5-4b
  under fused_ce, reduced rwkv6 under ce);
* ``launch.train.main`` at (2, 2): 3 steps with a checkpoint at 2, then a
  run resumed from that checkpoint alone (``--model-parallel 2``);
* after the four-rank group, rank 0 alone in a one-rank group: two
  fused_ce steps at mesh (1, 1) beside one device's.
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
from repro_torch.models.transformer import tree_paths  # noqa: E402
from repro_torch.train import (CheckpointManager, TrainState,  # noqa: E402
                               compress_psum, init_opt_state,
                               init_train_state, make_train_step,
                               params_placements, state_shardings,
                               train_loop)

B, S = 8, 16
SEED = 0
BIT_LOSSES = ("fused_ce", "ce", "mimps_ce")
# the compute split held to one device and to JAX: (arch key, loss); the
# arch keys name the JAX parameter trees the pytest process writes
SPLIT_CASES = (("qwen", "fused_ce"), ("qwen", "ce"), ("qwen", "selfnorm"),
               ("moe", "fused_ce"))
SPLIT_MESHES = ((1, 4), (2, 2))
ARCHS = {"qwen": "qwen1.5-4b", "moe": "deepseek-moe-16b",
         "rwkv": "rwkv6-7b"}
EST_LOSSES = ("mimps_ce", "mince_ce", "lsh_ce")
TOL_LOSSES = ("fused_ce", "nce")
TOL_MESHES = ((2, 2), (4, 1))
# compress_psum's numpy inputs: rank r's gradients of these shapes
CP_SHAPES = ((37,), (5, 8))
B1 = TrainConfig().beta1


def cfg(arch="qwen"):
    return dataclasses.replace(reduced_config(ARCHS[arch]), dtype="float32")


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
    """(1, 4) against one device, 2 steps: reduced rwkv6, whose blocks the
    split gathers whole (bits, and the tolerance's numbers), and the split
    qwen1.5-4b (the tolerance's numbers)."""
    mesh = M.make_mesh_2d((1, 4))
    rwkv = Model(cfg("rwkv"))
    for loss in BIT_LOSSES:
        tc = tcfg(loss)
        out = {}
        for name, mdl in (("rwkv", rwkv), ("qwen", model)):
            bs = batches(mdl.cfg.vocab, 2)
            first, got, logs = run(mdl, tc, bs, mesh)
            ref_first, ref, ref_logs = run(mdl, tc, bs)
            out[name] = (same_bits(got, ref), grad_errors(first, ref_first),
                         logs, ref_logs)
        res[("bits", loss)] = out


def refresh_run(model, res):
    """The index refresh of a (1, 4) mimps_ce state (the head gathered)
    after one step, beside one device's refresh of the same parameters
    (the sharded state's, gathered)."""
    mesh = M.make_mesh_2d((1, 4))
    tc = tcfg("mimps_ce")
    b = batches(model.cfg.vocab, 1)[0]
    state = init_train_state(model, tc, SEED, "cpu", mesh=mesh)
    state, _ = make_train_step(model, tc, mesh=mesh)(state, b)
    params = M.gather_tree(state.params, params_placements(model, mesh))
    one = TrainState(params=params, opt=init_opt_state(params),
                     rng=state.rng, index=state.index)
    out = []
    for st, m in ((state, mesh), (one, None)):
        st, met = train_loop.make_index_refresh(model, tc, mesh=m)(st)
        out.append(([t.clone() if torch.is_tensor(t) else t
                     for t in st.index], met))
    res["refresh"] = out


def jax_params(out, arch):
    """The JAX package's parameters of ``arch`` from ``inputs.npz``."""
    data = np.load(os.path.join(out, "inputs.npz"))
    tree = {}
    for key in data.files:
        if key.startswith(arch + "/"):
            node = tree
            *parts, last = key[len(arch) + 1:].split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = data[key]
    return params_from_numpy(tree, cfg(arch), "cpu"), {
        k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}


def step_from(model, tc, params, batch, mesh=None):
    """One step from ``params`` (whole leaves) on ``batch``: the state after
    it (whole leaves), (loss, grad_norm), and this rank's own slices of
    the state after it, by name."""
    params = _clone(params) if mesh is None else M.shard_tree(
        params, params_placements(model, mesh))
    state = TrainState(params=params, opt=init_opt_state(params),
                       rng=torch.Generator().manual_seed(1))
    state, met = make_train_step(model, tc, mesh=mesh)(state, batch)
    local = {}
    for part, tree in (("params", state.params), ("m", state.opt.m),
                       ("v", state.opt.v)):
        for path, leaf in tree_paths(tree):
            local[part + path] = leaf.detach().clone()
    return whole(model, state, mesh), (met["loss_total"].item(),
                                       met["grad_norm"].item()), local


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def split_runs(out, rank, res):
    """The compute split at (1, 4) and (2, 2) from the JAX package's
    parameters and batch, one step each, against one device: the whole
    batch, or at (2, 2) for the MoE two microbatches holding the replicas'
    rows (each replica routes and sizes its experts' capacity from its own
    rows, as one device does a microbatch's). The state after the step is
    kept whole for the JAX comparison, and each rank's own slices with its
    mesh coordinates for the replica checks."""
    perm = torch.stack([torch.arange(B // 2), torch.arange(B // 2, B)],
                       1).reshape(-1)
    for arch, loss in SPLIT_CASES:
        model = Model(cfg(arch))
        params, batch = jax_params(out, arch)
        ref = {}
        for shape in SPLIT_MESHES:
            mesh = M.make_mesh_2d(shape)
            mb = 2 if arch == "moe" and shape[0] > 1 else 1
            if mb not in ref:
                b = batch if mb == 1 else {k: v[perm]
                                           for k, v in batch.items()}
                ref[mb] = step_from(model, tcfg(loss, microbatches=mb),
                                    params, b)
            got, log, local = step_from(model, tcfg(loss), params, batch,
                                        mesh)
            step = make_train_step(model, tcfg(loss), mesh=mesh)
            spec = {"params" + p: M.param_spec(p, x, shape[1])
                    for p, x in tree_paths_of(model)}
            res[("split", arch, loss, shape)] = {
                "errs": grad_errors(got, ref[mb][0]), "log": log,
                "ref_log": ref[mb][1], "mb": mb,
                "m": {k: v for k, v in got.items() if k.startswith("m[")},
                "local": local, "gathered": step.gathered,
                "coord": (M.axis_rank(mesh, "data"),
                          M.axis_rank(mesh, "model")),
                "replicated": [k for k, sp in spec.items()
                               if "model" not in sp]}


def tree_paths_of(model):
    return list(tree_paths(model.init(torch.Generator(), "meta")))


def estimator_runs(model, vocab, res):
    """mimps_ce, mince_ce and lsh_ce at (2, 2), 2 steps, against one
    device's steps on the whole batch (the plan is the whole batch's on
    every rank)."""
    mesh = M.make_mesh_2d((2, 2))
    bs = batches(vocab, 2)
    for loss in EST_LOSSES:
        tc = tcfg(loss)
        first, _, logs = run(model, tc, bs, mesh)
        ref_first, _, ref_logs = run(model, tc, bs)
        res[("est", loss)] = (grad_errors(first, ref_first), logs, ref_logs)


def vocab_runs(model, rank, res):
    """At model 4: the vocab-parallel lookup beside the whole table's, and
    the CE pair on each rank's rows with the combined lse (nll, lse, dh
    after the reduce, this rank's dW rows) beside the whole pair, on seeded
    inputs."""
    from repro_torch.core.distributed import split_compute
    from repro_torch.kernels.ops import fused_cross_entropy
    from repro_torch.models.layers import embed
    mesh = M.make_mesh_2d((1, 4))
    group = M.axis_group(mesh, "model")
    r = M.axis_rank(mesh, "model")
    g = torch.Generator().manual_seed(11)
    v, d, t = model.cfg.vocab, model.cfg.d_model, 24
    table = torch.randn(v, d, generator=g)
    tokens = torch.randint(0, v, (3, 8), generator=g)
    n = v // 4
    with split_compute(group):
        got = embed({"table": table[r * n:(r + 1) * n]}, tokens, v)
    res["lookup"] = torch.equal(bits(got), bits(embed({"table": table},
                                                      tokens)))
    h = torch.randn(t, d, generator=g) * 0.3
    labels = torch.randint(0, v, (t,), generator=g)
    g_nll, g_lse = torch.randn(t, generator=g), torch.randn(t, generator=g)
    out = {}
    for name, w, grp in (("shard", table[r * n:(r + 1) * n], group),
                         ("whole", table, None)):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        nll, lse = fused_cross_entropy(hh, ww, labels, grp)
        dh, dw = torch.autograd.grad((nll * g_nll + lse * g_lse).sum(),
                                     (hh, ww))
        out[name] = {"nll": nll.detach(), "lse": lse.detach(), "dh": dh,
                     "dw": dw}
    res["ce_pair"] = (r, out)


def one_rank_run(out, res):
    """A one-rank group at mesh (1, 1): the split is the identity, so two
    fused_ce steps equal one device's bit for bit."""
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(out, "store_one"), 1), rank=0, world_size=1)
    model = Model(cfg())
    bs = batches(model.cfg.vocab, 2)
    tc = tcfg("fused_ce")
    _, got, logs = run(model, tc, bs, M.make_mesh_2d((1, 1)))
    _, ref, ref_logs = run(model, tc, bs)
    res["one rank"] = (same_bits(got, ref), logs, ref_logs)
    dist.destroy_process_group()


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
    # (reduced rwkv6 with ce, whose leaves the split gathers whole: bits;
    # the split qwen1.5-4b with fused_ce: the tolerance's numbers)
    mesh = M.make_mesh_2d((2, 2))
    perm = torch.stack([torch.arange(B // 2), torch.arange(B // 2, B)],
                       1).reshape(-1)
    out = {}
    for name, mdl, loss in (("rwkv", Model(cfg("rwkv")), "ce"),
                            ("qwen", model, "fused_ce")):
        first, got, logs = run(mdl, tcfg(loss), bs, mesh)
        ref_first, ref, ref_logs = run(
            mdl, tcfg(loss, microbatches=2),
            [{k: v[perm] for k, v in b.items()} for b in bs])
        out[name] = (same_bits(got, ref), grad_errors(first, ref_first),
                     logs, ref_logs)
    res[("mb bits", (2, 2))] = out
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
    mesh = M.make_mesh_2d((2, 2))
    full, batch = jax_params(out, "qwen")
    whole_shapes = [x.shape for _, x in tree_paths(full)]
    params = M.shard_tree(full, params_placements(model, mesh))
    state = TrainState(params=params, opt=init_opt_state(params),
                       rng=torch.Generator().manual_seed(1))
    tc = tcfg("fused_ce", grad_compression="int8", grad_clip=1e9)
    step = make_train_step(model, tc, mesh=mesh, pod_axis="data")
    rec, real_cp, real_ar = {"int32": []}, train_loop.compress_psum, \
        dist.all_reduce

    placements = M.placements_like(params, params_placements(model, mesh))

    def wholes(gs):
        # a slice of a leaf the split computes on is gathered for the
        # record; a leaf computed whole is already whole
        return [M.gather_leaf(g.detach(), p) if g.shape != w
                else g.detach().clone()
                for g, p, w in zip(gs, placements, whole_shapes)]

    def recording_cp(grads, group, mode, amax_group=None):
        rec["local"] = [g.numel() for g in grads]
        rec["inside"] = True
        got = real_cp(grads, group, mode, amax_group)
        rec["inside"] = False
        rec["in"], rec["out"] = wholes(grads), wholes(got)
        return got

    def counting_ar(t, *args, **kwargs):
        if t.dtype == torch.int32 and rec.get("inside"):
            rec["int32"].append(t.numel())
        return real_ar(t, *args, **kwargs)
    train_loop.compress_psum = recording_cp
    dist.all_reduce = counting_ar
    try:
        state, met = step(state, batch)
    finally:
        train_loop.compress_psum = real_cp
        dist.all_reduce = real_ar
    got = whole(model, state, mesh)
    res["int8"] = {"in": rec["in"], "out": rec["out"],
                   "m": {k: v for k, v in got.items() if k.startswith("m[")},
                   "loss": met["loss_total"].item(),
                   "digest": digest(got), "int32_sums": rec["int32"],
                   "local_sizes": rec["local"],
                   "data_rank": M.axis_rank(mesh, "data")}


def state_errors(got, ref, base):
    """Per leaf of the state after a step from ``base``: (max |got - ref|,
    max |ref|, ||got - ref||, ||ref||) of m, of sqrt(v) (the gradients'
    root mean square) and of the parameters' update from ``base``."""
    out = {}
    for k in ref:
        g, r = got[k], ref[k]
        if k.startswith("v["):
            g, r = g.sqrt(), r.sqrt()
        elif k.startswith("params"):
            g, r = g - base[k], r - base[k]
        out[k] = ((g - r).abs().max().item(), r.abs().max().item(),
                  (g - r).norm().item(), r.norm().item())
    return out


def checkpoint_run(model, vocab, out, rank, res):
    """A checkpoint saved at (2, 2) after one step, restored at (2, 2),
    (1, 4) and on one device, and the step after each: the split
    qwen1.5-4b under fused_ce, and reduced rwkv6 under ce, whose step the
    split leaves gathering every leaf."""
    m22, m14 = M.make_mesh_2d((2, 2)), M.make_mesh_2d((1, 4))
    res["ckpt"] = {}
    for name, mdl, loss in (("qwen", model, "fused_ce"),
                            ("rwkv", Model(cfg("rwkv")), "ce")):
        tc = tcfg(loss)
        b1, b2 = batches(mdl.cfg.vocab, 2)
        step22 = make_train_step(mdl, tc, mesh=m22)
        state = init_train_state(mdl, tc, SEED, "cpu", mesh=m22)
        state, _ = step22(state, b1)
        mgr = CheckpointManager(os.path.join(out, "ckpt_" + name), keep=3,
                                async_write=False)
        mgr.save(1, state, shardings=state_shardings(mdl, m22))
        saved = whole(mdl, state, m22)
        state, _ = step22(state, b2)
        uninterrupted = whole(mdl, state, m22)

        def restored(mesh):
            like = init_train_state(mdl, tc, SEED, "cpu", mesh=mesh)
            st, man = mgr.restore(None, like, shardings=None if mesh is None
                                  else state_shardings(mdl, mesh))
            got = whole(mdl, st, mesh)
            st, _ = make_train_step(mdl, tc, mesh=mesh)(st, b2)
            return got, whole(mdl, st, mesh), man["step"]

        r22, n22, s22 = restored(m22)
        r14, n14, s14 = restored(m14)
        r1, n1, s1 = restored(None)
        res["ckpt"][name] = {
            "steps": (s22, s14, s1),
            "restored": [same_bits(r, saved) for r in (r22, r14, r1)],
            "next 2x2": same_bits(n22, uninterrupted),
            "next 1x4": same_bits(n14, n1),
            # the split's sums at (1, 4) differ from one device's in
            # rounding
            "next 1x4 errors": state_errors(n14, n1, saved)}


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
    t1 = time.time()
    split_runs(out, rank, res)
    estimator_runs(model, c.vocab, res)
    vocab_runs(model, rank, res)
    res["split seconds"] = time.time() - t1
    compress_runs(rank, res)
    int8_run(model, out, rank, res)
    checkpoint_run(model, c.vocab, out, rank, res)
    cli_run(out, rank, res)
    try:
        M.make_production_mesh()
    except ValueError as e:
        res["production"] = str(e)
    dist.destroy_process_group()
    if rank == 0:
        one_rank_run(out, res)
    res["seconds"] = time.time() - t0
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
