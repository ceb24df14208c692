"""One rank of the CPU mesh tests (``tests/test_torch_mesh.py``): a gloo
group of ``world`` ranks from a ``FileStore``, each rank running this
script with the same seeds. Imports no JAX: the pytest process computes
JAX's references from the inputs this script writes. Every rank writes its
results to ``<out>/rank<r>.pt``.

    python tests/_torch_mesh_rank.py RANK WORLD STORE OUT [cuda]

With ``cuda`` (``tests/test_torch_cuda_mesh.py``: four ranks sharing one
card over gloo) the engines serve from the card through the kernels, and
only the decode and function checks and the staggered trace run.

Runs, over the same four ranks, the mesh shapes (1, 4), (2, 2) and
(4, 1):

* every servable method's ``shard_decode`` beside the single-device decode
  of a mesh-free engine on the same hidden states and injected tail
  draws, through the kernel wrappers (their plain versions here) and the
  reference branches;
* ``logspace_psum``, ``sharded_exact_log_z``, ``sharded_top_k`` and
  ``sharded_mimps_log_z`` on seeded numpy inputs, and ``gather_rows``'
  bit-pattern sum beside a value sum on rows holding -0.0, NaN and Inf;

and the scheduler on a staggered trace beside the same run on one device
(and solo ``generate`` a request); then at (2, 2) only, each beside the
same run on one device: a NaN lane under the guard, a ladder walk,
speculation with the prefix pool, the server's look-ahead admission, and
the observability harvest.
"""
import dataclasses
import datetime
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ServingConfig, reduced_config  # noqa: E402
from repro_torch.configs.base import ObsConfig  # noqa: E402
from repro_torch.core.backends import (BACKENDS, get_backend,  # noqa: E402
                                       local_shard, state_partition_specs)
from repro_torch.core.distributed import (logspace_psum,  # noqa: E402
                                          sharded_exact_log_z,
                                          sharded_mimps_log_z,
                                          sharded_top_k)
from repro_torch.launch.mesh import (axis_group, axis_rank,  # noqa: E402
                                     axis_size, make_serving_mesh)
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.serve import (Engine, NanLogitsFault, Request,  # noqa: E402
                               Scheduler, Server, generate, trace_arrivals)
from repro_torch.serve.output_layer import gather_rows  # noqa: E402

SHAPES = ((1, 4), (2, 2), (4, 1))
MAX_LEN = 24
VOCAB = 1024
METHODS = ("exact", "selfnorm", "mimps", "mince", "topk", "fmbe", "lsh")
FIELDS = ("log_z", "top_score", "top_id", "head_lse", "tail_lse", "k_eff",
          "head_live")
# the distributed functions' inputs: N rows of width D, Q queries
DN, DD, DQ, DK, DL = 64, 16, 3, 5, 6
DEV = "cpu"                 # where the engines serve ("cuda": the card)


def cfg():
    c = reduced_config("qwen1.5-4b")
    return dataclasses.replace(
        c, vocab=VOCAB, dtype="float32", partition=dataclasses.replace(
            c.partition, method="mimps", block_rows=64, n_probe=4, l=64))


def dist_inputs(seed: int = 7):
    """The distributed functions' numpy inputs (the pytest process makes
    the same ones)."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((DN, DD)) * 0.5).astype(np.float32)
    q = rng.standard_normal((DQ, DD)).astype(np.float32)
    lse = rng.standard_normal((4, DQ)).astype(np.float32) * 3
    lse[1, 0] = -np.inf                         # one shard with no mass
    lse[:, 2] = -np.inf                         # a query with none at all
    return v, q, lse


def tail_pos(m: int, r: int):
    """Rank r's tail offsets for sharded_mimps_log_z at model degree m."""
    n_local = DN // m
    rng = np.random.default_rng(100 * m + r)
    return rng.integers(0, n_local - DK, DL)


def outs(out):
    return {f: (None if getattr(out, f) is None
                else getattr(out, f).clone()) for f in FIELDS}


def decode_checks(model, params, mesh, solo, res):
    """Every method's shard_decode beside the mesh-free engine's decode."""
    m = axis_size(mesh, "model")
    mr = axis_rank(mesh, "model")
    group = axis_group(mesh, "model")
    eng = Engine(model, params, MAX_LEN, seed=1, device=DEV, mesh=mesh)
    pc = eng.cfg.partition
    d = eng.cfg.d_model
    gen = torch.Generator().manual_seed(5)
    h = (torch.randn((6, d), generator=gen) * 2.0).to(DEV)
    active = torch.tensor([True, True, False, True, True, True], device=DEV)
    for method in METHODS:
        backend = get_backend(method)
        full, one = eng.tier_state(method), solo.tier_state(method)
        tail = (backend.draw_tail(one, pc, torch.Generator(
            device=DEV).manual_seed(9))
                if backend.has_tail(one) else None)
        for use_kernel in (True, False):
            # lsh keeps its plain path under the mesh (serve.output_layer)
            ref = backend.decode(one, h, pc, k=pc.sample_k,
                                 use_kernel=use_kernel and method != "lsh",
                                 tail_idx=tail, active=active)
            got = backend.shard_decode(local_shard(full, m, mr), h, pc,
                                       group=group, k=pc.sample_k,
                                       use_kernel=use_kernel, tail_idx=tail,
                                       active=active)
            res[("decode", mesh_name(mesh), method, use_kernel)] = (
                outs(got), outs(ref))
    res[("specs", mesh_name(mesh))] = (
        state_partition_specs(eng.tier_state("fmbe"), m),
        tuple(eng.state.index.v_blocks.shape), tuple(eng.state.w.shape))


def function_checks(mesh, res):
    m = axis_size(mesh, "model")
    r = axis_rank(mesh, "model")
    group = axis_group(mesh, "model")
    v, q, lse = dist_inputs()
    n_local = DN // m
    v_loc = torch.from_numpy(v[r * n_local:(r + 1) * n_local]).to(DEV)
    qt = torch.from_numpy(q).to(DEV)
    name = mesh_name(mesh)
    # logspace_psum over 4 shards' partials, each rank summing its share
    parts = torch.from_numpy(lse)[r * 4 // m:(r + 1) * 4 // m].to(DEV)
    local = torch.logsumexp(parts, 0)
    res[("psum", name)] = logspace_psum(local, group)
    res[("exact_log_z", name)] = sharded_exact_log_z(v_loc, qt, group)
    tk = sharded_top_k(v_loc, qt, DK, group)
    res[("top_k", name)] = (tk.scores, tk.ids)
    lz, tk = sharded_mimps_log_z(v_loc, qt[0], DK, DL, group,
                                 tail_pos=tail_pos(m, r))
    res[("mimps_log_z", name)] = (lz, tk.scores, tk.ids)
    # bit-pattern gather against a value sum: rows owned by rank 1 hold
    # -0.0, NaN and Inf
    n_loc = 4 // m if m > 1 else 4
    table = torch.zeros((n_loc * m, 3), device=DEV)
    table[2:4] = torch.tensor([[-0.0, float("nan"), float("inf")],
                               [-0.0, -float("inf"), 1.5]])
    local_t = table[r * n_loc:(r + 1) * n_loc].clone()
    slots = torch.tensor([2, 3, 0], device=DEV)
    bits = gather_rows(local_t, slots, group)
    loc = slots - r * n_loc
    own = ((loc >= 0) & (loc < n_loc))[:, None]
    vals = torch.where(own, local_t[torch.clamp(loc, 0, n_loc - 1)],
                       torch.zeros((), device=DEV))
    dist.all_reduce(vals, group=group)
    res[("rows", name)] = (bits, vals, table[slots])


def mesh_name(mesh) -> str:
    return f"{axis_size(mesh, 'data')}x{axis_size(mesh, 'model')}"


def trace_requests(base: int, n: int = 6):
    rng = np.random.default_rng(300 + base)
    return [Request(prompt=rng.integers(0, VOCAB, 2 + (3 * i) % 5),
                    max_new_tokens=3 + i % 3, seed=60 + base + i,
                    temperature=(0.0, 0.8)[i % 2]) for i in range(n)]


def completions(rep, reqs):
    got = {c.request.req_id: c for c in rep.completions}
    return [(got[r.req_id].tokens, got[r.req_id].log_zs,
             got[r.req_id].reason) for r in reqs]


def serve_run(engine, n_slots, reqs, at, cfg_kw=None, **sched_kw):
    sched = Scheduler(engine, n_slots, seed=3, eager=True, **sched_kw)
    server = Server(sched, ServingConfig(**(cfg_kw or {})))
    rep = server.run(arrivals=trace_arrivals(reqs, at))
    return rep, sched


def scheduler_checks(model, params, mesh, solo, res, full):
    """The mesh runs beside the same runs on one device (``full``: all of
    them, else the trace alone)."""
    eng = Engine(model, params, MAX_LEN, seed=1, device=DEV,
                 health_guard=True, mesh=mesh)

    def both(key, fn):
        out = {}
        for where, e in (("mesh", eng), ("solo", solo)):
            out[where] = fn(e)
        res[key] = out
    name = mesh_name(mesh)

    # a staggered trace; solo generate a request
    def trace(e):
        reqs = trace_requests(0)
        rep, sched = serve_run(e, 4, reqs, [0, 0, 1, 3, 4, 6])
        return completions(rep, reqs), [
            r.req_id for r in reqs], sched.harvest_metrics()
    both(("trace", name), trace)
    gens = []
    for r in trace_requests(0):
        g = torch.Generator(device=DEV).manual_seed(int(r.seed))
        toks = generate(solo, torch.from_numpy(r.prompt[None]).to(DEV),
                        r.max_new_tokens, temperature=r.temperature,
                        generator=g, host_loop=DEV != "cpu")
        gens.append(toks[0].tolist())
    res["generate"] = gens
    if DEV != "cpu" or not full:
        return

    # a NaN lane under the guard, beside the fault-free mesh run
    def nan_lane(e):
        reqs = trace_requests(10)
        sched = Scheduler(e, 4, seed=3, eager=True,
                          injector=NanLogitsFault([reqs[1].req_id], [3, 4]))
        rep = Server(sched, ServingConfig()).run(
            arrivals=trace_arrivals(reqs, [0, 0, 0, 0, 2, 2]))
        return completions(rep, reqs), rep.health
    both("nan", nan_lane)

    def clean(e):
        reqs = trace_requests(10)
        rep, _ = serve_run(e, 4, reqs, [0, 0, 0, 0, 2, 2])
        return completions(rep, reqs)
    res["nan_clean"] = clean(eng)

    # a ladder walk under overload
    def ladder(e):
        reqs = trace_requests(20, 10)
        rep, sched = serve_run(
            e, 4, reqs, [0] * 10,
            dict(degrade_ladder=("mimps", "topk"), degrade_high=3,
                 degrade_low=1, degrade_after=1, restore_after=2))
        return (completions(rep, reqs), rep.tier_transitions,
                dict(sched.captures_by_tier))
    both("ladder", ladder)

    # speculation with the prefix pool
    prefix = [11, 12, 13, 14, 15, 16]

    def spec(e, **kw):
        reqs = [Request(prompt=prefix + [20 + i] * (1 + i % 3),
                        max_new_tokens=3 + i % 2, seed=80 + i,
                        temperature=(0.0, 0.7)[i % 2]) for i in range(8)]
        rep, sched = serve_run(e, 4, reqs, [0, 0, 1, 1, 5, 5, 6, 6], **kw)
        return completions(rep, reqs), sched.prefix and sched.prefix.stats()
    both("spec", lambda e: spec(e, spec_draft="topk", spec_k=3,
                                prefix_cache_blocks=8,
                                prefix_block_tokens=2))
    res["spec_plain"] = spec(eng)

    # look-ahead admission: A's prefix chain lands on replica 0; three long
    # requests then fill replica 0 and half of replica 1, and C (A's
    # prefix) waits for its owner while D takes replica 1's last lane
    def window(e):
        rng = np.random.default_rng(7)
        other = [rng.integers(40, VOCAB, 4) for _ in range(4)]
        reqs = ([Request(prompt=prefix + [30], max_new_tokens=1, seed=90)]
                + [Request(prompt=p, max_new_tokens=6, seed=91 + i)
                   for i, p in enumerate(other[:3])]
                + [Request(prompt=prefix + [31], max_new_tokens=2, seed=95),
                   Request(prompt=other[3], max_new_tokens=2, seed=96)])
        rep, sched = serve_run(
            e, 4, reqs, [0, 12, 12, 12, 13, 13],
            dict(admit_window=2, admit_hold=8),
            prefix_cache_blocks=16, prefix_block_tokens=2)
        return completions(rep, reqs), rep.admit_skipped, \
            sched.prefix.stats()
    both("window", window)

    # the observability harvest with the shadow oracle on
    def observed(e):
        reqs = trace_requests(40)
        sched = Scheduler(e, 4, seed=3, eager=True)
        obs = Observability(ObsConfig(shadow_every=2, harvest_every=4))
        rep = Server(sched, ServingConfig(), obs=obs).run(
            arrivals=trace_arrivals(reqs, [0, 0, 1, 2, 2, 3]))
        e.obs = None
        return completions(rep, reqs), sched.harvest_metrics()
    both("obs", observed)


def main(rank: int, world: int, store: str, out: str,
         device: str = "cpu") -> None:
    global DEV
    DEV = device
    torch.set_num_threads(1)
    t0 = time.time()
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    res = {}
    c = cfg()
    model = Model(c)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), DEV)
    solo = Engine(model, params, MAX_LEN, seed=1, device=DEV,
                  health_guard=True)
    assert set(METHODS) == set(BACKENDS)
    for d, m in SHAPES:
        mesh = make_serving_mesh(d, m, device_type=DEV)
        function_checks(mesh, res)
        decode_checks(model, params, mesh, solo, res)
        scheduler_checks(model, params, mesh, solo, res, (d, m) == (2, 2))
    res["seconds"] = time.time() - t0
    dist.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
