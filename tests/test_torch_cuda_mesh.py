"""The serving mesh on the card, at a small width (qwen1.5-4b reduced to 2
layers, vocab 2048, mimps with the fixed-capacity index and the guard).

* A one-rank NCCL group, mesh (1, 1): the mesh scheduler's step, captured
  in one CUDA graph with its collectives in it, gives the eager mesh step's
  tokens and log Z bit for bit and the one-device captured scheduler's;
  one capture; an eager step issues its collectives at size 1 too (a
  one-rank communicator may launch no kernel for them).
* Four ranks on the one card over gloo (``tests/_torch_mesh_rank.py
  ... cuda``, eager): every method's ``shard_decode`` against the
  one-device decode of the same engine's state through the kernels (the
  probe methods bit for bit; ``exact``/``selfnorm`` ids and scores bit for
  bit and log Z within 1e-5; ``lsh`` on its plain path), the distributed
  functions against float64, and a staggered trace at (2, 2) served the
  same on every rank.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_mesh.py
"""
import dataclasses
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]
MAX_LEN = 24


def _cfg():
    from repro_torch.configs import reduced_config
    cfg = reduced_config("qwen1.5-4b")
    return dataclasses.replace(
        cfg, vocab=2048, dtype="bfloat16", partition=dataclasses.replace(
            cfg.partition, method="mimps", block_rows=64, n_probe=4, l=64))


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_serving_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _requests():
    from repro_torch.serve import Request
    rng = np.random.default_rng(5)
    return [Request(prompt=rng.integers(0, 2048, 3 + 2 * i),
                    max_new_tokens=4 + i % 3, seed=30 + i,
                    temperature=(0.0, 0.8)[i % 2]) for i in range(6)]


def _serve(sched):
    from repro_torch.serve import Server, trace_arrivals
    reqs = _requests()
    rep = Server(sched).run(arrivals=trace_arrivals(reqs,
                                                    [0, 0, 1, 2, 4, 5]))
    got = {c.request.req_id: c for c in rep.completions}
    return [(got[r.req_id].tokens, got[r.req_id].log_zs) for r in reqs]


def test_captured_nccl_mesh_step_equals_eager_and_one_device(nccl_mesh):
    import torch.distributed as dist

    from repro_torch.models import Model
    from repro_torch.serve import Engine, Scheduler
    dev = torch.device("cuda")
    model = Model(_cfg())
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    mesh_eng = Engine(model, params, MAX_LEN, seed=1, device_index=True,
                      health_guard=True, mesh=nccl_mesh)
    solo_eng = Engine(model, params, MAX_LEN, seed=1, device_index=True,
                      health_guard=True, index_assign=mesh_eng.index.assign)
    captured = Scheduler(mesh_eng, 4, seed=3)
    got = _serve(captured)
    assert captured.captures == 1
    eager = Scheduler(mesh_eng, 4, seed=3, eager=True)
    assert got == _serve(eager)
    assert got == _serve(Scheduler(solo_eng, 4, seed=3))
    # every step: the row gather (1), the guard's log-domain combine and
    # candidate merge (3), the shadow's combine (2), the latency MAX and
    # the outputs' combine (2)
    calls, real = [], dist.all_reduce
    dist.all_reduce = lambda t, *a, **kw: calls.append(t.numel()) or \
        real(t, *a, **kw)
    try:
        eager.step()
    finally:
        dist.all_reduce = real
    assert len(calls) == 8, calls


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for r in range(4):
        log = open(out / f"log{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_mesh_rank.py"),
             str(r), "4", str(out / "store"), str(out), "cuda"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    t_end = time.time() + 600
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, t_end - time.time()))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = "".join((out / f"log{r}.txt").read_text() for r in range(4))
    assert all(p.returncode == 0 for p, _ in procs), logs[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


METHODS = ("exact", "selfnorm", "mimps", "mince", "topk", "fmbe", "lsh")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_gloo_shard_decode_on_the_card(gloo_ranks, mesh, method):
    for res in gloo_ranks:
        got, ref = res[("decode", mesh, method, True)]
        for f, a in got.items():
            b = ref[f]
            if a is None or b is None:
                assert a is None and b is None, f
            elif method in ("exact", "selfnorm") and f in ("log_z",
                                                            "head_lse"):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
            else:
                assert torch.equal(a, b), (f, a, b)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_gloo_functions_and_rows_on_the_card(gloo_ranks, mesh):
    import _torch_mesh_rank as R
    v, q, lse = (x.astype(np.float64) for x in R.dist_inputs())
    s = q @ v.T
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[:, 0]
    for res in gloo_ranks:
        np.testing.assert_allclose(res[("exact_log_z", mesh)].cpu().numpy(),
                                   want, rtol=0, atol=1e-5)
        ids = res[("top_k", mesh)][1].cpu().numpy()
        np.testing.assert_array_equal(ids, np.argsort(-s, -1,
                                                      kind="stable")[:, :5])
        bits, _, rows = res[("rows", mesh)]
        assert torch.equal(bits.view(torch.int32), rows.view(torch.int32))


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_gloo_trace_is_served_alike_on_every_rank(gloo_ranks, mesh):
    rows = gloo_ranks[0][("trace", mesh)]["mesh"][0]
    assert all(reason is None for _, _, reason in rows)
    for res in gloo_ranks[1:]:
        assert res[("trace", mesh)]["mesh"][0] == rows
