"""The dry-run bodies' kernel routes on the card: ``sharded_decode`` mimps,
mince and fmbe with ``use_kernel`` (``ivf_score``, ``fmbe_z``) against the
same bodies on their plain versions, over four gloo ranks sharing the
card (``tests/_torch_sharded_rank.py ... cuda``, mesh (1, 4)), at f32 and
bf16; and ``streaming_logz_argmax``'s ``topk_z`` route against its plain
chunks. Log Z within 1e-3, top ids equal unless their scores are within
1e-3, the exhaustive probe within 1e-3 of the exact log Z, every rank the
same outputs.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_cuda_sharded_decode.py
"""
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
WORLD = 4
NB, BR, D, B = 32, 64, 32, 8
TOL = 1e-3


def _inputs(out):
    from repro_torch.core.feature_maps import build_fmbe, make_feature_map
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((NB * BR, D)) * 0.25).astype(np.float32)
    vb = v.reshape(NB, BR, D)
    cent = vb.mean(1)
    radius = np.linalg.norm(vb - cent[:, None], axis=-1).max(1)
    h = v[:B] + 0.01 * rng.standard_normal((B, D)).astype(np.float32)
    fm = make_feature_map(torch.Generator().manual_seed(2), D, 2048,
                          max_degree=6, device="cpu")
    st = build_fmbe(fm, torch.from_numpy(v))
    slots = rng.integers(0, NB // WORLD * BR, (WORLD, 16))
    np.savez(out / "inputs.npz", v_blocks=vb, centroids=cent,
             radius=radius.astype(np.float32),
             valid=np.ones((NB, BR), bool), h=h,
             omega=fm.omega.numpy(), degree=fm.degree.numpy(),
             coef=fm.coef.numpy(), p=np.asarray(fm.p),
             lambda_tilde=st.lambda_tilde.numpy(), slots_16=slots)
    return h, v


def _ranks(out, dtype):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", SHARDED_DTYPE=dtype)
    procs = []
    for r in range(WORLD):
        log = open(out / f"log{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_sharded_rank.py"),
             str(r), str(WORLD), str(out / "store"), str(out), "cuda"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    t_end = time.time() + 240
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, t_end - time.time()))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = "".join((out / f"log{r}.txt").read_text() for r in range(WORLD))
    assert all(p.returncode == 0 for p, _ in procs), logs[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def run(request, tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = tmp_path_factory.mktemp(f"sharded_{request.param}")
    h, v = _inputs(out)
    return _ranks(out, request.param), h, v


CASES = ("mimps", "mince", "fmbe", "mimps_all", "mince_all")


@pytest.mark.parametrize("name", CASES)
def test_kernel_route_equals_plain(run, name):
    got = run[0]
    k, p = got[0][(name, True)], got[0][(name, False)]
    assert (k[0] - p[0]).abs().max().item() <= TOL
    differ = k[1] != p[1]
    assert bool(((k[2] - p[2]).abs()[differ] <= TOL).all())


def test_exhaustive_probe_is_exact(run):
    got, h, v = run
    exact = torch.logsumexp(torch.from_numpy(h) @ torch.from_numpy(v).T, -1)
    for name in ("mimps_all", "mince_all"):
        assert (got[0][(name, True)][0] - exact).abs().max() <= TOL


def test_ranks_agree_and_launch(run):
    got = run[0]
    for r in range(1, WORLD):
        for key, vals in got[0].items():
            if key == "launches":
                continue
            assert all(torch.equal(a, b) for a, b in zip(vals, got[r][key]))
    # a probe a case: mimps, mince, fmbe and the two exhaustive ones
    assert got[0]["launches"] == {"ivf_score": 5, "fmbe_z": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_logz_argmax_topk_z_route(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.topk_z import topk_z
    from repro_torch.serve.output_layer import streaming_logz_argmax
    g = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(16, 256, device="cuda", generator=g).to(dtype)
    w = (torch.randn(151936, 256, device="cuda", generator=g) * 0.1).to(dtype)
    n0 = topk_z.launches
    k = streaming_logz_argmax(h, w)
    assert topk_z.launches == n0 + 1
    p = streaming_logz_argmax(h, w, use_kernel=False)
    assert (k[0] - p[0]).abs().max().item() <= TOL
    differ = k[1] != p[1]
    assert bool(((k[2] - p[2]).abs()[differ] <= TOL).all())
