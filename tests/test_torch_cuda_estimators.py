"""The estimator core, ``PartitionLayer`` and the paper tables on the card,
at a small width (V 4096, d 128, 8 queries).

``PartitionLayer`` with the kernels (``topk_z`` for the exact log Z and the
top candidates without an index, ``ivf_score`` for the mimps head and the
top candidates with one, ``fmbe_z`` on the sketch ``fmbe_phi`` built) must
equal ``use_kernel=False`` on the same draws: log Ẑ to 1e-3, top ids equal
wherever the neighbouring scores are more than 1e-3 apart, at bf16 and
f32; each kernel launches where it should. ``mince_stats`` and the table
functions give equal bits over two calls (fixed-order sums, no atomics).

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_estimators.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.base import PartitionConfig
from repro_torch.core import estimators as est
from repro_torch.core import mince
from repro_torch.core.feature_maps import make_feature_map
from repro_torch.core.partition_layer import PartitionLayer
from repro_torch.kernels import _build
from repro_torch.kernels.fmbe import fmbe_phi, fmbe_z
from repro_torch.kernels.ivf_score import ivf_score
from repro_torch.kernels.topk_z import topk_z
from repro_torch.studies import common, paper_tables as pt

pytestmark = pytest.mark.cuda
V, D, Q = 4096, 128, 8
TOL = 1e-3
PART = PartitionConfig(k=64, l=256, n_probe=4, block_rows=128, n_clusters=8,
                       fmbe_features=256, mince_iters=25)
METHODS = ["exact", "mimps", "nmimps", "uniform", "mince", "fmbe",
           "selfnorm"]
KERNELS = {"exact": (topk_z,), "mimps": (ivf_score,), "fmbe": (fmbe_z,)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(dev, dtype):
    """Rows and queries of norm at most about 1, where the FMBE sketch's
    signed sum is well above its cancellation, so its log compares too."""
    g = torch.Generator(device=dev).manual_seed(0)
    w = common.make_embeddings(g, V, D, score_scale=0.05, device=dev)
    h, _ = common.make_queries(g, w, Q, 0.1)
    return w.to(dtype).contiguous(), h.to(dtype).contiguous()


def _layer(dev, method, w):
    cfg = dataclasses.replace(PART, method=method)
    return PartitionLayer.build(cfg, w,
                                torch.Generator(device=dev).manual_seed(1),
                                device=dev)


def _draws(dev, method, layer):
    if method not in ("mimps", "uniform", "mince"):
        return None
    high = V - PART.k if method == "mince" else V
    g = torch.Generator(device=dev).manual_seed(2)
    return torch.randint(0, high, (Q, PART.l), generator=g, device=dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("method", METHODS)
def test_layer_log_z_kernels_equal_plain(dev, method, dtype):
    w, h = _data(dev, dtype)
    _build.reset_counts(_build.COUNTED)
    layer = _layer(dev, method, w)
    if method == "fmbe":
        assert fmbe_phi.launches > 0, "the fmbe build ran no fmbe_phi"
    draws = _draws(dev, method, layer)
    _build.reset_counts(_build.COUNTED)
    got = layer.log_z(w, h, draws=draws)
    for fn in KERNELS.get(method, ()):
        assert fn.launches > 0, f"{method}: no {fn.__name__} launch"
    launched = {fn: fn.launches for fn in _build.COUNTED}
    want = layer.log_z(w, h, draws=draws, use_kernel=False)
    assert {fn: fn.launches for fn in _build.COUNTED} == launched
    assert got.shape == (Q,) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    again = layer.log_z(w, h, draws=draws)
    assert torch.equal(got, again)


def _ids_where_separated(vals, ids, pv, pi):
    vals, ids, pv, pi = (t.cpu() for t in (vals, ids, pv, pi))
    assert (vals - pv).abs().max().item() <= TOL
    k = vals.shape[1]
    for q in range(vals.shape[0]):
        for j in range(k):
            up = pv[q, j - 1] - pv[q, j] if j else float("inf")
            down = pv[q, j] - pv[q, j + 1] if j + 1 < k else float("inf")
            if up > TOL and down > TOL:
                assert ids[q, j] == pi[q, j], (q, j)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("method,k", [("mimps", 8), ("exact", 8),
                                      ("exact", 32), ("exact", 40)])
def test_layer_top_candidates_kernels_equal_plain(dev, method, k, dtype):
    """k 40 is past topk_z's 32: the plain product, no kernel."""
    w, h = _data(dev, dtype)
    layer = _layer(dev, method, w)
    _build.reset_counts(_build.COUNTED)
    vals, ids = layer.top_candidates(w, h, k)
    kernel = ivf_score if method == "mimps" else topk_z
    assert kernel.launches == (0 if k > 32 else 1)
    pv, pi = layer.top_candidates(w, h, k, use_kernel=False)
    _ids_where_separated(vals, ids, pv, pi)
    top_id, p = layer.normalized_top_prob(
        w, h, draws=_draws(dev, "mimps", layer) if method == "mimps"
        else None)
    assert torch.equal(top_id, ids[:, 0]) and torch.isfinite(p).all()


def test_mince_stats_bit_equal_over_two_calls(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    scores = torch.randn((64, 4096), generator=g, device=dev) * 4.0
    mult = torch.rand((64, 4096), generator=g, device=dev) * 30.0
    anchor = torch.logsumexp(scores, -1)
    atoms = mince.anchored_atoms(scores, mult, 100000, 64.0, 4032.0, anchor)
    a = mince.mince_stats(*atoms, anchor)
    b = mince.mince_stats(*atoms, anchor)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    theta = mince.solve_from_stats(a, anchor - 5.0)
    assert torch.isfinite(theta).all()


def test_tables_bit_equal_over_two_calls(dev):
    n, d, nq = 4096, 64, 16
    g = torch.Generator(device=dev).manual_seed(4)
    v = common.make_embeddings(g, n, d, device=dev)
    q, idx = common.make_queries(g, v, nq)
    noise = torch.randn((nq, d), generator=g, device=dev)
    fm = make_feature_map(g, d, 512, device=dev)
    draws = {}
    runs = []
    for _ in range(2):
        runs.append((
            pt.table1(v, q, (256, 16), (256, 32), generator=g, draws=draws),
            pt.table2(v, idx, noise, fm, k=256, l=256, generator=g,
                      draws=draws),
            pt.table3(v, q, k=256, l=256, generator=g, draws=draws),
            pt.fig1(v)))
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert a.keys() == b.keys()
        for key in a:
            assert (a[key] == b[key]).all(), key
    assert runs[0][3] == runs[1][3]
    lz = est.estimate_log_z("exact", v, q)
    assert torch.equal(lz, est.estimate_log_z("exact", v, q))
