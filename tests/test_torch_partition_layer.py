"""The port's ``PartitionLayer`` and paper tables against the JAX package
on the same numpy inputs and draws (f32, CPU).

``PartitionLayer``: the mimps index from the JAX k-means assignment, the
fmbe sketch from the JAX feature map, each query's uniform draws from the
key JAX's ``log_z`` splits for it; log Ẑ to 1e-5 (1 + |log Z|), top ids
equal where the neighbouring scores are more than 1e-5 apart.

The tables: a 2 x 2 grid, 8 queries, the JAX package's own synthetic data
(``benchmarks/common.py``, rebuilt in the port from its draws) through
``studies.paper_tables`` against the same computation through
``repro.core`` on the same draws. Each query's mu agrees to what a log Ẑ
error of 1e-4 (1 + |log Z|) can move it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from benchmarks.fig1_cdf import neighbors_for_mass as j_neighbors
from repro.configs.base import PartitionConfig as JPartitionConfig
from repro.core import estimators as je
from repro.core import feature_maps as jfm
from repro.core.partition_layer import PartitionLayer as JLayer
from repro_torch.configs.base import PartitionConfig
from repro_torch.core.partition_layer import PartitionLayer
from repro_torch.interop import feature_map_from_numpy
from repro_torch.studies import common as tcommon
from repro_torch.studies import paper_tables as pt

N, D, Q = 2048, 32, 8
PART = dict(k=16, l=64, n_probe=4, block_rows=64, n_clusters=8,
            fmbe_features=64, mince_iters=25)
METHODS = ["exact", "mimps", "nmimps", "uniform", "mince", "fmbe",
           "selfnorm"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _logz(got, want, rel=1e-5):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.abs(got - want) <= rel * (1 + np.abs(want))), \
        (got, want)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, D))
    v = centers[rng.integers(0, 16, N)] + 0.6 * rng.standard_normal((N, D))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v *= (0.35 + 1.8 * np.sqrt(np.arange(N) / N))[:, None] * np.sqrt(D) * 0.35
    h = v[rng.choice(N, Q, replace=False)] + 0.1 * rng.standard_normal((Q, D))
    return v.astype(np.float32), h.astype(np.float32)


def _layers(method, v):
    """The JAX layer (built from its key) and the port's, given the JAX
    layer's k-means assignment or feature map."""
    key = jax.random.PRNGKey(5)
    jl = JLayer.build(JPartitionConfig(method=method, **PART),
                      jnp.asarray(v), key)
    inject = {}
    if jl.index is not None:
        inject["assign"] = _t(jl.index.assign)
    if jl.fmbe_state is not None:
        fm = jl.fmbe_state.fm
        inject["feature_map"] = feature_map_from_numpy(
            np.asarray(fm.omega), np.asarray(fm.degree), np.asarray(fm.coef),
            fm.p, device="cpu")
    tl = PartitionLayer.build(PartitionConfig(method=method, **PART), _t(v),
                              device="cpu", **inject)
    return jl, tl, key


def _draws(method, key, n):
    """The uniform draws ``JLayer.log_z`` makes for each query's key."""
    high = {"mimps": n, "uniform": n, "mince": n - PART["k"]}.get(method)
    if high is None:
        return None
    keys = jax.random.split(key, Q)
    return _t(np.stack([np.asarray(jax.random.randint(k, (PART["l"],), 0,
                                                      high)) for k in keys]))


@pytest.mark.parametrize("method", METHODS)
def test_build_state(data, method):
    v, _ = data
    jl, tl, _ = _layers(method, v)
    assert (tl.index is None) == (jl.index is None) == (method != "mimps")
    assert (tl.fmbe_state is None) == (jl.fmbe_state is None) == \
        (method != "fmbe")
    if method == "mimps":
        for name in ("v_blocks", "valid", "row_id", "slot_of_row"):
            np.testing.assert_array_equal(_np(getattr(tl.index, name)),
                                          np.asarray(getattr(jl.index, name)))
    if method == "fmbe":                  # the global sketch, no blocks
        assert tl.fmbe_state.lambda_blocks is None
        got = _np(tl.fmbe_state.lambda_tilde)
        want = np.asarray(jl.fmbe_state.lambda_tilde)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("method", ["mimps", "mince", "topk", "fmbe", "lsh"])
def test_backend_build_with_index_false(data, method):
    """``with_index=False`` builds no IVF or LSH index (fmbe: the global
    sketch, whose sum equals the per-block build's), as in JAX."""
    from repro_torch.core import backends as tb
    v, _ = data
    cfg = PartitionConfig(method=method, lsh_bits=4, **PART)
    g = torch.Generator().manual_seed(0)
    bare = tb.get_backend(method).build(cfg, _t(v), generator=g,
                                        device="cpu", with_index=False)
    assert bare.index is None and bare.lsh is None
    full = tb.get_backend(method).build(
        cfg, _t(v), generator=torch.Generator().manual_seed(0), device="cpu")
    assert (full.index is not None) or (full.lsh is not None)
    if method == "fmbe":
        assert bare.fmbe.lambda_blocks is None
        torch.testing.assert_close(bare.fmbe.lambda_tilde,
                                   full.fmbe.lambda_tilde, rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_log_z(data, method, use_kernel):
    v, h = data
    jl, tl, key = _layers(method, v)
    got = tl.log_z(_t(v), _t(h), draws=_draws(method, key, N),
                   use_kernel=use_kernel)
    want = jl.log_z(jnp.asarray(v), jnp.asarray(h), key)
    if method == "fmbe":                     # the clip hides cancellation
        big = np.asarray(want) > np.log(1e-3)
        assert big.any()
        _logz(_np(got)[big], np.asarray(want)[big], 1e-4)
        return
    _logz(got, want)


def _ids_where_separated(got_v, got_i, want_v, want_i, gap=1e-5):
    got_v, got_i = _np(got_v), _np(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, atol=1e-5)
    k = want_v.shape[1]
    checked = 0
    for q in range(want_v.shape[0]):
        for j in range(k):
            up = want_v[q, j - 1] - want_v[q, j] if j else np.inf
            down = want_v[q, j] - want_v[q, j + 1] if j + 1 < k else np.inf
            if up > gap and down > gap:
                assert got_i[q, j] == want_i[q, j], (q, j)
                checked += 1
    assert checked >= want_v.size // 2


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("method,k", [("mimps", 8), ("exact", 8),
                                      ("exact", 40), ("mince", 8)])
def test_top_candidates(data, method, k, use_kernel):
    """With an index (mimps) and without (the oracle methods); k 40 is
    past ``topk_z``'s 32."""
    v, h = data
    jl, tl, key = _layers(method, v)
    vals, ids = tl.top_candidates(_t(v), _t(h), k, use_kernel=use_kernel)
    jv, ji = jl.top_candidates(jnp.asarray(v), jnp.asarray(h), k, key)
    assert vals.shape == ids.shape == (Q, k) and ids.dtype == torch.int32
    _ids_where_separated(vals, ids, jv, ji)


@pytest.mark.parametrize("method", ["mimps", "exact", "uniform"])
def test_normalized_top_prob(data, method):
    v, h = data
    jl, tl, key = _layers(method, v)
    ids, p = tl.normalized_top_prob(_t(v), _t(h),
                                    draws=_draws(method, key, N))
    jids, jp = jl.normalized_top_prob(jnp.asarray(v), jnp.asarray(h), key)
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    np.testing.assert_allclose(_np(p), np.asarray(jp), rtol=1e-4)


def test_generator_draws(data):
    v, h = data
    _, tl, _ = _layers("mimps", v)
    a = tl.log_z(_t(v), _t(h), torch.Generator().manual_seed(3))
    b = tl.log_z(_t(v), _t(h), torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# the studies: data, Fig. 1 and a reduced Table 1/2/3
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def study():
    """The JAX package's embeddings and queries, and the port's rebuilt
    from the same draws."""
    key = jax.random.PRNGKey(0)
    kv, kq, ke, kf = jax.random.split(key, 4)
    jv = jcommon.make_embeddings(kv, N, D)
    k1, k2, k3 = jax.random.split(kv, 3)
    tv = tcommon.make_embeddings(
        None, N, D, centers=jax.random.normal(k1, (64, D)),
        assign=jax.random.randint(k2, (N,), 0, 64),
        noise=jax.random.normal(k3, (N, D)), device="cpu")
    return jv, tv, kq, ke, kf


def test_make_embeddings_and_queries(study):
    jv, tv, kq, _, _ = study
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    idx = jax.random.choice(jax.random.split(kq)[0], N, (Q,), replace=False)
    noise = jax.random.normal(jax.random.split(kq)[1], (Q, D))
    for rel in (0.0, 0.2):
        jq, jidx = jcommon.make_queries(kq, jv, Q, noise_rel=rel)
        tq, tidx = tcommon.make_queries(None, tv, Q, rel, idx=idx,
                                        noise=noise)
        np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
        np.testing.assert_allclose(_np(tq), np.asarray(jq), rtol=1e-6,
                                   atol=1e-6)
    a, b = np.array([0.5, -1.0]), np.array([0.4, -1.0])
    np.testing.assert_array_equal(
        tcommon.pct_abs_rel_error(_t(a), b), jcommon.pct_abs_rel_error(a, b))


def test_fig1_neighbors_for_mass(study):
    jv, tv, _, _, _ = study
    ranks = [0, 5, 50, N // 2, N - 100, N - 1]
    rows = pt.fig1(tv, ranks[:3], ranks[3:])
    want = [j_neighbors(jv, jv[r]) for r in ranks]
    assert [r["k80"] for r in rows] == want
    assert tcommon.neighbors_for_mass(tv, tv[7]) == j_neighbors(jv, jv[7])


def _pct_close(got, want, lz_true, rel=1e-4):
    """mu = 100 |1 - e^delta| moves by at most (mu + 100) |d delta|."""
    got, want = np.asarray(got), np.asarray(want)
    tol = (want + 100.0) * rel * (1 + np.abs(np.asarray(lz_true)))
    assert np.all(np.abs(got - want) <= tol + 1e-9), (got, want)


def _jax_cells(keys, q, cells, fn):
    return {c: jax.vmap(lambda qq, kk: fn(c, qq, kk))(q, keys)
            for c in cells}


def _randint(keys, l, high):
    return np.stack([np.asarray(jax.random.randint(k, (l,), 0, high))
                     for k in keys])


def test_reduced_table1(study):
    jv, tv, kq, ke, _ = study
    ks, ls = (128, 16), (256, 64)
    jq, _ = jcommon.make_queries(kq, jv, Q)
    keys = jax.random.split(ke, Q)
    draws = {("uniform", l): _randint(keys, l, N) for l in ls}
    draws.update({("complement", k, l): _randint(keys, l, N - k)
                  for k in ks for l in ls})
    got = pt.table1(tv, _t(jq), ks, ls, draws=draws)
    true = jax.vmap(lambda qq: je.exact_log_z(jv, qq))(jq)
    want = {}
    for l in ls:
        want[("Uniform", 0, l)] = jax.vmap(
            lambda qq, kk: je.uniform_log_z(jv, qq, l, kk))(jq, keys)
        for k in ks:
            want[("MIMPS", k, l)] = jax.vmap(
                lambda qq, kk: je.mimps_log_z(jv, qq, k, l, kk))(jq, keys)
            want[("MINCE", k, l)] = jax.vmap(
                lambda qq, kk: je.mince_log_z(jv, qq, k, l, kk,
                                              weighting="paper"))(jq, keys)
    assert set(got) == set(want)
    for cell, lz in want.items():
        _pct_close(got[cell], jcommon.pct_abs_rel_error(lz, true), true)
    rows = pt.table1_rows([got, got])
    assert len(rows) == len(want) and all(r["sigma"] == 0 for r in rows)


def test_reduced_table2(study):
    jv, tv, kq, ke, kf = study
    noises, p = (0.0, 0.2), 64
    keys = jax.random.split(ke, Q)
    fm = jfm.make_feature_map(kf, D, p)
    jstate = jfm.build_fmbe(fm, jv)
    tfm = feature_map_from_numpy(np.asarray(fm.omega), np.asarray(fm.degree),
                                 np.asarray(fm.coef), fm.p, device="cpu")
    kq1, kq2 = jax.random.split(kq)
    idx = jax.random.choice(kq1, N, (Q,), replace=False)
    noise = jax.random.normal(kq2, (Q, D))
    k, l = 128, 256
    draws = {("uniform", l): _randint(keys, l, N),
             ("complement", k, l): _randint(keys, l, N - k),
             ("complement", 1, l): _randint(keys, l, N - 1)}
    got = pt.table2(tv, idx, noise, tfm, noises=noises, k=k, l=l,
                    draws=draws)
    for nz in noises:
        jq, _ = jcommon.make_queries(kq, jv, Q, noise_rel=nz)
        true = jax.vmap(lambda qq: je.exact_log_z(jv, qq))(jq)
        for name, fn in (
                ("Uniform", lambda qq, kk: je.uniform_log_z(jv, qq, l, kk)),
                ("MIMPS", lambda qq, kk: je.mimps_log_z(jv, qq, k, l, kk)),
                ("MINCE", lambda qq, kk: je.mince_log_z(
                    jv, qq, 1, l, kk, weighting="paper"))):
            lz = jax.vmap(fn)(jq, keys)
            _pct_close(got[(name, nz)], jcommon.pct_abs_rel_error(lz, true),
                       true)
        # FMBE: signed sums, to 1e-4 of sum |phi_j lambda_j| over Z
        zf = np.asarray(jax.vmap(lambda qq: jfm.fmbe_estimate_z(jstate, qq))(
            jq), np.float64)
        zt = np.exp(np.asarray(true, np.float64))
        terms = np.abs(np.asarray(jfm.apply_feature_map(jstate.fm, jq)) *
                       np.asarray(jstate.lambda_tilde)).sum(-1)
        want = 100.0 * np.abs((zf - zt) / zt)
        tol = 100.0 * (1e-4 * terms + 1e-5 * zt) / zt
        assert np.all(np.abs(got[("FMBE", nz)] - want) <= tol)


def test_reduced_table3(study):
    jv, tv, kq, ke, _ = study
    k, l = 128, 256
    jq, _ = jcommon.make_queries(kq, jv, Q)
    keys = jax.random.split(ke, Q)
    draws = {("complement", k, l): _randint(keys, l, N - k),
             ("complement", 1, l): _randint(keys, l, N - 1)}
    got = pt.table3(tv, _t(jq), k=k, l=l, draws=draws)
    true = jax.vmap(lambda qq: je.exact_log_z(jv, qq))(jq)
    lz_mince = jax.vmap(lambda qq, kk: je.mince_log_z(jv, qq, 1, l, kk))(
        jq, keys)
    for case, dr in pt.DROPS.items():
        lz = jax.vmap(lambda qq, kk: je.mimps_log_z(
            jv, qq, k, l, kk, drop_ranks=dr))(jq, keys)
        _pct_close(got[("MIMPS", case)], jcommon.pct_abs_rel_error(lz, true),
                   true)
        _pct_close(got[("MINCE", case)],
                   jcommon.pct_abs_rel_error(lz_mince, true), true)


def test_run_and_orderings_at_a_small_size():
    """``run`` end to end on the CPU at a small size: every table and
    cell, finite, and the orderings evaluated (they need the full grid)."""
    res = pt.run(n=N, d=D, n_queries=Q, seeds=(0, 1), fmbe_features=64,
                 device="cpu")
    assert len(res["table1"]["rows"]) == len(pt.LS) + \
        2 * len(pt.KS) * len(pt.LS)
    assert len(res["table2"]["rows"]) == 4 * len(pt.NOISES)
    assert len(res["table3"]["rows"]) == 2 * len(pt.DROPS)
    assert len(res["fig1"]["rows"]) == 6
    for name in ("table1", "table2", "table3"):
        assert all(np.isfinite(r["mu"]) for r in res[name]["rows"])
    checks = pt.check_orderings(res)
    assert set(checks) == set(pt.ORDERINGS)
    assert "Table 1" in pt.format_tables(res)


def test_layer_config_mirrors_jax():
    assert dataclasses.asdict(PartitionConfig(**PART)) == \
        dataclasses.asdict(JPartitionConfig(**PART))
