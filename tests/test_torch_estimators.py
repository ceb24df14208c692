"""The port's estimators against the JAX package on the same numpy inputs
and draws (f32, CPU). log Ẑ agrees to 1e-5 (1 + |log Z|), the paper
weighting's MINCE solve to 1e-4 (1 + |theta|) (25 Halley iterations
magnify f32 differences). The JAX functions run per query under
``jax.vmap`` with one key a query; the port takes the whole (Q, d) batch
and the ``randint`` draws of those keys, and its batched call equals its
per-query calls."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as je
from repro.core import feature_maps as jfm
from repro.core import mips as jmips
from repro_torch.core import estimators as te
from repro_torch.core import feature_maps as tfm
from repro_torch.core import mips as tmips
from repro_torch.interop import feature_map_from_numpy

N, D, Q = 2048, 32, 6


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
    """word2vec-like rows (clusters, rank-correlated norms, no ties) and
    queries near rows, one JAX key a query."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, D))
    v = centers[rng.integers(0, 16, N)] + 0.6 * rng.standard_normal((N, D))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v *= (0.35 + 1.8 * np.sqrt(np.arange(N) / N))[:, None] * np.sqrt(D) * 0.35
    q = v[rng.choice(N, Q, replace=False)] + 0.1 * rng.standard_normal((Q, D))
    keys = jax.random.split(jax.random.PRNGKey(7), Q)
    return v.astype(np.float32), q.astype(np.float32), keys


def _draws(keys, l, high):
    """The randint draws the JAX estimators make from each query's key."""
    return _t(np.stack([np.asarray(jax.random.randint(k, (l,), 0, high))
                        for k in keys]))


def _jvmap(fn, q, keys):
    return jax.vmap(fn)(jnp.asarray(q), keys)


def test_exact_and_nmimps(data):
    v, q, _ = data
    jv = jnp.asarray(v)
    _logz(te.exact_log_z(_t(v), _t(q)),
          jax.vmap(lambda qq: je.exact_log_z(jv, qq))(jnp.asarray(q)))
    for k in (1, 16):
        _logz(te.nmimps_log_z(_t(v), _t(q), k),
              jax.vmap(lambda qq: je.nmimps_log_z(jv, qq, k))(
                  jnp.asarray(q)))


def test_oracle_retrieve_and_complement_sample(data):
    v, q, keys = data
    ret = te.oracle_retrieve(_t(v), _t(q))
    jret = jax.vmap(lambda qq: je.oracle_retrieve(jnp.asarray(v), qq))(
        jnp.asarray(q))
    np.testing.assert_array_equal(_np(ret.order), np.asarray(jret.order))
    np.testing.assert_allclose(_np(ret.scores_sorted),
                               np.asarray(jret.scores_sorted), atol=1e-5)
    for k, l in ((16, 64), (N, 8)):           # k == N clamps to the last rank
        got = te._complement_sample(None, ret, k, l,
                                    _draws(keys, l, max(N - k, 1)))
        want = jax.vmap(lambda kk, r: je._complement_sample(kk, r, k, l))(
            keys, jret)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("k,l,drop", [
    (16, 64, None), (128, 256, None), (128, 256, (0,)), (128, 256, (1,)),
    (128, 256, (0, 1)),
    (0, 64, None),                 # no head: uniform over every rank
    (16, 0, None),                 # no tail: the head alone
    (N, 64, None),                 # the head is everything: exact
])
def test_mimps_log_z(data, k, l, drop):
    v, q, keys = data
    got = te.mimps_log_z(_t(v), _t(q), k, l, drop_ranks=drop,
                         tail_pos=_draws(keys, l, max(N - k, 1)))
    want = _jvmap(lambda qq, kk: je.mimps_log_z(jnp.asarray(v), qq, k, l, kk,
                                                drop_ranks=drop), q, keys)
    _logz(got, want)


@pytest.mark.parametrize("l", [0, 64])
def test_uniform_log_z(data, l):
    v, q, keys = data
    got = te.uniform_log_z(_t(v), _t(q), l, idx=_draws(keys, l, N))
    want = _jvmap(lambda qq, kk: je.uniform_log_z(jnp.asarray(v), qq, l, kk),
                  q, keys)
    _logz(got, want)


@pytest.mark.parametrize("weighting", ["paper", "anchored"])
@pytest.mark.parametrize("k,l", [(16, 64), (128, 256),
                                 (0, 64),       # uniform on the same draws
                                 (N, 64)])      # exact
def test_mince_log_z(data, weighting, k, l):
    v, q, keys = data
    got = te.mince_log_z(_t(v), _t(q), k, l, weighting=weighting,
                         tail_pos=_draws(keys, l, max(N - k, 1)))
    want = _jvmap(lambda qq, kk: je.mince_log_z(
        jnp.asarray(v), qq, k, l, kk, weighting=weighting), q, keys)
    _logz(got, want, 1e-4 if weighting == "paper" else 1e-5)


def test_mince_refuses_an_unknown_weighting(data):
    v, q, keys = data
    with pytest.raises(ValueError, match="weighting"):
        te.mince_log_z(_t(v), _t(q), 16, 64, weighting="median",
                       tail_pos=_draws(keys, 64, N - 16))


def test_batched_equals_per_query(data):
    """As jax.vmap: each row of the batched call is that query's call."""
    v, q, keys = data
    pos = _draws(keys, 64, N - 16)
    idx = _draws(keys, 64, N)
    fns = [lambda qq, p, i: te.mimps_log_z(_t(v), qq, 16, 64, tail_pos=p),
           lambda qq, p, i: te.mince_log_z(_t(v), qq, 16, 64, tail_pos=p),
           lambda qq, p, i: te.mince_log_z(_t(v), qq, 16, 64, tail_pos=p,
                                           weighting="paper"),
           lambda qq, p, i: te.uniform_log_z(_t(v), qq, 64, idx=i),
           lambda qq, p, i: te.nmimps_log_z(_t(v), qq, 16),
           lambda qq, p, i: te.exact_log_z(_t(v), qq)]
    for fn in fns:
        batched = _np(fn(_t(q), pos, idx))
        for i in range(Q):
            one = fn(_t(q[i]), pos[i], idx[i])
            assert one.shape == ()
            _logz(one, batched[i], 1e-6)


def test_generator_draws_have_the_right_ranges(data):
    v, q, _ = data
    g = torch.Generator().manual_seed(0)
    for fn in (lambda: te.mimps_log_z(_t(v), _t(q), 16, 64, g),
               lambda: te.uniform_log_z(_t(v), _t(q), 64, g),
               lambda: te.mince_log_z(_t(v), _t(q), 16, 64, g)):
        out = fn()
        assert out.shape == (Q,) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="Generator"):
        te.uniform_log_z(_t(v), _t(q), 64)


@pytest.mark.parametrize("case", ["plain", "masked", "empty_head",
                                  "empty_tail"])
def test_head_tail_log_z(case):
    rng = np.random.default_rng(4)
    head = rng.normal(3, 1, (Q, 12)).astype(np.float32)
    tail = rng.normal(0, 1, (Q, 20)).astype(np.float32)
    hm = rng.random((Q, 12)) > 0.3
    tmask = rng.random((Q, 20)) > 0.3
    kw, tkw = {}, {}
    if case == "masked":
        kw = dict(head_mask=jnp.asarray(hm), tail_mask=jnp.asarray(tmask))
        tkw = dict(head_mask=_t(hm), tail_mask=_t(tmask))
    if case == "empty_head":
        head = head[:, :0]
    if case == "empty_tail":
        tail = tail[:, :0]
    got = te.head_tail_log_z(_t(head), _t(tail), 1000.0, 20.0, **tkw)
    want = jax.vmap(lambda h, t, *m: je.head_tail_log_z(
        h, t, jnp.float32(1000.0), jnp.float32(20.0),
        *m))(jnp.asarray(head), jnp.asarray(tail), *kw.values())
    _logz(got, want)


@pytest.fixture(scope="module")
def index(data):
    v, _, _ = data
    j = jmips.build_ivf(jax.random.PRNGKey(1), jnp.asarray(v), block_rows=64,
                        n_clusters=8)
    t = tmips.build_ivf(_t(v), block_rows=64, n_clusters=8,
                        assign=_t(np.asarray(j.assign)), device="cpu")
    return j, t


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("n_probe,l", [(4, 64), (32, 64)])
def test_mimps_ivf(data, index, use_kernel, n_probe, l):
    """n_probe 32 of 35 blocks: most tail samples rejected."""
    v, q, keys = data
    j, t = index
    got = te.mimps_ivf(t, _t(q), n_probe, l, idx=_draws(keys, l, N),
                       use_kernel=use_kernel)
    want = jax.vmap(lambda qq, kk: je.mimps_ivf(j, qq, n_probe, l, kk))(
        jnp.asarray(q), keys)
    _logz(got.log_z, want.log_z)
    np.testing.assert_array_equal(_np(got.k_eff), np.asarray(want.k_eff))
    np.testing.assert_array_equal(_np(got.top_id), np.asarray(want.top_id))
    np.testing.assert_allclose(_np(got.top_score), np.asarray(want.top_score),
                               atol=1e-5)
    one = te.mimps_ivf(t, _t(q[0]), n_probe, l, idx=_draws(keys, l, N)[0],
                       use_kernel=use_kernel)
    assert one.log_z.shape == ()
    _logz(one.log_z, _np(got.log_z)[0], 1e-6)


@pytest.fixture(scope="module")
def sketch(data):
    v, _, _ = data
    fm = jfm.make_feature_map(jax.random.PRNGKey(3), D, 128)
    jstate = jfm.build_fmbe(fm, jnp.asarray(v))
    tmap = feature_map_from_numpy(np.asarray(fm.omega), np.asarray(fm.degree),
                                  np.asarray(fm.coef), fm.p, device="cpu")
    return jstate, tfm.build_fmbe(tmap, _t(v))


def test_fmbe_z(data, sketch):
    """Signed sums that cancel: equal to 1e-4 of sum_j |phi_j lambda_j|."""
    _, q, _ = data
    jstate, tstate = sketch
    got = _np(te.fmbe_z(tstate, _t(q)))
    want = np.asarray(jax.vmap(lambda qq: je.fmbe_z(jstate, qq))(
        jnp.asarray(q)))
    terms = np.abs(np.asarray(jfm.apply_feature_map(jstate.fm, jnp.asarray(q)))
                   * np.asarray(jstate.lambda_tilde)).sum(-1)
    assert np.all(np.abs(got - want) <= 1e-4 * terms + 1e-6)


def test_relative_error():
    a = np.array([0.0, 1.0, -2.0, 30.0], np.float32)
    b = np.array([0.0, 1.5, -2.0, 29.0], np.float32)
    np.testing.assert_allclose(_np(te.relative_error(_t(a), _t(b))),
                               np.asarray(je.relative_error(
                                   jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)


METHODS = ["exact", "mimps", "mimps_ivf", "nmimps", "uniform", "mince",
           "fmbe", "selfnorm"]


@pytest.mark.parametrize("method", METHODS)
def test_estimate_log_z(data, index, sketch, method):
    """Every method name of the dispatcher, with JAX's own options."""
    v, q, keys = data
    jindex, tindex = index
    jstate, tstate = sketch
    k, l, n_probe = 16, 64, 4
    ivf = method == "mimps_ivf"
    name = "mimps" if ivf else method
    draws = {"mimps": _draws(keys, l, N if ivf else N - k),
             "uniform": _draws(keys, l, N),
             "mince": _draws(keys, l, N - k)}.get(name)
    got = te.estimate_log_z(name, _t(v), _t(q), k=k, l=l,
                            index=tindex if ivf else None, n_probe=n_probe,
                            fmbe_state=tstate, draws=draws, use_kernel=False)
    want = jax.vmap(lambda qq, kk: je.estimate_log_z(
        name, jnp.asarray(v), qq, kk, k=k, l=l,
        index=jindex if ivf else None, n_probe=n_probe,
        fmbe_state=jstate))(jnp.asarray(q), keys)
    if method == "fmbe":                     # the clip hides cancellation
        big = np.asarray(want) > np.log(1e-3)
        assert big.any()
        _logz(_np(got)[big], np.asarray(want)[big], 1e-4)
        return
    _logz(got, want)
    # the kernel route's plain versions on CPU tensors give the same value
    again = te.estimate_log_z(name, _t(v), _t(q), k=k, l=l,
                              index=tindex if ivf else None,
                              n_probe=n_probe, fmbe_state=tstate, draws=draws,
                              use_kernel=True)
    _logz(again, want)


def test_estimate_log_z_refuses_unknown_and_unbuilt(data):
    v, q, _ = data
    with pytest.raises(ValueError, match="unknown partition method"):
        te.estimate_log_z("median", _t(v), _t(q))
    with pytest.raises(ValueError, match="FMBEState"):
        te.estimate_log_z("fmbe", _t(v), _t(q))
