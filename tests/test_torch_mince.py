"""The port's MINCE core against the JAX package on the same numpy inputs
(f32, CPU). Sums and stats agree to 1e-5 relative; solved thetas to
1e-4 (1 + |theta|), since 25 Halley iterations magnify f32 differences;
the convergence trace wherever it is still above round-off."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mince as jm
from repro_torch.core import mince as tm

Q, A, B = 5, 48, 64


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x)


def _close(got, want, rel=1e-5):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, np.abs(want).max()))


def _theta(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-4 * (1 + np.abs(want))), \
        (got, want)


@pytest.fixture(scope="module")
def nce():
    """A paper-weighted NCE problem per row: head atoms above the noise
    atoms, theta0 the head's logsumexp, and masks that drop a few."""
    rng = np.random.default_rng(0)
    alpha = (rng.normal(2.0, 1.5, (Q, A)) + 4.0).astype(np.float32)
    beta = rng.normal(0.0, 1.5, (Q, B)).astype(np.float32)
    theta0 = np.log(np.exp(alpha).sum(-1)).astype(np.float32) - 3.0
    am = (rng.random((Q, A)) > 0.1).astype(np.float32)
    bm = (rng.random((Q, B)) > 0.1).astype(np.float32)
    return alpha, beta, theta0, am, bm


@pytest.fixture(scope="module")
def atoms():
    """Anchored atoms of one head + tail draw per row."""
    rng = np.random.default_rng(1)
    k, l, n = 16, 48, 4096
    scores = np.concatenate([rng.normal(6.0, 1.0, (Q, k)),
                             rng.normal(0.0, 1.0, (Q, l))], -1)
    scores = scores.astype(np.float32)
    mult = np.concatenate([np.ones((Q, k)),
                           np.full((Q, l), (n - k) / l)], -1)
    mult = mult.astype(np.float32)
    anchor = np.log(np.exp(scores[:, :k]).sum(-1) + (n - k) / l *
                    np.exp(scores[:, k:]).sum(-1)).astype(np.float32)
    return scores, mult, n, np.float32(k), np.float32(l), anchor


@pytest.mark.parametrize("masked", [False, True])
def test_objective_and_derivative_sums(nce, masked):
    alpha, beta, theta0, am, bm = nce
    ma, mb = (am, bm) if masked else (None, None)
    tma, tmb = (_t(am), _t(bm)) if masked else (None, None)
    for theta in (theta0, theta0 + 30.0, theta0 - 30.0):
        _close(tm.nce_objective(_t(theta), _t(alpha), _t(beta), tma, tmb),
               jm.nce_objective(jnp.asarray(theta), jnp.asarray(alpha),
                                jnp.asarray(beta), ma, mb))
        for got, want in zip(
                tm.derivative_sums(_t(theta), _t(alpha), _t(beta), tma, tmb),
                jm.derivative_sums(jnp.asarray(theta), jnp.asarray(alpha),
                                   jnp.asarray(beta), ma, mb)):
            _close(got, want)


def test_objective_keeps_softplus_above_twenty():
    """softplus(x) = log(1 + e^x), not x, past 20: the JAX objective."""
    theta = np.array([25.0], np.float32)
    alpha = np.array([[0.5, 30.0]], np.float32)
    beta = np.array([[-2.0]], np.float32)
    got = tm.nce_objective(_t(theta), _t(alpha), _t(beta))
    want = jm.nce_objective(jnp.asarray(theta), jnp.asarray(alpha),
                            jnp.asarray(beta))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("solver", ["halley", "newton"])
def test_halley_step(solver):
    rng = np.random.default_rng(2)
    f1, f2, f3 = (rng.normal(0, 3, 64).astype(np.float32) for _ in range(3))
    f1[:4] = [1e-8, 0.0, 50.0, -50.0]           # denominator ~0, clips
    f2[:4] = [1e-9, 1e-9, 0.01, 0.01]
    f3[:4] = [0.0, 0.0, 0.0, 0.0]
    for max_step in (10.0, float("inf")):
        _close(tm.halley_step(_t(f1), _t(f2), _t(f3), solver, max_step),
               jm.halley_step(jnp.asarray(f1), jnp.asarray(f2),
                              jnp.asarray(f3), solver, max_step))


@pytest.mark.parametrize("solver", ["halley", "newton"])
@pytest.mark.parametrize("masked", [False, True])
def test_solve_log_z(nce, solver, masked):
    alpha, beta, theta0, am, bm = nce
    ma, mb = (am, bm) if masked else (None, None)
    got = tm.solve_log_z(_t(alpha), _t(beta), _t(theta0), 25, solver,
                         None if ma is None else _t(ma),
                         None if mb is None else _t(mb))
    want = jm.solve_log_z(jnp.asarray(alpha), jnp.asarray(beta),
                          jnp.asarray(theta0), iters=25, solver=solver,
                          alpha_mask=ma, beta_mask=mb)
    _theta(got, want)


def test_solve_log_z_batched_equals_each_row(nce):
    """Rank-polymorphic: the (Q,) batch solves each row's problem."""
    alpha, beta, theta0, _, _ = nce
    batched = tm.solve_log_z(_t(alpha), _t(beta), _t(theta0))
    for i in range(Q):
        one = tm.solve_log_z(_t(alpha[i]), _t(beta[i]), _t(theta0[i]))
        assert one.shape == ()
        _theta(one, _np(batched)[i])


def test_anchored_atoms(atoms):
    scores, mult, n, k, l, anchor = atoms
    got = tm.anchored_atoms(_t(scores), _t(mult), n, _t(k), _t(l),
                            _t(anchor))
    want = jm.anchored_atoms(jnp.asarray(scores), jnp.asarray(mult), n,
                             jnp.asarray(k), jnp.asarray(l),
                             jnp.asarray(anchor))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.fixture(scope="module")
def stats(atoms):
    scores, mult, n, k, l, anchor = atoms
    ja = jm.anchored_atoms(jnp.asarray(scores), jnp.asarray(mult), n,
                           jnp.asarray(k), jnp.asarray(l),
                           jnp.asarray(anchor))
    ta = tm.anchored_atoms(_t(scores), _t(mult), n, _t(k), _t(l),
                           _t(anchor))
    # two atoms far outside the span: clamped into the edge bins
    ja = (ja[0].at[:, 0].set(anchor + 500.0).at[:, 1].set(anchor - 500.0),
          ja[1], ja[2])
    ta = (ta[0].clone(), ta[1], ta[2])
    ta[0][:, 0] = _t(anchor) + 500.0
    ta[0][:, 1] = _t(anchor) - 500.0
    return (tm.mince_stats(*ta, _t(anchor), n_bins=64),
            jm.mince_stats(*ja, jnp.asarray(anchor), n_bins=64), anchor)


def test_mince_stats(stats):
    got, want, _ = stats
    assert isinstance(got, tm.MinceStats)
    for name in tm.MinceStats._fields:
        _close(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("solver", ["halley", "newton"])
def test_stats_sums_residual_and_solve(stats, solver):
    got, want, anchor = stats
    for theta in (anchor, anchor + 3.0):
        for g, w in zip(tm.stats_derivative_sums(_t(theta), got),
                        jm.stats_derivative_sums(jnp.asarray(theta), want)):
            _close(g, w)
        _close(tm.solver_residual(_t(theta), got),
               jm.solver_residual(jnp.asarray(theta), want))
    theta0 = anchor - 15.0
    _theta(tm.solve_from_stats(got, _t(theta0), 25, solver),
           jm.solve_from_stats(want, jnp.asarray(theta0), iters=25,
                               solver=solver))


@pytest.mark.parametrize("solver", ["halley", "newton"])
@pytest.mark.parametrize("iters", [2, 30])
def test_anchored_solve(solver, iters):
    rng = np.random.default_rng(3)
    anchor = rng.normal(5.0, 3.0, 16).astype(np.float32)
    theta0 = (anchor + rng.normal(0.0, 20.0, 16)).astype(np.float32)
    theta0[:2] = anchor[:2] + [100.0, -100.0]        # clipped starts
    _theta(tm.anchored_solve(_t(anchor), _t(theta0), iters, solver),
           jm.anchored_solve(jnp.asarray(anchor), jnp.asarray(theta0),
                             iters=iters, solver=solver))


@pytest.mark.parametrize("solver", ["halley", "newton"])
def test_solve_shared_atoms(atoms, solver):
    scores, mult, n, k, l, anchor = atoms
    ta = tm.anchored_atoms(_t(scores), _t(mult), n, _t(k), _t(l),
                           _t(anchor))
    ja = jm.anchored_atoms(jnp.asarray(scores), jnp.asarray(mult), n,
                           jnp.asarray(k), jnp.asarray(l),
                           jnp.asarray(anchor))
    for start in (anchor, anchor - 6.0):
        got = tm.solve_shared_atoms(*ta, _t(start), 8, solver)
        want = jm.solve_shared_atoms(*ja, jnp.asarray(start), iters=8,
                                     solver=solver)
        _theta(got, want)
        u = ta[1] + ta[2]
        _theta(tm._bracketed_shared_solve(ta[0], u, ta[2].sum(-1),
                                          _t(start), 8, solver),
               jm._bracketed_shared_solve(ja[0], ja[1] + ja[2],
                                          ja[2].sum(-1), jnp.asarray(start),
                                          8, solver))
    # the anchored root is the anchor (the collapse identity)
    root = tm.solve_shared_atoms(*ta, _t(anchor), 8, solver)
    _theta(root, anchor)


@pytest.mark.parametrize("solver", ["halley", "newton"])
def test_solver_convergence_trace(nce, solver):
    """|f'| per iteration, equal wherever it is above f32 round-off of the
    sums (1e-3 here, where the terms are O(1) and about 100 of them)."""
    alpha, beta, theta0, _, _ = nce
    got = _np(tm.solver_convergence_trace(_t(alpha), _t(beta), _t(theta0),
                                          12, solver))
    want = np.asarray(jm.solver_convergence_trace(
        jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(theta0), 12,
        solver))
    assert got.shape == want.shape == (12, Q)
    live = want > 1e-3
    assert live[0].all() and live.sum() >= 2 * Q
    np.testing.assert_allclose(got[live], want[live], rtol=1e-3)
