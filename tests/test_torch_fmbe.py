"""The port's FMBE feature maps and its plain feature kernels against the JAX
package on the same numpy inputs (f32, CPU): ``fmbe_phi``/``fmbe_z``
against the Pallas kernels in interpret mode, ``core.feature_maps`` against
the JAX module, with the JAX feature map injected
(``interop.feature_map_from_numpy``). FMBE sums are signed and cancel, so a
sum is held to 1e-4 of the sum of its terms' magnitudes (plus 1e-6), and a
feature to 1e-4 of its scale |coef_j| * max(|x|_2, 1) ** degree_j."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import backends as jback
from repro.core import feature_maps as jfm
from repro.core.estimators import fmbe_log_z as j_fmbe_log_z
from repro.kernels.fmbe import fmbe_phi as jax_fmbe_phi
from repro.kernels.fmbe import fmbe_z as jax_fmbe_z
from repro_torch.configs import reduced_config
from repro_torch.core import backends as tback
from repro_torch.core import feature_maps as tfm
from repro_torch.core.estimators import fmbe_log_z
from repro_torch.interop import feature_map_from_numpy
from repro_torch.kernels.fmbe import (fmbe_phi, fmbe_phi_plain, fmbe_z,
                                     fmbe_z_plain)

REL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_fm(seed, d, p, max_degree=8):
    fm = jfm.make_feature_map(jax.random.PRNGKey(seed), d, p,
                              max_degree=max_degree)
    return fm, feature_map_from_numpy(np.asarray(fm.omega),
                                      np.asarray(fm.degree),
                                      np.asarray(fm.coef), fm.p,
                                      device="cpu")


def _phi_scale(fm, x):
    norm = np.maximum(np.linalg.norm(x, axis=-1), 1.0)
    deg = np.asarray(fm.degree, np.float64)
    return np.abs(np.asarray(fm.coef))[None, :] * norm[:, None] ** deg


def _assert_phi(got, want, fm, x):
    got, want = np.asarray(got), np.asarray(want)
    tol = REL * (np.abs(want) + _phi_scale(fm, x))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _assert_sum(got, want, terms):
    """|got - want| <= 1e-4 * sum |terms| + 1e-6 along the last axis."""
    scale = np.abs(np.asarray(terms, np.float64)).sum(-1)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= REL * scale + 1e-6).all(), (err, scale)


def _x(seed, q, d, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((q, d))
            ).astype(np.float32)


class TestFeatureKernelsPlain:
    @pytest.mark.parametrize("q,p,max_degree", [(5, 200, 8), (8, 128, 4),
                                                (3, 70, 6)])
    def test_phi_matches_pallas_and_reference(self, q, p, max_degree):
        """P not a multiple of the 128-feature tile, Q below the query
        tile; the Pallas kernel and the JAX reference feature map agree
        with the port's plain version."""
        fm, tmap = _jax_fm(q + p, 32, p, max_degree)
        x = _x(p, q, 32, 0.5)
        got = fmbe_phi_plain(tmap.omega, tmap.degree, tmap.coef, _t(x))
        _assert_phi(got.numpy(), jax_fmbe_phi(fm.omega, fm.degree, fm.coef,
                                              jnp.asarray(x)), fm, x)
        _assert_phi(got.numpy(), jfm.apply_feature_map(fm, jnp.asarray(x)),
                    fm, x)

    def test_degree_zero_feature_is_its_coef(self):
        fm, tmap = _jax_fm(2, 16, 64)
        deg = tmap.degree.numpy()
        assert (deg == 0).any()
        x = _x(3, 4, 16)
        phi = fmbe_phi_plain(tmap.omega, tmap.degree, tmap.coef, _t(x))
        zero = deg == 0
        np.testing.assert_array_equal(
            phi.numpy()[:, zero],
            np.broadcast_to(tmap.coef.numpy()[zero], (4, zero.sum())))

    @pytest.mark.parametrize("shared", [True, False])
    @pytest.mark.parametrize("q,p", [(5, 200), (8, 256)])
    def test_z_matches_pallas(self, q, p, shared):
        """lambda shared (P,) and per query (Q, P); x at several units of
        norm so high-degree features dominate and the sum cancels."""
        fm, tmap = _jax_fm(q * p, 32, p)
        x = _x(q, q, 32)
        rng = np.random.default_rng(p)
        lam = rng.standard_normal((p,) if shared else (q, p)
                                  ).astype(np.float32)
        got = fmbe_z_plain(tmap.omega, tmap.degree, tmap.coef, _t(lam),
                           _t(x))
        want = jax_fmbe_z(fm.omega, fm.degree, fm.coef, jnp.asarray(lam),
                          jnp.asarray(x))
        terms = np.asarray(jfm.apply_feature_map(fm, jnp.asarray(x))) * lam
        _assert_sum(got.numpy(), want, terms)

    def test_wrappers_take_plain_versions_on_cpu(self):
        _, tmap = _jax_fm(4, 16, 64)
        x, lam = _t(_x(5, 3, 16)), _t(_x(6, 3, 64))
        before = (fmbe_phi.launches, fmbe_z.launches)
        torch.testing.assert_close(
            fmbe_phi(tmap.omega, tmap.degree, tmap.coef, x),
            fmbe_phi_plain(tmap.omega, tmap.degree, tmap.coef, x),
            rtol=0, atol=0)
        torch.testing.assert_close(
            fmbe_z(tmap.omega, tmap.degree, tmap.coef, lam, x),
            fmbe_z_plain(tmap.omega, tmap.degree, tmap.coef, lam, x),
            rtol=0, atol=0)
        assert (fmbe_phi.launches, fmbe_z.launches) == before


@pytest.fixture(scope="module")
def sketch():
    """A JAX feature map and block-partitioned sketch over 5 blocks of 16
    rows (some rows padding), and the port's copy of both."""
    d, p, nb, br = 24, 96, 5, 16
    rng = np.random.default_rng(0)
    v_blocks = (0.3 * rng.standard_normal((nb, br, d))).astype(np.float32)
    valid = rng.random((nb, br)) < 0.8
    v_blocks[~valid] = 0.0
    fm, tmap = _jax_fm(1, d, p)
    lam_b = jfm.build_fmbe_blocks(fm, jnp.asarray(v_blocks),
                                  jnp.asarray(valid))
    jstate = jfm.FMBEState(fm=fm, lambda_tilde=lam_b.sum(0),
                           lambda_blocks=lam_b)
    return dict(v_blocks=v_blocks, valid=valid, fm=fm, tmap=tmap,
                jstate=jstate)


class TestFeatureMaps:
    def test_feature_map_from_numpy_carries_fields(self, sketch):
        fm, tmap = sketch["fm"], sketch["tmap"]
        for name in ("omega", "degree", "coef"):
            np.testing.assert_array_equal(getattr(tmap, name).numpy(),
                                          np.asarray(getattr(fm, name)))
        assert tmap.degree.dtype == torch.int32 and tmap.p == fm.p

    def test_apply_feature_map_matches(self, sketch):
        x = _x(1, 6, 24)
        got = tfm.apply_feature_map(sketch["tmap"], _t(x))
        _assert_phi(got.numpy(), jfm.apply_feature_map(sketch["fm"],
                                                       jnp.asarray(x)),
                    sketch["fm"], x)

    @pytest.mark.parametrize("chunk_blocks", [16, 2])
    def test_build_fmbe_blocks_matches(self, sketch, chunk_blocks):
        """Block sums of ~16 signed features, to 1e-4 of their magnitude
        sum; chunks of 2 blocks leave a ragged last chunk."""
        got = tfm.build_fmbe_blocks(sketch["tmap"], _t(sketch["v_blocks"]),
                                    _t(sketch["valid"]),
                                    chunk_blocks=chunk_blocks)
        phi = np.asarray(jfm.apply_feature_map(
            sketch["fm"], jnp.asarray(sketch["v_blocks"])))
        terms = np.abs(phi * sketch["valid"][..., None]).transpose(0, 2, 1)
        _assert_sum(got.numpy(), sketch["jstate"].lambda_blocks, terms)

    def test_build_fmbe_matches(self, sketch):
        v = sketch["v_blocks"].reshape(-1, 24)[sketch["valid"].reshape(-1)]
        got = tfm.build_fmbe(sketch["tmap"], _t(v), chunk=32)
        want = jfm.build_fmbe(sketch["fm"], jnp.asarray(v), chunk=32)
        terms = np.asarray(jfm.apply_feature_map(sketch["fm"],
                                                 jnp.asarray(v))).T
        _assert_sum(got.lambda_tilde.numpy(), want.lambda_tilde, terms)
        assert got.lambda_blocks is None

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_tail_and_global_estimates_match(self, sketch, use_kernel):
        j = sketch["jstate"]
        t = tfm.FMBEState(fm=sketch["tmap"],
                          lambda_tilde=_t(j.lambda_tilde),
                          lambda_blocks=_t(j.lambda_blocks))
        x = _x(7, 5, 24, 0.4)
        probed = np.array([[0, 1], [2, 4], [3, 3], [1, 0], [4, 2]], np.int32)
        phi = np.asarray(jfm.apply_feature_map(j.fm, jnp.asarray(x)))
        rest = np.asarray(j.lambda_tilde)[None] - \
            np.asarray(j.lambda_blocks)[probed].sum(1)
        _assert_sum(tfm.fmbe_tail_z(t, _t(x), _t(probed), use_kernel),
                    jfm.fmbe_tail_z(j, jnp.asarray(x), jnp.asarray(probed),
                                    use_pallas=use_kernel), phi * rest)
        terms = phi * np.asarray(j.lambda_tilde)
        _assert_sum(tfm.fmbe_z_batch(t, _t(x), use_kernel),
                    jfm.fmbe_z_batch(j, jnp.asarray(x),
                                     use_pallas=use_kernel), terms)
        _assert_sum(tfm.fmbe_estimate_z(t, _t(x)),
                    jfm.fmbe_estimate_z(j, jnp.asarray(x)), terms)

    def test_fmbe_log_z_matches_where_the_estimate_is_positive(self,
                                                                sketch):
        """log of the clipped estimate: equal to 1e-4 where z is well above
        the clip, the clip itself (log 1e-30) where z <= 0."""
        j = sketch["jstate"]
        t = tfm.FMBEState(fm=sketch["tmap"], lambda_tilde=_t(j.lambda_tilde))
        x = _x(11, 16, 24, 0.4)
        z = np.asarray(jfm.fmbe_estimate_z(j, jnp.asarray(x)))
        got = fmbe_log_z(t, _t(x)).numpy()
        want = np.asarray(j_fmbe_log_z(j, jnp.asarray(x)))
        big, neg = z > 1e-3, z <= 0
        assert big.any()
        np.testing.assert_allclose(got[big], want[big], atol=1e-4)
        np.testing.assert_allclose(got[neg], np.log(np.float32(1e-30)),
                                   rtol=1e-6)

    def test_tail_z_needs_block_table(self, sketch):
        t = tfm.FMBEState(fm=sketch["tmap"], lambda_tilde=torch.zeros(96))
        with pytest.raises(ValueError, match="block"):
            tfm.fmbe_tail_z(t, torch.zeros(1, 24), torch.zeros(1, 1).int())


class TestMakeFeatureMap:
    def test_draws_follow_the_jax_law(self):
        """Same shapes, dtypes and support as the JAX draw; each degree
        carries the JAX coef of that degree; the degree law is the
        truncated geometric (half of the features at degree 0)."""
        p, d = 4096, 8
        fm = jfm.make_feature_map(jax.random.PRNGKey(0), d, p)
        t = tfm.make_feature_map(torch.Generator().manual_seed(0), d, p,
                                 device="cpu")
        assert t.omega.shape == fm.omega.shape and t.omega.dtype == \
            torch.float32
        assert set(np.unique(t.omega.numpy())) == {-1.0, 1.0}
        assert t.degree.dtype == torch.int32
        deg, jdeg = t.degree.numpy(), np.asarray(fm.degree)
        assert deg.min() >= 0 and deg.max() <= 8
        for m in set(deg) & set(jdeg):
            np.testing.assert_allclose(
                np.unique(t.coef.numpy()[deg == m]),
                np.unique(np.asarray(fm.coef)[jdeg == m]), rtol=1e-6)
        assert abs((deg == 0).mean() - 0.5) < 0.05
        assert abs(deg.mean() - jdeg.mean()) < 0.15

    def test_seeded(self):
        a = tfm.make_feature_map(torch.Generator().manual_seed(3), 8, 64,
                                 device="cpu")
        b = tfm.make_feature_map(torch.Generator().manual_seed(3), 8, 64,
                                 device="cpu")
        for x, y in zip(a[:3], b[:3]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


class TestFmbeBackendWithoutIndex:
    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_global_sketch_matches(self, use_kernel):
        """A vocabulary below 4 blocks builds no index: exact candidates
        and a global-sketch log Ẑ, as in the JAX backend."""
        def cfg(reduced):
            c = reduced("qwen1.5-4b")
            return dataclasses.replace(c.partition, method="fmbe",
                                       block_rows=128, fmbe_features=64)
        jcfg, tcfg = cfg(j_reduced_config), cfg(reduced_config)
        w = _x(8, 300, 32, 0.2)
        h = _x(9, 4, 32, 0.5)
        jstate = jback.get_backend("fmbe").build(jcfg, jnp.asarray(w),
                                                 jax.random.PRNGKey(2))
        assert jstate.index is None
        fm = jstate.fmbe.fm
        tmap = feature_map_from_numpy(np.asarray(fm.omega),
                                      np.asarray(fm.degree),
                                      np.asarray(fm.coef), fm.p,
                                      device="cpu")
        backend = tback.get_backend("fmbe")
        tstate = backend.build(tcfg, _t(w), feature_map=tmap, device="cpu")
        assert tstate.index is None and tstate.fmbe.lambda_blocks is None
        jo = jback.get_backend("fmbe").decode(jstate, jnp.asarray(h),
                                              jax.random.PRNGKey(3), jcfg,
                                              k=4)
        to = backend.decode(tstate, _t(h), tcfg, k=4, use_kernel=use_kernel)
        np.testing.assert_array_equal(to.top_id.numpy(), np.asarray(jo.top_id))
        np.testing.assert_allclose(to.log_z.numpy(), np.asarray(jo.log_z),
                                   atol=1e-4)
