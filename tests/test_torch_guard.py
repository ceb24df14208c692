"""The port's health guard, exact oracle and registry additions against the
JAX package on the same numpy inputs (f32, CPU): ``health_flags``,
``apply_health_guard``, ``topk_z``'s per-query gate, ``shadow_exact_log_z``,
``verify_decode``, ``EstimatorBackend.refresh``, the byte accounting
(``embedding_floats``/``floats_bound``), the fixed-capacity backend build
and the ``kernels.ops`` wrappers. The JAX k-means assignment, feature map
and tail draws are injected. The guard must leave healthy rows bit for
bit and splice the port's exact pass into flagged ones bit for bit; against
JAX, log-values agree to 1e-4 with equal ids, FMBE sums to 1e-4 of the sum
of their terms' magnitudes (plus 1e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import backends as jback
from repro.core import decode as jdec
from repro.core import feature_maps as jfm
from repro.core import mips as jmips
from repro.kernels import ops as jops
from repro_torch.configs import reduced_config
from repro_torch.core import backends as tback
from repro_torch.core import decode as tdec
from repro_torch.core import mips as tmips
from repro_torch.interop import feature_map_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels.topk_z import NEG, topk_z, topk_z_plain

V, D, BR, C, Q, L, K = 2048, 64, 64, 8, 4, 64, 4
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _pc(reduced, method):
    pc = reduced("qwen1.5-4b").partition
    return dataclasses.replace(pc, method=method, block_rows=BR, n_probe=4,
                               l=L, n_clusters=C, fmbe_features=64,
                               sample_k=K)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, D))
    w = centers[rng.integers(0, 16, V)] + 0.5 * rng.standard_normal((V, D))
    w = (0.35 * w / np.linalg.norm(w, axis=1, keepdims=True)
         * np.sqrt(D)).astype(np.float32)
    h = (0.5 * w[rng.integers(0, V, Q)]
         + 0.2 * rng.standard_normal((Q, D))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    j_index = jmips.build_ivf(jax.random.PRNGKey(1), jnp.asarray(w),
                              block_rows=BR, n_clusters=C)
    t_index = tmips.build_ivf(_t(w), block_rows=BR, n_clusters=C,
                              assign=_t(j_index.assign), device="cpu")
    tail = _t(jax.random.randint(key, (L,), 0, V))
    jo = jdec.mimps_decode(j_index, jnp.asarray(h), key, n_probe=4, l=L,
                           k=K, use_pallas=False)
    to = tdec.mimps_decode(t_index, _t(h), n_probe=4, l=L, k=K,
                           use_kernel=False, tail_idx=tail)
    return dict(w=w, h=h, key=key, j_index=j_index, t_index=t_index,
                tail=tail, jo=jo, to=to)


def _same_out(a, b):
    for name in tdec.DecodeOut._fields:
        x, y = getattr(a, name), getattr(b, name)
        if y is None:
            assert x is None, name
            continue
        assert x.dtype == y.dtype and torch.equal(
            x.nan_to_num(), y.nan_to_num()), name
        assert torch.equal(x.isnan(), y.isnan()), name


class TestHealthFlags:
    def test_flags_equal_jax(self, data):
        """NaN and inf log Ẑ, an empty head and a non-finite candidate
        score, alone and together."""
        o = data["to"]
        log_z = o.log_z.numpy().copy()
        top = o.top_score.numpy().copy()
        k_eff = o.k_eff.numpy().astype(np.int32)
        log_z[1], log_z[2] = np.nan, -np.inf
        k_eff[2] = k_eff[3] = 0
        top[3, 1] = np.inf
        fields = dict(log_z=log_z, top_score=top, top_id=o.top_id.numpy(),
                      head_lse=o.head_lse.numpy(), tail_lse=o.tail_lse.numpy(),
                      k_eff=k_eff)
        j = jdec.DecodeOut(**{n: jnp.asarray(a) for n, a in fields.items()})
        t = tdec.DecodeOut(**{n: _t(a) for n, a in fields.items()})
        got = tdec.health_flags(t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jdec.health_flags(j)))
        assert got.tolist() == [0, 1, 1 | 2, 2 | 4]
        assert (tdec.HEALTH_NONFINITE_Z, tdec.HEALTH_EMPTY_HEAD,
                tdec.HEALTH_NONFINITE_SCORE) == (
            jdec.HEALTH_NONFINITE_Z, jdec.HEALTH_EMPTY_HEAD,
            jdec.HEALTH_NONFINITE_SCORE)


class TestGuard:
    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_identity_when_healthy(self, data, use_kernel):
        o = data["to"]
        w, h = _t(data["w"]), _t(data["h"])
        guarded, flags = tdec.apply_health_guard(o, w, h, K,
                                                 use_kernel=use_kernel)
        assert not flags.any()
        _same_out(guarded, o)

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_splices_exact_rows_into_poisoned_ones(self, data, use_kernel):
        """Rows 1 (NaN) and 3 (inf) take the port's exact decode bit for
        bit, rows 0 and 2 keep theirs; against JAX's guard to 1e-4 with
        equal ids."""
        o, jo = data["to"], data["jo"]
        w, h = _t(data["w"]), _t(data["h"])
        bad = o.log_z.clone()
        bad[1], bad[3] = float("nan"), float("inf")
        guarded, flags = tdec.apply_health_guard(
            o._replace(log_z=bad), w, h, K, use_kernel=use_kernel)
        assert flags.tolist() == [0, 1, 0, 1]
        ex = tdec.exact_topk_decode(w, h, k=K, use_kernel=use_kernel)
        for name in ("log_z", "top_score", "top_id", "head_lse", "tail_lse"):
            got, want, est = (getattr(x, name) for x in (guarded, ex, o))
            assert torch.equal(got[[1, 3]], want[[1, 3]]), name
            assert torch.equal(got[[0, 2]], est[[0, 2]]), name
        assert torch.equal(guarded.k_eff, o.k_eff)
        jbad = jo._replace(log_z=jo.log_z.at[1].set(jnp.nan)
                           .at[3].set(jnp.inf))
        jg, jflags = jdec.apply_health_guard(jbad, jnp.asarray(data["w"]),
                                             jnp.asarray(data["h"]), K)
        np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
        for name in ("log_z", "top_score", "head_lse"):
            np.testing.assert_allclose(getattr(guarded, name).numpy(),
                                       np.asarray(getattr(jg, name)),
                                       atol=ATOL, err_msg=name)
        np.testing.assert_array_equal(guarded.top_id.numpy(),
                                      np.asarray(jg.top_id))

    def test_active_mask_keeps_padded_lanes_out(self, data):
        o = data["to"]
        bad = o._replace(log_z=torch.where(torch.arange(Q) == 2,
                                           float("nan"), o.log_z))
        active = torch.tensor([True, True, False, True])
        guarded, flags = tdec.apply_health_guard(
            bad, _t(data["w"]), _t(data["h"]), K, active=active)
        assert not flags.any()
        assert torch.isnan(guarded.log_z[2])     # the lane's garbage stays
        jg, jflags = jdec.apply_health_guard(
            data["jo"]._replace(log_z=data["jo"].log_z.at[2].set(jnp.nan)),
            jnp.asarray(data["w"]), jnp.asarray(data["h"]), K,
            active=jnp.asarray(active.numpy()))
        np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))

    def test_topk_z_gate(self, data):
        """Gated rows get the filler (lse -inf, (NEG, 0)); flagged rows are
        the ungated call's, bit for bit."""
        w, h = _t(data["w"]), _t(data["h"])
        rows = torch.tensor([4, 0, 1, 0], dtype=torch.int32)
        full = topk_z(h, w, K)
        for got in (topk_z(h, w, K, rows=rows),
                    topk_z_plain(h, w, K, rows)):
            on = rows != 0
            for a, b in zip(got, full):
                assert torch.equal(a[on], b[on])
            assert torch.isneginf(got[0][~on]).all()
            assert (got[1][~on] == NEG).all() and not got[2][~on].any()
        none = topk_z(h, w, K, rows=torch.zeros(Q, dtype=torch.int32))
        assert torch.isneginf(none[0]).all()


class TestOracleAndRegistry:
    def test_shadow_exact_log_z_is_the_exact_tier(self, data):
        w, h = _t(data["w"]), _t(data["h"])
        state = tback.BackendState(w=w)
        exact = tback.get_backend("exact").decode(state, h, _pc(
            reduced_config, "exact"), k=K)
        got = tback.shadow_exact_log_z(state, h, k=K)
        assert torch.equal(got, exact.log_z)
        want = jback.shadow_exact_log_z(jback.BackendState(
            w=jnp.asarray(data["w"])), jnp.asarray(data["h"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_verify_decode_flattens_lane_major(self, data):
        """(S, k_pos, d) drafts: the flat decode's rows, lane-major, with
        a per-lane active mask; against JAX's verify_decode."""
        pc, jpc = _pc(reduced_config, "mimps"), _pc(j_reduced_config, "mimps")
        rng = np.random.default_rng(7)
        hs = (0.5 * data["w"][rng.integers(0, V, 6)]).reshape(3, 2, D)
        state = tback.BackendState(w=_t(data["w"]), index=data["t_index"])
        jstate = jback.BackendState(w=jnp.asarray(data["w"]),
                                    index=data["j_index"])
        active = np.array([True, False, True])
        tb, jb = tback.get_backend("mimps"), jback.get_backend("mimps")
        got = tback.verify_decode(tb, state, _t(hs), pc, k=K,
                                  active=_t(active), tail_idx=data["tail"])
        flat = tb.decode(state, _t(hs.reshape(6, D)), pc, k=K,
                         tail_idx=data["tail"],
                         active=_t(np.repeat(active, 2)))
        _same_out(got, flat)
        want = jback.verify_decode(jb, jstate, jnp.asarray(hs), data["key"],
                                   jpc, k=K, active=jnp.asarray(active))
        np.testing.assert_allclose(got.log_z.numpy(), np.asarray(want.log_z),
                                   atol=ATOL)
        np.testing.assert_array_equal(got.top_id.numpy(),
                                      np.asarray(want.top_id))

    @pytest.mark.parametrize("method", ["exact", "selfnorm", "mimps",
                                        "mince", "topk", "fmbe", "lsh"])
    def test_byte_accounting_equals_jax(self, data, method):
        pc, jpc = _pc(reduced_config, method), _pc(j_reduced_config, method)
        jstate = jback.get_backend(method).build(
            jpc, jnp.asarray(data["w"]), jax.random.PRNGKey(1))
        inject = {}
        if jstate.index is not None:
            inject["assign"] = _t(jstate.index.assign)
        if jstate.fmbe is not None:
            fm = jstate.fmbe.fm
            inject["feature_map"] = feature_map_from_numpy(
                *(np.asarray(a) for a in fm[:3]), p=fm.p, device="cpu")
        if jstate.lsh is not None:
            inject["lsh_proj"] = _t(jstate.lsh.proj)
        tb, jb = tback.get_backend(method), jback.get_backend(method)
        state = tb.build(pc, _t(data["w"]), device="cpu", **inject)
        for q, u in ((8, None), (8, 3), (1, None)):
            assert tb.embedding_floats(state, pc, q, u) == \
                jb.embedding_floats(jstate, jpc, q, u), (q, u)
        assert tb.floats_bound(state, pc, 8) == jb.floats_bound(jstate, jpc,
                                                                 8)

    @pytest.mark.parametrize("method", ["mimps", "fmbe"])
    def test_device_build_and_refresh_equal_jax(self, data, method):
        """``build(device_index=True, block_multiple=8)``: the JAX build's
        block count, layout and (fmbe) per-block lambdas; ``refresh`` on a
        new embedding keeps every shape and equals a fresh build."""
        pc, jpc = _pc(reduced_config, method), _pc(j_reduced_config, method)
        jstate = jback.get_backend(method).build(
            jpc, jnp.asarray(data["w"]), jax.random.PRNGKey(1), device=True,
            block_multiple=8)
        tb = tback.get_backend(method)
        inject = dict(assign=_t(jstate.index.assign))
        if method == "fmbe":
            fm = jstate.fmbe.fm
            inject["feature_map"] = feature_map_from_numpy(
                *(np.asarray(a) for a in fm[:3]), p=fm.p, device="cpu")
        state = tb.build(pc, _t(data["w"]), device="cpu", device_index=True,
                         block_multiple=8, **inject)
        idx, jidx = state.index, jstate.index
        assert idx.n_blocks == jidx.n_blocks and idx.n_blocks % 8 == 0
        for name in ("v_blocks", "valid", "row_id", "slot_of_row"):
            np.testing.assert_array_equal(getattr(idx, name).numpy(),
                                          np.asarray(getattr(jidx, name)))
        if method == "fmbe":
            lam, jlam = state.fmbe.lambda_blocks, jstate.fmbe.lambda_blocks
            assert lam.shape == jlam.shape
            phi = np.abs(np.asarray(jfm.apply_feature_map(
                jstate.fmbe.fm, jnp.asarray(data["w"])))).sum(0)
            assert (np.abs(lam.numpy() - np.asarray(jlam)) <=
                    1e-4 * phi + 1e-6).all()
        w2 = data["w"][::-1].copy()
        refreshed = tb.refresh(state, pc, _t(w2), device="cpu",
                               block_multiple=8, **inject)
        fresh = tb.build(pc, _t(w2), device="cpu", device_index=True,
                         block_multiple=8, **inject)
        for a, b in zip(refreshed.index, fresh.index):
            assert a == b if isinstance(a, int) else torch.equal(a, b)
        assert refreshed.index.v_blocks.shape == idx.v_blocks.shape


class TestOps:
    def test_fused_topk_z_and_its_oracle_equal_jax(self, data):
        w, h = data["w"], data["h"]
        got = tops.fused_topk_z(_t(h), _t(w), K)
        ref = tops.topk_z_ref(_t(h), _t(w), K)
        for want in (jops.fused_topk_z(jnp.asarray(h), jnp.asarray(w), K),
                     jops.topk_z_ref(jnp.asarray(h), jnp.asarray(w), K)):
            for mine in (got, ref):
                np.testing.assert_allclose(mine[0].numpy(),
                                           np.asarray(want[0]), atol=ATOL)
                np.testing.assert_allclose(mine[1].numpy(),
                                           np.asarray(want[1]), atol=ATOL)
                np.testing.assert_array_equal(mine[2].numpy(),
                                              np.asarray(want[2]))

    def test_fused_fmbe_phi_and_z_equal_jax(self):
        fm = jfm.make_feature_map(jax.random.PRNGKey(4), 32, 96)
        tmap = feature_map_from_numpy(*(np.asarray(a) for a in fm[:3]),
                                      p=fm.p, device="cpu")
        rng = np.random.default_rng(8)
        x = rng.standard_normal((5, 32)).astype(np.float32)
        lam = rng.standard_normal((96,)).astype(np.float32)
        phi = tops.fused_fmbe_phi(tmap.omega, tmap.degree, tmap.coef, _t(x))
        jphi = np.asarray(jops.fused_fmbe_phi(fm.omega, fm.degree, fm.coef,
                                              jnp.asarray(x)))
        scale = np.abs(np.asarray(fm.coef))[None, :] * np.maximum(
            np.linalg.norm(x, axis=-1), 1.0)[:, None] ** np.asarray(
                fm.degree, np.float64)
        assert (np.abs(phi.numpy() - jphi) <=
                1e-4 * (np.abs(jphi) + scale)).all()
        z = tops.fused_fmbe_z(tmap.omega, tmap.degree, tmap.coef, _t(lam),
                              _t(x))
        jz = np.asarray(jops.fused_fmbe_z(fm.omega, fm.degree, fm.coef,
                                          jnp.asarray(lam), jnp.asarray(x)))
        terms = np.abs(jphi * lam).sum(-1)
        assert (np.abs(z.numpy() - jz) <= 1e-4 * terms + 1e-6).all()
