"""The port's index, plans and decodes against the JAX package on the same
numpy inputs (f32, CPU). The index layout and the plans must be equal; the
decodes agree to 1e-4 on log-values with equal top ids. The JAX k-means
assignment, the JAX tail-sample draws and, for FMBE, the JAX feature map
are injected into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode as jdec
from repro.core import feature_maps as jfm
from repro.core import mips as jmips
from repro.core.estimators import combine_head_tail_lse as j_combine
from repro.core.estimators import exact_log_z as j_exact_log_z
from repro_torch.core import decode as tdec
from repro_torch.core import mips as tmips
from repro_torch.core.estimators import combine_head_tail_lse, exact_log_z
from repro_torch.core.feature_maps import FMBEState
from repro_torch.interop import feature_map_from_numpy, ivf_from_numpy
from repro_torch.kernels.topk_z import NEG

ATOL = 1e-4
V, D, BR, C, N_PROBE, L, Q = 2048, 64, 128, 8, 4, 128, 6


def _clustered(seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, D))
    v = centers[rng.integers(0, 16, V)] + 0.5 * rng.standard_normal((V, D))
    v *= (1.0 + 2.0 / np.sqrt(1.0 + np.arange(V)))[:, None]
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * np.sqrt(D) * 0.35
    h = v[rng.integers(0, V, Q)] + 0.3 * rng.standard_normal((Q, D))
    return v.astype(np.float32), (0.5 * h).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    v, h = _clustered(0)
    j_index = jmips.build_ivf(jax.random.PRNGKey(1), jnp.asarray(v),
                              block_rows=BR, n_clusters=C)
    t_index = tmips.build_ivf(torch.from_numpy(v), block_rows=BR,
                              n_clusters=C,
                              assign=torch.from_numpy(np.array(j_index.assign)),
                              device="cpu")
    return v, h, j_index, t_index


def _tail_idx(key, n):
    """The tail draws of the JAX plan_tail for ``key``."""
    return torch.from_numpy(np.array(jax.random.randint(key, (L,), 0, n)))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


class TestIndex:
    def test_layout_bit_identical(self, built):
        _, _, j, t = built
        for name in ("v_blocks", "valid", "row_id", "slot_of_row"):
            a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert t.n == j.n and t.block_rows == j.block_rows
        np.testing.assert_allclose(t.block_centroids.numpy(),
                                   np.asarray(j.block_centroids), atol=1e-5)
        np.testing.assert_allclose(t.block_radius.numpy(),
                                   np.asarray(j.block_radius), atol=1e-4)

    def test_probe_batch_ids_equal(self, built):
        _, h, j, t = built
        _eq(tmips.probe_batch(t, torch.from_numpy(h), N_PROBE),
            jmips.probe_batch(j, jnp.asarray(h), N_PROBE))
        ids = tmips.probe_batch(t, torch.from_numpy(h), N_PROBE)
        _eq(tmips.head_count(t, ids), jmips.head_count(j, jnp.asarray(
            ids.numpy())))


    def test_ivf_from_numpy_carries_the_jax_index(self, built):
        _, h, j, t = built
        fields = {f: np.asarray(getattr(j, f)) for f in (
            "v_blocks", "valid", "row_id", "slot_of_row", "block_centroids",
            "block_radius", "assign")}
        c = ivf_from_numpy(n=j.n, block_rows=j.block_rows, device="cpu",
                           **fields)
        for name in ("v_blocks", "valid", "row_id", "slot_of_row",
                     "block_centroids", "block_radius", "assign"):
            _eq(getattr(c, name), fields[name])
        _eq(tmips.probe_batch(c, torch.from_numpy(h), N_PROBE),
            tmips.probe_batch(t, torch.from_numpy(h), N_PROBE))


class TestPlan:
    def test_plan_heads_equal(self):
        rng = np.random.default_rng(4)
        ids = rng.integers(0, 9, (5, 3)).astype(np.int32)
        ids[1] = ids[0]                               # duplicated probes
        for cap in (15, 12):
            t = tdec.plan_heads(torch.from_numpy(ids), cap)
            j = jdec.plan_heads(jnp.asarray(ids), cap)
            for a, b in zip(t, j):
                _eq(a, b)

    @pytest.mark.parametrize("use_active", [False, True])
    def test_make_plan_equal(self, built, use_active):
        _, h, j, t = built
        key = jax.random.PRNGKey(7)
        active = np.array([True, False, True, True, False, True])
        jp = jdec.make_plan(j, jnp.asarray(h), key, N_PROBE, L,
                            active=jnp.asarray(active) if use_active else None)
        tp = tdec.make_plan(t, torch.from_numpy(h), N_PROBE, L,
                            tail_idx=_tail_idx(key, V),
                            active=torch.from_numpy(active) if use_active
                            else None)
        for name in tdec.DecodePlan._fields:
            _eq(getattr(tp, name), getattr(jp, name))


class TestDecode:
    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("use_pallas", [True, False])
    def test_mimps_decode_matches(self, built, use_kernel, use_pallas):
        _, h, j, t = built
        key = jax.random.PRNGKey(11)
        jo = jdec.mimps_decode(j, jnp.asarray(h), key, n_probe=N_PROBE, l=L,
                               k=8, use_pallas=use_pallas)
        to = tdec.mimps_decode(t, torch.from_numpy(h), n_probe=N_PROBE, l=L,
                               k=8, use_kernel=use_kernel,
                               tail_idx=_tail_idx(key, V))
        for name in ("log_z", "head_lse", "tail_lse"):
            np.testing.assert_allclose(getattr(to, name).numpy(),
                                       np.asarray(getattr(jo, name)),
                                       atol=ATOL, err_msg=name)
        _eq(to.top_id[:, 0], jo.top_id[:, 0])
        _eq(to.k_eff, jo.k_eff)
        _eq(to.head_live, jo.head_live)

    def test_zero_survivor_query(self, built):
        """A query whose probe covers every block rejects every tail sample:
        tail_lse is -inf and log Ẑ is the exact head."""
        v, h, j, t = built
        nb = t.n_blocks
        key = jax.random.PRNGKey(2)
        jo = jdec.mimps_decode(j, jnp.asarray(h[:2]), key, n_probe=nb, l=L,
                               k=4, use_pallas=True)
        to = tdec.mimps_decode(t, torch.from_numpy(h[:2]), n_probe=nb, l=L,
                               k=4, tail_idx=_tail_idx(key, V))
        assert torch.isneginf(to.tail_lse).all()
        np.testing.assert_allclose(to.log_z.numpy(), np.asarray(jo.log_z),
                                   atol=ATOL)
        exact = torch.logsumexp(torch.from_numpy(h[:2] @ v.T), -1)
        np.testing.assert_allclose(to.log_z.numpy(), exact.numpy(),
                                   atol=ATOL)

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_exact_topk_decode_matches(self, built, use_kernel):
        v, h, _, _ = built
        jo = jdec.exact_topk_decode(jnp.asarray(v), jnp.asarray(h), k=8,
                                    use_pallas=use_kernel)
        to = tdec.exact_topk_decode(torch.from_numpy(v), torch.from_numpy(h),
                                    k=8, use_kernel=use_kernel)
        np.testing.assert_allclose(to.log_z.numpy(), np.asarray(jo.log_z),
                                   atol=ATOL)
        np.testing.assert_allclose(to.top_score.numpy(),
                                   np.asarray(jo.top_score), atol=ATOL)
        _eq(to.top_id, jo.top_id)
        _eq(to.k_eff, jo.k_eff)
        assert torch.isneginf(to.tail_lse).all()


@pytest.fixture(scope="module")
def sketch(built):
    """A JAX feature map and its block-partitioned sketch over the JAX
    index, and the port's copy of both."""
    _, _, j, _ = built
    fm = jfm.make_feature_map(jax.random.PRNGKey(4), D, 128)
    lam_b = jfm.build_fmbe_blocks(fm, j.v_blocks, j.valid)
    jstate = jfm.FMBEState(fm=fm, lambda_tilde=lam_b.sum(0),
                           lambda_blocks=lam_b)
    tstate = FMBEState(
        fm=feature_map_from_numpy(np.asarray(fm.omega), np.asarray(fm.degree),
                                  np.asarray(fm.coef), fm.p, device="cpu"),
        lambda_tilde=torch.from_numpy(np.array(jstate.lambda_tilde)),
        lambda_blocks=torch.from_numpy(np.array(lam_b)))
    return jstate, tstate


def _probe_decode(method, built, sketch, h, n_probe, key, use_kernel,
                  use_pallas, k=8):
    """(port DecodeOut, JAX DecodeOut) of ``method`` on queries h."""
    _, _, j, t = built
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    if method == "topk":
        return (tdec.topk_head_decode(t, th, n_probe=n_probe, k=k,
                                      use_kernel=use_kernel),
                jdec.topk_head_decode(j, jh, key, n_probe=n_probe, k=k,
                                      use_pallas=use_pallas))
    if method == "mince":
        return (tdec.mince_decode(t, th, n_probe=n_probe, l=L, k=k,
                                  use_kernel=use_kernel,
                                  tail_idx=_tail_idx(key, V)),
                jdec.mince_decode(j, jh, key, n_probe=n_probe, l=L, k=k,
                                  use_pallas=use_pallas))
    jstate, tstate = sketch
    return (tdec.fmbe_decode(tstate, t, th, n_probe=n_probe, k=k,
                             use_kernel=use_kernel),
            jdec.fmbe_decode(jstate, j, jh, key, n_probe=n_probe, k=k,
                             use_pallas=use_pallas))


def _assert_out(to, jo):
    """log-values to ATOL (equal -inf patterns), real top entries equal."""
    for name in ("log_z", "head_lse", "tail_lse"):
        a, b = getattr(to, name).numpy(), np.asarray(getattr(jo, name))
        np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b),
                                      err_msg=name)
        fin = ~np.isneginf(b)
        np.testing.assert_allclose(a[fin], b[fin], atol=ATOL, err_msg=name)
    real = np.asarray(jo.top_score) > NEG * 0.5
    np.testing.assert_array_equal(to.top_score.numpy() > NEG * 0.5, real)
    np.testing.assert_allclose(to.top_score.numpy()[real],
                               np.asarray(jo.top_score)[real], atol=ATOL)
    np.testing.assert_array_equal(to.top_id.numpy()[real],
                                  np.asarray(jo.top_id)[real])
    _eq(to.k_eff, jo.k_eff)
    _eq(to.head_live, jo.head_live)


class TestProbeDecodes:
    """topk, mince and fmbe through the union-scoring head: each branch of
    the port (kernel wrapper, plain) against each branch of the JAX
    package (Pallas in interpret mode, XLA)."""

    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("use_pallas", [True, False])
    @pytest.mark.parametrize("method", ["topk", "mince", "fmbe"])
    def test_matches_jax(self, built, sketch, method, use_kernel,
                         use_pallas):
        _, h, _, _ = built
        to, jo = _probe_decode(method, built, sketch, h, N_PROBE,
                               jax.random.PRNGKey(13), use_kernel,
                               use_pallas)
        _assert_out(to, jo)
        if method == "topk":
            torch.testing.assert_close(to.log_z, to.head_lse)
        if method != "mince":
            assert torch.isneginf(to.tail_lse).all()

    @pytest.mark.parametrize("method", ["topk", "mince", "fmbe"])
    def test_duplicate_and_odd_queries(self, built, sketch, method):
        """Five identical queries (the union collapses to one probe set, U
        == n_probe) and an odd Q of 5 distinct ones."""
        _, h, _, _ = built
        for hq in (np.repeat(h[:1], 5, 0), h[:5]):
            to, jo = _probe_decode(method, built, sketch, np.ascontiguousarray(
                hq), N_PROBE, jax.random.PRNGKey(17), True, True)
            _assert_out(to, jo)
        same, _ = _probe_decode(method, built, sketch, np.repeat(h[:1], 5, 0),
                                N_PROBE, jax.random.PRNGKey(17), True, True)
        assert int(same.head_live) == N_PROBE
        assert (same.log_z == same.log_z[0]).all()

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_mince_full_probe_takes_the_head(self, built, sketch, use_kernel):
        """n_probe == n_blocks rejects every tail sample: the guard returns
        head_lse, which is the exact log Z, with no NaN."""
        v, h, _, t = built
        to, jo = _probe_decode("mince", built, sketch, h[:3], t.n_blocks,
                               jax.random.PRNGKey(2), use_kernel, True)
        assert not torch.isnan(to.log_z).any()
        assert torch.isneginf(to.tail_lse).all()
        torch.testing.assert_close(to.log_z, to.head_lse, rtol=0, atol=0)
        np.testing.assert_allclose(to.log_z.numpy(), np.asarray(jo.log_z),
                                   atol=ATOL)
        exact = torch.logsumexp(torch.from_numpy(h[:3] @ v.T), -1)
        np.testing.assert_allclose(to.log_z.numpy(), exact.numpy(),
                                   atol=ATOL)

    def test_mince_equals_mimps_anchor(self, built):
        """The closed-form MINCE estimate is the Eq. 5 anchor: the MIMPS
        log Ẑ on the same plan and draws."""
        _, h, _, t = built
        tail = _tail_idx(jax.random.PRNGKey(21), V)
        th = torch.from_numpy(h)
        mi = tdec.mimps_decode(t, th, n_probe=N_PROBE, l=L, k=4,
                               tail_idx=tail)
        mc = tdec.mince_decode(t, th, n_probe=N_PROBE, l=L, k=4,
                               tail_idx=tail)
        np.testing.assert_allclose(mc.log_z.numpy(), mi.log_z.numpy(),
                                   atol=ATOL)
        _eq(mc.top_id, mi.top_id)

    def test_head_only_plan_is_empty_tail(self, built):
        """l = 0 gives well-shaped empty tail arrays, as in JAX."""
        _, h, j, t = built
        key = jax.random.PRNGKey(5)
        tp = tdec.make_plan(t, torch.from_numpy(h), N_PROBE, 0)
        jp = jdec.make_plan(j, jnp.asarray(h), key, N_PROBE, 0)
        assert tp.tail_blocks.shape == (0,)
        assert tp.tail_accept.shape == (h.shape[0], 0)
        for name in tdec.DecodePlan._fields:
            _eq(getattr(tp, name), getattr(jp, name))

    def test_union_head_scores_matches(self, built):
        """The Pallas union head (interpret mode) and the port's: equal
        masks, equal scores at live slots, zeros at pad slots."""
        _, h, j, t = built
        th = torch.from_numpy(h)
        plan = tdec.make_plan(t, th, N_PROBE, 0)
        jplan = jdec.make_plan(j, jnp.asarray(h), jax.random.PRNGKey(0),
                               N_PROBE, 0)
        live = int(plan.head_live)
        scores, mask = tdec.union_head_scores(t, th, plan)
        js, jm = jdec.union_head_scores(j, jnp.asarray(h), jplan, True)
        _eq(mask, jm)
        np.testing.assert_allclose(scores.numpy(), np.asarray(js),
                                   atol=ATOL)
        assert (scores[:, live:] == 0).all()

    def test_empty_head_keeps_the_sentinel(self, built):
        """A query with no member row: head LSE is the logsumexp over NEG
        entries (about -1e30, finite) as in JAX, and every top entry is
        filler; the other query is unaffected."""
        _, h, j, t = built
        plan = tdec.make_plan(t, torch.from_numpy(h[:2]), N_PROBE, 0)
        scores, mask = tdec.union_head_scores(t, torch.from_numpy(h[:2]),
                                              plan)
        mask[0] = False
        q = scores.shape[0]
        hl, tv, _ = tdec._head_topk(t, plan.head_ids, scores.reshape(q, -1),
                                    mask.reshape(q, -1), 4)
        jl, jv, _ = jdec._head_topk(j, jnp.asarray(plan.head_ids.numpy()),
                                    jnp.asarray(scores.reshape(q, -1).numpy()),
                                    jnp.asarray(mask.reshape(q, -1).numpy()),
                                    4)
        assert np.isfinite(hl[0].item()) and hl[0].item() < -1e29
        np.testing.assert_allclose(hl.numpy(), np.asarray(jl), rtol=1e-6)
        assert (tv[0] == np.float32(NEG)).all()
        np.testing.assert_allclose(tv[1].numpy(), np.asarray(jv)[1],
                                   atol=ATOL)


class TestSelfnorm:
    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_matches_jax(self, built, use_kernel):
        v, h, _, _ = built
        jo = jdec.selfnorm_decode(jnp.asarray(v), jnp.asarray(h), k=8,
                                  use_pallas=use_kernel)
        to = tdec.selfnorm_decode(torch.from_numpy(v), torch.from_numpy(h),
                                  k=8, use_kernel=use_kernel)
        assert (to.log_z == 0).all() and (np.asarray(jo.log_z) == 0).all()
        np.testing.assert_allclose(to.head_lse.numpy(),
                                   np.asarray(jo.head_lse), atol=ATOL)
        _eq(to.top_id, jo.top_id)


class TestCombine:
    def test_exact_log_z_matches(self, built):
        v, h, _, _ = built
        np.testing.assert_allclose(
            exact_log_z(torch.from_numpy(v), torch.from_numpy(h[0])).numpy(),
            np.asarray(j_exact_log_z(jnp.asarray(v), jnp.asarray(h[0]))),
            atol=ATOL)

    @pytest.mark.parametrize("case", [
        (1.5, 0.3, 100.0, 10.0),                 # ordinary
        (1.5, float("-inf"), 100.0, 10.0),       # no surviving sample
        (1.5, 0.3, 0.0, 10.0),                   # empty tail population
        (1.5, 0.3, 100.0, 0.0),                  # zero survivors counted
        (float("-inf"), 0.3, 100.0, 10.0),       # empty head
        (-1e30, -1e30, 5.0, 5.0),                # sentinels on both sides
    ])
    def test_guard_cases_match(self, case):
        args = [np.array([x], np.float32) for x in case]
        got = combine_head_tail_lse(*[torch.from_numpy(a) for a in args])
        want = np.asarray(j_combine(*[jnp.asarray(a) for a in args]))
        assert not np.isnan(got.numpy()).any()
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
