"""The port's LSH index, plan, probe kernel (plain version) and decode
against the JAX package on the same numpy inputs (CPU; JAX's ``lsh_probe``
in interpret mode). The hyperplanes and tail draws of the JAX package are
injected into the port.

Exactness: codes, buckets and slots equal, except that a code may differ
where its projection lies within 1e-5 of 0 relative to |x| |proj row| (the
port projects in f64, the JAX package in f32); plans equal (tail bias and
accepted mass to 1e-5); LSEs and log Ẑ to 1e-4; top ids equal wherever the
gap to the neighbouring scores exceeds 1e-4; the port's inverse-CDF sampler
equal to JAX's draws except where u * cdf[-1] lies within 1e-6 relative of
a CDF step; probed-block scores to 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PartitionConfig as JPartitionConfig
from repro.core import backends as jback
from repro.core import lsh as jlsh
from repro.kernels import ops as jops
from repro.kernels.lsh_probe import lsh_probe as j_lsh_probe
from repro.kernels.lsh_probe import lsh_probe_ref as j_lsh_probe_ref
from repro_torch.configs.base import PartitionConfig
from repro_torch.core import backends as tback
from repro_torch.core import lsh as tlsh
from repro_torch.interop import lsh_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ivf_score import (QT, ivf_score, ivf_score_plain,
                                          ivf_score_tiles_plain,
                                          tile_unions_plain)
from repro_torch.kernels.lsh_probe import (hash_codes, lsh_probe,
                                          lsh_probe_plain, lsh_query_codes,
                                          probe_launch)
from repro_torch.kernels.topk_z import NEG

ATOL = 1e-4
CODE_REL = 1e-5
V, D, Q, L_TAIL = 2048, 32, 8, 128


def _clustered(seed, v=V, d=D, q=Q):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d))
    w = centers[rng.integers(0, 16, v)] + 0.5 * rng.standard_normal((v, d))
    w *= (1.0 + 2.0 / np.sqrt(1.0 + np.arange(v)))[:, None]
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * np.sqrt(d) * 0.35
    h = 0.4 * rng.standard_normal((q, d))
    return w.astype(np.float32), h.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j_index(w, seed=3, **kw):
    kw.setdefault("n_bits", 5)
    kw.setdefault("n_tables", 6)
    kw.setdefault("bucket_cap", 2048)
    return jlsh.build_lsh_device(jax.random.PRNGKey(seed), jnp.asarray(w),
                                 **kw)


def _port(jidx):
    return lsh_from_numpy(*(np.asarray(a) for a in jidx), device="cpu")


def _assert_codes(got, want, proj, x, aug=None):
    """Codes equal, or the differing sign bits' projections within CODE_REL
    of 0 relative to |x| |proj row|."""
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    if not diff.any():
        return
    proj = np.asarray(proj, np.float64)
    ltab, k, dp = proj.shape
    x = np.asarray(x, np.float64)
    s = x @ proj[..., :x.shape[1]].reshape(ltab * k, -1).T
    if aug is not None:
        s = s + np.asarray(aug, np.float64)[:, None] * \
            proj[..., -1].reshape(-1)[None, :]
    scale = np.linalg.norm(x, axis=1)[:, None] * \
        np.linalg.norm(proj.reshape(ltab * k, dp), axis=1)[None, :]
    rel = np.abs(s / scale).reshape(-1, ltab, k)
    for n, t in zip(*np.nonzero(diff)):
        flipped = [b for b in range(k)
                   if (got[n, t] >> b & 1) != (want[n, t] >> b & 1)]
        assert all(rel[n, t, b] <= CODE_REL for b in flipped), (n, t)


def _assert_lse(got, want, atol=ATOL):
    """-inf (or the logsumexp-over-NEG sentinel, about -1e30) where the
    other side has one; elsewhere within atol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    empty = want < -1e29
    np.testing.assert_array_equal(got < -1e29, empty)
    np.testing.assert_allclose(got[~empty], want[~empty], atol=atol)


def _assert_top(tv, ti, jv, ji, atol=ATOL):
    """Real entries' scores within atol; their ids equal wherever the gap to
    both neighbouring scores exceeds atol."""
    tv, ti, jv, ji = (np.asarray(a) for a in (tv, ti, jv, ji))
    real = jv > NEG * 0.5
    np.testing.assert_array_equal(tv > NEG * 0.5, real)
    np.testing.assert_allclose(tv[real], jv[real], atol=atol)
    checked = 0
    for q in range(jv.shape[0]):
        for j in range(jv.shape[1]):
            if not real[q, j]:
                continue
            up = jv[q, j - 1] - jv[q, j] if j else np.inf
            down = (jv[q, j] - jv[q, j + 1]
                    if j + 1 < jv.shape[1] and real[q, j + 1] else np.inf)
            if up > atol and down > atol:
                assert ti[q, j] == ji[q, j], (q, j)
                checked += 1
    assert checked > 0


@pytest.fixture(scope="module")
def data():
    return _clustered(0)


class TestIndex:
    @pytest.mark.parametrize("n_bits,n_tables,cap,mips,beta", [
        (5, 6, 2048, 0.0, 8.0),       # no overflow, angle-only
        (4, 8, 64, 0.0, 16.0),        # buckets overflow: dropped rows
        (6, 4, 0, 1.2, 0.0),          # auto capacity, MIPS augmentation
    ])
    def test_build_with_injected_proj_matches_jax(self, data, n_bits,
                                                  n_tables, cap, mips, beta):
        w, _ = data
        j = _j_index(w, n_bits=n_bits, n_tables=n_tables, bucket_cap=cap,
                     mips_scale=mips, tail_beta=beta)
        t = tlsh.build_lsh_device(
            _t(w), n_bits=n_bits, n_tables=n_tables, bucket_cap=cap,
            mips_scale=mips, tail_beta=beta, proj=_t(j.proj), device="cpu")
        aug = tlsh._row_aug(_t(w), t.aug_scale).numpy()
        _assert_codes(t.codes, j.codes, j.proj, w, aug)
        # the tables packed from the same codes equal JAX's bit for bit
        packed = [tlsh._pack_one_table(_t(j.codes)[:, i], 1 << n_bits,
                                       t.bucket_cap) for i in range(n_tables)]
        np.testing.assert_array_equal(
            torch.stack([b for b, _ in packed]).numpy(), np.asarray(j.buckets))
        np.testing.assert_array_equal(
            torch.stack([s for _, s in packed], 1).numpy(),
            np.asarray(j.slot_of_row))
        if torch.equal(t.codes, _t(j.codes)):
            assert torch.equal(t.buckets, _t(j.buckets))
            assert torch.equal(t.slot_of_row, _t(j.slot_of_row))
        for f in ("aug_scale", "tail_scale", "tail_logits"):
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       np.asarray(getattr(j, f)), rtol=1e-5,
                                       atol=1e-6, err_msg=f)
        assert (t.n, t.n_tables, t.n_bits, t.n_buckets, t.bucket_cap) == \
            (j.n, j.n_tables, j.n_bits, j.n_buckets, j.bucket_cap)
        if cap == 64:
            assert (t.slot_of_row < 0).any()          # overflow exercised

    def test_hash_codes_of_queries_match_jax(self, data):
        w, h = data
        j = _j_index(w, n_bits=8, n_tables=8)
        got = hash_codes(_t(j.proj), _t(h))
        _assert_codes(got, jlsh.hash_codes(j.proj, jnp.asarray(h)), j.proj,
                      h)
        np.testing.assert_array_equal(lsh_query_codes(_t(h), _t(j.proj)),
                                      got)

    def test_bucket_cap_and_draws(self, data):
        for n, k in ((151936, 8), (2048, 8), (100, 4), (5, 24)):
            assert tlsh.lsh_bucket_cap(n, k) == jlsh.lsh_bucket_cap(n, k)
        w, _ = data
        g = torch.Generator().manual_seed(0)
        idx = tlsh.build_lsh_device(_t(w), n_bits=6, n_tables=3,
                                    generator=g, device="cpu")
        assert idx.proj.shape == (3, 6, D + 1)
        again = tlsh.build_lsh_device(
            _t(w), n_bits=6, n_tables=3,
            generator=torch.Generator().manual_seed(0), device="cpu")
        assert torch.equal(idx.proj, again.proj)
        with pytest.raises(ValueError):
            tlsh.build_lsh_device(_t(w), device="cpu")    # nothing to draw
        with pytest.raises(ValueError):
            tlsh.build_lsh_device(_t(w), n_bits=25, generator=g,
                                  device="cpu")


class TestPlan:
    @pytest.mark.parametrize("strategy", ["compare", "scatter"])
    @pytest.mark.parametrize("cap,active", [(0, None), (96, None),
                                            (0, [1, 1, 0, 1, 0, 1, 1, 1])])
    def test_plan_matches_jax(self, data, monkeypatch, strategy, cap,
                              active):
        w, h = data
        j = _j_index(w, n_bits=4, n_tables=8, bucket_cap=64, tail_beta=16.0)
        if strategy == "scatter":
            monkeypatch.setattr(tlsh, "_BCAST_COLLIDE_LIMIT", 0)
        act = None if active is None else np.array(active, bool)
        kd = jax.random.PRNGKey(8)
        jp = jlsh.lsh_plan(j, jnp.asarray(h), kd, L_TAIL, cand_cap=cap,
                           active=None if act is None else jnp.asarray(act))
        tp = tlsh.lsh_plan(_port(j), _t(h), L_TAIL, cand_cap=cap,
                           tail_ids=_t(jp.tail_ids),
                           active=None if act is None else _t(act))
        for f in ("qcodes", "occ_q", "cand_rows", "cand_live", "member",
                  "k_eff", "tail_ids", "tail_accept"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)),
                                          err_msg=f)
        for f in ("tail_bias", "n_accept"):
            np.testing.assert_allclose(getattr(tp, f).numpy(),
                                       np.asarray(getattr(jp, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
        assert 0 < int(tp.cand_live)

    def test_occupancy_strategies_bit_identical(self, data):
        w, h = data
        t = _port(_j_index(w, n_bits=4, n_tables=8, bucket_cap=64))
        qcodes = hash_codes(t.proj, _t(h))
        a = tlsh._occupancy_compare(t, qcodes)
        b = tlsh._occupancy_scatter(t, qcodes)
        assert torch.equal(a, b) and a.any()

    @pytest.mark.parametrize("beta,seed", [(0.0, 1), (8.0, 2), (48.0, 3)])
    def test_inverse_cdf_sampler_matches_jax(self, data, beta, seed):
        w, h = data
        j = _j_index(w, tail_beta=beta)
        key = jax.random.PRNGKey(seed)
        l = 4096
        jp = jlsh.lsh_plan(j, jnp.asarray(h), key, l)
        u = np.asarray(jax.random.uniform(key, (l,)))
        logp = tlsh._tail_log_probs(_port(j))
        got = tlsh.inverse_cdf_sample(logp, _t(u)).numpy()
        want = np.asarray(jp.tail_ids)
        cdf = np.cumsum(np.exp(logp.numpy().astype(np.float64)))
        for i in np.nonzero(got != want)[0]:
            lo = min(got[i], want[i])
            assert abs(got[i] - want[i]) == 1, i
            assert abs(u[i] * cdf[-1] - cdf[lo]) <= 1e-6 * cdf[-1], i
        assert (got == want).mean() > 0.99

    def test_generator_draws_are_reproducible(self, data):
        w, h = data
        t = _port(_j_index(w))
        a, b = (tlsh.lsh_plan(t, _t(h), 64,
                              generator=torch.Generator().manual_seed(7))
                for _ in range(2))
        assert torch.equal(a.tail_ids, b.tail_ids)
        assert a.tail_ids.min() >= 0 and a.tail_ids.max() < V


def _probe_inputs(w, h, j, variant, dtype):
    """(JAX lsh_probe arguments, port lsh_probe arguments) for one plan."""
    t = _port(j)
    kd = jax.random.PRNGKey(21)
    jp = jlsh.lsh_plan(j, jnp.asarray(h), kd, L_TAIL)
    rows = np.asarray(jp.cand_rows)
    live = int(jp.cand_live)
    accept = np.asarray(jp.tail_accept)
    if variant == "dense":
        rows, live = np.arange(V, dtype=np.int32), V
    elif variant == "empty":
        live = 0
    elif variant == "no_tail":
        accept = np.zeros_like(accept)
        accept[0, 0] = True          # query 0 accepts one sample, others none
    wj = jnp.asarray(w, dtype)
    hj = jnp.asarray(h, dtype)
    codes = np.asarray(j.codes)
    ok = np.asarray(j.slot_of_row) >= 0
    tail_ids = np.asarray(jp.tail_ids)
    jargs = (wj[rows].astype(jnp.float32), hj, j.proj, jnp.asarray(rows),
             jnp.asarray(codes[rows]), jnp.asarray(ok[rows]), live,
             wj[tail_ids].astype(jnp.float32), jnp.asarray(accept),
             jp.tail_bias)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    targs = (_t(w).to(tdt), _t(h).to(tdt), t.proj, _t(rows),
             torch.tensor(live, dtype=torch.int32), t.codes, t.slot_of_row,
             _t(tail_ids), _t(accept), _t(jp.tail_bias))
    return jargs, targs


class TestProbe:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    @pytest.mark.parametrize("variant,k", [("plan", 4), ("dense", 1),
                                           ("empty", 8), ("no_tail", 4)])
    def test_plain_matches_jax_kernel_and_ref(self, data, dtype, variant, k):
        w, h = data
        j = _j_index(w, n_bits=4, n_tables=8, bucket_cap=64)
        jargs, targs = _probe_inputs(w, h, j, variant, dtype)
        got = lsh_probe_plain(*targs, k=k)
        via_wrapper = lsh_probe(*targs, k=k)          # CPU: the plain version
        for a, b in zip(got, via_wrapper):
            assert torch.equal(a, b)
        for jout in (j_lsh_probe(*jargs, k=k, cand_tile=128, tail_tile=32),
                     j_lsh_probe_ref(*jargs, k=k)):
            hl, tl, tv, ti, cnt = (np.asarray(a) for a in jout)
            np.testing.assert_array_equal(got[4].numpy(), cnt)
            _assert_lse(got[0].numpy(), hl)
            _assert_lse(got[1].numpy(), tl)
            if variant != "empty":
                _assert_top(got[2], got[3], tv, ti)
        hl, tl, tv, ti, cnt = got
        assert cnt.dtype == torch.int32 and cnt.shape == (Q, targs[3].shape[0])
        if variant == "empty":
            assert bool(torch.isneginf(hl).all()) and not cnt.any()
            assert bool((tv == np.float32(NEG)).all()) and not ti.any()
        if variant == "no_tail":
            assert bool(torch.isneginf(tl[1:]).all())
            assert bool(torch.isfinite(tl[0]))
        live = int(targs[4])
        assert not cnt[:, live:].any()

    @pytest.mark.parametrize("branch", ["trimmed", "dense"])
    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_decode_matches_jax(self, data, branch, use_kernel):
        w, h = data
        j = _j_index(w, n_bits=4, n_tables=8, bucket_cap=64, tail_beta=16.0)
        kd = jax.random.PRNGKey(8)
        plan = jlsh.lsh_plan(j, jnp.asarray(h), kd, L_TAIL)
        live = int(plan.cand_live)
        cap = live + 64 if branch == "trimmed" else max(8, live // 4)
        assert live + 64 < V          # the trimmed branch is a real choice
        jo = jlsh.lsh_decode(j, jnp.asarray(w), jnp.asarray(h), kd,
                             l=L_TAIL, k=4, cand_cap=cap)
        to = tlsh.lsh_decode(_port(j), _t(w), _t(h), l=L_TAIL, k=4,
                             cand_cap=cap, use_kernel=use_kernel,
                             tail_ids=_t(plan.tail_ids))
        resolved = tlsh.resolve_cand_cap(cap, _port(j), V)
        assert (int(to.head_live) > resolved) == (branch == "dense")
        np.testing.assert_allclose(to.log_z.numpy(), np.asarray(jo.log_z),
                                   atol=ATOL)
        _assert_lse(to.head_lse.numpy(), np.asarray(jo.head_lse))
        _assert_lse(to.tail_lse.numpy(), np.asarray(jo.tail_lse))
        _assert_top(to.top_score, to.top_id, jo.top_score, jo.top_id)
        np.testing.assert_array_equal(to.k_eff.numpy(), np.asarray(jo.k_eff))

    def test_launch_refuses_cpu_tensors(self, data):
        """The probe's launch function takes CUDA tensors only: the CPU
        path is the wrapper's plain version, never a launch."""
        w, h = data
        j = _j_index(w, n_bits=4, n_tables=8, bucket_cap=64)
        _, targs = _probe_inputs(w, h, j, "plan", jnp.float32)
        with pytest.raises(ValueError, match="one GPU"):
            probe_launch(*targs, k=4)

    def test_decode_needs_a_tail_sample(self, data):
        w, h = data
        with pytest.raises(ValueError, match="tail sample"):
            tlsh.lsh_decode(_port(_j_index(w)), _t(w), _t(h), l=0,
                            tail_ids=torch.zeros(0, dtype=torch.int32))


class TestMaintenance:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_update_rows_then_probe_equals_fresh_pack(self, data, seed):
        """The JAX gate's twin: update_rows followed by a probe equals a
        fresh pack of the updated embedding; the update also equals the JAX
        package's bit for bit."""
        w, h = data
        j = _j_index(w)
        rng = np.random.default_rng(100 + seed)
        rows = rng.choice(V, 64, replace=False).astype(np.int32)
        w2 = w.copy()
        w2[rows] += 0.3 * rng.standard_normal((64, D)).astype(np.float32)
        t = _port(j)
        upd = tlsh.update_rows(t, _t(w2), _t(rows))
        fresh = tlsh.pack_lsh(t.proj, _t(w2), t.aug_scale, t.tail_scale,
                              bucket_cap=t.bucket_cap)
        assert torch.equal(upd.codes, fresh.codes)
        np.testing.assert_allclose(upd.tail_logits.numpy(),
                                   fresh.tail_logits.numpy(), atol=1e-6)
        for tb in range(t.n_tables):
            a, b = upd.buckets[tb].numpy(), fresh.buckets[tb].numpy()
            for bk in range(t.n_buckets):
                assert set(a[bk][a[bk] >= 0]) == set(b[bk][b[bk] >= 0])
        jupd = jlsh.update_rows(j, jnp.asarray(w2), jnp.asarray(rows))
        for f in ("codes", "buckets", "slot_of_row"):
            np.testing.assert_array_equal(getattr(upd, f).numpy(),
                                          np.asarray(getattr(jupd, f)))
        assert torch.equal(t.codes, _port(j).codes)   # input left alone
        ids = torch.randint(0, V, (L_TAIL,),
                            generator=torch.Generator().manual_seed(seed))
        pa = tlsh.lsh_plan(upd, _t(h), L_TAIL, tail_ids=ids)
        pb = tlsh.lsh_plan(fresh, _t(h), L_TAIL, tail_ids=ids)
        assert int(pa.cand_live) > 0
        for f in ("occ_q", "cand_rows", "cand_live", "member", "k_eff",
                  "tail_ids", "tail_accept"):
            assert torch.equal(getattr(pa, f), getattr(pb, f)), f
        oa = tlsh.lsh_decode(upd, _t(w2), _t(h), l=L_TAIL, tail_ids=ids)
        ob = tlsh.lsh_decode(fresh, _t(w2), _t(h), l=L_TAIL, tail_ids=ids)
        np.testing.assert_allclose(oa.log_z.numpy(), ob.log_z.numpy(),
                                   atol=1e-6)
        assert torch.equal(oa.top_id, ob.top_id)

    def test_rehash_matches_jax(self, data):
        w, _ = data
        j = _j_index(w)
        t = _port(j)
        new, m = tlsh.rehash_lsh(t, _t(w * 1.5))
        assert float(m["churn"]) == 0.0
        assert torch.equal(new.buckets, t.buckets)
        w2 = w + 0.2 * np.random.default_rng(4).standard_normal(
            w.shape).astype(np.float32)
        new, m = tlsh.rehash_lsh(t, _t(w2), mips_scale=1.1, tail_beta=4.0)
        jnew, jm = jlsh.rehash_lsh(j, jnp.asarray(w2), mips_scale=1.1,
                                   tail_beta=4.0)
        np.testing.assert_array_equal(new.buckets.numpy(),
                                      np.asarray(jnew.buckets))
        for f in ("churn", "drift"):
            np.testing.assert_allclose(float(m[f]), float(jm[f]), rtol=1e-6)
            assert float(m[f]) > 0


class TestEstimators:
    def test_collision_log_prob_and_sns_match_jax(self):
        w, h = _clustered(5, v=512, d=16, q=2)
        j = _j_index(w, seed=700, n_bits=4, n_tables=4, bucket_cap=512,
                     mips_scale=1.1)
        t = _port(j)
        np.testing.assert_allclose(
            tlsh.collision_log_prob(t, _t(h), _t(w)).numpy(),
            np.asarray(jlsh.collision_log_prob(j, jnp.asarray(h),
                                               jnp.asarray(w))),
            atol=ATOL)
        np.testing.assert_allclose(
            tlsh.sns_log_z(t, _t(w), _t(h)).numpy(),
            np.asarray(jlsh.sns_log_z(j, jnp.asarray(w), jnp.asarray(h))),
            atol=ATOL)


class TestBackend:
    def test_registered_skip_and_embedding_floats(self, data):
        w, h = data
        backend = tback.get_backend("lsh")
        cfg, jcfg = (P(method="lsh", lsh_bits=4, l=64)
                     for P in (PartitionConfig, JPartitionConfig))
        jstate = jback.get_backend("lsh").build(jcfg, jnp.asarray(w),
                                                jax.random.PRNGKey(3))
        proj = _t(jstate.lsh.proj)
        state = backend.build(cfg, _t(w), lsh_proj=proj, device="cpu")
        assert torch.equal(state.lsh.buckets, _port(jstate.lsh).buckets)
        for u in (None, 100):
            assert backend.embedding_floats(state, cfg, Q, u) == \
                jback.get_backend("lsh").embedding_floats(jstate, jcfg, Q, u)
        small = backend.build(cfg, _t(w[:63]), lsh_proj=proj, device="cpu")
        assert small.lsh is None                      # 63 < 4 * 2**4 rows
        out = backend.decode(small, _t(h), cfg, k=2)
        exact = torch.logsumexp(_t(h) @ _t(w[:63]).T, -1)
        np.testing.assert_allclose(out.log_z.numpy(), exact.numpy(),
                                   atol=ATOL)
        assert backend.embedding_floats(small, cfg, Q) == 63 * D + Q * D


def _probe_ids(rng, q, p, nb, kind):
    """(q, p) int32 probe ids: uniform draws ("random"), each query's odd
    slots repeating its even ones ("dup"), every query on one block
    ("one"), or all distinct ("distinct", nb >= q * p)."""
    if kind == "distinct":
        return rng.permutation(nb)[:q * p].reshape(q, p).astype(np.int32)
    if kind == "one":
        return np.full((q, p), rng.integers(0, nb), dtype=np.int32)
    ids = rng.integers(0, nb, (q, p)).astype(np.int32)
    if kind == "dup":
        ids[:, 1::2] = ids[:, 0:p - 1:2]
    return ids


@pytest.mark.parametrize("q,p,br,nb,kind", [
    pytest.param(8, 16, 128, 40, "random", id="8-16-128-40"),
    pytest.param(1, 1, 50, 3, "random", id="1-1-50-3"),
    pytest.param(5, 3, 37, 9, "random", id="5-3-37-9"),
    (20, 40, 16, 60, "random"),       # three tiles, the last of 4 queries
    (8, 16, 16, 40, "dup"),           # a block twice in one query
    (20, 16, 16, 30, "one"),          # every query probes one block
    (8, 16, 16, 200, "distinct"),     # no block shared
    (1, 40, 8, 50, "dup"),            # one query, two mask words
])
def test_ivf_block_scores_match_jax(q, p, br, nb, kind):
    """The port's probed-block scores, the plain one and the per-tile
    decomposition its kernels compute (each tile's union of probes scored
    once, scattered through the probe masks), against the JAX kernel (in
    interpret mode) and its reference, to 1e-5."""
    rng = np.random.default_rng(q * 100 + p)
    w_blocks = rng.standard_normal((nb, br, D)).astype(np.float32)
    h = rng.standard_normal((q, D)).astype(np.float32)
    ids = _probe_ids(rng, q, p, nb, kind)
    want = np.asarray(jops.ivf_block_scores(jnp.asarray(w_blocks),
                                            jnp.asarray(h), jnp.asarray(ids)))
    ref = np.asarray(jops.ivf_score_ref(jnp.asarray(w_blocks),
                                        jnp.asarray(h), jnp.asarray(ids)))
    np.testing.assert_allclose(ref, want, atol=1e-5)
    for fn in (ivf_score_plain, ivf_score, tops.ivf_block_scores,
               tops.ivf_score_ref, ivf_score_tiles_plain):
        got = fn(_t(w_blocks), _t(h), _t(ids))
        assert got.shape == (q, p, br) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the per-tile unions: sorted, deduplicated, each probe in one mask bit
    uids, live, masks = tile_unions_plain(_t(ids), nb)
    n_tiles = -(-q // QT)
    assert uids.shape == (n_tiles, min(QT * p, nb))
    assert live.shape == (n_tiles,)
    assert masks.shape == (n_tiles, uids.shape[1], QT, -(-p // 32))
    for t in range(n_tiles):
        tile = ids[t * QT:(t + 1) * QT]
        n = int(live[t])
        np.testing.assert_array_equal(uids[t, :n].numpy(), np.unique(tile))
        assert (uids[t, n:] == uids[t, n - 1]).all()
        bits = (masks[t].long()[..., None] >> torch.arange(32)) & 1
        bits = bits.reshape(*masks.shape[1:3], -1)          # (U, QT, 32 W)
        assert (bits.sum(0)[:tile.shape[0], :p] == 1).all()
        assert not bits[n:].any() and not bits[:, tile.shape[0]:].any()
        assert not bits[:, :, p:].any()
        for qq, j in np.ndindex(*tile.shape):
            assert uids[t, bits[:, qq, j].argmax()] == tile[qq, j]


def test_ops_ivf_score_ref_reexports_the_plain_version():
    """``ops.ivf_score_ref`` is ``ivf_score_plain``, as the JAX package's
    ``ops.ivf_score_ref`` is its reference, and the two agree."""
    assert tops.ivf_score_ref is ivf_score_plain
    rng = np.random.default_rng(3)
    w_blocks = rng.standard_normal((6, 9, D)).astype(np.float32)
    h = rng.standard_normal((3, D)).astype(np.float32)
    ids = rng.integers(0, 6, (3, 4)).astype(np.int32)
    want = np.asarray(jops.ivf_score_ref(jnp.asarray(w_blocks),
                                         jnp.asarray(h), jnp.asarray(ids)))
    got = tops.ivf_score_ref(_t(w_blocks), _t(h), _t(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_tile_unions_skip_out_of_range_ids():
    """Ids outside [0, nb) take no union slot and no mask bit, and their
    rows of the per-tile decomposition are NaN; a tile with no valid id has
    live count 0."""
    rng = np.random.default_rng(7)
    nb, br = 12, 8
    w_blocks = _t(rng.standard_normal((nb, br, D)).astype(np.float32))
    h = _t(rng.standard_normal((12, D)).astype(np.float32))
    ids = rng.integers(0, nb, (12, 5)).astype(np.int32)
    ids[0, 1], ids[3, 4] = -1, nb
    ids[8:] = -1                                        # the second tile
    uids, live, masks = tile_unions_plain(_t(ids), nb)
    assert int(live[1]) == 0 and not masks[1].any() and not uids[1].any()
    valid = (ids >= 0) & (ids < nb)
    np.testing.assert_array_equal(uids[0, :int(live[0])].numpy(),
                                  np.unique(ids[:8][valid[:8]]))
    n_bits = ((masks[0].long()[..., None] >> torch.arange(32)) & 1).sum()
    assert n_bits == valid[:8].sum()
    got = ivf_score_tiles_plain(w_blocks, h, _t(ids))
    bad = torch.from_numpy(~valid)
    assert got[bad].isnan().all() and not got[~bad].isnan().any()
    want = ivf_score_plain(w_blocks, h, _t(np.where(valid, ids, 0)))
    torch.testing.assert_close(got[~bad], want[~bad], atol=1e-5, rtol=0)
