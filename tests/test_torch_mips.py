"""The port's fixed-capacity IVF index lifecycle and its decode-plan helpers
against the JAX package on the same numpy inputs (f32, CPU): ``pack_ivf``,
``build_ivf_device``, ``refresh_ivf``, ``probe``, ``gather_scores``,
``exact_top_k``, ``pad_ivf_blocks``, ``head_row_table``, ``tail_row_ids``
and the ``head_cap`` trim of the plain decode branches. The JAX k-means
assignment and tail draws are injected. Layouts (rows, masks, ids, slots,
assignments) must be equal bit for bit; centroids agree to 1e-5 and radii
to 1e-4 (f32 sums in another order), scores and log-values to 1e-5 and
1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode as jdec
from repro.core.kmeans import centroids_from_assign as j_centroids
from repro.core.kmeans import kmeans_step as j_kmeans_step
from repro.core import mips as jmips
from repro_torch.core import decode as tdec
from repro_torch.core import mips as tmips
from repro_torch.interop import ivf_from_numpy

V, D, BR, C, Q = 2048, 64, 64, 8, 6
LAYOUT = ("v_blocks", "valid", "row_id", "slot_of_row", "assign")


def _clustered(seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, D))
    v = centers[rng.integers(0, 16, V)] + 0.5 * rng.standard_normal((V, D))
    v *= (1.0 + 2.0 / np.sqrt(1.0 + np.arange(V)))[:, None]
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * np.sqrt(D) * 0.35
    h = v[rng.integers(0, V, Q)] + 0.3 * rng.standard_normal((Q, D))
    return v.astype(np.float32), (0.5 * h).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(t, j, name=""):
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _same_index(t, j):
    for name in LAYOUT:
        _eq(getattr(t, name), getattr(j, name), name)
    assert t.n == j.n and t.block_rows == j.block_rows
    np.testing.assert_allclose(t.block_centroids.numpy(),
                               np.asarray(j.block_centroids), atol=1e-5)
    np.testing.assert_allclose(t.block_radius.numpy(),
                               np.asarray(j.block_radius), atol=1e-4)


def _port_copy(j):
    """The JAX index's fields, bit for bit, as the port's index."""
    return ivf_from_numpy(n=j.n, block_rows=j.block_rows, device="cpu",
                          **{f: np.asarray(getattr(j, f)) for f in (
                              "v_blocks", "valid", "row_id", "slot_of_row",
                              "block_centroids", "block_radius", "assign")})


@pytest.fixture(scope="module")
def built():
    v, h = _clustered(0)
    j = jmips.build_ivf_device(jax.random.PRNGKey(1), jnp.asarray(v),
                               block_rows=BR, n_clusters=C)
    t = tmips.build_ivf_device(_t(v), block_rows=BR, n_clusters=C,
                               assign=_t(j.assign), device="cpu")
    return v, h, j, t


class TestDeviceBuild:
    def test_capacity_layout_equals_jax(self, built):
        _, _, j, t = built
        nb = tmips.ivf_capacity_blocks(V, BR, C)
        assert nb == jmips.ivf_capacity_blocks(V, BR, C) == t.n_blocks
        assert t.n_blocks == j.n_blocks
        _same_index(t, j)
        live = int(t.valid.any(-1).sum())
        assert live < nb and not t.valid[live:].any()    # dead tail blocks

    def test_pack_with_an_empty_cluster(self, built):
        """Cluster 3's rows moved to cluster 2: cluster 3 keeps one dead
        block, and the layout still equals JAX's."""
        v, _, j, _ = built
        assign = np.array(j.assign)
        assign[assign == 3] = 2
        jp = jmips.pack_ivf(jnp.asarray(v), jnp.asarray(assign), C, BR)
        tp = tmips.pack_ivf(_t(v), _t(assign), C, BR)
        _same_index(tp, jp)
        assert tp.n_blocks == tmips.ivf_capacity_blocks(V, BR, C)

    def test_host_build_keeps_its_total(self, built):
        """build_ivf packs into exactly the blocks the clusters need; on
        the same assignment its live blocks are the capacity build's."""
        v, _, j, t = built
        host = tmips.build_ivf(_t(v), block_rows=BR, n_clusters=C,
                               assign=_t(j.assign), device="cpu")
        jh = jmips.build_ivf(jax.random.PRNGKey(1), jnp.asarray(v),
                             block_rows=BR, n_clusters=C)
        _eq(host.v_blocks, jh.v_blocks, "host v_blocks")
        nb = host.n_blocks
        assert nb < t.n_blocks
        for name in ("v_blocks", "valid", "row_id"):
            assert torch.equal(getattr(host, name), getattr(t, name)[:nb])
        assert torch.equal(host.slot_of_row, t.slot_of_row)

    def test_every_row_packed_once(self, built):
        v, _, _, t = built
        rid = t.row_id.numpy().ravel()
        assert sorted(rid[rid >= 0].tolist()) == list(range(V))
        flat = t.v_blocks.reshape(-1, D)
        assert torch.equal(flat[t.slot_of_row.long()], _t(v))

    def test_pad_ivf_blocks_equals_jax(self, built):
        _, _, j, t = built
        for multiple in (8, 7, 1):
            jp = jmips.pad_ivf_blocks(j, multiple)
            tp = tmips.pad_ivf_blocks(t, multiple)
            assert tp.n_blocks == jp.n_blocks and tp.n_blocks % multiple == 0
            _same_index(tp, jp)
        assert tmips.pad_ivf_blocks(t, 1) is t


class TestRefresh:
    def test_refresh_matches_jax_on_drifted_rows(self, built):
        """Same new assignment except on ties (the two nearest refreshed
        centroids within 1e-5 relative), churn and drift to 1e-6, and the
        repacked layout bit-equal on JAX's new assignment."""
        v, _, j, _ = built
        rng = np.random.default_rng(3)
        w = (v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        jn, jm = jmips.refresh_ivf(j, jnp.asarray(w), n_clusters=C)
        tn, tm = tmips.refresh_ivf(_port_copy(j), _t(w), n_clusters=C)
        got, want = tn.assign.numpy(), np.asarray(jn.assign)
        # the refreshed centroids the new assignment is taken against
        c0, _ = j_centroids(jnp.asarray(w), j.assign, C)
        c = np.asarray(j_kmeans_step(jnp.asarray(w), c0), np.float64)
        d2 = ((w[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
        two = np.sort(d2, -1)[:, :2]
        tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 1]
        assert (got == want)[~tie].all()
        assert (got != want).sum() <= tie.sum()
        for name in ("churn", "drift"):
            assert abs(float(tm[name]) - float(jm[name])) <= 1e-6, name
        assert float(tm["churn"]) > 0 and float(tm["drift"]) > 0
        _same_index(tmips.pack_ivf(_t(w), _t(jn.assign), C, BR), jn)
        assert tn.v_blocks.shape == j.v_blocks.shape

    def test_refresh_on_the_same_rows_keeps_shapes(self, built):
        v, _, j, t = built
        tn, tm = tmips.refresh_ivf(t, _t(v), n_clusters=C)
        assert float(tm["drift"]) < 1e-6
        for name in LAYOUT + ("block_centroids", "block_radius"):
            assert getattr(tn, name).shape == getattr(t, name).shape, name
            assert getattr(tn, name).dtype == getattr(t, name).dtype, name
        again, _ = tmips.refresh_ivf(t, _t(v), n_clusters=C)
        for a, b in zip(tn, again):                 # deterministic
            assert a == b if isinstance(a, int) else torch.equal(a, b)


class TestProbe:
    def test_probe_and_gather_scores_equal_jax(self, built):
        _, h, j, t = built
        for i in range(Q):
            tid = tmips.probe(t, _t(h[i]), 4)
            jid = jmips.probe(j, jnp.asarray(h[i]), 4)
            _eq(tid, jid, "probe")
            _eq(tid, tmips.probe_batch(t, _t(h), 4)[i], "probe_batch")
            ts, tv = tmips.gather_scores(t, _t(h[i]), tid)
            js, jv = jmips.gather_scores(j, jnp.asarray(h[i]), jid)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
            _eq(tv, jv, "valid")

    def test_exact_top_k_equals_jax(self, built):
        v, h, _, _ = built
        for i in range(3):
            tv, ti = tmips.exact_top_k(_t(v), _t(h[i]), 5)
            jv, ji = jmips.exact_top_k(jnp.asarray(v), jnp.asarray(h[i]), 5)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
            _eq(ti, ji, "ids")

    def test_dead_blocks_rank_last(self, built):
        _, h, _, t = built
        live = int(t.valid.any(-1).sum())
        ids = tmips.probe_batch(t, _t(h), t.n_blocks)
        assert (t.valid.any(-1)[ids[:, :live].long()]).all()
        assert not (t.valid.any(-1)[ids[:, live:].long()]).any()


class TestPlanHelpers:
    def test_head_row_table_and_tail_row_ids_equal_jax(self, built):
        _, h, j, t = built
        key = jax.random.PRNGKey(7)
        jp = jdec.make_plan(j, jnp.asarray(h), key, 4, 32)
        tail = _t(jax.random.randint(key, (32,), 0, V))
        tp = tdec.make_plan(t, _t(h), 4, 32, tail_idx=tail)
        for cap in (tp.head_ids.shape[0], 5):
            rows, mask = tdec.head_row_table(t, tp.head_ids[:cap],
                                             tp.head_member[:, :cap])
            j_rows, j_mask = jdec.head_row_table(j, jp.head_ids[:cap],
                                                 jp.head_member[:, :cap])
            _eq(rows, j_rows, "head_rows")
            _eq(mask, j_mask, "head_mask")
        _eq(tdec.tail_row_ids(t, tp), jdec.tail_row_ids(j, jp), "tail ids")
        assert torch.equal(tdec.tail_row_ids(t, tp), tail.to(torch.int32))

    def test_resolve_head_cap_equals_jax(self):
        for cap, n_probe, capacity in ((0, 4, 24), (0, 16, 128), (3, 4, 24),
                                       (0, 2, 5), (100, 4, 24)):
            assert tdec._resolve_head_cap(cap, n_probe, capacity) == \
                jdec._resolve_head_cap(cap, n_probe, capacity)

    @pytest.mark.parametrize("method", ["mimps", "mince", "topk"])
    def test_trimmed_and_untrimmed_branches_agree(self, built, method):
        """head_cap 0 (auto: trimmed, the union fits), a cap the union
        overflows (the full capacity) and no cap give the same outputs:
        log-values to 1e-6, ids equal."""
        _, h, _, t = built
        hq = _t(h[[0, 1, 0, 1, 0, 1]])      # two probe sets: U fits the cap
        tail = _t(np.random.default_rng(5).integers(0, V, 32))

        def run(cap):
            kw = dict(n_probe=4, k=4, use_kernel=False, head_cap=cap)
            if method == "topk":
                return tdec.topk_head_decode(t, hq, **kw)
            fn = tdec.mimps_decode if method == "mimps" else tdec.mince_decode
            return fn(t, hq, l=32, tail_idx=tail, **kw)

        plan = tdec.make_plan(t, hq, 4, 0)
        assert int(plan.head_live) <= tdec._resolve_head_cap(
            0, 4, plan.head_ids.shape[0]) < plan.head_ids.shape[0]
        want = run(10 ** 6)
        for cap in (0, 1):
            got = run(cap)
            for name in ("log_z", "head_lse", "tail_lse", "top_score"):
                np.testing.assert_allclose(
                    getattr(got, name).numpy(), getattr(want, name).numpy(),
                    atol=1e-6, err_msg=name)
            assert torch.equal(got.top_id, want.top_id)


class TestDeadBlocksInTheUnion:
    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_probe_past_the_live_blocks_matches_jax(self, built, use_kernel):
        """n_probe above the live block count puts dead blocks into every
        query's union; the decode (kernel branch: the plain kernel
        versions) matches the JAX XLA path: log-values to 1e-4, ids
        equal."""
        _, h, j, t = built
        live = int(t.valid.any(-1).sum())
        n_probe = live + 2
        key = jax.random.PRNGKey(11)
        jo = jdec.mimps_decode(j, jnp.asarray(h), key, n_probe=n_probe,
                               l=32, k=4, use_pallas=False)
        tail = _t(jax.random.randint(key, (32,), 0, V))
        to = tdec.mimps_decode(t, _t(h), n_probe=n_probe, l=32, k=4,
                               use_kernel=use_kernel, tail_idx=tail)
        for name in ("log_z", "head_lse", "top_score"):
            np.testing.assert_allclose(getattr(to, name).numpy(),
                                       np.asarray(getattr(jo, name)),
                                       atol=1e-4, err_msg=name)
        _eq(to.top_id, jo.top_id, "top_id")
        np.testing.assert_array_equal(to.k_eff.numpy(), np.asarray(jo.k_eff))
        assert torch.isneginf(to.tail_lse).all()    # every tail row probed


def _out_of_place_statistics(idx):
    """The block centroids and radii recomputed from the packed blocks with
    out-of-place products, as ``mips._pack`` computed them before it
    overwrote its f32 copy in place."""
    vf = idx.v_blocks.float()
    counts = torch.clamp(idx.valid.sum(1, keepdim=True), min=1).float()
    cent = (vf * idx.valid[..., None]).sum(1) / counts
    dist = torch.linalg.vector_norm(vf - cent[:, None, :], dim=-1)
    radius = torch.where(idx.valid, dist, torch.zeros_like(dist)).amax(1)
    return cent.to(idx.v_blocks.dtype), radius


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_statistics_equal_the_out_of_place_arithmetic(dtype):
    """``_pack`` computes the centroids and radii on one f32 copy of the
    blocks, overwritten in place: the same bits as the out-of-place
    products, NaN rows and empty blocks included, and the blocks
    themselves untouched (at f32 ``.float()`` would alias them)."""
    gen = torch.Generator().manual_seed(3)
    v = torch.randn(700, 48, generator=gen).to(dtype)
    v[17] = float("nan")
    assign = torch.randint(0, 6, (700,), generator=gen)
    assign[assign == 4] = 5                    # cluster 4 empty
    idx = tmips.pack_ivf(v, assign, 6, 64)
    cent, radius = _out_of_place_statistics(idx)
    assert torch.equal(_bits(idx.block_centroids), _bits(cent))
    assert torch.equal(_bits(idx.block_radius), _bits(radius))
    rows = idx.v_blocks.reshape(-1, 48)[idx.slot_of_row.long()]
    assert torch.equal(_bits(rows), _bits(v))


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)
