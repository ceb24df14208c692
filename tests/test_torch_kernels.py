"""The port's plain kernel versions against the JAX package's Pallas kernels
(interpret mode on the CPU) and their jnp references, on the same numpy
inputs. f32 throughout; log-values to 1e-4 absolute. Top-k entries are
compared where they are real candidates (above NEG/2): the filler entries
of the Pallas kernels and of ``lax.top_k`` carry other ids than the port's
``(NEG, 0)``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ivf_score import ivf_decode as jax_ivf_decode
from repro.kernels.ivf_score import union_scores as jax_union_scores
from repro.kernels.ref import topk_z_ref
from repro.kernels.topk_z import topk_z as jax_topk_z
from repro_torch.kernels.ivf_score import (ivf_decode, ivf_decode_plain,
                                          union_launch, union_scores,
                                          union_scores_plain)
from repro_torch.kernels.topk_z import (NEG, check_tile, geometry, topk_z,
                                       topk_z_plain)

ATOL = 1e-4
NEG32 = np.float32(NEG)   # the f32 value of the filler score


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_topk(tv, ti, ref_v, ref_i, k):
    """Real entries equal (ids exactly, scores to ATOL); the port's
    missing entries are the filler (NEG, 0)."""
    tv, ti = tv.numpy(), ti.numpy()
    ref_v, ref_i = _np(ref_v), _np(ref_i)
    real = ref_v > NEG * 0.5
    np.testing.assert_array_equal(tv > NEG * 0.5, real)
    np.testing.assert_allclose(tv[real], ref_v[real], atol=ATOL)
    np.testing.assert_array_equal(ti[real], ref_i[real])
    np.testing.assert_array_equal(tv[~real], NEG32)
    np.testing.assert_array_equal(ti[~real], 0)


def _topk_inputs(seed, q, v, d, tie_rows=()):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((q, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((v, d))).astype(np.float32)
    for a, b in tie_rows:             # identical rows -> exactly tied scores
        w[a] = 3.0 * w[a]
        w[b] = w[a]
    return h, w


class TestTopkZPlain:
    @pytest.mark.parametrize("q,v,block_v", [(5, 300, 128), (8, 256, 128),
                                             (3, 1000, 512)])
    def test_matches_pallas_and_ref(self, q, v, block_v):
        """Q not a multiple of the query tile, V not a multiple of the vocab
        tile (300 = 2*128 + 44), and exactly tied rows across and within
        vocab tiles: the lowest id wins in every implementation."""
        k = 8
        h, w = _topk_inputs(q + v, q, v, 32,
                            tie_rows=[(7, 150), (20, 21), (260 % v, 3)])
        lse, tv, ti = topk_z_plain(_t(h), _t(w), k)
        j_lse, j_v, j_i = jax_topk_z(jnp.asarray(h), jnp.asarray(w), k,
                                     block_v=block_v)
        r_lse, r_v, r_i = topk_z_ref(jnp.asarray(h), jnp.asarray(w), k)
        np.testing.assert_allclose(lse.numpy(), _np(j_lse), atol=ATOL)
        np.testing.assert_allclose(lse.numpy(), _np(r_lse), atol=ATOL)
        _assert_topk(tv, ti, j_v, j_i, k)
        _assert_topk(tv, ti, r_v, r_i, k)

    def test_ties_lowest_id_wins(self):
        h = np.ones((2, 8), np.float32)
        w = np.zeros((40, 8), np.float32)
        w[[5, 17, 33]] = 1.0              # three tied maxima
        _, tv, ti = topk_z_plain(_t(h), _t(w), 4)
        np.testing.assert_array_equal(ti.numpy()[:, :3], [[5, 17, 33]] * 2)
        assert (ti.numpy()[:, 3] == 0).all()        # next tie group: id 0
        _, j_v, j_i = jax_topk_z(jnp.asarray(h), jnp.asarray(w), 4,
                                 block_v=128)
        np.testing.assert_array_equal(ti.numpy(), _np(j_i))

    def test_fewer_than_k_candidates_fill_neg_zero(self):
        """V < k: the missing entries are (NEG, 0), as the Pallas kernel's
        running top-k leaves them after one vocab tile."""
        h, w = _topk_inputs(3, 2, 5, 16)
        lse, tv, ti = topk_z_plain(_t(h), _t(w), 8)
        assert (tv.numpy()[:, 5:] == NEG32).all()
        assert (ti.numpy()[:, 5:] == 0).all()
        j_lse, j_v, j_i = jax_topk_z(jnp.asarray(h), jnp.asarray(w), 8)
        np.testing.assert_allclose(lse.numpy(), _np(j_lse), atol=ATOL)
        np.testing.assert_array_equal(_np(j_v)[:, 5:], NEG32)
        np.testing.assert_array_equal(_np(j_i)[:, 5:], 0)
        _assert_topk(tv, ti, j_v, j_i, 8)

    def test_wrapper_takes_plain_version_on_cpu(self):
        h, w = _topk_inputs(4, 3, 64, 16)
        before = topk_z.launches
        for a, b in zip(topk_z(_t(h), _t(w), 4),
                        topk_z_plain(_t(h), _t(w), 4)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert topk_z.launches == before     # no kernel launched on the CPU


def _ivf_inputs(seed):
    """A hand-built plan: nb=6 blocks of br=8 rows, d=32, Q=5 (not a
    multiple of the 8-row query tile), U=5 union slots of which 3 are live
    (pad slots repeat the last id), l=20 tail rows (not a multiple of the
    32-row tail tile). Query 3 probes only block 4, whose 3 real rows are
    fewer than k=8; query 4 accepts no tail sample; row 1 of block 2 and
    row 0 of block 4 are identical, so their scores tie."""
    rng = np.random.default_rng(seed)
    nb, br, d, q, l = 6, 8, 32, 5, 20
    w_blocks = (0.4 * rng.standard_normal((nb, br, d))).astype(np.float32)
    h = rng.standard_normal((q, d)).astype(np.float32)
    w_blocks[2, 1] = 0.5 * h[1]                       # query 1's best row
    w_blocks[4, 0] = w_blocks[2, 1]                   # tie across blocks
    head_ids = np.array([1, 2, 4, 4, 4], np.int32)
    head_live = np.int32(3)
    member = np.zeros((q, 5), bool)
    member[0, [0, 1]] = True
    member[1, [1, 2]] = True
    member[2, [0, 1, 2]] = True
    member[3, [2]] = True
    member[4, [0]] = True
    member[:, 3:] = True          # pad slots: must be ignored anyway
    valid = np.ones((nb, br), bool)
    valid[4, 3:] = False          # block 4 has 3 real rows
    valid[1, 6:] = False
    row_logw = np.where(valid, 0.0, -1e30).astype(np.float32)
    tail_rows = (0.4 * rng.standard_normal((l, d))).astype(np.float32)
    accept = rng.random((q, l)) < 0.6
    accept[4] = False
    return (w_blocks, h, head_ids, head_live, member, row_logw, tail_rows,
            accept)


class TestIvfDecodePlain:
    @pytest.mark.parametrize("k", [1, 8])
    def test_matches_pallas(self, k):
        args = _ivf_inputs(11)
        hl, tl, tv, ti = ivf_decode_plain(*[_t(a) for a in args], k=k)
        j_hl, j_tl, j_v, j_i = jax_ivf_decode(*[jnp.asarray(a) for a in args],
                                              k=k)
        np.testing.assert_allclose(hl.numpy(), _np(j_hl), atol=ATOL)
        _assert_topk(tv, ti, j_v, j_i, k)
        j_tl = _np(j_tl)
        assert np.isneginf(tl.numpy()[4]) and np.isneginf(j_tl[4])
        np.testing.assert_allclose(tl.numpy()[:4], j_tl[:4], atol=ATOL)

    def test_tie_lowest_slot_and_short_candidate_list(self):
        args = _ivf_inputs(11)
        _, _, tv, ti = ivf_decode_plain(*[_t(a) for a in args], k=8)
        tv, ti = tv.numpy(), ti.numpy()
        # query 1 probes blocks 2 and 4: the tied pair (slots 17 and 32)
        # leads, lowest slot first
        np.testing.assert_array_equal(ti[1, :2], [2 * 8 + 1, 4 * 8 + 0])
        assert tv[1, 0] == tv[1, 1]
        # query 3 sees block 4's 3 real rows only: 5 filler entries
        assert (tv[3, 3:] == NEG32).all() and (ti[3, 3:] == 0).all()
        assert set(ti[3, :3]) == {32, 33, 34}

    def test_pad_slots_skipped(self):
        """Slots at or past head_live add nothing even where a query's
        membership row marks them."""
        args = list(_ivf_inputs(5))
        base = ivf_decode_plain(*[_t(a) for a in args], k=4)
        args[0] = args[0].copy()
        args[0][0] = 50.0             # block 0 is in no live slot
        args[2] = np.array([1, 2, 4, 0, 0], np.int32)   # pad slots -> block 0
        moved = ivf_decode_plain(*[_t(a) for a in args], k=4)
        j_moved = jax_ivf_decode(*[jnp.asarray(a) for a in args], k=4)
        for a, b, c in zip(base, moved, j_moved):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(moved[0].numpy(), _np(j_moved[0]),
                                   atol=ATOL)

    def test_wrapper_takes_plain_version_on_cpu(self):
        args = [_t(a) for a in _ivf_inputs(2)]
        before = ivf_decode.launches
        for a, b in zip(ivf_decode(*args, k=3), ivf_decode_plain(*args, k=3)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert ivf_decode.launches == before


class TestUnionScoresPlain:
    @pytest.mark.parametrize("q,live", [(5, 3), (8, 1), (3, 5)])
    def test_matches_pallas(self, q, live):
        """Q below and at the 8-row query tile, one live slot and a full
        union: live slots equal the Pallas scores, pad slots are 0 in
        both."""
        rng = np.random.default_rng(q + live)
        nb, br, d, cap = 7, 8, 32, 5
        w_blocks = rng.standard_normal((nb, br, d)).astype(np.float32)
        h = rng.standard_normal((q, d)).astype(np.float32)
        ids = np.sort(rng.choice(nb, live, replace=False)).astype(np.int32)
        head_ids = np.concatenate([ids, np.full(cap - live, ids[-1],
                                                np.int32)])
        args = (w_blocks, h, head_ids, np.int32(live))
        got = union_scores_plain(*[_t(a) for a in args])
        want = _np(jax_union_scores(*[jnp.asarray(a) for a in args]))
        assert got.shape == (q, cap, br)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
        assert (got.numpy()[:, live:] == 0).all()
        np.testing.assert_allclose(
            got.numpy()[:, :live],
            np.einsum("qd,ubd->qub", h, w_blocks[ids]), atol=ATOL)

    def test_wrapper_takes_plain_version_on_cpu(self):
        args = [_t(a) for a in _ivf_inputs(3)[:4]]
        before = union_scores.launches
        torch.testing.assert_close(union_scores(*args),
                                   union_scores_plain(*args), rtol=0, atol=0)
        assert union_scores.launches == before

    def test_launch_refuses_cpu_tensors(self):
        """The kernel's launch function takes CUDA tensors only: the CPU
        path is the wrapper's plain version, never a launch."""
        args = [_t(a) for a in _ivf_inputs(3)[:4]]
        with pytest.raises(ValueError, match="one GPU"):
            union_launch(*args)


@pytest.mark.parametrize("d,dtype,fits", [
    (2560, torch.float32, True), (8192, torch.bfloat16, True),
    (13472, torch.bfloat16, True), (13480, torch.bfloat16, True),
    (6736, torch.float32, True), (8192, torch.float32, False)])
def test_topk_z_tile_check(d, dtype, fits):
    """The wrapper's check before a launch: the f32 kernel's query tile of
    8 rows of d against the shared memory a block of the kernel may take
    (an H100's 232,448 less the k > 8 instance's 16,896 bytes of static
    lists); a tile that does not fit raises a ValueError naming d, the
    dtype and the limit. The bf16 kernel keeps no query tile, so it takes
    any d % 8 == 0, past the 13,472 its tile once allowed."""
    limit = 232448 - 16896
    if fits:
        check_tile(d, dtype, limit)
        return
    with pytest.raises(ValueError, match=rf"d {d} in {dtype}.*{limit}"):
        check_tile(d, dtype, limit)


@pytest.mark.parametrize("q,v,d", [
    (8, 151936, 2560), (16, 151936, 2560), (1, 128256, 8192),
    (9, 128256, 8192), (17, 32003, 13472), (40, 300, 104), (3, 64, 8)])
def test_topk_z_geometry(q, v, d):
    """The bf16 kernel's geometry on an H100's 132 SMs: the CTAs' box
    ranges cover the V rows once, in order, with no overlap, and no CTA
    has more than one box more than another; the query tile is 8 wide for
    Q <= 8 and 16 above, one grid row per tile; the ring keeps at least 64
    KB of W in flight at every width and fits the 232,448 bytes of shared
    memory a block may take beside its 16 KB of candidate lists."""
    geo = geometry(q, v, d, torch.bfloat16, 132)
    assert geo["tensor_cores"] and geo["box_rows"] == 128
    ranges = geo["ranges"]
    assert len(ranges) == geo["grid_x"] == min(132, -(-v // 128))
    assert ranges[0][0] == 0 and ranges[-1][1] == geo["boxes"]
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [b1 - b0 for b0, b1 in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    rows = [r for b0, b1 in ranges
            for r in range(b0 * 128, min(b1 * 128, v))]
    assert rows == list(range(v))
    assert geo["n"] == (8 if q <= 8 else 16)
    assert geo["tiles"] == -(-q // geo["n"])
    assert geo["stages_per_box"] == -(-d // 64)
    assert geo["in_flight"] >= 64 * 1024
    assert geo["smem"] + 16 * 1024 + 1024 <= 232448
    f32 = geometry(q, v, d, torch.float32, 132)
    assert not f32["tensor_cores"] and f32["n"] == 8
