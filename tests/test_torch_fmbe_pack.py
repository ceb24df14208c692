"""The packed layout that the tensor-core ``fmbe_phi`` reads
(``kernels.fmbe.fmbe_pack``, ``pack_layout``) and its plain evaluation
(``fmbe_phi_pack_plain``), on the CPU.

The layout is held to its invariants over random degree vectors: every
live projection row (j, m < degree_j) appears exactly once, at column
start_j + m (so in m order), every other column is zero, no feature
crosses a 128-column tile, and the column tiles' feature ranges, of at
most 128 features each, tile [0, P) in order. The plain evaluation from
the pack equals ``fmbe_phi_plain`` bit for bit and the Pallas kernel in
interpret mode to
1e-4 of each feature's scale |coef_j| * max(|x|_2, 1) ** degree_j, on the
same numpy inputs, and so does the f32 kernel's decomposition
(``fmbe_phi_planes_plain``: three exact bf16 planes of x against the pack,
smallest first); ``build_fmbe_blocks`` and ``build_fmbe`` give the same
sums with a pack as without one, and ``fmbe_phi`` refuses a pack made from
other tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # pragma: no cover
    from _hyp_fallback import given, settings, st

from repro.core import feature_maps as jfm
from repro.kernels.fmbe import fmbe_phi as jax_fmbe_phi
from repro_torch.core import feature_maps as tfm
from repro_torch.interop import feature_map_from_numpy
from repro_torch.kernels.fmbe import (PACK_TILE, fmbe_pack,
                                     fmbe_phi, fmbe_phi_pack_plain,
                                     fmbe_phi_planes_plain, fmbe_phi_plain,
                                     pack_layout)

REL = 1e-4


def _map(seed, p, d, max_degree=8, degree=None):
    """A +-1 feature map from numpy: (omega, degree, coef) tensors."""
    rng = np.random.default_rng(seed)
    omega = (2 * rng.integers(0, 2, (p, max_degree, d)) - 1).astype(
        np.float32)
    if degree is None:
        degree = rng.integers(0, max_degree + 1, p)
    coef = (rng.random(p) + 0.1).astype(np.float32)
    return (torch.from_numpy(omega),
            torch.tensor(np.asarray(degree), dtype=torch.int32),
            torch.from_numpy(coef))


def _check_layout(degree, max_degree):
    start, tile_j0, n_tiles = pack_layout(degree, max_degree)
    n_cols = n_tiles * PACK_TILE
    used = np.zeros(n_cols, np.int64)
    for j, g in enumerate(degree):
        g = min(g, max_degree)
        if g == 0:
            assert start[j] == -1
            continue
        s = start[j]
        assert 0 <= s and s + g <= n_cols
        assert s // PACK_TILE == (s + g - 1) // PACK_TILE     # one tile
        used[s:s + g] += 1
    assert used.max(initial=0) <= 1                         # no overlap
    assert used.sum() == sum(min(g, max_degree) for g in degree)
    assert tile_j0[0] == 0 and tile_j0[-1] == len(degree)
    assert len(tile_j0) == n_tiles + 1
    assert all(0 <= b - a <= PACK_TILE for a, b in zip(tile_j0, tile_j0[1:]))
    for i in range(n_tiles):            # a tile's live features start in it
        for j in range(tile_j0[i], tile_j0[i + 1]):
            if start[j] >= 0:
                assert start[j] // PACK_TILE == i
    live = [s for s in start if s >= 0]
    assert live == sorted(live)                              # feature order
    return start, tile_j0, n_tiles


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 8), min_size=1, max_size=400),
       st.integers(1, 8))
def test_layout_invariants(degree, max_degree):
    """Degree vectors in [0, 8] of any length (P off the tile), capped at
    max_degree as the kernels cap them."""
    _check_layout(degree, max_degree)


@pytest.mark.parametrize("degree,n_tiles", [
    ([0] * 5, 1),                             # no live row at all
    ([8] * 16, 1),                            # exactly one full tile
    ([8] * 16 + [0] * 300, 4),                # tiles of degree-0 only
    ([1] * 130, 2),                           # 128 features fill a tile
    ([8] * 16 + [1], 2),
    ([8] * 15 + [7, 2, 8], 2),                # 2 pushed to the next tile
])
def test_layout_edges(degree, n_tiles):
    start, tile_j0, got = _check_layout(degree, 8)
    assert got == n_tiles
    if degree == [8] * 15 + [7, 2, 8]:
        assert start[14:] == [112, 120, 128, 130]


@pytest.mark.parametrize("p,d,max_degree", [(70, 32, 8), (300, 24, 4),
                                            (129, 16, 8)])
def test_pack_holds_each_live_row_once(p, d, max_degree):
    omega, degree, coef = _map(p, p, d, max_degree)
    pack = fmbe_pack(omega, degree, coef)
    start, tile_j0, n_tiles = pack_layout(degree.tolist(), max_degree)
    assert pack.rows.dtype == torch.bfloat16
    assert pack.rows.shape == (n_tiles * PACK_TILE, d)
    assert pack.start.tolist() == start and pack.tile_j0.tolist() == tile_j0
    rows = pack.rows.float()
    hit = torch.zeros(rows.shape[0], dtype=torch.bool)
    for j in range(p):
        for m in range(int(degree[j])):
            assert torch.equal(rows[start[j] + m], omega[j, m])
            hit[start[j] + m] = True
    assert not rows[~hit].any()                        # the rest is zero
    assert torch.equal(pack.degree, degree.clamp(0, max_degree))
    assert torch.equal(pack.coef, coef)


def test_pack_refuses_omega_not_exact_in_bf16():
    omega, degree, coef = _map(0, 16, 8)
    degree[:] = 2
    omega[3, 1, 5] = 1.0 + 2 ** -10                     # not a bf16 value
    with pytest.raises(ValueError, match="not exact in bf16"):
        fmbe_pack(omega, degree, coef)
    omega[3, 1, 5] = 0.3
    with pytest.raises(ValueError, match="not exact in bf16"):
        fmbe_pack(omega, degree, coef)
    degree[3] = 1                                     # the row is dead now
    fmbe_pack(omega, degree, coef)


@pytest.mark.parametrize("q,p,d,max_degree", [(5, 200, 32, 8),
                                              (8, 128, 16, 4),
                                              (3, 70, 32, 6)])
def test_pack_plain_matches_plain_and_pallas(q, p, d, max_degree):
    """The pack's evaluation against ``fmbe_phi_plain`` (bit for bit: the
    same f32 products of exact +-1 rows, in the same factor order) and the
    Pallas kernel in interpret mode on the JAX feature map."""
    fm = jfm.make_feature_map(jax.random.PRNGKey(q + p), d, p,
                              max_degree=max_degree)
    tmap = feature_map_from_numpy(np.asarray(fm.omega),
                                  np.asarray(fm.degree),
                                  np.asarray(fm.coef), fm.p, device="cpu")
    x = (0.5 * np.random.default_rng(p).standard_normal((q, d))
         ).astype(np.float32)
    pack = fmbe_pack(tmap.omega, tmap.degree, tmap.coef)
    got = fmbe_phi_pack_plain(pack, torch.from_numpy(x))
    plain = fmbe_phi_plain(tmap.omega, tmap.degree, tmap.coef,
                           torch.from_numpy(x))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    want = np.asarray(jax_fmbe_phi(fm.omega, fm.degree, fm.coef,
                                   jnp.asarray(x)))
    norm = np.maximum(np.linalg.norm(x, axis=-1), 1.0)
    scale = (np.abs(np.asarray(fm.coef))[None, :]
             * norm[:, None] ** np.asarray(fm.degree, np.float64)[None, :])
    assert (np.abs(got.numpy() - want) <= REL * (np.abs(want) + scale)).all()


@pytest.mark.parametrize("q,p,d,max_degree,x_std", [(5, 200, 32, 8, 0.5),
                                                    (8, 128, 16, 4, 0.5),
                                                    (3, 70, 40, 6, 2.0)])
def test_planes_plain_matches_plain_and_pallas(q, p, d, max_degree, x_std):
    """The f32 kernel's decomposition (x split into three bf16 planes, each
    against the packed +-1 rows, smallest first, summed in f32) against
    ``fmbe_phi_plain`` and the Pallas kernel in interpret mode, within 1e-4
    of |phi| + |coef_j| * max(|x|_2, 1) ** degree_j."""
    fm = jfm.make_feature_map(jax.random.PRNGKey(q * p), d, p,
                              max_degree=max_degree)
    tmap = feature_map_from_numpy(np.asarray(fm.omega),
                                  np.asarray(fm.degree),
                                  np.asarray(fm.coef), fm.p, device="cpu")
    x = (x_std * np.random.default_rng(q + d).standard_normal((q, d))
         ).astype(np.float32)
    pack = fmbe_pack(tmap.omega, tmap.degree, tmap.coef)
    got = fmbe_phi_planes_plain(pack, torch.from_numpy(x)).numpy()
    norm = np.maximum(np.linalg.norm(x, axis=-1), 1.0)
    scale = (np.abs(np.asarray(fm.coef))[None, :]
             * norm[:, None] ** np.asarray(fm.degree, np.float64)[None, :])
    plain = fmbe_phi_plain(tmap.omega, tmap.degree, tmap.coef,
                           torch.from_numpy(x)).numpy()
    pallas = np.asarray(jax_fmbe_phi(fm.omega, fm.degree, fm.coef,
                                     jnp.asarray(x)))
    for want in (plain, pallas):
        assert (np.abs(got - want) <= REL * (np.abs(want) + scale)).all()


def test_wrapper_takes_the_pack_plain_on_cpu():
    omega, degree, coef = _map(1, 90, 16)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16)).astype(np.float32))
    pack = fmbe_pack(omega, degree, coef)
    before = (fmbe_phi.launches, dict(fmbe_phi.by_variant))
    torch.testing.assert_close(fmbe_phi(omega, degree, coef, x, pack=pack),
                               fmbe_phi_pack_plain(pack, x), rtol=0, atol=0)
    assert (fmbe_phi.launches, fmbe_phi.by_variant) == before


@pytest.mark.parametrize("other", ["coef", "degree", "map", "in_place"])
def test_wrapper_refuses_a_pack_of_other_tensors(other):
    """A pack holds to the omega, degree and coef it was made from:
    another coef or degree, another map of the same P, or an omega changed
    in place after packing raise (the GPU route checks the same)."""
    omega, degree, coef = _map(4, 90, 16)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 16)).astype(np.float32))
    pack = fmbe_pack(omega, degree, coef)
    args = [omega, degree, coef]
    if other == "coef":
        args[2] = coef * 2
    elif other == "degree":
        args[1] = degree.clone()
    elif other == "map":
        args = list(_map(5, 90, 16))
    else:
        omega[0, 0].neg_()
    with pytest.raises(ValueError, match="another omega, degree or coef"):
        fmbe_phi(*args, x, pack=pack)
    repacked = fmbe_pack(*args)
    torch.testing.assert_close(fmbe_phi(*args, x, pack=repacked),
                               fmbe_phi_plain(*args, x), rtol=0, atol=0)


@pytest.mark.parametrize("chunk_blocks", [1, 2, 16])
def test_build_fmbe_blocks_same_with_and_without_pack(chunk_blocks):
    nb, br, d, p = 5, 16, 24, 96
    rng = np.random.default_rng(2)
    v_blocks = torch.from_numpy(
        (0.3 * rng.standard_normal((nb, br, d))).astype(np.float32))
    valid = torch.from_numpy(rng.random((nb, br)) < 0.8)
    omega, degree, coef = _map(3, p, d)
    fm = tfm.FeatureMap(omega=omega, degree=degree, coef=coef, p=2.0)
    pack = fmbe_pack(omega, degree, coef)
    without = tfm.build_fmbe_blocks(fm, v_blocks, valid, chunk_blocks)
    with_pack = tfm.build_fmbe_blocks(fm, v_blocks, valid, chunk_blocks,
                                      pack=pack)
    torch.testing.assert_close(with_pack, without, rtol=0, atol=0)
    flat = v_blocks.reshape(-1, d)
    torch.testing.assert_close(
        tfm.build_fmbe(fm, flat, chunk=32, pack=pack).lambda_tilde,
        tfm.build_fmbe(fm, flat, chunk=32).lambda_tilde, rtol=0, atol=0)
