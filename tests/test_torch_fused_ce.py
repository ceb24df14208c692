"""The port's fused cross-entropy against the JAX package's on the CPU, on
the same numpy inputs: the plain versions of the two kernels against the
Pallas kernels (interpret mode), and the autograd Function against
``jax.grad`` of ``repro.kernels.ops.fused_cross_entropy`` and against torch
autograd through the full-logits oracle ``fused_ce_ref``.

Tolerances. f32: scores are f32 dots of the same inputs summed in another
order (about 1e-6 relative), so nll/lse hold to 1e-5 and gradients to 1e-5
of the sum of their terms' magnitudes. bf16: both sides score the bf16
inputs in f32 and round ``coef`` to bf16 before the products; a coefficient
whose two f32 values straddle a bf16 rounding boundary rounds one bf16 step
(at most 2**-7 relative) apart, so gradients hold to 2**-7 (+ 1e-5) of the
sum of their terms' magnitudes, plus one bf16 step of the value for the
final cast. The chunked decomposition of the CUDA backward
(``fused_ce_bwd_chunked_plain``) scores each chunk's columns in a product of
their own, so its f32 scores differ from the full product's in the last
bits, and it is held to the same bounds, and to 2**-10 of the sum of the
terms' magnitudes on average.

At f32 the CUDA backward runs on the bf16 tensor cores on three exact
bf16 planes of each f32 operand (``split_planes``), summing the six plane
pairs whose terms are of order 2**-16 or larger (``plane_product``): the
split is exact bit for bit, the dropped pairs are of order 2**-24 of the
terms, so the six-pair product in float64 lies within 1e-8 of the sum of
its terms' magnitudes of the float64 product, and the chunked plane
decomposition, in token slices too (``token_slices``), is held to the f32
bounds above. The f32 forward runs the same planes
(``fused_ce_fwd_planes_plain``): its nll and lse hold to 1e-5 of 1 +
|value| from float64, and to 1e-4 of the Pallas kernel's, at logits about
N(0, 4) and N(0, 64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_ce as jfce
from repro.kernels import ops as jops
from repro_torch.interop import to_tensor
from repro_torch.kernels.fused_ce import (BK, BM, BN, F32_MAX_DEPTH, PAIRS,
                                         SCRATCH_BYTES,
                                         bwd_schedule, ce_coef,
                                         fused_ce_bwd,
                                         fused_ce_bwd_chunked_plain,
                                         fused_ce_bwd_plain, fused_ce_fwd,
                                         fused_ce_fwd_planes_plain,
                                         fused_ce_fwd_plain, fwd_schedule,
                                         grad_items, grad_order,
                                         plane_product, split_planes,
                                         token_slices)
from repro_torch.kernels.ops import fused_ce_ref, fused_cross_entropy

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2 ** -7 + 1e-5)}


def _inputs(t, v, d, dtype, seed=0):
    """h about the final norm's scale, logits about N(0, 4), labels at
    V - 1 and 0 first, the mean-nll and selfnorm cotangents."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][0]
    h = np.asarray(jnp.asarray(rng.standard_normal((t, d)), jdt))
    w = np.asarray(jnp.asarray(rng.standard_normal((v, d)) * 2 / d ** 0.5,
                               jdt))
    labels = rng.integers(0, v, t).astype(np.int32)
    labels[0] = v - 1
    labels[1:2] = 0
    g_nll = np.full(t, 1.0 / t, np.float32)
    g_lse = (0.2 * rng.standard_normal(t) / t).astype(np.float32)
    return h, w, labels, g_nll, g_lse


def _torch(*arrays):
    return [to_tensor(a, device="cpu") for a in arrays]


def _within_terms(got, want, terms, rel, out_dtype):
    """|got - want| <= rel * sum |terms| (+ one step of the output dtype)."""
    got, want = got.float(), torch.from_numpy(np.array(want, np.float32))
    tol = rel * terms + 1e-12
    if out_dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.abs()
    err = (got - want).abs()
    assert (err <= tol).all(), f"max err / tol {(err / tol).max().item()}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("v", [128, 1000])
@pytest.mark.parametrize("t", [1, 37, 64])
def test_plain_versions_match_pallas(t, v, d, dtype):
    h, w, labels, g_nll, g_lse = _inputs(t, v, d, dtype)
    rel = DTYPES[dtype][2]
    j_nll, j_lse = jfce.fused_ce_fwd(jnp.asarray(h), jnp.asarray(w),
                                     jnp.asarray(labels))
    th, tw, tl, tgn, tgl = _torch(h, w, labels, g_nll, g_lse)
    nll, lse = fused_ce_fwd_plain(th, tw, tl)
    np.testing.assert_allclose(nll.numpy(), np.asarray(j_nll), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=1e-5,
                               atol=1e-5)
    j_dh, j_dw = jfce.fused_ce_bwd(jnp.asarray(h), jnp.asarray(w),
                                   jnp.asarray(labels), j_lse,
                                   jnp.asarray(g_nll), jnp.asarray(g_lse))
    dh, dw = fused_ce_bwd_plain(th, tw, tl, lse, tgn, tgl)
    assert dh.dtype == th.dtype and dw.dtype == tw.dtype
    coef = ce_coef(th, tw, tl, lse, tgn, tgl).abs()
    _within_terms(dh, j_dh.astype(jnp.float32), coef @ tw.float().abs(), rel,
                  dh.dtype)
    _within_terms(dw, j_dw.astype(jnp.float32), coef.T @ th.float().abs(),
                  rel, dw.dtype)


def test_wrappers_take_the_plain_version_on_cpu():
    h, w, labels, g_nll, g_lse = _torch(*_inputs(37, 1000, 64, "float32"))
    before = (fused_ce_fwd.launches, fused_ce_bwd.launches)
    for got, want in zip(fused_ce_fwd(h, w, labels),
                         fused_ce_fwd_plain(h, w, labels)):
        assert torch.equal(got, want)
    lse = fused_ce_fwd_plain(h, w, labels)[1]
    for cast in (True, False):
        for got, want in zip(
                fused_ce_bwd(h, w, labels, lse, g_nll, g_lse, cast=cast),
                fused_ce_bwd_plain(h, w, labels, lse, g_nll, g_lse,
                                   cast=cast)):
            assert torch.equal(got, want)
    assert (fused_ce_fwd.launches, fused_ce_bwd.launches) == before


def test_label_outside_vocab_gives_the_sentinel_not_nan():
    """As in the Pallas kernel, a label outside [0, V) leaves the label
    score at NEG: nll is about 1e30 and finite, and the label adds nothing
    to the gradient."""
    h, w, labels, g_nll, g_lse = _inputs(8, 128, 32, "float32")
    labels[2], labels[5] = 128, -1
    j_nll, j_lse = jfce.fused_ce_fwd(jnp.asarray(h), jnp.asarray(w),
                                     jnp.asarray(labels))
    th, tw, tl, tgn, tgl = _torch(h, w, labels, g_nll, g_lse)
    nll, lse = fused_ce_fwd_plain(th, tw, tl)
    assert torch.isfinite(nll).all() and nll[2] > 1e29 and nll[5] > 1e29
    np.testing.assert_allclose(nll.numpy(), np.asarray(j_nll), rtol=1e-5)
    j_dh, _ = jfce.fused_ce_bwd(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(labels), j_lse,
                                jnp.asarray(g_nll), jnp.asarray(g_lse))
    dh, _ = fused_ce_bwd_plain(th, tw, tl, lse, tgn, tgl)
    np.testing.assert_allclose(dh.numpy(), np.asarray(j_dh), atol=1e-6)


def test_function_gradients_match_jax_and_the_oracle():
    """d/d(h, w) of sum(a * nll) + sum(b * lse): both outputs carry a
    cotangent, as under the selfnorm loss."""
    h, w, labels, a, b = _inputs(37, 1000, 64, "float32", seed=3)

    def j_obj(h_, w_):
        nll, lse = jops.fused_cross_entropy(h_, w_, jnp.asarray(labels))
        return jnp.sum(jnp.asarray(a) * nll) + jnp.sum(jnp.asarray(b) * lse)

    j_val, (j_dh, j_dw) = jax.value_and_grad(j_obj, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ta, tb = _torch(a, b)
    grads = {}
    for name, fn in (("kernel", fused_cross_entropy), ("oracle", fused_ce_ref)):
        th, tw = (x.requires_grad_(True) for x in _torch(h, w))
        nll, lse = fn(th, tw, torch.from_numpy(labels))
        val = (ta * nll).sum() + (tb * lse).sum()
        val.backward()
        np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5)
        grads[name] = (th.grad, tw.grad)
    for got in grads.values():
        for g, want in zip(got, (j_dh, j_dw)):
            want = np.asarray(want)
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


def test_function_takes_zeros_for_an_unused_output():
    """Only nll used: the lse cotangent arrives as zeros, as with the JAX
    custom VJP."""
    h, w, labels, _, _ = _inputs(16, 128, 32, "float32", seed=4)

    def j_obj(h_, w_):
        return jops.fused_cross_entropy(h_, w_, jnp.asarray(labels))[0].mean()

    j_dh, j_dw = jax.grad(j_obj, argnums=(0, 1))(jnp.asarray(h),
                                                 jnp.asarray(w))
    th, tw = (x.requires_grad_(True) for x in _torch(h, w))
    fused_cross_entropy(th, tw, torch.from_numpy(labels))[0].mean().backward()
    for g, want in ((th.grad, j_dh), (tw.grad, j_dw)):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


GRAD_MEAN = 2 ** -10


def _within_terms_mean(got, want, terms, rel):
    """f32 gradients: |got - want| <= rel * sum |terms| per element, and
    GRAD_MEAN of it on average over the elements."""
    want = torch.from_numpy(np.array(want, np.float32)) \
        if not isinstance(want, torch.Tensor) else want.float()
    ratio = (got.float() - want).abs() / terms.clamp(min=1e-30)
    assert ratio.max().item() <= rel, ratio.max().item()
    assert ratio.mean().item() <= GRAD_MEAN, ratio.mean().item()


@pytest.mark.parametrize("t,v,d", [(1, 151936, 2560), (37, 151936, 2560),
                                   (129, 151936, 2560), (1024, 151936, 2560),
                                   (1024, 1000, 64), (4096, 151936, 2560),
                                   (200000, 1000, 64)])
def test_bwd_schedule(t, v, d):
    """Every vocab column falls in exactly one chunk, chunks are whole
    128-column tiles, the scratch stays within 32 MB wherever a 128-column
    chunk fits, and each chunk's dh and dW items are dealt once each:
    longest first within a CTA and within one item of the mean load, or
    round-robin in item order."""
    s = bwd_schedule(t, v)
    c = s["chunk"]
    assert c % BN == 0 and c >= BN
    starts = list(range(0, v, c))
    assert len(starts) == s["n_chunks"]
    cover = np.zeros(v, np.int64)
    for c0 in starts:
        cover[c0:c0 + c] += 1
    assert (cover == 1).all()
    assert s["scratch_bytes"] == 2 * t * c
    if 2 * t * BN <= SCRATCH_BYTES:
        assert s["scratch_bytes"] <= SCRATCH_BYTES
    if t == 1024 and v == 151936:
        assert c == 16384
    last = v - (s["n_chunks"] - 1) * c
    assert 0 < last <= c
    n_tt, n_dt = -(-t // BM), -(-d // BN)
    for valid in (c, last):
        nk = grad_items(t, d, valid)
        # dh: every (token tile, d tile) covers the chunk's columns;
        # dW: every (vocab tile, d tile) takes all T tokens
        n_dh = n_tt * n_dt
        assert nk[:n_dh] == [-(-valid // BK)] * n_dh
        assert nk[n_dh:] == [-(-t // BK)] * (-(-valid // BM) * n_dt)
        for longest_first in (True, False):
            order, start, loads = grad_order(t, d, valid, 132, longest_first)
            # each item dealt to exactly one CTA
            assert sorted(order) == list(range(len(nk)))
            assert start[0] == 0 and start[-1] == len(nk)
            assert len(loads) == len(start) - 1 == min(132, len(nk))
            for b in range(len(loads)):
                ids = order[start[b]:start[b + 1]]
                mine = [nk[p] for p in ids]
                assert sum(mine) == loads[b]
                if longest_first:
                    assert mine == sorted(mine, reverse=True)
                else:
                    assert list(ids) == list(range(b, len(nk), len(loads)))
            if longest_first:
                # to the least loaded: within one item of the mean
                assert max(loads) <= sum(nk) / len(loads) + max(nk)


@pytest.mark.parametrize("t,v", [(1, 151936), (37, 1000), (1024, 151936),
                                 (129, 257)])
def test_fwd_schedule(t, v):
    """Every 128-column vocab tile lies in exactly one split, and the CTAs
    get about two (token tile, split) units each."""
    s = fwd_schedule(t, v, 132)
    n_vt = -(-v // BN)
    assert s["n_vt"] == n_vt and s["n_tt"] == -(-t // BM)
    tiles = [sp * s["per"] + i for sp in range(s["n_split"])
             for i in range(min(s["per"], n_vt - sp * s["per"]))]
    assert sorted(tiles) == list(range(n_vt))
    assert all(sp * s["per"] < n_vt for sp in range(s["n_split"]))
    assert s["n_part"] == 2 * s["n_split"]
    assert s["grid"] == min(132, s["n_tt"] * s["n_split"])
    units = s["n_tt"] * s["n_split"]
    assert units <= 2 * 132 or s["n_split"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("selfnorm", [False, True])
@pytest.mark.parametrize("v,chunk", [(1000, 256), (257, 256), (128, 128)])
@pytest.mark.parametrize("t", [1, 37, 129])
def test_chunked_backward_matches_plain_and_pallas(t, v, chunk, selfnorm,
                                                   dtype):
    """The CUDA backward's decomposition (chunks of ``chunk`` columns, the
    last one ragged where the chunk does not divide V; V = C + 1 leaves a
    one-column chunk) against the unchunked plain version and the Pallas
    kernel, with and without a selfnorm cotangent."""
    h, w, labels, g_nll, g_lse = _inputs(t, v, 32, dtype, seed=t + v)
    if not selfnorm:
        g_lse = np.zeros_like(g_lse)
    rel = DTYPES[dtype][2]
    th, tw, tl, tgn, tgl = _torch(h, w, labels, g_nll, g_lse)
    lse = fused_ce_fwd_plain(th, tw, tl)[1]
    dh, dw = fused_ce_bwd_chunked_plain(th, tw, tl, lse, tgn, tgl,
                                        cast=False, chunk=chunk)
    p_dh, p_dw = fused_ce_bwd_plain(th, tw, tl, lse, tgn, tgl, cast=False)
    coef = ce_coef(th, tw, tl, lse, tgn, tgl).abs()
    dh_terms, dw_terms = coef @ tw.float().abs(), coef.T @ th.float().abs()
    _within_terms_mean(dh, p_dh, dh_terms, rel)
    _within_terms_mean(dw, p_dw, dw_terms, rel)
    j_lse = jfce.fused_ce_fwd(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(labels))[1]
    j_dh, j_dw = jfce.fused_ce_bwd(jnp.asarray(h), jnp.asarray(w),
                                   jnp.asarray(labels), j_lse,
                                   jnp.asarray(g_nll), jnp.asarray(g_lse))
    _within_terms(dh.to(th.dtype), j_dh.astype(jnp.float32), dh_terms, rel,
                  th.dtype)
    _within_terms(dw.to(tw.dtype), j_dw.astype(jnp.float32), dw_terms, rel,
                  tw.dtype)
    c_dh, c_dw = fused_ce_bwd_chunked_plain(th, tw, tl, lse, tgn, tgl,
                                            chunk=chunk)
    assert c_dh.dtype == th.dtype and c_dw.dtype == tw.dtype
    assert torch.equal(c_dh, dh.to(th.dtype))
    assert torch.equal(c_dw, dw.to(tw.dtype))


def test_chunked_backward_default_chunk_and_sentinel_labels():
    """With no chunk given it takes ``bwd_schedule``'s; labels outside
    [0, V) add nothing, as in the unchunked version."""
    h, w, labels, g_nll, g_lse = _inputs(8, 300, 32, "float32", seed=5)
    labels[2], labels[5] = 300, -1
    th, tw, tl, tgn, tgl = _torch(h, w, labels, g_nll, g_lse)
    lse = fused_ce_fwd_plain(th, tw, tl)[1]
    want = fused_ce_bwd_plain(th, tw, tl, lse, tgn, tgl)
    for chunk in (None, 128):
        got = fused_ce_bwd_chunked_plain(th, tw, tl, lse, tgn, tgl,
                                         chunk=chunk)
        for g, x in zip(got, want):
            np.testing.assert_allclose(g.numpy(), x.numpy(), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("shape", [(1,), (7, 13), (129, 100), (3, 5, 37)])
def test_split_planes_is_exact(shape):
    """x0 + x1 + x2 == x bit for bit (summed in f32 in that order) over
    magnitudes 2**-60 .. 2**60, +0 and -0 included, at ragged shapes; each
    plane is bf16 and each is at most half a bf16 step of the one before."""
    rng = np.random.default_rng(len(shape) + shape[-1])
    n = int(np.prod(shape))
    vals = (rng.standard_normal(n) * np.exp2(rng.integers(-60, 61, n))
            ).astype(np.float32)
    vals[: min(n, 2)] = np.array([0.0, -0.0], np.float32)[: min(n, 2)]
    x = torch.from_numpy(vals.reshape(shape))
    x0, x1, x2 = split_planes(x)
    assert all(p.dtype == torch.bfloat16 and p.shape == x.shape
               for p in (x0, x1, x2))
    back = (x0.float() + x1.float()) + x2.float()
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))
    assert torch.equal(x0.float(), x.to(torch.bfloat16).float())
    assert (x1.float().abs() <= 2.0 ** -8 * x0.float().abs()).all()
    assert (x2.float().abs() <= 2.0 ** -8 * x1.float().abs()).all()
    # a value exact in bf16 has zero residual planes with its sign
    neg_zero = split_planes(torch.tensor([-0.0, -1.5, 2.0]))
    assert torch.equal(torch.signbit(neg_zero[1].float()),
                       torch.tensor([True, True, False]))


@pytest.mark.parametrize("m,k,n", [(64, 2560, 96), (37, 100, 129),
                                   (1, 4, 1)])
def test_plane_product_matches_float64(m, k, n):
    """The six pairs of ``PAIRS`` (all pairs i + j <= 2, each once) summed
    in float64 lie within 1e-8 of the sum of the terms' magnitudes of the
    float64 product of the f32 operands, h-like by W-like (std 0.02)."""
    assert sorted(PAIRS) == sorted((i, j) for i in range(3)
                                   for j in range(3) if i + j <= 2)
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((k, n)) * 0.02
                          ).astype(np.float32))
    want = a.double() @ b.double()
    terms = a.double().abs() @ b.double().abs()
    pa, pb = split_planes(a), split_planes(b)
    got = sum(pa[i].double() @ pb[j].double() for i, j in PAIRS)
    assert ((got - want).abs() <= 1e-8 * terms).all()
    # in f32 sums it stays an f32-accurate product
    got32 = plane_product(pa, pb)
    assert got32.dtype == torch.float32
    assert ((got32.double() - want).abs() <= 1e-6 * terms + 1e-30).all()


@pytest.mark.parametrize("t,v,d,chunk,depth", [(37, 300, 100, 128, None),
                                               (129, 257, 100, None, None),
                                               (8, 1000, 4, 256, None),
                                               (150, 300, 8, 128, 64)])
def test_plane_backward_matches_pallas_f32(t, v, d, chunk, depth):
    """The f32 backward's decomposition as the CUDA kernel computes it (h
    and each chunk of w split into planes, scores, dh and dW as six-pair
    plane products, the coefficient split unrounded; d a multiple of 4 but
    not of 32; with ``depth``, token slices whose dW adds to the earlier
    ones') against the Pallas kernel (interpret mode) within the f32
    tolerance, with a selfnorm cotangent."""
    h, w, labels, g_nll, g_lse = _inputs(t, v, d, "float32", seed=t * v)
    rel = DTYPES["float32"][2]
    th, tw, tl, tgn, tgl = _torch(h, w, labels, g_nll, g_lse)
    lse = fused_ce_fwd_plain(th, tw, tl)[1]
    dh, dw = fused_ce_bwd_chunked_plain(th, tw, tl, lse, tgn, tgl,
                                        chunk=chunk, depth=depth)
    assert dh.dtype == torch.float32 and dw.dtype == torch.float32
    j_lse = jfce.fused_ce_fwd(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(labels))[1]
    j_dh, j_dw = jfce.fused_ce_bwd(jnp.asarray(h), jnp.asarray(w),
                                   jnp.asarray(labels), j_lse,
                                   jnp.asarray(g_nll), jnp.asarray(g_lse))
    coef = ce_coef(th, tw, tl, lse, tgn, tgl).abs()
    _within_terms_mean(dh, j_dh, coef @ tw.abs(), rel)
    _within_terms_mean(dw, j_dw, coef.T @ th.abs(), rel)


@pytest.mark.parametrize("logit_std", [2, 8])
@pytest.mark.parametrize("t,v,d", [(37, 1000, 100), (8, 300, 4),
                                   (64, 129, 100)])
def test_plane_forward_matches_pallas_and_float64(t, v, d, logit_std):
    """The f32 forward's decomposition as the CUDA kernel computes it (h and
    w split into planes, the scores as six-pair plane products, then the
    LSE and the label's score) at ragged V, d of 4 and 100, labels at V - 1,
    0, V and -1 (the last two outside [0, V): nll about 1e30), logits about
    N(0, 4) and N(0, 64): nll and lse within 1e-5 of 1 + |value| of float64
    and within 1e-4 of the Pallas kernel (interpret mode)."""
    h, w, labels, _, _ = _inputs(t, v, d, "float32", seed=t + v + d)
    w = (w * (logit_std / 2)).astype(np.float32)
    labels[2], labels[3] = v, -1
    th, tw, tl = _torch(h, w, labels)
    nll, lse = fused_ce_fwd_planes_plain(th, tw, tl)
    assert nll.dtype == torch.float32 and lse.dtype == torch.float32
    logits = th.double() @ tw.double().T
    want_lse = torch.logsumexp(logits, -1)
    lab = tl.long()
    ok = (lab >= 0) & (lab < v)
    picked = logits.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
    want_nll = want_lse - torch.where(ok, picked, torch.full_like(picked,
                                                                  -1e30))
    for got, want in ((nll, want_nll), (lse, want_lse)):
        assert ((got.double() - want).abs()
                <= 1e-5 * (1 + want.abs())).all()
    assert nll[2] > 1e29 and nll[3] > 1e29
    j_nll, j_lse = jfce.fused_ce_fwd(jnp.asarray(h), jnp.asarray(w),
                                     jnp.asarray(labels))
    np.testing.assert_allclose(nll.numpy(), np.asarray(j_nll), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("t,v", [(1, 151936), (37, 151936), (129, 151936),
                                 (1024, 151936), (1024, 1000),
                                 (4096, 151936), (200000, 1000)])
def test_bwd_schedule_f32(t, v):
    """At f32 the coefficient scratch holds three bf16 planes, 6 bytes an
    element: every vocab column falls in exactly one chunk, chunks are
    whole 128-column tiles of at most F32_MAX_DEPTH columns (dh's depth in
    one tensor-core sum), and the (3, T, C) scratch stays within 32 MB
    wherever a 128-column chunk fits (C = 5376 at T = 1024)."""
    s = bwd_schedule(t, v, torch.float32)
    c = s["chunk"]
    assert c % BN == 0 and BN <= c <= F32_MAX_DEPTH
    assert len(range(0, v, c)) == s["n_chunks"]
    cover = np.zeros(v, np.int64)
    for c0 in range(0, v, c):
        cover[c0:c0 + c] += 1
    assert (cover == 1).all()
    assert s["scratch_bytes"] == 6 * t * c
    if 6 * t * BN <= SCRATCH_BYTES:
        assert s["scratch_bytes"] <= SCRATCH_BYTES
        # the largest such chunk, unless one chunk covers V or the cap
        assert (6 * t * (c + BN) > SCRATCH_BYTES
                or c >= -(-v // BN) * BN or c == F32_MAX_DEPTH)
    if (t, v) == (1024, 151936):
        assert (c, s["n_chunks"]) == (5376, 29)
    if t <= 512 and v > F32_MAX_DEPTH:
        assert c == F32_MAX_DEPTH
    last = v - (s["n_chunks"] - 1) * c
    assert 0 < last <= c


@pytest.mark.parametrize("t", [1, 1024, 8192, 8193, 20000, 200000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_token_slices(t, dtype):
    """The backward's token slices cover every token once, in order: all of
    T in one slice at bf16; at f32 as few slices as keep each within
    F32_MAX_DEPTH tokens (dW's depth in one tensor-core sum), the same size
    but for a shorter last one."""
    s = token_slices(t, dtype)
    assert s[0][0] == 0 and s[-1][1] == t
    assert all(a[1] == b[0] for a, b in zip(s, s[1:]))
    if dtype == torch.bfloat16:
        assert s == [(0, t)]
        return
    sizes = [t1 - t0 for t0, t1 in s]
    assert len(s) == -(-t // F32_MAX_DEPTH)
    assert max(sizes) <= F32_MAX_DEPTH and min(sizes) >= 1
    assert all(n == sizes[0] for n in sizes[:-1]) and sizes[-1] <= sizes[0]
    small = token_slices(t, dtype, depth=64)
    assert len(small) == -(-t // 64) and small[-1][1] == t
    assert all(0 < t1 - t0 <= 64 for t0, t1 in small)
