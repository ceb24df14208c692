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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_ce as jfce
from repro.kernels import ops as jops
from repro_torch.interop import to_tensor
from repro_torch.kernels.fused_ce import (BK, BM, BN, SCRATCH_BYTES,
                                         bwd_schedule, ce_coef,
                                         fused_ce_bwd,
                                         fused_ce_bwd_chunked_plain,
                                         fused_ce_bwd_plain, fused_ce_fwd,
                                         fused_ce_fwd_plain, fwd_schedule,
                                         grad_items, grad_order)
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
