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
final cast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_ce as jfce
from repro.kernels import ops as jops
from repro_torch.interop import to_tensor
from repro_torch.kernels.fused_ce import (ce_coef, fused_ce_bwd,
                                         fused_ce_bwd_plain, fused_ce_fwd,
                                         fused_ce_fwd_plain)
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
