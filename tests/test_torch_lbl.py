"""The port's log-bilinear model (``repro_torch.models.lbl``) and the
paper's Table 4 study (``repro_torch.studies.table4_lbl``) against the JAX
package's ``repro.models.lbl`` and ``benchmarks/table4_lbl.py`` on the CPU,
on JAX's parameters (``interop.lbl_params_from_numpy``), noise words,
k-means assignment and tail draws.

Tolerances: f32, as ``tests/test_torch_train.py`` states: values to 1e-5
relative, gradients to 1e-4 of their largest magnitude; parameters after a
few SGD steps to 1e-5 of a leaf's largest magnitude (plain SGD does not
magnify rounding as Adam does). Table 4's AbsE sums |Z_hat - Z| over
queries with Z up to exp(log Z): an f32 log Z 1e-6 off moves Z by 1e-6
relative, so the sums hold to 1e-4 relative and %Better exactly (no
query's two errors lie that close on these draws).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import table4_lbl as j_t4
from repro.core import build_ivf as j_build_ivf
from repro.core import exact_log_z as j_exact_log_z
from repro.core import mimps_ivf as j_mimps_ivf
from repro.data import zipf_probs as j_zipf_probs
from repro.models import lbl as jlbl
from repro_torch.core.mips import build_ivf
from repro_torch.interop import lbl_params_from_numpy
from repro_torch.models import lbl
from repro_torch.studies import table4_lbl as t4

VOCAB, D, CTX, B, K = 512, 16, 4, 8, 6


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_params(seed=0):
    jp = jlbl.init_lbl(jax.random.PRNGKey(seed), VOCAB, D, CTX)
    jp["b"] = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1), (VOCAB,))
    return jp


def _port(jp):
    return lbl_params_from_numpy(_np(jp["r"]), _np(jp["c"]), _np(jp["b"]),
                                 device="cpu")


def _close(got, want, rel=1e-5, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * np.abs(want).max() * 1e-2 + 1e-30,
                               err_msg=what)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (B, CTX)), rng.integers(0, VOCAB, B),
            rng.integers(0, VOCAB, (B, K)))


def test_functions_match_jax():
    jp = _jax_params()
    p = _port(jp)
    ctx, tgt, noise = _data()
    jq = jlbl.context_vector(jp, jnp.asarray(ctx))
    q = lbl.context_vector(p, _t(ctx))
    _close(q.numpy(), _np(jq), what="context_vector")
    _close(lbl.scores(p, q).numpy(), _np(jlbl.scores(jp, jq)),
           what="scores")
    _close(lbl.scores(p, q, _t(tgt)).numpy(),
           _np(jlbl.scores(jp, jq, jnp.asarray(tgt))), what="scores target")
    _close(lbl.scores(p, q, _t(noise)).numpy(),
           _np(jlbl.scores(jp, jq, jnp.asarray(noise))), what="scores noise")
    assert torch.equal(lbl.class_vectors(p),
                       _t(_np(jlbl.class_vectors(jp))))
    _close(lbl.query_vector(p, _t(ctx)).numpy(),
           _np(jlbl.query_vector(jp, jnp.asarray(ctx))), what="query")


def test_nce_loss_and_grad_match_jax():
    jp = _jax_params(1)
    ctx, tgt, noise = _data(1)
    lp = np.log(j_zipf_probs(VOCAB)).astype(np.float32)
    jlnp = (jnp.asarray(lp[tgt]), jnp.asarray(lp[noise]))

    def jl(p):
        return jlbl.nce_loss(p, jnp.asarray(ctx), jnp.asarray(tgt),
                             jnp.asarray(noise), jlnp, K)
    jv, jg = jax.value_and_grad(jl)(jp)
    p = {k: v.requires_grad_(True) for k, v in _port(jp).items()}
    val = lbl.nce_loss(p, _t(ctx), _t(tgt), _t(noise),
                       (_t(lp[tgt]), _t(lp[noise])), K)
    _close(val.item(), float(jv), what="nce loss")
    grads = torch.autograd.grad(val, list(p.values()))
    for name, g in zip(p, grads):
        want = _np(jg[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_init_lbl():
    a = lbl.init_lbl(torch.Generator().manual_seed(3), VOCAB, D, CTX,
                     device="cpu")
    b = lbl.init_lbl(torch.Generator().manual_seed(3), VOCAB, D, CTX,
                     device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["r"].shape == (VOCAB, D) and a["c"].shape == (CTX, D, D)
    assert not a["b"].any()
    assert abs(a["r"].std().item() - 0.1) < 0.01
    assert abs(a["c"].std().item() - D ** -0.5) < 0.02


def _jax_noise(key, vocab, steps, batch, n_noise):
    log_probs = jnp.log(jnp.asarray(j_zipf_probs(vocab)))
    return [_np(jax.random.categorical(jax.random.fold_in(key, 10_000 + i),
                                       log_probs[None, :],
                                       shape=(batch, n_noise)))
            for i in range(steps)]


def test_train_lbl_matches_jax():
    """Three SGD steps of the JAX script's train_lbl from its parameters
    and noise words."""
    key = jax.random.PRNGKey(2)
    kw = dict(vocab=VOCAB, d=D, ctx=CTX, steps=3, batch=B, n_noise=K)
    jp, _, jloss = j_t4.train_lbl(key, **kw)
    p0 = jlbl.init_lbl(key, VOCAB, D, CTX)
    p, _, loss = t4.train_lbl(None, params=_port(p0),
                              noise=_jax_noise(key, VOCAB, 3, B, K),
                              device="cpu", **kw)
    _close(loss, jloss, what="last loss")
    for name in p:
        want = _np(jp[name])
        np.testing.assert_allclose(p[name].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_noise_sampler_draws_zipf():
    log_probs, sample = t4.noise_sampler(64, "cpu")
    ids = sample(torch.Generator().manual_seed(0), (20000,))
    freq = torch.bincount(ids, minlength=64).double() / ids.numel()
    np.testing.assert_allclose(freq[:4].numpy(),
                               np.exp(log_probs[:4].double().numpy()),
                               rtol=0.05)
    assert ids.max() < 64


def test_pad_columns_keeps_every_product():
    """The zero columns the kernels need leave log Z and MIMPS exactly
    (plain path, the same assignment and draws)."""
    rng = np.random.default_rng(0)
    v = _t(rng.standard_normal((600, 101)).astype(np.float32) * 0.3)
    q = _t(rng.standard_normal((12, 101)).astype(np.float32) * 0.3)
    vp, qp = t4.pad_columns(v), t4.pad_columns(q)
    assert vp.shape == (600, 104) and not vp[:, 101:].any()
    assert torch.equal(t4.pad_columns(vp), vp)
    index = build_ivf(vp, 32, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    plain = build_ivf(v, 32, assign=index.assign, device="cpu")
    draws = {10: torch.randint(0, 600, (12, 10),
                               generator=torch.Generator().manual_seed(1))}
    a = t4.estimates(vp, qp, index, draws, ((4, 10),), use_kernel=False)
    b = t4.estimates(v, q, plain, draws, ((4, 10),), use_kernel=False)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(a[1][(4, 10)], b[1][(4, 10)], rtol=0,
                               atol=1e-6)
    # the kernel path (its plain versions on CPU tensors) on the padding
    k = t4.estimates(vp, qp, index, draws, ((4, 10),))
    torch.testing.assert_close(k[1][(4, 10)], a[1][(4, 10)], rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def reduced_table4():
    """The JAX script's evaluation at a reduced size on JAX-trained
    parameters, and the port's on the same parameters, assignment and
    tail draws."""
    vocab, n_test, steps = 2048, 64, 8
    key = jax.random.PRNGKey(7)
    jp, corpus, _ = j_t4.train_lbl(key, vocab=vocab, steps=steps, batch=64)
    v = jlbl.class_vectors(jp)
    idx = j_build_ivf(jax.random.fold_in(key, 1), v, block_rows=128)
    toks = jnp.asarray(corpus.batch(t4.HELD_OUT_STEP, n_test, 4))
    q = jlbl.query_vector(jp, toks[:, :4])
    lz_true = jax.vmap(lambda qq: j_exact_log_z(v, qq))(q)
    keys = jax.random.split(jax.random.fold_in(key, 2), n_test)
    want, draws = {}, {}
    for n_probe, l in t4.PAIRS:
        want[(n_probe, l)] = jax.vmap(
            lambda qq, kk: j_mimps_ivf(idx, qq, n_probe, l, kk).log_z)(q,
                                                                      keys)
        draws[l] = np.array(jax.vmap(
            lambda kk: jax.random.randint(kk, (l,), 0, vocab))(keys))
    jrows = t4.table_rows(_t(_np(lz_true)),
                          {k: _t(_np(x)) for k, x in want.items()}, vocab,
                          v.shape[1], idx.n_blocks)
    params = lbl_params_from_numpy(_np(jp["r"]), _np(jp["c"]), _np(jp["b"]),
                                   device="cpu")
    res = t4.run(device="cpu", params=params,
                 assign=np.array(idx.assign), draws=draws,
                 sizes=dict(vocab=vocab, steps=0, n_test=n_test))
    return jrows, res, idx


def test_reduced_table4_matches_jax(reduced_table4):
    """AbsE-MIPS, AbsE-NCE, %Better and the FLOP speed-up equal JAX's on
    its trained parameters and draws; the kernels hold to the plain path
    and the padding changes nothing."""
    jrows, res, idx = reduced_table4
    assert res["sizes"]["n_blocks"] == idx.n_blocks
    assert res["sizes"]["padded_d"] == 104
    for got, want in zip(res["rows"], jrows):
        assert (got["n_probe"], got["l"]) == (want["n_probe"], want["l"])
        _close(got["abse_mips"], want["abse_mips"], 1e-4, "abse_mips")
        _close(got["abse_nce"], want["abse_nce"], 1e-4, "abse_nce")
        assert got["better"] == want["better"]
        _close(got["speedup_flops"], want["speedup_flops"], 1e-12,
               "speedup")
        assert got["t_us"] > 0 and got["exact_t_us"] > 0
    assert res["kernel_max_abs_err"] <= 1e-5
    assert res["pad_max_abs_diff"] <= 1e-6


def test_run_quick_trains_and_orders():
    """``run`` from its own generator at a small size: a finite falling
    NCE loss and every row well formed."""
    res = t4.run(device="cpu", sizes=dict(vocab=4096, steps=10, n_test=32))
    assert np.isfinite(res["final_loss"]) and res["train_seconds"] > 0
    assert [(r["n_probe"], r["l"]) for r in res["rows"]] == list(t4.PAIRS)
    for r in res["rows"]:
        assert np.isfinite(r["abse_mips"]) and 0 <= r["better"] <= 100
    assert res["kernel_max_abs_err"] <= 1e-5
