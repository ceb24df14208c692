"""The VLM family in the port against the JAX package at
``reduced_config("llama-3.2-vision-90b")`` (10 layers: two groups of 4 self
+ 1 cross-attention block; d 128, 4 heads over 1 KV head, 16 image tokens;
vocab 1024), f32, CPU, on the JAX init carried across by
``interop.params_from_numpy``. The image embeddings are standard normal
draws from numpy (seed 11), as ``tests/test_models.py`` draws its image.

Tolerances: ``cross_attention`` within 1e-6; ``forward``'s hidden states
and three decode steps within 1e-5 relative to max(1, max |h|), every
state leaf within 1e-5 of its magnitude after every step; ``generate``
(exact and mimps, greedy, the JAX tail draws injected) gives JAX's tokens
with log Ẑ and log_prob within 1e-4, and the host loop equals the runner
bit for bit, with a second image giving other tokens; ``loss_fused_ce``
and ``loss_ce`` to 1e-5 relative and every gradient leaf (the image's
too) within 1e-4 of that leaf's largest magnitude, as in
``test_torch_family_train.py``; two microbatches of ``make_train_step``
carry the image row by row (loss, grad norm, lr to 1e-5 relative). The
slot scheduler refuses a VLM engine, as the JAX scheduler cannot step one;
a VLM without an image and another family with one raise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
import _torch_serving as S
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models.attention import cross_attention as j_cross_attention
from repro.serve import generate as j_generate
from repro.train import losses as jlosses
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import TrainConfig, reduced_config
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.models.attention import cross_attention
from repro_torch.serve import Scheduler, generate
from repro_torch.train import losses, optimizer, train_loop
from repro_torch.train.optimizer import tree_leaves, tree_map

ARCH = "llama-3.2-vision-90b"
TOL = 1e-5
SERVE_TOL = 1e-4
B, S_TRAIN = 2, 24


def _img(cfg, b, seed=11):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    return F.build(ARCH)


def test_init_tree_equals_jax():
    got, want = F.init_shapes(ARCH)
    assert got == want
    assert {"self_groups", "cross_groups"} <= {k.split("'")[1] for k in got}
    wq = "['self_groups']['attn']['wq']"
    assert got[wq][0][:2] == (2, 4)
    assert got["['cross_groups']['attn']['wq']"][0][0] == 2


def test_params_from_numpy_checks_the_cross_groups_width(model):
    npp = jax.tree.map(lambda a: a, model["npp"])
    wq = npp["cross_groups"]["attn"]["wq"]
    npp["cross_groups"]["attn"]["wq"] = wq[..., :wq.shape[-1] // 2]
    with pytest.raises(ValueError, match="cross_groups.attn.wq"):
        params_from_numpy(npp, model["tcfg"], device="cpu")
    tp = params_from_numpy(model["npp"], model["tcfg"], device="cpu")
    assert tuple(tp["cross_groups"]["attn"]["wq"].shape) == wq.shape


def test_cross_attention_equals_jax(model):
    cfg = model["tcfg"]
    rng = np.random.default_rng(0)
    p = {k: np.array(v[0]) for k, v in
         model["npp"]["cross_groups"]["attn"].items()}
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    img = _img(cfg, 2)
    want = j_cross_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             jnp.asarray(img), model["jcfg"])
    got = cross_attention({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), torch.from_numpy(img), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_forward_with_image_equals_jax(model):
    toks = np.random.default_rng(2).integers(0, model["tcfg"].vocab, (2, 20))
    assert F.forward_err(model, toks, img=_img(model["tcfg"], 2)) <= TOL


def test_decode_steps_equal_jax(model):
    toks = np.random.default_rng(3).integers(0, model["tcfg"].vocab, (2, 3))
    h_err, leaf_err = F.decode_errs(model, toks, max_len=8,
                                    img=_img(model["tcfg"], 2))
    assert h_err <= TOL
    assert set(leaf_err) == {"['self']['k']", "['self']['v']"}
    for name, err in leaf_err.items():
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("method", ["exact", "mimps"])
def test_generate_equals_jax(model, method):
    jeng, teng = F.engines(model, method, max_len=32)
    key = jax.random.PRNGKey(9)
    prompt = np.random.default_rng(5).integers(0, S.VOCAB, (3, 12))
    img = _img(model["tcfg"], 3)
    jt, jaux = j_generate(jeng, jnp.asarray(prompt, jnp.int32), 6, key,
                          img=jnp.asarray(img), return_aux=True)
    runs = [generate(teng, prompt, 6, return_aux=True,
                     img=torch.from_numpy(im), host_loop=host,
                     tail_source=F._tail_source(key, 64, S.VOCAB))
            for im, host in ((img, False), (img, True),
                             (_img(model["tcfg"], 3, seed=12), False))]
    (tt, taux), (ht, haux), (other, _) = runs
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for name in ("log_z", "log_prob"):
        np.testing.assert_allclose(taux[name].numpy(), np.asarray(jaux[name]),
                                   rtol=SERVE_TOL, atol=SERVE_TOL,
                                   err_msg=name)
        assert torch.equal(taux[name], haux[name]), name
    assert torch.equal(tt, ht)
    assert not torch.equal(other, tt)          # the image reaches the tokens


def _batch(cfg):
    tokens, labels = next(DataIterator(SyntheticCorpus(cfg.vocab, seed=5), B,
                                       S_TRAIN))
    return {"tokens": tokens, "labels": labels, "img": _img(cfg, B)}


def _keyed(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("loss", ["fused_ce", "ce"])
def test_loss_and_grads_with_image_equal_jax(model, loss):
    m = model
    batch = _batch(m["tcfg"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = {"backend": "xla"} if loss == "fused_ce" else {}

    def f(p, img):
        return jlosses.get_loss(loss)(m["jm"], p, dict(jb, img=img),
                                      jax.random.PRNGKey(0),
                                      JTrainConfig(loss=loss), **kw)
    (jval, jmet), (jg, jgi) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(m["jp"], jb["img"])
    params = tree_map(lambda t: t.clone().requires_grad_(True), m["tp"])
    img = torch.from_numpy(batch["img"]).requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items() if k != "img"}
    val, met = losses.get_loss(loss)(m["tm"], params, dict(tb, img=img),
                                     None, TrainConfig(loss=loss))
    np.testing.assert_allclose(val.item(), float(jval), rtol=TOL)
    assert met.keys() == jmet.keys()
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(val, leaves + [img])
    it = iter(grads)
    got = _keyed(tree_map(lambda _: next(it), params))
    got["img"] = next(it)
    want = dict(_keyed(jg), img=jgi)
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(got[name].double().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-30,
                                   err_msg=f"{loss} grad {name}")


def test_microbatched_train_step_carries_the_image(model):
    m = model
    batch = _batch(m["tcfg"])
    cfg = dict(warmup_steps=1, microbatches=2)
    jstate = jloop.TrainState(params=m["jp"],
                              opt=jopt.init_opt_state(m["jp"]),
                              rng=jax.random.PRNGKey(0))
    _, jmet = jax.jit(jloop.make_train_step(m["jm"], JTrainConfig(**cfg),
                                            backend="xla"))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.clone(), m["tp"])
    state = train_loop.TrainState(params=params,
                                  opt=optimizer.init_opt_state(params),
                                  rng=torch.Generator().manual_seed(0))
    _, met = train_loop.make_train_step(m["tm"], TrainConfig(**cfg))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss_total", "loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=TOL,
                                   err_msg=k)


def test_scheduler_refuses_a_vlm_engine(model):
    _, teng = F.engines(model, "mimps", max_len=32)
    with pytest.raises(NotImplementedError, match="no image"):
        Scheduler(teng, 3)


def test_image_required_by_a_vlm_and_refused_elsewhere(model):
    m = model
    toks = torch.zeros((2, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="image"):
        m["tm"].forward(m["tp"], toks)
    with pytest.raises(ValueError, match="image"):
        m["tm"].decode_step(m["tp"], m["tm"].init_decode_state(2, 8, "cpu"),
                            toks[:, 0], 0)
    _, teng = F.engines(m, "exact", max_len=16)
    with pytest.raises(ValueError, match="image"):
        generate(teng, toks, 2)
    dense = dataclasses.replace(reduced_config("qwen1.5-4b"), vocab=64)
    tm = Model(dense)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="no image"):
        tm.forward(tp, toks, img=torch.zeros((2, 16, dense.d_model),
                                             dtype=torch.bfloat16))
