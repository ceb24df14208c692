"""The port's training path against the JAX package's on the CPU, on the
same numpy inputs and the same (JAX-drawn) parameters: synthetic batches,
the full-sequence forward, the losses and their gradients, the AdamW step
and three train steps (with and without microbatching), and the training
counters.

Tolerances. f32 throughout the loss and step checks: the two frameworks sum
the same f32 products in other orders (about 1e-7 relative per sum), so the
loss holds to 1e-5 relative and every gradient leaf to 1e-4 of that leaf's
largest magnitude. Adam's update m_hat / (sqrt(v_hat) + eps) is scale-free:
an entry whose gradient is near zero can step differently by up to the
learning rate when its two float gradients differ in the last bits (the
key bias, whose gradient is nearly shift-invariant noise, is the worst
leaf). So after three steps, which move an entry by about 3 learning
rates, every entry holds to 0.25 of the learning rate and each leaf's
update p - p0 to 5e-3 in relative L2 norm; a wrong update rule (decay,
bias correction, clipping) misses both by far.
The bf16 forward is held to 2**-5 of max |h| per element and 2**-9 of it
on average: each matmul output is rounded to bf16 (8 significant bits) on
both sides from f32 sums taken in another order, so single elements round
one step apart and carry that through the layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import synthetic as jsyn
from repro.models import Model as JModel
from repro.train import losses as jlosses
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import TrainConfig, reduced_config
from repro_torch.data import DataIterator, DataState, SyntheticCorpus
from repro_torch.interop import opt_state_from_numpy, params_from_numpy
from repro_torch.models import Model
from repro_torch.train import losses, optimizer, train_loop
from repro_torch.train.optimizer import tree_leaves

B, S = 4, 16


def _cfgs(dtype="float32", remat="none"):
    over = dict(dtype=dtype, remat=remat)
    return (dataclasses.replace(j_reduced_config("qwen1.5-4b"), **over),
            dataclasses.replace(reduced_config("qwen1.5-4b"), **over))


def _jax_params(jm, seed=0):
    """JAX init with non-zero qkv biases, so the bias path is exercised."""
    jp = jm.init(jax.random.PRNGKey(seed))
    jp["blocks"]["attn"] = dict(jp["blocks"]["attn"])
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        leaf = jp["blocks"]["attn"][name]
        jp["blocks"]["attn"][name] = jnp.asarray(
            0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
    return jp


def _to_torch(jp, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _batches(vocab, n, b=B, s=S):
    it = DataIterator(SyntheticCorpus(vocab, seed=5), b, s)
    return [dict(zip(("tokens", "labels"), next(it))) for _ in range(n)]


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_tree_close(got, want, rel, what):
    want = dict(_leaf_items(jax.tree.map(np.asarray, want)))
    got = dict(_leaf_items(got))
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name].detach().float().numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-30,
                                   err_msg=f"{what} {name}")


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed,b,s,shard,codebooks", [
    (512, 0, 4, 16, 0, 0), (151936, 3, 2, 33, 1, 0), (64, 1, 3, 8, 2, 2)])
def test_batches_equal_jax(vocab, seed, b, s, shard, codebooks):
    mine = DataIterator(SyntheticCorpus(vocab, seed=seed), b, s, shard=shard,
                        n_shards=3, n_codebooks=codebooks)
    theirs = jsyn.DataIterator(jsyn.SyntheticCorpus(vocab, seed=seed), b, s,
                               shard=shard, n_shards=3,
                               n_codebooks=codebooks)
    for _ in range(3):
        for x, y in zip(next(mine), next(theirs)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert mine.state.to_dict() == theirs.state.to_dict() == {"step": 3}
    resumed = DataIterator(SyntheticCorpus(vocab, seed=seed), b, s,
                           shard=shard, n_shards=3, n_codebooks=codebooks,
                           state=DataState.from_dict({"step": 2}))
    theirs = jsyn.DataIterator(jsyn.SyntheticCorpus(vocab, seed=seed), b, s,
                               shard=shard, n_shards=3,
                               n_codebooks=codebooks,
                               state=jsyn.DataState(2))
    assert all(np.array_equal(x, y)
               for x, y in zip(next(resumed), next(theirs)))


# -- forward -------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, remat):
    jcfg, tcfg = _cfgs(dtype, remat)
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = _jax_params(jm)
    toks = _batches(tcfg.vocab, 1, b=2, s=24)[0]["tokens"]
    jh, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    th, aux = tm.forward(_to_torch(jp, tcfg), torch.from_numpy(toks))
    assert th.dtype == (torch.float32 if dtype == "float32"
                        else torch.bfloat16)
    assert aux == {"moe_balance": 0.0, "moe_zloss": 0.0,
                   "moe_drop_frac": 0.0}
    want = np.asarray(jh.astype(jnp.float32))
    err = np.abs(th.float().numpy() - want)
    scale = np.abs(want).max()
    if dtype == "float32":
        assert err.max() <= 1e-5 * scale
    else:
        assert err.max() <= 2 ** -5 * scale and err.mean() <= 2 ** -9 * scale


def test_remat_gives_the_same_gradients():
    """The checkpointed blocks recompute the same activations, so the
    gradients equal those of the plain forward bit for bit."""
    grads = {}
    for remat in ("none", "full"):
        _, tcfg = _cfgs(remat=remat)
        tm = Model(tcfg)
        params = tm.init(torch.Generator().manual_seed(0), device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = _tbatch(_batches(tcfg.vocab, 1)[0])
        loss, _ = losses.loss_fused_ce(tm, params, batch, None, TrainConfig())
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["none"], grads["full"]):
        assert torch.equal(a, b)


# -- losses and gradients -----------------------------------------------------

@pytest.mark.parametrize("loss,backend", [("fused_ce", "pallas"),
                                          ("fused_ce", "xla"),
                                          ("selfnorm", "pallas"),
                                          ("selfnorm", "xla"),
                                          ("ce", None)])
def test_loss_and_grads_match_jax(loss, backend):
    jcfg, tcfg = _cfgs()
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = _jax_params(jm, seed=1)
    batch = _batches(tcfg.vocab, 1)[0]
    kw = {} if backend is None else {"backend": backend}
    tc, jtc = TrainConfig(loss=loss), JTrainConfig(loss=loss)

    def j_loss(p):
        return jlosses.get_loss(loss)(jm, p, _jbatch(batch),
                                      jax.random.PRNGKey(0), jtc, **kw)

    (j_val, j_metrics), j_grads = jax.value_and_grad(j_loss, has_aux=True)(jp)
    params = _to_torch(jp, tcfg)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    val, metrics = losses.get_loss(loss)(tm, params, _tbatch(batch), None,
                                         tc, **kw)
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5)
    assert metrics.keys() == j_metrics.keys()
    for k, v in metrics.items():
        np.testing.assert_allclose(float(torch.as_tensor(v).detach()),
                                   float(j_metrics[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    grads = torch.autograd.grad(val, leaves)
    _assert_tree_close(_unflatten_like(params, grads), j_grads, 1e-4,
                       "grad")


def _unflatten_like(tree, leaves):
    it = iter(leaves)

    def fill(t):
        return {k: fill(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}
    return fill(tree)


def test_streaming_ce_backend_selects_nothing():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((100, 32)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 100, 8))
    a = losses.streaming_ce(h, w, lab, backend="xla")
    b = losses.streaming_ce(h, w, lab, backend="pallas")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="backend"):
        losses.streaming_ce(h, w, lab, backend="triton")


def test_unported_losses_raise():
    """Every loss of the JAX registry is ported (nce, sampled and the
    estimator losses since their slice, the codebook heads of
    ``_flatten_head`` since theirs: tests/test_torch_audio.py), and
    ``make_train_step`` takes each."""
    assert losses.LOSSES.keys() == jlosses.LOSSES.keys()
    assert losses.ESTIMATOR_LOSSES == jlosses.ESTIMATOR_LOSSES
    _, tcfg = _cfgs()
    tm = Model(tcfg)
    for name in losses.LOSSES:
        assert callable(train_loop.make_train_step(tm,
                                                   TrainConfig(loss=name)))


# -- optimizer and train steps -------------------------------------------------

def test_lr_schedule_matches_jax():
    tc = dict(lr=1e-3, warmup_steps=10, total_steps=50)
    for step in range(0, 60, 3):
        np.testing.assert_allclose(
            optimizer.lr_schedule(TrainConfig(**tc), step),
            float(jopt.lr_schedule(JTrainConfig(**tc), jnp.int32(step))),
            rtol=1e-6)


def _assert_updates_close(got, want, before, lr):
    """See the module docstring: every entry to 0.25 lr, each leaf's
    update to 5e-3 in relative L2 norm."""
    want = dict(_leaf_items(jax.tree.map(np.asarray, want)))
    before = dict(_leaf_items(jax.tree.map(np.asarray, before)))
    for name, g in _leaf_items(got):
        g = g.detach().numpy()
        w, p0 = want[name], before[name]
        np.testing.assert_allclose(g, w, rtol=0, atol=0.25 * lr,
                                   err_msg=name)
        du, dw = g - p0, w - p0
        assert np.linalg.norm(du - dw) <= 5e-3 * np.linalg.norm(dw), name


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    """Three fused_ce steps (the JAX step on the Pallas kernels) from the
    same parameters and batches: loss, grad norm and lr each step, and
    every parameter after the last."""
    jcfg, tcfg = _cfgs()
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = _jax_params(jm, seed=2)
    cfg = dict(warmup_steps=1, microbatches=microbatches)
    tc, jtc = TrainConfig(**cfg), JTrainConfig(**cfg)
    jstate = jloop.TrainState(params=jp, opt=jopt.init_opt_state(jp),
                              rng=jax.random.PRNGKey(0))
    jstep = jax.jit(jloop.make_train_step(jm, jtc, backend="pallas"))
    params = _to_torch(jp, tcfg)
    state = train_loop.TrainState(params=params,
                                  opt=optimizer.init_opt_state(params),
                                  rng=torch.Generator().manual_seed(0))
    step = train_loop.make_train_step(tm, tc, backend="pallas")
    for i, batch in enumerate(_batches(tcfg.vocab, 3)):
        jstate, jm_ = jstep(jstate, _jbatch(batch))
        state, m = step(state, _tbatch(batch))
        for k in ("loss_total", "loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert state.opt.step == int(jstate.opt.step) == 3
    _assert_updates_close(state.params, jstate.params, jp, float(jm_["lr"]))
    _assert_tree_close(state.opt.m, jstate.opt.m, 1e-4, "m")


def test_selfnorm_step_matches_jax():
    jcfg, tcfg = _cfgs()
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = _jax_params(jm, seed=3)
    tc, jtc = TrainConfig(loss="selfnorm"), JTrainConfig(loss="selfnorm")
    batch = _batches(tcfg.vocab, 1)[0]
    jstate = jloop.TrainState(params=jp, opt=jopt.init_opt_state(jp),
                              rng=jax.random.PRNGKey(0))
    jstate, jm_ = jax.jit(jloop.make_train_step(jm, jtc, backend="pallas"))(
        jstate, _jbatch(batch))
    params = _to_torch(jp, tcfg)
    state = train_loop.TrainState(params=params,
                                  opt=optimizer.init_opt_state(params),
                                  rng=torch.Generator().manual_seed(0))
    state, m = train_loop.make_train_step(tm, tc)(state, _tbatch(batch))
    for k in ("loss_total", "selfnorm_penalty", "mean_log_z", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-5,
                                   err_msg=k)


def test_carried_train_state_continues_like_jax():
    """One JAX step, its TrainState carried across (parameters and AdamW
    moments), then one more step on each side."""
    jcfg, tcfg = _cfgs()
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = _jax_params(jm, seed=4)
    tc, jtc = TrainConfig(warmup_steps=1), JTrainConfig(warmup_steps=1)
    b0, b1 = _batches(tcfg.vocab, 2)
    jstep = jax.jit(jloop.make_train_step(jm, jtc, backend="pallas"))
    jstate, _ = jstep(jloop.TrainState(params=jp, opt=jopt.init_opt_state(jp),
                                       rng=jax.random.PRNGKey(0)),
                      _jbatch(b0))
    host = jax.tree.map(np.asarray, jstate)
    state = train_loop.TrainState(
        params=params_from_numpy(host.params, tcfg, device="cpu"),
        opt=opt_state_from_numpy(host.opt.step, host.opt.m, host.opt.v,
                                  device="cpu"),
        rng=torch.Generator().manual_seed(0))
    assert state.opt.step == 1
    before = jstate.params
    jstate, jm_ = jstep(jstate, _jbatch(b1))
    state, m = train_loop.make_train_step(tm, tc)(state, _tbatch(b1))
    for k in ("loss_total", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-5,
                                   err_msg=k)
    _assert_updates_close(state.params, jstate.params, before,
                          float(jm_["lr"]))
    _assert_tree_close(state.opt.v, jstate.opt.v, 1e-4, "v")


def test_init_train_state():
    _, tcfg = _cfgs()
    state = train_loop.init_train_state(Model(tcfg), TrainConfig(), 7,
                                        device="cpu")
    again = train_loop.init_train_state(Model(tcfg), TrainConfig(), 7,
                                        device="cpu")
    assert state.opt.step == 0 and state.index is None
    for p, q, m in zip(tree_leaves(state.params), tree_leaves(again.params),
                       tree_leaves(state.opt.m)):
        assert torch.equal(p, q)                       # seeded
        assert m.dtype == torch.float32 and not m.any()
    assert isinstance(state.rng, torch.Generator)


def test_metric_state_matches_jax():
    steps = [{"loss_total": 2.5, "grad_norm": 1.5},
             {"loss_total": float("nan"), "grad_norm": 0.5},
             {"loss_total": 1.25, "grad_norm": 3.0}]
    tm = train_loop.init_train_metric_state(device="cpu")
    jtm = jloop.init_train_metric_state()
    for m in steps:
        tm = train_loop.observe_train_step(
            tm, {k: torch.tensor(v) for k, v in m.items()})
        jtm = jloop.observe_train_step(
            jtm, {k: jnp.float32(v) for k, v in m.items()})
    got, want = (train_loop.harvest_train_metrics(tm),
                 jloop.harvest_train_metrics(jtm))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
