"""Training of the gemma3, RWKV6, Zamba2 and MoE families against the JAX
package on the CPU: each family's reduced config in f32 (gemma3's window of
32 inside a sequence of 40, so its local layers mask), one seeded init (the
port's, which draws at the JAX package's shapes and scales) handed to both
as numpy arrays, one synthetic batch of B 2 x S 40.

Held: the ``fused_ce`` and ``ce`` losses (with the MoE aux terms), their
metrics and the gradient of every parameter, and two gemma3
``make_train_step`` steps (loss, grad norm, lr each step). Also C14: from
the JAX init at the full lr from the first step, the loss falls and then
rises in the JAX package itself (musicgen-medium at its full width with 2
layers, gemma3 at d 512), and the port's steps equal it. Tolerances as in
``test_torch_train.py``: losses to 1e-5 relative, every gradient leaf to
1e-4 of that leaf's largest magnitude. The JAX side runs each loss through
its plain reference (``backend="xla"``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import Model as JModel
from repro.train import losses as jlosses
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import TrainConfig, reduced_config
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.train import losses, optimizer, train_loop
from repro_torch.train.optimizer import tree_leaves, tree_map

ARCHS = ("gemma3-4b", "rwkv6-7b", "zamba2-7b", "deepseek-moe-16b")
LOSSES = ("fused_ce", "ce")
B, S = 2, 40


@pytest.fixture(scope="module")
def built():
    return {}


def _batch(vocab, seed=5):
    it = DataIterator(SyntheticCorpus(vocab, seed=seed), B, S)
    return dict(zip(("tokens", "labels"), next(it)))


def _family(built, arch):
    """The family's reduced model in both packages on one init, its batch,
    and JAX's (value, metrics) and gradients of both losses from one
    compiled function."""
    if arch in built:
        return built[arch]
    jcfg, tcfg = (dataclasses.replace(r(arch), dtype="float32")
                  for r in (j_reduced_config, reduced_config))
    assert S > (jcfg.sliding_window or 0)
    jm, tm = JModel(jcfg), Model(tcfg)
    npp = tree_map(lambda t: t.numpy(), tm.init(
        torch.Generator().manual_seed(5), device="cpu"))
    jp = jax.tree.map(jnp.asarray, npp)
    batch = _batch(jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)

    def both(p):
        out = {}
        for name in LOSSES:
            kw = {"backend": "xla"} if name == "fused_ce" else {}

            def f(q, name=name, kw=kw):
                return jlosses.get_loss(name)(jm, q, jb, key,
                                              JTrainConfig(loss=name), **kw)
            out[name] = jax.value_and_grad(f, has_aux=True)(p)
        return out
    m = dict(jcfg=jcfg, tcfg=tcfg, jm=jm, jp=jp, batch=batch,
             tm=tm, jax=jax.jit(both)(jp),
             tp=params_from_numpy(npp, tcfg, device="cpu"))
    built[arch] = m
    return m


def _keyed(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(built, arch, loss):
    m = _family(built, arch)
    (jval, jmet), jg = m["jax"][loss]
    params = tree_map(lambda t: t.clone(), m["tp"])
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in m["batch"].items()}
    val, met = losses.get_loss(loss)(m["tm"], params, batch, None,
                                     TrainConfig(loss=loss))
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    assert met.keys() == jmet.keys()
    for k in met:
        np.testing.assert_allclose(float(torch.as_tensor(met[k]).detach()),
                                   float(jmet[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    grads = torch.autograd.grad(val, leaves)
    it = iter(grads)
    got = _keyed(tree_map(lambda _: next(it), params))
    want = _keyed(jg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(got[name].double().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-30,
                                   err_msg=f"{arch} {loss} grad {name}")


def test_gemma3_train_steps_match_jax(built):
    """Two fused_ce steps of ``make_train_step`` from the same parameters
    on the same batches, past the window: loss, grad norm and lr each
    step."""
    m = _family(built, "gemma3-4b")
    cfg = dict(warmup_steps=1)
    jstate = jloop.TrainState(params=m["jp"],
                              opt=jopt.init_opt_state(m["jp"]),
                              rng=jax.random.PRNGKey(0))
    jstep = jax.jit(jloop.make_train_step(m["jm"], JTrainConfig(**cfg),
                                          backend="xla"))
    params = tree_map(lambda t: t.clone(), m["tp"])
    state = train_loop.TrainState(params=params,
                                  opt=optimizer.init_opt_state(params),
                                  rng=torch.Generator().manual_seed(0))
    step = train_loop.make_train_step(m["tm"], TrainConfig(**cfg))
    for i, seed in enumerate((5, 6)):
        batch = _batch(m["tcfg"].vocab, seed)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        for k in ("loss_total", "loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    assert state.opt.step == int(jstate.opt.step) == 2



# (config changes, B, S, steps): musicgen-medium at its full width with the
# reduced config's 2 layers; gemma3 at d 512 with the reduced 8 layers
RISE = {"musicgen-medium": (dict(d_model=1536, n_heads=24, n_kv_heads=24,
                                  head_dim=64, d_ff=6144, vocab=2048),
                             1, 16, 3),
        "gemma3-4b": (dict(d_model=512, head_dim=128, d_ff=2048,
                           vocab=1024), 1, 64, 4)}


@pytest.mark.parametrize("arch", sorted(RISE))
def test_full_lr_from_step_one_rises_in_the_reference_c14(arch):
    """C14 (reference behaviour): from the JAX init (musicgen's codebook
    head at C ** -0.5, gemma3's tied table at 1.0: LSEs in the tens and
    hundreds), AdamW at the full lr 3e-4 from the first step (warmup 1) on
    one repeated batch makes the fused_ce loss fall and then rise within a
    few steps in the JAX package itself, and the port's steps give the
    same losses (to 1e-4 relative: the steps amplify f32 rounding at
    these scales). f32, the JAX init handed to the port."""
    opts, b, s, n = RISE[arch]
    jcfg, tcfg = (dataclasses.replace(r(arch), dtype="float32", **opts)
                  for r in (j_reduced_config, reduced_config))
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                           device="cpu")
    tokens, labels = next(DataIterator(
        SyntheticCorpus(jcfg.vocab, seed=0), b, s,
        n_codebooks=jcfg.n_codebooks))
    cfg = dict(warmup_steps=1)
    jstate = jloop.TrainState(params=jp, opt=jopt.init_opt_state(jp),
                              rng=jax.random.PRNGKey(0))
    jstep = jax.jit(jloop.make_train_step(jm, JTrainConfig(**cfg),
                                          backend="xla"))
    state = train_loop.TrainState(params=tp,
                                  opt=optimizer.init_opt_state(tp),
                                  rng=torch.Generator().manual_seed(0))
    step = train_loop.make_train_step(tm, TrainConfig(**cfg))
    want, got = [], []
    for _ in range(n):
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens),
                                      "labels": jnp.asarray(labels)})
        state, met = step(state, {"tokens": torch.from_numpy(tokens),
                                  "labels": torch.from_numpy(labels)})
        want.append(float(jmet["loss_total"]))
        got.append(float(met["loss_total"]))
    assert want[1] < want[0] and want[-1] > want[-2], want
    np.testing.assert_allclose(got, want, rtol=1e-4)
