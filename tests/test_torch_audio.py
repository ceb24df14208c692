"""The audio family (musicgen's codebook embedding and heads) against the
JAX package on the CPU: ``reduced_config("musicgen-medium")`` (2 layers, d
128, 4 codebooks of vocab 64) in f32, the JAX init carried into the port by
``interop.params_from_numpy``.

Held: the init tree against ``eval_shape`` and each leaf's scale against
the JAX init's, ``forward``'s hidden states and
logits, 8 decode steps, ``Engine.decode_step`` greedy and at temperature
1.0 on the JAX engine's own Gumbel noise (its key schedule replayed:
``fold_in(key, t)`` for replay step t, ``fold_in(key, 10_000 + t)`` after,
then ``split``, then ``gumbel`` over (B, C, V)), the head in bf16 (log Z
and log_prob bit-equal to the JAX engine's), ``generate``'s runner
against the host loop, ``swap_index``, and the value and every gradient
leaf of the five losses that take a codebook head. Tolerances: hidden
states, logits and log Z / log_prob to 1e-5 (tokens exactly); losses to
1e-5 relative and gradients to 1e-4 of each leaf's largest magnitude, as
in ``test_torch_train.py``. Also C13 (reference behaviour): ``fused_ce``
normalises over all C·V rows, ``ce`` over each codebook's V, so the two
differ on the same batch on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve.engine import ServeState as JServeState
from repro.train import losses as jlosses
from repro_torch.configs import TrainConfig, get_config, reduced_config
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeState, generate
from repro_torch.train import losses
from repro_torch.train.optimizer import tree_leaves, tree_map

ARCH = "musicgen-medium"
ATOL = 1e-5
B, S, NEW, MAX_LEN = 2, 4, 5, 16
LOSSES = ("fused_ce", "selfnorm", "ce", "nce", "sampled")


@pytest.fixture(scope="module")
def m():
    jcfg, tcfg = (dataclasses.replace(r(ARCH), dtype="float32")
                  for r in (j_reduced_config, reduced_config))
    jm = JModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
    npp = jax.tree.map(np.asarray, jp)
    tm = Model(tcfg)
    it = DataIterator(SyntheticCorpus(tcfg.vocab, seed=5), B, 8,
                      n_codebooks=tcfg.n_codebooks)
    batch = dict(zip(("tokens", "labels"), next(it)))
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, jp=jp, npp=npp, tm=tm,
                tp=params_from_numpy(npp, tcfg, device="cpu"), batch=batch,
                jax_losses={})


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol, err_msg=what)


def test_full_width_model_constructs_and_counts_as_jax():
    """musicgen-medium at full width: the port builds its Model (no
    refusal), and the count the smoke holds its init to is the JAX
    package's ``eval_shape`` count."""
    import importlib.util
    from pathlib import Path
    cfg = get_config(ARCH)
    assert Model(cfg).plan == "stack" and cfg.n_codebooks == 4
    shapes = jax.eval_shape(JModel(j_get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes))
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.A_PARAMS == n


def test_init_tree_matches_eval_shape(m):
    tp = m["tm"].init(torch.Generator().manual_seed(0), device="cpu")
    jp = jax.eval_shape(m["jm"].init, jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    got = {jax.tree_util.keystr(k): (tuple(v.shape),
                                     str(v.dtype).removeprefix("torch."))
           for k, v in jax.tree_util.tree_leaves_with_path(tp)}
    assert got == want
    assert got["['embed']['table']"][0] == (4, 64, 128)


def test_init_scales_match_jax(m):
    """Each leaf of the port's init is drawn at the JAX init's scale: its
    standard deviation within 20% of the JAX leaf's and its mean within
    20% of that deviation, a constant leaf equal. The JAX package takes
    fan_in = shape[0], so the (C, V, d) codebook ``lm_head`` is drawn at
    C ** -0.5 (0.5 here), the embedding table at 1.0."""
    tp = m["tm"].init(torch.Generator().manual_seed(0), device="cpu")
    want = {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_leaves_with_path(m["jp"])}
    for k, v in jax.tree_util.tree_leaves_with_path(tp):
        name, got = jax.tree_util.keystr(k), v.double().numpy()
        w = want[name]
        if w.std() == 0:
            np.testing.assert_array_equal(got, w, err_msg=name)
            continue
        assert abs(got.std() / w.std() - 1) < 0.2, (name, got.std(),
                                                     w.std())
        assert abs(got.mean() - w.mean()) < 0.2 * w.std(), name
    assert abs(want["['lm_head']"].std() - 0.5) < 0.05


def test_params_from_numpy_checks_the_codebook_leaves(m):
    bad = dict(m["npp"], lm_head=m["npp"]["lm_head"][:3])
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy(bad, m["tcfg"], device="cpu")
    with pytest.raises(ValueError, match="embed.table"):
        params_from_numpy(m["npp"], dataclasses.replace(
            m["tcfg"], n_codebooks=2), device="cpu")


def test_forward_and_logits_match_jax(m):
    toks = m["batch"]["tokens"]
    jh, _ = jax.jit(m["jm"].forward)(m["jp"], jnp.asarray(toks))
    th, _ = m["tm"].forward(m["tp"], torch.from_numpy(toks))
    _close(th.numpy(), jh, what="hidden")
    jl = m["jm"].logits(m["jp"], jh)
    tl = m["tm"].logits(m["tp"], th)
    assert tuple(tl.shape) == jl.shape == toks.shape[:2] + (4, 64)
    _close(tl.detach().numpy(), jl, what="logits")


def test_decode_steps_match_jax(m):
    steps = 8
    toks = np.random.default_rng(0).integers(0, 64, (B, steps, 4))
    jstate = m["jm"].init_decode_state(B, MAX_LEN)
    tstate = m["tm"].init_decode_state(B, MAX_LEN, "cpu")
    step = jax.jit(m["jm"].decode_step)
    for pos in range(steps):
        jh, jstate = step(m["jp"], jstate, jnp.asarray(toks[:, pos]),
                          jnp.asarray(pos, jnp.int32))
        th = m["tm"].decode_step(m["tp"], tstate,
                                 torch.from_numpy(toks[:, pos]), pos)
        _close(th.numpy(), jh, what=f"position {pos}")
    _close(tstate["k"].numpy(), jstate["kv"]["k"], what="KV")


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_engine_decode_step_matches_jax(m, temperature):
    """Each step of the JAX host loop's schedule, the port's step on the
    JAX step's noise: tokens equal, log_prob and log Z to 1e-5."""
    jeng = JEngine(m["jm"], m["jp"], max_len=MAX_LEN)
    teng = Engine(m["tm"], m["tp"], MAX_LEN, device="cpu")
    assert teng.state is None and teng.index is None
    prompt = np.random.default_rng(1).integers(0, 64, (B, S, 4))
    key = jax.random.PRNGKey(9)
    jstep = jax.jit(lambda st, k: jeng.decode_step(
        st, k, temperature=temperature))
    jstate = JServeState(cache=m["jm"].init_decode_state(B, MAX_LEN),
                         pos=jnp.zeros((), jnp.int32),
                         last_token=jnp.asarray(prompt[:, 0]))
    tstate = ServeState(cache=m["tm"].init_decode_state(B, MAX_LEN, "cpu"),
                        pos=torch.zeros((), dtype=torch.int32),
                        last_token=torch.from_numpy(prompt[:, 0]))
    for s in range(S + NEW - 1):
        k = jax.random.fold_in(key, s if s < S else 10_000 + s - S)
        if s < S:
            jstate = dataclasses.replace(
                jstate, last_token=jnp.asarray(prompt[:, s]))
            tstate = dataclasses.replace(
                tstate, last_token=torch.from_numpy(prompt[:, s]))
        jout, jstate = jstep(jstate, k)
        g = jax.random.gumbel(jax.random.split(k)[1], (B, 4, 64))
        tout, tstate = teng.decode_step(
            tstate, temperature, gumbel=torch.from_numpy(np.array(g)))
        np.testing.assert_array_equal(tout["token"].numpy(),
                                      np.asarray(jout["token"]),
                                      err_msg=f"step {s}")
        for name in ("log_prob", "log_z"):
            _close(tout[name].numpy(), jout[name], what=f"{name} step {s}")
        # the next step feeds the sampled (B, C) tokens back
        assert tuple(tstate.last_token.shape) == (B, 4)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_codebook_head_in_bf16_matches_jax(m, temperature):
    """The audio head at the config's bf16 (the reduced config's own
    dtype): the logits, log Z and log_prob stay in bf16 as JAX computes
    them (``jax.nn.logsumexp`` of bf16 logits), so log Z and log_prob equal
    the JAX engine's bit for bit; a logsumexp in f32 over the same logits
    is up to half a bf16 step (about 0.03 near 16) away."""
    jcfg = dataclasses.replace(m["jcfg"], dtype="bfloat16")
    tcfg = dataclasses.replace(m["tcfg"], dtype="bfloat16")
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), m["jp"])
    tp = tree_map(lambda t: t.to(torch.bfloat16), m["tp"])
    jeng = JEngine(JModel(jcfg), jp, max_len=MAX_LEN)
    teng = Engine(Model(tcfg), tp, MAX_LEN, device="cpu")
    h = np.random.default_rng(6).standard_normal((8, 128), np.float32)
    key = jax.random.PRNGKey(1)
    jout = jeng.next_token_distribution(
        jnp.asarray(h).astype(jnp.bfloat16), key, temperature)
    g = jax.random.gumbel(jax.random.split(key)[1], (8, 4, 64))
    tout = teng.next_token_distribution(
        torch.from_numpy(h).to(torch.bfloat16), temperature,
        gumbel=torch.from_numpy(np.array(g)))
    np.testing.assert_array_equal(tout["token"].numpy(),
                                  np.asarray(jout["token"]))
    for name in ("log_prob", "log_z"):
        assert tout[name].dtype == torch.float32
        np.testing.assert_array_equal(
            tout[name].numpy(), np.asarray(jout[name], np.float32),
            err_msg=name)


def test_runner_equals_host_loop_and_swap_drops_it(m):
    eng = Engine(m["tm"], m["tp"], MAX_LEN, seed=4, device="cpu")
    prompt = np.random.default_rng(2).integers(0, 64, (B, S, 4))
    runs = {}
    for temperature in (0.0, 1.0):
        for host_loop in (False, True):
            eng.generator.manual_seed(7)
            runs[temperature, host_loop] = generate(
                eng, prompt, NEW, temperature=temperature, host_loop=host_loop,
                return_aux=True)
        (a, a_aux), (b, b_aux) = runs[temperature, False], runs[
            temperature, True]
        assert tuple(a.shape) == (B, NEW, 4)
        assert torch.equal(a, b)
        for name in ("log_prob", "log_z"):
            assert torch.equal(a_aux[name], b_aux[name]), name
    assert len(eng._graph_runners) == 1
    assert eng.verify_and_restore() is False
    with pytest.raises(NotImplementedError, match="audio"):
        eng.tier_state("exact")
    new = tree_map(lambda t: t * 1.5, m["tp"])
    eng.swap_index(new)
    assert eng.params is new and eng._graph_runners == {}
    got = generate(eng, prompt, NEW)
    fresh = generate(Engine(m["tm"], new, MAX_LEN, device="cpu"), prompt,
                     NEW)
    assert torch.equal(got, fresh)


def _jax_loss(m, name):
    """JAX's (value, metrics) and gradients of loss ``name`` on the batch,
    computed once a module."""
    if name in m["jax_losses"]:
        return m["jax_losses"][name]
    jtc = JTrainConfig(loss=name)
    batch = {k: jnp.asarray(v) for k, v in m["batch"].items()}
    kw = {"backend": "xla"} if name in ("fused_ce", "selfnorm") else {}
    key = jax.random.PRNGKey(4)

    def f(p):
        return jlosses.get_loss(name)(m["jm"], p, batch, key, jtc, **kw)
    grad = jax.jit(jax.value_and_grad(f, has_aux=True))
    out = m["jax_losses"][name] = grad(m["jp"])
    return out


def _torch_loss(m, name, grads=True):
    params = tree_map(lambda t: t.clone(), m["tp"])
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(grads)
    kw = {}
    if name in ("nce", "sampled"):
        # JAX's draw: (T·C, k) rows of the C·V-row head
        t = m["batch"]["tokens"].size
        kw["noise"] = torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(4), (t, JTrainConfig().nce_noise), 0,
            4 * 64)))
    batch = {k: torch.from_numpy(v) for k, v in m["batch"].items()}
    val, met = losses.get_loss(name)(m["tm"], params, batch, None,
                                     TrainConfig(loss=name), **kw)
    g = torch.autograd.grad(val, leaves) if grads else None
    return val, met, params, g


@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_grads_match_jax(m, name):
    (jval, jmet), jg = _jax_loss(m, name)
    val, met, params, g = _torch_loss(m, name)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    assert met.keys() == jmet.keys()
    for k in met:
        np.testing.assert_allclose(float(torch.as_tensor(met[k]).detach()),
                                   float(jmet[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    it = iter(g)
    got = dict(jax.tree_util.tree_leaves_with_path(
        tree_map(lambda _: next(it), params)))
    want = dict(jax.tree_util.tree_leaves_with_path(jg))
    assert {jax.tree_util.keystr(k) for k in got} == \
        {jax.tree_util.keystr(k) for k in want}
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in want.items()}
    for k, v in got.items():
        w = want[jax.tree_util.keystr(k)]
        _close(v.numpy(), w, atol=1e-4 * np.abs(w).max() + 1e-30,
               what=f"grad {jax.tree_util.keystr(k)}")


def test_flattened_head_normalises_over_every_codebook_c13(m):
    """C13: fused_ce's log Z runs over all C·V rows of the flattened head,
    ce's over each codebook's V, in the JAX package and in the port alike:
    the two losses differ by about log C here, and ce's log Z is the mean
    of the per-codebook logsumexps."""
    (jf, jfm), _ = _jax_loss(m, "fused_ce")
    (jc, jcm), _ = _jax_loss(m, "ce")
    f, fm, _, _ = _torch_loss(m, "fused_ce", grads=False)
    c, cm, _, _ = _torch_loss(m, "ce", grads=False)
    for fused, ce in ((float(jf), float(jc)), (f.item(), c.item())):
        assert fused - ce > 0.5 * np.log(4)
    np.testing.assert_allclose(fm["mean_log_z"].item() - cm[
        "mean_log_z"].item(), float(jfm["mean_log_z"] - jcm["mean_log_z"]),
        rtol=1e-5)
    toks = torch.from_numpy(m["batch"]["tokens"])
    h, _ = m["tm"].forward(m["tp"], toks)
    per_codebook = torch.logsumexp(m["tm"].logits(m["tp"], h), -1)
    np.testing.assert_allclose(per_codebook.mean().item(),
                               cm["mean_log_z"].item(), rtol=1e-6)
