"""The port's estimator-backed training (the sparse CE, estimator_ce,
lsh_estimator_ce, the nce and sampled losses, the index in TrainState, the
index refresh and the instrumented step) against the JAX package's on the
CPU, on the same numpy inputs, the JAX-built index carried across
(``interop.ivf_from_numpy``/``lsh_from_numpy``) and JAX's draws injected
(tail samples, noise words).

Tolerances. f32 throughout: the two frameworks sum the same f32 products
in other orders (about 1e-7 relative a sum), so losses and log Ẑ hold to
1e-5 relative and every gradient to 1e-4 of its largest magnitude, as in
``tests/test_torch_train.py``; parameters after three AdamW steps to 0.25
of the learning rate an entry and 5e-3 relative a leaf (that file's
docstring says why).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import lsh as jlsh
from repro.core import mips as jmips
from repro.core.decode import head_row_table as j_head_row_table
from repro.core.decode import make_plan as j_make_plan
from repro.core.decode import tail_row_ids as j_tail_row_ids
from repro.models import Model as JModel
from repro.train import losses as jlosses
from repro.train import train_loop as jloop
from repro_torch.configs import TrainConfig, reduced_config
from repro_torch.core import lsh as tlsh
from repro_torch.core.lsh import LSHIndex
from repro_torch.core.mips import IVFIndex
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.interop import (ivf_from_numpy, lsh_from_numpy,
                                 params_from_numpy)
from repro_torch.models import Model
from repro_torch.train import losses, optimizer, train_loop
from repro_torch.train.optimizer import tree_leaves

V, D, T = 2048, 64, 32
BR, NC = 32, 16
REL = 1e-5
GRAD = 1e-4


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(3)
    w = jax.random.normal(key, (V, D)) * 0.3
    h = jax.random.normal(jax.random.fold_in(key, 1), (T, D)) * 0.3
    labels = jax.random.randint(jax.random.fold_in(key, 2), (T,), 0, V)
    jidx = jmips.build_ivf_device(jax.random.fold_in(key, 4), w,
                                  block_rows=BR, n_clusters=NC)
    tidx = ivf_from_numpy(*[_np(x) if not isinstance(x, int) else x
                            for x in jidx], device="cpu")
    return dict(key=key, w=w, h=h, labels=labels, jidx=jidx, tidx=tidx)


def _lsh_setup(setup):
    jl = jlsh.build_lsh_device(jax.random.fold_in(setup["key"], 5),
                               setup["w"], n_bits=4, n_tables=6,
                               bucket_cap=256)
    return jl, lsh_from_numpy(*[_np(x) for x in jl], device="cpu")


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * np.abs(want).max() * 1e-3 + 1e-30,
                               err_msg=what)


def _grad_close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=0,
        atol=GRAD * np.abs(want).max() + 1e-30, err_msg=what)


def _cotangents(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(T).astype(np.float32) / T,
            rng.standard_normal(T).astype(np.float32) / T)


def _j_vjp(fn, h, w, cts):
    (nll, lz), vjp = jax.vjp(fn, h, w)
    dh, dw = vjp(tuple(jnp.asarray(c) for c in cts))
    return nll, lz, dh, dw


def _t_vjp(fn, h, w, cts):
    h = _t(h).requires_grad_(True)
    w = _t(w).requires_grad_(True)
    nll, lz = fn(h, w)[:2]
    dh, dw = torch.autograd.grad((nll, lz), (h, w),
                                 tuple(_t(c) for c in cts))
    return nll.detach(), lz.detach(), dh, dw


# -- _sparse_ce ----------------------------------------------------------------

@pytest.mark.parametrize("biased", [False, True])
def test_sparse_ce_matches_jax(setup, biased):
    """nll, log Ẑ, dh and dw of _sparse_ce on JAX's plan, with a zero and
    a non-zero tail bias (the Hajek form lsh_ce uses)."""
    jidx, h, w, labels = setup["jidx"], setup["h"], setup["w"], setup["labels"]
    key = jax.random.fold_in(setup["key"], 9)
    plan = j_make_plan(jidx, h, key, 4, 64)
    head_rows, head_mask = j_head_row_table(jidx, plan.head_ids,
                                            plan.head_member)
    tail_ids = j_tail_row_ids(jidx, plan)
    br = jidx.v_blocks.shape[1]
    lab_block = jidx.slot_of_row[labels] // br
    lih = jnp.any(plan.block_ids == lab_block[:, None], -1)
    accept = plan.tail_accept & (tail_ids[None, :] != labels[:, None])
    ntt = (jidx.n - plan.k_eff).astype(jnp.float32) - (~lih).astype(
        jnp.float32)
    bias = (0.3 * jax.random.normal(key, tail_ids.shape) if biased
            else jnp.zeros(tail_ids.shape, jnp.float32))
    args = (labels, head_rows, head_mask, tail_ids, accept, bias, ntt, lih)
    cts = _cotangents(1)
    want = _j_vjp(lambda hh, ww: jlosses._sparse_ce(hh, ww, *args), h, w, cts)
    targs = [_t(_np(a)) for a in args]
    got = _t_vjp(lambda hh, ww: losses._sparse_ce(hh, ww, *targs), h, w, cts)
    for name, g, wnt in zip(("nll", "log_z"), got[:2], want[:2]):
        _close(g.numpy(), _np(wnt), what=name)
    _grad_close(got[2].numpy(), _np(want[2]), "dh")
    _grad_close(got[3].numpy(), _np(want[3]), "dw")


def test_sparse_ce_dw_rows_and_float64(setup):
    """dw has rows in head ∪ tail ∪ labels only, exactly 0 elsewhere; the
    f32 evaluation holds to its own float64 evaluation (same code, float64
    operands), which ``chip_smoke.py`` does on the card; two calls are
    bit-equal."""
    tidx, h, w, labels = setup["tidx"], _t(setup["h"]), _t(setup["w"]), \
        _t(setup["labels"])
    sp, _ = losses.estimator_plan(tidx, h, labels, n_probe=2, l=64,
                                  tail_idx=torch.arange(0, V, V // 64))
    nll, lz, res = losses._sparse_ce_fwd(h, w, *sp)
    g = [torch.full((T,), 1.0 / T), torch.zeros(T)]
    dh, dw = losses._sparse_ce_bwd(res, *g)
    dh2, dw2 = losses._sparse_ce_bwd(losses._sparse_ce_fwd(h, w, *sp)[2], *g)
    assert torch.equal(dh, dh2) and torch.equal(dw, dw2)
    nll64, lz64, res64 = losses._sparse_ce_fwd(h.double(), w.double(), *sp)
    dh64, dw64 = losses._sparse_ce_bwd(res64, *g, cast=False)
    assert dh64.dtype == torch.float64
    _close(nll.numpy(), nll64.numpy(), 1e-5, "nll")
    _grad_close(dw.numpy(), dw64.numpy(), "dw")
    allowed = torch.zeros(V, dtype=torch.bool)
    allowed[sp.head_rows[sp.head_mask.any(0)].long()] = True
    allowed[sp.tail_ids.long()] = True
    allowed[labels.long()] = True
    touched = dw.abs().sum(-1) > 0
    assert not touched[~allowed].any()
    assert touched.sum() > 0 and (~allowed).sum() > V // 2


# -- estimator_ce and lsh_estimator_ce -----------------------------------------

@pytest.mark.parametrize("head_cap", [0, 120, 1])
def test_estimator_ce_matches_jax(setup, head_cap):
    """estimator_ce with JAX's index and tail draw: nll, log Ẑ, the aux
    metrics, dh and dw; head_cap 120 takes the trimmed union, 1 overflows
    to the full capacity (the same math)."""
    key = jax.random.fold_in(setup["key"], 11)
    n_probe, l = 4, 64
    tail_idx = _np(jax.random.randint(key, (l,), 0, V))
    jaux = {}

    def jfn(hh, ww):
        nll, lz, aux = jlosses.estimator_ce(
            setup["jidx"], hh, ww, setup["labels"], key, n_probe=n_probe,
            l=l, head_cap=head_cap)
        jaux.update(aux)
        return nll, lz
    cts = _cotangents(2)
    want = _j_vjp(jfn, setup["h"], setup["w"], cts)
    taux = {}

    def tfn(hh, ww):
        nll, lz, aux = losses.estimator_ce(
            setup["tidx"], hh, ww, _t(setup["labels"]), n_probe=n_probe,
            l=l, head_cap=head_cap, tail_idx=_t(tail_idx))
        taux.update(aux)
        return nll, lz
    got = _t_vjp(tfn, setup["h"], setup["w"], cts)
    _close(got[0].numpy(), _np(want[0]), what="nll")
    _close(got[1].numpy(), _np(want[1]), what="log_z")
    _grad_close(got[2].numpy(), _np(want[2]), "dh")
    _grad_close(got[3].numpy(), _np(want[3]), "dw")
    assert taux.keys() == jaux.keys()
    for k in taux:
        _close(float(taux[k]), float(jaux[k]), what=k)


@pytest.mark.parametrize("cand_cap", [0, 64])
def test_lsh_estimator_ce_matches_jax(setup, cand_cap):
    """lsh_estimator_ce with JAX's index and tail draw; cand_cap 64
    overflows to the dense branch."""
    jl, tl = _lsh_setup(setup)
    key = jax.random.fold_in(setup["key"], 12)
    l = 128
    jplan = jlsh.lsh_plan(jl, setup["h"], key, l, cand_cap=jl.n)
    jaux = {}

    def jfn(hh, ww):
        nll, lz, aux = jlosses.lsh_estimator_ce(
            jl, hh, ww, setup["labels"], key, l=l, cand_cap=cand_cap)
        jaux.update(aux)
        return nll, lz
    cts = _cotangents(3)
    want = _j_vjp(jfn, setup["h"], setup["w"], cts)
    taux = {}

    def tfn(hh, ww):
        nll, lz, aux = losses.lsh_estimator_ce(
            tl, hh, ww, _t(setup["labels"]), l=l, cand_cap=cand_cap,
            tail_ids=_t(_np(jplan.tail_ids)))
        taux.update(aux)
        return nll, lz
    got = _t_vjp(tfn, setup["h"], setup["w"], cts)
    _close(got[0].numpy(), _np(want[0]), what="nll")
    _close(got[1].numpy(), _np(want[1]), what="log_z")
    _grad_close(got[2].numpy(), _np(want[2]), "dh")
    _grad_close(got[3].numpy(), _np(want[3]), "dw")
    assert taux.keys() == jaux.keys()
    for k in taux:
        _close(float(taux[k]), float(jaux[k]), what=k)


def test_lsh_ce_every_row_in_exactly_one_part(setup):
    """The invariant of lsh_estimator_ce (one collision predicate): per
    token, each row is in the head (collides), is the explicit label term
    (the label, not colliding) or is in the tail population; the tail
    population's size is n_tail_total, a tail sample is accepted exactly
    when its row is in the population, and the scored head is the
    collision set."""
    h, labels = _t(setup["h"]), _t(setup["labels"]).long()
    # 2 tables of 8 bits: a union well under V, so the compact candidate
    # list has pad columns (row 0, never scored)
    tl = tlsh.build_lsh_device(_t(setup["w"]), n_bits=8, n_tables=2,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    sp, _, plan = losses.lsh_estimator_plan(tl, h, labels,
                                            torch.Generator().manual_seed(0),
                                            l=128)
    assert int(plan.cand_live) < V
    occ = plan.occ_q                                       # (T, V)
    label_term = ~occ[torch.arange(T), labels]
    assert torch.equal(label_term, ~sp.label_in_head)
    population = ~occ
    population[torch.arange(T), labels] = False
    assert torch.equal(sp.n_tail_total, population.sum(-1).float())
    head = occ.sum(-1) + population.sum(-1) + label_term.long()
    assert torch.equal(head, torch.full((T,), V))
    assert torch.equal(sp.tail_accept, population[:, sp.tail_ids.long()])
    cols = sp.head_mask.any(0)
    scored = torch.zeros((T, V), dtype=torch.bool)
    scored[:, sp.head_rows[cols].long()] = sp.head_mask[:, cols]
    assert torch.equal(scored, occ)
    assert torch.unique(sp.head_rows[cols]).numel() == int(cols.sum())


def test_untouched_rows_have_zero_grad(setup):
    """Rows outside head ∪ tail ∪ labels get exactly zero gradient."""
    h, w = _t(setup["h"]), _t(setup["w"]).requires_grad_(True)
    labels = _t(setup["labels"])
    nll, _, _ = losses.estimator_ce(setup["tidx"], h, w, labels,
                                    torch.Generator().manual_seed(7),
                                    n_probe=2, l=64)
    (gw,) = torch.autograd.grad(nll.mean(), w)
    zero_rows = gw.abs().sum(-1) == 0
    assert zero_rows.sum() > 0.5 * V


def test_head_cap_trim_matches_full(setup):
    """A trim that fits gives the full-capacity estimate; a cap of one
    block overflows to the full capacity."""
    h, w, labels = _t(setup["h"]), _t(setup["w"]), _t(setup["labels"])
    tail = torch.randint(0, V, (64,), generator=torch.Generator()
                         .manual_seed(11))
    outs = [losses.estimator_ce(setup["tidx"], h, w, labels, n_probe=4,
                                l=64, head_cap=cap, tail_idx=tail)[0]
            for cap in (0, 120, 1)]
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5)
    assert torch.equal(outs[2], outs[0])


# -- the loss entry points -------------------------------------------------------

def _cfgs(**part):
    jcfg, tcfg = j_reduced_config("qwen1.5-4b"), reduced_config("qwen1.5-4b")
    over = dict(vocab=V, dtype="float32")
    pj = dataclasses.replace(jcfg.partition, block_rows=64, n_probe=4,
                             l=128, n_clusters=8, lsh_bits=4, lsh_tables=6,
                             **part)
    pt = dataclasses.replace(tcfg.partition, block_rows=64, n_probe=4,
                             l=128, n_clusters=8, lsh_bits=4, lsh_tables=6,
                             **part)
    return (dataclasses.replace(jcfg, partition=pj, **over),
            dataclasses.replace(tcfg, partition=pt, **over))


def _batch(vocab, b=2, s=16, seed=5):
    it = DataIterator(SyntheticCorpus(vocab, seed=seed), b, s)
    return dict(zip(("tokens", "labels"), next(it)))


def _tree_close(got, want, what):
    got = dict(_items(got))
    for name, w_ in _items(jax.tree.map(np.asarray, want)):
        _grad_close(got[name].detach().numpy(), w_, f"{what} {name}")


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("loss", ["nce", "sampled"])
def test_sampled_losses_match_jax(loss):
    """nce and sampled on JAX's noise draw: the loss, its metrics and the
    gradient of every parameter."""
    jcfg, tcfg = _cfgs()
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    batch = _batch(V)
    key = jax.random.PRNGKey(4)
    jtc, tc = JTrainConfig(loss=loss), TrainConfig(loss=loss)
    t = batch["tokens"].size
    noise = _np(jax.random.randint(key, (t, jtc.nce_noise), 0, V))

    def jl(p):
        return jlosses.get_loss(loss)(
            jm, p, {k: jnp.asarray(v) for k, v in batch.items()}, key, jtc)
    (jval, jmet), jg = jax.value_and_grad(jl, has_aux=True)(jp)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    val, met = losses.get_loss(loss)(
        tm, params, {k: _t(v) for k, v in batch.items()}, None, tc,
        noise=_t(noise))
    _close(val.item(), float(jval), what="loss")
    assert met.keys() == jmet.keys()
    for k in met:
        _close(met[k].item(), float(jmet[k]), what=k)
    grads = torch.autograd.grad(val, leaves)
    it = iter(grads)
    gtree = optimizer.tree_map(lambda _: next(it), params)
    _tree_close(gtree, jg, "grad")


def test_registry_and_refusals():
    """Every loss of the JAX registry runs; the estimator losses refuse a
    missing index (ValueError) and a codebook head (NotImplementedError),
    as the JAX package's do."""
    assert losses.LOSSES.keys() == jlosses.LOSSES.keys()
    assert losses.ESTIMATOR_LOSSES == jlosses.ESTIMATOR_LOSSES
    _, tcfg = _cfgs()
    tm = Model(tcfg)
    for name in losses.ESTIMATOR_LOSSES:
        with pytest.raises(ValueError, match="index"):
            losses.get_loss(name)(tm, {}, {}, None, TrainConfig(loss=name),
                                  index=None)
        fake = types.SimpleNamespace(
            cfg=dataclasses.replace(tcfg, n_codebooks=2))
        with pytest.raises(NotImplementedError, match="single-stream"):
            losses.get_loss(name)(fake, {}, {}, None, TrainConfig(loss=name),
                                  index=object())
    with pytest.raises(ValueError, match="draws nothing"):
        train_loop.make_train_step(tm, TrainConfig(loss="fused_ce"),
                                   draw_source=lambda s, i: None)


# -- train steps, the index in TrainState, the refresh ---------------------------

def _jax_state(jm, loss, seed=0):
    jtc = JTrainConfig(loss=loss, lr=1e-3, warmup_steps=1)
    return jtc, jloop.init_train_state(jm, jtc, jax.random.PRNGKey(seed))


def _carry_index(jindex, loss):
    if loss == "lsh_ce":
        return lsh_from_numpy(*[_np(x) for x in jindex], device="cpu")
    return ivf_from_numpy(*[_np(x) if not isinstance(x, int) else x
                            for x in jindex], device="cpu")


def _jax_draws(jl_index, loss, rng, n_steps, l):
    """The tail draw of each of JAX's steps: key_i = split(rng_i)[0]."""
    out = []
    for _ in range(n_steps):
        key, rng = jax.random.split(rng)
        if loss == "lsh_ce":
            h0 = jnp.zeros((1, jl_index.proj.shape[-1] - 1))
            out.append(_np(jlsh.lsh_plan(jl_index, h0, key, l,
                                         cand_cap=jl_index.n).tail_ids))
        else:
            out.append(_np(jax.random.randint(key, (l,), 0, jl_index.n)))
    return out


@pytest.mark.parametrize("loss", ["mimps_ce", "lsh_ce"])
def test_train_steps_match_jax(loss):
    """Three steps of the estimator loss from JAX's TrainState (its
    parameters and index carried across, its tail draws injected): loss,
    log Ẑ, the aux metrics, grad norm and lr each step, and every
    parameter after the last."""
    jcfg, tcfg = _cfgs()
    jm, tm = JModel(jcfg), Model(tcfg)
    jtc, jstate = _jax_state(jm, loss)
    tc = TrainConfig(loss=loss, lr=1e-3, warmup_steps=1)
    draws = _jax_draws(jstate.index, loss, jstate.rng, 3, jcfg.partition.l)
    state = train_loop.TrainState(
        params=params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                                 tcfg, device="cpu"),
        opt=optimizer.init_opt_state(
            params_from_numpy(jax.tree.map(np.asarray, jstate.params), tcfg,
                              device="cpu")),
        rng=torch.Generator().manual_seed(0),
        index=_carry_index(jstate.index, loss))
    jstep = jax.jit(jloop.make_train_step(jm, jtc))
    step = train_loop.make_train_step(
        tm, tc, draw_source=lambda s, i: _t(draws[s]))
    before = jstate.params
    for i in range(3):
        batch = _batch(V, seed=10 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = step(state, {k: _t(v) for k, v in batch.items()})
        for k in ("loss_total", "loss", "mean_log_z", "head_hit_rate",
                  "k_eff", "head_live", "grad_norm", "lr"):
            _close(float(met[k]), float(jmet[k]), what=f"step {i} {k}")
    assert state.opt.step == 3
    lr = float(jmet["lr"])
    want = dict(_items(jax.tree.map(np.asarray, jstate.params)))
    p0 = dict(_items(jax.tree.map(np.asarray, before)))
    for name, g in _items(state.params):
        g = g.detach().numpy()
        np.testing.assert_allclose(g, want[name], rtol=0, atol=0.25 * lr,
                                   err_msg=name)
        du, dw = g - p0[name], want[name] - p0[name]
        assert np.linalg.norm(du - dw) <= 5e-3 * np.linalg.norm(dw) + 1e-12, \
            name


@pytest.mark.parametrize("loss", ["mimps_ce", "lsh_ce"])
def test_index_refresh_matches_jax(loss):
    """make_index_refresh on JAX's state carried across, after its head
    matrix moved: the new index equals JAX's, churn and drift too, and
    every tensor keeps its shape and dtype."""
    jcfg, tcfg = _cfgs()
    jm, tm = JModel(jcfg), Model(tcfg)
    jtc, jstate = _jax_state(jm, loss, seed=2)
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, jstate.params)
    params = dict(params)
    params["lm_head"] = (params["lm_head"] + 0.05 * rng.standard_normal(
        params["lm_head"].shape)).astype(np.float32)
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, params))
    jnew, jm_ = jloop.make_index_refresh(jm, jtc)(jstate)
    tc = TrainConfig(loss=loss)
    state = train_loop.TrainState(
        params=params_from_numpy(params, tcfg, device="cpu"), opt=None,
        rng=None, index=_carry_index(jstate.index, loss))
    new, m = train_loop.make_index_refresh(tm, tc)(state)
    for k in ("churn", "drift"):
        _close(float(m[k]), float(jm_[k]), what=k)
    for f, a, b in zip(new.index._fields, new.index, jnew.index):
        if torch.is_tensor(a):
            old = getattr(state.index, f)
            assert a.shape == old.shape and a.dtype == old.dtype, f
            _grad_close(a.numpy(), _np(b), f)
        else:
            assert a == b, f


def test_init_train_state_builds_the_index():
    """init_train_state gives mimps_ce/mince_ce a fixed-capacity IVF
    index and lsh_ce an LSH index of the initial head, seeded (two calls
    equal), and a dense loss none."""
    _, tcfg = _cfgs()
    tm = Model(tcfg)
    for loss, kind in (("mimps_ce", IVFIndex), ("mince_ce", IVFIndex),
                       ("lsh_ce", LSHIndex), ("fused_ce", type(None))):
        a = train_loop.init_train_state(tm, TrainConfig(loss=loss), 3,
                                        device="cpu")
        assert isinstance(a.index, kind), loss
        if a.index is None:
            continue
        b = train_loop.init_train_state(tm, TrainConfig(loss=loss), 3,
                                        device="cpu")
        for x, y in zip(a.index, b.index):
            assert (torch.equal(x, y) if torch.is_tensor(x) else x == y)
    idx = train_loop.init_train_state(tm, TrainConfig(loss="mimps_ce"), 3,
                                      device="cpu").index
    assert idx.n_blocks == -(-V // 64) + 8             # ivf_capacity_blocks


def test_index_rows_track_params():
    """After steps and a refresh, the index's rows equal the current head
    matrix (the staleness the refresh removes), and the instrumented step
    folds the counters."""
    _, tcfg = _cfgs()
    tm = Model(tcfg)
    tc = TrainConfig(loss="mimps_ce", lr=1e-3, warmup_steps=1)
    state = train_loop.init_train_state(tm, tc, 0, device="cpu")
    step = train_loop.make_instrumented_step(
        train_loop.make_train_step(tm, tc))
    counters = train_loop.init_train_metric_state(device="cpu")
    batch = {k: _t(v) for k, v in _batch(V).items()}
    losses_ = []
    for _ in range(4):
        state, counters, met = step(state, counters, batch)
        losses_.append(float(met["loss_total"]))
    assert all(np.isfinite(losses_)) and losses_[-1] < losses_[0]
    assert train_loop.harvest_train_metrics(counters)["steps"] == 4
    state, metrics = train_loop.make_index_refresh(tm, tc)(state)
    w = tm.head_matrix(state.params).detach()
    idx = state.index
    got = idx.v_blocks.reshape(-1, w.shape[1])[idx.slot_of_row.long()]
    assert torch.equal(got, w)
    assert float(metrics["drift"]) > 0


@pytest.mark.parametrize("loss", ["mince_ce", "nce", "sampled"])
def test_other_losses_train(loss):
    """mince_ce, nce and sampled run through make_train_step from their
    generator: finite losses that fall on a repeated batch."""
    _, tcfg = _cfgs()
    tm = Model(tcfg)
    tc = TrainConfig(loss=loss, lr=1e-3, warmup_steps=1)
    state = train_loop.init_train_state(tm, tc, 1, device="cpu")
    step = train_loop.make_train_step(tm, tc)
    batch = {k: _t(v) for k, v in _batch(V).items()}
    vals = []
    for _ in range(3):
        state, met = step(state, batch)
        vals.append(float(met["loss_total"]))
    assert all(np.isfinite(vals)) and vals[-1] < vals[0], vals


def test_global_norm_of_a_sparse_gradient():
    """The clip's global norm of an estimator loss's gradient (few non-zero
    rows of the head) and of a dense leaf equals JAX's to 1e-6: an f32
    ``vector_norm`` of a whole leaf on the CPU was 1.6e-5 off on the
    first and 4e-4 off on the second."""
    from repro.train import optimizer as jopt
    rng = np.random.default_rng(0)
    g = np.zeros((V, 128), np.float32)
    rows = rng.choice(V, 300, replace=False)
    g[rows] = rng.standard_normal((300, 128)).astype(np.float32) \
        * rng.lognormal(0, 2, (300, 1)).astype(np.float32)
    tree = {"lm_head": g, "b": rng.standard_normal(64).astype(np.float32),
            "dense": rng.standard_normal((4096, 2560)).astype(np.float32)}
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = optimizer.global_norm({k: _t(v) for k, v in tree.items()})
    assert got.dtype == torch.float32
    _close(got.item(), want, 1e-6, "global norm")
    exact = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                        for v in tree.values()))
    _close(got.item(), exact, 1e-6, "global norm vs float64")
