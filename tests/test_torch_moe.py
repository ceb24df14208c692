"""The port's MoE family (``repro_torch.models.moe`` and the moe blocks of
``models/transformer.py``) against the JAX package at
``reduced_config("deepseek-moe-16b")`` (2 layers, 8 routed experts, top-2,
1 shared, d 128), f32, CPU, on the JAX init carried across by
``interop.params_from_numpy`` and the same numpy inputs.

Tolerances: ``moe_block``'s output and its aux terms within 1e-6 (absolute
and relative: the two frameworks' f32 products differ in the last ulps), at
capacity factor 1.25 and at 0.25, where entries are dropped; a tie in the
router's probabilities keeps ``lax.top_k``'s order (the lower expert
first); ``Model.forward``'s hidden states and ``decode_step``'s within 1e-5
over two blocks, the summed aux within 1e-6; ``generate`` (mimps and exact,
the JAX tail draws injected) and the slot scheduler (staggered requests,
the JAX scheduler's draws injected, so dead lanes route what the JAX
table's do) give JAX's tokens, log Ẑ within 1e-5 relative; one ``ce``
loss within 1e-6 with its aux terms."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serving as S
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import reduced_config as j_reduced_config
from repro.models import Model as JModel
from repro.models.moe import moe_block as j_moe_block
from repro.serve import Engine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import Server as JServer
from repro.serve import generate as j_generate
from repro.serve import trace_arrivals as j_trace_arrivals
from repro.train.losses import loss_ce as j_loss_ce
from repro_torch.configs import TrainConfig, reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.models import moe as tmoe
from repro_torch.serve import Engine, Scheduler, Server, generate
from repro_torch.serve import trace_arrivals
from repro_torch.train.losses import loss_ce

ARCH = "deepseek-moe-16b"
TOL = 1e-6
HIDDEN_TOL = 1e-5


def _cfgs(**moe):
    j, t = (dataclasses.replace(r(ARCH), dtype="float32")
            for r in (j_reduced_config, reduced_config))
    if moe:
        j, t = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
                for c in (j, t))
    return j, t


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, jp=jp, npp=npp, tm=Model(tcfg),
                tp=params_from_numpy(npp, tcfg, device="cpu"))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _block_pair(model, x, router=None, **moe):
    """moe_block of layer 0 in both packages on x (numpy)."""
    jcfg, tcfg = _cfgs(**moe)
    jl = _layer0(model["npp"]["blocks"]["ffn"])
    if router is not None:
        jl["router"] = router
    tl = params_from_numpy(jl, tcfg, device="cpu")
    jo, ja = jax.jit(lambda p, v: j_moe_block(p, v, jcfg))(
        jax.tree.map(jnp.asarray, jl), jnp.asarray(x))
    to, ta = tmoe.moe_block(tl, torch.from_numpy(x), tcfg)
    return (np.asarray(jo), {k: float(v) for k, v in ja.items()},
            to.numpy(), {k: float(v) for k, v in ta.items()})


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_block_equals_jax(model, cf):
    x = np.random.default_rng(0).standard_normal((3, 7, 128)) \
        .astype(np.float32)
    jo, ja, to, ta = _block_pair(model, x, capacity_factor=cf)
    _close(to, jo, TOL, "out")
    for name in ("moe_balance", "moe_zloss", "moe_drop_frac"):
        _close(ta[name], ja[name], TOL, name)
    _, tcfg = _cfgs(capacity_factor=cf)
    assert tmoe.capacity(tcfg, 21) == max(int(cf * 21 * 2 / 8), 4)
    if cf < 1:
        # 42 (token, choice) entries for 8 experts of 4 slots: entries drop
        assert ta["moe_drop_frac"] > 0.1


@pytest.mark.parametrize("tie", ["all", "pairs"])
def test_router_tie_keeps_the_lower_expert_first(model, tie):
    router = np.array(model["npp"]["blocks"]["ffn"]["router"][0])
    if tie == "all":
        router[:] = 0.0                  # every probability 1/8
    else:
        router[:, 1] = router[:, 0]      # experts 0/1, 2/3, ... tie
        router[:, 3] = router[:, 2]
        router[:, 5] = router[:, 4]
        router[:, 7] = router[:, 6]
    x = np.random.default_rng(1).standard_normal((2, 5, 128)) \
        .astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(10, 128)) @ router, -1)
    _, j_top = jax.lax.top_k(probs, 2)
    _, _, _, t_top = tmoe.route(torch.from_numpy(router),
                                torch.from_numpy(x.reshape(10, 128)), 2)
    np.testing.assert_array_equal(t_top.numpy(), np.asarray(j_top))
    if tie == "all":
        assert (t_top.numpy() == [0, 1]).all()
    else:
        assert (t_top.numpy()[:, 0] % 2 == 0).all()   # the lower of a pair
    jo, ja, to, ta = _block_pair(model, x, router=router)
    _close(to, jo, TOL, "out")
    _close(ta["moe_drop_frac"], ja["moe_drop_frac"], TOL, "drop")


def test_router_product_turns_tf32_off_and_restores_the_flag():
    flag = torch.backends.cuda.matmul
    prev = flag.allow_tf32
    try:
        for before in (True, False):
            flag.allow_tf32 = before
            with tmoe._no_tf32():
                assert flag.allow_tf32 is False
            assert flag.allow_tf32 is before
            with pytest.raises(ZeroDivisionError):
                with tmoe._no_tf32():
                    1 / 0
            assert flag.allow_tf32 is before
    finally:
        flag.allow_tf32 = prev


def test_forward_and_aux_equal_jax(model):
    toks = np.random.default_rng(2).integers(0, model["tcfg"].vocab, (2, 9))
    jh, ja = jax.jit(model["jm"].forward)(model["jp"], jnp.asarray(toks))
    th, ta = model["tm"].forward(model["tp"], torch.from_numpy(toks))
    _close(th.numpy(), jh, HIDDEN_TOL, "hidden")
    assert set(ta) == set(ja)
    for name in ja:
        _close(float(ta[name]), float(ja[name]), TOL, name)
    assert float(ta["moe_balance"]) > 0 and float(ta["moe_zloss"]) > 0


def test_decode_step_equals_jax(model):
    jm, tm = model["jm"], model["tm"]
    b, steps = 3, 5
    toks = np.random.default_rng(3).integers(0, model["tcfg"].vocab,
                                             (steps, b))
    jstate = jm.init_decode_state(b, 8)
    tstate = tm.init_decode_state(b, 8, "cpu")
    step = jax.jit(jm.decode_step)
    for pos in range(steps):
        jh, jstate = step(model["jp"], jstate, jnp.asarray(toks[pos]),
                          jnp.asarray(pos, jnp.int32))
        th = tm.decode_step(model["tp"], tstate, torch.from_numpy(toks[pos]),
                            pos)
        _close(th.numpy(), jh, HIDDEN_TOL, f"position {pos}")
    _close(tstate["v"].numpy(), jstate["kv"]["v"], HIDDEN_TOL, "KV")


def test_init_tree_equals_jax_and_params_keep_dtypes(model):
    jcfg = j_reduced_config(ARCH)
    tcfg = reduced_config(ARCH)                     # bf16
    jp = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    tp = Model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")

    def leaves(tree):
        return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)
                                          .removeprefix("torch."))
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert leaves(tp) == leaves(jp)
    assert tp["blocks"]["ffn"]["router"].dtype == torch.float32
    # bf16 bits kept, router f32, widths checked against cfg.moe
    npb = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(1)))
    got = params_from_numpy(npb, tcfg, device="cpu")
    up = npb["blocks"]["ffn"]["experts"]["up"]
    np.testing.assert_array_equal(
        got["blocks"]["ffn"]["experts"]["up"].view(torch.int16).numpy(),
        up.view(np.int16))
    assert got["blocks"]["ffn"]["router"].dtype == torch.float32
    for bad in (dict(n_experts=4), dict(expert_d_ff=32), dict(n_shared=2)):
        with pytest.raises(ValueError, match="router|experts|shared"):
            params_from_numpy(npb, dataclasses.replace(
                tcfg, moe=dataclasses.replace(tcfg.moe, **bad)),
                device="cpu")


def test_ce_loss_and_aux_equal_jax(model):
    rng = np.random.default_rng(4)
    toks = rng.integers(0, model["tcfg"].vocab, (2, 8))
    labels = rng.integers(0, model["tcfg"].vocab, (2, 8))
    jl, jmet = j_loss_ce(model["jm"], model["jp"], {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, None,
        JTrainConfig())
    tl, tmet = loss_ce(model["tm"], model["tp"], {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)},
        None, TrainConfig())
    _close(float(tl), float(jl), TOL, "total")
    _close(float(tmet["loss"]), float(jmet["loss"]), TOL, "nll")
    # the aux terms the total adds: the same forward's, each within 1e-6
    _, ja = model["jm"].forward(model["jp"], jnp.asarray(toks))
    _, ta = model["tm"].forward(model["tp"], torch.from_numpy(toks))
    for name in ("moe_balance", "moe_zloss"):
        _close(float(ta[name]), float(ja[name]), TOL, name)
    assert float(tl) - float(tmet["loss"]) == pytest.approx(
        float(ta["moe_balance"] + ta["moe_zloss"]), rel=1e-4)


def _tail_source(key, l, n):
    """The JAX engine's tail draw of step ``step_id``."""
    def source(step_id):
        k_est = jax.random.split(jax.random.fold_in(key, step_id))[0]
        return np.array(jax.random.randint(k_est, (l,), 0, n))
    return source


@pytest.mark.parametrize("method", ["mimps", "exact"])
def test_generate_equals_jax(model, method):
    jcfg, tcfg = (dataclasses.replace(c, vocab=1024, partition=(
        dataclasses.replace(c.partition, method=method, block_rows=64,
                            n_probe=4, l=64)))
        for c in (model["jcfg"], model["tcfg"]))
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(5))
    jeng = JEngine(jm, jp, max_len=16)
    key = jax.random.PRNGKey(9)
    prompt = np.random.default_rng(5).integers(0, 1024, (4, 3))
    jt, jaux = j_generate(jeng, jnp.asarray(prompt, jnp.int32), 5, key,
                          return_aux=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assign = None if jeng.index is None else \
        torch.from_numpy(np.array(jeng.index.assign))
    eng = Engine(Model(tcfg), tp, 16, device="cpu", index_assign=assign)
    assert (eng.index is None) == (method == "exact")
    tt, taux = generate(eng, prompt, 5, return_aux=True,
                        tail_source=_tail_source(key, 64, 1024))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(taux["log_z"].numpy(), jaux["log_z"], 1e-5, "log_z")


def test_scheduler_tokens_equal_jax():
    jeng, teng = S.engines(arch=ARCH)
    pc = teng.cfg.partition
    at = [0, 0, 1, 3, 6]
    pairs = S.mixed_pairs(pc.sample_k, n=len(at), base=20)
    key = jax.random.PRNGKey(3)
    jrep = JServer(JScheduler(jeng, n_slots=3, key=key)).run(
        arrivals=j_trace_arrivals([p[0] for p in pairs], at))
    trep = Server(Scheduler(teng, 3, tail_source=S.tail_source(
        key, pc.l, S.VOCAB))).run(
        arrivals=trace_arrivals([p[1] for p in pairs], at))
    jc = S.by_request(jrep, [p[0] for p in pairs])
    tc = S.by_request(trep, [p[1] for p in pairs])
    for a, b in zip(jc, tc):
        assert b.error is None and len(b.tokens) == b.request.max_new_tokens
        assert b.tokens == a.tokens
        np.testing.assert_allclose(b.log_zs, a.log_zs, rtol=1e-5)
    assert trep.steps == jrep.steps
