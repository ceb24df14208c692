"""RWKV6 (the ``ssm`` family: ``repro_torch.models.rwkv`` and its plan in
``models/transformer.py``) against the JAX package at
``reduced_config("rwkv6-7b")`` (2 layers, d 128, 4 heads of 32; vocab
1024), f32, CPU, on the JAX init carried across by
``interop.params_from_numpy``.

Tolerances, each relative to max(1, max |value|): ``forward``'s hidden
states and 40 decode steps within 1e-5; after every step each state leaf
(``tm_last``, ``cm_last`` and the f32 ``wkv``, which grows to |S| ~ 30)
within 1e-5 of its magnitude; ``generate`` (mimps and exact, the JAX tail
draws injected) gives JAX's tokens, log Ẑ within 1e-5 relative. The slot
scheduler runs a trace with a reused lane and a late admission into a lane
that sat dead through earlier steps: the port equals the JAX scheduler
token for token (C11: neither resets a lane's recurrent state at
admission, and dead lanes step); how far those two requests lie from
``generate`` is recorded, not asserted. bf16: the state's dtypes equal
JAX's (``wkv`` f32) and 8 decode steps stay within 2**-5 (1.1%
measured)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro_torch.interop import params_from_numpy
from repro_torch.serve import Scheduler, generate

ARCH = "rwkv6-7b"
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    return F.build(ARCH)


def test_init_tree_equals_jax():
    got, want = F.init_shapes(ARCH)
    assert got == want
    assert "['blocks']['mix']['wr']" in got and not any(
        "attn" in k for k in got)


def test_params_from_numpy_takes_the_rwkv_tree(model):
    tp = params_from_numpy(model["npp"], model["tcfg"], device="cpu")
    assert tp["blocks"]["mix"]["bonus_u"].shape == (2, 4, 32)
    with pytest.raises(ValueError, match="blocks.mix.wr"):
        params_from_numpy(model["npp"], dataclasses.replace(
            model["tcfg"], n_layers=3), device="cpu")


def test_forward_equals_jax(model):
    toks = np.random.default_rng(2).integers(0, model["tcfg"].vocab, (2, 24))
    assert F.forward_err(model, toks) <= TOL


def test_decode_state_leaf_by_leaf_equals_jax(model):
    toks = np.random.default_rng(3).integers(0, model["tcfg"].vocab, (2, 40))
    h_err, leaf_err = F.decode_errs(model, toks, max_len=48)
    assert h_err <= TOL
    assert set(leaf_err) == {"['rwkv']['tm_last']", "['rwkv']['cm_last']",
                             "['rwkv']['wkv']"}
    for name, err in leaf_err.items():
        assert err <= TOL, (name, err)


def test_decode_bf16_dtype_conventions(model):
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in (model["jcfg"], model["tcfg"]))
    jp = jax.tree.map(lambda t: t.astype(jnp.bfloat16), model["jp"])
    bm = dict(model, jcfg=jcfg, tcfg=tcfg, jp=jp,
              jm=type(model["jm"])(jcfg), tm=type(model["tm"])(tcfg),
              tp=params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu"))
    state = bm["tm"].init_decode_state(2, 8, "cpu")
    assert F.shape_tree(state) == F.shape_tree(jax.eval_shape(
        lambda: bm["jm"].init_decode_state(2, 8)))
    assert state["rwkv"]["wkv"].dtype == torch.float32
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 8))
    h_err, _ = F.decode_errs(bm, toks, max_len=8)
    assert h_err <= 2 ** -5


@pytest.mark.parametrize("method", ["mimps", "exact"])
def test_generate_equals_jax(model, method):
    jt, tt, jz, tz = F.generate_pair(model, method, prompt_len=6, n_new=6,
                                     max_len=16)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tz, jz, rtol=TOL)


# three lanes: 0 and 1 from step 0; request 2 reuses lane 0 after request
# 0 finishes; request 3 enters lane 2, dead through the first steps
C11_REQS = [(3, 2, 0.0), (6, 10, 0.9), (5, 6, 0.0), (4, 5, 0.0)]
C11_AT = [0, 0, 6, 8]


def test_scheduler_equals_jax_on_a_reused_lane(model, request):
    jc, tc, teng, treqs = F.scheduler_pair(model, 24, C11_REQS, C11_AT)
    for a, b in zip(jc, tc):
        assert b.error is None and len(b.tokens) == b.request.max_new_tokens
        assert b.tokens == a.tokens
        np.testing.assert_allclose(b.log_zs, a.log_zs, rtol=TOL)
    # C11, recorded: the reused lane and the lane that sat dead against a
    # fresh batch-1 generate
    for i in (2, 3):
        r = treqs[i]
        solo = generate(teng, r.prompt[None], r.max_new_tokens)[0].tolist()
        request.node.user_properties.append(
            (f"c11_request{i}_equals_generate", tc[i].tokens == solo))
    for kw in (dict(spec_draft="topk", spec_k=4),
               dict(prefix_cache_blocks=4)):
        with pytest.raises(NotImplementedError):
            Scheduler(teng, 3, **kw)


def test_smoke_parameter_counts_equal_jax():
    """The full-width counts the smoke's families phase holds each built
    model to are the JAX package's ``eval_shape`` counts."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for arch in smoke.F_ARCHS:
        shapes = jax.eval_shape(JModel(j_get_config(arch)).init,
                                jax.random.PRNGKey(0))
        n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes))
        assert smoke.F_PARAMS[arch] == n, arch

