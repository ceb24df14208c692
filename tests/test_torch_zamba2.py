"""Zamba2 (the ``hybrid`` family: ``repro_torch.models.mamba`` and the
hybrid plan in ``models/transformer.py``) against the JAX package at
``reduced_config("zamba2-7b")`` (8 layers: one group of 6 Mamba2 blocks
followed by the one shared attention block, then 2 Mamba2 blocks; d 128,
state 16, conv 4; vocab 1024), f32, CPU, on the JAX init carried across by
``interop.params_from_numpy``.

Tolerances, each relative to max(1, max |value|): one Mamba2 block (the
recurrence over 24 steps) within 1e-6; ``forward``'s hidden states and 40
decode steps within 1e-4: the six blocks have no residual and shrink the
stream to |x| ~ 0.15, so the norms after them scale the blocks' last-ulp
differences (1e-6 a block) up to about 2e-5 of |h|; after every step each
state leaf of the first group (``conv_x``, ``conv_bc``, the f32 ``ssm``)
within 1e-5 of its magnitude, and the leaves fed after the shrink
(``shared_kv``, the tail's) within 1e-4. ``generate`` (mimps and exact,
the JAX tail draws injected) gives JAX's tokens, log Ẑ within 1e-5
relative. The slot
scheduler on a trace with a reused lane and a late admission into a lane
that sat dead equals the JAX scheduler token for token (C11); how far
those two requests lie from ``generate`` is recorded, not asserted. bf16:
the state's dtypes equal JAX's and one Mamba2 block's decode step stays
within 2**-5 of JAX's (0.7% measured)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.models import mamba as jmamba
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import mamba as tmamba
from repro_torch.models.transformer import _hybrid_plan
from repro_torch.serve import Scheduler, generate

ARCH = "zamba2-7b"
TOL = 1e-5
HIDDEN_TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    return F.build(ARCH)


def _block0(npp):
    return jax.tree.map(lambda t: t[0, 0], npp["mamba_groups"])


def test_init_tree_equals_jax_with_one_shared_block():
    got, want = F.init_shapes(ARCH)
    assert got == want
    # one weight copy of the shared block, no group axis
    assert got["['shared_attn']['attn']['wq']"][0] == (128, 128)
    assert got["['mamba_groups']['a_log']"][1] == "float32"
    # at full width: 13 groups of 6 and a tail of 3, one shared copy
    assert _hybrid_plan(get_config(ARCH)) == (13, 6, 3)
    full = jax.eval_shape(JModel(j_get_config(ARCH)).init,
                          jax.random.PRNGKey(0))
    assert full["shared_attn"]["attn"]["wq"].shape == (3584, 3584)
    assert full["mamba_groups"]["wz"].shape[:2] == (13, 6)


def test_mamba_block_equals_jax(model):
    x = np.random.default_rng(0).standard_normal((2, 24, 128)) \
        .astype(np.float32)
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    pj = _block0(model["npp"])
    jo, js = jax.jit(lambda p, v: jmamba.mamba_block(p, v, jcfg))(
        jax.tree.map(jnp.asarray, pj), jnp.asarray(x))
    to, ts = tmamba.mamba_block(params_from_numpy(pj, tcfg, device="cpu"),
                                torch.from_numpy(x), tcfg)
    assert F.rel_err(to.numpy(), jo) <= 1e-6
    for name in ("conv_x", "conv_bc", "ssm"):
        assert F.rel_err(ts[name].numpy(), js[name]) <= 1e-6, name


def test_forward_equals_jax(model):
    toks = np.random.default_rng(2).integers(0, model["tcfg"].vocab, (2, 24))
    assert F.forward_err(model, toks) <= HIDDEN_TOL


def test_decode_state_leaf_by_leaf_equals_jax(model):
    toks = np.random.default_rng(3).integers(0, model["tcfg"].vocab, (2, 40))
    h_err, leaf_err = F.decode_errs(model, toks, max_len=48)
    assert h_err <= HIDDEN_TOL
    assert set(leaf_err) == {f"['{a}']['{b}']" for a in ("mamba",
                                                          "mamba_tail")
                             for b in ("conv_x", "conv_bc", "ssm")} | {
        "['shared_kv']['k']", "['shared_kv']['v']"}
    for name, err in leaf_err.items():
        # leaves fed by the stream after the six blocks inherit its scale
        tol = TOL if name.startswith("['mamba']") else HIDDEN_TOL
        assert err <= tol, (name, err)


def test_decode_bf16_dtype_conventions(model):
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in (model["jcfg"], model["tcfg"]))
    state = type(model["tm"])(tcfg).init_decode_state(2, 8, "cpu")
    assert F.shape_tree(state) == F.shape_tree(jax.eval_shape(
        lambda: JModel(jcfg).init_decode_state(2, 8)))
    pj = jax.tree.map(lambda t: t.astype(jnp.bfloat16),
                      _block0(model["npp"]))
    pj["a_log"] = pj["a_log"].astype(jnp.float32)   # f32 in a bf16 model
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), tcfg, device="cpu")
    js = jmamba.init_mamba_state(2, jcfg, jnp.bfloat16)
    ts = tmamba.init_mamba_state(2, tcfg, torch.bfloat16, "cpu")
    rng = np.random.default_rng(4)
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((2, 1, 128)), jnp.bfloat16)
        jo, js = jax.jit(lambda p, v, s: jmamba.mamba_block(p, v, jcfg, s))(
            pj, x, js)
        to, ts = tmamba.mamba_block(
            pt, torch.from_numpy(np.asarray(x, np.float32)).bfloat16(), tcfg,
            ts)
        assert F.rel_err(to.float().numpy(), np.asarray(jo, np.float32)) \
            <= 2 ** -5
        for name in ("conv_x", "conv_bc", "ssm"):
            assert str(ts[name].dtype).removeprefix("torch.") == \
                str(js[name].dtype)
            assert F.rel_err(ts[name].float().numpy(),
                             np.asarray(js[name], np.float32)) <= 2 ** -5


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
    for i in (2, 3):
        r = treqs[i]
        solo = generate(teng, r.prompt[None], r.max_new_tokens)[0].tolist()
        request.node.user_properties.append(
            (f"c11_request{i}_equals_generate", tc[i].tokens == solo))
    for kw in (dict(spec_draft="topk", spec_k=4),
               dict(prefix_cache_blocks=4)):
        with pytest.raises(NotImplementedError):
            Scheduler(teng, 3, **kw)
