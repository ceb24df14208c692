"""The port's dense decode step against the JAX package's, with the JAX
init carried across by ``interop.params_from_numpy`` (f32, CPU): hidden
states agree to 1e-4 over consecutive positions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import Model as JModel
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model

ATOL = 1e-4


def _cfgs():
    over = dict(vocab=2048, dtype="float32")
    return (dataclasses.replace(j_reduced_config("qwen1.5-4b"), **over),
            dataclasses.replace(reduced_config("qwen1.5-4b"), **over))


def test_decode_step_hidden_states_match():
    jcfg, tcfg = _cfgs()
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    # non-zero qkv biases so the bias path is exercised
    jp["blocks"]["attn"] = dict(jp["blocks"]["attn"])
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        jp["blocks"]["attn"][name] = jnp.asarray(
            0.1 * rng.standard_normal(jp["blocks"]["attn"][name].shape),
            jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    b, steps = 3, 6
    tokens = rng.integers(0, tcfg.vocab, (steps, b))
    jstate = jm.init_decode_state(b, 8)
    tstate = tm.init_decode_state(b, 8, "cpu")
    step = jax.jit(jm.decode_step)
    for pos in range(steps):
        jh, jstate = step(jp, jstate, jnp.asarray(tokens[pos]),
                          jnp.asarray(pos, jnp.int32))
        th = tm.decode_step(tp, tstate, torch.from_numpy(tokens[pos]), pos)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                                   err_msg=f"position {pos}")
    np.testing.assert_allclose(tstate["k"].numpy(),
                               np.asarray(jstate["kv"]["k"]), atol=ATOL)


def test_init_shapes_match_jax():
    jcfg, tcfg = _cfgs()
    jp = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    tp = Model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    want = {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    got = {jax.tree_util.keystr(k): tuple(v.shape)
           for k, v in jax.tree_util.tree_leaves_with_path(tp)}
    assert got == want


def test_params_from_numpy_keeps_bf16_bits():
    jcfg = dataclasses.replace(j_reduced_config("qwen1.5-4b"), vocab=256)
    tcfg = dataclasses.replace(reduced_config("qwen1.5-4b"), vocab=256)
    jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(1)))
    tp = params_from_numpy(jp, tcfg, device="cpu")
    want = jp["blocks"]["attn"]["wq"]
    got = tp["blocks"]["attn"]["wq"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(jp, dataclasses.replace(tcfg, d_model=64),
                          device="cpu")
