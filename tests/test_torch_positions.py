"""Decode positions as device data, against the JAX package (f32, CPU;
qwen1.5-4b reduced to 2 layers, vocab 2048): ``decode_self_attention`` and
``Model.decode_step`` at a 0-d position shared by the batch and at a (B,)
vector with the lanes at different depths, with and without a sliding
window (whose cache is a ring), agree with JAX's per-slot decode to 1e-4,
hidden states and KV caches. The lane-window ops of the prefix cache,
``slice_lane_window`` and ``write_lane_window``, give JAX's bits, starts
past the end clamped as ``lax.dynamic_slice`` clamps them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import _layer

ATOL = 1e-4
B, MAX_LEN = 3, 8


def _cfgs(window=0):
    over = dict(vocab=2048, dtype="float32", sliding_window=window)
    return (dataclasses.replace(j_reduced_config("qwen1.5-4b"), **over),
            dataclasses.replace(reduced_config("qwen1.5-4b"), **over))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _pos(kind, t=0):
    """0-d, or (B,) with the lanes 0, 1 and 3 steps apart."""
    if kind == "shared":
        return np.int32(t)
    return np.array([t, t + 1, t + 3], np.int32)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("kind", ["shared", "per_lane"])
def test_decode_self_attention_matches_jax(models, kind, window):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(1)
    s_max = min(MAX_LEN, window) if window else MAX_LEN
    shape = (B, s_max, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    pos = _pos(kind, 4)                       # past the window: ring slots
    jpa = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    want, jcache = jattn.decode_self_attention(
        jpa, jnp.asarray(x), jattn.KVCache(k=jnp.asarray(k0),
                                           v=jnp.asarray(v0)),
        jnp.asarray(pos), jcfg, window=window)
    cache = tattn.KVCache(k=torch.from_numpy(k0.copy()),
                          v=torch.from_numpy(v0.copy()))
    got = tattn.decode_self_attention(
        _layer(tp["blocks"], 0)["attn"], torch.from_numpy(x), cache,
        torch.from_numpy(np.asarray(pos)), tcfg, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               atol=ATOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v),
                               atol=ATOL)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("kind", ["shared", "per_lane"])
def test_model_decode_step_matches_jax(kind, window):
    """Six consecutive steps from lanes at different depths (the ring of a
    4-slot window wraps): hidden states and caches to 1e-4."""
    jcfg, tcfg = _cfgs(window)
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(4))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tcfg.vocab, (6, B))
    jstate = jm.init_decode_state(B, MAX_LEN)
    tstate = tm.init_decode_state(B, MAX_LEN, "cpu")
    step = jax.jit(jm.decode_step)
    for t in range(5 if kind == "per_lane" else 6):
        pos = _pos(kind, t)
        jh, jstate = step(jp, jstate, jnp.asarray(tokens[t]),
                          jnp.asarray(pos))
        th = tm.decode_step(tp, tstate, torch.from_numpy(tokens[t]),
                            torch.from_numpy(np.asarray(pos)))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                                   err_msg=f"step {t}")
    for name in ("k", "v"):
        np.testing.assert_allclose(tstate[name].numpy(),
                                   np.asarray(jstate["kv"][name]), atol=ATOL)


def test_per_lane_step_equals_each_lane_alone(models):
    """A (B,) position vector gives each lane what a batch of that lane
    alone at its 0-d position gives, to 1e-5 (a batch of one sums its
    products in another order)."""
    _, tcfg, _, tp = models
    tm = Model(tcfg)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab, (4, B)))
    pos0 = torch.tensor([0, 1, 3], dtype=torch.int32)
    state = tm.init_decode_state(B, MAX_LEN, "cpu")
    lanes = [tm.init_decode_state(1, MAX_LEN, "cpu") for _ in range(B)]
    for t in range(4):
        h = tm.decode_step(tp, state, tokens[t], pos0 + t)
        for b in range(B):
            hb = tm.decode_step(tp, lanes[b], tokens[t, b:b + 1],
                                pos0[b] + t)
            np.testing.assert_allclose(h[b:b + 1].numpy(), hb.numpy(),
                                       atol=1e-5)


def test_python_int_position_is_the_tensor_position(models):
    _, tcfg, _, tp = models
    tm = Model(tcfg)
    tok = torch.tensor([5, 6, 7])
    a, b = (tm.init_decode_state(B, MAX_LEN, "cpu") for _ in range(2))
    for t in range(3):
        ha = tm.decode_step(tp, a, tok + t, t)
        hb = tm.decode_step(tp, b, tok + t, torch.tensor(t, dtype=torch.int32))
        assert torch.equal(ha, hb)


@pytest.mark.parametrize("lane,start,length", [
    (0, 0, 3), (2, 5, 3), (1, 6, 3),           # the last start is clamped
    (3, 0, 8), (5, 2, 1)])                     # lane 5 clamps to 3
def test_lane_window_ops_are_jax_bit_for_bit(lane, start, length):
    rng = np.random.default_rng(4)
    leaf = rng.standard_normal((2, 4, 8, 2, 16)).astype(np.float32)
    got = tattn.slice_lane_window(torch.from_numpy(leaf),
                                  torch.tensor(lane), torch.tensor(start),
                                  length)
    want = jattn.slice_lane_window(jnp.asarray(leaf), lane, start, length)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    rows = rng.standard_normal((2, 1, length, 2, 16)).astype(np.float32)
    t_leaf = torch.from_numpy(leaf.copy())
    out = tattn.write_lane_window(t_leaf, torch.from_numpy(rows),
                                  torch.tensor(lane), torch.tensor(start))
    assert out is t_leaf
    want = jattn.write_lane_window(jnp.asarray(leaf), jnp.asarray(rows),
                                   lane, start)
    np.testing.assert_array_equal(t_leaf.numpy(), np.asarray(want))


def test_lane_window_round_trip():
    """A window written into one lane reads back unchanged, and the other
    lanes keep their rows."""
    leaf = torch.zeros((3, 6, 2, 4))
    rows = torch.arange(3 * 2 * 4, dtype=torch.float32).reshape(
        1, 3, 2, 4)
    tattn.write_lane_window(leaf, rows, torch.tensor(1), torch.tensor(2))
    assert torch.equal(tattn.slice_lane_window(leaf, torch.tensor(1),
                                               torch.tensor(2), 3), rows)
    assert not leaf[0].any() and not leaf[2].any()
