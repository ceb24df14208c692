"""gemma3's local/global plan in the port against the JAX package at
``reduced_config("gemma3-4b")`` (8 layers: one group of 5 local + 1
global, then 2 local in the tail; window 32; d 128; vocab 1024), f32, CPU,
on the JAX init carried across by ``interop.params_from_numpy``.

Tolerances: ``forward``'s hidden states and 40 decode steps (past the
32-slot local ring) within 1e-5, relative to max(1, max |h|); every state
leaf (local ring, global, tail) within 1e-5 of its magnitude after every
step; ``generate`` (mimps and exact, a prompt that wraps the rings, the
JAX tail draws injected) gives JAX's tokens, log Ẑ within 1e-5 relative;
the slot scheduler on a staggered trace whose lanes wrap their rings gives
the JAX scheduler's tokens. The gelu MLP equals ``jax.nn.gelu``'s (the
tanh form) within 1e-6. bf16: the decode state's dtypes equal JAX's and 8
decode steps stay within 2**-5 of max(1, |h|) (bf16 rounds each op where
the JAX CPU backend keeps some fused ops in f32; 1.7% measured)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
from repro.models.layers import mlp as j_mlp
from repro.serve.prefix_cache import cache_is_kv_only as j_kv_only
from repro_torch.interop import decode_state_from_numpy, params_from_numpy
from repro_torch.models.layers import mlp as t_mlp
from repro_torch.serve import Scheduler
from repro_torch.serve.prefix_cache import cache_is_kv_only

ARCH = "gemma3-4b"
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    return F.build(ARCH)


def test_gelu_mlp_equals_jax():
    rng = np.random.default_rng(0)
    p = {"gate": rng.standard_normal((16, 32)).astype(np.float32),
         "up": rng.standard_normal((16, 32)).astype(np.float32) * 0.3,
         "down": rng.standard_normal((32, 16)).astype(np.float32) * 0.3}
    x = rng.uniform(-2, 2, (4, 16)).astype(np.float32)
    want = j_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), "gelu")
    got = t_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                torch.from_numpy(x), "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_init_tree_equals_jax():
    got, want = F.init_shapes(ARCH)
    assert got == want
    assert {"local_groups", "global_groups", "local_tail"} <= {
        k.split("'")[1] for k in got}


def test_forward_equals_jax(model):
    toks = np.random.default_rng(2).integers(0, model["tcfg"].vocab, (2, 40))
    assert F.forward_err(model, toks) <= TOL


def test_decode_past_the_ring_equals_jax(model):
    toks = np.random.default_rng(3).integers(0, model["tcfg"].vocab, (2, 40))
    h_err, leaf_err = F.decode_errs(model, toks, max_len=48)
    assert h_err <= TOL
    assert set(leaf_err) == {f"['{a}']['{b}']" for a in ("local", "global",
                                                          "tail")
                             for b in ("k", "v")}
    for name, err in leaf_err.items():
        assert err <= TOL, (name, err)
    state = model["tm"].init_decode_state(2, 48, "cpu")
    assert state["local"]["k"].shape[-3] == 32       # the ring
    assert state["global"]["k"].shape[-3] == 48


def test_decode_bf16_dtype_conventions(model):
    m = model
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in (m["jcfg"], m["tcfg"]))
    jp = jax.tree.map(lambda t: t.astype(jnp.bfloat16), m["jp"])
    bm = dict(m, jcfg=jcfg, tcfg=tcfg, jp=jp, jm=type(m["jm"])(jcfg),
              tm=type(m["tm"])(tcfg),
              tp=params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu"))
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 8))
    h_err, _ = F.decode_errs(bm, toks, max_len=16)
    assert h_err <= 2 ** -5
    assert F.shape_tree(bm["tm"].init_decode_state(2, 16, "cpu")) == \
        F.shape_tree(jax.eval_shape(lambda: bm["jm"].init_decode_state(2,
                                                                       16)))


@pytest.mark.parametrize("method", ["mimps", "exact"])
def test_generate_equals_jax(model, method):
    jt, tt, jz, tz = F.generate_pair(model, method, prompt_len=36, n_new=8,
                                     max_len=64)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tz, jz, rtol=TOL)


def test_scheduler_equals_jax(model):
    # prompts past the 32-slot ring: every long lane wraps its local rings
    reqs = [(30, 10, 0.0), (5, 6, 0.9), (34, 8, 0.0), (12, 4, 0.5)]
    jc, tc, teng, _ = F.scheduler_pair(model, 48, reqs, [0, 0, 2, 5])
    for a, b in zip(jc, tc):
        assert b.error is None and len(b.tokens) == b.request.max_new_tokens
        assert b.tokens == a.tokens
        np.testing.assert_allclose(b.log_zs, a.log_zs, rtol=TOL)
    for kw in (dict(spec_draft="topk", spec_k=4),
               dict(prefix_cache_blocks=4)):
        with pytest.raises(NotImplementedError):
            Scheduler(teng, 3, **kw)


def test_cache_is_kv_only_and_state_interop_equal_jax(model):
    from repro.configs import reduced_config as j_reduced_config
    from repro.models import Model as JModel
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model
    for arch in (ARCH, "qwen1.5-4b", "rwkv6-7b", "zamba2-7b"):
        jstate = JModel(j_reduced_config(arch)).init_decode_state(2, 8)
        tstate = Model(reduced_config(arch)).init_decode_state(2, 8, "cpu")
        got = cache_is_kv_only(tstate)
        assert got == j_kv_only(jstate), arch
        assert got == (arch in (ARCH, "qwen1.5-4b"))
        # the JAX state carried across leaf by leaf (qwen's {"kv": ...}
        # to the port's flat pair)
        carried = decode_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          device="cpu")
        assert F.shape_tree(carried) == F.shape_tree(tstate), arch


def test_params_from_numpy_checks_every_wq(model):
    for bad in (dict(n_heads=8), dict(head_dim=16)):
        with pytest.raises(ValueError, match="local_groups.attn.wq"):
            params_from_numpy(model["npp"], dataclasses.replace(
                model["tcfg"], **bad), device="cpu")
