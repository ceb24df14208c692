"""The port's engine lifecycle against the JAX engine (f32, CPU; qwen1.5-4b
reduced to 2 layers, vocab 2048, block_rows 64, 8 clusters): ``prefill``,
``swap_index`` on the fixed-capacity index, ``tier_state``, the index
digest, ``verify_and_restore``/``restore_index`` over corruptions installed
by ``_install_state``, the health guard in the engine and the ``overflow``
flag. Parity with JAX goes through injected k-means assignments and tail
draws (the JAX key schedule, as in test_torch_engine.py): greedy tokens are
equal, hidden states and log-values agree to 1e-4. The port's own
guarantees are bit for bit: a restore rebuilds the original state, the
tokens after it are the fault-free run's, a guarded healthy run is the
unguarded run, and a poisoned index under the guard serves the exact
engine's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import backends as jback
from repro.models import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve import generate as j_generate
from repro.serve.engine import _digest as j_digest
from repro_torch.configs import reduced_config
from repro_torch.core import backends as tback
from repro_torch.interop import feature_map_from_numpy, params_from_numpy
from repro_torch.models import Model
from repro_torch.serve import Engine, generate
from repro_torch.serve.engine import _digest, _shapes

ATOL = 1e-4
N_TOKENS, L = 4, 64


def _cfg(reduced, method="mimps"):
    cfg = reduced("qwen1.5-4b")
    return dataclasses.replace(
        cfg, vocab=2048, dtype="float32", partition=dataclasses.replace(
            cfg.partition, method=method, block_rows=64, n_probe=4, l=L,
            n_clusters=8, fmbe_features=64))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tail_source(key, n):
    """Tail draws of the JAX engine's step ``step_id``."""
    def source(step_id):
        k_est = jax.random.split(jax.random.fold_in(key, step_id))[0]
        return np.array(jax.random.randint(k_est, (L,), 0, n))
    return source


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfg(j_reduced_config), _cfg(reduced_config)
    jm = JModel(jcfg)
    jp0 = jm.init(jax.random.PRNGKey(5))
    jp1 = jm.init(jax.random.PRNGKey(6))              # "freshly trained"
    kb, key = jax.random.PRNGKey(2), jax.random.PRNGKey(9)
    jeng = JEngine(jm, jp0, max_len=16, key=kb, device_index=True)
    assign0 = _t(jeng.index.assign)
    jeng.swap_index(jp1)
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 3))
    jt, jaux = j_generate(jeng, jnp.asarray(prompt, jnp.int32), N_TOKENS,
                          key, return_aux=True)
    tm = Model(tcfg)
    tp0, tp1 = (params_from_numpy(jax.tree.map(np.asarray, p), tcfg,
                                  device="cpu") for p in (jp0, jp1))
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, jeng=jeng, jp1=jp1,
                jt=np.asarray(jt), jaux=jaux, tm=tm, tp0=tp0, tp1=tp1,
                assign0=assign0, prompt=prompt,
                source=_tail_source(key, jcfg.vocab))


def _index_tensors(index):
    return [x.clone() for x in index if isinstance(x, torch.Tensor)]


class TestSwap:
    def test_swap_index_matches_a_fresh_jax_engine(self, setup):
        """After swap_index the tokens are those of JAX's swapped engine
        (itself a fresh device_index engine's, as the JAX suite pins);
        every state shape is unchanged."""
        s = setup
        eng = Engine(s["tm"], s["tp0"], 16, device="cpu", device_index=True,
                     index_assign=s["assign0"])
        before = _shapes(eng.state)
        eng.swap_index(s["tp1"], index_assign=_t(s["jeng"].index.assign))
        assert _shapes(eng.state) == before
        assert eng.index.n_blocks == s["jeng"].index.n_blocks
        toks, aux = generate(eng, s["prompt"], N_TOKENS,
                             tail_source=s["source"], return_aux=True)
        np.testing.assert_array_equal(toks.numpy(), s["jt"])
        np.testing.assert_allclose(aux["log_z"].numpy(),
                                   np.asarray(s["jaux"]["log_z"]), atol=ATOL)

    def test_changed_vocab_raises_and_keeps_the_engine(self, setup):
        s = setup
        eng = Engine(s["tm"], s["tp0"], 16, device="cpu", device_index=True,
                     index_assign=s["assign0"])
        state = eng.state
        bad = dict(s["tp1"], lm_head=s["tp1"]["lm_head"][:1984].clone())
        with pytest.raises(ValueError, match="different shapes"):
            eng.swap_index(bad)
        assert eng.state is state and eng.params is s["tp0"]

    def test_prefill_matches_jax(self, setup):
        s = setup
        eng = Engine(s["tm"], s["tp1"], 16, device="cpu")
        h, st = eng.prefill(s["prompt"])
        jh, jst = s["jeng"].prefill(jnp.asarray(s["prompt"], jnp.int32))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
        assert st.pos == int(jst.pos) == 0
        np.testing.assert_array_equal(st.last_token.numpy(),
                                      np.asarray(jst.last_token))
        assert not st.cache["k"].any()
        out, _ = eng.decode_step(st)
        assert out["overflow"].dtype == torch.bool and not out["overflow"]


class TestTiers:
    def test_index_tiers_share_the_index_and_match_jax(self, setup):
        """topk and mince serve on the engine's own index object; their
        decodes equal JAX's tier decodes on the same hidden states."""
        s = setup
        eng = Engine(s["tm"], s["tp1"], 16, device="cpu", device_index=True,
                     index_assign=_t(s["jeng"].index.assign))
        pc, jpc = s["tcfg"].partition, s["jcfg"].partition
        h = np.random.default_rng(3).standard_normal(
            (3, s["tcfg"].d_model)).astype(np.float32)
        key = jax.random.PRNGKey(4)
        tail = _t(jax.random.randint(key, (L,), 0, s["jcfg"].vocab))
        for method in ("topk", "mince"):
            st = eng.tier_state(method)
            assert st.index is eng.index and eng.tier_state(method) is st
            got = tback.get_backend(method).decode(st, _t(h), pc, k=4,
                                                   tail_idx=tail)
            want = jback.get_backend(method).decode(
                s["jeng"].tier_state(method), jnp.asarray(h), key, jpc, k=4)
            np.testing.assert_allclose(got.log_z.numpy(),
                                       np.asarray(want.log_z), atol=ATOL)
            np.testing.assert_array_equal(got.top_id.numpy(),
                                          np.asarray(want.top_id))

    def test_fmbe_tier_builds_its_sketch_over_the_shared_index(self, setup):
        s = setup
        eng = Engine(s["tm"], s["tp1"], 16, device="cpu", device_index=True,
                     index_assign=_t(s["jeng"].index.assign))
        st = eng.tier_state("fmbe")
        assert st.index is eng.index
        assert st.fmbe.lambda_blocks.shape[0] == eng.index.n_blocks
        fmbe_eng = Engine(Model(_cfg(reduced_config, "fmbe")), s["tp1"], 16,
                          device="cpu", device_index=True,
                          index_assign=_t(s["jeng"].index.assign))
        for a, b in zip(st.fmbe.fm[:3], fmbe_eng.state.fmbe.fm[:3]):
            assert torch.equal(a, b)         # the same seed's feature map
        assert torch.equal(st.fmbe.lambda_blocks,
                           fmbe_eng.state.fmbe.lambda_blocks)
        # JAX's fmbe tier over the same index, through its feature map
        jst = s["jeng"].tier_state("fmbe")
        fm = jst.fmbe.fm
        tfm = feature_map_from_numpy(*(np.asarray(a) for a in fm[:3]),
                                     p=fm.p, device="cpu")
        lam = tback.fmbe_block_state(tfm, eng.index, eng.state.w)
        jlam = np.asarray(jst.fmbe.lambda_blocks)
        assert (np.abs(lam.lambda_blocks.numpy() - jlam) <=
                1e-4 * np.abs(jlam).max() + 1e-6).all()

    def test_generate_on_a_tier_equals_that_engine(self, setup):
        s = setup
        eng = Engine(s["tm"], s["tp1"], 16, device="cpu", device_index=True)
        topk = Engine(Model(_cfg(reduced_config, "topk")), s["tp1"], 16,
                      device="cpu", device_index=True,
                      index_assign=eng.index.assign)
        a = generate(eng, s["prompt"], N_TOKENS, tier="topk")
        b = generate(topk, s["prompt"], N_TOKENS)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def own(setup):
    """An engine on its own k-means (seed 3), so a restore rebuilds it."""
    s = setup
    return Engine(s["tm"], s["tp1"], 16, device="cpu", device_index=True,
                  seed=3)


def _corrupt(index, mode):
    vb = index.v_blocks.clone()
    if mode == "zero":
        vb[:2] = 0
    elif mode == "permute":
        vb[[0, 1, 2, 3]] = vb[[1, 0, 3, 2]]
    else:
        g = torch.Generator().manual_seed(7)
        vb += 0.05 * torch.randn(vb.shape, generator=g)
    return index._replace(v_blocks=vb)


class TestRestore:
    @pytest.mark.parametrize("mode", ["zero", "permute", "drift"])
    def test_verify_and_restore(self, setup, own, mode):
        """The digest catches the corruption; the rebuild is the original
        state bit for bit, and the tokens after it the fault-free run's."""
        s, eng = setup, own
        assert eng.verify_and_restore() is False
        clean = _index_tensors(eng.index)
        base, base_aux = generate(eng, s["prompt"], N_TOKENS,
                                  tail_source=s["source"], return_aux=True)
        restores = eng.index_restores
        eng._install_state(dataclasses.replace(
            eng.state, index=_corrupt(eng.index, mode)))
        assert eng.verify_and_restore() is True
        assert eng.index_restores == restores + 1
        for a, b in zip(_index_tensors(eng.index), clean):
            assert torch.equal(a, b)
        toks, aux = generate(eng, s["prompt"], N_TOKENS,
                             tail_source=s["source"], return_aux=True)
        assert torch.equal(toks, base)
        assert torch.equal(aux["log_z"], base_aux["log_z"])
        assert eng.verify_and_restore() is False

    def test_rebuild_leaves_the_decode_draws_alone(self, setup):
        """Two engines of one seed: a restore between two generate calls of
        one of them does not move its tail draws (log Ẑ bit-equal)."""
        s = setup
        a, b = (Engine(s["tm"], s["tp1"], 16, device="cpu",
                       device_index=True, seed=4) for _ in range(2))
        for eng in (a, b):
            generate(eng, s["prompt"], 2)
        a.restore_index()
        _, aux_a = generate(a, s["prompt"], N_TOKENS, return_aux=True)
        _, aux_b = generate(b, s["prompt"], N_TOKENS, return_aux=True)
        assert torch.equal(aux_a["log_z"], aux_b["log_z"])

    def test_digest_is_permutation_sensitive_and_deterministic(self, own):
        vb = own.index.v_blocks
        ref = _digest(vb)
        assert _digest(vb.clone()) == ref
        swapped = vb.clone()
        swapped[[0, 1]] = swapped[[1, 0]]
        assert _digest(swapped) != ref
        # the JAX digest is permutation-sensitive on the same rows too, and
        # both position-weighted sums agree with float64 to 1e-5 of
        # sum |w_p x_pd|
        j_ref = j_digest(jnp.asarray(vb.numpy()))
        assert j_digest(jnp.asarray(swapped.numpy())) != j_ref
        x = vb.numpy().astype(np.float64).reshape(-1, vb.shape[-1])
        wts = 1.0 + np.arange(x.shape[0])[:, None]
        a64, scale = (wts * x).sum(), np.abs(wts * x).sum()
        for a in (ref[0], j_ref[0]):
            assert abs(a - a64) <= 1e-5 * scale
        b64 = (x * x).sum()
        for b in (ref[1], j_ref[1]):
            assert abs(b - b64) <= 1e-5 * b64


class TestGuardInTheEngine:
    def test_guarded_healthy_run_is_the_unguarded_run(self, setup, own):
        s = setup
        guarded = Engine(s["tm"], s["tp1"], 16, device="cpu",
                         device_index=True, seed=3, health_guard=True)
        runs = [generate(e, s["prompt"], N_TOKENS, tail_source=s["source"],
                         return_aux=True) for e in (guarded, own)]
        assert torch.equal(runs[0][0], runs[1][0])
        for name in ("log_z", "log_prob"):
            assert torch.equal(runs[0][1][name], runs[1][1][name]), name

    def test_poisoned_index_serves_the_exact_tokens(self, setup):
        """NaN rows in the installed index flag every query of every step,
        and the guard serves the exact engine's tokens and log Z."""
        s = setup
        eng = Engine(s["tm"], s["tp1"], 16, device="cpu", device_index=True,
                     seed=3, health_guard=True)
        poisoned = eng.index._replace(
            v_blocks=torch.full_like(eng.index.v_blocks, float("nan")))
        eng._install_state(dataclasses.replace(eng.state, index=poisoned))
        exact = Engine(Model(_cfg(reduced_config, "exact")), s["tp1"], 16,
                       device="cpu")
        got, aux = generate(eng, s["prompt"], N_TOKENS, return_aux=True)
        want, want_aux = generate(exact, s["prompt"], N_TOKENS,
                                  return_aux=True)
        assert torch.equal(got, want)
        assert torch.equal(aux["log_z"], want_aux["log_z"])
        unguarded = Engine(s["tm"], s["tp1"], 16, device="cpu",
                           device_index=True, seed=3)
        unguarded._install_state(dataclasses.replace(unguarded.state,
                                                     index=poisoned))
        _, bad = generate(unguarded, s["prompt"], 1, return_aux=True)
        assert torch.isnan(bad["log_z"]).all()
