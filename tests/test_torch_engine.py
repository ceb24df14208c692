"""The port's serving engine against the JAX engine (f32, CPU): the same
params (``interop.params_from_numpy``), the same IVF index (the JAX k-means
assignment injected), for ``fmbe`` the same feature map
(``interop.feature_map_from_numpy``), for ``lsh`` the same hyperplanes
(``Engine(lsh_proj=...)``) and, for ``mimps``, ``mince`` and ``lsh``, the
same tail samples (the JAX key schedule replayed by ``tail_source``).
Greedy tokens are equal; log_z and log_prob agree to 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import lsh as j_lsh
from repro.models import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve import generate as j_generate
from repro_torch.configs import reduced_config
from repro_torch.interop import feature_map_from_numpy, params_from_numpy
from repro_torch.kernels.topk_z import NEG
from repro_torch.models import Model
from repro_torch.serve import Engine, generate

ATOL = 1e-4
N_TOKENS = 5
METHODS = ["exact", "mimps", "selfnorm", "topk", "mince", "fmbe", "lsh"]
INDEXED = ("mimps", "topk", "mince", "fmbe")


def _cfg(reduced, method):
    cfg = reduced("qwen1.5-4b")
    return dataclasses.replace(
        cfg, vocab=2048, dtype="float32", partition=dataclasses.replace(
            cfg.partition, method=method, block_rows=128, n_probe=4, l=128,
            fmbe_features=128))


def _tail_source(key, l, n, lsh_index=None):
    """Tail draws of the JAX engine's step ``step_id``: fold_in, split,
    then plan_tail's randint, or for ``lsh`` the plan's inverse-CDF draws
    (they depend on the index and the key, not on the hidden states)."""
    def source(step_id):
        k_est = jax.random.split(jax.random.fold_in(key, step_id))[0]
        if lsh_index is not None:
            return np.array(j_lsh.lsh_plan(
                lsh_index, jnp.zeros((1, lsh_index.proj.shape[-1] - 1)),
                k_est, l).tail_ids)
        return np.array(jax.random.randint(k_est, (l,), 0, n))
    return source


@pytest.fixture(scope="module", params=METHODS)
def served(request):
    method = request.param
    jcfg, tcfg = _cfg(j_reduced_config, method), _cfg(reduced_config, method)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(5))
    jeng = JEngine(jm, jp, max_len=32)
    key = jax.random.PRNGKey(9)
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, (3, 4))
    jt, jaux = j_generate(jeng, jnp.asarray(prompt, jnp.int32), N_TOKENS,
                          key, return_aux=True)
    tm = Model(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assign = None if jeng.index is None else \
        torch.from_numpy(np.array(jeng.index.assign))
    fm = None if jeng.state.fmbe is None else feature_map_from_numpy(
        *(np.asarray(a) for a in jeng.state.fmbe.fm[:3]),
        p=jeng.state.fmbe.fm.p, device="cpu")
    lsh = jeng.state.lsh
    proj = None if lsh is None else torch.from_numpy(np.array(lsh.proj))
    source = _tail_source(key, jcfg.partition.l, jcfg.vocab, lsh)
    return dict(method=method, jt=np.asarray(jt), jaux=jaux, tm=tm, tp=tp,
                tcfg=tcfg, assign=assign, fm=fm, proj=proj, prompt=prompt,
                source=source)


def _engine(s, **kw):
    return Engine(s["tm"], s["tp"], device="cpu", index_assign=s["assign"],
                  feature_map=s["fm"], lsh_proj=s["proj"], **kw)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_greedy_generate_matches_jax(served, use_kernel):
    s = served
    eng = _engine(s, max_len=32, use_kernel=use_kernel)
    assert (eng.index is not None) == (s["method"] in INDEXED)
    assert (eng.state.lsh is not None) == (s["method"] == "lsh")
    toks, aux = generate(eng, s["prompt"], N_TOKENS,
                         tail_source=s["source"], return_aux=True)
    np.testing.assert_array_equal(toks.numpy(), s["jt"])
    for name in ("log_z", "log_prob"):
        np.testing.assert_allclose(aux[name].numpy(),
                                   np.asarray(s["jaux"][name]), atol=ATOL,
                                   err_msg=name)


def test_temperature_draws_candidates_deterministically(served):
    s = served
    def engine(seed):
        return _engine(s, max_len=32, seed=seed)
    eng = engine(0)
    pc = s["tcfg"].partition
    h = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, s["tcfg"].d_model)).astype(np.float32))
    cand = eng.backend.decode(eng.state, h, pc, k=pc.sample_k,
                              generator=eng.generator)
    allowed = [set(ids[v > NEG * 0.5].tolist())
               for ids, v in zip(cand.top_id.numpy(), cand.top_score.numpy())]
    drawn = [set() for _ in allowed]
    for _ in range(40):
        tok = eng.next_token_distribution(h, temperature=2.0)["token"]
        for q, t in enumerate(tok.tolist()):
            assert t in allowed[q]
            drawn[q].add(t)
    assert any(len(d) > 1 for d in drawn)          # it does sample
    a = generate(engine(3), s["prompt"], N_TOKENS, temperature=0.8)
    b = generate(engine(3), s["prompt"], N_TOKENS, temperature=0.8)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_generate_guards(served):
    s = served
    eng = _engine(s, max_len=8)
    with pytest.raises(ValueError, match="non-empty prompt"):
        generate(eng, np.zeros((2, 0), np.int64), 2)
    with pytest.raises(ValueError, match="n_tokens"):
        generate(eng, s["prompt"], 0)
    with pytest.raises(ValueError, match="max_len"):
        generate(eng, s["prompt"], 6)
