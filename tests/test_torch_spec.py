"""The port's speculative step against the JAX package's (f32, CPU): the
JAX serving tests' engine (``_torch_serving``), a topk draft at spec_k 3,
the JAX scheduler's tail draws and each request's noise injected. Tokens
equal JAX's, log Ẑ within 1e-5 relative, log_prob within 1e-4, and the
proposed and accepted counts equal JAX's.

Then the port's own contract, mirroring the JAX suite: drafts (topk, fmbe,
mimps) at spec_k 2–4 emit the plain scheduler's tokens bit for bit, and
so does speculation over a warm prefix pool; a lane evicted mid-round
keeps a prefix of its stream and leaves its neighbour alone; the ladder
swaps the verifier; a NaN draft falls back per lane; non-KV caches are
refused. ``spec_accept`` is held to JAX's on every point of the JAX
property test's domain and to its documented invariants, by enumeration
(the JAX property test fails in its hypothesis harness: ROADMAP C1)."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serving as S
from repro.serve import Scheduler as JScheduler
from repro.serve import Server as JServer
from repro.serve import trace_arrivals as j_trace_arrivals
from repro.serve.scheduler import spec_accept as j_spec_accept
from repro_torch.configs import ServingConfig
from repro_torch.models import Model
from repro_torch.serve import (Engine, NanLogitsFault, Request, Scheduler,
                               Server, trace_arrivals)
from repro_torch.serve.scheduler import spec_accept

AT = [0, 0, 1, 2, 4, 7]


@pytest.fixture(scope="module")
def run():
    jeng, teng = S.engines()
    pc = teng.cfg.partition
    pairs = S.mixed_pairs(pc.sample_k, n=len(AT), base=10)
    key = jax.random.PRNGKey(4)
    jsched = JScheduler(jeng, n_slots=3, key=key, spec_draft="topk",
                        spec_k=3)
    jrep = JServer(jsched).run(
        arrivals=j_trace_arrivals([p[0] for p in pairs], AT))
    tsched = Scheduler(teng, 3, spec_draft="topk", spec_k=3,
                       tail_source=S.tail_source(key, pc.l, S.VOCAB))
    trep = Server(tsched).run(
        arrivals=trace_arrivals([p[1] for p in pairs], AT))
    return dict(teng=teng, pairs=pairs, jrep=jrep, trep=trep)


def test_spec_equals_jax(run):
    j, t = run["jrep"], run["trep"]
    jc = S.by_request(j, [p[0] for p in run["pairs"]])
    tc = S.by_request(t, [p[1] for p in run["pairs"]])
    for a, b in zip(jc, tc):
        assert b.tokens == a.tokens and len(b.tokens) == \
            b.request.max_new_tokens
        np.testing.assert_allclose(b.log_zs, a.log_zs, rtol=1e-5)
        np.testing.assert_allclose(b.log_probs, a.log_probs, atol=1e-4)
    # not the probe-union sizes: drafts past a request's last step read
    # noise JAX draws from the request's key and the port never draws, so
    # their hidden states, and the union they probe, differ (they emit
    # nothing)
    for name in ("steps", "spec_proposed", "spec_accepted",
                 "spec_acceptance_by_tier", "draft_flagged"):
        assert getattr(t, name) == getattr(j, name), name
    assert 0.0 < t.spec_acceptance < 1.0


def _requests(base=0, n=4):
    rng = np.random.default_rng(300 + base)
    return [Request(prompt=rng.integers(0, S.VOCAB, 2 + (3 * i) % 5),
                    max_new_tokens=3 + (2 * i) % 6, seed=70 + base + i,
                    temperature=(0.0, 0.9, 0.5, 1.5)[i % 4])
            for i in range(n)]


def _tokens(rep, reqs):
    return [c.tokens for c in S.by_request(rep, reqs)]


def _serve(eng, reqs, at=None, cfg=None, **kw):
    sched = Scheduler(eng, 3, seed=2, **kw)
    at = [0, 0, 1, 3][:len(reqs)] if at is None else at
    return Server(sched, cfg).run(arrivals=trace_arrivals(reqs, at)), sched


@pytest.mark.parametrize("spec_k,draft", [(2, "topk"), (4, "topk"),
                                          (2, "fmbe"), (3, "mimps")])
def test_spec_equals_plain(run, spec_k, draft):
    eng = run["teng"]
    reqs = _requests()
    plain, _ = _serve(eng, reqs)
    reqs2 = [dataclasses.replace(r) for r in reqs]
    rep, sched = _serve(eng, reqs2, spec_draft=draft, spec_k=spec_k)
    assert _tokens(rep, reqs2) == _tokens(plain, reqs)
    assert 0.0 < rep.spec_acceptance <= 1.0
    assert rep.spec_accepted <= rep.spec_proposed
    assert rep.steps < plain.steps or draft == "mimps" or spec_k == 2


def test_spec_over_a_warm_prefix_pool(run):
    eng = run["teng"]
    prompts = [[7, 8, 9, 10, 11, 12, 3], [7, 8, 9, 10, 11, 12, 5, 6],
               [7, 8, 9, 10, 1]]
    mk = lambda: [Request(prompt=p, max_new_tokens=4, seed=i,
                          temperature=0.7 * (i % 2))
                  for i, p in enumerate(prompts)]
    plain_reqs = mk()
    plain, _ = _serve(eng, plain_reqs, at=[0, 0, 0])
    sched = Scheduler(eng, 3, seed=2, spec_draft="topk", spec_k=2,
                      prefix_cache_blocks=8, prefix_block_tokens=2)
    cold_reqs, warm_reqs = mk(), mk()
    cold = Server(sched).run(arrivals=trace_arrivals(cold_reqs, [0, 0, 0]))
    warm = Server(sched).run(arrivals=trace_arrivals(warm_reqs, [0, 0, 0]))
    want = _tokens(plain, plain_reqs)
    assert _tokens(cold, cold_reqs) == want == _tokens(warm, warm_reqs)
    assert warm.prefix["hits"] == 3 and warm.prefix["saved_steps"] > 0
    assert warm.steps < cold.steps


def test_deadline_eviction_mid_speculation(run):
    eng = run["teng"]
    keep = Request(prompt=[5, 9, 2], max_new_tokens=6, seed=77,
                   temperature=0.6)
    evicted = Request(prompt=[8, 1], max_new_tokens=12, deadline=4, seed=78,
                      temperature=0.3)
    plain = [dataclasses.replace(r, deadline=0) for r in (keep, evicted)]
    base, _ = _serve(eng, plain, at=[0, 0])
    rep, sched = _serve(eng, [keep, evicted], at=[0, 0], spec_draft="topk",
                        spec_k=4)
    k, ev = S.by_request(rep, [keep, evicted])
    bk, bev = S.by_request(base, plain)
    assert k.tokens == bk.tokens and k.error is None
    assert ev.reason == "deadline_evicted"
    assert 0 < len(ev.tokens) < evicted.max_new_tokens
    assert ev.tokens == bev.tokens[:len(ev.tokens)]
    assert sched.n_free == 3
    assert bool((sched.table.t_stream <= eng.max_len).all())
    assert bool((sched.table.budget >= 0).all())


def test_spec_walks_the_ladder_with_the_verifier(run):
    eng = run["teng"]
    long_req = Request(prompt=[3, 4], max_new_tokens=20, seed=501)
    shorts = _requests(1) + _requests(2)
    reqs = [long_req] + shorts
    rep, sched = _serve(eng, reqs, at=[0] * len(reqs),
                        cfg=ServingConfig(degrade_high=3, degrade_low=1,
                                          degrade_after=2, restore_after=4),
                        spec_draft="topk", spec_k=4)
    assert len(rep.completions) == len(reqs)
    assert rep.tier_transitions
    assert set(rep.spec_acceptance_by_tier) == {"mimps", "topk"}
    for acc in rep.spec_acceptance_by_tier.values():
        assert 0.0 < acc <= 1.0
    for c in rep.completions:
        assert np.all(np.isfinite(c.log_probs))


def test_nan_draft_falls_back_per_lane(run):
    eng = run["teng"]
    reqs = _requests()
    base, _ = _serve(eng, reqs, spec_draft="topk", spec_k=4)
    reqs2 = [dataclasses.replace(r, req_id=100_000 + i)
             for i, r in enumerate(reqs)]
    inj = NanLogitsFault([reqs2[1].req_id], steps=range(1, 20))
    rep, sched = _serve(eng, reqs2, spec_draft="topk", spec_k=4,
                        injector=inj)
    got, want = _tokens(rep, reqs2), _tokens(base, reqs)
    for i in (0, 2, 3):
        assert got[i] == want[i]
    assert len(got[1]) == reqs[1].max_new_tokens
    assert rep.draft_flagged > 0 and rep.health["flagged"] > 0
    for c in rep.completions:
        assert np.all(np.isfinite(c.log_probs))
        assert np.all(np.isfinite(c.log_zs))


def test_non_kv_caches_are_refused(run):
    cfg = dataclasses.replace(run["teng"].cfg, sliding_window=8)
    eng = Engine(Model(cfg), run["teng"].params, S.MAX_LEN, device="cpu",
                 index_assign=run["teng"].index.assign)
    for kw in (dict(spec_draft="topk", spec_k=2),
               dict(prefix_cache_blocks=4)):
        with pytest.raises(NotImplementedError, match="rewindable"):
            Scheduler(eng, 2, **kw)
    with pytest.raises(ValueError, match="no serving backend"):
        Scheduler(run["teng"], 2, spec_draft="nope", spec_k=2)


# -- the accepted-count algebra -------------------------------------------------

MAX_LEN, K = 24, 4


def _domain():
    """Every point of the JAX property test's domain: n_ok 1-4, t_stream
    0-24, t_replay 1-24, budget 1-8, active and draft_bad 0-1."""
    grid = np.array(list(itertools.product(
        range(1, 5), range(0, 25), range(1, 25), range(1, 9), (0, 1),
        (0, 1))), np.int32)
    return [grid[:, i] for i in range(6)]


def test_spec_accept_equals_jax_everywhere():
    n_ok, t_stream, t_replay, budget, active, bad = _domain()
    want = np.asarray(j_spec_accept(
        jnp.asarray(n_ok), jnp.asarray(t_stream), jnp.asarray(t_replay),
        jnp.asarray(budget), jnp.asarray(active.astype(bool)),
        jnp.asarray(bad.astype(bool)), MAX_LEN, K))
    t = [torch.from_numpy(x) for x in (n_ok, t_stream, t_replay, budget)]
    got = spec_accept(*t, torch.from_numpy(active.astype(bool)),
                      torch.from_numpy(bad.astype(bool)), MAX_LEN, K)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_spec_accept_invariants_everywhere():
    n_ok, t_stream, t_replay, budget, active, bad = _domain()
    a = spec_accept(*(torch.from_numpy(x) for x in
                      (n_ok, t_stream, t_replay, budget)),
                    torch.from_numpy(active.astype(bool)),
                    torch.from_numpy(bad.astype(bool)), MAX_LEN, K).numpy()
    off = active == 0
    assert (a[off] == 0).all()
    on = ~off
    a, n_ok, t_stream, t_replay, budget, bad = (
        x[on] for x in (a, n_ok, t_stream, t_replay, budget, bad))
    assert ((1 <= a) & (a <= K)).all()
    assert ((a <= n_ok) | (bad == 1) | (a == 1)).all()
    r = np.clip(t_replay - 1 - t_stream, 0, K)
    assert (np.maximum(0, a - r) <= budget).all()
    assert ((t_stream + a <= MAX_LEN) |
            ((t_stream >= MAX_LEN) & (a == 1))).all()
    assert (a[bad == 1] == 1).all()
