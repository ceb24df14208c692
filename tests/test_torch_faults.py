"""The port's fault injectors against the JAX package's (f32, CPU): the JAX
serving tests' engine (``_torch_serving``) serving three requests with the
JAX scheduler's draws injected, fault-free, with NaN logits injected in one
request's lane, and with a permuted index installed at step 3 under a
digest check every step. Every request's tokens equal JAX's in each run,
the guard's counters equal JAX's, and the restore count too.

Then the containment contract, mirroring the JAX suite: an injected lane
(NaN or Inf) leaves its neighbours bit-identical to the fault-free run and
every emitted value finite; a corrupted index (zero, permute, drift) is
caught before a step reads it and every request comes out bit-identical;
an admission fault rejects cleanly; a step fault is retried without
advancing the clock; ``CorruptIndexFault`` corrupts a device copy and
leaves the engine's tensors alone."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_serving as S
from repro.configs import ServingConfig as JServingConfig
from repro.serve import NanLogitsFault as JNanLogitsFault
from repro.serve import CorruptIndexFault as JCorruptIndexFault
from repro.serve import Scheduler as JScheduler
from repro.serve import Server as JServer
from repro_torch.configs import ServingConfig
from repro_torch.serve import (AdmissionFault, CompositeFault,
                               CorruptIndexFault, FaultError, InfLogitsFault,
                               NanLogitsFault, Request, Scheduler, Server,
                               StepFault)


def _serve_pairs(jeng, teng, pairs, key, j_inj=None, t_inj=None, cfg=None):
    pc = teng.cfg.partition
    jserver = JServer(JScheduler(jeng, n_slots=3, key=key, injector=j_inj),
                      None if cfg is None else JServingConfig(**cfg))
    tserver = Server(Scheduler(teng, 3, injector=t_inj,
                               tail_source=S.tail_source(key, pc.l,
                                                         S.VOCAB)),
                     None if cfg is None else ServingConfig(**cfg))
    for jr, tr in pairs:
        jserver.submit(jr)
        tserver.submit(tr)
    return jserver.run(), tserver.run()


@pytest.fixture(scope="module")
def runs():
    jeng, teng = S.engines()
    kc = teng.cfg.partition.sample_k
    key = jax.random.PRNGKey(6)
    out = {"teng": teng}

    def fresh():
        return S.mixed_pairs(kc, n=3, base=20)

    pairs = fresh()
    out["clean"] = (pairs,) + _serve_pairs(jeng, teng, pairs, key)
    pairs = fresh()
    out["nan"] = (pairs,) + _serve_pairs(
        jeng, teng, pairs, key,
        JNanLogitsFault([pairs[1][0].req_id], steps=range(1, 20)),
        NanLogitsFault([pairs[1][1].req_id], steps=range(1, 20)))
    pairs = fresh()
    out["corrupt"] = (pairs,) + _serve_pairs(
        jeng, teng, pairs, key,
        JCorruptIndexFault(at_step=3, mode="permute", n_blocks=2, seed=7),
        CorruptIndexFault(at_step=3, mode="permute", n_blocks=2, seed=7),
        cfg=dict(verify_index_every=1))
    return out


@pytest.mark.parametrize("name", ["clean", "nan", "corrupt"])
def test_faulted_runs_equal_jax(runs, name):
    pairs, jrep, trep = runs[name]
    jc = S.by_request(jrep, [p[0] for p in pairs])
    tc = S.by_request(trep, [p[1] for p in pairs])
    for a, b in zip(jc, tc):
        assert b.tokens == a.tokens
        np.testing.assert_allclose(b.log_zs, a.log_zs, rtol=1e-5)
        assert np.all(np.isfinite(b.log_probs))
    assert trep.health == jrep.health
    assert trep.index_restores == jrep.index_restores
    assert trep.steps == jrep.steps


def test_jax_runs_contain_their_faults(runs):
    clean = [c.tokens for c in S.by_request(
        runs["clean"][2], [p[1] for p in runs["clean"][0]])]
    nan = [c.tokens for c in S.by_request(
        runs["nan"][2], [p[1] for p in runs["nan"][0]])]
    corrupt = [c.tokens for c in S.by_request(
        runs["corrupt"][2], [p[1] for p in runs["corrupt"][0]])]
    assert nan[0] == clean[0] and nan[2] == clean[2]
    assert runs["nan"][2].health["nonfinite_z"] > 0
    assert corrupt == clean and runs["corrupt"][2].index_restores == 1


def _requests(n=3, budget=4, base=0):
    rng = np.random.default_rng(400 + base)
    return [Request(prompt=rng.integers(0, S.VOCAB, 2 + i % 3),
                    max_new_tokens=budget, seed=90 + base + i,
                    temperature=0.0 if i % 2 else 0.7) for i in range(n)]


def _run(eng, reqs, n_slots=3, cfg=None, **kw):
    sched = Scheduler(eng, n_slots, seed=3, **kw)
    server = Server(sched, cfg)
    for r in reqs:
        server.submit(r)
    return server.run(), sched


def _tokens(rep):
    return {c.request.req_id: c.tokens for c in rep.completions}


@pytest.mark.parametrize("fault_cls", [NanLogitsFault, InfLogitsFault])
def test_injected_lane_is_contained(runs, fault_cls):
    eng = runs["teng"]
    reqs = _requests()
    base = _tokens(_run(eng, reqs)[0])
    victim = reqs[1]
    rep, _ = _run(eng, reqs, injector=fault_cls([victim.req_id],
                                                steps=range(1, 20)))
    got = _tokens(rep)
    for r in reqs:
        if r is not victim:
            assert got[r.req_id] == base[r.req_id]
    assert len(got[victim.req_id]) == victim.max_new_tokens
    for c in rep.completions:
        assert np.all(np.isfinite(c.log_probs))
        assert np.all(np.isfinite(c.log_zs))
    assert rep.health["flagged"] > 0 and rep.health["nonfinite_z"] > 0


@pytest.mark.parametrize("mode", ["zero", "permute", "drift"])
def test_corrupt_index_is_restored_before_a_step_reads_it(runs, mode):
    eng = runs["teng"]
    reqs = _requests(budget=5)
    base = _tokens(_run(eng, reqs)[0])
    clean = eng.index.v_blocks.clone()
    inj = CorruptIndexFault(at_step=3, mode=mode, n_blocks=2, seed=7)
    rep, _ = _run(eng, reqs, cfg=ServingConfig(verify_index_every=1),
                  injector=inj)
    assert inj.fired and rep.index_restores == 1
    assert _tokens(rep) == base
    assert torch.equal(eng.index.v_blocks, clean)


def test_corrupt_index_corrupts_a_copy(runs):
    eng = runs["teng"]
    sched = Scheduler(eng, 1)
    before = eng.state
    vb = before.index.v_blocks.clone()
    CorruptIndexFault(at_step=0, mode="drift", seed=7).on_step_begin(sched)
    assert eng.state is not before
    assert torch.equal(before.index.v_blocks, vb)      # the source is intact
    drift = eng.state.index.v_blocks - vb
    noise = np.random.default_rng(7).standard_normal(vb.shape)
    np.testing.assert_allclose(drift.numpy(), 0.05 * noise, atol=1e-6)
    assert eng.verify_and_restore() and torch.equal(eng.index.v_blocks, vb)
    eng._install_state(dataclasses.replace(
        eng.state, index=eng.index._replace(v_blocks=vb[:0])))
    eng.restore_index()
    eng.tier_state("exact")
    with pytest.raises(FaultError, match="index-backed"):
        sched.tier = "exact"
        CorruptIndexFault(at_step=0).on_step_begin(sched)


def test_admission_fault_rejects_cleanly(runs):
    eng = runs["teng"]
    reqs = _requests()
    base = _tokens(_run(eng, reqs)[0])
    rep, _ = _run(eng, reqs, injector=AdmissionFault([reqs[0].req_id]))
    by_id = {c.request.req_id: c for c in rep.completions}
    assert by_id[reqs[0].req_id].reason == "fault_injected"
    assert by_id[reqs[0].req_id].tokens == []
    assert rep.rejects_by_reason == {"fault_injected": 1}
    for r in reqs[1:]:
        assert by_id[r.req_id].tokens == base[r.req_id]


def test_step_fault_retried_without_advancing_the_clock(runs):
    eng = runs["teng"]
    reqs = _requests()
    base, _ = _run(eng, reqs)
    rep, sched = _run(eng, reqs, injector=CompositeFault(
        [StepFault([1, 3, 4]), NanLogitsFault([], steps=[2])]))
    assert rep.step_faults == 3
    assert rep.steps == base.steps + 3
    assert sched.steps_done == base.steps
    assert _tokens(rep) == _tokens(base)
