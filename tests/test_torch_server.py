"""The port's traffic server against the JAX package's (f32, CPU): the JAX
serving tests' engine (``_torch_serving``) under overload, ten requests of
mixed budgets and temperatures on Poisson arrivals into two slots, with a
bounded queue, a default deadline and the degradation ladder on, the JAX
scheduler's draws injected. On the virtual step clock the tier
transitions, the shed reasons of every request, the queue waits, the
tokens by tier and every served token equal JAX's.

The arrival processes, the default ladders and the bounded-look-ahead
admission (on a stand-in scheduler, as the JAX suite drives it) are held
to JAX's too; then the overload policy's own contract: the queue bound
sheds at the door, ``max_steps`` flushes stranded work, an expired queue
entry is shed with its reason, a lane evicted mid-decode leaves its
neighbour alone, the ladder walks down and back without flapping, and
nothing degrades by default."""
import jax
import numpy as np
import pytest

import _torch_serving as S
from repro.configs import ServingConfig as JServingConfig
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import Server as JServer
from repro.serve import poisson_arrivals as j_poisson_arrivals
from repro.serve import server as j_server
from repro_torch.configs import ServingConfig
from repro_torch.serve import (Request, Scheduler, Server, default_ladder,
                               poisson_arrivals, trace_arrivals)
from repro_torch.serve import server as t_server

OVERLOAD = dict(max_queue=3, default_deadline=14, degrade_high=2,
                degrade_low=0, degrade_after=2, restore_after=3)


@pytest.fixture(scope="module")
def run():
    jeng, teng = S.engines()
    pc = teng.cfg.partition
    rng = np.random.default_rng(9)
    pairs = [S.pair(rng.integers(0, S.VOCAB, 2 + i % 4), 2 + (3 * i) % 5,
                    600 + i, pc.sample_k, temperature=(0.0, 0.8)[i % 2])
             for i in range(10)]
    key = jax.random.PRNGKey(8)
    jrep = JServer(JScheduler(jeng, n_slots=2, key=key),
                   JServingConfig(**OVERLOAD)).run(arrivals=j_poisson_arrivals(
                       [p[0] for p in pairs], rate=1.0, seed=0))
    tsched = Scheduler(teng, 2, tail_source=S.tail_source(key, pc.l,
                                                          S.VOCAB))
    trep = Server(tsched, ServingConfig(**OVERLOAD)).run(
        arrivals=poisson_arrivals([p[1] for p in pairs], rate=1.0, seed=0))
    return dict(teng=teng, pairs=pairs, jrep=jrep, trep=trep, tsched=tsched)


def test_overload_policy_equals_jax(run):
    j, t = run["jrep"], run["trep"]
    assert t.tier_transitions and set(t.rejects_by_reason) >= {"queue_full"}
    for name in ("tier_transitions", "rejects_by_reason", "shed_rate",
                 "queue_wait_steps_mean", "queue_depth_peak", "steps",
                 "tokens_by_tier", "degraded_token_frac", "peak_concurrency",
                 "occupancy_mean", "occupancy_steady"):
        assert getattr(t, name) == getattr(j, name), name
    jc = S.by_request(j, [p[0] for p in run["pairs"]])
    tc = S.by_request(t, [p[1] for p in run["pairs"]])
    for a, b in zip(jc, tc):
        assert (b.reason, b.tokens, b.tiers) == (a.reason, a.tokens, a.tiers)
        np.testing.assert_allclose(b.log_zs, a.log_zs, rtol=1e-5)
    assert len(t.completions) == len(run["pairs"])
    assert run["tsched"].n_free == 2 and run["tsched"].captures == 0


def test_summary_reports_the_overload(run):
    text = run["trep"].summary()
    assert "tok/s goodput" in text and "shed" in text and "tier moves" in text


@pytest.mark.parametrize("rate,seed", [(0.25, 0), (1.5, 3)])
def test_arrivals_equal_jax(rate, seed):
    reqs = [Request(prompt=[1], max_new_tokens=1) for _ in range(20)]
    jreqs = [JRequest(prompt=[1], max_new_tokens=1) for _ in range(20)]
    got = [a.at_step for a in poisson_arrivals(reqs, rate, seed)]
    want = [a.at_step for a in j_poisson_arrivals(jreqs, rate, seed)]
    assert got == want
    tr = trace_arrivals(reqs[:3], [5, 1, 3])
    assert [a.at_step for a in tr] == [1.0, 3.0, 5.0]
    assert [a.request for a in tr] == [reqs[1], reqs[2], reqs[0]]


def test_default_ladders_equal_jax():
    assert t_server._DEFAULT_LADDERS == j_server._DEFAULT_LADDERS
    for m in t_server._DEFAULT_LADDERS:
        assert default_ladder(m) == j_server.default_ladder(m)


def test_obs_and_unknown_tiers_are_refused(run):
    sched = Scheduler(run["teng"], 1)
    with pytest.raises(NotImplementedError, match="Observability"):
        Server(sched, obs=object())
    with pytest.raises(ValueError, match="unknown degradation tier"):
        Server(sched, ServingConfig(degrade_ladder=("mimps", "nope")))


# -- admission: strict FIFO; the mesh's look-ahead is refused -----------------


@pytest.mark.parametrize("cfg", [
    dict(admit_window=2, admit_hold=8),
    dict(admit_window=1, admit_hold=3),
    dict(admit_window=1, admit_hold=8, default_deadline=5)],
    ids=["window", "hold-bound", "deadline-near"])
def test_lookahead_admission_is_refused(run, cfg):
    sched = Scheduler(run["teng"], 1)
    with pytest.raises(NotImplementedError, match="admit_window"):
        Server(sched, ServingConfig(**cfg))


def test_fifo_admission_fills_the_lowest_free_lanes(run):
    sched = Scheduler(run["teng"], 3)
    srv = Server(sched, ServingConfig())
    reqs = [Request(prompt=[1, 2, 3], max_new_tokens=2) for _ in range(5)]
    for r in reqs:
        srv.submit(r)
    srv._admit_ready()
    assert [sched._slot_req[i].req_id for i in range(3)] == \
        [r.req_id for r in reqs[:3]]
    assert [r.req_id for r in srv.queue] == [r.req_id for r in reqs[3:]]


# -- the overload policy's own contract ----------------------------------------


def _requests(n, budget, base=0):
    rng = np.random.default_rng(500 + base)
    return [Request(prompt=rng.integers(0, S.VOCAB, 2 + i % 3),
                    max_new_tokens=budget, seed=40 + base + i,
                    temperature=0.0 if i % 2 else 0.7) for i in range(n)]


def _run(eng, reqs, n_slots, cfg=None, **run_kw):
    sched = Scheduler(eng, n_slots, seed=3)
    server = Server(sched, cfg)
    for r in reqs:
        server.submit(r)
    return server.run(**run_kw), sched


def test_bounded_queue_sheds_at_the_door(run):
    rep, _ = _run(run["teng"], _requests(6, 3), 1,
                  ServingConfig(max_queue=2))
    assert len(rep.completions) == 6
    assert rep.rejects_by_reason == {"queue_full": 4}
    assert rep.queue_depth_peak <= 2 and 0 < rep.shed_rate < 1
    assert len([c for c in rep.completions if c.error is None]) == 2


def test_max_steps_flushes_stranded_work(run):
    rep, sched = _run(run["teng"], _requests(4, 6), 2, max_steps=3)
    assert len(rep.completions) == 4
    stopped = [c for c in rep.completions if c.reason == "server_stopped"]
    assert stopped and rep.rejects_by_reason["server_stopped"] == \
        len(stopped)
    assert sched.n_in_flight == 0 and sched.n_free == 2
    assert not bool(sched.table.active.any())


def test_queue_expiry_sheds_with_reason(run):
    rep, _ = _run(run["teng"], _requests(4, 6), 1,
                  ServingConfig(default_deadline=10))
    shed = [c for c in rep.completions if c.reason == "deadline_queue"]
    done = [c for c in rep.completions if c.error is None]
    assert len(rep.completions) == 4 and shed and done
    assert all(c.tokens == [] for c in shed)
    assert rep.queue_wait_steps_mean > 0


def test_mid_decode_eviction_leaves_the_neighbour_alone(run):
    eng = run["teng"]
    keep = Request(prompt=[5, 9, 2], max_new_tokens=6, seed=77,
                   temperature=0.6)
    evicted = Request(prompt=[8, 1], max_new_tokens=12, deadline=6, seed=78,
                      temperature=0.3)
    alone = [_run(eng, [Request(prompt=r.prompt, max_new_tokens=r.
                                max_new_tokens, seed=r.seed,
                                temperature=r.temperature)], 2)[0]
             for r in (keep, evicted)]
    rep, _ = _run(eng, [keep, evicted], 2)
    k, ev = S.by_request(rep, [keep, evicted])
    assert k.tokens == alone[0].completions[0].tokens and k.error is None
    assert ev.reason == "deadline_evicted"
    assert 0 < len(ev.tokens) < 12
    assert ev.tokens == alone[1].completions[0].tokens[:len(ev.tokens)]
    assert rep.rejects_by_reason == {"deadline_evicted": 1}


def test_ladder_walks_down_and_back_without_flapping(run):
    long_req = Request(prompt=[3, 4], max_new_tokens=20, seed=501)
    shorts = _requests(6, 2, base=1)
    rep, sched = _run(run["teng"], [long_req] + shorts, 2, ServingConfig(
        degrade_high=3, degrade_low=1, degrade_after=2, restore_after=4))
    assert len(rep.completions) == 7 and rep.tier_transitions
    ladder = ("mimps", "topk")
    ix = [ladder.index(t) for _, t in rep.tier_transitions]
    went_up = False
    for prev, cur in zip([0] + ix, ix):
        if cur < prev:
            went_up = True
        else:
            assert not went_up, rep.tier_transitions
    assert rep.tokens_by_tier.get("topk", 0) > 0 and \
        rep.degraded_token_frac > 0
    assert any("topk" in c.tiers for c in rep.completions if c.error is None)


def test_nothing_degrades_by_default(run):
    rep, _ = _run(run["teng"], _requests(5, 2), 1)
    assert rep.tier_transitions == [] and rep.degraded_token_frac == 0.0
    assert set(rep.tokens_by_tier) == {"mimps"}
