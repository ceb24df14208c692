"""The port's slot scheduler against the JAX package's (f32, CPU): the JAX
serving tests' engine (``_torch_serving``), seven requests of mixed
lengths, budgets and temperatures through three slots, staggered, with the
JAX scheduler's tail draws and each request's Gumbel noise injected. Greedy
and sampled tokens equal JAX's, log Ẑ within 1e-5 relative, log_prob
within 1e-4; the report and the device metric state equal JAX's.

Then the port's own "slot table is invisible" contract, as the JAX suite
pins it: a request in a busy, mixed table gives the tokens it gives alone
through ``generate(..., generator=)``, whatever the admission order; slots
recycle; callbacks fire in order; the capacity guards refuse on the host;
every table tensor keeps its storage (what a captured step reads). And the
two additions to existing port functions: ``generate(generator=)`` and
``shadow_exact_log_z(rows=)``."""
import dataclasses
import types
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serving as S
from repro.serve import Scheduler as JScheduler
from repro.serve import Server as JServer
from repro.serve import trace_arrivals as j_trace_arrivals
from repro.serve.scheduler import sample_slots as j_sample_slots
from repro_torch.core.backends import shadow_exact_log_z
from repro_torch.core.decode import DecodeOut
from repro_torch.serve import (Request, Scheduler, Server, generate,
                               poisson_arrivals, trace_arrivals)
from repro_torch.serve.scheduler import sample_slots

AT = [0, 0, 1, 3, 4, 4, 9]


@pytest.fixture(scope="module")
def run():
    jeng, teng = S.engines()
    pc = teng.cfg.partition
    pairs = S.mixed_pairs(pc.sample_k, n=len(AT))
    key = jax.random.PRNGKey(3)
    jsched = JScheduler(jeng, n_slots=3, key=key)
    jrep = JServer(jsched).run(
        arrivals=j_trace_arrivals([p[0] for p in pairs], AT))
    tsched = Scheduler(teng, 3, tail_source=S.tail_source(key, pc.l,
                                                          S.VOCAB))
    trep = Server(tsched).run(
        arrivals=trace_arrivals([p[1] for p in pairs], AT))
    return dict(teng=teng, pairs=pairs, jrep=jrep, trep=trep,
                jm=jsched.harvest_metrics(), tm=tsched.harvest_metrics(),
                tsched=tsched)


def test_tokens_and_log_z_equal_jax(run):
    jc = S.by_request(run["jrep"], [p[0] for p in run["pairs"]])
    tc = S.by_request(run["trep"], [p[1] for p in run["pairs"]])
    temps = set()
    for a, b in zip(jc, tc):
        assert b.error is None and len(b.tokens) == b.request.max_new_tokens
        assert b.tokens == a.tokens
        np.testing.assert_allclose(b.log_zs, a.log_zs, rtol=1e-5)
        np.testing.assert_allclose(b.log_probs, a.log_probs, atol=1e-4)
        temps.add(b.request.temperature)
    assert temps == {0.0, 0.5, 0.9}


def test_report_equals_jax(run):
    j, t = run["jrep"], run["trep"]
    for name in ("steps", "peak_concurrency", "occupancy_mean",
                 "occupancy_steady", "dedup_ratio_mean", "dedup_by_fill",
                 "queue_wait_steps_mean", "rejects_by_reason",
                 "tokens_by_tier", "health", "queue_depth_peak"):
        assert getattr(t, name) == getattr(j, name), name
    assert run["tsched"].n_free == 3


def test_metric_state_equals_jax(run):
    j, t = run["jm"], run["tm"]
    for name in ("steps", "tokens_total", "tokens_by_tier", "occupancy_mean",
                 "fill_mean", "queue_depth_mean", "queue_hist", "occ_hist",
                 "health_flagged", "health_by_cause", "spec_proposed",
                 "shadow_by_tier"):
        assert t[name] == j[name], name
    # the step-latency histogram counts every step after the first
    assert sum(sum(r) for r in t["latency_hist_by_tier"].values()) == \
        t["steps"] - 1
    assert int(run["tsched"].table.step_idx) == run["tsched"].steps_done


@pytest.mark.parametrize("restrict", [False, True])
def test_sample_slots_equals_jax(restrict):
    rng = np.random.default_rng(7)
    s, kc = 6, 8
    score = np.sort(rng.standard_normal((s, kc)).astype(np.float32))[:, ::-1]
    ids = rng.integers(0, 1000, (s, kc)).astype(np.int32)
    temp = np.array([0.0, 0.5, 0.9, 1.7, 0.0, 3.0], np.float32)
    sk = np.array([8, 3, 1, 5, 2, 8], np.int32) if restrict else None
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(s)])
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (1, kc))[0])(
        keys))
    Out = namedtuple("Out", "top_score top_id")
    jt, js = j_sample_slots(Out(jnp.asarray(score), jnp.asarray(ids)), keys,
                            jnp.asarray(temp),
                            None if sk is None else jnp.asarray(sk))
    tt, ts = sample_slots(
        Out(torch.from_numpy(score.copy()), torch.from_numpy(ids)),
        torch.from_numpy(g), torch.from_numpy(temp),
        None if sk is None else torch.from_numpy(sk))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# -- the port's own contract ---------------------------------------------------


def _requests(n=3, base=0):
    rng = np.random.default_rng(200 + base)
    return [Request(prompt=rng.integers(0, S.VOCAB, 2 + (5 * i) % 6),
                    max_new_tokens=3 + (2 * i) % 5, seed=30 + base + i,
                    temperature=(0.0, 0.9, 0.5)[i % 3]) for i in range(n)]


def _solo(eng, req):
    toks = generate(eng, torch.as_tensor(req.prompt[None]),
                    req.max_new_tokens, temperature=req.temperature,
                    generator=torch.Generator().manual_seed(req.seed))
    return toks[0].tolist()


@pytest.mark.parametrize("at", [[0, 0, 0], [0, 2, 5], [4, 1, 0]],
                         ids=["together", "staggered", "reversed"])
def test_table_is_invisible_to_each_request(run, at):
    eng = run["teng"]
    reqs = _requests()
    rep = Server(Scheduler(eng, 4, seed=5)).run(
        arrivals=trace_arrivals(reqs, at))
    for r, c in zip(reqs, S.by_request(rep, reqs)):
        assert c.tokens == _solo(eng, r)
        assert len(c.log_probs) == len(c.tokens) == len(c.log_zs)
        assert np.all(np.isfinite(c.log_probs))
        assert np.all(np.asarray(c.log_probs) <= 1e-4)


def test_more_requests_than_slots_all_complete(run):
    eng = run["teng"]
    reqs = [Request(prompt=[(11 * i + 3) % S.VOCAB, i], max_new_tokens=2 +
                    i % 3, seed=50 + i, temperature=0.0 if i % 2 else 0.7)
            for i in range(7)]
    sched = Scheduler(eng, 2, seed=1)
    server = Server(sched)
    for r in reqs:
        server.submit(r)
    rep = server.run()
    assert len(rep.completions) == 7
    assert sched.n_free == 2
    assert rep.occupancy_steady > 0.5
    assert rep.queue_wait_steps_mean > 0
    for r, c in zip(reqs, S.by_request(rep, reqs)):
        assert c.tokens == _solo(eng, r)


def test_poisson_traffic_on_a_warm_table(run):
    eng = run["teng"]
    sched = Scheduler(eng, 3, seed=1)
    Server(sched).run(arrivals=trace_arrivals(_requests(1), [0]))
    reqs = _requests(5, base=3) + [
        Request(prompt=[3], max_new_tokens=7, seed=2, temperature=2.0),
        Request(prompt=list(range(8)), max_new_tokens=1, seed=3)]
    rep = Server(sched).run(arrivals=poisson_arrivals(reqs, rate=1.5,
                                                      seed=1))
    assert len(rep.completions) == len(reqs)
    for r, c in zip(reqs, S.by_request(rep, reqs)):
        assert c.tokens == _solo(eng, r)


def test_streaming_callbacks_fire_in_order(run):
    seen, done = [], []
    req = Request(prompt=[1, 2, 3], max_new_tokens=4, seed=5,
                  on_token=lambda r, tok, t: seen.append(tok),
                  on_complete=lambda r, comp: done.append(comp))
    server = Server(Scheduler(run["teng"], 2))
    server.submit(req)
    server.run()
    assert len(done) == 1 and seen == done[0].tokens and len(seen) == 4


def test_capacity_guards_refuse_on_the_host(run):
    eng = run["teng"]
    sched = Scheduler(eng, 1, prompt_cap=12)
    with pytest.raises(ValueError, match="cache positions"):
        sched.admit(Request(prompt=list(range(10)), max_new_tokens=24))
    with pytest.raises(ValueError, match="prompt_cap"):
        sched.admit(Request(prompt=list(range(13)), max_new_tokens=1))
    with pytest.raises(ValueError, match="non-empty"):
        sched.admit(Request(prompt=[], max_new_tokens=1))
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.admit(Request(prompt=[1], max_new_tokens=0))
    with pytest.raises(ValueError, match="deadline"):
        sched.admit(Request(prompt=[1], max_new_tokens=1), deadline_steps=0)
    sched.admit(Request(prompt=[1], max_new_tokens=1))
    with pytest.raises(RuntimeError, match="no free slot"):
        sched.admit(Request(prompt=[1], max_new_tokens=1))
    with pytest.raises(ValueError, match="Request.gumbel"):
        Scheduler(eng, 1).admit(Request(prompt=[1, 2], max_new_tokens=2,
                                        gumbel=np.zeros((3, 2))))


def test_server_rejects_bad_request_without_killing_the_run(run):
    eng = run["teng"]
    good = Request(prompt=[4, 2], max_new_tokens=3, seed=11)
    bad = Request(prompt=list(range(10)), max_new_tokens=eng.max_len)
    server = Server(Scheduler(eng, 2))
    server.submit(good)
    server.submit(bad)
    rep = server.run()
    g, b = S.by_request(rep, [good, bad])
    assert g.tokens == _solo(eng, good) and g.error is None
    assert b.tokens == [] and "cache positions" in b.error
    assert rep.rejects_by_reason == {"admit_rejected": 1}


def test_audio_heads_and_meshes_are_refused():
    eng = types.SimpleNamespace(cfg=types.SimpleNamespace(n_codebooks=4))
    with pytest.raises(NotImplementedError, match="generate"):
        Scheduler(eng, 2)
    # a mesh's data replicas must split the lanes evenly (checked before
    # any device work, so a stand-in mesh of data 2 suffices)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: (2, 1)[i],
                                 get_local_rank=lambda name: 0)
    eng = types.SimpleNamespace(
        cfg=types.SimpleNamespace(n_codebooks=0), mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        Scheduler(eng, 3)


def test_table_keeps_its_storage(run):
    """Admission, steps, recycling, drain, a tier switch, metric resets and
    the prefix pool's loads write the table in place: a captured step
    keeps reading the right memory."""
    sched = Scheduler(run["teng"], 2, prefix_cache_blocks=8,
                      prefix_block_tokens=2)
    ptrs = [(n, t.data_ptr()) for n, t in sched._storage()]
    reqs = [Request(prompt=[5, 6, 7, 8, 9], max_new_tokens=3, seed=i,
                    temperature=0.5 * i) for i in range(3)]
    Server(sched).run(arrivals=trace_arrivals(reqs, [0, 1, 6]))
    assert sched.prefix.hits >= 1
    sched.set_tier("topk")
    sched.admit(reqs[0])
    sched.step()
    sched.drain()
    sched.reset_metrics()
    assert [(n, t.data_ptr()) for n, t in sched._storage()] == ptrs
    assert not bool(sched.table.active.any()) and sched.n_free == 2


# -- generate(generator=) and shadow_exact_log_z(rows=) ------------------------


def test_generate_generator_draws_the_noise(run):
    """With ``generator=`` the noise comes from it, one (B, sample_k) call
    a step, and the engine's generator draws only the tails; without it
    the engine's generator draws both, as before."""
    eng = run["teng"]
    pc = eng.cfg.partition
    prompt = torch.tensor([[3, 9, 27]])
    eng.generator.manual_seed(4)
    gen = torch.Generator().manual_seed(8)
    a = generate(eng, prompt, 4, temperature=0.9, generator=gen)
    after_engine = eng.generator.get_state()
    eng.generator.manual_seed(4)
    for _ in range(6):
        eng.backend.draw_tail(eng.state, pc, eng.generator)
    assert torch.equal(after_engine, eng.generator.get_state())
    ref = torch.Generator().manual_seed(8)
    for _ in range(6):
        torch.empty((1, pc.sample_k)).exponential_(generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())
    eng.generator.manual_seed(4)
    b = generate(eng, prompt, 4, temperature=0.9,
                 generator=torch.Generator().manual_seed(8), host_loop=True)
    assert torch.equal(a, b)
    # the default: the engine's generator draws tails and noise in turn
    eng.generator.manual_seed(4)
    c = generate(eng, prompt, 4, temperature=0.9)
    eng.generator.manual_seed(4)
    for _ in range(6):
        eng.backend.draw_tail(eng.state, pc, eng.generator)
        torch.empty((1, pc.sample_k)).exponential_(generator=eng.generator)
    state = eng.generator.get_state()
    eng.generator.manual_seed(4)
    d = generate(eng, prompt, 4, temperature=0.9, host_loop=True)
    assert torch.equal(c, d)
    assert torch.equal(eng.generator.get_state(), state)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_shadow_rows_gate_the_exact_pass(run, use_kernel):
    eng = run["teng"]
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, eng.cfg.d_model)).astype(np.float32))
    full = shadow_exact_log_z(eng.state, h, k=8, use_kernel=use_kernel)
    exact = _exact_log_z(eng, h, use_kernel)
    assert torch.equal(full, exact)
    every = shadow_exact_log_z(eng.state, h, k=8, use_kernel=use_kernel,
                               rows=torch.ones(5, dtype=torch.int32))
    assert torch.equal(every, full)
    rows = torch.tensor([1, 0, 0, 1, 0], dtype=torch.int32)
    some = shadow_exact_log_z(eng.state, h, k=8, use_kernel=use_kernel,
                              rows=rows)
    on = rows.bool()
    assert torch.equal(some[on], full[on])
    assert bool(torch.isneginf(some[~on]).all())


def _exact_log_z(eng, h, use_kernel):
    from repro_torch.core.backends import get_backend
    out = get_backend("exact").decode(eng.state, h, eng.cfg.partition, k=8,
                                      use_kernel=use_kernel)
    assert isinstance(out, DecodeOut)
    return out.log_z


def test_scheduler_shadow_oracle_on_its_cadence(run):
    """The shadow cadence is device data: off it, nothing is sampled; on
    it, every active lane of the sampled steps; the tokens do not move."""
    eng = run["teng"]
    reqs = _requests()
    base = Server(Scheduler(eng, 3, seed=5)).run(
        arrivals=trace_arrivals(reqs, [0, 1, 2]))
    sched = Scheduler(eng, 3, seed=5)
    sched.shadow_every = 2
    reqs2 = [dataclasses.replace(r) for r in reqs]
    rep = Server(sched).run(arrivals=trace_arrivals(reqs2, [0, 1, 2]))
    assert [c.tokens for c in S.by_request(rep, reqs2)] == \
        [c.tokens for c in S.by_request(base, reqs)]
    sh = sched.harvest_metrics()["shadow_by_tier"]["mimps"]
    assert sh["count"] > 0 and 0.0 < sh["rel_err_mean"] < 0.5
