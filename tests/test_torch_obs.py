"""The port's observability layer (``repro_torch.obs``: ``TraceWriter``,
``MetricsRegistry``, ``Observability`` and the hooks in ``Server``,
``Engine`` and ``Scheduler``) against the JAX package's ``repro.obs``, on
the MoE serving engine of ``_torch_serving`` at
``reduced_config("deepseek-moe-16b")`` (f32, CPU, the JAX scheduler's draws
injected).

Held here: with observability on, the port's tokens equal the JAX
server's with its observability on, and are bit-identical to the port's
own run with it off; the harvested counters equal JAX's and reconcile
with the report; the trace parses line by line, its request spans number
the completions, and the JAX package's ``obs_report`` accepts the port's
trace and snapshot (exit 0) and refuses a tampered snapshot (exit 3); the
exact tier's shadow rel err is identically 0; the engine's swap and
restore are traced as instants; the registry's Prometheus text and its
HTTP exposition on an ephemeral port; ``TraceWriter`` counts and
flushes."""
import dataclasses
import json
import urllib.request

import jax
import numpy as np
import pytest

import _torch_serving as S
from repro.launch import obs_report
from repro.obs import Observability as JObservability
from repro.obs import ObsConfig as JObsConfig
from repro.serve import Scheduler as JScheduler
from repro.serve import Server as JServer
from repro.serve import trace_arrivals as j_trace_arrivals
from repro_torch.models import Model
from repro_torch.obs import (MetricsRegistry, Observability, ObsConfig,
                             TraceWriter)
from repro_torch.serve import Engine, Scheduler, Server, trace_arrivals

ARCH = "deepseek-moe-16b"
AT = [0, 0, 1, 3, 4]


def _obs_cfg(path, name, cls=ObsConfig, **kw):
    kw.setdefault("harvest_every", 2)
    kw.setdefault("shadow_every", 2)
    kw.setdefault("snapshot_every", 1)
    return cls(trace_path=str(path / f"{name}.jsonl"),
               snapshot_path=str(path / f"{name}.json"), **kw)


def _events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _tokens(rep, reqs):
    return [c.tokens for c in S.by_request(rep, reqs)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs")
    jeng, teng = S.engines(arch=ARCH)
    pc = teng.cfg.partition
    key = jax.random.PRNGKey(3)
    pairs = S.mixed_pairs(pc.sample_k, n=len(AT), base=40)
    jobs = JObservability(_obs_cfg(tmp, "jax", JObsConfig))
    jrep = JServer(JScheduler(jeng, n_slots=3, key=key), obs=jobs).run(
        arrivals=j_trace_arrivals([p[0] for p in pairs], AT))
    jobs.close()

    def port_run(obs):
        reqs = [p[1] for p in pairs]
        sched = Scheduler(teng, 3, tail_source=S.tail_source(key, pc.l,
                                                             S.VOCAB))
        rep = Server(sched, obs=obs).run(arrivals=trace_arrivals(reqs, AT))
        return rep, reqs, sched

    off, off_reqs, _ = port_run(None)
    obs = Observability(_obs_cfg(tmp, "port"))
    on, on_reqs, sched = port_run(obs)
    harvest = dict(obs.last_harvest)
    obs.close()
    return dict(tmp=tmp, teng=teng, jrep=jrep, jobs=jobs, pairs=pairs,
                off=_tokens(off, off_reqs), on=on, on_reqs=on_reqs,
                obs=obs, harvest=harvest, sched=sched)


def test_obs_on_tokens_equal_obs_off_and_jax(served):
    on = _tokens(served["on"], served["on_reqs"])
    assert on == served["off"] and all(on)
    assert on == _tokens(served["jrep"], [p[0] for p in served["pairs"]])
    # the port's shadow cadence came from the config, as JAX's attach sets it
    assert served["sched"].shadow_every == 2
    assert served["teng"].obs is served["obs"]


def test_harvest_equals_jax_and_reconciles(served):
    h, jh = served["harvest"], served["jobs"].last_harvest
    for name in ("steps", "tokens_total", "tokens_by_tier", "health_flagged",
                 "queue_hist", "occ_hist"):
        assert h[name] == jh[name], name
    assert h["shadow_by_tier"]["mimps"]["count"] == \
        jh["shadow_by_tier"]["mimps"]["count"] > 0
    np.testing.assert_allclose(h["shadow_by_tier"]["mimps"]["rel_err_mean"],
                               jh["shadow_by_tier"]["mimps"]["rel_err_mean"],
                               rtol=1e-4, atol=1e-7)
    rep = served["on"]
    assert h["tokens_by_tier"] == {t: v for t, v in
                                   rep.tokens_by_tier.items() if v}
    assert h["tokens_total"] == sum(len(c.tokens) for c in rep.completions)
    r = served["obs"].registry
    assert r.get("serving_tokens_total") == h["tokens_total"]
    assert r.get("goodput_tok_s") == pytest.approx(rep.goodput_tok_s)


def test_trace_parses_and_obs_report_accepts_it(served):
    tmp = served["tmp"]
    trace, snap = tmp / "port.jsonl", tmp / "port.json"
    events = _events(trace)
    assert len(events) == served["obs"].tracer.events_written
    names = {e["name"] for e in events}
    for want in ("observability_attached", "enqueue", "queued", "replay",
                 "decode", "request", "device_step:mimps", "host_step"):
        assert want in names, want
    for e in events:
        assert e["ph"] in ("X", "i", "C", "M") and e["pid"] == 1
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0
    spans = [e for e in events if e["ph"] == "X" and e["name"] == "request"]
    assert sorted(e["args"]["req_id"] for e in spans) == \
        sorted(c.request.req_id for c in served["on"].completions)
    assert {e["name"] for e in _events(tmp / "jax.jsonl")} == names
    assert obs_report.main([str(trace), "--snapshot", str(snap)]) == 0
    bad = tmp / "tampered.json"
    s = json.loads(snap.read_text())
    s["harvest"]["tokens_by_tier"] = {"topk": s["harvest"]["tokens_total"]}
    bad.write_text(json.dumps(s))
    assert obs_report.main([str(trace), "--snapshot", str(bad)]) == 3


def test_exact_tier_shadow_rel_err_identically_zero(served, tmp_path):
    teng = served["teng"]
    cfg = dataclasses.replace(teng.cfg, partition=dataclasses.replace(
        teng.cfg.partition, method="exact"))
    eng = Engine(Model(cfg), teng.params, S.MAX_LEN, seed=1, device="cpu")
    obs = Observability(_obs_cfg(tmp_path, "exact", shadow_every=1))
    reqs = [p[1] for p in S.mixed_pairs(cfg.partition.sample_k, n=3,
                                        base=60)]
    Server(Scheduler(eng, 3), obs=obs).run(
        arrivals=trace_arrivals(reqs, [0] * len(reqs)))
    shadow = obs.last_harvest["shadow_by_tier"]["exact"]
    obs.close()
    assert shadow["count"] > 0
    assert shadow["rel_err_mean"] == 0.0 and shadow["rel_err_max"] == 0.0


def test_engine_swap_and_restore_are_traced(served, tmp_path):
    teng = served["teng"]
    eng = Engine(Model(teng.cfg), teng.params, S.MAX_LEN, seed=1,
                 device="cpu", index_assign=teng.index.assign)
    obs = Observability(ObsConfig(trace_path=str(tmp_path / "t.jsonl")))
    Server(Scheduler(eng, 2), obs=obs)
    eng.swap_index(teng.params, index_assign=teng.index.assign)
    eng.restore_index()
    obs.close()
    inst = [e for e in _events(tmp_path / "t.jsonl") if e["ph"] == "i"]
    assert [e["name"] for e in inst] == ["observability_attached",
                                         "index_swap", "index_restore"]
    assert inst[2]["args"] == {"method": "mimps", "restores": 1}


def test_prometheus_text_and_http_exposition():
    r = MetricsRegistry()
    r.set("tokens_total", 42, mtype="counter", help="tokens")
    r.set("rel_err", 0.25, labels={"tier": "mimps"})
    text = r.prometheus_text()
    assert "# TYPE repro_tokens_total counter" in text
    assert "# HELP repro_tokens_total tokens" in text
    assert "repro_tokens_total 42" in text
    assert 'repro_rel_err{tier="mimps"} 0.25' in text
    port = r.serve(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            assert "repro_tokens_total 42" in resp.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/snapshot",
                                    timeout=10) as resp:
            snap = json.loads(resp.read().decode())
        assert snap == {"rel_err": {"mimps": 0.25}, "tokens_total": 42.0}
    finally:
        r.close()


def test_tracewriter_counts_and_flushes(tmp_path):
    path = tmp_path / "w.jsonl"
    w = TraceWriter(str(path))
    w.name_thread(3, "req 3")
    w.name_thread(3, "req 3")            # named once
    w.span("s", 1.0, 2.0, tid=3)
    w.instant("i")
    w.counter("c", {"x": 1})
    assert path.read_text() == ""        # buffered until a flush
    w.flush()
    assert len(path.read_text().splitlines()) == 5
    w.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    # the constructor names tid 0 ("scheduler"), then the 4 events above
    assert len(lines) == w.events_written == 5
    assert [e["ph"] for e in lines] == ["M", "M", "X", "i", "C"]
    assert lines[4]["args"] == {"x": 1.0}
