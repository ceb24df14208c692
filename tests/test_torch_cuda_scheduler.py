"""The slot scheduler's captured steps on the card, at a small width
(qwen1.5-4b reduced to 2 layers, d 128, vocab 2048, bf16, mimps with the
fixed-capacity index and the guard): each tier's step is one CUDA graph
replayed once a step, and must give the eager step's (``eager=True``)
tokens, log_prob and log_z bit for bit, plain and speculative, with the
prefix pool on. Admissions, temperatures, deadlines, the shadow cadence and
a tier switch back capture nothing; ``swap_index`` makes the next step
capture its tier once again; a table field rebound after the capture makes
the step raise instead of reading stale storage. With observability on,
a restore and the capture again it forces are traced as instants.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_scheduler.py
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels.ivf_score import ivf_decode
from repro_torch.kernels.topk_z import topk_z
from repro_torch.models import Model
from repro_torch.obs import Observability, ObsConfig
from repro_torch.serve import (Engine, Request, Scheduler, Server,
                               generate, trace_arrivals)

pytestmark = pytest.mark.cuda
MAX_LEN = 24


def _cfg(method="mimps"):
    cfg = reduced_config("qwen1.5-4b")
    return dataclasses.replace(
        cfg, vocab=2048, dtype="bfloat16", partition=dataclasses.replace(
            cfg.partition, method=method, block_rows=128, n_probe=4, l=128,
            fmbe_features=128))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(dev):
    return Model(_cfg()).init(torch.Generator(device=dev).manual_seed(0), dev)


def _engine(dev, params):
    return Engine(Model(_cfg()), params, MAX_LEN, seed=1, device=dev,
                  device_index=True)


def _requests(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, 2048, 3 + i % 4),
                    max_new_tokens=4 + i % 3, seed=10 + i,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(n)]


def _serve(sched, reqs, at=None):
    at = list(range(0, 2 * len(reqs), 2)) if at is None else at
    rep = Server(sched).run(arrivals=trace_arrivals(reqs, at))
    by_id = {c.request.req_id: c for c in rep.completions}
    return [by_id[r.req_id] for r in reqs], rep


def _same(a, b):
    for x, y in zip(a, b):
        assert x.tokens == y.tokens
        assert x.log_probs == y.log_probs
        assert x.log_zs == y.log_zs


@pytest.mark.parametrize("kw", [{}, dict(spec_draft="topk", spec_k=3),
                                dict(prefix_cache_blocks=8,
                                     prefix_block_tokens=2)],
                         ids=["plain", "spec", "prefix"])
def test_captured_equals_eager(dev, params, kw):
    eng = _engine(dev, params)
    reqs = _requests()
    eager, _ = _serve(Scheduler(eng, 4, seed=2, eager=True, **kw), reqs)
    sched = Scheduler(eng, 4, seed=2, **kw)
    _build.reset_counts([ivf_decode, topk_z])
    got, rep = _serve(sched, reqs)
    _same(got, eager)
    assert sched.captures == 1
    assert ivf_decode.launches >= rep.steps
    assert topk_z.gated >= rep.steps          # the guard and the shadow gate


def test_solo_generate_parity(dev, params):
    eng = _engine(dev, params)
    reqs = _requests(4)
    got, _ = _serve(Scheduler(eng, 4, seed=2), reqs)
    for r, c in zip(reqs, got):
        solo = generate(eng, torch.as_tensor(r.prompt[None]),
                        r.max_new_tokens, temperature=r.temperature,
                        generator=torch.Generator(dev).manual_seed(r.seed))
        assert c.tokens == solo[0].tolist()


def test_nothing_captured_again(dev, params):
    eng = _engine(dev, params)
    sched = Scheduler(eng, 4, seed=2)
    _serve(sched, _requests(2))
    assert sched.captures == 1
    sched.shadow_every = 2
    reqs = _requests(6, seed=5)
    for i, r in enumerate(reqs):
        r.deadline = 40 + i
    _serve(sched, reqs, at=[0, 0, 1, 3, 3, 7])
    sched.set_tier("topk")
    _serve(sched, _requests(2, seed=6))
    sched.set_tier("mimps")
    _serve(sched, _requests(2, seed=7))
    assert sched.captures == 2 and sched.captures_by_tier == {"mimps": 1,
                                                              "topk": 1}
    assert sched.harvest_metrics()["shadow_by_tier"]["mimps"]["count"] > 0


def test_swap_index_captures_once_again(dev, params):
    eng = _engine(dev, params)
    sched = Scheduler(eng, 4, seed=2)
    _serve(sched, _requests(2))
    noise = torch.randn(params["lm_head"].shape, generator=torch.Generator(
        dev).manual_seed(9), device=dev, dtype=params["lm_head"].dtype)
    eng.swap_index(dict(params, lm_head=params["lm_head"] + 0.01 * noise))
    got, _ = _serve(sched, _requests(3, seed=8))
    assert sched.captures == 2 and len(sched.recapture_log) == 1
    fresh = Scheduler(eng, 4, seed=2, eager=True)
    want, _ = _serve(fresh, _requests(3, seed=8))
    assert [c.tokens for c in got] == [c.tokens for c in want]


def test_restore_and_its_capture_again_are_traced(dev, params, tmp_path):
    eng = _engine(dev, params)
    sched = Scheduler(eng, 4, seed=2)
    obs = Observability(ObsConfig(trace_path=str(tmp_path / "t.jsonl")))
    server = Server(sched, obs=obs)
    server.run(arrivals=trace_arrivals(_requests(2), [0, 2]))
    eng.restore_index()
    server.run(arrivals=trace_arrivals(_requests(2, seed=8), [0, 2]))
    obs.close()
    inst = [json.loads(line) for line in
            (tmp_path / "t.jsonl").read_text().splitlines()]
    inst = [e for e in inst if e["ph"] == "i" and e["name"] in
            ("index_restore", "recapture")]
    assert [e["name"] for e in inst] == ["index_restore", "recapture"]
    assert inst[1]["args"]["tier"] == "mimps"
    assert inst[1]["args"]["seconds"] == sched.recapture_log[0][1]
    assert sched.captures == 2


def test_rebound_field_raises(dev, params):
    eng = _engine(dev, params)
    sched = Scheduler(eng, 4, seed=2)
    _serve(sched, _requests(1))
    sched.table.budget = torch.zeros_like(sched.table.budget)
    sched.admit(_requests(1, seed=4)[0])
    with pytest.raises(RuntimeError, match="budget was rebound"):
        sched.step()
