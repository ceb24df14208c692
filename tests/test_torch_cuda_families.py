"""gemma3, RWKV6 and Zamba2 on the card at a small width (each family's
reduced config, vocab 2048, bf16, mimps with the fixed-capacity index):
one decode step captured in a CUDA graph equals the eager step bit for bit
(hidden states and every state leaf: KV rings, ``wkv``, ``ssm`` and conv
states); ``generate`` through its captured step equals the host loop
(tokens, log_prob, log_z), gemma3's with a prompt past its 32-slot rings;
the slot scheduler's captured step equals ``Scheduler(eager=True)`` on a
trace with a reused lane and a lane that sat dead, which holds only if the
capture's warm-up puts the recurrent leaves back. And the ring geometry
the gathered-row kernels pick at d 4096 (rwkv6-7b's width) and d 8192
(llama-3.2-vision-90b's): one bf16 row is 8208 or 16400 bytes with its
pitch, and at least two stages fit.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_families.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels.ivf_score import stream_geometry
from repro_torch.models import Model, tree_leaves, tree_paths
from repro_torch.serve import (Engine, Request, Scheduler, Server,
                               generate, trace_arrivals)

pytestmark = pytest.mark.cuda
ARCHS = ("gemma3-4b", "rwkv6-7b", "zamba2-7b")
MAX_LEN = 48
VOCAB = 2048


def _cfg(arch):
    cfg = reduced_config(arch)
    return dataclasses.replace(
        cfg, vocab=VOCAB, dtype="bfloat16", partition=dataclasses.replace(
            cfg.partition, method="mimps", block_rows=128, n_probe=4,
            l=128))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _engine(arch, dev):
    model = Model(_cfg(arch))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    return Engine(model, params, MAX_LEN, seed=1, device=dev,
                  device_index=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_decode_step_equals_eager(dev, arch):
    eng = _engine(arch, dev)
    model, params = eng.model, eng.params
    b = 4
    state = model.init_decode_state(b, MAX_LEN, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    pos = torch.zeros((b,), dtype=torch.int32, device=dev)
    for _ in range(40):                    # past gemma3's 32-slot rings
        tok = torch.randint(0, VOCAB, (b,), generator=gen, device=dev)
        model.decode_step(params, state, tok, pos)
        pos += 1
    tok = torch.randint(0, VOCAB, (b,), generator=gen, device=dev)
    eager = {p: t.clone() for p, t in tree_paths(state)}
    eager_state = _clone(state)
    want = model.decode_step(params, eager_state, tok, pos)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        model.decode_step(params, _clone(state), tok, pos)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = model.decode_step(params, state, tok, pos)
    for path, t in tree_paths(state):       # the capture changed nothing
        assert torch.equal(t, eager[path]), path
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for (path, a), b_ in zip(tree_paths(state), tree_leaves(eager_state)):
        assert torch.equal(a, b_), path


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_generate_equals_host_loop(dev, arch):
    eng = _engine(arch, dev)
    p_len = 36 if arch == "gemma3-4b" else 6
    prompt = torch.randint(0, VOCAB, (4, p_len), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(3))
    outs = []
    for host_loop in (False, True):
        eng.generator.manual_seed(5)
        outs.append(generate(eng, prompt, 8, return_aux=True,
                             temperature=0.7, host_loop=host_loop))
    (a, a_aux), (b, b_aux) = outs
    assert eng.captures == 1
    assert torch.equal(a, b)
    for name in ("log_prob", "log_z"):
        assert torch.equal(a_aux[name], b_aux[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_scheduler_equals_eager_on_a_reused_lane(dev, arch):
    eng = _engine(arch, dev)
    rng = np.random.default_rng(4)
    spec = [(3, 2, 0.0), (6, 12, 0.8), (5, 6, 0.0), (4, 5, 0.8)]
    at = [0, 0, 6, 8]                # lane 0 reused, lane 2 dead until 8
    if arch == "gemma3-4b":          # lanes past the 32-slot rings
        spec = [(30, 10, 0.0), (5, 6, 0.8), (34, 8, 0.0), (12, 4, 0.8)]
        at = [0, 0, 2, 5]
    prompts = [rng.integers(0, VOCAB, p) for p, _, _ in spec]
    got = []
    for eager in (False, True):
        sched = Scheduler(eng, 3, seed=2, eager=eager)
        reqs = [Request(prompt=pr, max_new_tokens=n, seed=20 + i,
                        temperature=t)
                for i, (pr, (_, n, t)) in enumerate(zip(prompts, spec))]
        rep = Server(sched).run(arrivals=trace_arrivals(reqs, at))
        by_id = {c.request.req_id: c for c in rep.completions}
        got.append([(by_id[r.req_id].tokens, by_id[r.req_id].log_zs)
                    for r in reqs])
        assert sched.captures == (0 if eager else 1)
    assert got[0] == got[1]


def test_stream_geometry_at_d4096(dev):
    """At d 4096 and at the VLM's d 8192 (a bf16 row of 16400 bytes with
    its pitch) the ring still holds at least two stages."""
    for d, pitch in ((4096, 8208), (8192, 16400)):
        for kernel in ("ivf_decode", "union_scores"):
            g = stream_geometry(kernel, d, torch.bfloat16, u=256, l=1000,
                                grid_x=132)
            assert g["pitch"] == pitch
            assert 1 <= g["rows"] <= 16 and g["stages"] >= 2
            assert g["smem"] <= 232448
