"""The MoE block on the card: one layer of deepseek-moe-16b at full width
(d 2048, 64 routed experts of 1408, top-6, 2 shared; bf16 experts, f32
router) against the same function on the CPU on the same inputs, at a
decode batch of 16 tokens and a prefill of 2 x 64: the same experts chosen
for every token, the output within 1e-2 of its norm (bf16 products summed
in another order), the aux terms within 1e-5. The router product stays
f32 with TF32 allowed globally (within 1e-5 of float64, where TF32 would
miss by about 1e-3). Two calls are bit-equal (the combine sums in a fixed
order, no atomics). One decode step of a reduced MoE model captured in a
CUDA graph equals the eager step bit for bit (hidden states and KV).

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_moe.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import Model
from repro_torch.models import moe as tmoe

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def layer(dev):
    """Layer 0 of a one-layer full-width deepseek-moe-16b MoE FFN."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = tmoe.init_moe(gen, cfg, 1, torch.bfloat16, dev)
    return cfg, {k: v[0] if not isinstance(v, dict)
                 else {n: t[0] for n, t in v.items()} for k, v in p.items()}


def _cpu(tree):
    return {k: _cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


@pytest.mark.parametrize("shape", [(16, 1), (2, 64)], ids=["decode16",
                                                          "prefill2x64"])
def test_full_width_block_equals_its_cpu_result(dev, layer, shape):
    cfg, p = layer
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape + (cfg.d_model,), generator=gen, device=dev
                    ).to(torch.bfloat16)
    got, aux = tmoe.moe_block(p, x, cfg)
    want, waux = tmoe.moe_block(_cpu(p), x.cpu(), cfg)
    xf = x.reshape(-1, cfg.d_model)
    _, _, _, e_dev = tmoe.route(p["router"], xf, cfg.moe.top_k)
    _, _, _, e_cpu = tmoe.route(p["router"].cpu(), xf.cpu(), cfg.moe.top_k)
    assert torch.equal(e_dev.cpu(), e_cpu)
    diff = (got.float().cpu() - want.float()).norm() / want.float().norm()
    assert diff.item() < 1e-2, diff.item()
    for name in aux:
        assert abs(float(aux[name]) - float(waux[name])) <= 1e-5, name
    again, _ = tmoe.moe_block(p, x, cfg)
    assert torch.equal(got, again)


def test_router_stays_f32_with_tf32_allowed(dev, layer):
    cfg, p = layer
    gen = torch.Generator(device=dev).manual_seed(2)
    xf = torch.randn((64, cfg.d_model), generator=gen, device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        logits, _, _, _ = tmoe.route(p["router"], xf, cfg.moe.top_k)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    ref = xf.double() @ p["router"].double()
    err = ((logits.double() - ref).abs() / (1 + ref.abs())).max().item()
    assert err < 1e-5, err


def test_captured_decode_step_equals_eager(dev):
    cfg = dataclasses.replace(reduced_config("deepseek-moe-16b"),
                              dtype="bfloat16")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(3), dev)
    b, max_len = 16, 8
    toks = torch.randint(0, cfg.vocab, (4, b), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    state = model.init_decode_state(b, max_len, dev)
    for t in range(3):
        model.decode_step(params, state, toks[t], t)
    pos = torch.tensor(3, dtype=torch.int32, device=dev)
    eager = {k: v.clone() for k, v in state.items()}
    want = model.decode_step(params, eager, toks[3], pos)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.decode_step(params, state, toks[3], pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = model.decode_step(params, state, toks[3], pos)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for k in state:
        assert torch.equal(state[k], eager[k]), k
