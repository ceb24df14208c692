"""The captured decode step on the card, at a small width (qwen1.5-4b reduced
to 2 layers, d 128, vocab 2048): ``generate`` replays one CUDA graph a step
and must give the host loop's tokens, log_prob and log_z bit for bit, for
every serving method, in bf16 and f32, at temperature 0 and above. The lsh
decode is captured on both of its branches (the trimmed union, and the
dense fallback that a small ``head_cap`` forces on every step). Launch
counts grow with the replays, a swap captures afresh, a step with lanes at
different positions replays the eager step's bits, and a capture that
would read the host raises instead of falling back.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_generate.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels.ivf_score import ivf_decode
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeState, generate

pytestmark = pytest.mark.cuda
METHODS = ["exact", "mimps", "selfnorm", "topk", "mince", "fmbe", "lsh"]
DTYPES = ["bfloat16", "float32"]
MAX_LEN = 24


def _cfg(method, dtype="bfloat16", **part):
    cfg = reduced_config("qwen1.5-4b")
    return dataclasses.replace(
        cfg, vocab=2048, dtype=dtype, partition=dataclasses.replace(
            cfg.partition, method=method, block_rows=128, n_probe=4, l=128,
            fmbe_features=128, **part))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(dev, dtype):
    cfg = _cfg("exact", dtype)
    return Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)


def _engine(dev, method, dtype="bfloat16", params=None, **kw):
    part = {k: kw.pop(k) for k in ("head_cap",) if k in kw}
    cfg = _cfg(method, dtype, **part)
    params = _params(dev, dtype) if params is None else params
    return Engine(Model(cfg), params, MAX_LEN, seed=1, device=dev, **kw)


def _prompt(dev, b=4, t=5, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 2048, (b, t), generator=g, device=dev)


def _both(eng, prompt, n, **kw):
    """Captured and host-loop runs from the same generator state."""
    eng.generator.manual_seed(7)
    cap = generate(eng, prompt, n, return_aux=True, **kw)
    eng.generator.manual_seed(7)
    host = generate(eng, prompt, n, return_aux=True, host_loop=True, **kw)
    return cap, host


def _assert_bit_equal(cap, host):
    assert torch.equal(cap[0], host[0])
    for name in ("log_prob", "log_z"):
        assert torch.equal(cap[1][name], host[1][name]), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_captured_generate_equals_host_loop(dev, method, dtype, temperature):
    eng = _engine(dev, method, dtype)
    cap, host = _both(eng, _prompt(dev), 6, temperature=temperature)
    assert eng.captures == 1
    _assert_bit_equal(cap, host)
    assert bool(torch.isfinite(cap[1]["log_z"]).all())


@pytest.mark.parametrize("head_cap,dense", [(0, False), (8, True)])
def test_lsh_branches_captured(dev, head_cap, dense):
    """Both branches of the lsh decode, chosen on the device, replay the
    eager loop's bits; the union size of each step says which ran."""
    eng = _engine(dev, "lsh", head_cap=head_cap)
    unions = []

    class Recording(type(eng.backend)):
        def decode(self, *args, **kwargs):
            out = super().decode(*args, **kwargs)
            unions.append(out.head_live)
            return out

    cap, _ = _both(eng, _prompt(dev), 6)
    eng.backend = Recording()
    unions.clear()
    eng.generator.manual_seed(7)
    host = generate(eng, _prompt(dev), 6, return_aux=True, host_loop=True)
    _assert_bit_equal(cap, host)
    from repro_torch.core.lsh import resolve_cand_cap
    cap_rows = resolve_cand_cap(head_cap, eng.state.lsh, 2048)
    live = [int(u) for u in unions]
    assert len(live) == 5 + 6 - 1
    if dense:
        assert all(u > cap_rows for u in live)
    else:
        assert all(u <= cap_rows for u in live)


def test_launch_counts_scale_with_replays(dev):
    eng = _engine(dev, "mimps")
    prompt = _prompt(dev)
    generate(eng, prompt, 2)                        # capture
    counts = []
    for n in (2, 7):
        _build.reset_counts(_build.COUNTED)
        generate(eng, prompt, n)
        torch.cuda.synchronize()
        counts.append((ivf_decode.launches, ivf_decode.by_variant["bf16"]))
    steps = [prompt.shape[1] + n - 1 for n in (2, 7)]
    assert counts == [(s, s) for s in steps]
    assert eng.captures == 1


def test_one_runner_serves_every_length(dev):
    eng = _engine(dev, "exact")
    for t, n in ((3, 2), (6, 4)):
        cap, host = _both(eng, _prompt(dev, t=t), n)
        _assert_bit_equal(cap, host)
    assert eng.captures == 1 and len(eng._graph_runners) == 1


def test_swap_and_restore_capture_afresh(dev):
    eng = _engine(dev, "mimps", device_index=True)
    prompt = _prompt(dev)
    generate(eng, prompt, 2)
    eng.swap_index(_params(dev, "bfloat16"))
    cap, host = _both(eng, prompt, 3)
    _assert_bit_equal(cap, host)
    eng.restore_index()
    generate(eng, prompt, 2)
    assert eng.captures == 3


def test_capture_that_reads_the_host_raises(dev):
    eng = _engine(dev, "mimps", use_kernel=False)
    with pytest.raises(ValueError, match="host_loop"):
        generate(eng, _prompt(dev), 2)
    generate(eng, _prompt(dev), 2, host_loop=True)

    eng = _engine(dev, "exact")

    class ReadsHost(type(eng.backend)):
        def decode(self, state, h, *args, **kwargs):
            if float(h.float().sum()) != float(h.float().sum()):
                raise AssertionError("unreachable")
            return super().decode(state, h, *args, **kwargs)

    eng.backend = ReadsHost()
    with pytest.raises(RuntimeError):
        generate(eng, _prompt(dev), 2)
    assert eng.captures == 0


def test_per_lane_positions_captured_step(dev):
    """Lanes at positions 2 to 5: one captured step equals the eager step
    bit for bit, outputs and KV cache."""
    eng = _engine(dev, "mimps")
    pc = eng.cfg.partition
    b = 4
    prompt = _prompt(dev, b=b, t=4)
    state = ServeState(
        cache=eng.model.init_decode_state(b, MAX_LEN, dev),
        pos=torch.arange(2, 2 + b, dtype=torch.int32, device=dev),
        last_token=prompt[:, 0])
    g = torch.Generator(device=dev).manual_seed(5)
    temp = torch.zeros((), dtype=torch.float32, device=dev)
    gumbel = torch.zeros((b, pc.sample_k), device=dev)
    for t in range(3):
        tail = eng.backend.draw_tail(eng.state, pc, g)
        state = dataclasses.replace(state, last_token=prompt[:, t])
        _, state = eng.decode_step(state, temp, tail_idx=tail, gumbel=gumbel)
    tail = eng.backend.draw_tail(eng.state, pc, g)
    state = dataclasses.replace(state, last_token=prompt[:, 3])
    eager_cache = {k: v.clone() for k, v in state.cache.items()}
    want, _ = eng.decode_step(dataclasses.replace(state, cache=eager_cache),
                              temp, tail_idx=tail, gumbel=gumbel)

    def step():
        return eng.decode_step(state, temp, tail_idx=tail, gumbel=gumbel)[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                       # idempotent: the same KV, same slots
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step()
    graph.replay()
    torch.cuda.synchronize()
    for name in ("token", "log_prob", "log_z", "overflow"):
        assert torch.equal(got[name], want[name]), name
    for k in eager_cache:
        assert torch.equal(state.cache[k], eager_cache[k])


def test_overflow_under_capture(dev):
    eng = _engine(dev, "exact")
    b = 2
    state = ServeState(
        cache=eng.model.init_decode_state(b, MAX_LEN, dev),
        pos=torch.tensor([MAX_LEN - 1, MAX_LEN], dtype=torch.int32,
                         device=dev),
        last_token=torch.zeros(b, dtype=torch.long, device=dev))
    temp = torch.zeros((), device=dev)
    gumbel = torch.zeros((b, eng.cfg.partition.sample_k), device=dev)
    with pytest.raises(ValueError, match="max_len"):
        eng.decode_step(state, temp, gumbel=gumbel)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = eng.decode_step(state, temp, gumbel=gumbel)
    graph.replay()
    torch.cuda.synchronize()
    assert out["overflow"].tolist() == [False, True]
