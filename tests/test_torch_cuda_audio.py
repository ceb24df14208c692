"""The audio family and gemma3 training on the card, at a reduced depth
and full width: musicgen-medium at 2 layers (d 1536, 24 heads of 64, 4
codebooks of vocab 2048, bf16), its captured ``generate`` equal to the host
loop bit for bit (tokens, log_prob, log_z) at temperature 0 and 1.0 and
launching none of the kernels; the fused CE pair at the audio training
step's flattened head (T 4096, V 8192, d 1536, bf16) against its plain
version (nll and lse to 1e-3, dh and dW to 2**-7 of the sum of their terms'
magnitudes per element and 2**-10 on average, two calls bit-equal); and
one gemma3 fused_ce train step at the reduced config (window 32) on a
sequence of 40, in f32, equal to the same step on the CPU (loss, grad norm
and lr to 1e-4 relative), each CE kernel launched once.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_audio.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import TrainConfig, get_config, reduced_config
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.kernels import _build
from repro_torch.kernels.fused_ce import (ce_coef, fused_ce_bwd,
                                         fused_ce_bwd_plain, fused_ce_fwd,
                                         fused_ce_fwd_plain)
from repro_torch.models import Model
from repro_torch.serve import Engine, generate
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.optimizer import tree_map

pytestmark = pytest.mark.cuda
KERNELS = (fused_ce_fwd, fused_ce_bwd)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_audio_generate_captured_equals_host_loop(dev):
    cfg = dataclasses.replace(get_config("musicgen-medium"), n_layers=2)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(model, params, 32, seed=3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (4, 8, cfg.n_codebooks),
                           generator=gen, device=dev)
    for temperature in (0.0, 1.0):
        runs = []
        for host_loop in (False, True):
            eng.generator.manual_seed(5)
            _build.reset_counts(KERNELS)
            runs.append(generate(eng, prompt, 12, temperature=temperature,
                                 host_loop=host_loop, return_aux=True))
            torch.cuda.synchronize()
            assert all(k.launches == 0 for k in KERNELS)
        (a, a_aux), (b, b_aux) = runs
        assert tuple(a.shape) == (4, 12, cfg.n_codebooks)
        assert torch.equal(a, b), temperature
        for name in ("log_prob", "log_z"):
            assert torch.equal(a_aux[name], b_aux[name]), (temperature, name)
            assert bool(torch.isfinite(a_aux[name]).all())
    assert eng.captures == 1


def test_fused_ce_pair_at_the_audio_head(dev):
    t, v, d = 4096, 8192, 1536
    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((t, d), generator=gen, device=dev).to(torch.bfloat16)
    # the (C, V, d) codebook head as the JAX init draws it: C ** -0.5
    w = (torch.randn((v, d), generator=gen, device=dev)
         * 4 ** -0.5).to(torch.bfloat16)
    lab = torch.randint(0, v, (t,), generator=gen, device=dev)
    nll, lse = fused_ce_fwd(h, w, lab)
    nll2, lse2 = fused_ce_fwd(h, w, lab)
    assert torch.equal(nll, nll2) and torch.equal(lse, lse2)
    p_nll, p_lse = fused_ce_fwd_plain(h, w, lab)
    assert (nll - p_nll).abs().max().item() <= 1e-3
    assert (lse - p_lse).abs().max().item() <= 1e-3
    args = (h, w, lab, lse, torch.full((t,), 1.0 / t, device=dev),
            torch.zeros((t,), device=dev))
    dh, dw = fused_ce_bwd(*args, cast=False)
    dh2, dw2 = fused_ce_bwd(*args, cast=False)
    assert torch.equal(dh, dh2) and torch.equal(dw, dw2)
    p_dh, p_dw = fused_ce_bwd_plain(*args, cast=False)
    coef = ce_coef(*args).abs()
    for got, want, terms in ((dh, p_dh, coef @ w.float().abs()),
                             (dw, p_dw, coef.T @ h.float().abs())):
        ratio = (got - want).abs() / terms.clamp(min=1e-30)
        assert ratio.max().item() <= 2 ** -7 + 1e-5
        assert ratio.mean().item() <= 2 ** -10


def test_gemma3_train_step_equals_cpu(dev):
    cfg = dataclasses.replace(reduced_config("gemma3-4b"), dtype="float32")
    assert cfg.sliding_window < 40
    model = Model(cfg)
    tcfg = TrainConfig(warmup_steps=1)
    cpu = init_train_state(model, tcfg, seed=0, device="cpu")
    card = cpu._replace(
        params=tree_map(lambda x: x.to(dev), cpu.params),
        opt=cpu.opt._replace(m=tree_map(lambda x: x.to(dev), cpu.opt.m),
                             v=tree_map(lambda x: x.to(dev), cpu.opt.v)))
    tokens, labels = next(DataIterator(SyntheticCorpus(cfg.vocab, seed=0),
                                       2, 40))
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    step = make_train_step(model, tcfg)
    _, want = step(cpu, batch)
    _build.reset_counts(KERNELS)
    _, got = step(card, {k: x.to(dev) for k, x in batch.items()})
    torch.cuda.synchronize()
    assert [k.launches for k in KERNELS] == [1, 1]
    for k in ("loss_total", "loss", "grad_norm", "lr"):
        a, b = float(got[k]), float(want[k])
        assert abs(a - b) <= 1e-4 * abs(b), (k, a, b)
