"""Estimator-backed training on the card, at a small width (V 8192, d 256,
T 512, bf16 and f32): the sparse CE of mimps_ce and lsh_ce against its own
float64 evaluation (nll and log Ẑ to 1e-5 of 1 + |value|, dh and dw before
the cast to 1e-4 of their largest magnitude), dw bit-equal over
two calls (the head rows written once, the tail and label rows summed by
``segment_sums``, no atomics), every dw row outside head ∪ tail ∪ labels
exactly 0; a few train steps of each estimator loss finite, with the index
refresh; Table 4 at a small size with the kernels (``topk_z``,
``ivf_score``) on the zero-padded 101-wide vectors.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_estimator_losses.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import TrainConfig, reduced_config
from repro_torch.core.lsh import build_lsh_device
from repro_torch.core.mips import build_ivf_device
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.kernels import _build
from repro_torch.kernels.ivf_score import ivf_score
from repro_torch.kernels.topk_z import topk_z
from repro_torch.models import Model
from repro_torch.studies import table4_lbl as t4
from repro_torch.train import (init_train_state, losses, make_index_refresh,
                               make_train_step)

pytestmark = pytest.mark.cuda
V, D, T = 8192, 256, 512


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    w = (0.05 * torch.randn((V, D), generator=g, device=dev)).to(dtype)
    h = (0.05 * torch.randn((T, D), generator=g, device=dev)).to(dtype)
    lab = torch.randint(0, V, (T,), generator=g, device=dev)
    return w, h, lab


def _plan(kind, w, h, lab, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    if kind == "lsh":
        idx = build_lsh_device(w, n_bits=6, n_tables=4, generator=g,
                               device=dev)
        sp, _, _ = losses.lsh_estimator_plan(idx, h, lab, g, l=256)
    else:
        idx = build_ivf_device(w, 64, 32, generator=g, device=dev)
        sp, _ = losses.estimator_plan(idx, h, lab, g, n_probe=2, l=256)
    return sp


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["ivf", "lsh"])
def test_sparse_ce_against_float64(dev, kind, dtype):
    """The f32 evaluation against the same formula on float64 operands:
    nll and log Ẑ to 1e-5 of 1 + |value|, dh and dw (before the cast) to
    1e-4 of their largest magnitude, as the CPU tests hold gradients."""
    w, h, lab = _inputs(dev, dtype)
    sp = _plan(kind, w, h, lab, dev)
    g_nll = torch.full((T,), 1.0 / T, device=dev)
    g_lz = torch.zeros_like(g_nll)
    nll, lz, res = losses._sparse_ce_fwd(h, w, *sp)
    dh, dw = losses._sparse_ce_bwd(res, g_nll, g_lz, cast=False)
    r_nll, r_lz, r_res = losses._sparse_ce_fwd(h.double(), w.double(), *sp)
    r_dh, r_dw = losses._sparse_ce_bwd(r_res, g_nll, g_lz, cast=False)
    assert r_dw.dtype == torch.float64 and dw.dtype == torch.float32
    for got, want in ((nll, r_nll), (lz, r_lz)):
        err = ((got.double() - want).abs() / (1 + want.abs())).max().item()
        assert err <= 1e-5, err
    for got, want in ((dh, r_dh), (dw, r_dw)):
        err = (got.double() - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-4, err.item()


@pytest.mark.parametrize("kind", ["ivf", "lsh"])
def test_dw_bit_equal_and_sparse(dev, kind):
    w, h, lab = _inputs(dev, torch.bfloat16)
    sp = _plan(kind, w, h, lab, dev)
    outs = []
    for _ in range(2):
        hh = h.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        nll, lz = losses._sparse_ce(hh, ww, *sp)
        dh, dw = torch.autograd.grad(nll.mean(), (hh, ww))
        outs.append((nll, lz, dh, dw))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    dw = outs[0][3]
    assert dw.dtype == torch.bfloat16
    allowed = torch.zeros(V, dtype=torch.bool, device=dev)
    allowed[sp.head_rows[sp.head_mask.any(0)].long()] = True
    allowed[sp.tail_ids.long()] = True
    allowed[sp.labels.long()] = True
    touched = dw.float().abs().sum(-1) > 0
    assert not touched[~allowed].any()
    assert touched.any()


@pytest.mark.parametrize("loss", ["mimps_ce", "mince_ce", "lsh_ce", "nce",
                                  "sampled"])
def test_train_steps_on_the_card(dev, loss):
    cfg = reduced_config("qwen1.5-4b")
    cfg = dataclasses.replace(cfg, vocab=4096, partition=dataclasses.replace(
        cfg.partition, block_rows=64, n_probe=4, l=128, n_clusters=8,
        lsh_bits=6, lsh_tables=4))
    model = Model(cfg)
    tc = TrainConfig(loss=loss, lr=1e-3, warmup_steps=1)
    state = init_train_state(model, tc, 0, device=dev)
    step = make_train_step(model, tc)
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), 4, 32)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in zip(("tokens", "labels"), next(it))}
    for i in range(3):
        if i == 2 and state.index is not None:
            state, m = make_index_refresh(model, tc)(state)
            assert torch.isfinite(m["churn"]) and torch.isfinite(m["drift"])
        state, met = step(state, batch)
        assert torch.isfinite(met["loss_total"])


def test_table4_small_on_the_card(dev):
    _build.reset_counts([topk_z, ivf_score])
    res = t4.run(device=dev, sizes=dict(vocab=4096, steps=20, n_test=64))
    torch.cuda.synchronize()
    assert topk_z.by_variant["f32"] > 0 and ivf_score.by_variant["f32"] > 0
    assert res["sizes"]["padded_d"] == 104
    assert res["kernel_max_abs_err"] <= 1e-3
    assert res["pad_max_abs_diff"] <= 1e-5
