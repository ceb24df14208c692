"""The CUDA kernels against their plain PyTorch versions on the card, at the
qwen1.5-4b widths and at edge shapes the CPU tests cannot reach: query
counts that are not a multiple of the 8-query tile, k above 8 (the 32-entry
top-k lists), a single live union slot, a query with no member slot and one
with no accepted tail sample. bf16 inputs; LSEs and scores to 1e-3.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from repro_torch.kernels.ivf_score import ivf_decode, ivf_decode_plain
from repro_torch.kernels.topk_z import topk_z, topk_z_plain

pytestmark = pytest.mark.cuda
TOL = 1e-3
D = 2560


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _close_lse(got, want):
    assert torch.equal(got.isneginf(), want.isneginf())
    fin = ~want.isneginf()
    assert ((got[fin] - want[fin]).abs() <= TOL).all()


@pytest.fixture(scope="module")
def head(gen):
    w = (torch.randn(151936, D, generator=gen, device="cuda") * 0.02
         ).to(torch.bfloat16)
    w[100] = w[90000]                                   # an exact tie
    return w


@pytest.mark.parametrize("q,k", [(8, 8), (5, 1), (16, 12), (3, 8), (9, 32)])
def test_topk_z_matches_plain(gen, head, q, k):
    h = torch.randn(q, D, generator=gen, device="cuda").to(torch.bfloat16)
    h[0] = (head[90000].float() * 40).to(torch.bfloat16)   # tie on top
    before = topk_z.launches
    lse, tv, ti = topk_z(h, head, k)
    torch.cuda.synchronize()
    assert topk_z.launches == before + 1
    p_lse, p_v, p_i = topk_z_plain(h, head, k)
    _close_lse(lse, p_lse)
    assert (tv - p_v).abs().max().item() <= TOL
    assert torch.equal(ti, p_i)
    assert ti[0, :2].tolist() == [100, 90000][:k]      # lowest id first


@pytest.mark.parametrize("q,k,live", [(8, 8, 40), (5, 1, 7), (16, 12, 100),
                                      (3, 8, 1)])
def test_ivf_decode_matches_plain(gen, q, k, live):
    nb, br, l = 300, 512, 1000
    wb = (torch.randn(nb, br, D, generator=gen, device="cuda") * 0.02
          ).to(torch.bfloat16)
    h = torch.randn(q, D, generator=gen, device="cuda").to(torch.bfloat16)
    cap = min(q * 16, nb)
    ids = torch.sort(torch.randperm(nb, generator=gen, device="cuda")[:live]
                     ).values
    head_ids = torch.cat([ids, ids[-1:].expand(cap - live)]).to(torch.int32)
    member = torch.rand(q, cap, generator=gen, device="cuda") < 0.3
    member[0, 0] = True                                 # a real head ...
    member[-1] = False                                  # ... and an empty one
    valid = torch.rand(nb, br, generator=gen, device="cuda") < 0.9
    row_logw = torch.where(valid, 0.0, -1e30).float()
    tail = (torch.randn(l, D, generator=gen, device="cuda") * 0.02
            ).to(torch.bfloat16)
    accept = torch.rand(q, l, generator=gen, device="cuda") < 0.8
    accept[0] = False                                   # no survivor
    args = (wb, h, head_ids.contiguous(),
            torch.tensor(live, dtype=torch.int32, device="cuda"), member,
            row_logw, tail, accept)
    before = ivf_decode.launches
    hl, tl, tv, ti = ivf_decode(*args, k=k)
    torch.cuda.synchronize()
    assert ivf_decode.launches == before + 1
    p_hl, p_tl, p_v, p_i = ivf_decode_plain(*args, k=k)
    _close_lse(hl, p_hl)
    _close_lse(tl, p_tl)
    assert torch.isneginf(tl[0]) and torch.isneginf(hl[-1])
    assert (tv - p_v).abs().max().item() <= TOL
    assert torch.equal(ti, p_i)


def test_wrapper_refuses_what_the_kernel_does_not_take(gen):
    h = torch.randn(4, D, generator=gen, device="cuda")
    w = torch.randn(64, D, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        topk_z(h, w, 4)                                 # float32
    with pytest.raises(ValueError, match="k="):
        topk_z(h.bfloat16(), w.bfloat16(), 33)
