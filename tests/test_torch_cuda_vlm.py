"""The VLM and the decode kernels at wide rows, on the card.

- The reduced llama-3.2-vision-90b (10 layers, d 128, 16 image tokens;
  vocab 2048, bf16, mimps with the fixed-capacity index and the guard):
  ``generate`` through its captured step equals the host loop (tokens,
  log_prob, log_z) at temperature 0.7, and a second image replays the same
  graph (no capture again), equal to its host loop and giving other
  tokens.
- ``topk_z`` (ungated and gated by ``rows``) and ``ivf_decode`` against
  their plain versions at d 5120, 6144 and 8192 (mistral-nemo-12b's,
  nemotron-4-15b's and the VLM's widths), ``topk_z`` also at zamba2's d
  3584 and rwkv6's 4096: LSEs and top-k scores to 1e-3, top ids equal,
  two calls bit-equal. bf16 ``topk_z`` keeps no query tile, so it runs at
  every width; the f32 kernel's tile fits up to d 6736, and f32 at d 8192
  raises the wrapper's ValueError before any launch.
- The index at the VLM head's size (507 blocks of 512 x 8192 bf16): the
  block centroids and radii, computed on one f32 copy overwritten in
  place, equal the out-of-place products bit for bit.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_vlm.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import mips
from repro_torch.kernels.ivf_score import ivf_decode, ivf_decode_plain
from repro_torch.kernels.topk_z import topk_z, topk_z_plain
from repro_torch.models import Model
from repro_torch.serve import Engine, generate

pytestmark = pytest.mark.cuda
TOL = 1e-3
VOCAB = 2048
WIDTHS = (5120, 6144, 8192)


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in f32
    return torch.Generator(device="cuda").manual_seed(0)


def _close_lse(got, want):
    assert torch.equal(got.isneginf(), want.isneginf())
    fin = ~want.isneginf()
    assert ((got[fin] - want[fin]).abs() <= TOL).all()


def test_captured_generate_with_an_image_equals_host_loop(gen):
    cfg = reduced_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(
        cfg, vocab=VOCAB, dtype="bfloat16", partition=dataclasses.replace(
            cfg.partition, method="mimps", block_rows=128, n_probe=4,
            l=128))
    model = Model(cfg)
    dev = torch.device("cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(model, params, 32, seed=1, device=dev, device_index=True,
                 health_guard=True)
    prompt = torch.randint(0, VOCAB, (4, 6), device=dev, generator=gen)
    toks = []
    for _ in range(2):                       # two images, one graph
        img = torch.randn(4, cfg.n_image_tokens, cfg.d_model, device=dev,
                          generator=gen).to(torch.bfloat16)
        outs = []
        for host_loop in (False, True):
            eng.generator.manual_seed(5)
            outs.append(generate(eng, prompt, 8, return_aux=True, img=img,
                                 temperature=0.7, host_loop=host_loop))
        (a, a_aux), (b, b_aux) = outs
        assert torch.equal(a, b)
        for name in ("log_prob", "log_z"):
            assert torch.equal(a_aux[name], b_aux[name]), name
        toks.append(a)
    assert eng.captures == 1
    assert not torch.equal(toks[0], toks[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", (3584, 4096) + WIDTHS)
def test_topk_z_at_wide_rows(gen, d, dtype):
    q, k, v = 8, 8, 32000
    w = (torch.randn(v, d, generator=gen, device="cuda") * d ** -0.5
         ).to(dtype)
    w[100] = w[20000]                                   # an exact tie
    h = torch.randn(q, d, generator=gen, device="cuda").to(dtype)
    h[0] = (w[20000].float() * 40).to(dtype)            # tie on top
    if dtype == torch.float32 and d > 6736:
        with pytest.raises(ValueError, match=f"d {d} in torch.float32"):
            topk_z(h, w, k)
        return
    lse, tv, ti = topk_z(h, w, k)
    again = topk_z(h, w, k)
    rows = torch.zeros(q, dtype=torch.int32, device="cuda")
    rows[0] = rows[-1] = 1
    gated = topk_z(h, w, k, rows=rows)
    torch.cuda.synchronize()
    for a, b in zip((lse, tv, ti), again):
        assert torch.equal(a, b)
    p_lse, p_v, p_i = topk_z_plain(h, w, k)
    _close_lse(lse, p_lse)
    assert (tv - p_v).abs().max().item() <= TOL
    assert torch.equal(ti, p_i)
    assert ti[0, :2].tolist() == [100, 20000]           # lowest id first
    on = rows != 0
    for a, b in zip(gated, (lse, tv, ti)):
        assert torch.equal(a[on], b[on])
    assert torch.isneginf(gated[0][~on]).all()


@pytest.mark.parametrize("d", WIDTHS)
def test_ivf_decode_at_wide_rows(gen, d):
    """The main path's plan shape at bf16: 8 queries, 23 live blocks of a
    128-slot union of 512-row blocks, 1000 tail rows, k 8."""
    q, k, nb, br, live, cap, l = 8, 8, 128, 512, 23, 128, 1000
    dt = torch.bfloat16
    wb = (torch.randn(nb, br, d, generator=gen, device="cuda") * d ** -0.5
          ).to(dt)
    h = torch.randn(q, d, generator=gen, device="cuda").to(dt)
    ids = torch.sort(torch.randperm(nb, generator=gen, device="cuda")[:live]
                     ).values
    head_ids = torch.cat([ids, ids[-1:].expand(cap - live)]).to(torch.int32)
    member = torch.rand(q, cap, generator=gen, device="cuda") < 0.3
    member[:, 0] = True
    valid = torch.rand(nb, br, generator=gen, device="cuda") < 0.9
    row_logw = torch.where(valid, 0.0, -1e30).float()
    tail = (torch.randn(l, d, generator=gen, device="cuda") * d ** -0.5
            ).to(dt)
    accept = torch.rand(q, l, generator=gen, device="cuda") < 0.8
    args = (wb, h, head_ids.contiguous(),
            torch.tensor(live, dtype=torch.int32, device="cuda"), member,
            row_logw, tail, accept)
    out = ivf_decode(*args, k=k)
    again = ivf_decode(*args, k=k)
    torch.cuda.synchronize()
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    hl, tl, tv, ti = out
    p_hl, p_tl, p_v, p_i = ivf_decode_plain(*args, k=k)
    _close_lse(hl, p_hl)
    _close_lse(tl, p_tl)
    assert (tv - p_v).abs().max().item() <= TOL
    assert torch.equal(ti, p_i)


def test_index_statistics_at_the_vlm_head(gen):
    """``mips.pack_ivf`` at llama-3.2-vision-90b's head (128256 x 8192 bf16,
    256 clusters, 507 blocks of 512): the block centroids and radii, which
    it computes on one f32 copy overwritten in place, equal the
    out-of-place products bit for bit."""
    v = (torch.randn(128256, 8192, generator=gen, device="cuda")
         * 128256 ** -0.5).to(torch.bfloat16)
    assign = torch.randint(0, 256, (128256,), generator=gen, device="cuda")
    idx = mips.pack_ivf(v, assign, 256, 512)
    assert idx.v_blocks.shape == (507, 512, 8192)
    del v, assign
    vf = idx.v_blocks.float()
    counts = torch.clamp(idx.valid.sum(1, keepdim=True), min=1).float()
    cent = (vf * idx.valid[..., None]).sum(1) / counts
    dist = torch.linalg.vector_norm(vf - cent[:, None, :], dim=-1)
    radius = torch.where(idx.valid, dist, torch.zeros_like(dist)).amax(1)
    assert torch.equal(idx.block_centroids.view(torch.int16),
                       cent.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(idx.block_radius.view(torch.int32),
                       radius.view(torch.int32))
