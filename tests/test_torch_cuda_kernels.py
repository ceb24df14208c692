"""The CUDA kernels against their plain PyTorch versions on the card, at the
qwen1.5-4b widths and at edge shapes the CPU tests cannot reach: query
counts that are not a multiple of the 8-query tile, k above 8 (the 32-entry
top-k lists), a single live union slot and a full union, a query with no
member slot and one with no accepted tail sample, feature counts that are
not a multiple of the feature tile, features of degree 0 and of degree 8.
Every kernel runs with bf16 and with f32 rows and queries (the f32
instantiations accumulate in f32 as the bf16 ones do); LSEs and scores to
1e-3. The tensor-core ``fmbe_phi`` (bf16 x) also runs at pack layouts
with degree-8 features ending at a column-tile boundary and pushed past
one, and column tiles of degree-0 features only, must give equal bits
over two calls and refuses a pack made from other tensors. The tensor-core
``fmbe_z`` reads that pack at both dtypes (f32 x as three planes), with
lambda shared and per query, P off the 16-feature and 128-column tiles,
features of degree 0 and 8, two calls bit-equal, and refuses a pack of
other tensors. FMBE sums are signed and cancel, so
z is held to 1e-4 of sum_j |phi_j lambda_j| and phi to 1e-4 of its own
scale |coef_j| * max(|x|_2, 1) ** degree_j (plus |phi|); f32 z is held
to float64 and to its planes decomposition, not to the plain version,
whose own f32 products reach that tolerance at these inputs. The fused CE
kernels run at token counts and vocabularies that are not multiples of
their 128 x 128 tiles or of the backward's vocab chunk (T 129, V = C + 1), with labels at 0 and V - 1 and with and without a selfnorm
cotangent; nll and lse to 1e-3. ``ivf_decode`` runs with no live slot
(tail rows only), at block heights 64 and 131 (heads ending inside a
stage; every CTA's first stage holds tail and head rows), with a few tail
rows a CTA, k 1, 8, 12 and 32, a query with no member slot and one with no
accepted tail sample (-inf LSEs), two calls bit-equal. ``union_scores``
runs with no live slot and
with every slot live, at block heights 64 and 131 (live rows that split
unevenly over the grid) and at rows too wide for a full stage (bf16 d
8192, f32 d 6144), two calls bit-equal. The LSH probe runs at one query
and at query counts off the tile, one candidate and a count off the
32-column group, no live candidate and all live, candidates ending inside
a stage, tail samples only, the dense fallback over every row, one tail
sample (dense and trimmed) and none accepted, k of 1 and 8, d off 128
and d 6144; its counts
equal the plain version's exactly and its membership the plan's, and its
query codes equal ``hash_codes`` except where a projection lies within
1e-5 of 0 relative to |h| |proj row|. ``ivf_score`` runs at one probe, one
query and block heights off 32. Both the kernel and the plain version
round the backward's coefficient to bf16 before the products, from f32
scores summed in another order (on the tensor cores, about 1e-4 apart at
d = 2560), so a coefficient whose two f32 values straddle a bf16 rounding
boundary rounds one bf16 step (at most 2**-7 relative) apart. dh and dW
(f32, before the cast) are therefore held per element to GRAD_REL = 2**-7
(+ 1e-5 for the f32 sums) of the sum of their terms' magnitudes, which an
element dominated by one term can reach, and on average over the elements
to GRAD_MEAN = 2**-10, which a missing or misplaced tile would exceed.

The f32 fused CE kernels round nothing: both run on the tensor cores on
exact bf16 planes of their f32 operands (``split_planes``, whose six
largest pair products drop terms of order 2**-24). The forward's nll and
lse are held to 1e-3 of the plain version and to 1e-5 of 1 + |value| from
float64 at logits up to about N(0, 64), and refuse d past F32_MAX_DEPTH
(the depth of their one sum). The backward's dh and dW are held to
F32_GRAD_REL = 1e-4 of the sum of their terms' magnitudes per element and
F32_GRAD_MEAN = 1e-5 on average (f32 scores, exp and sums in another order
than the plain version's; about 1e-6 is expected), 78x tighter than the
bf16 pair's limit, at widths d that are a multiple of 4 but not of 32, and
across the f32 chunk's edges, and at T 4096 and 16384, where the f32
backward runs in token slices of at most F32_MAX_DEPTH tokens whose dW
add up in f32 (also at small slices, through ``bwd_launch(depth=)``), and
against float64 at logits up to about N(0, 64). The
split kernel gives ``split_planes``'s bits, zeros past the rows and
columns it is given, in the backward's library and in the forward's (the
planes the forward read). f32 ``fmbe_phi`` runs the tensor-core kernel on
three exact bf16 planes of x against the +-1 pack: it is held to the plain
version, to its plane decomposition (``fmbe_phi_planes_plain``) and to
float64 under the same phi tolerance, and its planes of x are
``split_planes``'s.

A two-process test fingerprints every stage of the lsh path
(``tools/stage_fingerprints.py --lsh-only``) and requires the same
SHA-256 in both processes.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.fmbe import (PACK_TILE, fmbe_pack, fmbe_phi,
                                     fmbe_phi_planes_plain, fmbe_phi_plain,
                                     fmbe_z, fmbe_z_pack_plain,
                                     fmbe_z_planes_plain, fmbe_z_plain,
                                     pack_layout, phi_launch)
from repro_torch.kernels.fused_ce import (F32_MAX_DEPTH, bwd_launch,
                                         bwd_schedule, ce_coef, fused_ce_bwd,
                                         fused_ce_bwd_plain, fused_ce_fwd,
                                         fused_ce_fwd_planes_plain,
                                         fused_ce_fwd_plain, fwd_launch,
                                         planes_launch, split_planes)
from repro_torch.core import lsh as tlsh
from repro_torch.kernels.ivf_score import (ivf_decode, ivf_decode_plain,
                                          ivf_score, ivf_score_plain,
                                          union_scores, union_scores_plain)
from repro_torch.kernels.lsh_probe import (hash_codes, lsh_probe,
                                          lsh_probe_plain, lsh_query_codes)
from repro_torch.kernels.topk_z import NEG, topk_z, topk_z_plain

pytestmark = pytest.mark.cuda
TOL = 1e-3
GRAD_REL = 2 ** -7 + 1e-5
GRAD_MEAN = 2 ** -10
F32_GRAD_REL = 1e-4
F32_GRAD_MEAN = 1e-5
D = 2560
DTYPES = [torch.bfloat16, torch.float32]


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


@pytest.fixture(scope="module")
def head_bf16(gen):
    w = (torch.randn(151936, D, generator=gen, device="cuda") * 0.02
         ).to(torch.bfloat16)
    w[100] = w[90000]                                   # an exact tie
    return w


def _launched(fn, dtype, before, n=1):
    """``fn`` launched its kernel ``n`` times more, at ``dtype``."""
    key = "f32" if dtype == torch.float32 else "bf16"
    assert fn.launches == before[0] + n
    assert fn.by_variant[key] == before[1][key] + n


def _counts(fn):
    return fn.launches, dict(fn.by_variant)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q,k", [(8, 8), (5, 1), (16, 12), (3, 8), (9, 32)])
def test_topk_z_matches_plain(gen, head_bf16, q, k, dtype):
    head = head_bf16.to(dtype)
    h = torch.randn(q, D, generator=gen, device="cuda").to(dtype)
    h[0] = (head[90000].float() * 40).to(dtype)         # tie on top
    before = _counts(topk_z)
    lse, tv, ti = topk_z(h, head, k)
    torch.cuda.synchronize()
    _launched(topk_z, dtype, before)
    p_lse, p_v, p_i = topk_z_plain(h, head, k)
    _close_lse(lse, p_lse)
    assert (tv - p_v).abs().max().item() <= TOL
    assert torch.equal(ti, p_i)
    assert ti[0, :2].tolist() == [100, 90000][:k]      # lowest id first


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q,k,live,br,l", [
    (8, 8, 40, 512, 1000), (5, 1, 7, 512, 1000), (16, 12, 100, 512, 1000),
    (3, 8, 1, 512, 1000),
    (8, 8, 23, 512, 1000),        # the main path's plan
    (8, 32, 23, 512, 1000),       # k 32: the 32-entry lists
    (4, 8, 0, 512, 1000),         # head_live 0: tail rows only
    (8, 8, 23, 64, 1000),         # br 64: heads end inside stages
    (5, 8, 9, 131, 77),           # odd rows a block, a few tail rows a CTA
])
def test_ivf_decode_matches_plain(gen, q, k, live, br, l, dtype):
    """Against the plain version: LSEs to 1e-3, top-k values to 1e-3 and
    ids equal (fillers (NEG, 0) included), a query with no member slot and
    one with no accepted tail sample at -inf, two calls bit-equal. Each CTA
    takes its share of the tail rows first, so a stage holds tail and head
    rows, and its share of the head rows ends inside a block."""
    nb = 300
    wb = (torch.randn(nb, br, D, generator=gen, device="cuda") * 0.02
          ).to(dtype)
    h = torch.randn(q, D, generator=gen, device="cuda").to(dtype)
    cap = min(q * 16, nb)
    ids = torch.sort(torch.randperm(nb, generator=gen, device="cuda")[:live]
                     ).values
    last = ids[-1:] if live else torch.zeros(1, dtype=ids.dtype,
                                             device="cuda")
    head_ids = torch.cat([ids, last.expand(cap - live)]).to(torch.int32)
    member = torch.rand(q, cap, generator=gen, device="cuda") < 0.3
    member[0, 0] = True                                 # a real head ...
    member[-1] = False                                  # ... and an empty one
    valid = torch.rand(nb, br, generator=gen, device="cuda") < 0.9
    row_logw = torch.where(valid, 0.0, -1e30).float()
    tail = (torch.randn(l, D, generator=gen, device="cuda") * 0.02
            ).to(dtype)
    accept = torch.rand(q, l, generator=gen, device="cuda") < 0.8
    accept[0] = False                                   # no survivor
    args = (wb, h, head_ids.contiguous(),
            torch.tensor(live, dtype=torch.int32, device="cuda"), member,
            row_logw, tail, accept)
    before = _counts(ivf_decode)
    out = ivf_decode(*args, k=k)
    again = ivf_decode(*args, k=k)
    torch.cuda.synchronize()
    _launched(ivf_decode, dtype, before, 2)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    hl, tl, tv, ti = out
    p_hl, p_tl, p_v, p_i = ivf_decode_plain(*args, k=k)
    _close_lse(hl, p_hl)
    _close_lse(tl, p_tl)
    assert torch.isneginf(tl[0]) and torch.isneginf(hl[-1])
    if live == 0:
        assert torch.isneginf(hl).all() and (tv == NEG).all()
        assert not ti.any()
    assert (tv - p_v).abs().max().item() <= TOL
    assert torch.equal(ti, p_i)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q,live,cap,br", [
    (8, 23, 128, 512), (5, 1, 80, 512), (13, 128, 128, 512), (3, 2, 48, 512),
    (4, 0, 48, 512),              # no live slot: every slot a pad
    (8, 128, 128, 512),           # every slot live at the main path's Q
    (5, 3, 16, 131),              # 393 live rows: uneven shares under a stage
    (8, 23, 128, 64),
])
def test_union_scores_matches_plain(gen, q, live, cap, br, dtype):
    """Live slots equal the plain scores to 1e-3; pad slots are exactly 0
    although the output starts as uninitialised memory; two calls give the
    same bits."""
    nb = 300
    wb = (torch.randn(nb, br, D, generator=gen, device="cuda") * 0.02
          ).to(dtype)
    h = torch.randn(q, D, generator=gen, device="cuda").to(dtype)
    ids = torch.sort(torch.randperm(nb, generator=gen, device="cuda")[:live]
                     ).values
    last = ids[-1:] if live else torch.zeros(1, dtype=ids.dtype,
                                             device="cuda")
    head_ids = torch.cat([ids, last.expand(cap - live)]).to(torch.int32)
    head_live = torch.tensor(live, dtype=torch.int32, device="cuda")
    torch.full((q, cap, br), float("nan"), device="cuda")   # dirty the pool
    before = _counts(union_scores)
    got = union_scores(wb, h, head_ids.contiguous(), head_live)
    torch.full((q, cap, br), float("nan"), device="cuda")
    again = union_scores(wb, h, head_ids.contiguous(), head_live)
    torch.cuda.synchronize()
    _launched(union_scores, dtype, before, 2)
    want = union_scores_plain(wb, h, head_ids, head_live)
    assert got.shape == (q, cap, br)
    assert torch.equal(got, again)
    if live:
        assert (got[:, :live] - want[:, :live]).abs().max().item() <= TOL
    assert (got[:, live:] == 0).all()


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 5120),
                                     (torch.bfloat16, 8192),
                                     (torch.float32, 6144)])
def test_union_scores_wide_rows(gen, dtype, d):
    """Rows too wide for two stages of the full stage height: the ring takes
    fewer rows a stage (at f32 d 6144 one stage of one row), with the same
    contract and two calls bit-equal."""
    nb, br, q, live, cap = 40, 64, 5, 3, 8
    wb = (torch.randn(nb, br, d, generator=gen, device="cuda") * 0.02
          ).to(dtype)
    h = torch.randn(q, d, generator=gen, device="cuda").to(dtype)
    ids = torch.tensor([2, 17, 39, 39, 39, 39, 39, 39], dtype=torch.int32,
                       device="cuda")
    head_live = torch.tensor(live, dtype=torch.int32, device="cuda")
    got = union_scores(wb, h, ids, head_live)
    again = union_scores(wb, h, ids, head_live)
    want = union_scores_plain(wb, h, ids, head_live)
    assert torch.equal(got, again)
    assert (got[:, :live] - want[:, :live]).abs().max().item() <= TOL
    assert (got[:, live:] == 0).all()


def _codes_agree(got, want, proj, h):
    """Query codes equal, or the differing bits' projections within 1e-5
    of 0 relative to |h| |proj row|."""
    diff = got != want
    if not diff.any():
        return
    ltab, kbits, _ = proj.shape
    pm = proj[..., :h.shape[1]].reshape(ltab * kbits, -1).double()
    s = h.double() @ pm.T
    rel = (s / (h.double().norm(dim=1)[:, None] * pm.norm(dim=1)[None, :])
           ).abs().reshape(-1, ltab, kbits)
    flips = ((got ^ want)[..., None] >> torch.arange(
        kbits, device=got.device)) & 1
    assert (rel[flips.bool()] <= 1e-5).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q,d,c_kind,live_kind,l,tail_kind,k", [
    (1, D, "plan", "all", 1000, "sampled", 1),
    (13, D, "one", "all", 1000, "sampled", 8),
    (8, D, "odd", "none", 1000, "sampled", 8),
    (5, D, "dense", "all", 1, "sampled", 8),
    (9, D, "plan", "plan", 1000, "none", 1),
    (7, 200, "plan", "plan", 64, "sampled", 8),
    (8, D, "plan", "mid", 1000, "sampled", 8),    # head ends inside a stage
    (6, D, "plan", "none", 1000, "sampled", 4),   # tail rows only
    (5, D, "plan", "plan", 1, "sampled", 8),      # one tail sample, trimmed
    (3, 6144, "plan", "plan", 64, "sampled", 8),  # rows too wide for 16
])
def test_lsh_probe_matches_plain(gen, q, d, c_kind, live_kind, l, tail_kind,
                                 k, dtype):
    """Against the plain version at edge shapes: LSEs to 1e-3, counts
    exactly, top ids where the gap exceeds 1e-3, counts > 0 equal to the
    plan's membership, two calls bit-equal."""
    v = 20000
    w = (torch.randn(v, d, generator=gen, device="cuda") * 0.02).to(dtype)
    idx = tlsh.build_lsh_device(w, generator=gen, device="cuda")
    h = torch.randn(q, d, generator=gen, device="cuda").to(dtype)
    plan = tlsh.lsh_plan(idx, h, l, generator=gen)
    rows, live = plan.cand_rows, int(plan.cand_live)
    if c_kind == "one":
        rows, live = rows[:1].contiguous(), 1
    elif c_kind == "odd":
        rows = rows[:37].contiguous()
    elif c_kind == "dense":
        rows = torch.arange(v, dtype=torch.int32, device="cuda")
        live = v
    if live_kind == "all":
        live = rows.shape[0]
    elif live_kind == "none":
        live = 0
    elif live_kind == "mid":
        live = min(rows.shape[0], 1005)
    accept = plan.tail_accept
    if tail_kind == "none":
        accept = torch.zeros_like(accept)
    args = (w, h, idx.proj, rows, torch.tensor(live, dtype=torch.int32,
                                                  device="cuda"),
            idx.codes, idx.slot_of_row, plan.tail_ids, accept.contiguous(),
            plan.tail_bias.contiguous())
    before = _counts(lsh_probe)
    out = lsh_probe(*args, k=k)
    again = lsh_probe(*args, k=k)
    torch.cuda.synchronize()
    _launched(lsh_probe, dtype, before, 2)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    hl, tl, tv, ti, cnt = out
    p_hl, p_tl, p_v, p_i, p_cnt = lsh_probe_plain(*args, k=k)
    _codes_agree(lsh_query_codes(h, idx.proj), hash_codes(idx.proj, h),
                 idx.proj, h)
    assert torch.equal(cnt, p_cnt)
    assert not cnt[:, live:].any()
    if c_kind == "dense" or (c_kind == "plan" and live_kind == "plan"):
        member = plan.occ_q if c_kind == "dense" else plan.member
        assert torch.equal(cnt > 0, member)
    _close_lse(hl, p_hl)
    _close_lse(tl, p_tl)
    if live == 0:
        assert torch.isneginf(hl).all() and (tv == NEG).all()
        assert not ti.any()
    if tail_kind == "none":
        assert torch.isneginf(tl).all()
    assert (tv - p_v).abs().max().item() <= TOL
    _, _, p_v1, p_i1, _ = lsh_probe_plain(*args, k=k + 1)
    for qq in range(q):
        for j in range(k):
            up = p_v1[qq, j - 1] - p_v1[qq, j] if j else float("inf")
            down = p_v1[qq, j] - p_v1[qq, j + 1]
            if up > TOL and down > TOL:
                assert ti[qq, j] == p_i1[qq, j]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q,p,br", [(8, 16, 512), (1, 1, 512), (3, 5, 100),
                                    (4, 2, 37)])
def test_ivf_score_matches_plain(gen, q, p, br, dtype):
    nb = 50
    wb = (torch.randn(nb, br, D, generator=gen, device="cuda") * 0.02
          ).to(dtype)
    h = torch.randn(q, D, generator=gen, device="cuda").to(dtype)
    ids = torch.randint(0, nb, (q, p), generator=gen, device="cuda",
                        dtype=torch.int32)
    before = _counts(ivf_score)
    got = ivf_score(wb, h, ids)
    torch.cuda.synchronize()
    _launched(ivf_score, dtype, before)
    assert got.shape == (q, p, br)
    assert (got - ivf_score_plain(wb, h, ids)).abs().max().item() <= TOL


def _feature_map(gen, p, m=8, d=D):
    """Degrees drawn as the FMBE build draws them (truncated geometric),
    with feature 0 of degree 0 and feature 1 of degree m forced."""
    probs = torch.tensor([2.0 ** -(i + 1) for i in range(m + 1)],
                         device="cuda")
    degree = torch.multinomial(probs / probs.sum(), p, replacement=True,
                               generator=gen).to(torch.int32)
    degree[0], degree[1] = 0, m
    omega = (2 * torch.randint(0, 2, (p, m, d), generator=gen,
                               device="cuda") - 1).float()
    coef = torch.rand(p, generator=gen, device="cuda") * 0.01
    return omega, degree, coef


def _phi_scale(omega, degree, coef, x):
    norm = x.float().norm(dim=-1).clamp(min=1.0)
    return coef.abs()[None, :] * norm[:, None] ** degree[None, :].float()


def _check_phi(omega, degree, coef, x, pack=None):
    """fmbe_phi against its plain version, two calls bit-equal, one launch
    a call at x's dtype; returns phi."""
    q, p = x.shape[0], omega.shape[0]
    before = _counts(fmbe_phi)
    got = fmbe_phi(omega, degree, coef, x, pack=pack)
    again = fmbe_phi(omega, degree, coef, x, pack=pack)
    torch.cuda.synchronize()
    _launched(fmbe_phi, x.dtype, before, 2)
    assert torch.equal(got, again)                      # bit-reproducible
    want = fmbe_phi_plain(omega, degree, coef, x)
    assert got.shape == (q, p)
    zero = degree == 0
    assert torch.equal(got[:, zero], coef[zero].expand(q, -1))  # phi = coef
    tol = 1e-4 * (want.abs() + _phi_scale(omega, degree, coef, x))
    assert ((got - want).abs() <= tol).all()
    return got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q,p", [(8, 4096), (5, 1000), (13, 70),
                                 (8192, 4096), (131, 1000)])
def test_fmbe_phi_matches_plain(gen, q, p, dtype):
    """Both dtypes run the tensor-core kernel: bf16 x as it is, f32 x as
    three exact bf16 planes against the same +-1 pack."""
    omega, degree, coef = _feature_map(gen, p)
    x = (torch.randn(q, D, generator=gen, device="cuda") * 0.02).to(dtype)
    _check_phi(omega, degree, coef, x)


def _phi64(pack, x):
    """phi in float64 from f32 x and the pack's rows."""
    proj = x.double() @ pack.rows.double().T
    prod = torch.ones((x.shape[0], pack.start.shape[0]), dtype=torch.float64,
                      device=x.device)
    for m in range(8):
        use = pack.degree > m
        col = torch.where(use, pack.start + m, 0).long()
        prod = torch.where(use[None, :], prod * proj[:, col], prod)
    return prod * pack.coef.double()


@pytest.mark.parametrize("q,p,d,x_std", [(8192, 4096, D, 0.02),
                                         (131, 1000, 104, 1.0)])
def test_fmbe_phi_f32_matches_planes_plain_and_float64(gen, q, p, d, x_std):
    """f32 x at the build's chunk, and at rows off the tile with d off the
    64-column box (zeros in the planes past d): phi within the phi
    tolerance of ``fmbe_phi_planes_plain`` and of float64, and the split of
    x equal to ``split_planes`` bit for bit, zeros past d."""
    omega, degree, coef = _feature_map(gen, p, d=d)
    x = torch.randn(q, d, generator=gen, device="cuda") * x_std
    pack = fmbe_pack(omega, degree, coef)
    got, planes = phi_launch(pack, x)
    torch.cuda.synchronize()
    assert planes.shape == (3, q, -(-d // 64) * 64)
    for i, plane in enumerate(split_planes(x)):
        assert torch.equal(planes[i, :, :d].view(torch.int16),
                           plane.view(torch.int16))
    assert not planes[:, :, d:].any()
    tol = 1e-4 * _phi_scale(omega, degree, coef, x)
    for want in (fmbe_phi_planes_plain(pack, x), _phi64(pack, x)):
        assert ((got.double() - want).abs()
                <= tol + 1e-4 * want.abs()).all()


def _pinned_map(gen, degrees, d=D):
    deg = torch.tensor(degrees, dtype=torch.int32, device="cuda")
    p = deg.shape[0]
    omega = (2 * torch.randint(0, 2, (p, 8, d), generator=gen,
                               device="cuda") - 1).float()
    coef = torch.rand(p, generator=gen, device="cuda") * 0.01 + 1e-3
    return omega, deg, coef


@pytest.mark.parametrize("q", [8, 131])
@pytest.mark.parametrize("case", ["tile_edge", "zero_tile", "odd"])
def test_fmbe_phi_pack_layouts(gen, case, q):
    """The tensor-core kernel at pack layouts the FMBE draws rarely give
    (its epilogue unit is a warp's 8 rows of one 128-column tile):
    degree-8 features ending and starting at a tile boundary, and one that
    would cross the next boundary pushed past it ("tile_edge"); a
    column tile holding only degree-0 features, 128 of them, the most a
    tile takes ("zero_tile"); P off 128
    with every degree ("odd")."""
    if case == "tile_edge":
        degrees = [8] * 31 + [3, 8, 2, 0, 8]
    elif case == "zero_tile":
        degrees = [8] * 16 + [0] * 300
    else:
        degrees = [m % 9 for m in range(1000)]
    start, tile_j0, n_tiles = pack_layout(degrees, 8)
    if case == "tile_edge":
        assert start[15] == PACK_TILE - 8 and start[16] == PACK_TILE
        assert start[31:] == [2 * PACK_TILE - 8, 2 * PACK_TILE,
                              2 * PACK_TILE + 8, -1, 2 * PACK_TILE + 10]
    if case == "zero_tile":
        assert n_tiles == 4 and tile_j0 == [0, 16, 144, 272, 316]
    omega, degree, coef = _pinned_map(gen, degrees)
    x = (torch.randn(q, D, generator=gen, device="cuda") * 0.02
         ).to(torch.bfloat16)
    pack = fmbe_pack(omega, degree, coef)
    assert pack.rows.shape[0] == n_tiles * PACK_TILE
    _check_phi(omega, degree, coef, x, pack)


def test_fmbe_phi_refuses_a_pack_of_other_tensors(gen):
    """The tensor-core kernel reads the pack's rows, degree and coef, so a
    pack made from another coef, another map of the same P, or an omega
    changed since raises instead of returning that map's phi."""
    omega, degree, coef = _feature_map(gen, 300)
    x = (torch.randn(8, D, generator=gen, device="cuda") * 0.02
         ).to(torch.bfloat16)
    pack = fmbe_pack(omega, degree, coef)
    before = _counts(fmbe_phi)
    for args in ((omega, degree, coef * 2), _feature_map(gen, 300)):
        with pytest.raises(ValueError, match="another omega, degree or coef"):
            fmbe_phi(*args, x, pack=pack)
    omega[0, 0].neg_()
    with pytest.raises(ValueError, match="another omega, degree or coef"):
        fmbe_phi(omega, degree, coef, x, pack=pack)
    assert _counts(fmbe_phi) == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("q,p", [(8, 4096), (5, 1000), (13, 70), (1, 4096)])
def test_fmbe_z_matches_plain(gen, q, p, shared, dtype):
    """The tensor-core kernel on the map's pack, with and without the pack
    passed: x at the final norm's scale (|x|_2 about 50): products of up
    to 8 projections reach about 1e13 before coef. P not a multiple of 16
    or of the 128-column tile, features of degree 0 and 8, lambda shared
    and per query; z to 1e-4 of sum_j |phi_j lambda_j| (+1e-6) of float64
    and of the pack's decomposition (f32: of its planes), and at bf16 of
    the plain version, two calls bit-equal. At f32 the plain version's
    own f32 products are held to nothing here: at this scale their error
    reaches the tolerance (0.23 of it against float64 where the kernel's
    is 0.09, tools/fmbe_z_error.py), so float64 takes its place."""
    omega, degree, coef = _feature_map(gen, p)
    pack = fmbe_pack(omega, degree, coef)
    x = torch.randn(q, D, generator=gen, device="cuda").to(dtype)
    lam = torch.randn((p,) if shared else (q, p), generator=gen,
                      device="cuda")
    before = _counts(fmbe_z)
    got = fmbe_z(omega, degree, coef, lam, x, pack=pack)
    again = fmbe_z(omega, degree, coef, lam, x, pack=pack)
    unpacked = fmbe_z(omega, degree, coef, lam, x)
    torch.cuda.synchronize()
    _launched(fmbe_z, dtype, before, 3)
    assert torch.equal(got, again)                      # bit-reproducible
    assert torch.equal(got, unpacked)
    scale = (fmbe_phi_plain(omega, degree, coef, x) * lam).abs().sum(-1)
    assert torch.isfinite(got).all()
    wants = [_z64(pack, lam, x)]
    if dtype == torch.float32:
        wants.append(fmbe_z_planes_plain(pack, lam, x))
    else:
        wants += [fmbe_z_pack_plain(pack, lam, x),
                  fmbe_z_plain(omega, degree, coef, lam, x)]
    for want in wants:
        assert ((got.double() - want.double()).abs()
                <= 1e-4 * scale + 1e-6).all()


def _z64(pack, lam, x):
    """z in float64 from x and the pack's rows."""
    return (_phi64(pack, x) * lam.double()).sum(-1)


def test_fmbe_z_refuses_a_pack_of_other_tensors(gen):
    omega, degree, coef = _feature_map(gen, 300)
    pack = fmbe_pack(omega, degree, coef)
    x = torch.randn(4, D, generator=gen, device="cuda").bfloat16()
    lam = torch.randn(300, generator=gen, device="cuda")
    before = _counts(fmbe_z)
    with pytest.raises(ValueError, match="fmbe_z: the pack was made from "
                                         "another omega"):
        fmbe_z(omega, degree, coef * 2, lam, x, pack=pack)
    assert _counts(fmbe_z) == before


def _ce_inputs(gen, t, v, d, dtype=torch.bfloat16):
    """h at the final norm's scale, logits about N(0, 4), labels at V - 1
    and 0 first."""
    h = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(v, d, generator=gen, device="cuda") * 2 / d ** 0.5
         ).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[0] = v - 1
    labels[1:2] = 0
    return h, w, labels


def _within_terms(name, got, want, terms, rel=GRAD_REL, mean_rel=GRAD_MEAN):
    """|got - want| / sum |terms|: at most ``rel``, ``mean_rel`` on average
    (an element with no terms must match exactly)."""
    ratio = (got - want).abs() / terms.clamp(min=1e-30)
    worst, mean = ratio.max().item(), ratio.mean().item()
    assert worst <= rel and mean <= mean_rel, (name, worst, mean)


def _check_fused_ce(gen, t, v, d, selfnorm, dtype=torch.bfloat16):
    h, w, labels = _ce_inputs(gen, t, v, d, dtype)
    before = (_counts(fused_ce_fwd), _counts(fused_ce_bwd))
    nll, lse = fused_ce_fwd(h, w, labels)
    nll2, lse2 = fused_ce_fwd(h, w, labels)
    torch.cuda.synchronize()
    assert torch.equal(nll, nll2) and torch.equal(lse, lse2)
    p_nll, p_lse = fused_ce_fwd_plain(h, w, labels)
    assert (nll - p_nll).abs().max().item() <= TOL
    assert (lse - p_lse).abs().max().item() <= TOL
    # cotangents of the mean nll and of the selfnorm penalty 0.1 mean lse**2
    g_nll = torch.full((t,), 1.0 / t, device="cuda")
    g_lse = 2 * 0.1 * lse / t if selfnorm else torch.zeros_like(lse)
    dh, dw = fused_ce_bwd(h, w, labels, lse, g_nll, g_lse, cast=False)
    dh2, dw2 = fused_ce_bwd(h, w, labels, lse, g_nll, g_lse, cast=False)
    torch.cuda.synchronize()
    assert torch.equal(dh, dh2) and torch.equal(dw, dw2)   # no atomics
    _launched(fused_ce_fwd, dtype, before[0], 2)
    _launched(fused_ce_bwd, dtype, before[1], 2)
    p_dh, p_dw = fused_ce_bwd_plain(h, w, labels, lse, g_nll, g_lse,
                                    cast=False)
    coef = ce_coef(h, w, labels, lse, g_nll, g_lse).abs()
    assert dh.shape == (t, d) and dw.shape == (v, d)
    limits = ((F32_GRAD_REL, F32_GRAD_MEAN) if dtype == torch.float32
              else (GRAD_REL, GRAD_MEAN))
    _within_terms("dh", dh, p_dh, coef @ w.float().abs(), *limits)
    _within_terms("dw", dw, p_dw, coef.T @ h.float().abs(), *limits)
    cdh, cdw = fused_ce_bwd(h, w, labels, lse, g_nll, g_lse)
    assert cdh.dtype == dtype and cdw.dtype == dtype
    assert torch.equal(cdh, dh.to(dtype))
    assert torch.equal(cdw, dw.to(dtype))


@pytest.mark.parametrize("selfnorm", [False, True])
@pytest.mark.parametrize("d", [64, D])
@pytest.mark.parametrize("v", [1000, 151936])
@pytest.mark.parametrize("t", [1, 37, 129, 1024])
def test_fused_ce_matches_plain(gen, t, v, d, selfnorm):
    _check_fused_ce(gen, t, v, d, selfnorm)


def _chunk(t, dtype=torch.bfloat16):
    return bwd_schedule(t, 151936, dtype)["chunk"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, D])
@pytest.mark.parametrize("t,v", [(129, "C+1"), (1024, "C+1"),
                                 (1024, "3C-5")])
def test_fused_ce_crosses_chunk_edges(gen, t, v, d, dtype):
    """V = C + 1 leaves a one-column last chunk (and a 1-row vocab tile);
    3 C - 5 a ragged one; T = 129 a one-row token tile. C is the chunk of
    the dtype (16384 columns at T 1024 in bf16, 5376 in f32)."""
    c = _chunk(t, dtype)
    _check_fused_ce(gen, t, c + 1 if v == "C+1" else 3 * c - 5, d, True,
                    dtype)


@pytest.mark.parametrize("selfnorm", [False, True])
@pytest.mark.parametrize("t,v,d", [(129, 1000, 64), (129, 151936 - 5, D),
                                   (1024, 151936, D), (37, 1000, D),
                                   (129, 1000, 100), (37, 151936 - 5, 100),
                                   (1024, 40000, 4), (4096, 151936, D),
                                   (16384, 32768, D)])
def test_fused_ce_f32_matches_plain(gen, t, v, d, selfnorm):
    """The f32 kernels (backward on three bf16 planes): T 129 leaves a
    one-row token tile, V 1000 and 151931 ragged vocab tiles and a ragged
    last chunk, d 100 and 4 a multiple of 4 but not of 32 (zeros in the
    planes past d), labels at 0 and V - 1; T 4096 is one train_4k sequence
    (dW's sums F32_MAX_DEPTH / 2 deep), T 16384 two token slices; dh and dW
    to F32_GRAD_REL of the sum of their terms."""
    _check_fused_ce(gen, t, v, d, selfnorm, torch.float32)


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_fused_ce_f32_matches_float64(gen, scale):
    """The f32 backward against float64 at logits about N(0, 4), N(0, 16)
    and N(0, 64) (W scaled by 1, 2 and 4; T 1024, V 40000, d 2560): dh and
    dW to F32_GRAD_REL of the sum of their terms, F32_GRAD_MEAN on average.
    A score's error is its coefficient's relative error, so large logits
    test how the scores are summed. The plain f32 version itself leaves the
    mean limit at the largest scale, so the kernel is held to float64."""
    t = 1024
    h, w, labels = _ce_inputs(gen, t, 40000, D, torch.float32)
    w = w * scale
    lse = fused_ce_fwd(h, w, labels)[1]
    g_nll = torch.full((t,), 1.0 / t, device="cuda")
    g_lse = 0.2 * lse / t
    dh, dw = fused_ce_bwd(h, w, labels, lse, g_nll, g_lse)
    h64, w64 = h.double(), w.double()
    coef = torch.exp(h64 @ w64.T - lse.double()[:, None]) \
        * (g_nll + g_lse).double()[:, None]
    coef[torch.arange(t, device="cuda"), labels.long()] -= g_nll.double()
    want_dh, want_dw = coef @ w64, coef.T @ h64
    coef.abs_()
    _within_terms("dh", dh.double(), want_dh, coef @ w64.abs(),
                  F32_GRAD_REL, F32_GRAD_MEAN)
    _within_terms("dw", dw.double(), want_dw, coef.T @ h64.abs(),
                  F32_GRAD_REL, F32_GRAD_MEAN)


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_fused_ce_fwd_f32_matches_float64(gen, scale):
    """The f32 forward against float64 at logits about N(0, 4), N(0, 16)
    and N(0, 64) (W scaled by 1, 2 and 4; T 1024, V 40000, d 2560): nll and
    lse within 1e-5 of 1 + |value|. Its scores feed exp, so their error is
    the LSE's; the plain f32 version's error is printed beside."""
    t = 1024
    h, w, labels = _ce_inputs(gen, t, 40000, D, torch.float32)
    w = w * scale
    got = fused_ce_fwd(h, w, labels)
    logits = h.double() @ w.double().T
    lse = torch.logsumexp(logits, -1)
    want = (lse - logits.gather(1, labels.long()[:, None])[:, 0], lse)
    del logits

    def err(out):
        return max(((g.double() - x).abs() / (1 + x.abs())).max().item()
                   for g, x in zip(out, want))
    kernel, plain = err(got), err(fused_ce_fwd_plain(h, w, labels))
    print(f"scale {scale}: kernel {kernel:.3e}, plain f32 {plain:.3e} of "
          f"1 + |value| from float64")
    assert kernel <= 1e-5, (kernel, plain)
    p_nll, p_lse = fused_ce_fwd_planes_plain(h, w, labels)
    assert (got[0] - p_nll).abs().max().item() <= TOL
    assert (got[1] - p_lse).abs().max().item() <= TOL


@pytest.mark.parametrize("t,v,d", [(1024, 40000, D), (37, 1001, 100),
                                   (1, 130, 4)])
def test_fused_ce_fwd_split_matches_split_planes(gen, t, v, d):
    """The planes the f32 forward read (its own ``ce_split``, h into
    (3, T, dp) and w into (3, V, dp)) are ``split_planes``'s bit for bit,
    zeros past d, and the call counts no launch."""
    h, w, labels = _ce_inputs(gen, t, v, d, torch.float32)
    before = _counts(fused_ce_fwd)
    nll, lse, planes = fwd_launch(h, w, labels)
    torch.cuda.synchronize()
    assert _counts(fused_ce_fwd) == before
    dp = -(-d // 64) * 64
    for x, got in zip((h, w), planes):
        assert got.shape == (3, x.shape[0], dp)
        for q, plane in enumerate(split_planes(x)):
            assert torch.equal(got[q, :, :d].view(torch.int16),
                               plane.view(torch.int16))
        assert not got[:, :, d:].any()
    assert torch.equal(nll, fused_ce_fwd(h, w, labels)[0])
    if d % 32 == 0:                                     # bf16 reads no planes
        assert fwd_launch(h.bfloat16(), w.bfloat16(), labels)[2] is None


@pytest.mark.parametrize("t,v,d,depth", [(1024, 5000, 100, 400),
                                         (129, 1000, 64, 64)])
def test_fused_ce_f32_token_slices(gen, t, v, d, depth):
    """The f32 backward in token slices of at most ``depth`` tokens (three
    of 342, 342 and 340; three of 43), each adding its dW to the earlier
    ones': bit-equal over two calls, dh and dW to F32_GRAD_REL of the sum
    of their terms of the plain version, and no launch counted."""
    h, w, labels = _ce_inputs(gen, t, v, d, torch.float32)
    lse = fused_ce_fwd(h, w, labels)[1]
    g_nll = torch.full((t,), 1.0 / t, device="cuda")
    args = (h, w, labels, lse, g_nll, 0.2 * lse / t)
    before = fused_ce_bwd.launches
    dh, dw = bwd_launch(*args, depth=depth)
    dh2, dw2 = bwd_launch(*args, depth=depth)
    torch.cuda.synchronize()
    assert fused_ce_bwd.launches == before
    assert torch.equal(dh, dh2) and torch.equal(dw, dw2)
    p_dh, p_dw = fused_ce_bwd_plain(*args)
    coef = ce_coef(*args).abs()
    _within_terms("dh", dh, p_dh, coef @ w.abs(), F32_GRAD_REL,
                  F32_GRAD_MEAN)
    _within_terms("dw", dw, p_dw, coef.T @ h.abs(), F32_GRAD_REL,
                  F32_GRAD_MEAN)


@pytest.mark.parametrize("r,d,rows", [(1024, D, 1024), (5376, D, 5376),
                                      (1, 4, 64), (129, 100, 200),
                                      (37, 2564, 37)])
def test_split_kernel_matches_split_planes(gen, r, d, rows):
    """The backward's split kernel on values whose magnitudes spread over
    2**-30 .. 2**30, with +0 and -0: the planes are ``split_planes``'s bit
    for bit, zeros past the R given rows and past d (to whole 64-column
    boxes), and sum back to x exactly."""
    mag = torch.exp2(torch.randint(-30, 31, (r, d), generator=gen,
                                   device="cuda").float())
    x = torch.randn(r, d, generator=gen, device="cuda") * mag
    x.view(-1)[:2] = torch.tensor([0.0, -0.0], device="cuda")
    got = planes_launch(x, rows)
    torch.cuda.synchronize()
    dp = -(-d // 64) * 64
    assert got.shape == (3, rows, dp) and got.dtype == torch.bfloat16
    want = torch.zeros_like(got)
    for q, plane in enumerate(split_planes(x)):
        want[q, :r, :d] = plane
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    back = (got[0, :r, :d].float() + got[1, :r, :d].float()) \
        + got[2, :r, :d].float()
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))


@pytest.mark.parametrize("t,v,d", [(129, 1000, 64), (1024, 40000, D)])
def test_fused_ce_bwd_deals_agree(gen, t, v, d):
    """The dh and dW items dealt round-robin give the same bits as
    ``grad_order``'s longest-first lists, and no launch is counted."""
    h = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(v, d, generator=gen, device="cuda") * 2 / d ** 0.5
         ).bfloat16()
    labels = torch.randint(0, v, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    lse = fused_ce_fwd(h, w, labels)[1]
    args = (h, w, labels, lse, torch.full((t,), 1.0 / t, device="cuda"),
            0.2 * lse / t)
    before = fused_ce_bwd.launches
    for cast in (True, False):
        want = bwd_launch(*args, cast=cast)
        got = bwd_launch(*args, cast=cast, longest_first=False)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fused_ce_bwd.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take(gen):
    """f32 and bf16 are both taken; mixed dtypes, and dtypes no kernel
    has, raise a ValueError naming each input's dtype."""
    h = torch.randn(4, D, generator=gen, device="cuda")
    w = torch.randn(64, D, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="h torch.float32, w torch.bfloat16"):
        topk_z(h, w.bfloat16(), 4)                      # mixed
    with pytest.raises(ValueError, match="float16"):
        topk_z(h.half(), w.half(), 4)
    with pytest.raises(ValueError, match="k="):
        topk_z(h.bfloat16(), w.bfloat16(), 33)
    omega = torch.ones(16, 9, D, device="cuda")
    degree = torch.zeros(16, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="max_degree"):
        fmbe_phi(omega, degree, torch.ones(16, device="cuda"), h.bfloat16())
    with pytest.raises(ValueError, match="bf16 or f32 x"):
        fmbe_z(omega[:, :8].contiguous(), degree,
               torch.ones(16, device="cuda"), torch.ones(16, device="cuda"),
               h.half())                                # float16 x
    with pytest.raises(ValueError, match="not exact in bf16"):
        fmbe_phi(omega[:, :8] * 0.3, degree + 1,
                 torch.ones(16, device="cuda"), h.bfloat16())
    with pytest.raises(ValueError, match="int32"):
        union_scores(w.bfloat16().reshape(1, 64, D), h.bfloat16(),
                     torch.zeros(1, dtype=torch.int64, device="cuda"),
                     torch.ones((), dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="w_blocks torch.float32"):
        union_scores(w.reshape(1, 64, D), h.bfloat16(),
                     torch.zeros(1, dtype=torch.int32, device="cuda"),
                     torch.ones((), dtype=torch.int32, device="cuda"))
    labels = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="h torch.bfloat16, w torch.float32"):
        fused_ce_fwd(h.bfloat16(), w, labels)           # mixed
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_ce_fwd(h[:, :48].bfloat16().contiguous(),
                     w[:, :48].bfloat16().contiguous(), labels)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_ce_fwd(h[:, :46].contiguous(), w[:, :46].contiguous(), labels)
    deep = F32_MAX_DEPTH + 32                           # f32 only
    with pytest.raises(ValueError, match=f"d={deep} exceeds F32_MAX_DEPTH="
                                         f"{F32_MAX_DEPTH}"):
        fused_ce_fwd(torch.ones(4, deep, device="cuda"),
                     torch.ones(64, deep, device="cuda"), labels)
    fused_ce_fwd(torch.ones(4, deep, device="cuda").bfloat16(),
                 torch.ones(64, deep, device="cuda").bfloat16(), labels)
    with pytest.raises(ValueError, match="multiple of 4"):
        planes_launch(h[:, :46].contiguous())
    with pytest.raises(ValueError, match="per-token"):
        fused_ce_fwd(h.bfloat16(), w.bfloat16(), labels[:3])
    with pytest.raises(ValueError, match="int32"):
        ivf_score(w.bfloat16().reshape(2, 32, D), h.bfloat16(),
                  torch.zeros((4, 1), dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError, match="tail_rows torch.bfloat16"):
        ivf_decode(w.reshape(2, 32, D), h,
                   torch.zeros(1, dtype=torch.int32, device="cuda"),
                   torch.ones((), dtype=torch.int32, device="cuda"),
                   torch.ones((4, 1), dtype=torch.bool, device="cuda"),
                   torch.zeros((2, 32), device="cuda"), w[:8].bfloat16(),
                   torch.ones((4, 8), dtype=torch.bool, device="cuda"))
    proj = torch.randn(2, 4, D + 1, generator=gen, device="cuda")
    ids = torch.zeros(8, dtype=torch.int32, device="cuda")
    codes = torch.zeros((64, 2), dtype=torch.int32, device="cuda")
    lsh_args = (ids, torch.tensor(8, dtype=torch.int32, device="cuda"),
                codes, codes, ids, torch.ones((4, 8), dtype=torch.bool,
                                              device="cuda"),
                torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError, match="w torch.bfloat16, h torch.float32"):
        lsh_probe(w.bfloat16(), h, proj, *lsh_args)     # mixed
    with pytest.raises(ValueError, match="K="):
        lsh_probe(w.bfloat16(), h.bfloat16(),
                  torch.randn(2, 25, D + 1, device="cuda"), *lsh_args)


def test_lsh_path_is_bit_equal_across_processes(gen):
    """Two processes of this tree, given the same seeds, give the same
    SHA-256 for every stage of the lsh path: the hidden states, the
    hyperplanes, scales, codes and tables, the query codes, the tail
    proposal's running mass and draw, the plan and ``lsh_probe``'s outputs,
    from the trunk's hidden states and from injected ones
    (``tools/stage_fingerprints.py --lsh-only``; it exits 1 if a stage
    differs)."""
    tool = Path(__file__).resolve().parents[1] / "tools" / \
        "stage_fingerprints.py"
    res = subprocess.run([sys.executable, str(tool), "--lsh-only"],
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "first stage of the path that differs: None" in res.stdout
