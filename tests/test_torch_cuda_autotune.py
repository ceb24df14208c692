"""The autotuner's launch knobs on the card, for the five tuned kernels at
both dtypes and the main path's shapes (qwen1.5-4b: d 2560, V 151936;
8 queries; a 128-slot union of 23 live blocks of 512 rows; 1000 tail
rows; 4096 FMBE features; an 8 x 8-bit LSH index of the head):

- every candidate of the sweep (``kernels.autotune``'s grid candidates)
  is held to the plain version: LSEs and scores to 1e-3, top ids where
  the neighbouring scores are more than 1e-3 apart, FMBE sums to 1e-4 of
  the sum of their terms' magnitudes; every grid of ``union_scores`` and
  ``fmbe_z``, whose outputs are each written by one thread from a sum in
  a fixed order, gives the default launch's bits;
- a knob left out is bit-equal to the knob at its default value;
- a launch the kernel refuses (rows too wide for its ring) raises a named
  error and leaves no CUDA error behind, and a sweep with such a candidate
  skips it, returns a clean candidate and records the refusal.

These tests need a GPU and skip without one:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_autotune.py
"""
import pytest
import torch

from repro_torch.core import lsh as tlsh
from repro_torch.core.feature_maps import make_feature_map
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as at
from repro_torch.kernels.fmbe import (fmbe_pack, fmbe_phi_plain, fmbe_z,
                                      fmbe_z_pack_plain, fmbe_z_planes_plain)
from repro_torch.kernels.ivf_score import (ivf_decode, ivf_decode_plain,
                                          union_scores, union_scores_plain)
from repro_torch.kernels.lsh_probe import lsh_probe, lsh_probe_plain
from repro_torch.kernels.topk_z import geometry, topk_z, topk_z_plain

pytestmark = pytest.mark.cuda
TOL = 1e-3
FMBE_REL = 1e-4
V, D, Q, K = 151936, 2560, 8, 8
NB, BR, U, LIVE, L = 300, 512, 128, 23, 1000
DTYPES = [torch.bfloat16, torch.float32]
DT = {torch.bfloat16: "bf16", torch.float32: "f32"}


@pytest.fixture(scope="module")
def ops():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in f32
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    w = torch.randn(V, D, generator=g, device=dev) * V ** -0.5
    h = torch.randn(16, D, generator=g, device=dev)
    blocks = torch.randn(NB, BR, D, generator=g, device=dev) * V ** -0.5
    ids = torch.sort(torch.randperm(NB, generator=g, device=dev)[:LIVE])[0]
    head_ids = torch.cat([ids, ids[-1:].expand(U - LIVE)]).int()
    member = torch.rand(Q, U, generator=g, device=dev) < 0.3
    row_logw = torch.where(torch.rand(NB, BR, generator=g, device=dev) < .05,
                           -1e30, 0.0).float()
    tail = torch.randn(L, D, generator=g, device=dev) * V ** -0.5
    accept = torch.rand(Q, L, generator=g, device=dev) < 0.9
    fm = make_feature_map(g, D, 4096, device=dev)
    lam = torch.randn(Q, 4096, generator=g, device=dev)
    lidx = tlsh.build_lsh_device(w.bfloat16(), n_bits=8, n_tables=8,
                                 generator=g, device=dev)
    return dict(w=w, h=h, blocks=blocks, head_ids=head_ids,
                live=torch.tensor(LIVE, dtype=torch.int32, device=dev),
                member=member, row_logw=row_logw, tail=tail, accept=accept,
                fm=fm, pack=fmbe_pack(fm.omega, fm.degree, fm.coef), lam=lam,
                lidx=lidx)


def _in(ops, dtype):
    w, h = ops["w"].to(dtype), ops["h"][:Q].to(dtype)
    return w, h


def _case(name, ops, dtype):
    """(kernel call taking knobs, plain outputs, candidates, the default
    knobs, whether every candidate keeps the default's bits)."""
    w, h = _in(ops, dtype)
    dev = h.device
    if name == "topk_z":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        dflt = geometry(Q, V, D, dtype, sms)["grid_x"]
        grids = at.grid_candidates(
            dev, dflt, lambda g: geometry(Q, V, D, dtype, sms, g)["grid_x"])
        return (lambda **kw: topk_z(h, w, K, **kw),
                topk_z_plain(h, w, K), [{"grid_x": g} for g in grids],
                {"grid_x": dflt}, False)
    if name == "lsh_probe":
        lidx = ops["lidx"]
        plan = tlsh.lsh_plan(lidx, h, L, generator=torch.Generator(
            device=dev).manual_seed(1))
        rows, live = tlsh.device_cands(plan)
        args = (w, h, lidx.proj, rows, live, lidx.codes, lidx.slot_of_row,
                plan.tail_ids, plan.tail_accept, plan.tail_bias)
        return (lambda **kw: lsh_probe(*args, k=K, **kw)[:4],
                lsh_probe_plain(*args, k=K)[:4], at._stream_cands(dev),
                {"grid_x": _build.stream_grid(dev)}, False)
    blocks = ops["blocks"].to(dtype)
    if name == "union_scores":
        args = (blocks, h, ops["head_ids"], ops["live"])
        return (lambda **kw: (union_scores(*args, **kw),),
                (union_scores_plain(*args),),
                at._stream_cands(dev), {"grid_x": _build.stream_grid(dev)},
                True)
    if name == "ivf_decode":
        args = (blocks, h, ops["head_ids"], ops["live"], ops["member"],
                ops["row_logw"], ops["tail"].to(dtype), ops["accept"])
        return (lambda **kw: ivf_decode(*args, k=K, **kw),
                ivf_decode_plain(*args, k=K), at._stream_cands(dev),
                {"grid_x": _build.stream_grid(dev)}, False)
    fm, pack, lam = ops["fm"], ops["pack"], ops["lam"]
    want = (fmbe_z_planes_plain(pack, lam, h) if dtype == torch.float32
            else fmbe_z_pack_plain(pack, lam, h))
    return (lambda **kw: (fmbe_z(fm.omega, fm.degree, fm.coef, lam, h,
                                 pack=pack, **kw),),
            (want,), at._stream_cands(dev),
            {"grid_x": _build.stream_grid(dev)}, True)


def _hold(name, got, want, ops, dtype):
    if name == "fmbe_z":
        fm = ops["fm"]
        h = ops["h"][:Q].to(dtype)
        terms = (fmbe_phi_plain(fm.omega, fm.degree, fm.coef, h) *
                 ops["lam"]).abs().sum(-1)
        assert ((got[0].double() - want[0].double()).abs()
                <= FMBE_REL * terms + 1e-6).all()
        return
    if name == "union_scores":
        assert ((got[0] - want[0]).abs() <= TOL).all()
        return
    *lses, topv, topi = got
    *w_lses, w_topv, w_topi = want
    for a, b in zip(lses, w_lses):
        assert torch.equal(a.isneginf(), b.isneginf())
        fin = ~b.isneginf()
        assert ((a[fin] - b[fin]).abs() <= TOL).all()
    assert ((topv - w_topv).abs() <= TOL).all()
    gap = torch.cat([w_topv[:, :-1] - w_topv[:, 1:],
                     torch.full_like(w_topv[:, :1], 1.0)], 1)
    prev = torch.cat([torch.full_like(w_topv[:, :1], 1.0),
                      w_topv[:, :-1] - w_topv[:, 1:]], 1)
    sep = (gap > TOL) & (prev > TOL)
    assert torch.equal(topi[sep], w_topi.to(topi.dtype)[sep])


NAMES = ["topk_z", "ivf_decode", "union_scores", "fmbe_z", "lsh_probe"]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: DT[d])
@pytest.mark.parametrize("name", NAMES)
def test_every_candidate_holds_to_plain(ops, name, dtype):
    call, want, cands, dflt, same_bits = _case(name, ops, dtype)
    base = call()
    assert len(cands) >= 2 and cands[0] == dflt
    for cfg in cands:
        got = call(**cfg)
        torch.cuda.synchronize()
        _hold(name, got, want, ops, dtype)
        if same_bits or cfg.get("grid_x") == dflt["grid_x"]:
            assert all(torch.equal(a, b) for a, b in zip(got, base)), cfg
        assert all(torch.equal(a, b) for a, b in zip(call(**cfg), got)), \
            cfg                                   # two calls bit-equal


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: DT[d])
@pytest.mark.parametrize("name", NAMES)
def test_knob_left_out_is_the_default(ops, name, dtype):
    call, _, _, dflt, _ = _case(name, ops, dtype)
    got, want = call(), call(**dflt)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: DT[d])
def test_refused_candidate_leaves_no_error(ops, dtype, tmp_path):
    """Rows too wide for the ring (d 65536) make ``union_scores_launch``
    return cudaErrorInvalidValue: a named RuntimeError, nothing left in the
    library's error state, and a sweep that skips it."""
    dev = ops["h"].device
    wide = torch.zeros((2, 4, 65536), dtype=dtype, device=dev)
    hw = torch.zeros((8, 65536), dtype=dtype, device=dev)
    ids = torch.zeros((2,), dtype=torch.int32, device=dev)
    live = torch.tensor(2, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="union_scores kernel launch"):
        union_scores(wide, hw, ids, live)
    torch.cuda.synchronize()
    assert _build.last_error("union_scores") == 0
    _, h = _in(ops, dtype)
    blocks = ops["blocks"].to(dtype)
    args = (blocks, h, ops["head_ids"], ops["live"])

    def build(cfg):
        if cfg.get("wide"):
            return lambda: union_scores(wide, hw, ids, live)
        return lambda: union_scores(*args, **cfg)

    best = at.autotune("union_scores",
                       [{"wide": 1}, {"grid_x": _build.stream_grid(dev)}],
                       build, (blocks, h, "refusal"), reps=2,
                       path=str(tmp_path / "cache.json"))
    assert best == {"grid_x": _build.stream_grid(dev)}
    swept = at.LAST["union_scores"]["swept"]
    assert "RuntimeError" in swept[0]["error"] and swept[1]["ms"] > 0
    got = union_scores(*args)
    torch.cuda.synchronize()
    assert ((got - union_scores_plain(*args)).abs() <= TOL).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: DT[d])
def test_tuners_sweep_and_cache(ops, dtype, tmp_path):
    """Each ``tune_*`` returns one of its candidates, cached: a second call
    reads the cache without a sweep. Prints each sweep (``-s``): every
    candidate's ms a call in a burst, with the card's name."""
    path = str(tmp_path / "cache.json")
    w, h = _in(ops, dtype)
    fm, lidx = ops["fm"], ops["lidx"]
    blocks = ops["blocks"].to(dtype)
    calls = {
        "topk_z": lambda: at.tune_topk_z(h, w, K, path=path),
        "union_scores": lambda: at.tune_union_scores(
            blocks, h, ops["head_ids"], ops["live"], path=path),
        "ivf_decode": lambda: at.tune_ivf_decode(
            blocks, h, ops["head_ids"], ops["live"], ops["member"],
            ops["row_logw"], ops["tail"].to(dtype), ops["accept"], k=K,
            path=path),
        "fmbe_z": lambda: at.tune_fmbe_z(fm.omega, fm.degree, fm.coef,
                                         ops["lam"], h, pack=ops["pack"],
                                         path=path),
        "lsh_probe": lambda: at.tune_lsh_probe(
            lidx, w, h, l=L, k=K, path=path,
            generator=torch.Generator(device=h.device).manual_seed(1)),
    }
    card = torch.cuda.get_device_name(h.device)
    for name, fn in calls.items():
        cfg = fn()
        rec = at.LAST[name]
        assert rec["hit"] is False and cfg
        assert cfg in [c["config"] for c in rec["swept"]]
        print(f"sweep {name} {DT[dtype]} [{card}]: " + "; ".join(
            f"{c['config']} {c.get('ms', c.get('error'))}"
            for c in rec["swept"]) + f" -> {cfg}")
        assert fn() == cfg and at.LAST[name]["hit"] is True
