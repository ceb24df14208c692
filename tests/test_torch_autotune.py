"""The port's kernel autotuner (``repro_torch.kernels.autotune``), mirroring
tests/test_autotune.py: the sweep, the cache hit without a sweep, failing
candidates, the cache key (shapes, dtypes, device name, the kernels'
source hash); on the CPU every ``tune_*`` returns {} and every wrapper and
backend decode takes the launch knobs and gives what it gives without
them; an autotuned CPU engine keeps ``kernel_cfg == {}`` and generates an
untuned engine's tokens."""
import dataclasses
import json
import os
import shutil

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import PartitionConfig
from repro_torch.core import decode as tdecode
from repro_torch.core import lsh as tlsh
from repro_torch.core.backends import BACKENDS, get_backend
from repro_torch.core.feature_maps import make_feature_map
from repro_torch.core.mips import build_ivf
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as at
from repro_torch.kernels.fmbe import fmbe_pack, fmbe_z
from repro_torch.kernels.ivf_score import ivf_decode, union_scores
from repro_torch.kernels.lsh_probe import lsh_probe
from repro_torch.kernels.topk_z import topk_z
from repro_torch.models import Model
from repro_torch.models.transformer import torch_dtype
from repro_torch.serve import Engine, generate

KNOBS = {"grid_x": 3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and beside other test workers on the same cores more threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _busy(n=40_000):
    return sum(i * i for i in range(n))


class TestAutotuneCore:
    def test_picks_fastest_and_caches(self, tmp_path):
        path = str(tmp_path / "cache.json")
        calls = []

        def build(cfg):
            def run():
                calls.append(cfg["x"])
                if cfg["x"] != 2:           # the "fast" config does no work
                    _busy()
            return run

        cands = [{"x": 1}, {"x": 2}, {"x": 3}]
        args = (torch.zeros((4, 8)),)
        assert at.autotune("fake", cands, build, args, reps=2,
                           path=path) == {"x": 2}
        rec = json.load(open(path))
        (entry,) = rec.values()
        assert entry["config"] == {"x": 2}
        assert [s["config"] for s in entry["swept"]] == cands
        assert all(s["ms"] > 0 for s in entry["swept"])
        assert at.LAST["fake"]["hit"] is False

    def test_cache_hit_runs_no_sweep(self, tmp_path):
        path = str(tmp_path / "cache.json")
        calls = []

        def build(cfg):
            return lambda: calls.append(cfg["x"])

        args = (torch.zeros((2, 2)),)
        first = at.autotune("hit", [{"x": 1}, {"x": 2}], build, args,
                            reps=1, path=path)
        calls.clear()
        assert at.autotune("hit", [{"x": 1}, {"x": 2}], build, args,
                           reps=1, path=path) == first
        assert calls == []
        assert at.LAST["hit"]["hit"] is True

    def test_failing_candidates_skipped(self, tmp_path):
        path = str(tmp_path / "cache.json")

        def build(cfg):
            def run():
                if cfg["x"] != 1:
                    raise RuntimeError("the launch was refused")
            return run

        best = at.autotune("flaky", [{"x": 0}, {"x": 1}, {"x": 2}], build,
                           (torch.zeros((2,)),), reps=1, path=path)
        assert best == {"x": 1}
        swept = next(iter(json.load(open(path)).values()))["swept"]
        assert sum("error" in r for r in swept) == 2
        assert "RuntimeError" in swept[0]["error"]

    def test_all_failing_returns_first_default(self, tmp_path):
        path = str(tmp_path / "cache.json")

        def build(cfg):
            def run():
                raise RuntimeError("no")
            return run

        best = at.autotune("dead", [{"x": 5}, {"x": 6}], build,
                           (torch.zeros(()),), reps=1, path=path)
        assert best == {"x": 5}
        assert not os.path.exists(path)    # nothing worth caching

    def test_cache_key_varies_with_shape_dtype_kernel_extra(self):
        a32 = torch.zeros((4, 8))
        k1 = at.cache_key("k", (a32,))
        assert k1 != at.cache_key("k", (a32.bfloat16(),))
        assert k1 != at.cache_key("k", (torch.zeros((8, 8)),))
        assert k1 != at.cache_key("other", (a32,))
        assert k1 != at.cache_key("k", (a32,), extra="e")
        assert at.cache_key("k", (a32, 7)) != at.cache_key("k", (a32, 8))
        assert k1 == at.cache_key("k", (torch.zeros((4, 8)),))
        assert torch.__version__ in k1

    def test_cache_key_changes_with_device_name(self, monkeypatch):
        args = (torch.zeros((4, 8)),)
        k1 = at.cache_key("ivf_decode", args)
        monkeypatch.setattr(at, "device_name", lambda dev: "another card")
        assert at.cache_key("ivf_decode", args) != k1

    def test_cache_key_changes_with_library_hash(self, monkeypatch,
                                                 tmp_path):
        args = (torch.zeros((4, 8)),)
        k1 = at.cache_key("union_scores", args)
        assert at.library_hash("union_scores") != \
            at.library_hash("ivf_decode")
        assert at.library_hash("not a kernel") == "none"
        # a kernel whose sources change (a header here) keys anew
        csrc = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        monkeypatch.setattr(_build, "CSRC", csrc)
        assert at.cache_key("union_scores", args) == k1
        with open(csrc / "gather_stream.cuh", "a") as f:
            f.write("\n// changed\n")
        assert at.cache_key("union_scores", args) != k1

    def test_cache_path_from_environment(self, monkeypatch, tmp_path):
        monkeypatch.setenv(at.ENV, str(tmp_path / "c.json"))
        assert at.cache_path() == str(tmp_path / "c.json")
        assert at.cache_path("/elsewhere.json") == "/elsewhere.json"
        monkeypatch.delenv(at.ENV)
        assert at.cache_path().endswith(
            os.path.join(".cache", "repro_torch", "autotune.json"))


# -- the kernels on CPU tensors -----------------------------------------------

@pytest.fixture(scope="module")
def ops():
    """CPU operands of the five tuned kernels."""
    g = torch.Generator().manual_seed(0)
    v = 0.3 * torch.randn((512, 32), generator=g)
    h = v[:8].clone()
    index = build_ivf(v, block_rows=64, generator=g, device="cpu")
    plan = tdecode.make_plan(index, h, 2, 16, generator=g)
    row_logw = torch.where(index.valid, 0.0, -1e30).float()
    ivf = (index.v_blocks, h, plan.head_ids, plan.head_live,
           plan.head_member, row_logw, tdecode._tail_rows(index, plan),
           plan.tail_accept)
    fm = make_feature_map(g, 32, 128, max_degree=3, device="cpu")
    lam = torch.randn((128,), generator=g)
    lsh_cfg = PartitionConfig(method="lsh", lsh_bits=4, l=16)
    lstate = get_backend("lsh").build(lsh_cfg, v, generator=g, device="cpu")
    return dict(v=v, h=h, ivf=ivf, fm=fm, lam=lam, lstate=lstate,
                lsh_cfg=lsh_cfg)


def _kernel_call(name, ops, **knobs):
    h = ops["h"]
    if name == "ivf_decode":
        return ivf_decode(*ops["ivf"], k=4, **knobs)
    if name == "union_scores":
        return union_scores(*ops["ivf"][:4], **knobs)
    if name == "topk_z":
        return topk_z(h, ops["v"], 4, **knobs)
    if name == "fmbe_z":
        fm = ops["fm"]
        return fmbe_z(fm.omega, fm.degree, fm.coef, ops["lam"], h,
                      pack=fmbe_pack(fm.omega, fm.degree, fm.coef), **knobs)
    st = ops["lstate"]
    lsh = st.lsh
    lp = tlsh.lsh_plan(lsh, h, 16, generator=torch.Generator().manual_seed(3))
    rows, live = tlsh.device_cands(lp)
    return lsh_probe(st.w, h, lsh.proj, rows, live, lsh.codes,
                     lsh.slot_of_row, lp.tail_ids, lp.tail_accept,
                     lp.tail_bias, k=4, **knobs)


TUNED = ["ivf_decode", "union_scores", "topk_z", "fmbe_z", "lsh_probe"]


@pytest.mark.parametrize("name", TUNED)
def test_cpu_call_with_knobs_equals_without(ops, name):
    got = _kernel_call(name, ops, **KNOBS)
    want = _kernel_call(name, ops)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("name", TUNED)
def test_tune_returns_nothing_on_the_cpu(ops, name, tmp_path):
    path = str(tmp_path / "cache.json")
    h = ops["h"]
    if name == "ivf_decode":
        got = at.tune_ivf_decode(*ops["ivf"], path=path)
    elif name == "union_scores":
        got = at.tune_union_scores(*ops["ivf"][:4], path=path)
    elif name == "topk_z":
        got = at.tune_topk_z(h, ops["v"], 4, path=path)
    elif name == "fmbe_z":
        fm = ops["fm"]
        got = at.tune_fmbe_z(fm.omega, fm.degree, fm.coef, ops["lam"], h,
                             path=path)
    else:
        st = ops["lstate"]
        got = at.tune_lsh_probe(st.lsh, st.w, h, l=16, path=path)
    assert got == {}
    assert not os.path.exists(path)


# -- the backends -------------------------------------------------------------

@pytest.mark.parametrize("method", sorted(BACKENDS))
def test_backend_tune_and_knobbed_decode(ops, method, tmp_path):
    """``tune`` returns kwargs its ``decode`` accepts ({} on the CPU), and
    a decode given every knob (some its kernel does not take, which it
    drops) equals one without, on the same draws."""
    cfg = PartitionConfig(method=method, block_rows=64, n_probe=2, l=16,
                          n_clusters=0, fmbe_features=128,
                          fmbe_max_degree=3, lsh_bits=4)
    bk = get_backend(method)
    state = bk.build(cfg, ops["v"], generator=torch.Generator().manual_seed(1),
                     device="cpu")
    h = ops["h"]
    kcfg = bk.tune(state, cfg, h, generator=torch.Generator().manual_seed(2),
                   path=str(tmp_path / "cache.json"))
    assert kcfg == {}

    def run(**kw):
        return bk.decode(state, h, cfg, k=4,
                         generator=torch.Generator().manual_seed(5), **kw)

    ref = run()
    for kw in (kcfg, KNOBS, dict(KNOBS, stages=2, block_q=8)):
        out = run(**kw)
        for name in ("log_z", "top_score", "top_id"):
            assert torch.equal(getattr(out, name), getattr(ref, name)), \
                (method, kw, name)


def test_engine_autotune_on_the_cpu_keeps_nothing():
    cfg = reduced_config("qwen1.5-4b")
    cfg = dataclasses.replace(cfg, vocab=1024, partition=dataclasses.replace(
        cfg.partition, block_rows=64, n_probe=4, l=64))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    prompt = torch.tensor([[3, 5, 7], [11, 13, 17]])
    tuned = Engine(model, params, 16, seed=1, device="cpu", autotune=True,
                   autotune_batch=16)
    plain = Engine(model, params, 16, seed=1, device="cpu")
    assert tuned.kernel_cfg == {} and plain.kernel_cfg == {}
    assert torch.equal(generate(tuned, prompt, 4), generate(plain, prompt, 4))


def test_query_tiles():
    assert [at.query_tiles(q) for q in (1, 8, 9, 16, 17, 64, 65)] == \
        [1, 1, 2, 2, 3, 8, 9]


def test_engine_tunes_and_picks_by_query_tiles(monkeypatch):
    """``Engine._tune`` runs the backend's ``tune`` once a query-tile count
    up to the batch's, on the first rows of one seeded batch; ``knobs``
    picks a decode's by its rows' tile count ({} where none were tuned),
    and ``next_token_distribution`` hands them to the decode."""
    cfg = reduced_config("qwen1.5-4b")
    cfg = dataclasses.replace(cfg, vocab=1024, partition=dataclasses.replace(
        cfg.partition, block_rows=64, n_probe=4, l=64))
    model = Model(cfg)
    eng = Engine(model, model.init(torch.Generator().manual_seed(0), "cpu"),
                 16, seed=1, device="cpu")
    seen = []

    def tune(state, pc, h, *, generator=None, path=None):
        seen.append(h)
        return {"grid_x": h.shape[0]}

    monkeypatch.setattr(eng.backend, "tune", tune)
    eng.kernel_cfg = eng._tune(20)
    assert eng.kernel_cfg == {1: {"grid_x": 8}, 2: {"grid_x": 16},
                              3: {"grid_x": 20}}
    assert all(torch.equal(a, seen[-1][:a.shape[0]]) for a in seen)
    assert [eng.knobs(q) for q in (1, 8, 9, 20, 24, 25)] == [
        {"grid_x": 8}, {"grid_x": 8}, {"grid_x": 16}, {"grid_x": 20},
        {"grid_x": 20}, {}]
    got = []
    decode = eng.backend.decode
    monkeypatch.setattr(eng.backend, "decode", lambda *a, **kw: (
        got.append({k: kw[k] for k in kw if k == "grid_x"}),
        decode(*a, **kw))[1])
    h = torch.zeros((12, cfg.d_model), dtype=torch_dtype(cfg.dtype))
    eng.next_token_distribution(h)
    eng.next_token_distribution(h[:3])
    eng.next_token_distribution(h, tier="exact")
    assert got == [{"grid_x": 16}, {"grid_x": 8}]
