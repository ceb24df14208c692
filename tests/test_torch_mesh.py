"""The port's serving mesh on the CPU (gloo), against one device and JAX.

In-process units: ``best_mesh_shape``, the least-loaded replica routing
and FIFO at one replica (JAX's ``TestSlotRouting``), the local-shard rule
(only ``w`` and ``v_blocks`` split; an indivisible payload stays whole),
``serve_cache_spec``'s lane axes, ``Engine(mesh=)``'s validations, the
word view of ``bitsum_`` and the prefix pool's replica-local allocation and
owners against JAX's ``PrefixPool(n_replicas=2)`` on the same operations.

One spawn of four ranks (``tests/_torch_mesh_rank.py``, a gloo group over
a ``FileStore`` with a 60 s timeout, joined with a deadline) runs the mesh
shapes (1, 4), (2, 2) and (4, 1) over the same ranks and writes each rank's
results under ``tmp_path``; each check below is its own test over them:

* every method's ``shard_decode`` bit for bit against the single-device
  decode of a mesh-free engine (``exact``/``selfnorm``: ids and scores
  bit for bit, log Z within 1e-5), through the kernel wrappers (their
  plain versions on the CPU) and the reference branches;
* ``logspace_psum``, ``sharded_exact_log_z``, ``sharded_top_k`` and
  ``sharded_mimps_log_z`` against JAX's ``logsumexp``/``top_k`` on the
  same numpy inputs (JAX runs here, never in a child), and the rows'
  bit-pattern sum against a value sum;
* the mesh scheduler's tokens and log Z on a staggered trace equal to
  the one-device scheduler's (at (4, 1), one lane a replica, log Z within
  1e-5: a batch of one rounds otherwise), and its tokens to solo
  ``generate``; at
  (2, 2): a NaN lane under the guard; a ladder walk; speculation with the
  prefix pool; the server's look-ahead admission; the observability
  harvest; every rank's results the same.

The spawn takes about 15 s.
"""
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_rank as R
from repro.serve.prefix_cache import PrefixPool as JPrefixPool
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch.configs import reduced_config
from repro_torch.core.backends import BackendState, local_shard
from repro_torch.core.distributed import _words
from repro_torch.core.mips import IVFIndex
from repro_torch.launch.mesh import (batch_axis_for, best_mesh_shape,
                                     data_size, serve_cache_spec)
from repro_torch.serve import Engine, Scheduler
from repro_torch.serve.prefix_cache import PrefixPool

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 240


# -- in-process units ------------------------------------------------------


@pytest.mark.parametrize("n,mp,want", [(4, 4, (1, 4)), (4, 2, (2, 2)),
                                       (6, 4, (2, 3)), (1, 8, (1, 1)),
                                       (8, 3, (4, 2))])
def test_best_mesh_shape(n, mp, want):
    from repro.launch.mesh import best_mesh_shape as j_best
    assert best_mesh_shape(n, mp) == want == j_best(n, mp)


@pytest.mark.parametrize("data,batch,want", [(2, 8, "data"), (2, 7, None),
                                             (1, 3, "data")])
def test_batch_axis_for(data, batch, want):
    mesh = _fake_mesh(("data", "model"), (data, 2))
    assert data_size(mesh) == data
    assert batch_axis_for(mesh, batch) == want


def _router(n_replicas, lanes, free):
    return types.SimpleNamespace(n_replicas=n_replicas,
                                 lanes_per_replica=lanes, _free=list(free))


def test_least_loaded_replica_round_robin():
    s, j = _router(4, 2, range(8)), _router(4, 2, range(8))
    picks = [Scheduler._pick_slot(s) for _ in range(8)]
    assert picks == [JScheduler._pick_slot(j) for _ in range(8)] == \
        [0, 2, 4, 6, 1, 3, 5, 7]
    assert s._free == []


def test_preferred_replica_then_least_loaded():
    s, j = _router(2, 2, [1, 2, 3]), _router(2, 2, [1, 2, 3])
    assert Scheduler._pick_slot(s, 0) == JScheduler._pick_slot(j, 0) == 1
    assert Scheduler._pick_slot(s, 0) == JScheduler._pick_slot(j, 0) == 2
    assert Scheduler.free_in_replica(s, 1) == 1
    assert Scheduler.free_in_replica(s, 0) == 0


def test_single_replica_keeps_fifo():
    s = _router(1, 4, [2, 0, 3])
    assert Scheduler._pick_slot(s) == 2


def _state(v, nb, br=2, d=4):
    w = torch.arange(v * d, dtype=torch.float32).reshape(v, d)
    z = torch.zeros((nb, br), dtype=torch.bool)
    index = IVFIndex(v_blocks=torch.arange(nb * br * d, dtype=torch.float32
                                           ).reshape(nb, br, d),
                     valid=z, row_id=z.int(), slot_of_row=torch.zeros(v),
                     block_centroids=torch.zeros((nb, d)),
                     block_radius=torch.zeros(nb), n=v, block_rows=br)
    return BackendState(w=w, index=index)


@pytest.mark.parametrize("m,split_w,split_v", [(2, True, True),
                                               (4, True, False),
                                               (3, False, True)])
def test_local_shard_splits_only_w_and_v_blocks(m, split_w, split_v):
    st = _state(8, 6)
    for r in range(m):
        loc = local_shard(st, m, r)
        want_w = st.w[r * 8 // m:(r + 1) * 8 // m] if split_w else st.w
        want_v = (st.index.v_blocks[r * 6 // m:(r + 1) * 6 // m]
                  if split_v else st.index.v_blocks)
        assert torch.equal(loc.w, want_w)
        assert torch.equal(loc.index.v_blocks, want_v)
        assert loc.w.data_ptr() == want_w.data_ptr()        # a view
        for f in ("valid", "row_id", "slot_of_row", "block_centroids",
                  "block_radius"):
            assert getattr(loc.index, f) is getattr(st.index, f)


@pytest.mark.parametrize("path,nd,want", [
    ("['k']", 5, 1), ("['blocks']['v']", 4, 0), ("['rwkv']['wkv']", 5, 1),
    ("['ssm']", 4, 0), ("['tm_last']", 3, 1), ("['conv_x']", 3, 0),
    ("['scale']", 2, None)])
def test_serve_cache_spec_lane_axis(path, nd, want):
    assert serve_cache_spec(path, torch.zeros((1,) * nd)) == want


def _fake_mesh(names, sizes):
    return types.SimpleNamespace(mesh_dim_names=names,
                                 size=lambda i: sizes[i])


@pytest.mark.parametrize("arch,names,sizes,match", [
    ("qwen1.5-4b", ("data",), (1,), "model"),
    ("musicgen-medium", ("data", "model"), (1, 2), "audio"),
    ("qwen1.5-4b", ("data", "model"), (1, 3), "divide")])
def test_engine_mesh_validations(arch, names, sizes, match):
    model = types.SimpleNamespace(cfg=reduced_config(arch))
    with pytest.raises(ValueError, match=match):
        Engine(model, None, 16, device="cpu",
               mesh=_fake_mesh(names, sizes))


@pytest.mark.parametrize("shape,dtype,words", [
    ((3, 4), torch.bfloat16, torch.int32), ((3,), torch.bfloat16,
                                            torch.uint8),
    ((2, 3), torch.float32, torch.int32)])
def test_bitsum_word_view(shape, dtype, words):
    t = torch.randn(shape).to(dtype)
    w = _words(t)
    assert w.dtype == words and w.data_ptr() == t.data_ptr()


def test_prefix_pool_replicas_equal_jax():
    """Replica-local allocation, owners, eviction within a replica and the
    pool contents of each replica, against JAX's two-replica pool on the
    same operations (lane s of a two-lane table is on replica s)."""
    rng = np.random.default_rng(3)
    cache = rng.standard_normal((2, 16, 1, 4)).astype(np.float32)
    jp = JPrefixPool({"layers": [{"k": jnp.asarray(cache)}]}, 4, 2, 4,
                     n_replicas=2)
    tps = [PrefixPool({"k": torch.from_numpy(cache[r:r + 1].copy())}, 4, 2,
                      4, n_replicas=2, replica=r) for r in range(2)]
    jc = {"layers": [{"k": jnp.asarray(cache)}]}
    prompts = [([3, 1, 4, 1, 5], 0), ([3, 1, 9, 9, 9], 1),
               ([2, 7, 1, 8, 2], 1), ([6, 6, 6, 6, 6, 6], 0),
               ([5, 5, 5, 5, 5], 0), ([3, 1, 4, 1, 5, 9], 1)]
    for toks, rep in prompts:
        toks = np.asarray(toks, np.int32)
        got = [tp.insert(toks, len(toks), {"k": torch.from_numpy(
            cache[r:r + 1].copy())}, 0, rep) for r, tp in enumerate(tps)]
        assert got[0] == got[1] == jp.insert(toks, len(toks), jc, rep, rep)
        want = jp.match(toks, len(toks))
        for tp in tps:
            assert tp.match(toks, len(toks)) == want
            assert tp._node == jp._node and tp._lru == jp._lru
            assert tp._free == jp._free and tp.stats() == jp.stats()
    full = np.asarray(jp.pool["layers"][0]["k"])
    for r, tp in enumerate(tps):
        np.testing.assert_array_equal(tp.pool["k"].numpy(),
                                      full[2 * r:2 * r + 2])


# -- the four-rank spawn ------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for r in range(WORLD):
        log = open(out / f"log{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_mesh_rank.py"),
             str(r), str(WORLD), str(out / "store"), str(out)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    t_end = time.time() + DEADLINE_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, t_end - time.time()))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = "".join((out / f"log{r}.txt").read_text() for r in range(WORLD))
    assert all(p.returncode == 0 for p, _ in procs), logs[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _bits(t):
    if t is None:
        return None
    t = t.detach()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.long()


MESHES = ["1x4", "2x2", "4x1"]


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("method", R.METHODS)
@pytest.mark.parametrize("mesh", MESHES)
def test_shard_decode_equals_one_device(ranks, mesh, method, use_kernel):
    for res in ranks:
        got, ref = res[("decode", mesh, method, use_kernel)]
        loose = ("log_z", "head_lse") if method in ("exact",
                                                    "selfnorm") else ()
        for f in R.FIELDS:
            if f in loose:
                torch.testing.assert_close(got[f], ref[f], rtol=0,
                                           atol=1e-5)
                continue
            a, b = _bits(got[f]), _bits(ref[f])
            assert (a is None) == (b is None), f
            if a is not None:
                assert got[f].dtype == ref[f].dtype, f
                assert torch.equal(a, b), (f, got[f], ref[f])


@pytest.mark.parametrize("mesh", MESHES)
def test_state_partition_specs(ranks, mesh):
    specs, vb_shape, w_shape = ranks[0][("specs", mesh)]
    m = int(mesh.split("x")[1])
    assert specs == {"w": 0, "index.v_blocks": 0}
    assert vb_shape[0] % m == 0 and w_shape[0] % m == 0


def _jax_refs(m):
    v, q, lse = R.dist_inputs()
    lz_exact = np.asarray(jax.nn.logsumexp(jnp.asarray(q @ v.T), -1))
    tv, ti = jax.lax.top_k(jnp.asarray(q @ v.T), R.DK)
    n_local = R.DN // m
    locals_, heads = [], []
    for r in range(m):
        s = jnp.asarray(v[r * n_local:(r + 1) * n_local] @ q[0])
        hv, hi = jax.lax.top_k(s, R.DK)
        order = jnp.argsort(-s)
        tail = s[order[R.DK + jnp.asarray(R.tail_pos(m, r))]]
        log_tail = (jnp.log(jnp.float32(n_local - R.DK))
                    - jnp.log(jnp.float32(R.DL))
                    + jax.nn.logsumexp(tail))
        locals_.append(jnp.logaddexp(jax.nn.logsumexp(hv), log_tail))
        heads.append((hv, hi + r * n_local))
    av = jnp.concatenate([h[0] for h in heads])
    ai = jnp.concatenate([h[1] for h in heads])
    mv, mi = jax.lax.top_k(av, R.DK)
    return {"psum": np.asarray(jax.nn.logsumexp(jnp.asarray(lse), 0)),
            "exact_log_z": lz_exact, "top_k": (np.asarray(tv),
                                               np.asarray(ti)),
            "mimps_log_z": (np.asarray(jax.nn.logsumexp(
                jnp.stack(locals_))), np.asarray(mv), np.asarray(ai[mi]))}


@pytest.mark.parametrize("fn", ["psum", "exact_log_z", "top_k",
                                "mimps_log_z"])
@pytest.mark.parametrize("mesh", MESHES)
def test_distributed_functions_equal_jax(ranks, mesh, fn):
    want = _jax_refs(int(mesh.split("x")[1]))[fn]
    for res in ranks:
        got = res[(fn, mesh)]
        if fn in ("psum", "exact_log_z"):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        elif fn == "top_k":
            np.testing.assert_array_equal(got[1].numpy(), want[1])
            np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                                       atol=1e-5)
        else:
            np.testing.assert_allclose(got[0].item(), want[0], rtol=0,
                                       atol=1e-5)
            np.testing.assert_array_equal(got[2].numpy(), want[2])
            np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_row_gather_keeps_bits_a_value_sum_loses(ranks, mesh):
    for res in ranks:
        bits, vals, want = res[("rows", mesh)]
        assert torch.equal(bits.view(torch.int32), want.view(torch.int32))
        assert torch.signbit(bits[0, 0]) and torch.isnan(bits[0, 1])
        if mesh != "4x1":       # a value sum turns -0.0 + 0.0 into +0.0
            assert not torch.signbit(vals[0, 0])


def _tokens(rows):
    return [toks for toks, _, _ in rows]


@pytest.mark.parametrize("against", ["scheduler", "generate"])
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_scheduler_equals_one_device(ranks, mesh, against):
    res = ranks[0]
    mesh_rows, _, _ = res[("trace", mesh)]["mesh"]
    solo_rows, _, _ = res[("trace", mesh)]["solo"]
    assert all(reason is None for _, _, reason in mesh_rows)
    if against == "generate":
        assert _tokens(mesh_rows) == res["generate"]
    elif mesh != "4x1":
        assert mesh_rows == solo_rows           # tokens, log Z bit for bit
    else:
        # one lane a replica: its batch of one rounds otherwise than the
        # one device's four lanes (C9's mechanism, on the CPU too)
        assert _tokens(mesh_rows) == _tokens(solo_rows)
        for (_, got, _), (_, want, _) in zip(mesh_rows, solo_rows):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_nan_lane_falls_back_and_neighbours_keep_bits(ranks):
    res = ranks[0]
    rows, health = res["nan"]["mesh"]
    clean = res["nan_clean"]
    assert health["flagged"] > 0 and health["nonfinite_z"] > 0
    assert res["nan"]["mesh"] == res["nan"]["solo"]
    for i, (row, ref) in enumerate(zip(rows, clean)):
        if i != 1:
            assert row == ref, i
    assert all(np.isfinite(rows[1][1]))


def test_ladder_walk_under_the_mesh(ranks):
    res = ranks[0]
    rows, moves, _ = res["ladder"]["mesh"]
    assert [t for _, t in moves] == ["topk", "mimps"]
    assert res["ladder"]["mesh"][:2] == res["ladder"]["solo"][:2]


def test_speculation_with_prefix_pool(ranks):
    res = ranks[0]
    rows, stats = res["spec"]["mesh"]
    assert _tokens(rows) == _tokens(res["spec"]["solo"][0])
    assert _tokens(rows) == _tokens(res["spec_plain"][0])
    assert stats["hits"] > 0 and stats["inserted"] > 0


def test_lookahead_admission_holds_for_the_owner(ranks):
    res = ranks[0]
    rows, skipped, stats = res["window"]["mesh"]
    assert skipped > 0 and res["window"]["solo"][1] == 0
    assert stats["hits"] >= 1
    assert _tokens(rows) == _tokens(res["window"]["solo"][0])


def test_observability_harvest_equals_one_device(ranks):
    res = ranks[0]
    rows, got = res["obs"]["mesh"]
    solo_rows, want = res["obs"]["solo"]
    assert rows == solo_rows
    for key in want:
        if key == "fill_mean":        # the replicas' unions are summed
            assert got[key] >= want[key]
        elif key == "latency_hist_by_tier":   # host times
            assert {t: sum(v) for t, v in got[key].items()} == \
                {t: sum(v) for t, v in want[key].items()}
        elif key == "shadow_by_tier":
            for t, sh in want[key].items():
                assert got[key][t]["count"] == sh["count"]
                for f in ("rel_err_mean", "rel_err_max"):
                    np.testing.assert_allclose(got[key][t][f], sh[f],
                                               rtol=1e-4, atol=1e-6)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("key", [("trace", "1x4"), ("trace", "2x2"),
                                 ("trace", "4x1"), "nan", "ladder", "spec",
                                 "window", "obs"], ids=str)
def test_every_rank_serves_the_same(ranks, key):
    for res in ranks[1:]:
        assert res[key]["mesh"] == ranks[0][key]["mesh"]
