"""The port's multi-device training on the CPU (gloo), against one device
and the JAX package.

In-process units:

* ``param_spec`` against JAX's for every leaf of every assigned arch: at
  model 16 on the full configs (JAX's tree from ``jax.eval_shape``, the
  port's from a ``meta`` init) and at model 2 and 4 on the reduced trees;
  the two trees' path sets equal. zamba2's ``shared_attn`` attention stays
  replicated, as in JAX;
* ``decode_state_spec`` likewise over each family's decode state, with a
  stub mesh on each side ((data, model) and (pod, data, model), a batch
  that divides and one that does not);
* ``best_mesh_shape`` and the straggler watchdog on JAX's cases (the
  watchdog on a clock the test advances, not on sleeps);
* the named refusals: the estimator losses at data > 1, a ``pod_axis``
  that is not a mesh dim, gradient compression of an unknown mode;
* ``launch.train.main`` on one device, reduced, with a resume.

One spawn of four ranks (``tests/_torch_train_mesh_rank.py``, gloo over a
``FileStore`` with a 60 s timeout, joined with a deadline; about 15 s)
runs every multi-rank check; JAX runs only here, in the pytest process:

* ``compress_psum`` int8 bit for bit against JAX's under ``vmap(axis_name=)``
  on the same numpy inputs; ``none`` within the dtype's rounding of a sum
  of 4 terms (3 roundings of 2**-8 of the terms' magnitudes in bf16,
  2**-24 in f32), against float64 and against JAX;
* the sharded step at (1, 4) bit for bit against the one-device step:
  every leaf of the parameters, m and v after 2 steps, and each step's
  loss and grad_norm (fused_ce, ce, mimps_ce); mimps_ce's index refresh
  on the sharded state;
* at (2, 2) bit for bit against one device with two microbatches holding
  the two replicas' rows (the same partial gradients, summed in f32);
* at (2, 2) and (4, 1) (fused_ce, nce; and fused_ce with 2 microbatches at
  (2, 2)) within the tolerance below; at (2, 1, 2) over (pod, data,
  model) with ``pod_axis="pod"``, the gradient twice the one-device one
  within it (the pod axis sums, as in JAX);
* int8 with ``pod_axis="data"`` at (2, 2) against JAX's
  ``make_train_step(pod_axis=)`` under ``vmap`` from the same parameters
  and rows: the compressor's outputs bit for bit against JAX's
  ``compress_psum`` on the step's own gradients, and the int payloads
  that JAX's m carries equal to the port's for at least 99.9% of the
  entries and within D = 2 int8 steps everywhere; every rank's gathered
  state the same; the int32 all-reduces issued;
* a checkpoint saved at (2, 2), restored at (2, 2), at (1, 4) and on one
  device, bit for bit, the step after each equal to the uninterrupted one;
* ``launch.train.main`` at (2, 2) with a resume from a checkpoint.

Tolerance at data > 1 (one device takes the mean over the batch in one
sum, the mesh a mean of the replicas' means, so only rounding differs):
the loss within 1e-5 relative, grad_norm within 1e-3 relative, each
leaf's gradient, read back as m / (1 - b1) after step 1, within 2**-7 of
the leaf's max |g| (one bf16 step) with relative L2 error within 1e-2.
"""
import dataclasses
import os
import shutil
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

import _torch_train_mesh_rank as R
from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import mesh as jmesh
from repro.models import Model as JModel
from repro.train import compression as jcomp
from repro.train import elastic as jelastic
from repro.train import train_loop as jloop
from repro_torch.configs import TrainConfig, get_config, reduced_config
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models.transformer import tree_paths
from repro_torch.train import (StragglerWatchdog, best_mesh_shape,
                               compress_psum, elastic, make_train_step)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 240
LOSS_REL, GNORM_REL = 1e-5, 1e-3
GRAD_MAX, GRAD_L2 = 2 ** -7, 1e-2
JAX_SEED = 3


# -- the specs against JAX's ----------------------------------------------


def _jax_specs(tree, spec_of):
    """{port path: JAX spec as a tuple} over a JAX shape tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        out["".join(f"[{k!r}]" for k in keys)] = tuple(spec_of(path, leaf))
    return out


@pytest.mark.parametrize("reduced,model_axis", [(False, 16), (True, 2),
                                                (True, 4)],
                         ids=["full-16", "reduced-2", "reduced-4"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_spec_equals_jax(arch, reduced, model_axis):
    jcfg = (j_reduced_config if reduced else j_get_config)(arch)
    cfg = (reduced_config if reduced else get_config)(arch)
    jtree = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.PRNGKey(0)))
    want = _jax_specs(jtree, lambda p, x: jmesh.param_spec(p, x, model_axis))
    mine = Model(cfg).init(torch.Generator(), "meta")
    got = {p: M.param_spec(p, x, model_axis) for p, x in tree_paths(mine)}
    assert got.keys() == want.keys()
    jshape = {"".join(f"[{str(getattr(k, 'key', k))!r}]" for k in p):
              tuple(x.shape)
              for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    for path, leaf in tree_paths(mine):
        assert tuple(leaf.shape) == jshape[path], path
        assert got[path] == want[path], path
    assert any("model" in spec for spec in got.values())


def test_zamba2_shared_attention_stays_replicated():
    """The 'shared' branch catches zamba2's shared_attn (as in JAX): its
    wq/wk/wv/wo stay whole, its ffn splits."""
    mine = Model(get_config("zamba2-7b")).init(torch.Generator(), "meta")
    specs = {p: M.param_spec(p, x, 16) for p, x in tree_paths(mine)
             if p.startswith("['shared_attn']")}
    for name in ("wq", "wk", "wv", "wo"):
        assert specs[f"['shared_attn']['attn']['{name}']"] == (None, None)
    assert specs["['shared_attn']['ffn']['gate']"] == (None, "model")
    assert specs["['shared_attn']['ffn']['down']"] == ("model", None)
    replicated = [p for p, x in tree_paths(mine)
                  if "model" not in M.param_spec(p, x, 16)]
    assert len(replicated) == 23 and len(list(tree_paths(mine))) == 38


def _fake_mesh(names, sizes):
    """A mesh object for both packages' spec functions: JAX's reads
    ``shape``/``axis_names``, the port's ``mesh_dim_names``/``size``."""
    return types.SimpleNamespace(
        axis_names=names, shape=dict(zip(names, sizes)),
        mesh_dim_names=names, size=lambda i: sizes[i])


MESHES = [(("data", "model"), (2, 2)), (("data", "model"), (1, 4)),
          (("pod", "data", "model"), (2, 2, 4))]


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_state_spec_equals_jax(arch, reduced):
    jcfg = (j_reduced_config if reduced else j_get_config)(arch)
    cfg = (reduced_config if reduced else get_config)(arch)
    max_len = 32 if reduced else 64
    for batch in (8, 6):
        jtree = jax.eval_shape(
            lambda: JModel(jcfg).init_decode_state(batch, max_len))
        if set(jtree) == {"kv"}:       # the port's dense state is flat
            jtree = jtree["kv"]
        mine = Model(cfg).init_decode_state(batch, max_len, "meta")
        for names, sizes in MESHES if reduced else [MESHES[0]]:
            if not reduced:
                sizes = (2, 16)
            mesh = _fake_mesh(names, sizes)
            want = _jax_specs(jtree, lambda p, x: jmesh.decode_state_spec(
                p, x, mesh, batch))
            got = {p: M.decode_state_spec(p, x, mesh, batch)
                   for p, x in tree_paths(mine)}
            assert got == want, (names, sizes, batch)


@pytest.mark.parametrize("n,mp,want", [(256, 16, (16, 16)),
                                       (128, 16, (8, 16)),
                                       (96, 16, (6, 16)), (8, 16, (1, 8)),
                                       (6, 4, (2, 3))])
def test_best_mesh_shape_equals_jax(n, mp, want):
    assert best_mesh_shape(n, mp) == jelastic.best_mesh_shape(n, mp) == want


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(wd, clock, durations, first_step=0):
    flags = []
    for i, dt in enumerate(durations):
        wd.start_step()
        clock.t += dt
        flags.append(wd.end_step(first_step + i))
    return flags


@pytest.mark.parametrize("case", ["flags", "raises"])
def test_straggler_watchdog_equals_jax(monkeypatch, case):
    """JAX's two watchdog cases (``tests/test_infra.py``) on a clock the
    test advances: the same flags, events, EMA and raise."""
    clock = _Clock()
    monkeypatch.setattr(elastic.time, "perf_counter", clock)
    monkeypatch.setattr(jelastic.time, "perf_counter", clock)
    if case == "flags":
        kw, durations = dict(threshold=2.0, max_consecutive=100), \
            [0.01, 0.01, 0.01, 0.08]
    else:
        kw, durations = dict(threshold=1.5, max_consecutive=2), \
            [0.01] + [0.05] * 5
    outs = []
    for cls in (StragglerWatchdog, jelastic.StragglerWatchdog):
        clock.t = 0.0
        wd = cls(**kw)
        try:
            flags, err = _drive(wd, clock, durations), None
        except RuntimeError as e:
            flags, err = None, str(e)
        outs.append((flags, err, wd.events, wd.ema, wd.consecutive))
    assert outs[0] == outs[1]
    if case == "flags":
        assert outs[0][0] == [False, False, False, True]
        assert len(outs[0][2]) == 1
    else:
        assert "persistent straggler" in outs[0][1]


@pytest.mark.parametrize("loss", ["mimps_ce", "mince_ce", "lsh_ce"])
def test_estimator_losses_refuse_split_data(loss):
    model = Model(reduced_config("qwen1.5-4b"))
    mesh = _fake_mesh(("data", "model"), (2, 2))
    with pytest.raises(NotImplementedError, match="whole batch"):
        make_train_step(model, TrainConfig(loss=loss), mesh=mesh)


def test_pod_axis_must_name_a_mesh_dim():
    model = Model(reduced_config("qwen1.5-4b"))
    with pytest.raises(ValueError, match="pod_axis"):
        make_train_step(model, TrainConfig(), mesh=_fake_mesh(
            ("data", "model"), (2, 2)), pod_axis="pod")
    with pytest.raises(ValueError, match="pod_axis"):
        make_train_step(model, TrainConfig(), pod_axis="data")


def test_compress_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown grad compression"):
        compress_psum([torch.zeros(2)], None, mode="fp8")
    with pytest.raises(ValueError, match="unknown grad compression"):
        jcomp.compress_psum([jnp.zeros(2)], "pod", mode="fp8")


def _step_arrays(ckpt_dir, step):
    path = Path(ckpt_dir) / f"step_{step:010d}" / "arrays.npz"
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _assert_same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(
            a[k].reshape(-1).view(np.uint8),
            b[k].reshape(-1).view(np.uint8)), k


def test_launch_train_resume_on_one_device(tmp_path, capsys):
    """``main`` on one device: 3 steps with a checkpoint at 2; a run from
    that checkpoint alone resumes at step 2 and ends in the same state."""
    a, b = tmp_path / "a", tmp_path / "b"
    flags = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4",
             "--seq", "16", "--ckpt-every", "2"]
    th = launch_train.main(flags + ["--ckpt-dir", str(a)])
    assert th["steps"] == 3 and th["nonfinite_steps"] == 0
    shutil.copytree(a / "step_0000000002", b / "step_0000000002")
    th2 = launch_train.main(flags + ["--ckpt-dir", str(b)])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "mesh: {'data': 1" in out
    assert th2["steps"] == 1
    _assert_same_arrays(_step_arrays(a, 3), _step_arrays(b, 3))


# -- the four-rank spawn ------------------------------------------------------


def _jax_setup():
    """JAX's reduced qwen1.5-4b (f32), its train state from JAX_SEED and the
    int8 run's config and batch."""
    jcfg = dataclasses.replace(j_reduced_config("qwen1.5-4b"),
                               dtype="float32")
    jm = JModel(jcfg)
    jtc = JTrainConfig(loss="fused_ce", lr=1e-3, warmup_steps=1,
                       total_steps=10, grad_compression="int8",
                       grad_clip=1e9)
    jstate = jloop.init_train_state(jm, jtc, jax.random.PRNGKey(JAX_SEED))
    toks, labels = next(R.DataIterator(R.SyntheticCorpus(jcfg.vocab, seed=9),
                                       R.B, R.S))
    return jm, jtc, jstate, toks, labels


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_mesh")
    jm, jtc, jstate, toks, labels = _jax_setup()
    flat = {"p/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jstate.params)[0]}
    np.savez(out / "inputs.npz", tokens=toks, labels=labels, **flat)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for r in range(WORLD):
        log = open(out / f"log{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_train_mesh_rank.py"),
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
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return types.SimpleNamespace(ranks=ranks, out=out, jm=jm, jtc=jtc,
                                 jstate=jstate, toks=toks, labels=labels)


def _stacked():
    return [np.stack([R.cp_inputs(r)[i] for r in range(WORLD)])
            for i in range(len(R.CP_SHAPES))]


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_psum_int8_bits_equal_jax(spawn, dtype):
    jd = jnp.dtype(dtype)
    ins = [jnp.asarray(x).astype(jd) for x in _stacked()]
    want = jax.vmap(lambda g: jcomp.compress_psum(g, "pod", "int8"),
                    axis_name="pod")(ins)
    for res in spawn.ranks:
        got = res[("compress", "int8", f"torch.{dtype}")]
        for g, w in zip(got, want):
            w0 = np.asarray(w[0].astype(jnp.float32))
            assert np.array_equal(_np(g).view(np.uint32), w0.view(np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_psum_none_sums_within_rounding(spawn, dtype):
    jd = jnp.dtype(dtype)
    unit = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -24
    ins = [np.asarray(jnp.asarray(x).astype(jd).astype(jnp.float32))
           for x in _stacked()]
    jax_sum = jax.vmap(lambda g: jcomp.compress_psum(g, "pod", "none"),
                       axis_name="pod")(
        [jnp.asarray(x).astype(jd) for x in ins])
    for res in spawn.ranks:
        got = res[("compress", "none", f"torch.{dtype}")]
        for g, x, j in zip(got, ins, jax_sum):
            exact = x.astype(np.float64).sum(0)
            terms = np.abs(x.astype(np.float64)).sum(0)
            tol = 3 * unit * terms + 1e-30
            assert np.all(np.abs(_np(g) - exact) <= tol)
            jf = np.asarray(j[0].astype(jnp.float32))
            assert np.all(np.abs(_np(g) - jf) <= 2 * tol)


@pytest.mark.parametrize("loss", R.BIT_LOSSES)
def test_sharded_step_1x4_bits_equal_one_device(spawn, loss):
    for res in spawn.ranks:
        differ, logs, ref_logs = res[("bits", loss)]
        assert differ == [], differ[:5]
        assert logs == ref_logs


def test_index_refresh_on_the_sharded_state(spawn):
    """The refresh gathers the whole head of a (1, 4) state: the index and
    its churn and drift equal one device's bit for bit."""
    for res in spawn.ranks:
        (got, got_m), (want, want_m) = res["refresh"]
        for a, b in zip(got, want):
            if torch.is_tensor(a):
                assert a.dtype == b.dtype and torch.equal(a, b)
            else:
                assert a == b
        for k in want_m:
            assert torch.equal(torch.as_tensor(got_m[k]),
                               torch.as_tensor(want_m[k])), k


def test_sharded_step_2x2_bits_equal_two_microbatches(spawn):
    """At (2, 2) the mesh sums, in f32, the two replicas' gradients: one
    device with two microbatches holding the replicas' rows sums the same
    partial gradients, so the states agree bit for bit."""
    for res in spawn.ranks:
        differ, logs, ref_logs = res[("mb bits", (2, 2))]
        assert differ == [], differ[:5]
        assert logs == ref_logs


TOL_KEYS = [("tol", s, l) for s in R.TOL_MESHES for l in R.TOL_LOSSES] + [
    ("tol", (2, 2), "fused_ce mb2"), ("tol", (2, 1, 2), "fused_ce pod sum")]


@pytest.mark.parametrize("key", TOL_KEYS, ids=lambda k: f"{k[1]}-{k[2]}")
def test_sharded_step_within_tolerance(spawn, key):
    for res in spawn.ranks:
        errs, logs, ref_logs = res[key]
        for (loss, gn), (rloss, rgn) in zip(logs, ref_logs):
            assert abs(loss - rloss) <= LOSS_REL * abs(rloss)
            if "pod sum" not in key[2]:
                assert abs(gn - rgn) <= GNORM_REL * abs(rgn)
            else:                                       # twice the gradient
                assert abs(gn - 2 * rgn) <= GNORM_REL * 2 * rgn
        assert errs
        for name, (d_max, r_max, d_l2, r_l2) in errs.items():
            assert d_max <= GRAD_MAX * r_max, name
            assert d_l2 <= GRAD_L2 * r_l2, name


def _jax_int8_step(spawn):
    step = jloop.make_train_step(spawn.jm, spawn.jtc, pod_axis="pod")
    batch = {"tokens": jnp.asarray(spawn.toks.reshape(2, R.B // 2, -1)),
             "labels": jnp.asarray(spawn.labels.reshape(2, R.B // 2, -1))}
    state, _ = jax.jit(jax.vmap(step, in_axes=(None, 0), axis_name="pod"))(
        spawn.jstate, batch)
    return state


def test_int8_pod_step_compressor_bits_equal_jax(spawn):
    """The step's own per-replica gradients through JAX's compress_psum
    under vmap give the port's compressed gradients bit for bit."""
    by_data = {res["int8"]["data_rank"]: res["int8"] for res in spawn.ranks}
    ins = [jnp.asarray(np.stack([_np(by_data[c]["in"][i]) for c in (0, 1)]))
           for i in range(len(by_data[0]["in"]))]
    want = jax.jit(jax.vmap(lambda g: jcomp.compress_psum(g, "pod", "int8"),
                            axis_name="pod"))(ins)
    for res in spawn.ranks:
        got = res["int8"]["out"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(_np(g).view(np.uint32),
                                  np.asarray(w[0]).view(np.uint32))
        # one int32 all-reduce a leaf, of the leaf's size
        assert res["int8"]["int32_sums"] == [g.numel() for g in got]


def test_int8_pod_step_sums_like_jax(spawn):
    """m after one step carries (1 - b1) x scale x the int32 payload sum
    over the 2 replicas (no clipping): the port's payloads against those of
    JAX's m, read with the port's scale (JAX's differs by rounding)."""
    jstate = _jax_int8_step(spawn)
    jm = {}
    for path, v in jax.tree_util.tree_flatten_with_path(jstate.opt.m)[0]:
        v = np.asarray(v)
        assert np.array_equal(v[0], v[1])                 # pods agree
        jm["m" + "".join(f"[{str(k.key)!r}]" for k in path)] = v[0]
    res = spawn.ranks[0]["int8"]
    by_data = {r["int8"]["data_rank"]: r["int8"] for r in spawn.ranks}
    names = list(res["m"])
    assert sorted(names) == sorted(jm)
    b1 = np.float32(1 - R.B1)
    equal = total = 0
    for i, name in enumerate(_ordered(names, spawn)):
        amax = max(np.abs(_np(by_data[c]["in"][i])).max() for c in (0, 1))
        scale = (np.float32(amax) + np.float32(1e-12)) / np.float32(127.0)
        mine = _np(res["m"][name]) / (b1 * scale)
        theirs = jm[name] / (b1 * scale)
        s_mine, s_theirs = np.round(mine), np.round(theirs)
        assert np.abs(mine - s_mine).max() < 1e-2, name
        assert np.abs(theirs - s_theirs).max() < 1e-2, name
        assert np.abs(s_mine - s_theirs).max() <= 2, name
        equal += int((s_mine == s_theirs).sum())
        total += s_mine.size
    assert equal >= 0.999 * total, (equal, total)


def _ordered(names, spawn):
    """The m leaves in the compressor's order (the parameters' tree order
    of the port state built from the JAX tree)."""
    from repro_torch.interop import params_from_numpy
    with np.load(spawn.out / "inputs.npz") as data:
        tree = {}
        for key in data.files:
            if key.startswith("p/"):
                node = tree
                *parts, last = key[2:].split("/")
                for p in parts:
                    node = node.setdefault(p, {})
                node[last] = data[key]
    cfg = R.cfg()
    order = ["m" + p for p, _ in tree_paths(params_from_numpy(tree, cfg,
                                                              "cpu"))]
    assert sorted(order) == sorted(names)
    return order


def test_int8_pod_step_replicas_agree(spawn):
    digests = [res["int8"]["digest"] for res in spawn.ranks]
    assert all(d == digests[0] for d in digests)
    losses = {res["int8"]["loss"] for res in spawn.ranks}
    assert len(losses) == 1 and np.isfinite(losses.pop())


@pytest.mark.parametrize("what", ["restored", "next"])
def test_checkpoint_reshards_across_meshes(spawn, what):
    for res in spawn.ranks:
        ck = res["ckpt"]
        assert ck["steps"] == (1, 1, 1)
        if what == "restored":      # at (2, 2), (1, 4) and on one device
            assert ck["restored"] == [[], [], []]
        else:
            assert ck["next 2x2"] == [] and ck["next 1x4"] == []


def test_launch_train_resumes_under_the_mesh(spawn):
    for res in spawn.ranks:
        assert res["cli"]["steps"] == 1
        assert res["cli"]["nonfinite_steps"] == 0
    _assert_same_arrays(_step_arrays(spawn.out / "cli_a", 3),
                        _step_arrays(spawn.out / "cli_b", 3))
    log = (spawn.out / "log0.txt").read_text()
    assert "mesh: {'data': 2, 'model': 2}" in log
    assert "resumed from step 2" in log


def test_production_mesh_needs_its_ranks(spawn):
    assert "needs 256 ranks" in spawn.ranks[0]["production"]
