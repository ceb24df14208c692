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
* ``split_plan`` on the full configs: the leaves the compute split
  gathers whole (none of qwen1.5-4b's at model 4, its attention at 16,
  gemma3's attention at 16, an estimator loss's head, RWKV6's and
  Mamba2's blocks);
* the named refusals: a ``pod_axis`` that is not a mesh dim, gradient
  compression of an unknown mode;
* ``launch.train.main`` on one device, reduced, with a resume.

One spawn of four ranks (``tests/_torch_train_mesh_rank.py``, gloo over a
``FileStore`` with a 60 s timeout, joined with a deadline; about 25 s)
runs every multi-rank check; JAX runs only here, in the pytest process:

* ``compress_psum`` int8 bit for bit against JAX's under ``vmap(axis_name=)``
  on the same numpy inputs; ``none`` within the dtype's rounding of a sum
  of 4 terms (3 roundings of 2**-8 of the terms' magnitudes in bf16,
  2**-24 in f32), against float64 and against JAX;
* the sharded step at (1, 4) against the one-device step (fused_ce, ce,
  mimps_ce): bit for bit on reduced rwkv6, whose leaves the split gathers
  whole (every leaf of the parameters, m and v after 2 steps, each step's
  loss and grad_norm; under fused_ce its vocab rows split, so it too
  takes the tolerance), within the tolerance on the split qwen1.5-4b;
  mimps_ce's index refresh on the sharded state;
* at (2, 2) against one device with two microbatches holding the two
  replicas' rows: rwkv6 with ce bit for bit (the same partial gradients,
  summed in f32), the split qwen1.5-4b within the tolerance;
* the compute split (fused_ce, ce, selfnorm on qwen1.5-4b, fused_ce on
  deepseek-moe-16b) at (1, 4) and (2, 2) within the tolerance of the
  port's one-device step and of JAX's one-device ``make_train_step``
  from the same numpy parameters and batch (the MoE at (2, 2) against two
  microbatches of the replicas' rows: each replica sizes its experts'
  capacity from its own rows, C10); no qwen or MoE leaf gathered under
  fused_ce and selfnorm; the data replicas of each model slice and every
  replicated leaf bit-equal across ranks; the (1, 1) step of a one-rank
  group bit for bit; the vocab-parallel lookup bit for bit and the CE
  pair at V / 4 rows against the whole pair; mimps_ce, mince_ce and
  lsh_ce at (2, 2) within the tolerance of one device on the whole
  batch;
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
  device, bit for bit; the step after it at (2, 2) equal to the
  uninterrupted one; at (1, 4) one device's bits for reduced rwkv6 under
  ce (every leaf gathered), and for the split qwen1.5-4b params, m and v
  within the tolerance of one device's;
* ``launch.train.main`` at (2, 2) (four ranks, ``--model-parallel 2``)
  with a resume from a checkpoint.

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


@pytest.mark.parametrize("arch,model_axis,loss,gathered", [
    ("qwen1.5-4b", 4, "fused_ce", []),
    ("qwen1.5-4b", 16, "fused_ce", ["wq", "wk", "wv", "wo", "bq", "bk",
                                    "bv"]),
    ("qwen1.5-4b", 4, "mimps_ce", ["lm_head"]),
    ("gemma3-4b", 16, "fused_ce", ["wq", "wk", "wv", "wo"]),
    ("deepseek-moe-16b", 16, "fused_ce", []),
    ("zamba2-7b", 16, "fused_ce", None),
    ("rwkv6-7b", 16, "fused_ce", None)],
    ids=lambda x: str(x) if not isinstance(x, list) else "")
def test_split_plan_gathers_what_cannot_split(arch, model_axis, loss,
                                              gathered):
    """The leaves the compute split gathers whole, by name, on the full
    configs: none for qwen1.5-4b at model 4 (its 20 heads and 6912-wide
    MLP divide), its attention at 16 (20 heads do not), gemma3's attention
    at 16 (2048 / 16 is half a 256-wide head), the head of an estimator
    loss; zamba2's Mamba2 blocks and RWKV6's blocks, while their MLP
    (zamba2's shared block) and vocab rows split."""
    cfg = get_config(arch)
    plan = M.split_plan(cfg, Model(cfg).init(torch.Generator(), "meta"),
                        model_axis, loss)
    names = sorted({M.path_keys(p)[-1] for p, k in plan.items()
                    if k == "gather"})
    if gathered is not None:
        assert names == sorted(gathered)
    else:
        assert names and all(plan[p] == "gather" for p in plan
                             if M.path_keys(p)[0] in ("mamba_groups",
                                                      "mamba_tail", "blocks")
                             and plan[p] != "whole")
    assert plan["['embed']['table']"] == "split"
    if arch == "zamba2-7b":
        assert plan["['shared_attn']['ffn']['gate']"] == "split"
        assert plan["['shared_attn']['attn']['wq']"] == "whole"     # C17


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


def _jax_model(arch):
    return JModel(dataclasses.replace(j_reduced_config(R.ARCHS[arch]),
                                      dtype="float32"))


def _jax_setup():
    """JAX's reduced qwen1.5-4b (f32), its train state from JAX_SEED and the
    int8 run's config and batch."""
    jm = _jax_model("qwen")
    jtc = JTrainConfig(loss="fused_ce", lr=1e-3, warmup_steps=1,
                       total_steps=10, grad_compression="int8",
                       grad_clip=1e9)
    jstate = jloop.init_train_state(jm, jtc, jax.random.PRNGKey(JAX_SEED))
    toks, labels = next(R.DataIterator(
        R.SyntheticCorpus(jm.cfg.vocab, seed=9), R.B, R.S))
    return jm, jtc, jstate, toks, labels


def _flat(prefix, params):
    return {prefix + "/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_mesh")
    jm, jtc, jstate, toks, labels = _jax_setup()
    moe = jloop.init_train_state(_jax_model("moe"), jtc,
                                 jax.random.PRNGKey(JAX_SEED)).params
    np.savez(out / "inputs.npz", tokens=toks, labels=labels,
             **_flat("qwen", jstate.params), **_flat("moe", moe))
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
        # JAX's references run here while the ranks work
        jax_split = _jax_split_refs(toks, labels)
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
                                 jstate=jstate, toks=toks, labels=labels,
                                 jax_split=jax_split)


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


def _within(errs, logs, ref_logs, scale=1.0):
    """The tolerance of the module's notes: each step's loss and grad_norm
    (``ref_logs``'s grad_norm times ``scale``), every leaf's gradient."""
    for (loss, gn), (rloss, rgn) in zip(logs, ref_logs):
        assert abs(loss - rloss) <= LOSS_REL * abs(rloss)
        assert abs(gn - scale * rgn) <= GNORM_REL * scale * abs(rgn)
    assert errs and len(logs) == len(ref_logs)
    for name, (d_max, r_max, d_l2, r_l2) in errs.items():
        assert d_max <= GRAD_MAX * r_max, name
        assert d_l2 <= GRAD_L2 * r_l2, name


@pytest.mark.parametrize("loss", R.BIT_LOSSES)
def test_sharded_step_1x4_bits_equal_one_device(spawn, loss):
    """Reduced rwkv6, whose blocks the split gathers whole: bit for bit
    where its head is gathered too (ce, mimps_ce); under fused_ce its
    vocab rows split (the LSE combine and dh's sum reorder the sums), so
    it, and the split qwen1.5-4b, are held to the tolerance."""
    for res in spawn.ranks:
        out = res[("bits", loss)]
        differ, errs, logs, ref_logs = out["rwkv"]
        if loss == "fused_ce":
            _within(errs, logs, ref_logs)
        else:
            assert differ == [], differ[:5]
            assert logs == ref_logs
        _, errs, logs, ref_logs = out["qwen"]
        _within(errs, logs, ref_logs)


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
    partial gradients, so where the split gathers every leaf (reduced
    rwkv6 with ce) the states agree bit for bit; the split qwen1.5-4b
    (fused_ce) is held to the tolerance."""
    for res in spawn.ranks:
        out = res[("mb bits", (2, 2))]
        differ, _, logs, ref_logs = out["rwkv"]
        assert differ == [], differ[:5]
        assert logs == ref_logs
        _, errs, logs, ref_logs = out["qwen"]
        _within(errs, logs, ref_logs)


TOL_KEYS = [("tol", s, l) for s in R.TOL_MESHES for l in R.TOL_LOSSES] + [
    ("tol", (2, 2), "fused_ce mb2"), ("tol", (2, 1, 2), "fused_ce pod sum")]


@pytest.mark.parametrize("key", TOL_KEYS, ids=lambda k: f"{k[1]}-{k[2]}")
def test_sharded_step_within_tolerance(spawn, key):
    for res in spawn.ranks:
        errs, logs, ref_logs = res[key]
        # the pod axis sums: twice the gradient
        _within(errs, logs, ref_logs, 2.0 if "pod sum" in key[2] else 1.0)


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
        # one int32 all-reduce a leaf, of the rank's slice of it
        assert res["int8"]["int32_sums"] == res["int8"]["local_sizes"]
        assert len(got) == len(res["int8"]["local_sizes"])


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
            if key.startswith("qwen/"):
                node = tree
                *parts, last = key[5:].split("/")
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
        for name, ck in res["ckpt"].items():
            assert ck["steps"] == (1, 1, 1), name
            if what == "restored":      # at (2, 2), (1, 4), one device
                assert ck["restored"] == [[], [], []], name
                continue
            # the step after: at (2, 2) the uninterrupted one's bits
            assert ck["next 2x2"] == [], name
            if name == "rwkv":
                # every leaf gathered, so (1, 4) is one device's bits
                assert ck["next 1x4"] == [], ck["next 1x4"][:5]
                continue
            # the split at (1, 4): params, m and v within the tolerance of
            # one device's (m holds the sum of two steps' gradients, v
            # as sqrt(v) their root mean square, the parameters by their
            # update); an update's max is left out: Adam divides a
            # gradient by its own root mean square, so an element that is
            # 0 in exact arithmetic (the key bias's) moves on rounding
            errs = ck["next 1x4 errors"]
            assert {k.split("[")[0] for k in errs} == {"params", "m", "v"}
            for leaf, (d_max, r_max, d_l2, r_l2) in errs.items():
                if not leaf.startswith("params"):
                    assert d_max <= GRAD_MAX * r_max, leaf
                assert d_l2 <= GRAD_L2 * r_l2, leaf


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


# -- the compute split over 'model' ------------------------------------------

SPLIT_KEYS = [("split", arch, loss, shape) for arch, loss in R.SPLIT_CASES
              for shape in R.SPLIT_MESHES]


def _split_id(key):
    return f"{key[1]}-{key[2]}-{key[3][0]}x{key[3][1]}"


def _jax_split_refs(toks, labels):
    """JAX's one-device make_train_step, one step from the same parameters
    on the same batch, for each split case: (loss, grad_norm) and m by
    name. The MoE's (2, 2) reference takes two microbatches holding the
    replicas' rows, as the port's does."""
    perm = np.stack([np.arange(R.B // 2), np.arange(R.B // 2, R.B)],
                    1).reshape(-1)
    out = {}
    for arch, loss in R.SPLIT_CASES:
        jm = _jax_model(arch)
        for mb in sorted({2 if arch == "moe" and s[0] > 1 else 1
                          for s in R.SPLIT_MESHES}):
            jtc = JTrainConfig(loss=loss, lr=1e-3, warmup_steps=1,
                               total_steps=10, microbatches=mb)
            state = jloop.init_train_state(jm, jtc,
                                           jax.random.PRNGKey(JAX_SEED))
            rows = perm if mb > 1 else np.arange(R.B)
            batch = {"tokens": jnp.asarray(toks[rows]),
                     "labels": jnp.asarray(labels[rows])}
            state, met = jax.jit(jloop.make_train_step(jm, jtc))(state,
                                                                  batch)
            m = {"m" + "".join(f"[{str(k.key)!r}]" for k in path):
                 np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(
                     state.opt.m)[0]}
            out[(arch, loss, mb)] = ((float(met["loss_total"]),
                                      float(met["grad_norm"])), m)
    return out


@pytest.fixture(scope="module")
def jax_split(spawn):
    return spawn.jax_split


@pytest.mark.parametrize("key", SPLIT_KEYS, ids=_split_id)
def test_split_step_within_tolerance_of_one_device(spawn, key):
    """The split step (qwen1.5-4b's attention, MLP and vocab rows, the
    MoE's experts and shared experts) against the port's one-device step
    from the JAX package's parameters: loss, grad_norm and every leaf's
    gradient within the module's tolerance."""
    for res in spawn.ranks:
        r = res[key]
        _within(r["errs"], [r["log"]], [r["ref_log"]])


@pytest.mark.parametrize("key", SPLIT_KEYS, ids=_split_id)
def test_split_step_within_tolerance_of_jax(spawn, jax_split, key):
    """The same split step against JAX's one-device make_train_step on the
    same numpy parameters and batch."""
    _, arch, loss, _ = key
    for res in spawn.ranks:
        r = res[key]
        want_log, want_m = jax_split[(arch, loss, r["mb"])]
        assert sorted(want_m) == sorted(r["m"])
        errs = {}
        for name, got in r["m"].items():
            g = got.numpy().astype(np.float64) / (1 - R.B1)
            w = want_m[name].astype(np.float64) / (1 - R.B1)
            errs[name] = (np.abs(g - w).max(), np.abs(w).max(),
                          np.linalg.norm(g - w), np.linalg.norm(w))
        _within(errs, [r["log"]], [want_log])


def test_split_step_gathers_no_leaf_of_qwen_or_the_moe(spawn):
    """At (1, 4) and (2, 2) every leaf of reduced qwen1.5-4b and
    deepseek-moe-16b that param_spec splits is computed as a slice under
    fused_ce and selfnorm (0 gathered whole); ce gathers only the head."""
    for res in spawn.ranks:
        for key in SPLIT_KEYS:
            want = ["['lm_head']"] if key[2] == "ce" else []
            assert res[key]["gathered"] == want, key


def test_split_step_data_replicas_bit_equal(spawn):
    """At (2, 2) the two data replicas of each model slice hold the same
    parameters and moments after the step, bit for bit."""
    for key in SPLIT_KEYS:
        if key[3] != (2, 2):
            continue
        by_model = {}
        for res in spawn.ranks:
            r = res[key]
            by_model.setdefault(r["coord"][1], []).append(r["local"])
        assert len(by_model) == 2
        for a, b in by_model.values():
            assert R.same_bits(a, b) == [], key


def test_split_step_replicated_leaves_bit_equal_across_model(spawn):
    """The leaves param_spec replicates (norms, routers) are the same bits
    on every rank after the step: their gradients come out whole on each
    model rank."""
    for key in SPLIT_KEYS:
        repl = spawn.ranks[0][key]["replicated"]
        assert repl
        first = spawn.ranks[0][key]["local"]
        for res in spawn.ranks[1:]:
            local = res[key]["local"]
            for name in repl:
                for part in ("params", "m", "v"):
                    n = part + name[len("params"):]
                    assert torch.equal(R.bits(local[n]), R.bits(first[n])), n


def test_split_step_1x1_bits_equal_one_device(spawn):
    """A one-rank group at mesh (1, 1): the split is the identity."""
    differ, logs, ref_logs = spawn.ranks[0]["one rank"]
    assert differ == [], differ[:5]
    assert logs == ref_logs


def test_vocab_parallel_lookup_bits_equal(spawn):
    assert all(res["lookup"] for res in spawn.ranks)


def test_vocab_parallel_ce_pair_against_the_whole_pair(spawn):
    """The CE pair on each rank's V/4 rows with the combined lse: nll and
    lse within 1e-6 relative, dh (summed over 'model') and the ranks' dW
    rows, concatenated in rank order, within 1e-5 of their largest
    magnitude (sums of 512 f32 terms in another order, with the combined
    lse's bits), of the whole pair on the same inputs (plain versions on
    the CPU, f32)."""
    pairs = dict(res["ce_pair"] for res in spawn.ranks)
    whole = pairs[0]["whole"]
    dw = torch.cat([pairs[r]["shard"]["dw"] for r in range(WORLD)])
    assert dw.shape == whole["dw"].shape
    for r in range(WORLD):
        got = pairs[r]["shard"]
        for name in ("nll", "lse"):
            assert torch.allclose(got[name], whole[name], rtol=1e-6,
                                  atol=0), name
        assert (got["dh"] - whole["dh"]).abs().max() <= \
            1e-5 * whole["dh"].abs().max()
    assert (dw - whole["dw"]).abs().max() <= 1e-5 * whole["dw"].abs().max()


@pytest.mark.parametrize("loss", R.EST_LOSSES)
def test_estimator_losses_at_split_data(spawn, loss):
    """mimps_ce, mince_ce and lsh_ce at (2, 2): the hidden states and
    labels gathered over 'data', one plan over the whole batch on every
    rank, each rank scoring its rows; two steps within the tolerance of
    one device's on the whole batch."""
    for res in spawn.ranks:
        _within(*res[("est", loss)])
