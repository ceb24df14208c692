"""The dry-run bodies of ``repro_torch.serve.output_layer`` against the JAX
package's on the CPU.

The index and queries are JAX's ``tests/test_backends.py`` sharded case
(nb 32 blocks of 64 rows, d 32, 8 queries) over four shards. JAX runs its
bodies (``_local_ivf_logz``, ``_local_mince_logz``, ``_local_ivf_topk``
and ``fmbe_z_batch``) in this process under ``jax.vmap(...,
axis_name="model")`` over the four stacked shards, which covers their
psum, pmax, all_gather and axis_index on one device. One spawn of four
gloo ranks (``tests/_torch_sharded_rank.py``, mesh (1, 4)) runs the
port's ``sharded_decode`` on the same numpy inputs, each rank's tail slots
injected as JAX draws them, ``jax.random.randint(jax.random.fold_in(key,
shard), (l_local,), 0, n_slots)``, with and without ``use_kernel`` (the
kernels' plain versions here). Tolerances: mimps log Z within 1e-5 and
ids equal; mince within 1e-4 (its stats are summed in another order);
fmbe within 1e-4 and ids equal; the exhaustive probe equal to exact log Z;
every rank's outputs bit-equal. ``streaming_logz_argmax`` against JAX's:
log Z within 1e-5, ids equal. The spawn takes about 5 s.
"""
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_fmbe, fmbe_z_batch, make_feature_map
from repro.core.feature_maps import FeatureMap
from repro.serve import output_layer as J
from repro_torch.serve.output_layer import (ivf_partition_specs,
                                            ivf_specs_for, sharded_decode,
                                            streaming_logz_argmax)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 120
NB, BR, D, B = 32, 64, 32, 8
CASES = (("mimps", "mimps", 2, 16), ("mince", "mince", 2, 16),
         ("fmbe", "fmbe", 4, 0), ("mimps_all", "mimps", 8, 16),
         ("mince_all", "mince", 8, 16))


def _inputs():
    key = jax.random.PRNGKey(0)
    v = jax.random.normal(key, (NB * BR, D)) * 0.25
    vb = v.reshape(NB, BR, D)
    cent = vb.mean(axis=1)
    radius = jnp.max(jnp.linalg.norm(vb - cent[:, None, :], axis=-1), axis=1)
    ivf = J.IVFSpecs(v_blocks=vb, centroids=cent, radius=radius,
                     valid=jnp.ones((NB, BR), bool))
    h = v[:B] + 0.01 * jax.random.normal(jax.random.fold_in(key, 1), (B, D))
    # JAX's feature map of the sharded case, traced once (its eager draws
    # take seconds)
    fields = jax.jit(lambda k: make_feature_map(k, D, 2048, max_degree=6)[
        :3])(jax.random.fold_in(key, 2))
    fm = FeatureMap(*fields, p=2.0)
    fstate = jax.jit(lambda o, g, c, v: build_fmbe(fm._replace(
        omega=o, degree=g, coef=c), v))(*fields, v)
    return key, v, ivf, h, fm, fstate


def _jax_body(name, method, p, l, key, ivf, h, fstate):
    stacked = J.IVFSpecs(*[x.reshape((WORLD, -1) + x.shape[1:])
                           for x in ivf])
    if method == "fmbe":
        body = functools.partial(J._local_ivf_topk, n_probe_local=p)
        ids, top = jax.jit(jax.vmap(body, in_axes=(0, None),
                                    axis_name="model"))(stacked, h)
        z = jax.jit(lambda lam, h: fmbe_z_batch(fstate._replace(
            lambda_tilde=lam), h))(fstate.lambda_tilde, h)
        return jnp.log(jnp.maximum(z, 1e-30)), ids[0], top[0]
    fn = J._local_ivf_logz if method == "mimps" else J._local_mince_logz
    kw = {"iters": 3, "solver": "halley"} if method == "mince" else {}
    body = functools.partial(fn, n_probe_local=p, l_local=l, **kw)
    out = jax.jit(jax.vmap(body, in_axes=(0, None, None),
                           axis_name="model"))(stacked, h, key)
    # every shard holds the combined result
    for x in out:
        np.testing.assert_array_equal(np.asarray(x[0]), np.asarray(x[-1]))
    return tuple(x[0] for x in out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    key, v, ivf, h, fm, fstate = _inputs()
    out = tmp_path_factory.mktemp("sharded")
    n_slots = NB // WORLD * BR
    arrays = {k: np.asarray(x) for k, x in ivf._asdict().items()}
    arrays.update(h=np.asarray(h), omega=np.asarray(fm.omega),
                  degree=np.asarray(fm.degree), coef=np.asarray(fm.coef),
                  p=np.asarray(fm.p),
                  lambda_tilde=np.asarray(fstate.lambda_tilde))
    for l in (16,):
        arrays[f"slots_{l}"] = np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(key, s), (l,), 0, n_slots))
            for s in range(WORLD)])
    np.savez(out / "inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for r in range(WORLD):
        log = open(out / f"log{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_sharded_rank.py"),
             str(r), str(WORLD), str(out / "store"), str(out)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    # JAX's references while the ranks run
    want = {name: tuple(np.asarray(x) for x in _jax_body(
        name, method, p, l, key, ivf, h, fstate))
        for name, method, p, l in CASES}
    logits = np.asarray(h @ v.T, np.float32)
    exact = (np.asarray(jax.nn.logsumexp(logits, -1)), logits.argmax(-1))
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
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    yield got, want, exact, (np.array(h), np.array(v))
    torch.set_num_threads(n)


TOL = {"mimps": 1e-5, "mince": 1e-4, "fmbe": 1e-4, "mimps_all": 1e-5,
       "mince_all": 1e-4}


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_body_equals_jax(run, name, use_kernel):
    got, want, _, _ = run
    lz, tid, ts = (x.numpy() for x in got[0][(name, use_kernel)])
    jlz, jid, jts = want[name]
    np.testing.assert_allclose(lz, jlz, rtol=0, atol=TOL[name])
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_allclose(ts, jts, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["mimps_all", "mince_all"])
def test_exhaustive_probe_is_exact(run, name):
    got, _, (lz_ref, id_ref), _ = run
    lz, tid, _ = (x.numpy() for x in got[0][(name, True)])
    np.testing.assert_allclose(lz, lz_ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tid, id_ref)


def test_every_rank_holds_the_same(run):
    got = run[0]
    for r in range(1, WORLD):
        for key, vals in got[0].items():
            for a, b in zip(vals, got[r][key]):
                assert torch.equal(a, b), (r, key)


def test_kernel_route_equals_plain_bits_on_the_cpu(run):
    """The probe methods' kernel route is ``ivf_score``'s plain version,
    the same einsum; fmbe's ``fmbe_z_plain`` sums in another order than
    the feature map's product (both held to JAX above)."""
    got = run[0]
    for name, *_ in CASES:
        pairs = zip(got[0][(name, True)], got[0][(name, False)])
        if name == "fmbe":
            lz, lz_plain = next(pairs)
            assert torch.allclose(lz, lz_plain, rtol=0, atol=1e-5)
        for a, b in pairs:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("chunk", [64, 8192])
def test_streaming_logz_argmax_equals_jax(run, chunk):
    h, v = run[3]
    v = v[:2000]                          # 2000 rows: a partial chunk
    jlz, jid, jts = J.streaming_logz_argmax(jnp.asarray(h), jnp.asarray(v),
                                            chunk=chunk)
    lz, tid, ts = streaming_logz_argmax(torch.from_numpy(h),
                                        torch.from_numpy(v), chunk=chunk)
    np.testing.assert_allclose(lz.numpy(), np.asarray(jlz), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=0,
                               atol=1e-6)
    # the kernel route (topk_z's plain version on the CPU) agrees
    klz, kid, kts = streaming_logz_argmax(torch.from_numpy(h),
                                          torch.from_numpy(v),
                                          use_kernel=True)
    np.testing.assert_allclose(klz.numpy(), np.asarray(jlz), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(kid.numpy(), np.asarray(jid))


def test_dispatch_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="no sharded backend"):
        sharded_decode(None, "nope", None, None, n_probe_local=1, l_local=1)


def test_specs_split_over_model():
    s = ivf_specs_for(151936, 2560, 512, torch.bfloat16)
    assert s.v_blocks.shape == (304, 512, 2560)
    assert all(spec[0] == "model" for spec in ivf_partition_specs())
