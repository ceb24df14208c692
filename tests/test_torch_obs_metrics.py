"""The port's device metric state (``repro_torch.obs.metrics``) against the
JAX package's ``repro.obs.metrics`` on the same inputs (CPU): a sequence of
``observe_step`` calls with every optional argument, spec counters and
shadow triples on two tiers, harvested by both (counters equal, the f32
shadow sums within 1e-6 relative: torch's and XLA's ``expm1`` differ by an
ulp and their sums add in another order); ``shadow_rel_err``,
``_bucket`` at the edges and ``hist_quantile`` alike; the tier order the
port's registry gives equal to JAX's. ``observe_step`` adds in place, and
``reset_metric_state`` zeroes in place: the tensors keep their storage."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import metrics as jm
from repro_torch.obs import metrics as tm


def test_tier_order_and_edges_equal_jax():
    assert tm.TIERS == jm.TIERS and tm.TIER_IX == jm.TIER_IX
    for name in ("LATENCY_EDGES_MS", "QUEUE_EDGES", "OCC_EDGES"):
        assert getattr(tm, name) == getattr(jm, name)
    j = jm.init_metric_state()
    t = tm.init_metric_state("cpu")
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(t):
        assert tuple(getattr(t, f.name).shape) == \
            tuple(np.shape(getattr(j, f.name))), f.name


@pytest.mark.parametrize("edges,values", [
    ("LATENCY_EDGES_MS", [-1.0, 0.0, 0.5, 0.51, 9.99, 10.0, 4999.0, 5000.0,
                          7000.0]),
    ("QUEUE_EDGES", [0, 1, 3, 4, 127, 128, 129, 1000]),
    ("OCC_EDGES", [0.0, 0.1, 0.15, 0.5, 0.9, 0.95, 1.0])])
def test_bucket_equals_jax(edges, values):
    e = getattr(tm, edges)
    for v in values:
        want = int(jm._bucket(e, v))
        assert int(tm._bucket(e, torch.tensor(float(v)))[0]) == want, v


def _steps(seed=0, n=12):
    """Random step inputs, as the scheduler feeds them (S = 6 lanes)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        flags = rng.choice([0, 0, 0, 1, 2, 4, 5, 7], 6).astype(np.int32)
        log_z = rng.standard_normal(6).astype(np.float32) * 3
        ref = log_z + rng.standard_normal(6).astype(np.float32) * 0.05
        if i % 4 == 1:
            log_z[2] = np.nan
        active = rng.random(6) < 0.7
        out.append(dict(
            tier=("mimps", "topk")[i % 2], n_active=int(active.sum()),
            head_live=int(rng.integers(0, 40)),
            n_emitted=int(rng.integers(0, 7)), health_flags=flags,
            queue_depth=int(rng.integers(0, 200)),
            last_ms=float(rng.choice([-1.0, 0.3, 7.5, 10.0, 61.0, 9000.0])),
            last_tier=int(rng.integers(0, len(tm.TIERS))),
            shadow=(log_z, ref, active) if i % 3 == 0 else None,
            spec=(int(rng.integers(0, 24)), int(rng.integers(0, 24)),
                  int(rng.integers(0, 3))) if i % 2 else None))
    return out


def test_observe_and_harvest_equal_jax():
    j = jm.init_metric_state()
    t = tm.init_metric_state("cpu")
    ptrs = [getattr(t, f.name).data_ptr() for f in dataclasses.fields(t)]
    for s in _steps():
        spec = s["spec"] or (None, None, None)
        jsh = None if s["shadow"] is None else jm.shadow_rel_err(
            *(jnp.asarray(a) for a in s["shadow"]))
        tsh = None if s["shadow"] is None else tm.shadow_rel_err(
            *(torch.from_numpy(np.asarray(a)) for a in s["shadow"]))
        if jsh is not None:      # f32 sums of the same terms: 1e-6
            np.testing.assert_allclose([float(x) for x in tsh[:2]],
                                       [float(x) for x in jsh[:2]],
                                       rtol=1e-6)
            assert int(tsh[2]) == int(jsh[2])
        common = dict(n_active=s["n_active"], head_live=s["head_live"],
                      n_emitted=s["n_emitted"], queue_depth=s["queue_depth"],
                      last_ms=s["last_ms"], last_tier=s["last_tier"])
        j = jm.observe_step(
            j, jm.TIER_IX[s["tier"]], 6, health_flags=jnp.asarray(
                s["health_flags"]), shadow=jsh, spec_proposed=spec[0],
            spec_accepted=spec[1], draft_flagged=spec[2], **common)
        out = tm.observe_step(
            t, tm.TIER_IX[s["tier"]], 6, health_flags=torch.from_numpy(
                s["health_flags"]), shadow=tsh, spec_proposed=spec[0],
            spec_accepted=spec[1], draft_flagged=spec[2],
            **{k: torch.tensor(v) for k, v in common.items()})
        assert out is t
    th, jh = tm.harvest(t, 6), jm.harvest(j, 6)
    tsh, jsh = th.pop("shadow_by_tier"), jh.pop("shadow_by_tier")
    assert th == jh
    assert tsh.keys() == jsh.keys() == {"mimps", "topk"}
    for tier in tsh:
        assert tsh[tier]["count"] == jsh[tier]["count"]
        for name in ("rel_err_mean", "rel_err_max"):
            np.testing.assert_allclose(tsh[tier][name], jsh[tier][name],
                                       rtol=1e-6)
    assert [getattr(t, f.name).data_ptr()
            for f in dataclasses.fields(t)] == ptrs
    tm.reset_metric_state(t)
    assert tm.harvest(t, 6) == jm.harvest(jm.init_metric_state(), 6)
    assert [getattr(t, f.name).data_ptr()
            for f in dataclasses.fields(t)] == ptrs


def test_shadow_rel_err_masks_inactive_and_nonfinite():
    log_z = torch.tensor([1.0, 2.0, float("nan"), 4.0, float("inf")])
    ref = torch.tensor([1.1, 2.0, 3.0, float("-inf"), 5.0])
    active = torch.tensor([True, False, True, True, True])
    s, m, n = tm.shadow_rel_err(log_z, ref, active)
    js, jmx, jn = jm.shadow_rel_err(jnp.asarray(log_z.numpy()),
                                    jnp.asarray(ref.numpy()),
                                    jnp.asarray(active.numpy()))
    np.testing.assert_allclose([float(s), float(m)], [float(js), float(jmx)],
                               rtol=1e-6)      # expm1 to an ulp
    assert int(n) == int(jn) == 1


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 0.99, 1.0])
def test_hist_quantile_equals_jax(q):
    counts = [0, 3, 9, 0, 2, 1, 0, 0, 0, 0, 0, 0, 4]
    edges = tm.LATENCY_EDGES_MS
    assert tm.hist_quantile(counts, edges, q) == \
        jm.hist_quantile(counts, edges, q)
    assert np.isnan(tm.hist_quantile([0] * 13, edges, q))
