"""Device-resident serving metrics (counterpart of ``repro.obs.metrics``).

The scheduler carries one ``MetricState`` of counters and histograms on the
device and updates it inside its step, always: harvesting on or off and
the shadow oracle's cadence change only device data, never which captured
graph replays, so tokens stay bit-identical and nothing is captured again.
Updates read only values the step already computed (emitted counts, health
flags, the probe-union size); nothing here feeds back into the tokens.

Where the JAX package returns a new state, ``observe_step`` adds into the
tensors of the one it is given, in place: a CUDA graph keeps reading the
storage it captured.

``harvest`` is one device-to-host copy of the whole state. The step-latency
histogram is fed forward: the host times step N and hands the time to step
N + 1 as device data (``last_ms``, ``last_tier``); ``last_ms < 0`` (the
first step) records nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..core.backends import BACKENDS
from ..core.decode import (HEALTH_EMPTY_HEAD, HEALTH_NONFINITE_SCORE,
                           HEALTH_NONFINITE_Z)

# canonical tier order: every per-tier row of the state is indexed by the
# tier's position here
TIERS: tuple = tuple(sorted(BACKENDS))
TIER_IX: dict = {t: i for i, t in enumerate(TIERS)}

# bucket upper edges: value v lands in the first bucket whose edge is not
# below it; the last bucket is the +inf overflow
LATENCY_EDGES_MS: tuple = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0,
                           200.0, 500.0, 1000.0, 5000.0)
QUEUE_EDGES: tuple = (0, 1, 2, 4, 8, 16, 32, 64, 128)
OCC_EDGES: tuple = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)

_NT = len(TIERS)
_NL = len(LATENCY_EDGES_MS) + 1
_NQ = len(QUEUE_EDGES) + 1
_NO = len(OCC_EDGES) + 1


@dataclasses.dataclass
class MetricState:
    """Monotone counters (harvest reads cumulative values and never resets
    them mid-run); every field a device tensor, int32 unless noted."""
    steps: torch.Tensor            # ()   steps observed
    tokens_total: torch.Tensor     # ()   emitted tokens
    tokens_by_tier: torch.Tensor   # (T,) emitted tokens per estimator tier
    active_sum: torch.Tensor       # ()   sum of live lanes per step
    fill_sum: torch.Tensor         # ()   sum of probe-union live blocks
    queue_sum: torch.Tensor        # ()   sum of admission-queue depth
    queue_hist: torch.Tensor       # (NQ,) queue-depth histogram
    occ_hist: torch.Tensor         # (NO,) occupancy-fraction histogram
    latency_hist: torch.Tensor     # (T, NL) step-ms histogram per tier
    health_flagged: torch.Tensor   # ()   lane-steps the guard flagged
    health_by_cause: torch.Tensor  # (3,) nonfinite_z, empty_head,
                                   #      nonfinite_score lane-steps
    spec_proposed: torch.Tensor    # ()   speculative positions offered
    spec_accepted: torch.Tensor    # ()   speculative positions advanced
    draft_flagged: torch.Tensor    # ()   draft-health fallbacks to k = 1
    shadow_count: torch.Tensor     # (T,) lane-steps shadow-sampled
    shadow_err_sum: torch.Tensor   # (T,) f32 sum of |Ẑ/Z - 1|
    shadow_err_max: torch.Tensor   # (T,) f32 max |Ẑ/Z - 1|


def init_metric_state(device="cuda") -> MetricState:
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def zf(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    m = MetricState(
        steps=z(), tokens_total=z(), tokens_by_tier=z(_NT),
        active_sum=z(), fill_sum=z(), queue_sum=z(),
        queue_hist=z(_NQ), occ_hist=z(_NO), latency_hist=z(_NT, _NL),
        health_flagged=z(), health_by_cause=z(3),
        spec_proposed=z(), spec_accepted=z(), draft_flagged=z(),
        shadow_count=z(_NT), shadow_err_sum=zf(_NT), shadow_err_max=zf(_NT))
    # the bucket edges on the device, made here: a captured step cannot
    # copy them from the host (not a field: no counter)
    m.edges = {e: torch.tensor(e, dtype=torch.float32, device=dev)
               for e in (LATENCY_EDGES_MS, QUEUE_EDGES, OCC_EDGES)}
    return m


def reset_metric_state(m: MetricState) -> None:
    """Zero every counter in place (the tensors a graph captured stay)."""
    for f in dataclasses.fields(m):
        getattr(m, f.name).zero_()


def _bucket(edges: tuple, v, edge_tensors: dict = None) -> torch.Tensor:
    """Bucket (1,) of ``v`` (a device scalar): ``searchsorted(...,
    side='left')`` over f32 edges, as the JAX package buckets;
    ``edge_tensors`` (a state's ``edges``) holds them on the device."""
    v = torch.as_tensor(v).to(torch.float32)
    e = (edge_tensors or {}).get(edges)
    if e is None:
        e = torch.tensor(edges, dtype=torch.float32, device=v.device)
    return torch.searchsorted(e, v.reshape(1), side="left")


def _i32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).to(torch.int32)


def observe_step(m: MetricState, tier_ix: int, n_slots: int, *,
                 n_active, head_live, n_emitted, health_flags, queue_depth,
                 last_ms, last_tier, shadow=None, spec_proposed=None,
                 spec_accepted=None, draft_flagged=None) -> MetricState:
    """Add one step into ``m`` in place (no host read: it runs inside the
    captured step) and return it. Scalars are device tensors or Python
    numbers; ``shadow`` is ``shadow_rel_err``'s (sum, max, count)."""
    dev = m.steps.device
    hf = torch.as_tensor(health_flags, device=dev)
    flagged = (hf > 0).sum().to(torch.int32)
    causes = torch.stack([
        ((hf & HEALTH_NONFINITE_Z) > 0).sum(),
        ((hf & HEALTH_EMPTY_HEAD) > 0).sum(),
        ((hf & HEALTH_NONFINITE_SCORE) > 0).sum()]).to(torch.int32)
    n_emitted = _i32(n_emitted, dev)
    n_active = _i32(n_active, dev)
    lat_ok = (torch.as_tensor(last_ms, device=dev).to(torch.float32)
              >= 0.0).to(torch.int32)
    lat_b = _bucket(LATENCY_EDGES_MS, torch.as_tensor(last_ms, device=dev),
                    m.edges)
    occ_b = _bucket(OCC_EDGES, n_active.to(torch.float32) / n_slots,
                    m.edges)
    q_b = _bucket(QUEUE_EDGES, torch.as_tensor(queue_depth, device=dev),
                  m.edges)
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    m.steps.add_(1)
    m.tokens_total.add_(n_emitted)
    m.tokens_by_tier[tier_ix].add_(n_emitted)
    m.active_sum.add_(n_active)
    m.fill_sum.add_(_i32(head_live, dev))
    m.queue_sum.add_(_i32(queue_depth, dev))
    m.queue_hist.index_add_(0, q_b, one)
    m.occ_hist.index_add_(0, occ_b, one)
    tier_row = _i32(last_tier, dev).long().reshape(1)
    flat = tier_row * _NL + lat_b
    m.latency_hist.view(-1).index_add_(0, flat, lat_ok.reshape(1))
    m.health_flagged.add_(flagged)
    m.health_by_cause.add_(causes)
    for field, v in (("spec_proposed", spec_proposed),
                     ("spec_accepted", spec_accepted),
                     ("draft_flagged", draft_flagged)):
        if v is not None:
            getattr(m, field).add_(_i32(v, dev))
    if shadow is not None:
        sh_sum, sh_max, sh_n = shadow
        m.shadow_count[tier_ix].add_(_i32(sh_n, dev))
        m.shadow_err_sum[tier_ix].add_(
            torch.as_tensor(sh_sum, device=dev).to(torch.float32))
        torch.maximum(m.shadow_err_max[tier_ix],
                      torch.as_tensor(sh_max, device=dev).to(torch.float32),
                      out=m.shadow_err_max[tier_ix])
    return m


def shadow_rel_err(log_z, ref_log_z, active) -> tuple:
    """Masked relative error of the serving estimate against the exact
    shadow oracle, |exp(log Ẑ - log Z) - 1| = |Ẑ/Z - 1| (the paper's
    multiplicative error). Inactive lanes and non-finite values are left
    out. Returns the (sum, max, count) triple ``observe_step`` adds."""
    rel = torch.abs(torch.expm1(log_z.float() - ref_log_z.float()))
    ok = active.bool() & torch.isfinite(rel)
    relm = torch.where(ok, rel, torch.zeros_like(rel))
    return (relm.sum(), torch.clamp_min(relm.max(), 0.0),
            ok.sum().to(torch.int32))


def harvest(m: MetricState, n_slots: int) -> dict:
    """One device-to-host copy of the whole state, flattened into a plain
    dict (Python scalars and per-tier sub-dicts). Counters stay
    cumulative on the device."""
    g = {f.name: getattr(m, f.name).cpu().numpy()
         for f in dataclasses.fields(m)}
    steps = int(g["steps"])
    tiers_tok = {t: int(g["tokens_by_tier"][i]) for t, i in TIER_IX.items()
                 if int(g["tokens_by_tier"][i])}
    shadow = {}
    for t, i in TIER_IX.items():
        n = int(g["shadow_count"][i])
        if n:
            shadow[t] = {"count": n,
                         "rel_err_mean": float(g["shadow_err_sum"][i]) / n,
                         "rel_err_max": float(g["shadow_err_max"][i])}
    lat = {t: [int(c) for c in g["latency_hist"][i]]
           for t, i in TIER_IX.items() if int(g["latency_hist"][i].sum())}
    return {
        "steps": steps,
        "tokens_total": int(g["tokens_total"]),
        "tokens_by_tier": tiers_tok,
        "occupancy_mean": float(g["active_sum"]) / (max(steps, 1) * n_slots),
        "fill_mean": float(g["fill_sum"]) / max(steps, 1),
        "queue_depth_mean": float(g["queue_sum"]) / max(steps, 1),
        "queue_hist": [int(c) for c in g["queue_hist"]],
        "queue_edges": list(QUEUE_EDGES),
        "occ_hist": [int(c) for c in g["occ_hist"]],
        "occ_edges": list(OCC_EDGES),
        "latency_hist_by_tier": lat,
        "latency_edges_ms": list(LATENCY_EDGES_MS),
        "health_flagged": int(g["health_flagged"]),
        "health_by_cause": {
            "nonfinite_z": int(g["health_by_cause"][0]),
            "empty_head": int(g["health_by_cause"][1]),
            "nonfinite_score": int(g["health_by_cause"][2])},
        "spec_proposed": int(g["spec_proposed"]),
        "spec_accepted": int(g["spec_accepted"]),
        "draft_flagged": int(g["draft_flagged"]),
        "shadow_by_tier": shadow,
    }


def hist_quantile(counts, edges, q: float) -> float:
    """Quantile from a bucketed histogram: the upper edge of the bucket
    where the cumulative count crosses q (the last finite edge for the
    overflow bucket), never interpolated."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return float("nan")
    cum = np.cumsum(counts)
    b = int(np.searchsorted(cum, q * total))
    return float(edges[min(b, len(edges) - 1)])
