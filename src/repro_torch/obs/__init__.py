"""Live observability for the serving stack (counterpart of ``repro.obs``).

Three layers, composable and individually optional:

 * **Device-resident metrics** (``obs.metrics``): the scheduler updates one
   ``MetricState`` inside its step, always; the host harvests it on
   ``ObsConfig.harvest_every`` cadence into the registry.
 * **Per-request tracing** (``obs.tracing``): lifecycle spans (enqueue ->
   admit -> replay -> decode -> complete/shed/evict), per-step device/host
   phases, harvested counter tracks, and instants for the engine's index
   swaps and restores and the captures a state change forces, as
   Chrome-trace JSONL.
 * **Estimator-quality telemetry**: the shadow oracle (the gated exact
   ``topk_z`` inside the step, over ``active & do_shadow``) feeds a live
   per-tier rel-err stream; exposition through the Prometheus registry
   (``ObsConfig.metrics_port``) and JSON snapshots.

``Observability`` wires all of it to a ``serve.Server``: pass it as
``Server(sched, cfg, obs=Observability(ObsConfig(...)))``. The captured
steps are the same graphs with observability on or off (the metric state
is always updated; the cadence flags are data in the table's ``extras``),
so tokens stay bit-identical and nothing is captured for it.
"""
from __future__ import annotations

import math
import time
from typing import Optional

from ..configs.base import ObsConfig
from .metrics import (LATENCY_EDGES_MS, OCC_EDGES, QUEUE_EDGES, TIER_IX,
                      TIERS, MetricState, harvest, hist_quantile,
                      init_metric_state, observe_step, shadow_rel_err)
from .registry import MetricsRegistry
from .tracing import TraceWriter

__all__ = ["Observability", "ObsConfig", "MetricsRegistry", "TraceWriter",
           "MetricState", "TIERS", "TIER_IX", "LATENCY_EDGES_MS",
           "QUEUE_EDGES", "OCC_EDGES", "init_metric_state", "observe_step",
           "harvest", "hist_quantile", "shadow_rel_err"]


class Observability:
    """Host-side orchestrator: harvest cadence, span emission, exposition.

    All hooks are bookkeeping and buffered writes; the serving loop never
    blocks on a scrape: the HTTP server runs in a daemon thread against the
    registry's lock-protected map. The only device read it adds is the
    harvest, one copy of the metric state every ``harvest_every`` steps.
    """

    def __init__(self, cfg: Optional[ObsConfig] = None):
        self.cfg = cfg or ObsConfig()
        self.cfg.validate()
        self.registry = MetricsRegistry()
        self.tracer: Optional[TraceWriter] = (
            TraceWriter(self.cfg.trace_path) if self.cfg.trace_path
            else None)
        self.port: Optional[int] = (
            self.registry.serve(self.cfg.metrics_port)
            if self.cfg.metrics_port else None)
        self.last_harvest: dict = {}
        self._steps = 0
        self._harvests = 0
        self._tiers_seen = 0
        self._submit_at: dict = {}     # req_id -> wall stamp at enqueue

    # -- wiring ---------------------------------------------------------------

    def attach(self, server) -> None:
        """Bind to a ``serve.Server`` (called by its constructor). Sets the
        scheduler's shadow cadence and hooks the engine's index lifecycle
        events; everything else flows through the server's obs calls."""
        server.scheduler.shadow_every = self.cfg.shadow_every
        server.scheduler.engine.obs = self
        if self.tracer:
            self.tracer.instant("observability_attached", args={
                "tiers": list(TIERS),
                "shadow_every": self.cfg.shadow_every,
                "harvest_every": self.cfg.harvest_every})

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        """Engine- and scheduler-facing hook (index swap / restore, a
        capture again after a state change)."""
        if self.tracer:
            self.tracer.instant(name, args=args)

    # -- server lifecycle hooks ----------------------------------------------

    def on_submit(self, server, request) -> None:
        self._submit_at[request.req_id] = time.perf_counter()
        if self.tracer:
            self.tracer.instant("enqueue", tid=request.req_id, args={
                "req_id": request.req_id, "queue_depth": len(server.queue),
                "prompt_len": int(request.prompt.shape[0]),
                "max_new_tokens": request.max_new_tokens})

    def on_reject(self, server, request, reason: str) -> None:
        t0 = self._submit_at.pop(request.req_id, None)
        if self.tracer:
            now = time.perf_counter()
            self.tracer.name_thread(request.req_id,
                                    f"req {request.req_id}")
            if t0 is not None:
                self.tracer.span("queued", t0, now, tid=request.req_id,
                                 args={"outcome": reason})
            self.tracer.instant("shed", t=now, tid=request.req_id,
                                args={"reason": reason})

    def on_step(self, server, rec: dict) -> None:
        self._steps += 1
        if self.tracer:
            t0, td, te, tn = (rec.get("t_start"), rec.get("t_dispatch"),
                              rec.get("t_device_done"), rec.get("t_done"))
            if td is not None and te is not None:
                self.tracer.span(f"device_step:{rec['tier']}", td, te,
                                 args={"n_active": rec["n_active"],
                                       "n_emitted": rec["n_emitted"],
                                       "spec_accepted":
                                           rec.get("spec_accepted", 0)})
            if t0 is not None and tn is not None:
                self.tracer.span("host_step", te or t0, tn,
                                 args={"completions":
                                       len(rec["completions"])})
            for comp in rec["completions"]:
                self._trace_completion(comp)
            # tier transitions appended by the server since last look
            for step_i, tier in server.tier_transitions[self._tiers_seen:]:
                self.tracer.instant("tier_transition",
                                    args={"tier": tier, "step": step_i})
            self._tiers_seen = len(server.tier_transitions)
        else:
            for comp in rec["completions"]:
                self._submit_at.pop(comp.request.req_id, None)
            self._tiers_seen = len(server.tier_transitions)
        if self.cfg.metrics and self._steps % self.cfg.harvest_every == 0:
            self._harvest(server)

    def on_done(self, server, report) -> None:
        """End of a ``Server.run``: final harvest, report-level gauges, a
        last snapshot, flush. The trace stays open for back-to-back runs;
        call ``close()`` when finished."""
        if self.cfg.metrics:
            self._harvest(server, force_snapshot=bool(
                self.cfg.snapshot_path))
        r = self.registry
        for name, v in (("goodput_tok_s", report.goodput_tok_s),
                        ("p50_token_ms", report.p50_token_ms),
                        ("p95_token_ms", report.p95_token_ms),
                        ("p99_token_ms", report.p99_token_ms),
                        ("shed_rate", report.shed_rate)):
            if isinstance(v, float) and math.isnan(v):
                continue
            r.set(name, v, help="ServerReport." + name)
        if self.tracer:
            self.tracer.flush()

    def close(self) -> None:
        if self.tracer:
            self.tracer.close()
        self.registry.close()

    # -- internals ------------------------------------------------------------

    def _trace_completion(self, comp) -> None:
        req = comp.request
        tid = req.req_id
        t_sub = self._submit_at.pop(tid, None)
        self.tracer.name_thread(tid, f"req {tid}")
        if t_sub is not None and comp.admit_time >= t_sub:
            self.tracer.span("queued", t_sub, comp.admit_time, tid=tid)
        first = comp.first_token_time
        if first is not None:
            self.tracer.span("replay", comp.admit_time, first, tid=tid)
            self.tracer.span("decode", first, comp.done_time, tid=tid,
                             args={"tokens": len(comp.tokens)})
        outcome = comp.reason or ("overflow" if comp.overflowed else "ok")
        self.tracer.span("request", comp.admit_time, comp.done_time,
                         tid=tid, cat="request",
                         args={"req_id": tid, "tokens": len(comp.tokens),
                               "tiers": list(comp.tiers),
                               "outcome": outcome,
                               "error": comp.error or ""})
        if comp.error is not None:
            self.tracer.instant("evict", t=comp.done_time, tid=tid,
                                args={"reason": outcome})

    def _harvest(self, server, force_snapshot: bool = False) -> None:
        h = server.scheduler.harvest_metrics()
        self.last_harvest = h
        self._harvests += 1
        self._push_registry(h, server)
        if self.tracer:
            self.tracer.counter("queue_depth",
                                {"depth": len(server.queue)})
            self.tracer.counter("occupancy",
                                {"live_frac": h["occupancy_mean"]})
            if h["shadow_by_tier"]:
                self.tracer.counter(
                    "shadow_rel_err",
                    {t: s["rel_err_mean"]
                     for t, s in h["shadow_by_tier"].items()})
        if self.cfg.snapshot_path and (
                force_snapshot
                or self._harvests % self.cfg.snapshot_every == 0):
            self.registry.write_snapshot(
                self.cfg.snapshot_path,
                extra={"harvest": h, "harvests": self._harvests})

    def _push_registry(self, h: dict, server) -> None:
        r = self.registry
        r.set("serving_steps", h["steps"], mtype="counter",
              help="scheduler steps observed")
        r.set("serving_tokens_total", h["tokens_total"], mtype="counter",
              help="tokens emitted")
        for t, v in h["tokens_by_tier"].items():
            r.set("serving_tokens", v, labels={"tier": t}, mtype="counter")
        r.set("occupancy_mean", h["occupancy_mean"])
        r.set("queue_depth", len(server.queue))
        r.set("queue_depth_mean", h["queue_depth_mean"])
        r.set("probe_union_fill_mean", h["fill_mean"])
        r.set("health_flagged_total", h["health_flagged"], mtype="counter")
        for cause, v in h["health_by_cause"].items():
            r.set("health_cause_total", v, labels={"cause": cause},
                  mtype="counter")
        r.set("spec_proposed_total", h["spec_proposed"], mtype="counter")
        r.set("spec_accepted_total", h["spec_accepted"], mtype="counter")
        r.set("draft_flagged_total", h["draft_flagged"], mtype="counter")
        for t, s in h["shadow_by_tier"].items():
            r.set("shadow_samples_total", s["count"], labels={"tier": t},
                  mtype="counter",
                  help="lane-steps shadow-sampled against exact log Z")
            r.set("shadow_rel_err_mean", s["rel_err_mean"],
                  labels={"tier": t},
                  help="mean |Zhat/Z - 1| over shadow samples")
            r.set("shadow_rel_err_max", s["rel_err_max"],
                  labels={"tier": t})
        for t, counts in h["latency_hist_by_tier"].items():
            cum = 0
            edges = list(h["latency_edges_ms"]) + ["+Inf"]
            for edge, c in zip(edges, counts):
                cum += c
                r.set("step_latency_ms_bucket", cum,
                      labels={"tier": t, "le": str(edge)},
                      mtype="histogram")
