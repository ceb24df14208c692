"""Traffic-facing serving loop over the slot scheduler (counterpart of
``repro.serve.server``).

The ``Scheduler`` is mechanism (slot table + one mixed step, a CUDA graph a
tier on a GPU); the
``Server`` is policy: an admission queue, arrival processes (Poisson or a
replayed trace), slot recycling back into admission, streaming per-token /
per-request callbacks, and the latency accounting the serving benchmark
reports.

Time model: arrivals are scheduled on a **virtual step clock** (a request
"arrives" at step t), which keeps traffic generation deterministic and
backend-speed-independent — the same trace replays bit-identically on any
machine. Latency metrics are real wall-clock, measured around the step.
When the table drains and the queue is empty but arrivals remain in
the future, the clock fast-forwards to the next arrival (idle steps are not
simulated).

Overload policy (``configs.ServingConfig``, all knobs in virtual steps):

 * **Backpressure.** A bounded admission queue sheds over-watermark
   arrivals at submit time ('queue_full') and expired entries at the next
   admission boundary ('deadline_queue') — every shed is an errored,
   token-less completion with a machine-readable reason, never a silent
   drop. Queue wait is recorded for shed requests too (they waited; the
   report should say so).
 * **Deadlines.** A request's deadline (its own or the config default)
   counts down from submission; the *remaining* budget at admission becomes
   the lane's traced eviction countdown, so queue wait spends the same
   budget service does.
 * **Graceful degradation.** Under sustained queue pressure the server
   walks the scheduler DOWN an estimator-tier ladder (e.g. mimps -> topk:
   cheaper steps drain the backlog) and back UP with hysteresis — separate
   high/low watermarks plus consecutive-step debounce, so an oscillating
   queue cannot flap the tier. After warm-up a tier switch captures
   nothing (each tier's step is captured once; see
   ``Scheduler.set_tier``).
 * **Fault containment.** A ``FaultError`` raised at a step boundary (the
   injection harness, serve.faults) is counted and retried without
   advancing the virtual clock — the device table was never touched, so
   non-injected requests stay bit-identical to a fault-free run.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ServingConfig
from ..core.backends import BACKENDS
from .faults import FaultError
from .scheduler import Completion, Request, Scheduler


@dataclasses.dataclass
class Arrival:
    at_step: float
    request: Request


def poisson_arrivals(requests: Sequence[Request], rate: float,
                     seed: int = 0) -> List[Arrival]:
    """Poisson process on the virtual step clock: inter-arrival gaps are
    Exp(rate) steps (``rate`` = expected requests per scheduler step)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for req in requests:
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        out.append(Arrival(at_step=t, request=req))
    return out


def trace_arrivals(requests: Sequence[Request],
                   at_steps: Sequence[float]) -> List[Arrival]:
    """Replay a recorded trace: request i arrives at virtual step
    ``at_steps[i]``."""
    assert len(requests) == len(at_steps)
    return sorted((Arrival(float(t), r)
                   for t, r in zip(at_steps, requests)),
                  key=lambda a: a.at_step)


_DEFAULT_LADDERS: Dict[str, Tuple[str, ...]] = {
    # ordered most-accurate -> cheapest; every rung shares the engine's IVF
    # index (Engine.tier_state), so walking down is free of rebuilds
    "mimps": ("mimps", "topk"),
    "mince": ("mince", "mimps", "topk"),
    "fmbe": ("fmbe", "topk"),
}
# every other registered backend degrades within itself: the REGISTRY is
# the source of truth (a new backend is never silently unladderable), and a
# singleton ladder is the right default for backends that share no IVF
# index with the topk rung (lsh: stepping "down" to topk would force a
# k-means build the engine never made, and exact is costlier, not cheaper)
for _m in sorted(BACKENDS):
    _DEFAULT_LADDERS.setdefault(_m, (_m,))


def default_ladder(method: str) -> Tuple[str, ...]:
    """The degradation ladder used when ``ServingConfig.degrade_ladder`` is
    empty: start at the engine's own method, step down through cheaper
    index-sharing tiers, end at head-only top-k (Eq. 4) — the rung that
    keeps lanes moving when everything else is too slow."""
    return _DEFAULT_LADDERS.get(method, (method,))


@dataclasses.dataclass
class ServerReport:
    completions: List[Completion]
    wall_s: float                  # first admission -> last completion
    steps: int
    goodput_tok_s: float           # emitted tokens / wall_s
    p50_token_ms: float            # per-token latency percentiles over all
    p95_token_ms: float            #   emitted tokens (gap to previous token
                                   #   of the same request; first token:
                                   #   admission -> emit)
    p99_token_ms: float            # tail percentile of the same series
    peak_concurrency: int          # max live lanes reached during the run
    occupancy_mean: float          # mean live-lane fraction over live steps
    occupancy_steady: float        # same, but only while demand exceeded
                                   #   capacity (queue non-empty at step
                                   #   start) — the saturation figure
    dedup_ratio_mean: Optional[float]  # mean U / (n_active * n_probe)
    dedup_by_fill: dict            # n_active -> mean dedup ratio
    queue_wait_steps_mean: float   # admission queueing delay (virtual
                                   #   steps) — includes shed requests
    # -- overload / robustness accounting ------------------------------------
    rejects_by_reason: Dict[str, int] = dataclasses.field(
        default_factory=dict)      # reason code -> count over every errored
                                   # completion (sheds, evictions, flushes)
    shed_rate: float = 0.0         # errored completions / all completions
    queue_depth_peak: int = 0      # max queue depth reached
    tokens_by_tier: Dict[str, int] = dataclasses.field(default_factory=dict)
    degraded_token_frac: float = 0.0   # tokens emitted below the top tier
    tier_transitions: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)      # (virtual step, new tier)
    health: Dict[str, int] = dataclasses.field(default_factory=dict)
                                   # estimator health-guard counters summed
                                   # over the run (lane-steps flagged)
    index_restores: int = 0        # digest-verify mismatches repaired
    step_faults: int = 0           # FaultErrors caught + retried at step
                                   # boundaries
    # -- raw-speed accounting -------------------------------------------------
    admit_skipped: int = 0         # look-ahead admission holds
    spec_proposed: int = 0         # lane-positions offered by speculative
                                   # rounds (n_active * spec_k per step)
    spec_accepted: int = 0         # lane-positions actually advanced
    spec_acceptance: float = 0.0   # accepted / proposed (0 when spec off)
    spec_acceptance_by_tier: Dict[str, float] = dataclasses.field(
        default_factory=dict)      # per VERIFIER tier (the ladder walks the
                                   # verifier; the draft stays fixed)
    draft_flagged: int = 0         # lane-rounds where the draft pass was
                                   # health-flagged -> non-spec fallback
    prefix: Dict[str, int] = dataclasses.field(default_factory=dict)
                                   # this run's prefix-pool deltas: hits,
                                   # saved_steps, inserted, evictions
    # -- step-time attribution: device vs host split -------------------------
    step_device_ms_mean: float = 0.0   # mean step + readback time
    step_host_ms_mean: float = 0.0     # mean host bookkeeping/callback time
                                       # per step (previously swallowed into
                                       # the latency figure)

    def summary(self) -> str:
        ded = f"{self.dedup_ratio_mean:.2f}" \
            if self.dedup_ratio_mean is not None else "n/a"
        base = (f"{len(self.completions)} requests, {self.steps} steps, "
                f"{self.goodput_tok_s:.1f} tok/s goodput, per-token p50 "
                f"{self.p50_token_ms:.2f}ms p95 {self.p95_token_ms:.2f}ms "
                f"p99 {self.p99_token_ms:.2f}ms, step device "
                f"{self.step_device_ms_mean:.2f}ms + host "
                f"{self.step_host_ms_mean:.2f}ms, "
                f"occupancy {self.occupancy_mean:.2f} "
                f"(steady {self.occupancy_steady:.2f}), probe dedup {ded}")
        if self.rejects_by_reason or self.tier_transitions or \
                self.index_restores or self.step_faults:
            base += (f"; shed {self.shed_rate:.2f} {self.rejects_by_reason}"
                     f", degraded frac {self.degraded_token_frac:.2f} "
                     f"({len(self.tier_transitions)} tier moves), "
                     f"{self.index_restores} index restores, "
                     f"{self.step_faults} step faults")
        if self.spec_proposed:
            base += (f"; spec acceptance {self.spec_acceptance:.2f} "
                     f"({self.spec_accepted}/{self.spec_proposed}, "
                     f"{self.draft_flagged} draft-flagged)")
        if self.prefix.get("hits") or self.prefix.get("inserted"):
            base += (f"; prefix hits {self.prefix.get('hits', 0)} saving "
                     f"{self.prefix.get('saved_steps', 0)} replay steps")
        if self.admit_skipped:
            base += f"; {self.admit_skipped} admission holds"
        return base


class Server:
    """Admission queue + run loop around one ``Scheduler``.

    Requests enter via ``submit`` (immediate) or a pre-built arrival list
    (``run(arrivals=...)``); free slots are filled FIFO from the queue at
    every step boundary, so a completion recycles its lane into the next
    queued request on the very next step. ``cfg`` (``ServingConfig``)
    activates the overload policy; the default config keeps every mechanism
    off and reproduces the plain unbounded loop.

    Under the serving mesh every rank runs its own ``Server`` on the same
    arrivals (the SPMD host of ``serve.scheduler``).
    """

    def __init__(self, scheduler: Scheduler,
                 cfg: Optional[ServingConfig] = None, obs=None):
        self.scheduler = scheduler
        self.cfg = cfg or ServingConfig()
        self.cfg.validate()
        # optional observability layer (obs.Observability): harvest cadence,
        # span tracing, shadow sampling. The captured steps are the same
        # with or without it: obs only reads.
        self.obs = obs
        if obs is not None:
            obs.attach(self)
        scheduler.verify_index_every = self.cfg.verify_index_every
        if not scheduler.steps_done:
            # policy reaches mechanism only before the first step: the
            # guard is part of each tier's captured step
            scheduler.health_guard = self.cfg.health_guard
        self.ladder: Tuple[str, ...] = tuple(
            self.cfg.degrade_ladder or default_ladder(scheduler.tier))
        for tier in self.ladder:
            if tier not in BACKENDS:
                raise ValueError(
                    f"unknown degradation tier {tier!r}; registered "
                    f"backends: {sorted(BACKENDS)}")
        self.queue: deque = deque()
        self._queued_at: dict = {}      # req_id -> virtual step queued
        self._deadline_at: dict = {}    # req_id -> absolute deadline step
        self._admit_skips: dict = {}    # req_id -> look-ahead holds so far
        self.admit_skipped = 0
        # per-run accumulators, reset by run() (entries are dropped from
        # _queued_at at admission so bookkeeping stays bounded)
        self._run_waits: List[float] = []
        self._rejected: List[Completion] = []
        self._step_faults = 0
        self._tier_ix = 0
        self._pressure = 0
        self._calm = 0
        self.tier_transitions: List[Tuple[int, str]] = []
        self.step_i = 0

    def submit(self, request: Request) -> None:
        cfg = self.cfg
        if cfg.max_queue and len(self.queue) >= cfg.max_queue:
            # backpressure: shed at the door instead of growing an unbounded
            # backlog every queued request then times out in
            self._reject(request, "queue_full",
                         f"admission queue full ({cfg.max_queue})")
            return
        ddl = request.deadline or cfg.default_deadline
        if ddl:
            self._deadline_at[request.req_id] = self.step_i + int(ddl)
        self._queued_at[request.req_id] = float(self.step_i)
        self.queue.append(request)
        if self.obs is not None:
            self.obs.on_submit(self, request)

    def _reject(self, req: Request, reason: str, error: str,
                queued_at: Optional[float] = None) -> None:
        """Close a request out as an errored, token-less completion. The
        queue wait (if it queued at all) is recorded — shed requests waited
        too, and hiding them would flatter the wait metric."""
        now = time.perf_counter()
        if queued_at is not None:
            self._run_waits.append(self.step_i - queued_at)
        self._deadline_at.pop(req.req_id, None)
        comp = Completion(request=req, tokens=[], log_probs=[], log_zs=[],
                          admit_time=now, first_token_time=None,
                          done_time=now, error=error, reason=reason)
        self._rejected.append(comp)
        if self.obs is not None:
            self.obs.on_reject(self, req, reason)
        if req.on_complete is not None:
            req.on_complete(req, comp)

    def _admit_ready(self) -> None:
        """Fill free lanes from the queue. A request whose deadline lapsed
        while it queued is shed before it pays for prefill; one that cannot
        be admitted is rejected alone. Default: strict FIFO. With
        ``admit_window > 0`` the pass looks ahead: a request whose cached
        prefix's owner replica has no free lane is held (put back at the
        queue head in order), so later requests that fit elsewhere admit
        instead of waiting behind it. Each hold is counted
        (``admit_skipped``); a request held ``admit_hold`` times, or whose
        deadline is within ``admit_hold`` steps, admits anywhere and
        forfeits its hit, so none starves past its deadline."""
        cfg = self.cfg
        held: List[Request] = []
        while self.queue and self.scheduler.n_free:
            req = self.queue.popleft()
            queued = self._queued_at.get(req.req_id, self.step_i)
            ddl_at = self._deadline_at.get(req.req_id)
            if ddl_at is not None and ddl_at - self.step_i < 1:
                # expired while queued: shed before paying for prefill
                self._queued_at.pop(req.req_id, None)
                self._admit_skips.pop(req.req_id, None)
                self._reject(req, "deadline_queue",
                             f"deadline lapsed after {self.step_i - queued:g}"
                             " steps in queue", queued_at=queued)
                continue
            if cfg.admit_window and len(held) < cfg.admit_window:
                _, owner = self.scheduler.prefix_preview(req)
                if owner is not None and \
                        self.scheduler.free_in_replica(owner) == 0:
                    skips = self._admit_skips.get(req.req_id, 0)
                    starving = skips + 1 >= cfg.admit_hold or (
                        ddl_at is not None
                        and ddl_at - self.step_i <= cfg.admit_hold)
                    if not starving:
                        self._admit_skips[req.req_id] = skips + 1
                        self.admit_skipped += 1
                        held.append(req)
                        continue
            self._queued_at.pop(req.req_id, None)
            self._admit_skips.pop(req.req_id, None)
            remaining = None if ddl_at is None else int(ddl_at - self.step_i)
            try:
                self.scheduler.admit(req, deadline_steps=remaining)
            except FaultError as e:
                # injected admission failure: reject cleanly, nothing else
                # in the batch is touched (admit raises before any mutation)
                self._reject(req, "fault_injected", str(e), queued_at=queued)
                continue
            except ValueError as e:
                # one unadmittable request (over cache capacity, empty
                # prompt) must not kill the loop for every other request:
                # reject it with an errored, token-less completion
                self._reject(req, "admit_rejected", str(e), queued_at=queued)
                continue
            self._deadline_at.pop(req.req_id, None)
            self._run_waits.append(self.step_i - queued)
        for req in reversed(held):
            self.queue.appendleft(req)

    def _update_tier(self) -> None:
        """Hysteresis ladder walk on queue depth. Pressure (depth >= high)
        must persist ``degrade_after`` consecutive steps to step down; calm
        (depth <= low) must persist ``restore_after`` steps to step up; the
        dead band between the watermarks holds the current tier and resets
        neither direction into flapping."""
        cfg = self.cfg
        if not cfg.degrade_high or len(self.ladder) < 2:
            return
        depth = len(self.queue)
        if depth >= cfg.degrade_high:
            self._pressure += 1
            self._calm = 0
        elif depth <= cfg.degrade_low:
            self._calm += 1
            self._pressure = 0
        else:
            self._pressure = 0
            self._calm = 0
        if self._pressure >= cfg.degrade_after and \
                self._tier_ix < len(self.ladder) - 1:
            self._tier_ix += 1
            self._pressure = 0
            self.scheduler.set_tier(self.ladder[self._tier_ix])
            self.tier_transitions.append(
                (self.step_i, self.ladder[self._tier_ix]))
        elif self._calm >= cfg.restore_after and self._tier_ix > 0:
            self._tier_ix -= 1
            self._calm = 0
            self.scheduler.set_tier(self.ladder[self._tier_ix])
            self.tier_transitions.append(
                (self.step_i, self.ladder[self._tier_ix]))

    def run(self, arrivals: Optional[Sequence[Arrival]] = None,
            max_steps: int = 100_000,
            on_step: Optional[Callable] = None) -> ServerReport:
        """Drive the loop until every submitted/arriving request completes
        (or ``max_steps``). Returns the traffic report. Hitting
        ``max_steps`` FLUSHES all queued and in-flight work as errored
        completions ('server_stopped') — accounting always balances, nothing
        is silently stranded."""
        pending = deque(sorted(arrivals or [], key=lambda a: a.at_step))
        completions: List[Completion] = []
        token_lat: List[float] = []
        steady_occ: List[float] = []
        run_records: List[dict] = []    # THIS run's step records only — a
                                        # reused/warmed scheduler must not
                                        # leak its history into the report
        t_start = None
        t_end = None
        steps = 0
        queue_depth_peak = 0
        # _run_waits/_rejected are NOT reset here: sheds recorded by
        # submit() calls made before run() (queue_full backpressure) belong
        # to this run's report; both reset after the report is assembled
        self._step_faults = 0
        self.admit_skipped = 0
        self._admit_skips = {}
        self.tier_transitions = []
        self._tier_ix = 0
        self._pressure = 0
        self._calm = 0
        pf0 = self.scheduler.prefix.stats() \
            if self.scheduler.prefix is not None else None
        self.scheduler.set_tier(self.ladder[0])
        while steps < max_steps:
            while pending and pending[0].at_step <= self.step_i:
                self.submit(pending.popleft().request)
            queue_depth_peak = max(queue_depth_peak, len(self.queue))
            if not self.queue and self.scheduler.n_in_flight == 0:
                if not pending:
                    break
                # fast-forward the idle gap to the next arrival
                self.step_i = max(self.step_i, int(np.ceil(
                    pending[0].at_step)))
                continue
            demand_backed_up = bool(self.queue)
            self._admit_ready()
            self._update_tier()
            if self.scheduler.n_in_flight == 0:
                # everything queued was rejected at admission: nothing to
                # step (and no occupancy sample to take)
                continue
            if t_start is None:
                t_start = time.perf_counter()
            try:
                rec = self.scheduler.step(queue_depth=len(self.queue))
            except FaultError:
                # injected step-boundary fault: the step never ran,
                # the table is unadvanced — count it, burn one loop
                # iteration against max_steps (bounding retry storms) and
                # retry WITHOUT advancing the virtual clock, so arrival
                # timing and every request's tokens are unchanged
                self._step_faults += 1
                steps += 1
                continue
            run_records.append(rec)
            now = time.perf_counter()
            if demand_backed_up:
                steady_occ.append(rec["occupancy"])
            for comp in rec["completions"]:
                completions.append(comp)
                t_end = now
            self.step_i += 1
            steps += 1
            if self.obs is not None:
                self.obs.on_step(self, rec)
            if on_step is not None:
                on_step(self, rec)
        # flush: anything still queued or in-flight at exit (max_steps hit)
        # becomes an errored completion instead of being silently stranded
        while self.queue:
            req = self.queue.popleft()
            queued = self._queued_at.pop(req.req_id, self.step_i)
            self._reject(req, "server_stopped",
                         "server stopped before admission", queued_at=queued)
        drained = self.scheduler.drain("server_stopped")
        if drained:
            completions.extend(drained)
            t_end = time.perf_counter()
        # latency accounting from completion records: token i's latency is
        # the gap between consecutive emissions; completions record only the
        # first/last stamps, so spread the post-first-token budget evenly —
        # the steady-state decode cadence (every live lane emits once per
        # step) makes this exact up to scheduler jitter.
        for comp in completions:
            n = len(comp.tokens)
            if n == 0:
                continue
            first = (comp.first_token_time or comp.done_time) \
                - comp.admit_time
            token_lat.append(first)
            if n > 1 and comp.first_token_time is not None:
                per = (comp.done_time - comp.first_token_time) / (n - 1)
                token_lat.extend([per] * (n - 1))
        total_tokens = sum(len(c.tokens) for c in completions)
        wall = (t_end - t_start) \
            if (t_start is not None and t_end is not None) else float("nan")
        n_probe = self.scheduler.engine.cfg.partition.n_probe
        live = [r for r in run_records if r["n_active"] > 0]
        occ = [r["occupancy"] for r in live]
        waits = self._run_waits
        completions.extend(self._rejected)
        self._run_waits = []
        self._rejected = []
        fills: dict = {}
        for r in live:
            if r["head_live"] > 0:
                fills.setdefault(r["n_active"], []).append(
                    r["head_live"] / (r["n_active"] * n_probe))
        dedup = [x for v in fills.values() for x in v]
        rejects: Dict[str, int] = {}
        for c in completions:
            if c.error is not None:
                reason = c.reason or "error"
                rejects[reason] = rejects.get(reason, 0) + 1
        tokens_by_tier: Dict[str, int] = {}
        health = {"flagged": 0, "nonfinite_z": 0, "empty_head": 0,
                  "nonfinite_score": 0}
        index_restores = 0
        for r in run_records:
            tier = r.get("tier", self.ladder[0])
            tokens_by_tier[tier] = tokens_by_tier.get(tier, 0) \
                + r.get("n_emitted", 0)
            health["flagged"] += r.get("health_flagged", 0)
            health["nonfinite_z"] += r.get("health_nonfinite_z", 0)
            health["empty_head"] += r.get("health_empty_head", 0)
            health["nonfinite_score"] += r.get("health_nonfinite_score", 0)
            index_restores += int(r.get("index_restored", False))
        degraded = sum(v for k, v in tokens_by_tier.items()
                       if k != self.ladder[0])
        n_errored = sum(1 for c in completions if c.error is not None)
        # speculative-decoding accounting: acceptance overall and per
        # VERIFIER tier (rounds the ladder served at a lower rung verify
        # with that rung's backend; the draft never moves)
        spec_proposed = sum(r.get("spec_proposed", 0) for r in run_records)
        spec_accepted = sum(r.get("spec_accepted", 0) for r in run_records)
        draft_flagged = sum(r.get("draft_flagged", 0) for r in run_records)
        spec_by_tier: Dict[str, List[int]] = {}
        for r in run_records:
            if r.get("spec_proposed"):
                ent = spec_by_tier.setdefault(r["tier"], [0, 0])
                ent[0] += r.get("spec_accepted", 0)
                ent[1] += r["spec_proposed"]
        prefix_stats: Dict[str, int] = {}
        if pf0 is not None:
            pf1 = self.scheduler.prefix.stats()
            prefix_stats = {k: pf1[k] - pf0[k] for k in pf0
                            if k != "cached_blocks"}
            prefix_stats["cached_blocks"] = pf1["cached_blocks"]
        dev_ms = [r["wall_device_s"] * 1e3 for r in run_records
                  if "wall_device_s" in r]
        host_ms = [r["wall_host_s"] * 1e3 for r in run_records
                   if "wall_host_s" in r]
        report = ServerReport(
            completions=completions,
            wall_s=wall,
            steps=steps,
            goodput_tok_s=total_tokens / wall if wall and wall > 0
            else float("nan"),
            p50_token_ms=float(np.percentile(token_lat, 50) * 1e3)
            if token_lat else float("nan"),
            p95_token_ms=float(np.percentile(token_lat, 95) * 1e3)
            if token_lat else float("nan"),
            p99_token_ms=float(np.percentile(token_lat, 99) * 1e3)
            if token_lat else float("nan"),
            step_device_ms_mean=float(np.mean(dev_ms)) if dev_ms else 0.0,
            step_host_ms_mean=float(np.mean(host_ms)) if host_ms else 0.0,
            peak_concurrency=max((r["n_active"] for r in live), default=0),
            occupancy_mean=float(np.mean(occ)) if occ else 0.0,
            occupancy_steady=float(np.mean(steady_occ)) if steady_occ
            else (float(np.mean(occ)) if occ else 0.0),
            dedup_ratio_mean=float(np.mean(dedup)) if dedup else None,
            dedup_by_fill={k: float(np.mean(v))
                           for k, v in sorted(fills.items())},
            queue_wait_steps_mean=float(np.mean(waits)) if waits else 0.0,
            rejects_by_reason=rejects,
            shed_rate=n_errored / len(completions) if completions else 0.0,
            queue_depth_peak=queue_depth_peak,
            tokens_by_tier=tokens_by_tier,
            degraded_token_frac=degraded / max(1, total_tokens),
            tier_transitions=list(self.tier_transitions),
            health=health,
            index_restores=index_restores,
            step_faults=self._step_faults,
            admit_skipped=self.admit_skipped,
            spec_proposed=spec_proposed,
            spec_accepted=spec_accepted,
            spec_acceptance=spec_accepted / spec_proposed
            if spec_proposed else 0.0,
            spec_acceptance_by_tier={t: a / p for t, (a, p)
                                     in sorted(spec_by_tier.items())},
            draft_flagged=draft_flagged,
            prefix=prefix_stats)
        if self.obs is not None:
            self.obs.on_done(self, report)
        return report
