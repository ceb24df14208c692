"""Deterministic fault injection for the serving stack (counterpart of
``repro.serve.faults``).

Chaos harness for the scheduler/server: every injector is seeded and fires
on the scheduler's deterministic step counter, so a faulted run is exactly
reproducible. The contract the chaos tests pin: with any single injector
active, every NON-injected request completes with tokens bit-identical to
the fault-free run, nothing is captured again after warm-up but the one
capture a restored state needs, and no NaN/Inf ever reaches an emitted
log_prob / log_z.

Injection surfaces, matched to real failure modes:

 * ``NanLogitsFault`` / ``InfLogitsFault`` — corrupted activations or
   embedding rows for specific requests: flips the step's per-lane fault
   masks, device tensors written before the step (nothing is captured
   again; the blast radius is the lane), which the in-step health guard
   must catch and route through the exact fallback.
 * ``CorruptIndexFault`` — a bad ``swap_index`` / device bit-rot: installs
   a zeroed-block, permuted-block, or drifted copy of the engine's IVF
   state WITHOUT updating its digest. The scheduler's verify/restore
   cadence must repair it before any step consumes it.
 * ``AdmissionFault`` — dependency failure at admission time for specific
   requests: raises before the scheduler mutates anything; the server
   rejects with reason 'fault_injected'.
 * ``StepFault`` — a transient host-side exception at a step boundary
   (watchdog trip, preempted RPC): raises before the step runs;
   the server counts it and retries without advancing the virtual clock.

``CompositeFault`` chains several injectors. All hooks receive the live
``Scheduler`` — injectors may read its request map / step counter but must
only mutate state through the documented surfaces above.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


class FaultError(RuntimeError):
    """Raised by injectors to simulate a host-side failure. The scheduler
    guarantees it propagates BEFORE any device state mutates, so catching
    it and retrying is always safe."""


class FaultInjector:
    """Base injector: every hook is a no-op. Subclasses override the
    surface(s) they corrupt; the scheduler calls these at fixed points:

    - ``on_admit(request, sched)``   before admission mutates anything
    - ``on_step_begin(sched)``       before digest verify + the step
    - ``lane_faults(sched)``         -> None, or (nan_mask, inf_mask) bool
                                        arrays of shape (n_slots,)
    """

    def on_admit(self, request, sched) -> None:
        pass

    def on_step_begin(self, sched) -> None:
        pass

    def lane_faults(self, sched
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        return None


class CompositeFault(FaultInjector):
    """Run several injectors in sequence (lane masks OR together)."""

    def __init__(self, injectors: Sequence[FaultInjector]):
        self.injectors = list(injectors)

    def on_admit(self, request, sched) -> None:
        for inj in self.injectors:
            inj.on_admit(request, sched)

    def on_step_begin(self, sched) -> None:
        for inj in self.injectors:
            inj.on_step_begin(sched)

    def lane_faults(self, sched):
        nan = inf = None
        for inj in self.injectors:
            lanes = inj.lane_faults(sched)
            if lanes is None:
                continue
            n, i = (np.asarray(lanes[0], bool), np.asarray(lanes[1], bool))
            nan = n if nan is None else nan | n
            inf = i if inf is None else inf | i
        if nan is None:
            return None
        return nan, inf


class _LogitsFault(FaultInjector):
    """Shared machinery: flip the fault mask for targeted requests' lanes
    on the given scheduler steps."""

    _inf = False

    def __init__(self, req_ids: Iterable[int], steps: Iterable[int]):
        self.req_ids = set(int(r) for r in req_ids)
        self.steps = set(int(s) for s in steps)

    def lane_faults(self, sched):
        if sched.steps_done not in self.steps:
            return None
        mask = np.zeros((sched.n_slots,), bool)
        for s, req in enumerate(sched._slot_req):
            if req is not None and req.req_id in self.req_ids:
                mask[s] = True
        if not mask.any():
            return None
        zero = np.zeros_like(mask)
        return (zero, mask) if self._inf else (mask, zero)


class NanLogitsFault(_LogitsFault):
    """NaN log Ẑ + candidate scores for the targeted requests' lanes on the
    targeted steps (``steps`` index the scheduler's ``steps_done``)."""
    _inf = False


class InfLogitsFault(_LogitsFault):
    """Same as ``NanLogitsFault`` but +Inf — exercises the guard's Inf arm
    (an Inf that survives to sampling corrupts argmax silently rather than
    poisoning downstream sums, which is why both arms are pinned)."""
    _inf = True


class CorruptIndexFault(FaultInjector):
    """Install a corrupted copy of the current tier's retrieval state at
    step ``at_step`` (a bad swap or bit rot; fires once). The copy is made
    on the device; the engine's own tensors are not touched.

    mode:
      'zero'    - zero ``n_blocks`` IVF blocks (dead rows: the lanes
                  probing them lose mass silently)
      'permute' - swap the first ``2 * n_blocks`` blocks pairwise (routing
                  betrayal, which a plain checksum of sums would miss: the
                  digest is position-weighted)
      'drift'   - add seeded Gaussian noise of scale ``drift_scale``, drawn
                  by numpy from ``seed`` as the JAX package draws it (a
                  half-updated index after an interrupted swap)
    """

    def __init__(self, at_step: int, mode: str = "zero", n_blocks: int = 2,
                 seed: int = 0, drift_scale: float = 0.05):
        assert mode in ("zero", "permute", "drift")
        self.at_step = int(at_step)
        self.mode = mode
        self.n_blocks = int(n_blocks)
        self.seed = int(seed)
        self.drift_scale = float(drift_scale)
        self.fired = False

    def on_step_begin(self, sched) -> None:
        if self.fired or sched.steps_done != self.at_step:
            return
        self.fired = True
        eng = sched.engine
        state = eng.tier_state(sched.tier)
        if state is None or state.index is None:
            raise FaultError("CorruptIndexFault needs an index-backed tier")
        vb = state.index.v_blocks.clone()
        nb = vb.shape[0]
        if self.mode == "zero":
            vb[: min(self.n_blocks, nb)] = 0
        elif self.mode == "permute":
            for i in range(0, min(2 * self.n_blocks, nb - 1), 2):
                vb[[i, i + 1]] = vb[[i + 1, i]]
        else:
            rng = np.random.default_rng(self.seed)
            noise = torch.from_numpy(rng.standard_normal(vb.shape).astype(
                np.float32)).to(device=vb.device, dtype=vb.dtype)
            vb = vb + self.drift_scale * noise
        index = state.index._replace(v_blocks=vb)
        eng._install_state(dataclasses.replace(state, index=index),
                           method=sched.tier)


class AdmissionFault(FaultInjector):
    """Fail admission for the targeted request ids (dependency outage at
    the door). Raises before the scheduler mutates anything."""

    def __init__(self, req_ids: Iterable[int]):
        self.req_ids = set(int(r) for r in req_ids)

    def on_admit(self, request, sched) -> None:
        if request.req_id in self.req_ids:
            raise FaultError(
                f"injected admission failure for request {request.req_id}")


class StepFault(FaultInjector):
    """Raise at the given step boundaries, once each (transient host-side
    failure: the server must retry without advancing the virtual clock)."""

    def __init__(self, steps: Iterable[int]):
        self.steps = set(int(s) for s in steps)
        self._fired: set = set()

    def on_step_begin(self, sched) -> None:
        t = sched.steps_done
        if t in self.steps and t not in self._fired:
            self._fired.add(t)
            raise FaultError(f"injected step fault at step {t}")


__all__ = ["FaultError", "FaultInjector", "CompositeFault",
           "NanLogitsFault", "InfLogitsFault", "CorruptIndexFault",
           "AdmissionFault", "StepFault"]
