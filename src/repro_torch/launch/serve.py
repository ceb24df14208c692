"""Traffic-driven serving: continuous batching over the slot scheduler
(counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --reduced --slots 8 --requests 16 --rate 1.0 --gen 12 --method mimps

Generates a Poisson arrival stream of mixed-length, mixed-temperature
requests, serves it through ``serve.Server`` (admission queue, one CUDA
graph a tier, slot recycling, streaming callbacks) and prints the traffic
report. ``--sequential`` adds a one-request-at-a-time ``generate`` pass
over the same workload and counts the requests whose tokens equal the slot
table's (bit-equal on the CPU; on the card a batch of one may round
otherwise than the slot table's 16 lanes).

``--device`` is ``cuda`` (the hand-written kernels) by default or ``cpu``
(their plain versions); there is no fallback from one to the other.
``--method`` choices come from the estimator-backend registry.

Overload policy is driven by the ``ServingConfig`` flags: ``--max-queue``
bounds the admission queue, ``--deadline`` stamps a default deadline in
virtual steps, and ``--degrade-high/--degrade-low/--degrade-after/
--restore-after`` (with an optional ``--ladder``) walk the estimator-tier
ladder under sustained queue pressure. ``--spec-draft topk --spec-k 4``
turns on estimator-speculative decoding; ``--prefix-cache-blocks N`` the
shared-prefix KV pool; ``--admit-window`` bounded admission look-ahead.

``--mesh data=K,model=M`` serves over a (data, model) process mesh
(``launch.mesh.make_serving_mesh``): run it under ``torchrun`` with K * M
ranks (or in ranks whose default group is already initialised). The group
is NCCL on ``cuda`` and gloo on ``cpu``; ``--dist-backend gloo`` puts
several ranks on one card (their steps then run eagerly).

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \\
        --reduced --mesh data=1,model=2 --slots 4 --requests 6 --gen 4
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs import ServingConfig, get_config, reduced_config
from ..configs.base import ObsConfig
from ..core.backends import BACKENDS
from ..models import Model
from ..obs import Observability
from ..serve import (Engine, Request, Scheduler, Server, generate,
                     poisson_arrivals)
from ..serve.scheduler import vlm_refusal


def build_workload(n: int, vocab: int, gen: int, pmin: int, pmax: int,
                   temperature: float, seed: int) -> List[Request]:
    """Mixed prompt lengths cycling [pmin..pmax], alternating greedy and
    sampled: the JAX workload's prompts, lengths and temperatures (numpy
    ``default_rng(seed)``); request ``i`` draws its noise from a generator
    seeded ``seed + 1000 + i``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p_len = pmin + (i * 3) % max(pmax - pmin + 1, 1)
        prompt = rng.integers(0, vocab, size=(p_len,), dtype=np.int32)
        reqs.append(Request(
            prompt=prompt, max_new_tokens=gen, seed=seed + 1000 + i,
            temperature=0.0 if i % 2 == 0 else temperature))
    return reqs


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--method", default=None,
                    choices=[None] + sorted(BACKENDS))
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="expected arrivals per scheduler step")
    ap.add_argument("--prompt-len-min", type=int, default=4)
    ap.add_argument("--prompt-len-max", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="sampled requests' temperature (every other "
                         "request decodes greedily)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--mesh", default=None, metavar="data=K,model=M",
                    help="serve over a (data, model) process mesh: slot "
                         "lanes split across K replicas, the output "
                         "embedding and IVF index across M shards (K * M "
                         "ranks under torchrun; tokens as one device's)")
    ap.add_argument("--dist-backend", default="", choices=("", "nccl",
                                                           "gloo"),
                    help="the mesh's process-group backend under torchrun "
                         "(default: nccl on cuda, gloo on cpu; gloo for "
                         "several ranks on one card)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the admission queue; arrivals over the "
                         "bound are shed with reason 'queue_full' "
                         "(0 = unbounded)")
    ap.add_argument("--deadline", type=int, default=0,
                    help="default per-request deadline in virtual steps: "
                         "expired queue entries are shed, in-flight lanes "
                         "evicted mid-decode (0 = no deadlines)")
    ap.add_argument("--degrade-high", type=int, default=0,
                    help="queue depth at/above which sustained pressure "
                         "steps the estimator tier DOWN the ladder "
                         "(0 = degradation off)")
    ap.add_argument("--degrade-low", type=int, default=0,
                    help="queue depth at/below which sustained calm "
                         "restores the tier back UP")
    ap.add_argument("--degrade-after", type=int, default=3,
                    help="consecutive over-watermark steps before "
                         "degrading")
    ap.add_argument("--restore-after", type=int, default=8,
                    help="consecutive under-watermark steps before "
                         "restoring")
    ap.add_argument("--ladder", default=None,
                    help="comma list of tiers, most-accurate first (default:"
                         " the method's built-in ladder, e.g. mimps,topk)")
    ap.add_argument("--spec-draft", default=None,
                    choices=[None] + sorted(BACKENDS),
                    help="estimator-speculative decoding: draft tier that "
                         "proposes --spec-k tokens per lane inside the one "
                         "step; the lane's serving tier verifies all of "
                         "them in a single batched pass (tokens stay "
                         "bit-identical; typically 'topk' or 'fmbe')")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per lane per speculative round "
                         "(ignored without --spec-draft)")
    ap.add_argument("--spec-draft-probes", type=int, default=0,
                    help="IVF probes for the draft pass (0 = half the "
                         "serving tier's n_probe)")
    ap.add_argument("--prefix-cache-blocks", type=int, default=0,
                    help="device-resident shared-prefix KV pool capacity in "
                         "token blocks (0 = off)")
    ap.add_argument("--prefix-block-tokens", type=int, default=8,
                    help="tokens per prefix-pool block (match granularity)")
    ap.add_argument("--admit-window", type=int, default=0,
                    help="admission look-ahead: hold up to N queue-head "
                         "requests whose prefix-cache-preferred replica is "
                         "full, admitting the first fit instead "
                         "(0 = strict FIFO)")
    ap.add_argument("--admit-hold", type=int, default=8,
                    help="force-admit a held request anywhere after this "
                         "many holds (bounds unfairness)")
    ap.add_argument("--verify-index-every", type=int, default=0,
                    help="digest-verify (and restore) the serving tier's "
                         "IVF index every N steps (0 = off)")
    ap.add_argument("--no-health-guard", action="store_true",
                    help="disable the in-step estimator health guard")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write per-request lifecycle spans + step phases "
                         "as Chrome-trace JSONL to PATH (summarize with "
                         "repro_torch.launch.obs_report)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve Prometheus text metrics on "
                         "127.0.0.1:PORT/metrics (0 = off)")
    ap.add_argument("--metrics-snapshot", default=None, metavar="PATH",
                    help="write periodic JSON metric snapshots to PATH")
    ap.add_argument("--harvest-every", type=int, default=16,
                    help="steps between device->host metric harvests")
    ap.add_argument("--shadow-every", type=int, default=16,
                    help="steps between shadow-sampled exact log-Z passes "
                         "feeding the per-tier rel-err stream (0 = off)")
    ap.add_argument("--stream", action="store_true",
                    help="print every completion as it finishes")
    ap.add_argument("--sequential", action="store_true",
                    help="also run the one-request-at-a-time generate() "
                         "baseline over the same workload")
    return ap.parse_args(argv)


def _mesh_shape(spec: str) -> dict:
    kv = dict(part.split("=", 1) for part in spec.split(","))
    unknown = set(kv) - {"data", "model"}
    if unknown:
        raise SystemExit(f"--mesh keys must be data/model, got "
                         f"{sorted(unknown)}")
    return {"data": int(kv.get("data", 1)), "model": int(kv.get("model", 1))}


def _init_group(args, dev: torch.device) -> bool:
    """Initialise the default process group under ``torchrun``; returns
    whether this call did (and so must destroy it)."""
    import torch.distributed as dist
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return False
    backend = args.dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://")
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Serve as the flags say; returns the exit code (0, or 2 for a model
    the slot scheduler does not step). Under a mesh every rank calls it and
    rank 0 prints."""
    import torch.distributed as dist
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    owns_group = _init_group(args, dev) if args.mesh else False
    try:
        return _serve(args, dev)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _serve(args, dev: torch.device) -> int:
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.method:
        cfg = dataclasses.replace(
            cfg, partition=dataclasses.replace(cfg.partition,
                                               method=args.method))
    if cfg.family == "vlm":
        print(vlm_refusal(cfg), file=sys.stderr)
        return 2
    mesh, eager = None, False
    if args.mesh:
        from .mesh import make_serving_mesh
        shape = _mesh_shape(args.mesh)
        mesh = make_serving_mesh(shape["data"], shape["model"],
                                 device_type=dev.type)
        # a gloo group on the card cannot be captured
        eager = dev.type == "cuda" and dist.get_backend() == "gloo"

    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dev)
    max_len = args.prompt_len_max + args.gen + 1
    eng = Engine(model, params, max_len, seed=args.seed, device=dev,
                 mesh=mesh)
    mesh_note = "" if mesh is None else f"  mesh {args.mesh}"
    say(f"arch {cfg.name}  Z-method {cfg.partition.method}  vocab "
        f"{cfg.vocab}  slots {args.slots}  device {dev}{mesh_note}")

    if cfg.n_codebooks:
        # audio codebook heads have no slot-table path (multi-stream
        # tokens): one synchronous generate() batch
        say("audio arch: serving one synchronous generate() batch "
            "(no continuous batching for codebook heads)")
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        prompt = torch.randint(
            0, cfg.vocab, (args.slots, args.prompt_len_min, cfg.n_codebooks),
            generator=gen, device=dev)
        t0 = time.perf_counter()
        toks = generate(eng, prompt, args.gen, temperature=args.temperature,
                        generator=gen)
        toks.cpu()
        dt = time.perf_counter() - t0
        n_tok = args.slots * args.gen
        say(f"generated {args.slots}x{args.gen} codebook tokens in "
            f"{dt:.2f}s ({n_tok / dt:.1f} tok/s)")
        return 0

    reqs = build_workload(args.requests, cfg.vocab, args.gen,
                          args.prompt_len_min, args.prompt_len_max,
                          args.temperature, args.seed)
    if args.stream:
        for r in reqs:
            r.on_complete = lambda req, comp: say(
                f"  req {req.req_id:3d} T={req.temperature:.1f} "
                f"len {len(req.prompt):2d} -> {comp.tokens[:8]}"
                f"{'...' if len(comp.tokens) > 8 else ''}")

    sched = Scheduler(eng, n_slots=args.slots, seed=args.seed,
                      spec_draft=args.spec_draft, spec_k=args.spec_k,
                      spec_draft_probes=args.spec_draft_probes,
                      prefix_cache_blocks=args.prefix_cache_blocks,
                      prefix_block_tokens=args.prefix_block_tokens,
                      eager=eager)
    srv_cfg = ServingConfig(
        max_queue=args.max_queue, default_deadline=args.deadline,
        degrade_ladder=tuple(args.ladder.split(",")) if args.ladder else (),
        degrade_high=args.degrade_high, degrade_low=args.degrade_low,
        degrade_after=args.degrade_after, restore_after=args.restore_after,
        health_guard=not args.no_health_guard,
        verify_index_every=args.verify_index_every,
        admit_window=args.admit_window, admit_hold=args.admit_hold)
    obs = None
    if args.trace_out or args.metrics_port or args.metrics_snapshot:
        obs = Observability(ObsConfig(
            harvest_every=args.harvest_every,
            shadow_every=args.shadow_every,
            trace_path=(args.trace_out or "") if rank == 0 else "",
            metrics_port=args.metrics_port if rank == 0 else 0,
            snapshot_path=(args.metrics_snapshot or "") if rank == 0
            else ""))
        if obs.port:
            say(f"  metrics: http://127.0.0.1:{obs.port}/metrics")
    server = Server(sched, srv_cfg, obs=obs)
    arrivals = poisson_arrivals(reqs, rate=args.rate, seed=args.seed)
    rep = server.run(arrivals=arrivals)
    say("continuous:", rep.summary())
    if obs is not None:
        h = obs.last_harvest or {}
        shadow = h.get("shadow_by_tier", {})
        live = {t: f"{v['rel_err_mean']:.2e}/{v['rel_err_max']:.2e}"
                for t, v in shadow.items() if v["count"]}
        if live:
            say(f"  shadow rel-err mean/max by tier: {live}")
        if args.trace_out and obs.tracer is not None:
            say(f"  trace: {args.trace_out} "
                f"({obs.tracer.events_written} events)")
        if args.metrics_snapshot:
            say(f"  snapshot: {args.metrics_snapshot}")
        obs.close()
    extra = sched.captures - len(sched.captures_by_tier)
    say(f"  captures after warm-up: {extra} (0 expected; one capture per "
        f"served tier: {dict(sched.captures_by_tier)})")
    if rep.dedup_by_fill:
        fills = ", ".join(f"{k}:{v:.2f}" for k, v in
                          rep.dedup_by_fill.items())
        say(f"  probe-union dedup by batch fill: {fills}")
    if rep.rejects_by_reason or rep.tier_transitions or \
            rep.index_restores or any(rep.health.values()):
        say(f"  robustness: shed_rate {rep.shed_rate:.2f} "
            f"(by reason: {dict(rep.rejects_by_reason)}), "
            f"queue peak {rep.queue_depth_peak}")
        if rep.tier_transitions:
            path = " -> ".join(f"{t}@{s}" for s, t in rep.tier_transitions)
            say(f"  tier transitions: {path}; tokens by tier "
                f"{dict(rep.tokens_by_tier)} "
                f"(degraded frac {rep.degraded_token_frac:.2f})")
        if rep.index_restores or any(rep.health.values()):
            say(f"  guards: health {dict(rep.health)}, index restores "
                f"{rep.index_restores}, step faults {rep.step_faults}")

    if args.sequential:
        _sequential(eng, reqs, rep, say)
    return 0


def _sequential(eng: Engine, reqs: List[Request], rep, say) -> None:
    """Each request alone through ``generate`` (batch 1, its own seeded
    generator) after one warm-up call; reports tokens/s, the speedup of the
    slot table and how many requests got the slot table's tokens."""
    dev = eng.device

    def solo(r):
        prompt = torch.as_tensor(r.prompt, device=dev).long()[None]
        gen = torch.Generator(device=dev).manual_seed(int(r.seed))
        return generate(eng, prompt, r.max_new_tokens,
                        temperature=r.temperature, generator=gen)

    solo(reqs[0]).cpu()                        # the capture, then steady
    served = {c.request.req_id: c.tokens for c in rep.completions
              if c.error is None}
    t0 = time.perf_counter()
    outs = [solo(r) for r in reqs]
    toks = [o[0].tolist() for o in outs]       # reads the device
    dt = time.perf_counter() - t0
    tot = sum(len(t) for t in toks)
    same = sum(served.get(r.req_id) == t for r, t in zip(reqs, toks))
    say(f"sequential: {tot} tokens in {dt:.2f}s ({tot / dt:.1f} tok/s); "
        f"continuous speedup {rep.goodput_tok_s / (tot / dt):.2f}x; "
        f"tokens equal to the slot table's for {same}/{len(reqs)} requests")


if __name__ == "__main__":
    raise SystemExit(main())
