"""Continuous-batching quickstart: serve a live traffic stream
(counterpart of ``examples/serve_traffic.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_traffic [--device cpu]

Builds a reduced model, wraps it in the slot scheduler and serves a small
Poisson arrival stream of mixed-length, mixed-temperature requests with
streaming callbacks, then shows the two properties the subsystem is built
around: each request's slot-table tokens equal a solo ``generate`` of it
with its own seeded generator, bit for bit, and on a GPU the step is one
CUDA graph a tier, captured once.

Part two serves the raw-speed stack on a shared system-prompt workload:
the prefix KV pool turns the shared replay into block copies, and a cheap
``topk`` draft verified by the serving tier in one batched pass lands
several tokens a step. Tokens stay equal to solo ``generate`` throughout.
``main`` returns the reports and the parity checks.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs import reduced_config
from ..models import Model
from ..serve import Engine, Request, Scheduler, Server, generate, \
    poisson_arrivals


def _solo(engine, request) -> list:
    """The request alone through ``generate`` with its own generator."""
    dev = engine.device
    prompt = torch.as_tensor(request.prompt, device=dev).long()[None]
    gen = torch.Generator(device=dev).manual_seed(int(request.seed))
    return generate(engine, prompt, request.max_new_tokens,
                    temperature=request.temperature,
                    generator=gen)[0].tolist()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_traffic")
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--gen", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # -- model + engine (mimps partition estimation at the output layer) ---
    cfg = reduced_config("qwen1.5-4b")
    cfg = dataclasses.replace(
        cfg, vocab=args.vocab, partition=dataclasses.replace(
            cfg.partition, method="mimps", block_rows=128, n_probe=4, l=128))
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dev)
    engine = Engine(model, params, max_len=32, seed=args.seed, device=dev)

    # -- a little traffic: mixed prompt lengths and temperatures -----------
    rng = np.random.default_rng(args.seed)
    requests = [
        Request(prompt=rng.integers(0, cfg.vocab, size=(3 + 2 * (i % 3),)),
                max_new_tokens=args.gen, seed=100 + i,
                temperature=0.0 if i % 2 == 0 else 0.8,
                on_token=lambda r, tok, t: print(
                    f"    req {r.req_id}: +token {tok}"),
                on_complete=lambda r, comp: print(
                    f"  done req {r.req_id} (T={r.temperature}): "
                    f"{comp.tokens}"))
        for i in range(args.requests)]

    # -- serve: Poisson arrivals, admission queue, slot recycling ----------
    scheduler = Scheduler(engine, n_slots=args.slots, seed=args.seed)
    report = Server(scheduler).run(
        arrivals=poisson_arrivals(requests, rate=1.0, seed=args.seed))
    print("\ntraffic report:", report.summary())
    print(f"captures: {scheduler.captures} by tier "
          f"{scheduler.captures_by_tier} (on a GPU one a served tier; "
          f"nothing captured again under mixed replay, decode and "
          f"admission)")

    # -- the invisibility guarantee: batched == solo, bit for bit ----------
    served = {c.request.req_id: c.tokens for c in report.completions}
    parity = [served[r.req_id] == _solo(engine, r) for r in requests]
    req = requests[min(1, len(requests) - 1)]
    print(f"\nreq {req.req_id} served in the busy slot table == solo "
          f"generate(): {served[req.req_id]}; all requests: {all(parity)}")

    # -- raw speed: shared system prompt + speculation ---------------------
    print("\n--- shared-system-prompt traffic: prefix cache + speculation "
          "---")
    system_prompt = rng.integers(0, cfg.vocab, size=(12,))

    def shared_wave(n, tag):
        return [Request(prompt=np.concatenate(
                            [system_prompt,
                             rng.integers(0, cfg.vocab, size=(1 + i % 3,))]),
                        max_new_tokens=args.gen, seed=500 + tag * 100 + i,
                        temperature=0.0 if i % 2 == 0 else 0.8)
                for i in range(n)]

    fast_sched = Scheduler(engine, n_slots=args.slots, seed=args.seed,
                           spec_draft="topk", spec_k=4,
                           prefix_cache_blocks=16, prefix_block_tokens=4)
    fast_server = Server(fast_sched)
    waves = []
    for wave in range(2):          # wave 2 finds the pool warm
        reqs = shared_wave(args.requests, wave)
        for r in reqs:
            fast_server.submit(r)
        rep = fast_server.run()
        got = {c.request.req_id: c.tokens for c in rep.completions}
        same = [got[r.req_id] == _solo(engine, r) for r in reqs]
        acc_by_tier = ", ".join(f"{t}: {a:.0%}" for t, a in
                                sorted(rep.spec_acceptance_by_tier.items()))
        print(f"wave {wave + 1}: {rep.goodput_tok_s:.0f} tok/s, prefix hits "
              f"{rep.prefix.get('hits', 0)} (saved "
              f"{rep.prefix.get('saved_steps', 0)} replay steps), "
              f"acceptance by tier [{acc_by_tier}], tokens == solo "
              f"generate(): {all(same)}")
        waves.append({"report": rep, "parity": same})
    print(f"pool: {fast_sched.prefix.stats()}")
    return {"report": report, "parity": parity, "waves": waves,
            "captures": scheduler.captures}


if __name__ == "__main__":
    main()
