"""End-to-end serving example (the paper's use case): batched decode where
each token's probability comes from the configured partition estimator
(counterpart of ``examples/serve_sublinear.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_sublinear \\
        [--device cpu]

Trains nothing: a reduced qwen-family model with seeded weights serves one
decode batch under every method of the registry (exact, mimps, mince,
fmbe, lsh, selfnorm), compares MIMPS's log Z with the exact one, then
generates under MIMPS greedily and at temperature 0.8. ``main`` returns
each method's log Z and tokens and the generated streams.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from .. import resolve_device
from ..configs import reduced_config
from ..models import Model
from ..models.transformer import torch_dtype
from ..serve import Engine, generate

METHODS = ("exact", "mimps", "mince", "fmbe", "lsh", "selfnorm")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_sublinear")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=12)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=8192,
                    help="big enough for the IVF index to engage")
    ap.add_argument("--features", type=int, default=0,
                    help="FMBE features (0: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    base = dataclasses.replace(reduced_config("qwen1.5-4b"), vocab=args.vocab)
    params = Model(base).init(
        torch.Generator(device=dev).manual_seed(args.seed), dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    prompt = torch.randint(0, base.vocab, (args.batch, args.prompt),
                           generator=g, device=dev)
    h = (0.3 * torch.randn((args.batch, base.d_model), generator=g,
                           device=dev)).to(torch_dtype(base.dtype))
    max_len = args.prompt + args.gen + 1

    def config(method):
        over = (dict(lsh_bits=7, lsh_tables=12, lsh_bucket_cap=256,
                     head_cap=1024, lsh_tail_beta=16.0)
                if method == "lsh" else {})
        if args.features:
            over["fmbe_features"] = args.features
        return dataclasses.replace(base, partition=dataclasses.replace(
            base.partition, method=method, block_rows=128, n_probe=8, l=512,
            **over))

    outs = {}
    for method in METHODS:
        cfg = config(method)
        # every method dispatches through the estimator-backend registry
        eng = Engine(Model(cfg), params, max_len, seed=args.seed, device=dev)
        t0 = time.perf_counter()
        dist = eng.next_token_distribution(h)
        log_z = dist["log_z"].float().cpu()
        dt = (time.perf_counter() - t0) * 1e3
        outs[method] = {"log_z": log_z, "token": dist["token"].cpu()}
        pc = cfg.partition
        if method == "lsh":        # the collision head's candidates + tail
            n_scored = pc.head_cap + pc.l
        elif eng.index is None:
            n_scored = cfg.vocab
        elif method == "fmbe":     # the head; Z from the feature sketch
            n_scored = eng.index.n_blocks + pc.n_probe * pc.block_rows
        else:
            n_scored = (eng.index.n_blocks + pc.n_probe * pc.block_rows +
                        pc.l)
        print(f"{method:9s} log Z = "
              f"{[round(float(z), 3) for z in log_z[:4]]} rows scored/query:"
              f" {n_scored:6d}  ({dt:.0f} ms)")

    err = torch.abs(1 - torch.exp(outs["mimps"]["log_z"] -
                                  outs["exact"]["log_z"]))
    agree = (outs["mimps"]["token"] == outs["exact"]["token"]).float().mean()
    print(f"\nMIMPS vs exact: mean |dZ|/Z = {float(err.mean()) * 100:.2f}%  "
          f"argmax agreement = {float(agree) * 100:.0f}%")
    print("(seeded untrained weights: near-flat logits, so the argmax among "
          "ties is noise; Z accuracy is the estimator's property)")

    # the generation loop under the sublinear estimator: greedy, then
    # Gumbel-max over the retrieved candidates at temperature 0.8
    eng = Engine(Model(config("mimps")), params, max_len, seed=args.seed,
                 device=dev)
    greedy = generate(eng, prompt, args.gen).cpu()
    print(f"\ngenerated {tuple(greedy.shape)} tokens under sublinear Z; "
          f"stream 0: {greedy[0][:10].tolist()}")
    hot = generate(eng, prompt, args.gen, temperature=0.8,
                   generator=torch.Generator(device=dev).manual_seed(
                       args.seed)).cpu()
    print(f"same prompt at temperature 0.8; stream 0: "
          f"{hot[0][:10].tolist()}")
    return {"methods": outs, "mimps_rel_err": err, "greedy": greedy,
            "sampled": hot}


if __name__ == "__main__":
    main()
