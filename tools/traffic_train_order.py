"""Does chip_smoke.py's traffic phase, run before training in one process,
slow the train steps after it, and why?

On one GPU: builds the kernels, then times ``--blocks`` blocks of fused_ce
train steps of full-width qwen1.5-4b at chip_smoke.py's training shapes
(B 4 x S 256), with the traffic phase after block ``--traffic-after``
(0: no traffic phase, the control; the phase adds a block). After the
phase it logs the serving objects still alive and what refers to them,
times a block as the phase left things, then calls ``gc.collect()`` and
``torch.cuda.empty_cache()`` before the next. Each block logs its step
times, the caching allocator's retries, device mallocs and frees over
the steps, the memory allocated and reserved, the time Python's cyclic
garbage collector spent in the steps, and two host probes taken before
them: a fixed pure-Python loop and 2000 one-element CUDA launches (the
host's own speed, apart from the process's state).

    python3 tools/traffic_train_order.py    # traffic after block 1
    python3 tools/traffic_train_order.py --traffic-after 0 --blocks 5
    python3 tools/traffic_train_order.py --variant no-profiler
    python3 tools/traffic_train_order.py --variant profiler-only

``--variant no-profiler`` runs the phase with its step timed by CUDA
events alone (no ``torch.profiler`` session in ``graph_step_ms``);
``profiler-only`` runs, in the phase's place, only profiler sessions
like that function's (a CUDA-only one, then a CPU and CUDA one under a
``TorchFunctionMode`` with a ``record_function`` range a call, as
``trunk_kinds`` takes) over eager matmuls.

Needs one GPU; prints its log on stdout.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STEPS = 6

_gc = {"t0": 0.0, "s": 0.0, "by_gen": [0, 0, 0]}


def _gc_callback(phase, info):
    if phase == "start":
        _gc["t0"] = time.perf_counter()
    else:
        _gc["s"] += time.perf_counter() - _gc["t0"]
        _gc["by_gen"][info["generation"]] += 1


def memory(torch) -> str:
    return (f"allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB, "
            f"reserved {torch.cuda.memory_reserved() / 1e9:.3f} GB")


def host_probe(torch) -> str:
    """Median ms of a fixed pure-Python loop and µs a launch of 2000
    one-element CUDA adds, over three tries each."""
    py, launch = [], []
    x = torch.zeros(1, device="cuda")
    for _ in range(3):
        t0 = time.perf_counter()
        sum(i * i for i in range(1_000_000))
        py.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            x.add_(1)
        torch.cuda.synchronize()
        launch.append((time.perf_counter() - t0) / 2000 * 1e6)
    return (f"host probe: python loop {statistics.median(py):.1f} ms, "
            f"{statistics.median(launch):.2f} us a launch")


def train_block(torch, smoke, card, label):
    """STEPS fused_ce steps on a fresh train state after one warm step;
    returns the step milliseconds."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.models import Model
    from repro_torch.train import init_train_state, make_train_step
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    model = Model(cfg)
    state = init_train_state(model, TrainConfig(), seed=0, device=dev)
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), smoke.TRAIN_B,
                      smoke.TRAIN_S)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in next(it))
    batch = {"tokens": tokens, "labels": labels}
    step = make_train_step(model, TrainConfig(loss="fused_ce",
                                              warmup_steps=1))
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    probe = host_probe(torch)
    before = torch.cuda.memory_stats()
    _gc.update(s=0.0, by_gen=[0, 0, 0])
    ms = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    after = torch.cuda.memory_stats()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("num_alloc_retries", "num_device_alloc",
                       "num_device_free")}
    smoke.log(f"{label}: {probe}; fused_ce steps "
              f"{[round(x, 1) for x in ms]} ms, median "
              f"{statistics.median(ms):.1f}; over the steps "
              f"{delta}, gc {_gc['s'] * 1e3:.1f} ms in {_gc['by_gen']} "
              f"collections by generation; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, "
              f"{memory(torch)} [{card}]")
    del state, step, batch, tokens, labels
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return ms


def alive(torch, smoke, label):
    """The serving objects still alive, and what refers to each."""
    import types

    from repro_torch.serve import Engine, Scheduler, Server
    objs = gc.get_objects()
    found = [o for o in objs if isinstance(o, (Engine, Scheduler, Server))]
    by_type = {}
    for o in found:
        by_type[type(o).__name__] = by_type.get(type(o).__name__, 0) + 1
    smoke.log(f"{label}: {len(objs)} gc-tracked objects; alive {by_type}; "
              f"{memory(torch)}")
    for o in found[:6]:
        refs = []
        for r in gc.get_referrers(o):
            if r is objs or r is found:
                continue
            if isinstance(r, types.FrameType):
                refs.append(f"frame {r.f_code.co_name}")
            elif isinstance(r, types.CellType):
                refs.append("closure cell")
            elif isinstance(r, dict):
                owners = [type(x).__name__ for x in gc.get_referrers(r)
                          if getattr(x, "__dict__", None) is r]
                refs.append(f"dict of {owners}")
            else:
                refs.append(type(r).__name__)
        smoke.log(f"  {type(o).__name__} referred to by {refs}")
    del objs, found


def profiler_sessions(torch, smoke, card):
    """Profiler sessions like the traffic phase's, over eager matmuls."""
    from torch.overrides import TorchFunctionMode
    from torch.profiler import ProfilerActivity, profile, record_function

    class Ranges(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            with record_function("kind:probe"):
                return func(*args, **(kwargs or {}))

    a = torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            torch.mm(a, a)
        torch.cuda.synchronize()
    n = len(prof.events())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with Ranges():
            for _ in range(200):
                torch.mm(a, a)
        torch.cuda.synchronize()
    smoke.log(f"profiler sessions in the phase's place: {n} and "
              f"{len(prof.events())} events [{card}]")


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--traffic-after", type=int, default=1,
                    help="run the traffic phase after this block (0: none)")
    ap.add_argument("--variant", default="full",
                    choices=("full", "no-profiler", "profiler-only"))
    args = ap.parse_args()

    import chip_smoke as smoke
    if not torch.cuda.is_available():
        print("traffic_train_order: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import fmbe_phi, fmbe_z
    from repro_torch.kernels.fused_ce import fused_ce_bwd, fused_ce_fwd
    from repro_torch.kernels.ivf_score import (ivf_decode, ivf_score,
                                              union_scores)
    from repro_torch.kernels.lsh_probe import lsh_probe
    from repro_torch.kernels.topk_z import topk_z
    kernels = {"topk_z": topk_z, "ivf_decode": ivf_decode,
               "union_scores": union_scores, "fmbe_phi": fmbe_phi,
               "fmbe_z": fmbe_z, "fused_ce_fwd": fused_ce_fwd,
               "fused_ce_bwd": fused_ce_bwd, "lsh_probe": lsh_probe,
               "ivf_score": ivf_score}
    card = smoke.card_line()
    smoke.log(f"card: {card}; torch {torch.__version__}")
    _build.build_all()
    gc.callbacks.append(_gc_callback)
    what = {"full": "traffic", "no-profiler": "traffic without profiler",
            "profiler-only": "profiler sessions"}[args.variant]
    t0 = time.time()
    blocks = {}
    label = "block 1"
    for i in range(1, args.blocks + 1):
        blocks[label] = train_block(torch, smoke, card, label)
        label = f"block {i + 1}"
        if i == args.traffic_after:
            if args.variant == "profiler-only":
                profiler_sessions(torch, smoke, card)
            else:
                if args.variant == "no-profiler":
                    smoke.graph_step_ms = (
                        lambda torch, sched, params, card:
                        smoke._median_events(
                            torch, sched._graphs[sched.tier].graph.replay, 20))
                smoke.traffic_last(torch, card, kernels)
            alive(torch, smoke, f"after {what}, as it left things")
            blocks[f"{label} (after {what}, as left)"] = train_block(
                torch, smoke, card, f"{label} (after {what}, as left)")
            gc.collect()
            torch.cuda.empty_cache()
            alive(torch, smoke, "after gc.collect() and empty_cache()")
            label = f"block {i + 1} (after {what}, gc.collect, empty_cache)"
    smoke.log("medians: " + ", ".join(
        f"{k} {statistics.median(v):.1f} ms" for k, v in blocks.items())
        + f"; {time.time() - t0:.1f} s [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
