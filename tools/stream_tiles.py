#!/usr/bin/env python3
"""Tile sweep of the gathered-row kernels (``union_scores`` and
``lsh_probe`` on ``csrc/gather_stream.cuh``) on one GPU.

    python3 tools/stream_tiles.py       # from the repository root

Builds ``csrc/union_scores.cu`` and ``csrc/lsh_probe.cu`` once for each
variant below (one ``nvcc`` per build, all at once, into
``build/tools/stream_tiles/``), with ``-D`` overrides of the header's
constants: rows a stage (``GS_ROWS_*``), the cap on ring stages
(``GS_STAGES_*``; the ring takes as many as shared memory holds, at most
the cap), consumer warps (``GS_WARPS_*``), CTAs per SM (``GS_CTAS``, the
grid sized to match) and programmatic dependent launch of the probe after
the query codes (``GS_PDL``); two diagnostic builds time the copies alone
and the math alone (``GS_DIAG``). Each build carries one bf16 and one f32
variant. At the main path's shapes (qwen1.5-4b: d 2560, Q 8, seeded random
rows) it holds each variant to the plain versions (scores and LSEs to
1e-3, pads 0, counts exact) and times, by CUDA-graph replay (median of
20):
  - ``union_scores`` over 23 and over 31 live blocks of 512 rows of a
    128-slot union (the bf16 and the f32 main path's mimps plans), bf16
    and f32, with the L2 cache warm and flushed (a 64 MB write before each
    call in the graph, its own time subtracted);
  - ``lsh_probe`` on the trimmed candidate union of an 8 x 8-bit index of
    V 151936 rows (capacity 38016, l 1000, k 8) and on the dense fallback
    (every row), bf16 and f32.
The package's build is also timed with 10 calls in one graph (per call),
which spreads the host's launch of the graph, and a graph of one
one-element kernel gives the floor of the one-call timing. The variants
are timed in order and then in reverse; each time printed is the mean of
the two, beside the card's name and power limit. Everything
is written to ``chiprun_out/stream_tiles.json``.

The package's constants were chosen from this sweep on an NVIDIA H100
80GB HBM3 at 700 W (``PERF.md`` gives the runs): stages of 16 bf16 rows
(8 lose at ``lsh_probe``, 12 tie), 8 consumer warps (4 lose at f32
``lsh_probe``), one CTA an SM (two lose everywhere), the probe launched
as a programmatic dependent (faster at both dtypes) and an f32 ring of 2
stages (3 are slower at every f32 case).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

V, D, Q = 151936, 2560, 8
NB, BR, CAP = 474, 512, 128
LIVES = (23, 31)      # live blocks of the bf16 and of the f32 phase's union
L_TAIL, K = 1000, 8
TOL = 1e-3
# name, -D flags, CTAs per SM; the first is the package's own constants
VARIANTS = (
    ("package", [], 1),
    ("bf16 rows 12", ["-DGS_ROWS_BF16=12"], 1),
    ("bf16 rows 8", ["-DGS_ROWS_BF16=8"], 1),
    ("bf16 rows 8, stages 2", ["-DGS_ROWS_BF16=8", "-DGS_STAGES_BF16=2"], 1),
    ("f32 stages 3", ["-DGS_STAGES_F32=3"], 1),
    ("f32 rows 2", ["-DGS_ROWS_F32=2"], 1),
    ("warps 4", ["-DGS_WARPS_BF16=4", "-DGS_WARPS_F32=4"], 1),
    ("no programmatic launch", ["-DGS_PDL=0"], 1),
    ("2 CTAs an SM, rows 8 / 1, warps 4",
     ["-DGS_CTAS=2", "-DGS_ROWS_BF16=8", "-DGS_ROWS_F32=1",
      "-DGS_WARPS_BF16=4", "-DGS_WARPS_F32=4"], 2),
    # diagnostics, not held to the plain versions: the copies alone, the
    # math alone, and cycles by phase (printed, not timed)
    ("copies only", ["-DGS_DIAG=1"], 1),
    ("math only", ["-DGS_DIAG=2"], 1),
    ("cycles by phase", ["-DGS_DIAG=3"], 1),
)
DEFAULTS = {"GS_ROWS_BF16": 16, "GS_STAGES_BF16": 8, "GS_WARPS_BF16": 8,
            "GS_ROWS_F32": 4, "GS_STAGES_F32": 2, "GS_WARPS_F32": 8,
            "GS_CTAS": 1, "GS_PDL": 1, "GS_DIAG": 0}


def constants(flags):
    out = dict(DEFAULTS)
    for f in flags:
        key, val = f[2:].split("=")
        out[key] = int(val)
    return out


def ring_stages(c, dt, side=0, extra=0):
    """The ring's stages at d = D (``gather_stream.cuh``'s ``layout``),
    with ``side`` bytes beside each row and ``extra`` of the Job's own."""
    es, tag = (2, "BF16") if dt == "bf16" else (4, "F32")
    rows, cap, warps = (c[f"GS_{k}_{tag}"] for k in ("ROWS", "STAGES",
                                                      "WARPS"))
    limit = 232448 if c["GS_CTAS"] == 1 else 233472 // c["GS_CTAS"] - 1024
    row = D * es
    pitch = row + (32 if (row // 16) & 1 else 16)
    stage = -(-rows * (pitch + side) // 16) * 16
    bar = -(-(8 * pitch + 2 * warps * rows * 8 * 4 + extra) // 16) * 16
    ring_off = -(-(bar + (2 * cap + 1) * 8) // 128) * 128
    return max(0, min(cap, (limit - ring_off) // stage)), rows


def build(_build, name, flags):
    """Starts nvcc on both sources with ``flags``; returns a function that
    waits and loads {"union_scores": lib, "lsh_probe": lib}."""
    out_dir = ROOT / "build" / "tools" / "stream_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in ("union_scores", "lsh_probe"):
        so = out_dir / f"lib{src}_{name}.so"
        procs[src] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
             str(_build.CSRC / f"{src}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def wait():
        libs = {}
        for src, (so, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc {src} {flags} failed:\n{out}")
            lib = ctypes.CDLL(str(so))
            for entry in _build.ENTRIES.get(src, (src,)):
                fn = getattr(lib, f"{entry}_launch")
                fn.argtypes = _build.SIGNATURES[entry]
                fn.restype = ctypes.c_int
            libs[src] = lib
        return libs
    return wait


def graph_ms(torch, fn, flush=None, reps=20, calls=1):
    """Median device ms of ``fn`` over CUDA-graph replays; with ``flush``
    (a callable that overwrites the L2 cache) inside the graph before each
    call, less the median of ``flush`` alone. With ``calls`` > 1 the graph
    holds that many calls back to back and the time is per call, so the
    host's launch of the graph is spread over them."""
    def one(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                body()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / calls)
        return statistics.median(out)
    if flush is None:
        return one(fn)
    return one(lambda: (flush(), fn())) - one(flush)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("stream_tiles: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import lsh as tlsh
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_score import union_launch, union_scores_plain
    from repro_torch.kernels.lsh_probe import lsh_probe_plain, probe_launch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    waits = [(name, build(_build, str(i), flags), flags, ctas)
             for i, (name, flags, ctas) in enumerate(VARIANTS)]
    libs = {name: (wait(), flags, ctas) for name, wait, flags, ctas in waits}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    w32 = torch.randn(V, D, generator=gen, device=dev) * V ** -0.5
    h32 = torch.randn(Q, D, generator=gen, device=dev)
    ids = torch.sort(torch.randperm(NB, generator=gen, device=dev)[:max(LIVES)]
                     ).values
    unions = {}
    for live_u in LIVES:
        tab = torch.cat([ids[:live_u], ids[live_u - 1:live_u].expand(
            CAP - live_u)]).to(torch.int32)
        unions[live_u] = (tab, torch.tensor(live_u, dtype=torch.int32,
                                            device=dev))
    blocks = torch.randint(0, V, (NB * BR,), generator=gen, device=dev)
    idx = tlsh.build_lsh_device(w32, generator=gen, device=dev)
    cap = tlsh.resolve_cand_cap(0, idx, V)
    plan = tlsh.lsh_plan(idx, h32, L_TAIL, generator=gen, cand_cap=cap)
    live = int(plan.cand_live)
    if live > cap:
        plan = tlsh.lsh_plan(idx, h32, L_TAIL, tail_ids=plan.tail_ids,
                             cand_cap=live)
    rows_t, _, live_t = tlsh._with_trimmed_cands(plan, lambda *a: a)
    rows_d = torch.arange(V, dtype=torch.int32, device=dev)
    live_d = torch.tensor(V, dtype=torch.int32, device=dev)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    print(f"union: {LIVES} live of {CAP} slots x {BR} rows; lsh: {live} "
          f"candidates of capacity {cap}, l {L_TAIL}, dense {V}", flush=True)

    cases = {}
    for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        w, h = w32.to(dtype), h32.to(dtype)
        wb = w[blocks].reshape(NB, BR, D)
        for live_u, (tab, n_live) in unions.items():
            uargs = (wb, h, tab, n_live)
            cases[f"union_scores {live_u} blocks {dt}"] = (
                uargs, union_scores_plain(*uargs))
        for name, rows, col in (("trimmed", rows_t, live_t),
                                ("dense", rows_d, live_d)):
            largs = (w, h, idx.proj, rows, col, idx.codes, idx.slot_of_row,
                     plan.tail_ids, plan.tail_accept, plan.tail_bias)
            cases[f"lsh_probe {name} {dt}"] = (
                largs, lsh_probe_plain(*largs, k=K))

    def call(case, lib_set, ctas):
        args, _ = cases[case]
        if case.startswith("union"):
            return lambda: union_launch(*args, lib=lib_set["union_scores"],
                                        grid_x=sms * ctas)
        return lambda: probe_launch(*args, k=K, lib=lib_set["lsh_probe"],
                                    grid_x=sms * ctas)

    # every variant against the plain versions; the cycle counts printed
    ok = {}
    for name, (lib_set, flags, ctas) in libs.items():
        if constants(flags)["GS_DIAG"] == 3:
            for case in cases:
                print(f"{name}, {case}:", flush=True)
                call(case, lib_set, ctas)()
                torch.cuda.synchronize()
            continue
        if constants(flags)["GS_DIAG"]:
            continue
        good = True
        for case, (args, want) in cases.items():
            got = call(case, lib_set, ctas)()
            torch.cuda.synchronize()
            if case.startswith("union"):
                n = int(args[3])
                good &= bool((got[:, :n] - want[:, :n]).abs().max()
                             <= TOL) and bool((got[:, n:] == 0).all())
            else:
                good &= torch.equal(got[4], want[4])
                for a, b in zip(got[:2], want[:2]):
                    good &= bool((a - b).abs().max() <= TOL)
        ok[name] = good
        print(f"{name}: {'agrees' if good else 'DIFFERS'} with the plain "
              f"versions", flush=True)

    times = {name: {} for name in libs}
    timed = [n for n in libs if constants(libs[n][1])["GS_DIAG"] != 3]
    order = timed + timed[::-1]
    for name in order:
        lib_set, flags, ctas = libs[name]
        for case in cases:
            fn = call(case, lib_set, ctas)
            times[name].setdefault(case, []).append(graph_ms(torch, fn))
            if not case.startswith("lsh_probe dense"):
                times[name].setdefault(f"{case}, L2 flushed", []).append(
                    graph_ms(torch, fn, flush))
            if name == "package":
                times[name].setdefault(f"{case}, 10 calls a graph", []).append(
                    graph_ms(torch, fn, calls=10))
                if not case.startswith("lsh_probe dense"):
                    times[name].setdefault(
                        f"{case}, 10 calls a graph, L2 flushed", []).append(
                        graph_ms(torch, fn, flush, calls=10))
    # the query codes alone (the package's build), the probe's first launch,
    # and the floor: a graph of one kernel that adds 1 to one number
    from repro_torch.kernels.lsh_probe import lsh_query_codes
    one = torch.zeros(1, device=dev)
    floor_ms = graph_ms(torch, lambda: one.add_(1))
    floor10 = graph_ms(torch, lambda: one.add_(1), calls=10)
    print(f"a graph of one one-element kernel: {floor_ms:.4f} ms; of 10, "
          f"per kernel: {floor10:.4f} ms [{card}]")
    codes_ms = {}
    for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        hq = h32.to(dtype)
        codes_ms[dt] = graph_ms(torch, lambda: lsh_query_codes(hq, idx.proj))
        print(f"lsh query codes alone, {dt}: {codes_ms[dt]:.4f} ms [{card}]")
    report = []
    for name in timed:
        lib_set, flags, ctas = libs[name]
        c = constants(flags)
        nb16, rb16 = ring_stages(c, "bf16")
        nf32, rf32 = ring_stages(c, "f32")
        # lsh_probe: 68 side bytes a row (L = 8), codes and two flag buffers
        lb16, _ = ring_stages(c, "bf16", 68, 8 * 8 * 4 + 2 * rb16 * 9 * 4)
        lf32, _ = ring_stages(c, "f32", 68, 8 * 8 * 4 + 2 * rf32 * 9 * 4)
        row = dict(variant=name, flags=flags, ctas_per_sm=ctas,
                   bf16_ring=f"{nb16} (lsh {lb16}) x {rb16} rows",
                   f32_ring=f"{nf32} (lsh {lf32}) x {rf32} rows",
                   warps=(c["GS_WARPS_BF16"], c["GS_WARPS_F32"]),
                   pdl=c["GS_PDL"], diag=c["GS_DIAG"],
                   agrees=ok.get(name),
                   ms={k: statistics.mean(v) for k, v in times[name].items()},
                   runs={k: v for k, v in times[name].items()})
        report.append(row)
        print(f"{name} (bf16 ring {row['bf16_ring']}, f32 ring "
              f"{row['f32_ring']}, warps "
              f"{row['warps']}, {ctas} CTA/SM, pdl {row['pdl']}, "
              f"diagnostic {row['diag']}) [{card}]:")
        for key, ms in row["ms"].items():
            print(f"    {key}: {ms:.4f} ms")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "stream_tiles.json").write_text(json.dumps(
        {"card": card, "variants": report, "lsh_codes_ms": codes_ms,
         "one_kernel_graph_ms": floor_ms, "ten_kernel_graph_ms": floor10},
        indent=1))
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
