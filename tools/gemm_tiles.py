#!/usr/bin/env python3
"""Mainloop microbenchmark of the fused cross-entropy kernels on one GPU.

    python3 tools/gemm_tiles.py       # from the repository root

Builds ``tools/gemm_tiles.cu`` (into ``build/tools/``) and times, at the
three products of the backward at T 1024, C 16384, d 2560 (seeded random
bf16 operands, in the layouts the kernels read them):

    scores  S = h W[chunk]^T   M 1024,  N 16384, K 2560  (A, B K-major)
    dh      coef W[chunk]      M 1024,  N 2560,  K 16384 (B MN-major)
    dW      coef^T h           M 16384, N 2560,  K 1024  (A, B MN-major)

the kernels' own mainloop ("pingpong": 128 x 128 tiles, consumers on
alternate tiles), a 128 x 256 cooperative mainloop ("coop": both consumers
on every tile) and ``torch.matmul`` on the same operands, each without an
epilogue. Each variant's sum of accumulators is first checked against the
sum of ``A @ B`` in f64, to 1e-7 of the sum of the products' magnitudes (a
misread operand would miss by about 1e-5 of it). A time is the median of
5 runs of 20 calls issued back to back, each run timed with CUDA events;
the kernels are timed in the order pingpong, coop, coop, pingpong, beside
the card's name and power limit. The forward's product is the scores' one
with N = V.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = (("scores", 1024, 16384, 2560, 0),
          ("dh", 1024, 2560, 16384, 1),
          ("dW", 16384, 2560, 1024, 3))     # mode: 2 = A MN-major, 1 = B


def median_ms(torch, fn, runs=5, calls=20):
    """Median over ``runs`` of the mean device time of ``calls`` calls
    issued back to back (CUDA events around each run), so that the host's
    launch work overlaps the previous call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemm_tiles: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libgemm_tiles.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(ROOT / "tools" / "gemm_tiles.cu")],
                         capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas {line.strip()}")
    if res.returncode:
        return 1
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gemm_tiles_launch.argtypes = [I, I, P, P, I, I, I, P, I, P]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.zeros(sms * 256, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for name, m, n, k, mode in SHAPES:
        a = torch.randn(*((k, m) if mode & 2 else (m, k)), generator=gen,
                        device="cuda").bfloat16()
        b = torch.randn(*((k, n) if mode & 1 else (n, k)), generator=gen,
                        device="cuda").bfloat16()
        a_mat = a.T if mode & 2 else a
        b_mat = b if mode & 1 else b.T
        want = (a_mat.double() @ b_mat.double()).sum().item()
        scale = (a_mat.double().abs().sum(0) @ b_mat.double().abs().sum(1)
                 ).item()

        def kernel(variant):
            err = lib.gemm_tiles_launch(variant, mode, a.data_ptr(),
                                        b.data_ptr(), m, n, k,
                                        out.data_ptr(), sms, stream)
            if err:
                raise RuntimeError(f"gemm_tiles launch failed: {err}")

        for variant, label in ((0, "pingpong"), (1, "coop")):
            out.zero_()
            kernel(variant)
            torch.cuda.synchronize()
            got = out.double().sum().item()
            if abs(got - want) > 1e-7 * scale:
                print(f"{name} {label}: sum {got} != {want}")
                ok = False
        times = {0: [], 1: []}
        for variant in (0, 1, 1, 0):
            times[variant].append(
                median_ms(torch, lambda v=variant: kernel(v)))
        lib_ms = median_ms(torch, lambda: torch.matmul(a_mat, b_mat))
        flop = 2 * m * n * k
        for variant, label in ((0, "pingpong 128x128"),
                               (1, "coop 128x256")):
            ms = times[variant]
            print(f"{name} M {m} N {n} K {k}: {label} {ms[0]} and {ms[1]} "
                  f"ms, {flop / statistics.mean(ms) / 1e9:.1f} TFLOP/s "
                  f"[{card}]", flush=True)
        print(f"{name} M {m} N {n} K {k}: torch.matmul {lib_ms} ms, "
              f"{flop / lib_ms / 1e9:.1f} TFLOP/s [{card}]", flush=True)
        del a, b, a_mat, b_mat
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
