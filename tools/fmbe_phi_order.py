#!/usr/bin/env python3
"""Times the tensor-core ``fmbe_phi`` kernel at the FMBE build's chunk on
one GPU, over the order of its items and without its epilogue.

    python3 tools/fmbe_phi_order.py       # from the repository root

Builds ``tools/fmbe_phi_order.cu`` (into ``build/tools/``): the kernel's
own Job with its items walked in groups of ``group_m`` row tiles, row tile
fastest (1: column tile fastest; the kernel uses 8), with or without its
epilogue. The chunk is the serving build's: 8192 rows (16 IVF blocks of
512) of d 2560 bf16, seeded N(0, 0.02^2), against a feature map of P 4096
drawn as the FMBE build draws it (max degree 8, p 2, seed 0). Each
variant with the epilogue is first checked to give the bits of
``fmbe_phi`` itself. A time is the median of 5 runs of 10 calls issued
back to back (CUDA events), the variants in the order given and then
reversed, beside the card's name and power limit; ``fmbe_phi`` itself and
``torch.matmul(x, pack.rows.T)`` (the product alone, on cuBLAS) are timed
beside them.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

VARIANTS = ((1, 1), (4, 1), (8, 1), (16, 1), (1, 0), (8, 0))  # group_m, epi


def median_ms(torch, fn, runs=5, calls=10):
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
        print("fmbe_phi_order: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.feature_maps import make_feature_map
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import PACK_TILE, fmbe_pack, fmbe_phi
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libfmbe_phi_order.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(ROOT / "tools" / "fmbe_phi_order.cu")],
                         capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "error" in line:
            print(f"  nvcc {line.strip()}")
    if res.returncode:
        return 1
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fmbe_phi_order_launch.argtypes = [P] * 6 + [I] * 5 + [P] * 2 + [I] * 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fm = make_feature_map(gen, 2560, 4096, device=dev)
    x = (torch.randn(8192, 2560, generator=gen, device=dev) * 0.02
         ).to(torch.bfloat16)
    pack = fmbe_pack(fm.omega, fm.degree, fm.coef)
    q, d = x.shape
    n_tiles = pack.rows.shape[0] // PACK_TILE
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = min(sms, -(-q // PACK_TILE) * n_tiles)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((q, fm.omega.shape[0]), device=dev)
    args = [t.data_ptr() for t in (x, pack.rows, pack.start, pack.tile_j0,
                                   pack.degree, pack.coef)]

    def variant(group_m, epi):
        err = lib.fmbe_phi_order_launch(*args, q, out.shape[1], d, n_tiles,
                                        grid, out.data_ptr(), stream,
                                        group_m, epi)
        if err:
            raise RuntimeError(f"fmbe_phi_order launch failed: {err}")

    def kernel():
        return fmbe_phi(fm.omega, fm.degree, fm.coef, x, pack=pack)

    want = kernel()
    for v in VARIANTS:
        if v[1]:
            out.zero_()
            variant(*v)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"fmbe_phi_order: group_m {v[0]} changed phi",
                      file=sys.stderr)
                return 1
    times = {v: [] for v in VARIANTS}
    for v in VARIANTS + VARIANTS[::-1]:
        times[v].append(median_ms(torch, lambda v=v: variant(*v)))
    own = median_ms(torch, kernel)
    lib_ms = median_ms(torch, lambda: torch.matmul(x, pack.rows.T))
    print(f"fmbe_phi tensor cores, x {q} x {d}, P {out.shape[1]}, pack "
          f"{pack.rows.shape[0]} columns [{card}]")
    for (group_m, epi), ms in times.items():
        print(f"  group_m {group_m}{'' if epi else ', no epilogue'}: {ms} ms")
    print(f"  fmbe_phi (group_m 8): {own} ms")
    print(f"  torch.matmul(x, pack.rows.T): {lib_ms} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
