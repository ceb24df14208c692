#!/usr/bin/env python3
"""One GPU: does a cuBLAS workspace per stream hold memory after the
work is gone (C15)?

PyTorch gives cuBLAS a workspace from the caching allocator for every
stream a cuBLAS call runs on, and keeps it until
``torch._C._cuda_clearCublasWorkspaces()``. This runs a bf16 matmul on 8
side streams, then captures it in 8 CUDA graphs (each capture runs on a
side stream of its own) and deletes them, logging ``memory_allocated``
after each part, after clearing the workspaces, and the allocator's
segments by stream.

    python3 tools/cublas_workspaces.py
"""
import subprocess
import sys

import torch


def allocated_mb():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    a = torch.randn(512, 512, device="cuda", dtype=torch.bfloat16)
    base = allocated_mb()
    for _ in range(8):
        with torch.cuda.stream(torch.cuda.Stream()):
            a @ a
    side = allocated_mb()
    graphs = []
    for _ in range(8):
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            a @ a                                   # warm-up on the stream
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(g):
            out = a @ a
        graphs.append((g, out))
    captured = allocated_mb()
    del graphs, out
    freed = allocated_mb()
    segs = [(s["stream"], s["total_size"], s["allocated_size"],
             s.get("segment_pool_id")) for s in torch.cuda.memory_snapshot()
            if s["allocated_size"]]
    torch._C._cuda_clearCublasWorkspaces()
    cleared = allocated_mb()
    print(f"allocated MB: inputs {base:.1f}; after a matmul on 8 side "
          f"streams {side:.1f}; after 8 captured graphs {captured:.1f}; "
          f"graphs deleted {freed:.1f}; cuBLAS workspaces cleared "
          f"{cleared:.1f} [{card}]")
    for stream, total, alloc, pool in sorted(segs):
        print(f"  segment on stream {stream}: {total / 1e6:.1f} MB, "
              f"{alloc / 1e6:.1f} MB allocated, pool {pool}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
