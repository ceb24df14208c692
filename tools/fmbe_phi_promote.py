#!/usr/bin/env python3
"""Whether the f32 ``fmbe_phi`` needs promoted sums, measured on one GPU.

    python3 tools/fmbe_phi_promote.py       # from the repository root

At f32, ``csrc/fmbe_phi_wgmma.cu`` runs three passes of x's exact bf16
planes against the pack's +-1 rows, so every product is exact and only the
tensor cores' f32 sums over d round. This script builds that source with
``-DFMBE_PHI3_PROMOTE=2`` (into ``build/tools/``): the last pass, (x0,
omega), summed two 64-deep stages at a time on the tensor cores and each
sum added to an f32 sum in shared memory, on a 4-stage ring beside it. The
package's own build does not promote (``FMBE_PHI3_PROMOTE`` = 0, a
6-stage ring).

Inputs, each made from a seed: 8192 rows of d 2560 f32 drawn as
``Model.init`` draws qwen1.5-4b's output embedding (N(0, 1/V), V 151936),
the rows of one chunk of the f32 fmbe build, and the same rows scaled by 8;
a feature map of P 4096 drawn as the FMBE build draws it
(``make_feature_map``, max degree 8, p 2, seed 0). For each, phi of both
builds and of the plain version in f32 (``fmbe_phi_plain``, no TF32) is
held to phi in float64 from the same f32 rows: the largest |error| /
(FMBE_REL x (|phi| + |coef| max(|x|_2, 1)^degree)) -- chip_smoke.py's
limit is 1 -- and the mean |error| / (|phi| + |coef| max(|x|_2,
1)^degree). Each build is timed (median of 5 runs of 10 calls, CUDA
events). Prints one line a measurement beside the card's name and power
limit and writes them to ``chiprun_out/fmbe_phi_promote.json``.
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

ROWS, D, P_FEAT, V = 8192, 2560, 4096, 151936
FMBE_REL = 1e-4                    # chip_smoke.py's FMBE_REL
SCALES = (1, 8)


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


def phi64(torch, pack, x):
    """phi in float64 from f32 x: the projections on the pack's rows, each
    feature's columns multiplied in m order, then coef."""
    proj = x.double() @ pack.rows.double().T
    prod = torch.ones((x.shape[0], pack.start.shape[0]),
                      dtype=torch.float64, device=x.device)
    for m in range(8):
        use = pack.degree > m
        if not bool(use.any()):
            break
        col = torch.where(use, pack.start + m, 0).long()
        prod = torch.where(use[None, :], prod * proj[:, col], prod)
    return prod * pack.coef.double()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fmbe_phi_promote: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.feature_maps import make_feature_map
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import fmbe_pack, fmbe_phi_plain, phi_launch
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libfmbe_phi_promote2.so"
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DFMBE_PHI3_PROMOTE=2", "-o",
         str(so), str(ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
                      "fmbe_phi_wgmma.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"not promoted (the kernel)": _build.load("fmbe_phi_wgmma")}
    log, _ = proc.communicate()
    if proc.returncode:
        print(f"nvcc fmbe_phi_wgmma -DFMBE_PHI3_PROMOTE=2 failed:\n{log}")
        return 1
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas promoted: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    lib.fmbe_phi_wgmma_launch.argtypes = _build.SIGNATURES["fmbe_phi_wgmma"]
    lib.fmbe_phi_wgmma_launch.restype = ctypes.c_int
    libs["promoted every 2 stages"] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fm = make_feature_map(gen, D, P_FEAT, device=dev)
    pack = fmbe_pack(fm.omega, fm.degree, fm.coef)
    base = torch.randn(ROWS, D, generator=gen, device=dev) * V ** -0.5
    print(f"card: {card}")
    rows = []
    for scale in SCALES:
        x = (base * scale).contiguous()
        want = phi64(torch, pack, x)
        norm = x.double().norm(dim=-1).clamp(min=1.0)
        size = want.abs() + (fm.coef.double().abs()[None, :]
                             * norm[:, None] ** fm.degree.double()[None, :])
        runs = [("plain f32", lambda: fmbe_phi_plain(fm.omega, fm.degree,
                                                     fm.coef, x))]
        runs += [(name, lambda lib=lib: phi_launch(pack, x, lib=lib)[0])
                 for name, lib in libs.items()]
        for name, fn in runs:
            got = fn()
            err = (got.double() - want).abs()
            row = dict(scale=scale, variant=name,
                       max_over_tol=(err / (FMBE_REL * size)).max().item(),
                       mean_rel=(err / size).mean().item())
            if name != "plain f32":
                row["ms"] = median_ms(torch, fn)
            rows.append(row)
            print(f"x scale {scale}, {name}: {row.get('ms', float('nan')):.4f}"
                  f" ms, max error {row['max_over_tol']:.4g} of the "
                  f"tolerance, mean {row['mean_rel']:.4g} of the scale "
                  f"[{card}]", flush=True)
            del got, err
        del x, want, size
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fmbe_phi_promote.json").write_text(json.dumps(
        {"card": card, "rows": ROWS, "d": D, "features": P_FEAT,
         "fmbe_rel": FMBE_REL, "results": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
