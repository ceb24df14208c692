#!/usr/bin/env python3
"""Accuracy and time of the f32 fused cross-entropy kernels on one GPU: the
backward by the number of plane pairs a product, by how its scores are
summed, and by the depth of dW's sums; the forward by how its scores are
summed.

    python3 tools/ce_f32_pairs.py       # from the repository root

The f32 backward (``csrc/fused_ce_bwd.cu`` at three planes) sums six plane
pairs a product, and sums the scores' (0, 0) pass two 64-deep stages at a
time on the tensor cores, each such sum added to an f32 sum in shared
memory (``CE_COEF3_PROMOTE`` = 2). ``tools/ce_f32_pairs.cu`` includes
that source as it is, and this script builds it (into ``build/tools/``,
one ``nvcc`` each, all at once) with macros for these variants beside the
kernel itself: the sums promoted every stage and every 4 stages, not
promoted at all (one tensor-core sum over all of d, as before promotion,
though with the 5-stage ring), and three pairs, (0, 1), (1, 0), (0, 0),
which read planes 0 and 1 only (the split still writes three).

Part 1, variants, at chip_smoke.py's f32 shape (T 1024, V 151936, d
2560): four inputs, each made from a seed:
  - ``logits_std2``: h ~ N(0, 1), W ~ N(0, (2 / sqrt(d))^2), logits about
    N(0, 4), as the card tests draw them;
  - ``logits_std4``, ``logits_std8``: W two and four times as large;
  - ``snapped``: the logits_std2 values rounded to 6 significant bits, x0,
    then made x0 (1 + 2**-9 + 2**-18), exact in f32: planes 1 and 2 are
    x0 2**-9 and x0 2**-18, so the pairs that three pairs drop do not
    cancel. A legal f32 input, if not a typical one.
For each input, every variant's dh and dW (f32) are held to a float64
reference (``reference64``), as the largest and the mean |error| / sum of
the terms' magnitudes, beside chip_smoke.py's limits (1e-4 and 1e-5), and
each is timed (median of 5 runs of 3 calls, CUDA events). The plain
version in f32 (``fused_ce_bwd_plain``, cuBLAS without TF32) is held to
the same reference, as the yardstick of f32 arithmetic.

Part 2, depth: the kernel (six pairs) on logits_std2 inputs at T 1024 ..
32768 (V 151936, d 2560), with its token slices of at most F32_MAX_DEPTH
tokens and, up to T 16384, as one slice (``depth`` = T), so that dW's
error is read against the depth of its sums.

Part 3, the forward (``csrc/fused_ce_fwd.cu`` at three planes, which
promotes its scores' (0, 0) pass as the backward does): nll and lse
against float64 on the four inputs of part 1, as the largest and the mean
|error| / (1 + |value|) beside chip_smoke.py's limit (1e-5), for the
kernel (promoted every 2 stages) and its builds promoted every stage and
not at all (``csrc/fused_ce_fwd.cu`` with ``-DCE_COEF3_PROMOTE``), each
timed, beside the plain version in f32 (``fused_ce_fwd_plain``).

Prints one line a measurement and the card's name and power limit, and
writes all of it to ``chiprun_out/ce_f32_pairs.json``.
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

T, V, D = 1024, 151936, 2560
LIMITS = (1e-4, 1e-5)              # chip_smoke.py F32_GRAD_REL, _MEAN
DEPTH_T = (1024, 4096, 8192, 16384, 32768)
# name, extra nvcc flags (the first is the kernel itself, as the package
# builds it)
VARIANTS = (
    ("six pairs, promoted every 2 stages", None),
    ("six pairs, promoted every stage", ["-DCE_COEF3_PROMOTE=1"]),
    ("six pairs, promoted every 4 stages", ["-DCE_COEF3_PROMOTE=4"]),
    ("six pairs, not promoted", ["-DCE_COEF3_PROMOTE=0"]),
    ("three pairs, promoted every 2 stages",
     ["-DCE_PASSES3=3", "-DCE_PAIR_A=0x010", "-DCE_PAIR_B=0x001"]),
)
UNSLICED_MAX = 16384
FWD_LIMIT = 1e-5                   # chip_smoke.py F32_FWD_REL
# the forward's builds: name, -DCE_COEF3_PROMOTE (None: the package's)
FWD_VARIANTS = (("promoted every 2 stages", None),
                ("promoted every stage", 1), ("not promoted", 0))


def median_ms(torch, fn, runs=5, calls=3):
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


def snap(torch, x):
    """x rounded to 6 significant bits, x0, then x0 (1 + 2**-9 + 2**-18):
    exact in f32, with bf16 planes x0, x0 2**-9 and x0 2**-18."""
    m, e = torch.frexp(x)
    x0 = torch.ldexp(torch.round(m * 64) / 64, e)
    return x0 * (1 + 2.0 ** -9 + 2.0 ** -18)


def inputs(torch, gen, t, v, d, kind):
    dev = gen.device
    h = torch.randn(t, d, generator=gen, device=dev)
    w = torch.randn(v, d, generator=gen, device=dev) * 2 / d ** 0.5
    if kind in ("logits_std4", "logits_std8"):
        w = w * int(kind[-1]) / 2
    if kind == "snapped":
        h, w = snap(torch, h), snap(torch, w)
    labels = torch.randint(0, v, (t,), generator=gen, device=dev,
                           dtype=torch.int32)
    return h.contiguous(), w.contiguous(), labels


def reference64(torch, h, w, labels, lse, g_nll, g_lse, block=1024):
    """dh, dW and the sums of their terms' magnitudes in float64, from the
    f32 inputs and the given lse, a block of tokens at a time."""
    t, d = h.shape
    v = w.shape[0]
    w64 = w.double()
    dh = torch.empty((t, d), dtype=torch.float64, device=h.device)
    dh_terms = torch.empty_like(dh)
    dw = torch.zeros((v, d), dtype=torch.float64, device=h.device)
    dw_terms = torch.zeros_like(dw)
    for t0 in range(0, t, block):
        s = slice(t0, t0 + block)
        h64 = h[s].double()
        coef = torch.exp(h64 @ w64.T - lse[s].double()[:, None]) \
            * (g_nll[s] + g_lse[s]).double()[:, None]
        rows = torch.arange(coef.shape[0], device=h.device)
        coef[rows, labels[s].long()] -= g_nll[s].double()
        dh[s] = coef @ w64
        dw += coef.T @ h64
        coef.abs_()
        dh_terms[s] = coef @ w64.abs()
        dw_terms += coef.T @ h64.abs()
        del coef
    return dh, dw, dh_terms, dw_terms


def errors(got, want, terms):
    ratio = (got.double() - want).abs() / terms.clamp(min=1e-300)
    return ratio.max().item(), ratio.mean().item()


def forward64(torch, h, w, labels, block=256):
    """nll and lse in float64 from the f32 inputs."""
    w64 = w.double()
    lse = torch.empty(h.shape[0], dtype=torch.float64, device=h.device)
    picked = torch.empty_like(lse)
    for t0 in range(0, h.shape[0], block):
        logits = h[t0:t0 + block].double() @ w64.T
        lse[t0:t0 + block] = torch.logsumexp(logits, -1)
        picked[t0:t0 + block] = logits.gather(
            1, labels[t0:t0 + block].long()[:, None])[:, 0]
        del logits
    return lse - picked, lse


def fwd_errors(got, want):
    """The largest and the mean |got - want| / (1 + |want|) over nll and
    lse."""
    out = []
    for g, x in zip(got, want):
        ratio = (g.double() - x).abs() / (1 + x.abs())
        out += [ratio.max().item(), ratio.mean().item()]
    return out


def build(_build, name, source, flags, entry):
    """Starts ``nvcc`` on ``source`` with ``flags`` into build/tools/; returns
    a function that waits for it and loads the library, with ``entry``'s
    signature."""
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{name}.so"
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
         str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def wait():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{out}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, f"{entry}_launch")
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        return lib
    return wait


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ce_f32_pairs: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_ce import (F32_MAX_DEPTH, bwd_launch,
                                             fused_ce_bwd_plain,
                                             fused_ce_fwd, fused_ce_fwd_plain,
                                             fwd_launch, token_slices)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    waits = {name: build(_build, f"ce_f32_variant{i}",
                         ROOT / "tools" / "ce_f32_pairs.cu", flags,
                         "fused_ce_bwd")
             for i, (name, flags) in enumerate(VARIANTS[1:], 1)}
    fwd_waits = {name: build(_build, f"ce_f32_fwd_promote{every}",
                             ROOT / "src" / "repro_torch" / "kernels" /
                             "csrc" / "fused_ce_fwd.cu",
                             [f"-DCE_COEF3_PROMOTE={every}"], "fused_ce_fwd")
                 for name, every in FWD_VARIANTS[1:]}
    libs = {VARIANTS[0][0]: _build.load("fused_ce_bwd")}
    fwd_libs = {FWD_VARIANTS[0][0]: _build.load("fused_ce_fwd")}
    try:
        libs.update({name: wait() for name, wait in waits.items()})
        fwd_libs.update({name: wait() for name, wait in fwd_waits.items()})
    except RuntimeError as e:
        print(e)
        return 1
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"card": card, "shape": [T, V, D], "limits": LIMITS,
              "fwd_limit": FWD_LIMIT, "variants": [], "depth": [],
              "forward": []}

    def grads(h, w, labels):
        lse = fused_ce_fwd(h, w, labels)[1]
        t = h.shape[0]
        g_nll = torch.full((t,), 1.0 / t, device="cuda")
        g_lse = 0.2 * lse / t
        return lse, g_nll, g_lse

    for kind in ("logits_std2", "logits_std4", "logits_std8", "snapped"):
        h, w, labels = inputs(torch, gen, T, V, D, kind)
        lse, g_nll, g_lse = grads(h, w, labels)
        args = (h, w, labels, lse, g_nll, g_lse)
        ref = reference64(torch, *args)
        dh, dw = fused_ce_bwd_plain(*args, cast=False)
        row = dict(input=kind, variant="plain f32")
        row["dh_max"], row["dh_mean"] = errors(dh, ref[0], ref[2])
        row["dw_max"], row["dw_mean"] = errors(dw, ref[1], ref[3])
        report["variants"].append(row)
        print(f"{kind} plain f32: dh max {row['dh_max']:.4g} mean "
              f"{row['dh_mean']:.4g}, dW max {row['dw_max']:.4g} mean "
              f"{row['dw_mean']:.4g}", flush=True)
        del dh, dw
        for name, _ in VARIANTS:
            lib = libs[name]
            dh, dw = bwd_launch(*args, lib=lib)
            ms = median_ms(torch, lambda lib=lib: bwd_launch(*args, lib=lib))
            row = dict(input=kind, variant=name, ms=ms)
            row["dh_max"], row["dh_mean"] = errors(dh, ref[0], ref[2])
            row["dw_max"], row["dw_mean"] = errors(dw, ref[1], ref[3])
            row["within_limits"] = (
                max(row["dh_max"], row["dw_max"]) <= LIMITS[0]
                and max(row["dh_mean"], row["dw_mean"]) <= LIMITS[1])
            report["variants"].append(row)
            print(f"{kind} {name}: {ms:.4f} ms, dh max {row['dh_max']:.4g}"
                  f" mean {row['dh_mean']:.4g}, dW max {row['dw_max']:.4g} "
                  f"mean {row['dw_mean']:.4g}, within "
                  f"{LIMITS}: {row['within_limits']}", flush=True)
            del dh, dw
        del ref, h, w

    for t in DEPTH_T:
        h, w, labels = inputs(torch, gen, t, V, D, "logits_std2")
        lse, g_nll, g_lse = grads(h, w, labels)
        args = (h, w, labels, lse, g_nll, g_lse)
        ref = reference64(torch, *args)
        runs = [("slices", None)]
        if t <= UNSLICED_MAX and t > F32_MAX_DEPTH:
            runs.append(("one slice", t))
        for how, depth in runs:
            n_slices = len(token_slices(t, torch.float32, depth))
            dh, dw = bwd_launch(*args, depth=depth)
            row = dict(T=t, how=how, slices=n_slices)
            row["dh_max"], row["dh_mean"] = errors(dh, ref[0], ref[2])
            row["dw_max"], row["dw_mean"] = errors(dw, ref[1], ref[3])
            report["depth"].append(row)
            print(f"depth T {t} {how} ({n_slices}): dh max "
                  f"{row['dh_max']:.4g} mean {row['dh_mean']:.4g}, dW max "
                  f"{row['dw_max']:.4g} mean {row['dw_mean']:.4g}",
                  flush=True)
            del dh, dw
        del ref, h, w
        torch.cuda.empty_cache()
    for kind in ("logits_std2", "logits_std4", "logits_std8", "snapped"):
        h, w, labels = inputs(torch, gen, T, V, D, kind)
        want = forward64(torch, h, w, labels)
        runs = [("plain f32", lambda: fused_ce_fwd_plain(h, w, labels))]
        runs += [(name, lambda lib=lib: fwd_launch(h, w, labels, lib=lib)[:2])
                 for name, lib in fwd_libs.items()]
        for name, fn in runs:
            got = fn()
            row = dict(input=kind, variant=name)
            (row["nll_max"], row["nll_mean"], row["lse_max"],
             row["lse_mean"]) = fwd_errors(got, want)
            if name != "plain f32":
                row["ms"] = median_ms(torch, fn)
            row["within_limit"] = max(row["nll_max"],
                                      row["lse_max"]) <= FWD_LIMIT
            report["forward"].append(row)
            print(f"forward {kind} {name}: {row.get('ms', float('nan')):.4f}"
                  f" ms, lse max {row['lse_max']:.4g} mean "
                  f"{row['lse_mean']:.4g}, nll max {row['nll_max']:.4g} "
                  f"mean {row['nll_mean']:.4g} of 1 + |value|, within "
                  f"{FWD_LIMIT}: {row['within_limit']}", flush=True)
            del got
        del h, w, want
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ce_f32_pairs.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
