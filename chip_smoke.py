#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. Builds full-width qwen1.5-4b (40 layers, d 2560, vocab 151936, bf16,
   seeded random weights) and one engine per estimator: ``exact``,
   ``mimps`` (which runs the k-means), then ``topk``, ``mince``, ``fmbe``
   and ``selfnorm``, which reuse the mimps k-means assignment. The fmbe
   build (feature map, index and per-block sketch sums through
   ``fmbe_phi``) starts with every launch count at 0 and must launch
   ``fmbe_phi``.
3. Holds each kernel against its plain PyTorch version at the shapes the
   main path gives it (bf16 inputs; LSEs and scores to 1e-3 absolute, top
   ids equal wherever the gap to the neighbouring scores exceeds 1e-3,
   union pad slots exactly 0; the signed FMBE sums to 1e-4 of the sum of
   their terms' magnitudes) and times the kernel, the plain version and,
   where one exists, a PyTorch library call computing the same function,
   beside the kernel's bound.
4. Holds the estimators against each other on the same hidden states and
   tail draws: ``mimps`` within 0.05 of the exact log Z, ``mince`` equal to
   ``mimps`` to 1e-3, ``topk`` at most the exact log Z (+1e-3) with
   ``mimps``'s top ids, ``fmbe`` finite and at least its head LSE.
5. Serves the model through ``generate`` with each estimator: 8 requests,
   prompt 16, 16 new tokens, greedy. Each run starts with every kernel's
   launch count at 0 and must launch the kernels of its path.

Prints the kernel record as one JSON line before the last, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
TOL = 1e-3
FMBE_REL = 1e-4                # signed FMBE sums: of sum |terms|, + 1e-6
N_REQ, PROMPT, NEW = 8, 16, 16
PHI_CHUNK_BLOCKS = 16          # blocks per fmbe_phi launch in the build


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=20, warm=3):
    """Device time of ``fn``: median milliseconds over ``reps`` replays of a
    CUDA graph captured from one call, timed with CUDA events. The graph
    leaves out the host's launch overhead, which ``eager_ms`` includes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _median_events(torch, graph.replay, reps)


def eager_ms(torch, fn, reps=20, warm=3):
    """Median milliseconds of one eager call, host launch overhead included."""
    for _ in range(warm):
        fn()
    return _median_events(torch, fn, reps)


def _median_events(torch, fn, reps):
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def wall_ms(torch, fn, reps=10):
    """Median host-clock milliseconds of ``fn`` ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare_lse(name, got, want):
    got, want = got.float().cpu(), want.float().cpu()
    same_inf = (got.isneginf() == want.isneginf()).all().item()
    check(same_inf, f"{name}: -inf pattern differs")
    fin = ~want.isneginf()
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    check(err <= TOL, f"{name}: max abs err {err} > {TOL}")
    return err


def compare_topk(name, kv, ki, pv, pi):
    """kv/ki: kernel top-k; pv/pi: plain top-(k+1). Values agree to TOL at
    every rank; ids agree wherever the gap to both neighbours > TOL."""
    kv, ki, pv, pi = (t.cpu() for t in (kv, ki, pv, pi))
    k = kv.shape[1]
    err = (kv - pv[:, :k]).abs().max().item()
    check(err <= TOL, f"{name}: top-k scores differ by {err}")
    checked = 0
    for q in range(kv.shape[0]):
        for j in range(k):
            up = pv[q, j - 1] - pv[q, j] if j else float("inf")
            down = pv[q, j] - pv[q, j + 1]
            if up > TOL and down > TOL:
                check(ki[q, j] == pi[q, j],
                      f"{name}: query {q} rank {j} id {int(ki[q, j])} != "
                      f"plain {int(pi[q, j])}")
                checked += 1
    return err, checked


def compare_signed_sum(name, got, want, terms):
    """FMBE sums are signed and cancel: |got - want| <= 1e-4 * sum |terms|
    + 1e-6 along the last axis of ``terms``. Returns (max abs err, max
    err / tolerance)."""
    err = (got.double() - want.double()).abs()
    tol = FMBE_REL * terms.double().abs().sum(-1) + 1e-6
    ratio = (err / tol).max().item()
    check(ratio <= 1.0, f"{name}: error {err.max().item():.3e} exceeds "
          f"1e-4 of sum |terms| ({ratio:.3f} of the tolerance)")
    return err.max().item(), ratio


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    # the plain versions' f32 products run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.core.decode import _tail_rows, make_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import (fmbe_phi, fmbe_phi_plain, fmbe_z,
                                         fmbe_z_plain)
    from repro_torch.kernels.ivf_score import (ivf_decode, ivf_decode_plain,
                                              union_scores,
                                              union_scores_plain)
    from repro_torch.kernels.topk_z import topk_z, topk_z_plain
    from repro_torch.models import Model
    from repro_torch.serve import Engine, generate

    kernels = {"topk_z": topk_z, "ivf_decode": ivf_decode,
               "union_scores": union_scores, "fmbe_phi": fmbe_phi,
               "fmbe_z": fmbe_z}

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in kernels.items()}

    t_start = time.time()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.time()
    built = _build.build_all()
    log(f"build: {time.time() - t0:.1f} s (built {built})")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # -- 2. model and engines --------------------------------------------------
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")

    def with_method(method):
        return dataclasses.replace(cfg, partition=dataclasses.replace(
            cfg.partition, method=method))

    t0 = time.time()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"model: {cfg.name} layers {cfg.n_layers} d {cfg.d_model} vocab "
        f"{cfg.vocab} {cfg.dtype}, {n_params / 1e9:.3f} B params, init "
        f"{time.time() - t0:.1f} s")
    max_len = PROMPT + NEW
    engines = {"exact": Engine(Model(with_method("exact")), params, max_len,
                               seed=1)}
    t0 = time.time()
    engines["mimps"] = Engine(Model(cfg), params, max_len, seed=1)
    torch.cuda.synchronize()
    index = engines["mimps"].index
    check(index is not None, "mimps engine built no index")
    log(f"index: {index.n_blocks} blocks of {index.block_rows} rows, "
        f"{index.v_blocks.numel() * 2 / 1e9:.3f} GB, k-means build "
        f"{time.time() - t0:.1f} s")
    for method in ("topk", "mince", "selfnorm"):
        engines[method] = Engine(Model(with_method(method)), params, max_len,
                                 seed=1, index_assign=index.assign)
    reset_counts()
    t0 = time.time()
    engines["fmbe"] = Engine(Model(with_method("fmbe")), params, max_len,
                             seed=1, index_assign=index.assign)
    torch.cuda.synchronize()
    build_counts = read_counts()
    check(build_counts["fmbe_phi"] > 0, "the fmbe build never launched "
          "fmbe_phi")
    fstate = engines["fmbe"].state.fmbe
    fm = fstate.fm
    check(fstate.lambda_blocks is not None, "fmbe engine built no block "
          "sketch")
    check(bool(torch.isfinite(fstate.lambda_blocks).all()),
          "fmbe lambda_blocks not finite")
    deg_sum = int(fm.degree.sum())
    log(f"fmbe build: P {fm.omega.shape[0]} features, max degree "
        f"{fm.omega.shape[1]}, mean degree {deg_sum / fm.omega.shape[0]:.4f}, "
        f"{time.time() - t0:.2f} s with launches {build_counts} [{card}]")
    for name, eng in engines.items():
        check(eng.backend.method == name, f"{name}: engine serves "
              f"{eng.backend.method}")
        check((eng.index is not None) == (name not in ("exact", "selfnorm")),
              f"{name}: unexpected index state")
        if eng.index is not None:
            check(torch.equal(eng.index.v_blocks, index.v_blocks),
                  f"{name}: index differs from mimps's")

    # decode hidden states of the real model for the kernel comparisons
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (N_REQ,), generator=gen, device=dev)
    exact_eng = engines["exact"]
    cache = exact_eng.model.init_decode_state(N_REQ, max_len, dev)
    h = exact_eng.model.decode_step(params, cache, toks, 0)
    w = exact_eng.state.w
    pc = cfg.partition
    k = pc.sample_k
    q, d, v = h.shape[0], h.shape[1], w.shape[0]
    log(f"hidden states: Q {q}, |h|_2 mean "
        f"{h.float().norm(dim=-1).mean().item():.2f}")

    # -- 3. kernels against their plain versions -----------------------------
    lse, tv, ti = topk_z(h, w, k)
    torch.cuda.synchronize()
    p_lse, p_v, p_i = topk_z_plain(h, w, k + 1)
    err = compare_lse("topk_z lse", lse, p_lse)
    err_v, n_ids = compare_topk("topk_z", tv, ti, p_v, p_i)
    tz_bytes = v * d * 2 + q * d * 2 + q * 4 + q * k * 8
    tz_bound, tz_by = bound_ms(tz_bytes, 2 * q * v * d)

    def library_topk_z():
        logits = torch.matmul(h, w.T)
        return torch.logsumexp(logits.float(), -1), torch.topk(logits, k)

    tz = dict(name="topk_z", route="cuda",
              source="src/repro_torch/kernels/csrc/topk_z.cu",
              replaces="src/repro/kernels/topk_z.py:82",
              max_abs_err=max(err, err_v),
              ms=time_ms(torch, lambda: topk_z(h, w, k)),
              plain_ms=time_ms(torch, lambda: topk_z_plain(h, w, k)),
              bound_ms=tz_bound, bound_by=tz_by,
              library_ms=time_ms(torch, library_topk_z))
    tz_eager = eager_ms(torch, lambda: topk_z(h, w, k))
    log(f"topk_z: Q {q} V {v} d {d} k {k}: lse err {err:.2e}, top-k err "
        f"{err_v:.2e}, {n_ids} ids checked; kernel {tz['ms']:.4f} ms "
        f"(eager call {tz_eager:.4f} ms), plain "
        f"{tz['plain_ms']:.4f} ms, library {tz['library_ms']:.4f} ms, bound "
        f"{tz_bound:.4f} ms ({tz_by}, {tz_bytes / 1e6:.1f} MB) [{card}]")

    plan = make_plan(index, h, pc.n_probe, pc.l, generator=gen)
    row_logw = torch.where(index.valid, 0.0, -1e30).float()
    args = (index.v_blocks, h, plan.head_ids, plan.head_live,
            plan.head_member, row_logw, _tail_rows(index, plan),
            plan.tail_accept)
    hl, tl, iv, ii = ivf_decode(*args, k=k)
    torch.cuda.synchronize()
    p_hl, p_tl, p_v, p_i = ivf_decode_plain(*args, k=k + 1)
    err = max(compare_lse("ivf_decode head_lse", hl, p_hl),
              compare_lse("ivf_decode tail_lse", tl, p_tl))
    err_v, n_ids = compare_topk("ivf_decode", iv, ii, p_v, p_i)
    live, cap = int(plan.head_live), plan.head_ids.shape[0]
    br, l = index.block_rows, pc.l
    iv_bytes = (live * br * d * 2 + l * d * 2 + q * d * 2 + cap * 4
                + q * cap + live * br * 4 + q * l + q * (8 + 8 * k))
    iv_bound, iv_by = bound_ms(iv_bytes, 2 * q * (live * br + l) * d)
    ivf = dict(name="ivf_decode", route="cuda",
               source="src/repro_torch/kernels/csrc/ivf_decode.cu",
               replaces="src/repro/kernels/ivf_score.py:226",
               max_abs_err=max(err, err_v),
               ms=time_ms(torch, lambda: ivf_decode(*args, k=k)),
               plain_ms=time_ms(torch, lambda: ivf_decode_plain(*args, k=k)),
               bound_ms=iv_bound, bound_by=iv_by, library_ms=None)
    iv_eager = eager_ms(torch, lambda: ivf_decode(*args, k=k))
    log(f"ivf_decode: Q {q} union {live} live of {cap} slots x {br} rows, "
        f"l {l}: lse err {err:.2e}, top-k err {err_v:.2e}, {n_ids} ids "
        f"checked; kernel {ivf['ms']:.4f} ms (eager call {iv_eager:.4f} ms), "
        f"plain {ivf['plain_ms']:.4f} ms, "
        f"bound {iv_bound:.4f} ms ({iv_by}, {iv_bytes / 1e6:.1f} MB) [{card}]")

    # union_scores on the same plan's union (the topk/mince/fmbe head)
    uargs = (index.v_blocks, h, plan.head_ids, plan.head_live)
    us = union_scores(*uargs)
    torch.cuda.synchronize()
    p_us = union_scores_plain(*uargs)
    check(us.shape == (q, cap, br), f"union_scores shape {tuple(us.shape)}")
    err = (us[:, :live] - p_us[:, :live]).abs().max().item()
    check(err <= TOL, f"union_scores: live slots differ by {err}")
    check(bool((us[:, live:] == 0).all()), "union_scores: pad slots not 0")
    us_bytes = (live * br * d * 2 + q * d * 2 + cap * 4 + 4
                + q * cap * br * 4)
    us_bound, us_by = bound_ms(us_bytes, 2 * q * live * br * d)

    def library_union_scores():
        return torch.einsum("qd,ubd->qub", h, index.v_blocks[plan.head_ids])

    uni = dict(name="union_scores", route="cuda",
               source="src/repro_torch/kernels/csrc/union_scores.cu",
               replaces="src/repro/kernels/ivf_score.py:110",
               max_abs_err=err,
               ms=time_ms(torch, lambda: union_scores(*uargs)),
               plain_ms=time_ms(torch, lambda: union_scores_plain(*uargs)),
               bound_ms=us_bound, bound_by=us_by,
               library_ms=time_ms(torch, library_union_scores))
    us_eager = eager_ms(torch, lambda: union_scores(*uargs))
    log(f"union_scores: Q {q} union {live} live of {cap} slots x {br} rows: "
        f"live err {err:.2e}, pad slots 0; kernel {uni['ms']:.4f} ms (eager "
        f"call {us_eager:.4f} ms), plain {uni['plain_ms']:.4f} ms, library "
        f"{uni['library_ms']:.4f} ms, bound {us_bound:.4f} ms ({us_by}, "
        f"{us_bytes / 1e6:.1f} MB) [{card}]")

    # fmbe_z on the decode's per-query complement lambda
    n_feat, max_deg, _ = fm.omega.shape
    lam_rest = (fstate.lambda_tilde[None, :] -
                fstate.lambda_blocks[plan.block_ids.long()].sum(1))
    zargs = (fm.omega, fm.degree, fm.coef, lam_rest.contiguous(), h)
    z = fmbe_z(*zargs)
    z_again = fmbe_z(*zargs)
    torch.cuda.synchronize()
    check(torch.equal(z, z_again), "fmbe_z is not bit-reproducible")
    check(bool(torch.isfinite(z).all()), "fmbe_z not finite")
    phi_h = fmbe_phi_plain(fm.omega, fm.degree, fm.coef, h)
    err, ratio = compare_signed_sum("fmbe_z", z, fmbe_z_plain(*zargs),
                                    phi_h * lam_rest)
    fz_bytes = (deg_sum * d * 4 + n_feat * 8 + q * n_feat * 4 + q * d * 2
                + q * 4)
    fz_bound, fz_by = bound_ms(fz_bytes, 2 * q * deg_sum * d)
    fz = dict(name="fmbe_z", route="cuda",
              source="src/repro_torch/kernels/csrc/fmbe_z.cu",
              replaces="src/repro/kernels/fmbe.py:121",
              max_abs_err=err, max_err_over_tol=ratio,
              ms=time_ms(torch, lambda: fmbe_z(*zargs)),
              plain_ms=time_ms(torch, lambda: fmbe_z_plain(*zargs)),
              bound_ms=fz_bound, bound_by=fz_by, library_ms=None)
    fz_eager = eager_ms(torch, lambda: fmbe_z(*zargs))
    log(f"fmbe_z: Q {q} P {n_feat} max degree {max_deg} (sum of degrees "
        f"{deg_sum}), per-query lambda: max abs err {err:.3e} = {ratio:.4f} "
        f"of the tolerance, |z| up to {z.abs().max().item():.3e}; kernel "
        f"{fz['ms']:.4f} ms (eager call {fz_eager:.4f} ms), plain "
        f"{fz['plain_ms']:.4f} ms, bound {fz_bound:.4f} ms ({fz_by}, "
        f"{fz_bytes / 1e6:.1f} MB) [{card}]")

    # fmbe_phi on one real build chunk of v_blocks, and that chunk's
    # lambda_blocks as the build computed them
    nbc = PHI_CHUNK_BLOCKS
    x = index.v_blocks[:nbc].reshape(-1, d)
    rows = x.shape[0]
    pargs = (fm.omega, fm.degree, fm.coef, x)
    phi = fmbe_phi(*pargs)
    torch.cuda.synchronize()
    p_phi = fmbe_phi_plain(*pargs)
    norm = x.float().norm(dim=-1).clamp(min=1.0)
    scale = fm.coef.abs()[None, :] * norm[:, None] ** fm.degree[None, :]
    perr = (phi - p_phi).abs()
    ptol = FMBE_REL * (p_phi.abs() + scale)
    p_ratio = (perr / ptol).max().item()
    check(p_ratio <= 1.0, f"fmbe_phi: error {perr.max().item():.3e} is "
          f"{p_ratio:.3f} of the tolerance")
    masked = p_phi.reshape(nbc, br, -1) * index.valid[:nbc, :, None]
    lerr, l_ratio = compare_signed_sum(
        "lambda_blocks", fstate.lambda_blocks[:nbc], masked.sum(1),
        masked.transpose(1, 2))
    del p_phi, masked
    fp_bytes = deg_sum * d * 4 + n_feat * 8 + rows * d * 2 + rows * n_feat * 4
    fp_bound, fp_by = bound_ms(fp_bytes, 2 * rows * deg_sum * d)
    fph = dict(name="fmbe_phi", route="cuda",
               source="src/repro_torch/kernels/csrc/fmbe_phi.cu",
               replaces="src/repro/kernels/fmbe.py:89",
               max_abs_err=perr.max().item(), max_err_over_tol=p_ratio,
               ms=time_ms(torch, lambda: fmbe_phi(*pargs), reps=10),
               plain_ms=time_ms(torch, lambda: fmbe_phi_plain(*pargs),
                                reps=5),
               bound_ms=fp_bound, bound_by=fp_by, library_ms=None)
    del phi, perr, ptol
    log(f"fmbe_phi: {nbc} blocks = {rows} rows x P {n_feat}: max abs err "
        f"{fph['max_abs_err']:.3e} = {p_ratio:.4f} of the tolerance; chunk "
        f"lambda_blocks err {lerr:.3e} = {l_ratio:.4f} of the tolerance; "
        f"kernel {fph['ms']:.4f} ms, plain {fph['plain_ms']:.4f} ms, bound "
        f"{fp_bound:.4f} ms ({fp_by}, {fp_bytes / 1e6:.1f} MB, "
        f"{rows * deg_sum * d / 1e9:.1f} G multiply-adds) [{card}]")

    # -- 4. the estimators on the same hidden states and tail draws -----------
    tail_idx = torch.randint(0, cfg.vocab, (pc.l,), generator=gen, device=dev)

    def decode(method, kk=k):
        eng = engines[method]
        return eng.backend.decode(eng.state, h, pc, k=kk, tail_idx=tail_idx)

    ex, mi, mc, tk, fb = (decode(m) for m in ("exact", "mimps", "mince",
                                              "topk", "fmbe"))
    gaps = {}
    for name, out in (("mimps", mi), ("mince", mc), ("topk", tk),
                      ("fmbe", fb)):
        check(bool(torch.isfinite(out.log_z).all()),
              f"{name} log_z not finite")
        gaps[name] = (out.log_z - ex.log_z).abs().max().item()
    check(gaps["mimps"] < 0.05, f"mimps log_z off the exact log_z by "
          f"{gaps['mimps']}")
    mince_gap = (mc.log_z - mi.log_z).abs().max().item()
    check(mince_gap <= TOL, f"mince log_z off mimps's by {mince_gap}")
    over = (tk.log_z - ex.log_z).max().item()
    check(over <= TOL, f"topk log_z above the exact log_z by {over}")
    mi_next = decode("mimps", k + 1)
    _, n_ids = compare_topk("topk vs mimps", tk.top_score, tk.top_id,
                            mi_next.top_score, mi_next.top_id)
    below = (fb.head_lse - fb.log_z).max().item()
    check(below <= TOL, f"fmbe log_z below its head_lse by {below}")
    log(f"estimators vs exact log_z on the same hidden states (max abs): "
        + ", ".join(f"{m} {g:.4e}" for m, g in gaps.items())
        + f"; mince vs mimps {mince_gap:.2e}; topk - exact at most "
        f"{over:.4e}, {n_ids} topk ids equal mimps's; fmbe log_z - head_lse "
        f"at least {-below:.4e}")

    # -- 5. serve ------------------------------------------------------------
    prompt = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen,
                           device=dev)
    path_kernels = {"exact": ("topk_z",), "mimps": ("ivf_decode",),
                    "topk": ("union_scores",), "mince": ("union_scores",),
                    "fmbe": ("union_scores", "fmbe_z"),
                    "selfnorm": ("topk_z",)}
    served = {}
    totals = {name: 0 for name in kernels}
    totals["fmbe_phi"] = build_counts["fmbe_phi"]        # the fmbe build
    for method, needs in path_kernels.items():
        eng = engines[method]
        generate(eng, prompt[:, :2], 2)                  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        out, aux = generate(eng, prompt, NEW, return_aux=True)
        torch.cuda.synchronize()
        secs = time.time() - t0
        counts = read_counts()
        check(out.shape == (N_REQ, NEW), f"{method}: tokens {out.shape}")
        check(bool(((out >= 0) & (out < cfg.vocab)).all()),
              f"{method}: token out of range")
        check(bool(torch.isfinite(aux["log_z"]).all()),
              f"{method}: log_z not finite")
        for name in needs:
            check(counts[name] > 0,
                  f"{method}: the main path never launched {name}")
        for name in totals:
            totals[name] += counts[name]
        served[method] = dict(tokens=out.cpu(), counts=counts)
        log(f"serve {method}: {N_REQ} requests x ({PROMPT} prompt + {NEW} "
            f"new) in {secs:.3f} s, {N_REQ * NEW / secs:.1f} new tokens/s, "
            f"{secs / (PROMPT + NEW - 1) * 1e3:.2f} ms/step, launches "
            f"{counts} [{card}]")
    for rec in (tz, ivf, uni, fph, fz):
        rec["launches"] = totals[rec["name"]]
    for method in ("mimps", "topk", "mince", "fmbe", "selfnorm"):
        for ref in ("exact", "mimps"):
            share = (served[method]["tokens"] == served[ref]["tokens"]
                     ).float().mean().item()
            log(f"share of {method} greedy tokens equal to {ref}'s: "
                f"{share:.4f}")

    # where a decode step's time goes: trunk vs output layer, host clock
    # (synchronised) beside device time (CUDA graph replay)
    parts = [("trunk", lambda: exact_eng.model.decode_step(
        params, cache, toks, 1))]
    parts += [(f"{m} output", lambda m=m: decode(m))
              for m in ("exact", "mimps", "topk", "mince", "fmbe",
                        "selfnorm")]
    for name, fn in parts:
        log(f"step part {name}: wall {wall_ms(torch, fn):.3f} ms, "
            f"device {time_ms(torch, fn):.3f} ms [{card}]")
    line = {"kernels": [tz, ivf, uni, fph, fz]}
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
