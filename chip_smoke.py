#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. Holds each kernel against its plain PyTorch version at the shapes the
   main path gives it (bf16 inputs; LSEs to 1e-3 absolute; top ids equal
   wherever the gap to the neighbouring scores exceeds 1e-3) and times the
   kernel, the plain version and, where one exists, a PyTorch library call
   computing the same function, beside the kernel's bound.
3. Serves full-width qwen1.5-4b (40 layers, d 2560, vocab 151936, bf16,
   seeded random weights) through ``generate`` with the ``exact`` and the
   ``mimps`` estimator: 8 requests, prompt 16, 16 new tokens, greedy. Each
   run starts with every kernel's launch count at 0 and must launch its
   kernel.

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
N_REQ, PROMPT, NEW = 8, 16, 16


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

    from repro_torch.configs import get_config
    from repro_torch.core.decode import _tail_rows, make_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_score import ivf_decode, ivf_decode_plain
    from repro_torch.kernels.topk_z import topk_z, topk_z_plain
    from repro_torch.models import Model
    from repro_torch.serve import Engine, generate

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

    # -- model and engines ---------------------------------------------------
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    cfg_exact = dataclasses.replace(
        cfg, partition=dataclasses.replace(cfg.partition, method="exact"))
    t0 = time.time()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"model: {cfg.name} layers {cfg.n_layers} d {cfg.d_model} vocab "
        f"{cfg.vocab} {cfg.dtype}, {n_params / 1e9:.3f} B params, init "
        f"{time.time() - t0:.1f} s")
    max_len = PROMPT + NEW
    exact_eng = Engine(Model(cfg_exact), params, max_len, seed=1)
    t0 = time.time()
    mimps_eng = Engine(Model(cfg), params, max_len, seed=1)
    torch.cuda.synchronize()
    index = mimps_eng.index
    check(index is not None, "mimps engine built no index")
    log(f"index: {index.n_blocks} blocks of {index.block_rows} rows, "
        f"{index.v_blocks.numel() * 2 / 1e9:.3f} GB, k-means build "
        f"{time.time() - t0:.1f} s")

    # decode hidden states of the real model for the kernel comparisons
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (N_REQ,), generator=gen, device=dev)
    cache = exact_eng.model.init_decode_state(N_REQ, max_len, dev)
    h = exact_eng.model.decode_step(params, cache, toks, 0)
    w = exact_eng.state.w
    pc = cfg.partition
    k = pc.sample_k

    # -- 2. kernels against their plain versions -----------------------------
    lse, tv, ti = topk_z(h, w, k)
    torch.cuda.synchronize()
    p_lse, p_v, p_i = topk_z_plain(h, w, k + 1)
    err = compare_lse("topk_z lse", lse, p_lse)
    err_v, n_ids = compare_topk("topk_z", tv, ti, p_v, p_i)
    q, d, v = h.shape[0], h.shape[1], w.shape[0]
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

    # the estimator against the exact pass on the same hidden states
    ex = exact_eng.backend.decode(exact_eng.state, h, pc, k=k)
    mi = mimps_eng.backend.decode(mimps_eng.state, h, pc, k=k,
                                  generator=gen)
    gap = (mi.log_z - ex.log_z).abs().max().item()
    check(torch.isfinite(mi.log_z).all().item(), "mimps log_z not finite")
    check(gap < 0.05, f"mimps log_z off the exact log_z by {gap}")
    log(f"mimps vs exact log_z on the same hidden states: max abs diff "
        f"{gap:.2e}")

    # -- 3. serve --------------------------------------------------------------
    prompt = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen,
                           device=dev)
    served = {}
    for method, eng, kernel in (("exact", exact_eng, topk_z),
                                ("mimps", mimps_eng, ivf_decode)):
        generate(eng, prompt[:, :2], 2)                  # warm-up
        torch.cuda.synchronize()
        topk_z.launches = 0
        ivf_decode.launches = 0
        t0 = time.time()
        out, aux = generate(eng, prompt, NEW, return_aux=True)
        torch.cuda.synchronize()
        secs = time.time() - t0
        counts = {"topk_z": topk_z.launches,
                  "ivf_decode": ivf_decode.launches}
        check(out.shape == (N_REQ, NEW), f"{method}: tokens {out.shape}")
        check(bool(((out >= 0) & (out < cfg.vocab)).all()),
              f"{method}: token out of range")
        check(bool(torch.isfinite(aux["log_z"]).all()),
              f"{method}: log_z not finite")
        check(kernel.launches > 0,
              f"{method}: the main path never launched {kernel.__name__}")
        served[method] = dict(tokens=out.cpu(), counts=counts)
        log(f"serve {method}: {N_REQ} requests x ({PROMPT} prompt + {NEW} "
            f"new) in {secs:.3f} s, {N_REQ * NEW / secs:.1f} new tokens/s, "
            f"{secs / (PROMPT + NEW - 1) * 1e3:.2f} ms/step, launches "
            f"{counts} [{card}]")
    tz["launches"] = served["exact"]["counts"]["topk_z"]
    ivf["launches"] = served["mimps"]["counts"]["ivf_decode"]
    share = (served["mimps"]["tokens"] == served["exact"]["tokens"]
             ).float().mean().item()
    log(f"share of mimps greedy tokens equal to exact: {share:.4f}")

    # where a decode step's time goes: trunk vs output layer, host clock
    # (synchronised) beside device time (CUDA graph replay)
    tail_idx = torch.randint(0, cfg.vocab, (pc.l,), generator=gen, device=dev)
    parts = (("trunk", lambda: exact_eng.model.decode_step(
                  params, cache, toks, 1)),
             ("exact output", lambda: exact_eng.backend.decode(
                  exact_eng.state, h, pc, k=k)),
             ("mimps output", lambda: mimps_eng.backend.decode(
                  mimps_eng.state, h, pc, k=k, tail_idx=tail_idx)))
    for name, fn in parts:
        log(f"step part {name}: wall {wall_ms(torch, fn):.3f} ms, "
            f"device {time_ms(torch, fn):.3f} ms [{card}]")
    line = {"kernels": [tz, ivf]}
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
