#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA
GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. Builds full-width qwen1.5-4b (40 layers, d 2560, vocab 151936, bf16,
   seeded random weights) and one engine per estimator: ``exact``,
   ``mimps`` (which runs the k-means), then ``topk``, ``mince``, ``fmbe``
   and ``selfnorm``, which reuse the mimps k-means assignment, and ``lsh``
   (8 tables of 8-bit SimHash codes over the head). The fmbe build
   (feature map, index, pack and per-block sketch sums through
   ``fmbe_phi``) starts with every launch count at 0, is timed by itself
   and must launch only the tensor-core ``fmbe_phi``.
3. Holds each kernel against its plain PyTorch version at the shapes the
   main path gives it (bf16 inputs; LSEs and scores to 1e-3 absolute, top
   ids equal wherever the gap to the neighbouring scores exceeds 1e-3,
   union pad slots exactly 0; the signed FMBE sums to 1e-4 of the sum of
   their terms' magnitudes; ``lsh_probe`` on the trimmed candidate union
   and on the dense fallback, its counts equal exactly and its membership
   equal to the plan's, its query codes equal to the plan's except where a
   projection lies within 1e-5 of 0 relative to |h| |proj row|, two calls
   bit-equal; ``union_scores`` two calls bit-equal too) and times the
   kernel, the plain version and, where one exists, a PyTorch library call
   computing the same function, beside the kernel's bound, with the
   kernel's share of the bound and its GB/s for ``union_scores`` and
   ``lsh_probe`` (``union_scores`` also with the L2 cache flushed before
   each call, a time its record takes if the warm one beats the bound).
   ``ivf_score`` runs on the mimps plan's probe ids (two calls bit-equal,
   the rows its kernels copy equal to its bound's distinct blocks, timed
   as ``ivf_decode`` is, by kernel too) and is then driven through its
   entry point ``ops.ivf_block_scores`` with the launch counts at 0.
4. Holds the estimators against each other on the same hidden states and
   tail draws: ``mimps`` within 0.05 of the exact log Z, ``mince`` equal to
   ``mimps`` to 1e-3, ``topk`` at most the exact log Z (+1e-3) with
   ``mimps``'s top ids, ``fmbe`` and ``lsh`` finite and at least their head
   LSE (``lsh`` draws its own tail; its gap to the exact log Z is
   recorded).
5. Serves the model through ``generate`` with each estimator: 8 requests,
   prompt 16, 16 new tokens, greedy. Each engine's decode step is captured
   in a CUDA graph first (timed), then ``generate`` replays it once a step,
   starting with every kernel's launch count at 0: each kernel of the path
   must launch once a replay or a whole multiple of it. The same requests
   then go through ``host_loop=True`` from the same generator state: the
   tokens, log_prob and log_z must be bit-equal. Logs wall ms/step and
   tokens/s of both, and the captured step's device ms (graph replay).
   mimps also runs at temperature 1.0 on the same graph, bit-equal to its
   host loop. The lsh run logs its candidate union per step against the
   trimmed capacity (at least one step on the trimmed branch), and an lsh
   engine with ``head_cap`` 64 takes the dense branch on every step,
   captured and bit-equal too. One captured mimps step with the lanes at
   positions shifted by 0 to 3 must equal the same step taken eagerly bit
   for bit (tokens, log_prob, log_z, KV cache). The step parts (trunk and
   each output layer, lsh included) are timed as CUDA graphs; one replay
   of the captured mimps step runs under ``torch.profiler`` (kernels a
   step, time by kernel), and one eager trunk call by kind (projections,
   attention, norms, RoPE, elementwise), its output bit-equal to the plain
   trunk's.
5b. The lifecycle phase (``lifecycle``), on the same parameters: a mimps
   engine with the fixed-capacity index (``device_index=True``: 553
   blocks at qwen1.5-4b) and the health guard on serves the same traffic,
   its tokens and log Z bit-equal to the unguarded run's; with NaN rows
   installed in its index every query of every step is flagged and the
   tokens and log Z are the exact engine's; ``shadow_exact_log_z`` is
   bit-equal to the exact tier's log Z; ``swap_index`` to a new head keeps
   every state shape and serves a fresh engine's tokens; a two-block
   permutation is caught by ``verify_and_restore`` and the restored index
   and tokens are bit-equal to the clean ones; topk, mince and fmbe serve
   through ``tier_state`` on the shared index. Every run goes through the
   captured ``generate`` and then the host loop (which records the guard's
   flags of each step), bit-equal; the runs after the swap and after the
   restore must each capture afresh. Each run of the path starts
   with the launch counts at 0 and must launch ``ivf_decode``,
   ``union_scores``, ``fmbe_phi``, ``fmbe_z`` and the gated ``topk_z``.
   Times the fixed-capacity build, the swap, the restore and the digest,
   the gated ``topk_z`` with no query and with every query flagged, and a
   guarded against an unguarded output layer. The serving engines and
   parameters are then freed.
5c. The estimators phase (``estimators``), on the same parameters and the
   serving phase's 8 hidden states: ``PartitionLayer`` over qwen1.5-4b's
   lm_head (151936 x 2560, bf16) for exact, mimps (with an index), nmimps,
   uniform, mince, fmbe and selfnorm, its kernels (``topk_z``,
   ``ivf_score``, ``fmbe_z``, and ``fmbe_phi`` in the fmbe build) against
   ``use_kernel=False`` on the same injected draws: log Z within 1e-3,
   ``top_candidates`` (k 8) ids equal wherever the neighbouring scores are
   more than 1e-3 apart, two calls bit-equal, mimps within 0.05 of exact,
   the fmbe sketch's signed sums within 1e-4 of the sum of their terms;
   mince also with the paper's weighting. Each method's path starts with
   the launch counts at 0 and must launch its kernels. Then the paper's
   Fig. 1 and Tables 1-3 (``repro_torch.studies.paper_tables``) at the JAX
   scripts' sizes (n 20000, d 64, 100 queries, seeds 0-2, FMBE with 16384
   features), printed, their f32 kernels launched, and every ordering of
   ``paper_tables.ORDERINGS`` required. Then the paper's Table 4
   (``repro_torch.studies.table4_lbl``) at the JAX script's full size (an
   LBL model, V 10000, d 100, trained 300 NCE steps; 500 held-out
   contexts): its class vectors (d + 1 = 101 wide) and queries padded with
   zero columns to 104 for ``topk_z`` (the exact log Z) and ``ivf_score``
   (MIMPS over a 128-row block index), both launched at f32 only, held to
   ``use_kernel=False`` within 1e-3, the padded plain path to the unpadded
   one within T4_PAD_TOL, and MIMPS beating Z = 1 at every (n_probe, l).
6. Builds the training state of the same model (``init_train_state``:
   bf16 parameters, f32 AdamW moments) and holds the fused CE kernels
   against their plain versions on the forward's hidden states of one
   synthetic batch (B 4 x S 256, T = 1024), w = lm_head, g_nll = 1/T and
   the selfnorm cotangent g_lse = 2 alpha lse / T: nll and lse to 1e-3, dh
   and dW (f32, before the cast) to 2**-7 of the sum of their terms'
   magnitudes per element and 2**-10 on average (both versions round the
   coefficient to bf16), the same against ``fused_ce_bwd_chunked_plain``
   (the kernel's chunked decomposition), two calls bit-equal; times both
   beside their bounds, plain versions and library calls, and prints their
   achieved TFLOP/s and share of the bound, the backward's chunk size and
   scratch bytes, its peak memory across one call, each kernel's
   registers, shared memory and spills as ptxas reported them, each
   launch of the two by name (``torch.profiler``), and the backward with
   its dh and dW items dealt longest first (its path) against round-robin
   (the same bits required; timed in the order longest-first, round-robin,
   round-robin, longest-first).
7. Trains: 4 ``fused_ce`` steps on that batch, repeated (the loss must be
   finite and fall), then 2 ``selfnorm`` steps, each starting with the
   launch counts at 0 and launching each fused CE kernel exactly once;
   prints ms/step, tokens/s and peak memory, then one more step split
   into forward, loss, backward and optimizer, and one under
   ``torch.profiler`` (device busy time, idle share, top kernels and host
   ops).

7b. Estimator-backed training (``estimator_train``) of the same
   full-width model on the same batch, each loss from a fresh
   ``init_train_state`` (the previous state freed): mimps_ce (the 553-block
   IVF index in ``TrainState.index``) and lsh_ce (8 tables of 8-bit codes):
   at the first step's inputs the sparse CE's nll and log Z to 1e-5 of 1 +
   |value| from a float64 evaluation of the same formula on the same plan
   and operands, dh and dw before the cast to 1e-4 of the sum of their
   terms' magnitudes (1e-5 on average) and after it to GRAD_REL, every dw
   row outside head ∪ tail ∪ labels exactly 0, two calls bit-equal, and
   for lsh_ce each row of each token in exactly one of head, tail
   population and label term; then 4 steps, ``make_index_refresh`` between
   steps 2 and 3 (the index's shapes kept, churn and drift finite), the
   loss finite and falling; mimps_ce takes one more step split into parts
   and 2 fused_ce steps for comparison. mince_ce, nce and sampled take 2
   steps each (nce and sampled on one noise draw), finite and falling. The
   estimator steps launch none of the nine kernels. Logs ms a step (wall
   and CUDA events), tokens/s, peak memory, head_live, head_hit_rate and
   k_eff a step, the refresh's seconds and the sparse CE's ms.
7c. The checkpoint round trip (``checkpoint_round_trip``) on the reduced
   qwen1.5-4b config, mimps_ce and lsh_ce: save after 2 steps, restore
   (twice): every leaf, the index and the generator bit-equal to the
   saved state; step 3 from the two restored copies, and, if they are
   bit-equal, the uninterrupted step 3 equal to them bit for bit (else
   where they first differ is logged).

8. The f32 phase: the same model at full width in f32 with its depth cut
   to 4 layers (the one cut). Each estimator builds its engine (the f32
   fmbe build timed, its ``fmbe_phi`` launches all f32) and takes one
   decode step through the captured ``generate`` with the launch counts at
   0, bit-equal to the host loop's; each kernel of its path must launch,
   and only at f32 (``by_variant``). Every
   kernel is held to its plain version at f32 at the path's shapes under
   the limits above. The f32 CE pair and ``fmbe_phi`` run on the tensor
   cores on three exact bf16 planes of each f32 operand (omega's +-1 rows
   are exact as they are), and nothing is rounded to bf16: the CE
   backward's dh and dW to 1e-4 of the sum of their terms, 1e-5 on
   average; the CE forward's nll and lse to 1e-3 of its plain version and
   of its plane decomposition and to 1e-5 of 1 + |value| from float64;
   ``fmbe_phi`` to its plain version and to its plane decomposition; each
   kernel's split of its operands equal to ``split_planes`` bit for bit.
   Then 2 ``fused_ce`` train steps launch one f32 CE kernel of each kind a
   step.

9. The traffic phase (``traffic``), last, on the serving phase's
   parameters made again from their seed (its ``torch.profiler`` sessions
   slow the host-bound train steps run after them in the same process;
   ``tools/traffic_train_order.py``): a mimps
   engine with the fixed-capacity index and the guard behind one
   ``Scheduler`` of 16 lanes (prompt cap 128, max_len 160), its step one
   CUDA graph a tier. Parity: six staggered requests (prompts 5-120, 4-32
   new tokens, greedy and sampled) give the tokens each gives alone in the
   table and through its solo captured ``generate(generator=)`` (where
   batch 1 differs, the first differing step and the trunk's batch-1 vs
   batch-16 hidden states are logged and every request is held to
   ``generate`` at batch 16, a sampled one with row 0 of generate's noise
   injected). Traffic: 64 requests (prompts 16-128, 32 new
   tokens) on Poisson arrivals at 0.25 a step: all complete, nothing is
   captured again, ``ivf_decode`` launches once a step and the gated
   ``topk_z`` twice; goodput, token-latency percentiles, first-token
   latency, occupancy, step device and host ms, the dedup ratio and the
   captures are logged beside the sequential captured ``generate`` over
   the same requests. Overload: 48 requests at twice the rate, queue 16,
   ladder watermarks 8/2: the tier walks mimps -> topk and back, every
   shed has its reason, completions balance, one capture a tier. Faults:
   a NaN lane contained, step faults retried, a permuted index restored
   by the digest every 4 steps with one capture again, tokens unchanged.
   A shared 64-token prefix (32 requests) through a 128-block pool of
   16-token blocks, plain and drafted by topk and fmbe at spec_k 4, cold
   and warm: tokens bit-identical to the plain scheduler without a pool.
   Last, one eager step of a busy table (12 of 16 lanes) at mimps, at
   topk, and drafted by topk and by fmbe: every ``ivf_decode``,
   ``union_scores``, ``fmbe_z`` and gated ``topk_z`` call of the step
   (Q 16, and 64 in a verify) made again and held to its plain version.

Prints the kernel record as one JSON line before the last (each kernel at
bf16, the gated ``topk_z`` as ``topk_z[gated]``, then each at f32 as
``<name>[f32]``), and as the last line ``{"ok": true,
"device": {...}}``. Any failure exits non-zero.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
F32_FLOPS = 67e12              # H100 SXM f32 rate outside the tensor cores
TOL = 1e-3
CODE_REL = 1e-5                # a code may flip where |proj| <= this * |h||p|
FMBE_REL = 1e-4                # signed FMBE sums: of sum |terms|, + 1e-6
N_REQ, PROMPT, NEW = 8, 16, 16
SERVE_SEED = 11                # the decode generator's seed of a served pair
PHI_CHUNK_BLOCKS = 16          # blocks per fmbe_phi launch in the build
# fused CE backward: both versions round coef to bf16, so one coefficient
# may round one bf16 step (<= 2**-7 relative) apart; + 1e-5 for f32 sums
GRAD_REL = 2 ** -7 + 1e-5      # of sum |terms|, per element
GRAD_MEAN = 2 ** -10           # of sum |terms|, on average
TRAIN_B, TRAIN_S = 4, 256      # T = 1024 tokens a step
FUSED_STEPS, SELFNORM_STEPS = 4, 2
EST_STEPS = 4                  # mimps_ce and lsh_ce steps (a refresh after 2)
# the f32 phase: qwen1.5-4b at full width, f32, depth cut to F32_LAYERS
F32_LAYERS = 4
F32_STEPS = 2
# the f32 CE pair rounds nothing: f32 scores, exp and sums in another order
F32_GRAD_REL = 1e-4            # of sum |terms|, per element
F32_GRAD_MEAN = 1e-5           # of sum |terms|, on average
F32_FWD_REL = 1e-5             # f32 nll and lse to float64, of 1 + |value|
SERVE_METHODS = ("exact", "mimps", "topk", "mince", "fmbe", "selfnorm",
                 "lsh")
PATH_KERNELS = {"exact": ("topk_z",), "mimps": ("ivf_decode",),
                "topk": ("union_scores",), "mince": ("union_scores",),
                "fmbe": ("union_scores", "fmbe_z"),
                "selfnorm": ("topk_z",), "lsh": ("lsh_probe",)}


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


def graph10_ms(torch, fn, reps=20, warm=3):
    """Device time of one call of ``fn`` in a CUDA graph of ten calls
    (median of ``reps`` replays, divided by ten): the one-call replay less
    most of a graph's own cost (``floor_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(10):
            fn()
    return _median_events(torch, graph.replay, reps) / 10


def floor_ms(torch):
    """The one-call replay of a graph of one one-element kernel: what a
    replay costs before any work."""
    one = torch.zeros(1, device="cuda")
    return time_ms(torch, lambda: one.add_(1.0))


def flushed_ms(torch, fn, reps=20):
    """Device time of ``fn`` with the L2 cache flushed before each call: a
    CUDA graph of a 64 MB write and then ``fn``, less a graph of the write
    alone (medians of ``reps`` replays each)."""
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    both = time_ms(torch, lambda: (scratch.zero_(), fn()), reps)
    return both - time_ms(torch, scratch.zero_, reps)


def share(bound, ms):
    """A kernel's time as a share of its bound, as a percentage."""
    return f"{100 * bound / ms:.1f}%"


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


def bound_ms(n_bytes, n_ops, f32_ops=0):
    """Least time for the work: bytes over the memory rate, or bf16 ``n_ops``
    at the tensor-core rate plus ``f32_ops`` at the f32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / BF16_FLOPS + f32_ops / F32_FLOPS) * 1e3
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


def capture_runner(torch, eng, tier=None):
    """Capture ``eng``'s decode step for N_REQ lanes ahead of ``generate``
    (its warm-up step and the capture, as ``generate`` would on first use).
    Returns (runner, wall seconds)."""
    from repro_torch.serve import engine as engine_mod
    torch.cuda.synchronize()
    t0 = time.time()
    run = engine_mod._graph_runner(eng, N_REQ, tier)
    run.capture(eng)
    torch.cuda.synchronize()
    return run, time.time() - t0


def served_pair(torch, eng, prompt, n, label, *, temperature=0.0,
                tier=None, seed=SERVE_SEED, wrap=None, host_first=None):
    """``generate`` through the captured step, then through the host loop
    from the same generator state; the tokens, log_prob and log_z must be
    bit-equal. ``wrap(fn)`` calls the captured run (the main path: a
    launch count is read there); ``host_first`` runs before the host loop.
    Returns ((tokens, aux, wall s) captured, (tokens, aux, wall s) host
    loop)."""
    from repro_torch.serve import generate
    runs = []
    for host_loop in (False, True):
        def run():
            eng.generator.manual_seed(seed)
            torch.cuda.synchronize()
            t0 = time.time()
            out, aux = generate(eng, prompt, n, return_aux=True,
                                temperature=temperature, tier=tier,
                                host_loop=host_loop)
            torch.cuda.synchronize()
            return out, aux, time.time() - t0
        if host_loop and host_first is not None:
            host_first()
        runs.append(wrap(run) if wrap is not None and not host_loop
                    else run())
    (a, a_aux, _), (b, b_aux, _) = runs
    check(torch.equal(a, b), f"{label}: captured tokens differ from the "
          f"host loop's")
    for name in ("log_prob", "log_z"):
        check(torch.equal(a_aux[name], b_aux[name]), f"{label}: captured "
              f"{name} differs from the host loop's")
    return runs


def load_zero(torch, run, prompt, steps):
    """Reset a captured step for ``steps`` replays of ``prompt`` (step 0,
    zero draws, temperature 0): a replay past the runner's ``max_len``
    buffers would index out of range."""
    tails = (None if run.tails is None else
             torch.zeros((steps, run.tails.shape[1]), dtype=torch.long,
                         device=run.tails.device))
    gumbel = torch.zeros((steps,) + tuple(run.gumbel.shape[1:]),
                         device=run.gumbel.device)
    run.load(prompt, tails, gumbel, 0.0)


def replay_ms(torch, run, prompt, reps=10, rounds=3):
    """Device milliseconds of one replay of a captured step: the median of
    ``rounds`` x ``reps`` replays, each round from step 0 of ``prompt``
    (CUDA events)."""
    times = []
    for _ in range(rounds):
        load_zero(torch, run, prompt, reps)
        times.append(_median_events(torch, run.graph.replay, reps))
    return statistics.median(times)


def per_lane_step(torch, eng, prompt, card):
    """Lanes shifted by 0 to 3 positions replay 4 prompt tokens eagerly
    (``Engine.decode_step`` on a (B,) position vector); the next step,
    captured in a CUDA graph and replayed, must equal the same step taken
    eagerly bit for bit: tokens, log_prob, log_z and the KV cache."""
    from repro_torch.serve import ServeState
    pc = eng.cfg.partition
    b = prompt.shape[0]
    dev = prompt.device
    gen = torch.Generator(device=dev).manual_seed(6)
    temp = torch.zeros((), dtype=torch.float32, device=dev)
    gumbel = torch.zeros((b, pc.sample_k), device=dev)
    pos0 = (torch.arange(b, device=dev) % 4).to(torch.int32)
    state = ServeState(cache=eng.model.init_decode_state(b, eng.max_len, dev),
                       pos=pos0, last_token=prompt[:, 0])
    for t in range(4):
        tail = eng.backend.draw_tail(eng.state, pc, gen)
        state = dataclasses.replace(state, last_token=prompt[:, t])
        _, state = eng.decode_step(state, temp, tail_idx=tail, gumbel=gumbel)
    tail = eng.backend.draw_tail(eng.state, pc, gen)
    state = dataclasses.replace(state, last_token=prompt[:, 4])
    eager_cache = {name: t.clone() for name, t in state.cache.items()}
    want, _ = eng.decode_step(dataclasses.replace(state, cache=eager_cache),
                              temp, tail_idx=tail, gumbel=gumbel)

    def step():
        return eng.decode_step(state, temp, tail_idx=tail, gumbel=gumbel)[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()             # writes the same KV at the same slots
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step()
    graph.replay()
    torch.cuda.synchronize()
    for name in ("token", "log_prob", "log_z", "overflow"):
        check(torch.equal(got[name], want[name]), f"per-lane positions: "
              f"the captured step's {name} differs from the eager step's")
    for name in eager_cache:
        check(torch.equal(state.cache[name], eager_cache[name]),
              f"per-lane positions: the captured step's KV {name} differs")
    log(f"per-lane positions {state.pos.tolist()}: one captured "
        f"{eng.backend.method} step bit-equal to the eager step (tokens, "
        f"log_prob, log_z, KV cache) [{card}]")


# where a decode trunk op runs, by the port function that calls it
TRUNK_KINDS = {"rmsnorm": "norms", "apply_rope": "RoPE",
               "rope_frequencies": "RoPE", "_project_qkv": "projections",
               "_dyn_update": "attention", "decode_position": "position",
               "embed": "embedding", "tblock_decode": "elementwise",
               "mlp": "elementwise", "decode_self_attention": "attention"}


def trunk_kinds(torch, fn):
    """Device milliseconds of one eager call of the decode trunk ``fn`` by
    kind: each torch call is put under a profiler range named by the port
    function that makes it (``TRUNK_KINDS``; a matmul inside
    ``decode_self_attention`` or ``mlp`` is a projection). Returns
    ({kind: (device ms, kernels)}, the trunk's output)."""
    from torch.autograd import DeviceType
    from torch.overrides import TorchFunctionMode
    from torch.profiler import ProfilerActivity, profile, record_function

    class Kinds(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            f = sys._getframe(1)
            while f is not None and "repro_torch" not in \
                    f.f_code.co_filename:
                f = f.f_back
            where = f.f_code.co_name if f is not None else ""
            kind = TRUNK_KINDS.get(where, "other")
            if getattr(func, "__name__", "") in ("__matmul__", "matmul"):
                kind = "projections"
            with record_function(f"kind:{kind}"):
                return func(*args, **(kwargs or {}))

    def n_kernels(e):
        return len(e.kernels) + sum(n_kernels(c) for c in e.cpu_children)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with Kinds():
            out = fn()
        torch.cuda.synchronize()
    kinds = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("kind:"):
            ms, n = kinds.get(e.name[5:], (0.0, 0))
            kinds[e.name[5:]] = (ms + e.device_time_total / 1e3,
                                 n + n_kernels(e))
    return kinds, out


def step_breakdown(torch, run, eng, params, toks, pos, card):
    """One replay of a captured bf16 decode step under torch.profiler (its
    kernels and their device time), and one eager trunk call by kind
    (``trunk_kinds``), its output bit-equal to the plain call's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    load_zero(torch, run, toks[:, None], 2)
    run.graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run.graph.replay()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kern:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")[:50]
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"captured step profile (mimps, one replay): {len(kern)} kernels, "
        f"{sum(ms for ms, _ in by_name.values()):.3f} ms of kernel time; "
        f"top by time: "
        + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, (ms, c) in top)
        + f" [{card}]")
    cache = eng.model.init_decode_state(N_REQ, eng.max_len, toks.device)
    want = eng.model.decode_step(params, cache, toks, pos)
    kinds, got = trunk_kinds(torch, lambda: eng.model.decode_step(
        params, cache, toks, pos))
    check(torch.equal(got, want), "the trunk under the profiler's ranges "
          "differs from the plain trunk")
    total = sum(ms for ms, _ in kinds.values())
    log(f"trunk by kind (eager, 40 layers, kernel time): {total:.3f} ms in "
        f"{sum(n for _, n in kinds.values())} kernels; "
        + "; ".join(f"{k} {ms:.3f} ms ({n} kernels)" for k, (ms, n) in
                    sorted(kinds.items(), key=lambda kv: -kv[1][0]))
        + f"; weight read bound "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params['blocks'])) / HBM_BYTES_PER_S * 1e3:.3f} ms [{card}]")


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

    records, study = serve(torch, card, kernels)
    torch.cuda.empty_cache()                    # the serving state is gone
    ce_records = train(torch, card, kernels)
    records += ce_records
    torch.cuda.empty_cache()                    # the training state is gone
    estimator_train(torch, card, kernels, ce_records)
    torch.cuda.empty_cache()
    checkpoint_round_trip(torch, card)
    f32_records = f32_phase(torch, card, kernels)
    for rec in f32_records:                     # the studies ran at f32
        rec["launches"] += study[rec["name"].removesuffix("[f32]")]
    gc.collect()
    torch.cuda.empty_cache()
    # traffic last: its torch.profiler sessions slow the host-bound train
    # steps run after them in the same process
    counts, n_gated, held = traffic_last(torch, card, kernels)
    for rec in records:                         # bf16 records, by name
        rec["launches"] += n_gated if rec["name"] == "topk_z[gated]" \
            else counts.get(rec["name"], 0)
        if rec["name"] in held:                 # the table's shapes too
            rec["max_abs_err"] = max(rec["max_abs_err"], held[rec["name"]])
    records += f32_records
    line = {"kernels": records}
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def serve(torch, card, kernels):
    """Phases 2-5c: the serving engines, the seven serving kernels against
    their plain versions, the estimators, serving, the step split, the
    lifecycle phase and the estimators phase. Returns the eight kernel
    records (the gated ``topk_z`` last) and the studies' f32 launches by
    kernel; every serving tensor is freed on return."""
    from repro_torch.configs import get_config
    from repro_torch.core.decode import make_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels import fmbe as kfmbe
    from repro_torch.kernels.fmbe import fmbe_phi
    from repro_torch.core.lsh import draw_tail_ids
    from repro_torch.models import Model
    from repro_torch.serve import Engine, generate

    def reset_counts():
        _build.reset_counts(kernels.values())

    def read_counts():
        return {name: fn.launches for name, fn in kernels.items()}

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
    t_fmbe = time.time()
    engines["fmbe"] = Engine(Model(with_method("fmbe")), params, max_len,
                             seed=1, index_assign=index.assign)
    torch.cuda.synchronize()
    fmbe_secs = time.time() - t_fmbe
    build_counts = read_counts()
    check(build_counts["fmbe_phi"] > 0, "the fmbe build never launched "
          "fmbe_phi")
    check(fmbe_phi.by_variant["bf16"] == build_counts["fmbe_phi"],
          f"the bf16 fmbe build ran fmbe_phi variants "
          f"{fmbe_phi.by_variant}, want the tensor-core one only")
    t0 = time.time()
    engines["lsh"] = Engine(Model(with_method("lsh")), params, max_len,
                            seed=1)
    torch.cuda.synchronize()
    lidx = engines["lsh"].state.lsh
    check(lidx is not None, "lsh engine built no index")
    log(f"lsh index: {lidx.n_tables} tables of {lidx.n_bits} bits, "
        f"{lidx.n_buckets} buckets of {lidx.bucket_cap} rows, "
        f"{int((lidx.slot_of_row < 0).sum())} of {lidx.n * lidx.n_tables} "
        f"row-table slots dropped, largest bucket "
        f"{int((lidx.buckets >= 0).sum(-1).max())}, build "
        f"{time.time() - t0:.2f} s [{card}]")
    fstate = engines["fmbe"].state.fmbe
    fm = fstate.fm
    check(fstate.lambda_blocks is not None, "fmbe engine built no block "
          "sketch")
    check(bool(torch.isfinite(fstate.lambda_blocks).all()),
          "fmbe lambda_blocks not finite")
    deg_sum = int(fm.degree.sum())
    log(f"fmbe build: P {fm.omega.shape[0]} features, max degree "
        f"{fm.omega.shape[1]}, mean degree {deg_sum / fm.omega.shape[0]:.4f}, "
        f"{fmbe_secs:.3f} s (engine build: k-means assignment injected, "
        f"index, pack, sketch) with launches {build_counts} [{card}]")
    for name, eng in engines.items():
        check(eng.backend.method == name, f"{name}: engine serves "
              f"{eng.backend.method}")
        check((eng.index is not None) ==
              (name in ("mimps", "topk", "mince", "fmbe")),
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
    q = h.shape[0]
    log(f"hidden states: Q {q}, |h|_2 mean "
        f"{h.float().norm(dim=-1).mean().item():.2f}")

    # -- 3. kernels against their plain versions -----------------------------
    floor = floor_ms(torch)
    log(f"graph floor: a CUDA graph of one one-element kernel replays in "
        f"{floor:.4f} ms [{card}]")
    tz = topk_z_phase(torch, card, h, w, k)
    plan = make_plan(index, h, pc.n_probe, pc.l, generator=gen)
    ivf = ivf_decode_phase(torch, card, index, h, plan, pc, k)
    uni = union_scores_phase(torch, card, index, h, plan)
    fz = fmbe_z_phase(torch, card, fm, fstate, h, plan, deg_sum)

    # fmbe_phi on one real build chunk of v_blocks, and that chunk's
    # lambda_blocks as the build computed them
    fph = fmbe_phi_phase(torch, card, fm, index, fstate, deg_sum)

    lsp = lsh_probe_phase(torch, card, lidx, w, h, pc, k, gen)
    ivs = ivf_score_phase(torch, card, kernels, index, h, plan)

    # -- 4. the estimators on the same hidden states and tail draws -----------
    tail_idx = torch.randint(0, cfg.vocab, (pc.l,), generator=gen, device=dev)

    def decode(method, kk=k):
        eng = engines[method]
        if method == "lsh":           # lsh draws its own norm-tempered tail
            return eng.backend.decode(eng.state, h, pc, k=kk, generator=gen)
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
    ls = decode("lsh")
    check(bool(torch.isfinite(ls.log_z).all()), "lsh log_z not finite")
    gaps["lsh"] = (ls.log_z - ex.log_z).abs().max().item()
    ls_below = (ls.head_lse - ls.log_z).max().item()
    check(ls_below <= TOL, f"lsh log_z below its head_lse by {ls_below}")
    log(f"estimators vs exact log_z on the same hidden states (max abs): "
        + ", ".join(f"{m} {g:.4e}" for m, g in gaps.items())
        + f"; mince vs mimps {mince_gap:.2e}; topk - exact at most "
        f"{over:.4e}, {n_ids} topk ids equal mimps's; fmbe log_z - head_lse "
        f"at least {-below:.4e}; lsh log_z - exact per query "
        f"{[round(x, 4) for x in (ls.log_z - ex.log_z).tolist()]}, log_z - "
        f"head_lse at least {-ls_below:.4e}, union {int(ls.head_live)}, "
        f"k_eff {ls.k_eff.tolist()}")

    # -- 5. serve ------------------------------------------------------------
    prompt = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen,
                           device=dev)
    path_kernels = PATH_KERNELS
    served = {}
    totals = {name: 0 for name in kernels}
    totals["fmbe_phi"] = build_counts["fmbe_phi"]        # the fmbe build
    totals["ivf_score"] = ivs.pop("path_launches")    # ops.ivf_block_scores
    lsh_backend = engines["lsh"].backend

    # every fmbe_pack call from here on: a decode must never pack (it reads
    # degree to the host); the fmbe build made the pack the decode reads
    real_pack = kfmbe.fmbe_pack
    packs = []

    def counting_pack(*args, **kwargs):
        packs.append(1)
        return real_pack(*args, **kwargs)

    steps = PROMPT + NEW - 1
    runners = {}
    path_counts = {}

    def path_run(fn):
        """A captured run of the main path: the counts from 0, read
        after."""
        reset_counts()
        res = fn()
        path_counts.update(read_counts())
        return res

    for method, needs in path_kernels.items():
        eng = engines[method]
        run, capture_s = capture_runner(torch, eng)
        runners[method] = run
        kfmbe.fmbe_pack = counting_pack
        try:
            (out, aux, secs), (_, _, host_secs) = served_pair(
                torch, eng, prompt, NEW, f"serve {method}", wrap=path_run)
        finally:
            kfmbe.fmbe_pack = real_pack
        check(not packs, f"{method}: the serving run called fmbe_pack "
              f"{len(packs)} times")
        counts = dict(path_counts)
        check(out.shape == (N_REQ, NEW), f"{method}: tokens {out.shape}")
        check(bool(((out >= 0) & (out < cfg.vocab)).all()),
              f"{method}: token out of range")
        check(bool(torch.isfinite(aux["log_z"]).all()),
              f"{method}: log_z not finite")
        check(eng.captures == 1, f"{method}: {eng.captures} captures")
        for name in needs:
            check(counts[name] > 0 and counts[name] % steps == 0,
                  f"{method}: the main path launched {name} "
                  f"{counts[name]} times in {steps} replays")
        for name in totals:
            totals[name] += counts[name]
        dev_ms = replay_ms(torch, run, prompt)
        served[method] = dict(tokens=out.cpu(), counts=counts)
        log(f"serve {method}: {N_REQ} requests x ({PROMPT} prompt + {NEW} "
            f"new), captured: {secs / steps * 1e3:.3f} ms/step wall, "
            f"{N_REQ * NEW / secs:.1f} new tokens/s, replay device "
            f"{dev_ms:.3f} ms/step, capture {capture_s:.3f} s; host loop: "
            f"{host_secs / steps * 1e3:.3f} ms/step, "
            f"{N_REQ * NEW / host_secs:.1f} new tokens/s; tokens, log_prob "
            f"and log_z bit-equal; launches {counts}, fmbe_pack calls "
            f"{len(packs)} [{card}]")

    # mimps at temperature 1.0: one graph serves every temperature
    eng = engines["mimps"]
    (t_out, _, secs), (_, _, host_secs) = served_pair(
        torch, eng, prompt, NEW, "serve mimps T=1.0", temperature=1.0)
    check(eng.captures == 1, "mimps at temperature 1.0 captured again")
    log(f"serve mimps at temperature 1.0: captured {secs / steps * 1e3:.3f} "
        f"ms/step, host loop {host_secs / steps * 1e3:.3f} ms/step, "
        f"bit-equal, {(t_out.cpu() != served['mimps']['tokens']).sum()} of "
        f"{t_out.numel()} tokens differ from greedy [{card}]")

    # the lsh branches, each captured and bit-equal to the eager loop; the
    # eager loop records each step's union
    cap = lsp["trimmed_capacity"]

    def lsh_unions(eng, label):
        unions = []

        class RecordingLsh(type(lsh_backend)):
            def decode(self, *args, **kwargs):
                out = super().decode(*args, **kwargs)
                unions.append(out.head_live)
                return out

        eng.backend = RecordingLsh()
        try:
            eng.generator.manual_seed(SERVE_SEED)
            generate(eng, prompt, NEW, host_loop=True)
        finally:
            eng.backend = lsh_backend
        unions = [int(u) for u in unions]
        check(len(unions) == steps, f"{label}: {len(unions)} steps recorded")
        return unions

    unions = lsh_unions(engines["lsh"], "lsh")
    n_trim = sum(u <= cap for u in unions)
    check(n_trim > 0, "lsh: no step took the trimmed branch")
    log(f"serve lsh: candidate union per step (trimmed capacity {cap}): "
        f"{unions}; trimmed branch on {n_trim} of {len(unions)} steps, "
        f"dense fallback on {len(unions) - n_trim}")
    dense_cap = 64
    dense_eng = Engine(Model(dataclasses.replace(cfg, partition=
                                                 dataclasses.replace(
                                                     cfg.partition,
                                                     method="lsh",
                                                     head_cap=dense_cap))),
                       params, max_len, seed=1, lsh_proj=lidx.proj)
    run, capture_s = capture_runner(torch, dense_eng)
    (_, d_aux, secs), (_, _, host_secs) = served_pair(
        torch, dense_eng, prompt, NEW, "serve lsh dense", wrap=path_run)
    check(path_counts["lsh_probe"] == steps,
          f"lsh dense: {path_counts['lsh_probe']} lsh_probe launches")
    totals["lsh_probe"] += path_counts["lsh_probe"]
    d_unions = lsh_unions(dense_eng, "lsh dense")
    check(all(u > dense_cap for u in d_unions), f"lsh with head_cap "
          f"{dense_cap}: a step kept the trimmed branch ({d_unions})")
    d_ms = replay_ms(torch, run, prompt)
    log(f"serve lsh dense (head_cap {dense_cap}, every step's union "
        f"{min(d_unions)}-{max(d_unions)} rows past it): captured "
        f"{secs / steps * 1e3:.3f} ms/step, replay device {d_ms:.3f} "
        f"ms/step, host loop {host_secs / steps * 1e3:.3f} ms/step, "
        f"bit-equal [{card}]")
    del dense_eng, run

    for rec in (tz, ivf, uni, fph, fz, lsp, ivs):
        rec["launches"] = totals[rec["name"]]
    for rec in (tz, ivf, uni, fz, lsp, ivs):       # the decode kernels
        rec["floor_ms"] = floor
    for method in ("mimps", "topk", "mince", "fmbe", "selfnorm", "lsh"):
        for ref in ("exact", "mimps"):
            share = (served[method]["tokens"] == served[ref]["tokens"]
                     ).float().mean().item()
            log(f"share of {method} greedy tokens equal to {ref}'s: "
                f"{share:.4f}")

    # lanes at different positions: one captured step bit-equal to eager
    per_lane_step(torch, engines["mimps"], prompt, card)

    # where a decode step's time goes: trunk vs output layer, host clock
    # (synchronised) beside device time (CUDA graph replay)
    pos1 = torch.ones((), dtype=torch.int32, device=dev)
    lsh_tail = draw_tail_ids(lidx, pc.l, gen)
    parts = [("trunk", lambda: exact_eng.model.decode_step(
        params, cache, toks, pos1))]
    parts += [(f"{m} output", lambda m=m: decode(m))
              for m in ("exact", "mimps", "topk", "mince", "fmbe",
                        "selfnorm")]
    parts.append(("lsh output", lambda: engines["lsh"].backend.decode(
        engines["lsh"].state, h, pc, k=k, tail_idx=lsh_tail)))
    for name, fn in parts:
        log(f"step part {name}: wall {wall_ms(torch, fn):.3f} ms, "
            f"device {time_ms(torch, fn):.3f} ms [{card}]")
    step_breakdown(torch, runners["mimps"], exact_eng, params, toks, pos1,
                   card)
    del runners
    records = [tz, ivf, uni, fph, fz, lsp, ivs]
    del engines, exact_eng, cache, fstate, fm, lidx, index, plan
    gc.collect()
    torch.cuda.empty_cache()
    gated, life = lifecycle(torch, card, kernels, params, cfg, floor)
    for rec in records:
        rec["launches"] += life[rec["name"]]
    layer_counts, study_counts = estimators(torch, card, kernels, params,
                                            cfg, h)
    for rec in records:
        rec["launches"] += layer_counts[rec["name"]]
    return records + [gated], study_counts


# the traffic phase: full-width qwen1.5-4b behind the slot scheduler
T_SLOTS, T_PROMPT_CAP, T_NEW = 16, 128, 32
T_MAX_LEN = T_PROMPT_CAP + T_NEW
T_PARITY = ((5, 32, 0.0), (40, 4, 0.5), (120, 16, 0.0), (17, 8, 0.7),
            (77, 24, 0.0), (100, 12, 0.9))      # (prompt, new tokens, T)
T_PARITY_AT = (0, 3, 7, 12, 20, 30)
T_REQUESTS, T_RATE = 64, 0.25     # the traffic run: Poisson, numpy seed 0
T_OVERLOAD = 48                   # at twice the rate
T_PREFIX, T_PREFIX_REQ, T_PREFIX_NEW = 64, 32, 16
T_SPEC_K = 4
T_HELD_LANES, T_HELD_WARM = 12, 3    # the held steps' busy table


def traffic_last(torch, card, kernels):
    """Phase 9: the serving phase's full-width bf16 parameters made again
    from the same seed, then ``traffic``; returns what it returns."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    t0 = time.time()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log(f"traffic: the serving phase's parameters again (seed 0), "
        f"{time.time() - t0:.1f} s [{card}]")
    return traffic(torch, card, kernels, params, cfg)


def traffic(torch, card, kernels, params, cfg):
    """Phase 9: traffic serving (``repro_torch.serve.Scheduler`` and
    ``Server``) at full width. A mimps engine with the fixed-capacity index
    and the guard, and one scheduler of T_SLOTS lanes (prompt cap 128,
    max_len 160), whose step is one CUDA graph a tier. Runs, each with the
    launch counts from 0:

    1. Parity: six requests (prompts 5-120, 4-32 new tokens, three greedy,
       three at T 0.5-0.9 with their own seeds), admitted staggered: each
       request's tokens equal the same request alone in the table, and its
       solo captured ``generate(..., generator=<its seed>)``.
    2. Traffic: 64 requests (prompts cycling 16, 32, 64, 128; 32 new
       tokens; even ones greedy, odd ones at T 0.8), Poisson arrivals at
       0.25 a step (numpy seed 0): every request completes, nothing is
       captured again, ``ivf_decode`` launches once a step and the gated
       ``topk_z`` twice (the guard and the shadow gate). Logged beside the
       sequential captured ``generate`` over the same requests.
    3. Overload: 48 requests at twice the rate with a bounded queue, a
       default deadline and the ladder: the tier walks mimps -> topk and
       back, every shed has its reason, completions balance submissions,
       one capture a tier and none after.
    4. Faults: a NaN lane (its neighbours bit-identical to the fault-free
       run, the guard's flags counted), a step fault (retried, tokens
       unchanged), a permuted index with a digest every 4 steps (restored,
       every token unchanged, exactly one capture again, its seconds
       logged).
    5. A shared 64-token prefix with 1-4-token tails, 32 requests, through
       a 128-block pool of 16-token blocks: plain, and drafted by topk and
       by fmbe at spec_k 4, each on a cold and a warm pool, tokens
       bit-identical to the plain scheduler without a pool.
    6. The step's kernels at the table's shapes: on eager schedulers with
       12 of 16 lanes live at staggered positions, one mimps step, one topk
       step and one verify drafted by topk and by fmbe (``held_step``):
       every ``ivf_decode``, ``union_scores``, ``fmbe_z`` and (gated)
       ``topk_z`` call of the step made again and held to its plain
       version (these launches are not counted).

    Returns the path's launches by kernel, the gated ``topk_z``'s, and the
    held calls' max abs err by kernel record name."""
    import numpy as np

    from repro_torch.configs import ServingConfig
    from repro_torch.kernels import _build
    from repro_torch.models import Model
    from repro_torch.serve import (CorruptIndexFault, Engine,
                                   NanLogitsFault, Request, Scheduler,
                                   Server, StepFault, generate,
                                   poisson_arrivals, trace_arrivals)

    dev = torch.device("cuda")
    t_phase = time.time()
    path = {name: 0 for name in kernels}
    gated = [0]

    def counted(fn):
        torch.cuda.synchronize()
        _build.reset_counts(kernels.values())
        res = fn()
        torch.cuda.synchronize()
        counts = {name: kfn.launches for name, kfn in kernels.items()}
        for name in kernels:
            path[name] += counts[name]
        gated[0] += kernels["topk_z"].gated
        return res, counts, kernels["topk_z"].gated

    t0 = time.time()
    eng = Engine(Model(cfg), params, T_MAX_LEN, seed=7, device_index=True,
                 health_guard=True, device=dev)
    sched = Scheduler(eng, T_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3)
    torch.cuda.synchronize()
    kv_gb = sum(t.numel() * t.element_size()
                for t in sched.table.cache.values()) / 1e9
    log(f"traffic: engine and a {T_SLOTS}-lane table ({kv_gb:.3f} GB of KV, "
        f"max_len {T_MAX_LEN}) built in {time.time() - t0:.2f} s [{card}]")
    vocab = cfg.vocab
    gen = torch.Generator(device=dev).manual_seed(21)

    def prompt(n):
        return torch.randint(0, vocab, (n,), generator=gen,
                             device=dev).cpu().numpy()

    def serve(reqs, at=None, server_cfg=None, s=None, rate=None):
        s = sched if s is None else s
        server = Server(s, server_cfg)
        arrivals = (poisson_arrivals(reqs, rate, seed=0) if rate
                    else trace_arrivals(reqs, at or [0] * len(reqs)))
        torch.cuda.synchronize()
        t0 = time.time()
        rep = server.run(arrivals=arrivals)
        torch.cuda.synchronize()
        by_id = {c.request.req_id: c for c in rep.completions}
        return rep, [by_id.get(r.req_id) for r in reqs], time.time() - t0

    def copy(reqs):
        return [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        seed=r.seed, temperature=r.temperature)
                for r in reqs]

    # -- 1. parity ---------------------------------------------------------
    par = [Request(prompt=prompt(p), max_new_tokens=n, seed=100 + i,
                   temperature=t)
           for i, (p, n, t) in enumerate(T_PARITY)]
    (rep, got, secs), counts, _ = counted(
        lambda: serve(par, list(T_PARITY_AT)))
    check(all(c is not None and c.error is None and
              len(c.tokens) == r.max_new_tokens for r, c in zip(par, got)),
          "traffic parity: a request did not complete")
    check(sched.captures == 1, f"traffic parity: {sched.captures} captures")
    check(counts["ivf_decode"] == rep.steps, f"traffic parity: ivf_decode "
          f"launched {counts['ivf_decode']} times in {rep.steps} steps")
    alone = []
    for r in copy(par):
        _, (c,), _ = serve([r])
        alone.append(c.tokens)
    check(alone == [c.tokens for c in got], "traffic parity: a request's "
          "tokens in the busy table differ from its tokens alone in it")
    solo = []
    for r in par:
        out = generate(eng, torch.as_tensor(r.prompt[None], device=dev),
                       r.max_new_tokens, temperature=r.temperature,
                       generator=torch.Generator(device=dev).manual_seed(
                           r.seed))
        solo.append(out[0].tolist())
    same = [a == c.tokens for a, c in zip(solo, got)]
    if all(same):
        log(f"traffic parity: {len(par)} requests (prompts "
            f"{[p for p, _, _ in T_PARITY]}, staggered), tokens equal to "
            f"each alone in the table and to its solo captured generate "
            f"(batch 1), {rep.steps} steps, {secs:.2f} s [{card}]")
    else:
        batch1_vs_16(torch, eng, params, par, got, solo, same, card, serve)
    # -- 2. traffic --------------------------------------------------------
    lengths = (16, 32, 64, 128)
    reqs = [Request(prompt=prompt(lengths[i % 4]), max_new_tokens=T_NEW,
                    seed=1000 + i, temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(T_REQUESTS)]
    sched.shadow_every = 8
    sched.reset_metrics()
    caps = sched.captures
    (rep, got, secs), counts, n_gated = counted(
        lambda: serve(reqs, rate=T_RATE))
    check(all(c is not None and c.error is None and len(c.tokens) == T_NEW
              for c in got), "traffic: a request did not complete")
    check(sched.captures == caps, f"traffic: {sched.captures - caps} "
          f"captures after the warm-up run")
    check(counts["ivf_decode"] == rep.steps, f"traffic: ivf_decode "
          f"launched {counts['ivf_decode']} times in {rep.steps} steps")
    check(n_gated == 2 * rep.steps, f"traffic: the gated topk_z launched "
          f"{n_gated} times in {rep.steps} steps, want 2 a step")
    m = sched.harvest_metrics()
    ttft = [(c.first_token_time - c.admit_time) * 1e3 for c in got]
    step_ms = graph_step_ms(torch, sched, params, card)
    n_tok = sum(len(c.tokens) for c in got)
    log(f"traffic: {T_REQUESTS} requests (prompts 16/32/64/128, {T_NEW} new "
        f"tokens, half at T 0.8), Poisson {T_RATE}/step: {rep.summary()}; "
        f"{n_tok} tokens in {secs:.2f} s wall ({n_tok / secs:.1f} tokens/s "
        f"with set-up); first token after admission p50 "
        f"{statistics.median(ttft):.2f} ms, max {max(ttft):.2f} ms, queue "
        f"wait {rep.queue_wait_steps_mean:.2f} steps; a step's graph replay "
        f"{step_ms:.3f} ms device; shadow mimps rel err "
        f"{m['shadow_by_tier'].get('mimps')}; {counts['ivf_decode']} "
        f"ivf_decode and {n_gated} gated topk_z launches; captures "
        f"{sched.captures_by_tier} [{card}]")
    torch.cuda.synchronize()
    t0 = time.time()
    seq_tok = seq_steps = 0
    for r in reqs:
        out = generate(eng, torch.as_tensor(r.prompt[None], device=dev),
                       r.max_new_tokens, temperature=r.temperature,
                       generator=torch.Generator(device=dev).manual_seed(
                           r.seed))
        seq_tok += out.shape[1]
        seq_steps += len(r.prompt) + r.max_new_tokens - 1
    torch.cuda.synchronize()
    seq_s = time.time() - t0
    log(f"traffic, sequential captured generate over the same requests: "
        f"{seq_tok} tokens in {seq_s:.2f} s ({seq_tok / seq_s:.1f} tokens/s, "
        f"{seq_s / seq_steps * 1e3:.3f} ms a step over {seq_steps} steps); "
        f"the scheduler {rep.goodput_tok_s / (seq_tok / seq_s):.2f}x its "
        f"goodput [{card}]")
    # -- 3. overload -------------------------------------------------------
    over = [Request(prompt=prompt(lengths[i % 4]), max_new_tokens=T_NEW,
                    seed=3000 + i, temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(T_OVERLOAD)]
    ocfg = ServingConfig(max_queue=16, degrade_high=8, degrade_low=2,
                         default_deadline=400)
    (rep, got, secs), counts, _ = counted(
        lambda: serve(over, server_cfg=ocfg, rate=2 * T_RATE))
    tiers = [t for _, t in rep.tier_transitions]
    check(tiers[:1] == ["topk"] and tiers[-1:] == ["mimps"],
          f"overload: the ladder walked {rep.tier_transitions}")
    check(len(rep.completions) == T_OVERLOAD and all(c is not None
                                                     for c in got),
          f"overload: {len(rep.completions)} completions for {T_OVERLOAD} "
          f"submissions")
    check(all(c.reason for c in got if c.error is not None),
          "overload: a shed without its reason")
    check(sched.captures_by_tier == {"mimps": 1, "topk": 1},
          f"overload: captures {sched.captures_by_tier}")
    check(counts["union_scores"] > 0, "overload: the topk rung never "
          "launched union_scores")
    log(f"overload: {T_OVERLOAD} requests at {2 * T_RATE}/step, queue 16, "
        f"ladder 8/2: {rep.summary()}; tier path {rep.tier_transitions}; "
        f"tokens by tier {rep.tokens_by_tier}; launches ivf_decode "
        f"{counts['ivf_decode']}, union_scores {counts['union_scores']}; "
        f"captures {sched.captures_by_tier}; {secs:.2f} s [{card}]")
    # -- 4. faults ---------------------------------------------------------
    base_reqs = [Request(prompt=prompt(16 + 8 * i), max_new_tokens=12,
                         seed=5000 + i, temperature=0.0 if i % 2 else 0.7)
                 for i in range(6)]
    (_, base, _), _, _ = counted(lambda: serve(copy(base_reqs)))
    base = [c.tokens for c in base]
    caps = sched.captures
    victim = copy(base_reqs)
    sched.injector = NanLogitsFault([victim[2].req_id], steps=range(
        sched.steps_done + 1, sched.steps_done + 40))
    (rep, got, _), _, _ = counted(lambda: serve(victim))
    check(all(c.tokens == b for i, (c, b) in enumerate(zip(got, base))
              if i != 2), "faults: a NaN lane changed a neighbour's tokens")
    check(len(got[2].tokens) == 12 and rep.health["flagged"] > 0,
          f"faults: the NaN lane: {len(got[2].tokens)} tokens, health "
          f"{rep.health}")
    check(all(np.isfinite(c.log_zs).all() for c in got),
          "faults: a non-finite log Z was emitted")
    nan_health = rep.health
    sched.injector = StepFault([sched.steps_done + 2, sched.steps_done + 5])
    (rep, got, _), _, _ = counted(lambda: serve(copy(base_reqs)))
    check(rep.step_faults == 2 and [c.tokens for c in got] == base,
          f"faults: step faults {rep.step_faults}, tokens unchanged "
          f"{[c.tokens for c in got] == base}")
    at = (sched.steps_done // 4 + 2) * 4
    sched.injector = CorruptIndexFault(at_step=at, mode="permute", n_blocks=2)
    n_re = len(sched.recapture_log)
    (rep, got, _), counts, _ = counted(lambda: serve(
        copy(base_reqs), server_cfg=ServingConfig(verify_index_every=4)))
    sched.injector = None
    check(rep.index_restores == 1, f"faults: {rep.index_restores} restores")
    check([c.tokens for c in got] == base, "faults: tokens after the "
          "restore differ from the fault-free run's")
    check(len(sched.recapture_log) == n_re + 1 and
          sched.captures == caps + 1, f"faults: {sched.captures - caps} "
          f"captures for one restore")
    log(f"faults: NaN lane contained (neighbours bit-identical, health "
        f"{nan_health}); 2 step faults retried, tokens unchanged; permuted "
        f"index at step {at} restored by the digest every 4 steps, tokens "
        f"unchanged, one capture again in "
        f"{sched.recapture_log[-1][1] if sched.recapture_log else 0:.3f} "
        f"s (JAX recompiles nothing across a swap: its states are traced "
        f"arguments) [{card}]")
    # -- 5. prefix pool and speculation ------------------------------------
    shared = prompt(T_PREFIX)
    pre = [Request(prompt=np.concatenate([shared, prompt(1 + i % 4)]),
                   max_new_tokens=T_PREFIX_NEW, seed=7000 + i,
                   temperature=0.0 if i % 2 == 0 else 0.8)
           for i in range(T_PREFIX_REQ)]
    (rep, got, secs), _, _ = counted(lambda: serve(copy(pre)))
    want = [c.tokens for c in got]
    log(f"prefix/spec: plain, no pool: {rep.steps} steps, "
        f"{rep.goodput_tok_s:.1f} tokens/s, {secs:.2f} s [{card}]")
    for draft in (None, "topk", "fmbe"):
        kw = {} if draft is None else dict(spec_draft=draft,
                                           spec_k=T_SPEC_K)
        s = Scheduler(eng, T_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3,
                      prefix_cache_blocks=128, prefix_block_tokens=16, **kw)
        for wave in ("cold", "warm"):
            (rep, got, secs), counts, _ = counted(
                lambda: serve(copy(pre), s=s))
            label = f"prefix/spec {draft or 'plain'} {wave}"
            check([c.tokens for c in got] == want, f"{label}: tokens differ "
                  f"from the plain run without a pool")
            if draft == "topk":
                check(counts["union_scores"] > 0, f"{label}: the draft "
                      f"never launched union_scores")
            if draft == "fmbe":
                check(counts["fmbe_z"] > 0, f"{label}: the draft never "
                      f"launched fmbe_z")
            check(counts["ivf_decode"] == rep.steps, f"{label}: ivf_decode "
                  f"{counts['ivf_decode']} in {rep.steps} steps")
            log(f"{label}: {rep.steps} steps, {rep.goodput_tok_s:.1f} "
                f"tokens/s, step device {rep.step_device_ms_mean:.3f} ms + "
                f"host {rep.step_host_ms_mean:.3f} ms, prefix {rep.prefix}, "
                f"acceptance {rep.spec_acceptance:.3f} "
                f"({rep.spec_accepted}/{rep.spec_proposed}), draft-flagged "
                f"{rep.draft_flagged}, {secs:.2f} s [{card}]")
        check(s.captures == 1, f"prefix/spec {draft}: {s.captures} captures")
        del s
        torch.cuda.empty_cache()
    # -- 6. the step's kernels at the table's shapes -----------------------
    held = {}
    before = _build.snapshot()
    for draft in (None, "topk", "fmbe"):
        kw = {} if draft is None else dict(spec_draft=draft, spec_k=T_SPEC_K)
        s = Scheduler(eng, T_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3,
                      eager=True, **kw)
        busy = copy(reqs[:T_HELD_LANES])
        for i, r in enumerate(busy):
            s.admit(r)
            if i == T_HELD_LANES // 2 - 1:
                for _ in range(T_HELD_WARM):
                    s.step()
        for _ in range(T_HELD_WARM):
            s.step()
        tiers = ("mimps", "topk") if draft is None else ("mimps",)
        for tier in tiers:
            s.set_tier(tier)
            label = f"held {tier} step" if draft is None else \
                f"held {draft}-drafted verify"
            for name, err in held_step(torch, s, busy[1], label,
                                       card).items():
                held[name] = max(held.get(name, 0.0), err)
        s.drain()
        del s
        torch.cuda.empty_cache()
    _build.restore(before)
    for name in ("ivf_decode", "topk_z[gated]", "union_scores", "fmbe_z"):
        check(name in held, f"traffic: no {name} call was held to its plain "
              f"version at the table's shapes")
    path["topk_z"] -= gated[0]
    log(f"traffic path launches {path}, gated topk_z {gated[0]}; kernels "
        f"held to their plain versions at the table's shapes, max abs err "
        f"{held}; phase {time.time() - t_phase:.1f} s [{card}]")
    return path, gated[0], held


# the kernel wrappers a scheduler step calls, by the module that calls them
STEP_KERNEL_SITES = (("repro_torch.core.decode", "ivf_decode"),
                     ("repro_torch.core.decode", "union_scores"),
                     ("repro_torch.core.decode", "topk_z"),
                     ("repro_torch.core.backends", "topk_z"),
                     ("repro_torch.core.feature_maps", "fmbe_z"))


def held_step(torch, sched, victim, label, card):
    """One step of the eager scheduler ``sched`` on its busy table, with
    the kernel wrappers the step calls recording their arguments; a NaN
    fault on ``victim``'s lane (the guard's gated ``topk_z`` scores it) and
    the shadow oracle on (its gated ``topk_z`` scores every live lane).
    Then each recorded call is made again through its wrapper and held to
    its plain version on the same inputs: the hidden states, the tier's
    state and the plan (the live lanes' probe union) of that step, at
    Q = n_slots rows, or n_slots x spec_k in a speculative verify. Returns
    the max abs err by kernel record name."""
    import importlib

    from repro_torch.serve import NanLogitsFault
    calls, saved = [], []
    for mod_name, fn_name in STEP_KERNEL_SITES:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, fn_name)
        saved.append((mod, fn_name, real))

        def record(*args, _real=real, _name=fn_name, **kwargs):
            calls.append((_name, _real, args, kwargs))
            return _real(*args, **kwargs)
        setattr(mod, fn_name, record)
    sched.injector = NanLogitsFault([victim.req_id], [sched.steps_done])
    sched.shadow_every = 1
    try:
        rec = sched.step()
    finally:
        for mod, fn_name, real in saved:
            setattr(mod, fn_name, real)
        sched.injector = None
        sched.shadow_every = 0
    torch.cuda.synchronize()
    check(rec["health_flagged"] >= 1, f"{label}: the NaN lane was not "
          f"flagged ({rec['health_flagged']})")
    errs, notes = {}, []
    for name, real, args, kwargs in calls:
        key, err, note = hold_call(torch, f"{label} {name}", name, real,
                                   args, kwargs)
        errs[key] = max(errs.get(key, 0.0), err)
        notes.append(note)
    log(f"{label}: {rec['n_active']} of {sched.n_slots} lanes live, tier "
        f"{rec['tier']}; each kernel call of the step made again and held "
        f"to its plain version: " + "; ".join(notes) + f" [{card}]")
    return errs


def hold_call(torch, label, name, real, args, kwargs):
    """One recorded kernel call made again through its wrapper ``real`` and
    held to its plain version (the kernel phases' tolerances): (record
    name, max abs err, a note for the log)."""
    from repro_torch.kernels.fmbe import fmbe_phi_plain, fmbe_z_plain
    from repro_torch.kernels.ivf_score import (ivf_decode_plain,
                                              union_scores_plain)
    from repro_torch.kernels.topk_z import topk_z_plain
    if name == "ivf_decode":
        k = kwargs["k"]
        hl, tl, iv, ii = real(*args, k=k)
        p_hl, p_tl, p_v, p_i = ivf_decode_plain(*args, k=k + 1)
        err = max(compare_lse(f"{label} head_lse", hl, p_hl),
                  compare_lse(f"{label} tail_lse", tl, p_tl))
        err_v, n_ids = compare_topk(label, iv, ii, p_v, p_i)
        live, cap = int(args[3]), args[2].shape[0]
        return name, max(err, err_v), (
            f"ivf_decode Q {args[1].shape[0]} union {live} live of {cap} "
            f"slots, lse err {err:.2e}, top-k err {err_v:.2e} ({n_ids} ids)")
    if name == "union_scores":
        live = int(args[3])
        us = real(*args)
        p_us = union_scores_plain(*args)
        err = (us[:, :live] - p_us[:, :live]).abs().max().item()
        check(err <= TOL, f"{label}: live slots differ by {err}")
        check(bool((us[:, live:] == 0).all()), f"{label}: pad slots not 0")
        return name, err, (f"union_scores Q {us.shape[0]} union {live} live "
                           f"of {us.shape[1]} slots, err {err:.2e}")
    if name == "topk_z":
        h, w, k = args
        rows = kwargs.get("rows")
        lse, tv, ti = real(h, w, k, rows=rows)
        p_lse, p_v, p_i = topk_z_plain(h, w, k + 1, rows)
        err = compare_lse(f"{label} lse", lse, p_lse)
        err_v, n_ids = compare_topk(label, tv, ti, p_v, p_i)
        on = h.shape[0] if rows is None else int((rows != 0).sum())
        key = "topk_z" if rows is None else "topk_z[gated]"
        return key, max(err, err_v), (
            f"{key} Q {h.shape[0]} ({on} rows scored), lse err {err:.2e}, "
            f"top-k err {err_v:.2e} ({n_ids} ids)")
    omega, degree, coef, lam, x = args
    z = real(*args, **kwargs)
    terms = fmbe_phi_plain(omega, degree, coef, x) * lam
    err, ratio = compare_signed_sum(label, z, fmbe_z_plain(*args), terms)
    return name, err, (f"fmbe_z Q {x.shape[0]} lambda {tuple(lam.shape)}, "
                       f"err {err:.3e} = {ratio:.4f} of the tolerance")


def graph_step_ms(torch, sched, params, card):
    """Device milliseconds of one replay of the scheduler's captured step
    of its current tier, every lane idle (the step does every lane's work
    whatever its state): CUDA events over 20 replays. Then one replay
    under ``torch.profiler`` (kernels, time by kernel) and one eager
    16-lane trunk call at positions 0-150 by kind (``trunk_kinds``), beside
    the 8-lane ``generate`` step's of the serving phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = sched._graphs[sched.tier]
    ms = _median_events(torch, g.graph.replay, 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.graph.replay()
        torch.cuda.synchronize()
    sched.reset_metrics()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kern:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")[:50]
        k_ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (k_ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"traffic step profile (mimps, 16 lanes, one replay): {len(kern)} "
        f"kernels, {sum(v for v, _ in by_name.values()):.3f} ms of kernel "
        f"time; top: " + "; ".join(f"{n} {v:.3f} ms x{c}"
                                    for n, (v, c) in top) + f" [{card}]")
    eng = sched.engine
    dev = sched.device
    cache = eng.model.init_decode_state(sched.n_slots, eng.max_len, dev)
    toks = torch.zeros((sched.n_slots,), dtype=torch.long, device=dev)
    pos = torch.arange(0, 160, 10, dtype=torch.int32, device=dev)
    kinds, _ = trunk_kinds(torch, lambda: eng.model.decode_step(
        params, cache, toks, pos))
    del cache
    log(f"traffic trunk by kind (eager, 16 lanes, KV of {eng.max_len}): "
        f"{sum(v for v, _ in kinds.values()):.3f} ms in "
        f"{sum(n for _, n in kinds.values())} kernels; "
        + "; ".join(f"{k} {v:.3f} ms ({n})" for k, (v, n) in
                    sorted(kinds.items(), key=lambda kv: -kv[1][0]))
        + f" [{card}]")
    return ms


def batch1_vs_16(torch, eng, params, par, got, solo, same, card, serve):
    """Where a request's batch-1 ``generate`` differs from its lane of the
    16-lane table: log each request's first differing token, then feed the
    first such request's tokens (its prompt, then the table's samples)
    through the trunk at batch 1 and at batch 16 (the request in every
    lane) and log the first position whose hidden states differ and by how
    much (one GEMM shape against another). Then hold every request to
    ``generate`` at batch 16 with the request in every lane: a sampled
    request takes row 0 of the (16, sample_k) noise that generate draws a
    step, drawn again from a second generator seeded alike and injected
    through ``Request.gumbel``; the six run staggered in the table again
    (``serve``, as in the parity run) and each must give row 0 of
    generate's tokens."""
    from repro_torch.serve import Request, generate
    from repro_torch.serve.engine import _draw_gumbel
    dev = torch.device("cuda")
    first = [next((i for i, (a, b) in enumerate(zip(s, c.tokens))
                   if a != b), None) for s, c in zip(solo, got)]
    i = same.index(False)
    seq = list(par[i].prompt) + got[i].tokens[:-1]
    c1 = eng.model.init_decode_state(1, T_MAX_LEN, dev)
    c16 = eng.model.init_decode_state(T_SLOTS, T_MAX_LEN, dev)
    where, diff = None, 0.0
    with torch.inference_mode():
        for pos, t in enumerate(seq):
            tok = torch.tensor([int(t)], device=dev)
            h1 = eng.model.decode_step(params, c1, tok, pos)
            h16 = eng.model.decode_step(params, c16, tok.expand(T_SLOTS),
                                        pos)
            diff = (h1.float() - h16[:1].float()).abs().max().item()
            if diff > 0:
                where = pos
                break
    del c1, c16
    log(f"traffic parity: batch-1 generate differs from the table for "
        f"{same.count(False)} of {len(same)} requests (first differing "
        f"token {first}; each equals itself alone in the table); request "
        f"{i}'s tokens through the trunk at batch 1 and batch 16: the "
        f"hidden states first differ at position {where} (of "
        f"{len(seq)}), by {diff:.3e} [{card}]")
    k = eng.cfg.partition.sample_k
    injected, want = [], []
    for r in par:
        total = len(r.prompt) + r.max_new_tokens - 1
        gumbel = None
        if r.temperature > 0:
            g2 = torch.Generator(device=dev).manual_seed(r.seed)
            gumbel = torch.stack([_draw_gumbel((T_SLOTS, k), g2, dev)[0]
                                  for _ in range(total)]).cpu().numpy()
        injected.append(Request(prompt=r.prompt,
                                max_new_tokens=r.max_new_tokens,
                                temperature=r.temperature, gumbel=gumbel))
        out = generate(eng, torch.as_tensor(r.prompt[None], device=dev)
                       .expand(T_SLOTS, -1), r.max_new_tokens,
                       temperature=r.temperature,
                       generator=torch.Generator(device=dev).manual_seed(
                           r.seed))
        want.append(out[0].tolist())
    _, got16, _ = serve(injected, list(T_PARITY_AT))
    for r, c, w in zip(par, got16, want):
        check(c is not None and c.tokens == w, f"traffic parity: a request "
              f"at T {r.temperature} differs from generate at batch 16 "
              f"too (row 0's noise injected)")
    log(f"traffic parity: every request, greedy and sampled (row 0 of "
        f"generate's batch-16 noise injected), staggered in the table, "
        f"equals generate at batch 16 [{card}]")


LAYER_METHODS = ("exact", "mimps", "nmimps", "uniform", "mince", "fmbe",
                 "selfnorm")
# the kernels each method's PartitionLayer path must launch (the build's
# included): log_z, then top_candidates (topk_z, or ivf_score with an index)
LAYER_KERNELS = {"exact": ("topk_z",), "mimps": ("ivf_score",),
                 "fmbe": ("fmbe_phi", "fmbe_z", "topk_z")}
LAYER_K = 8                    # top_candidates' k
STUDY_KERNELS = ("topk_z", "fmbe_phi", "fmbe_z")
T4_KERNELS = ("topk_z", "ivf_score")
# the padded and unpadded plain Table 4 paths sum the same f32 products
# (zeros added): log Z equal to a few f32 ulps of |log Z| < 20
T4_PAD_TOL = 1e-5


def estimators(torch, card, kernels, params, cfg, h):
    """Phase 5c: the paper's estimators on the serving phase's bf16
    parameters. ``PartitionLayer`` at full width (qwen1.5-4b's lm_head, the
    serving phase's 8 hidden states) for each method of LAYER_METHODS, with
    the kernels against ``use_kernel=False`` on the same injected draws:
    log Ẑ within 1e-3, ``top_candidates`` (k 8) with ids equal wherever the
    neighbouring scores are more than 1e-3 apart, two calls bit-equal,
    mimps within 0.05 of exact; MINCE also with the paper's weighting (the
    oracle path, no kernel). Each method's build and first ``log_z`` +
    ``top_candidates`` run from launch counts of 0: each kernel of
    LAYER_KERNELS must launch. Logs build seconds and log_z ms (wall, a
    synchronise, 8 queries) of both paths. Then the four studies of
    ``repro_torch.studies.paper_tables`` at the JAX scripts' sizes (f32
    data: ``topk_z``, ``fmbe_phi`` and ``fmbe_z`` must launch, at f32
    only), their tables printed, every ordering of ``ORDERINGS`` required.
    Returns the layer path's and the studies' launches by kernel."""
    from repro_torch.core import estimators as est
    from repro_torch.core.feature_maps import apply_feature_map, fmbe_z_batch
    from repro_torch.core.partition_layer import PartitionLayer
    from repro_torch.kernels import _build
    from repro_torch.studies import paper_tables as pt
    from repro_torch.studies import table4_lbl as t4lbl

    t_phase = time.time()
    dev = h.device
    pc = cfg.partition
    w = params["lm_head"]
    v_rows, q = w.shape[0], h.shape[0]
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = torch.randint(0, v_rows, (q, pc.l), generator=gen, device=dev)
    ranks = torch.randint(0, v_rows - pc.k, (q, pc.l), generator=gen,
                          device=dev)
    draws = {"mimps": rows, "uniform": rows, "mince": ranks}
    path = {name: 0 for name in kernels}

    def reset():
        torch.cuda.synchronize()
        _build.reset_counts(kernels.values())

    def read():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in kernels.items()}

    lz = {}
    for method in LAYER_METHODS:
        lcfg = dataclasses.replace(pc, method=method)
        reset()
        t0 = time.time()
        layer = PartitionLayer.build(
            lcfg, w, torch.Generator(device=dev).manual_seed(7), device=dev)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        built = read()
        reset()
        got = layer.log_z(w, h, draws=draws.get(method))
        tv, ti = layer.top_candidates(w, h, LAYER_K)
        counts = read()
        for name in kernels:
            path[name] += built[name] + counts[name]
        for name in LAYER_KERNELS.get(method, ("topk_z",)):
            check(built[name] + counts[name] > 0, f"estimators {method}: "
                  f"the PartitionLayer path launched no {name}")
        plain = layer.log_z(w, h, draws=draws.get(method), use_kernel=False)
        check(got.shape == (q,) and bool(torch.isfinite(got).all()),
              f"estimators {method}: log_z {got}")
        err = (got - plain).abs().max().item()
        check(err <= TOL, f"estimators {method}: log_z with the kernels off "
              f"the plain path by {err}")
        check(torch.equal(got, layer.log_z(w, h, draws=draws.get(method))),
              f"estimators {method}: two log_z calls differ")
        pv, pi = layer.top_candidates(w, h, LAYER_K + 1, use_kernel=False)
        _, n_ids = compare_topk(f"estimators {method} top_candidates", tv, ti,
                                pv, pi)
        tv2, ti2 = layer.top_candidates(w, h, LAYER_K)
        check(torch.equal(tv, tv2) and torch.equal(ti, ti2),
              f"estimators {method}: two top_candidates calls differ")
        extra = ""
        if method == "fmbe":        # the signed sums beside their cancellation
            st = layer.fmbe_state
            terms = apply_feature_map(st.fm, h) * st.lambda_tilde
            zk = fmbe_z_batch(st, h, True)
            zp = fmbe_z_batch(st, h, False)
            _, ratio = compare_signed_sum("estimators fmbe z", zk, zp, terms)
            extra = (f"; signed z {[f'{x:.4e}' for x in zp.tolist()]}, sum "
                     f"|terms| {terms.abs().sum(-1).max().item():.4e}, z error "
                     f"{ratio:.3f} of its limit")
        ms = wall_ms(torch, lambda: layer.log_z(w, h, draws=draws.get(method)))
        plain_ms = wall_ms(torch, lambda: layer.log_z(
            w, h, draws=draws.get(method), use_kernel=False))
        lz[method] = got
        log(f"estimators {method}: build {build_s:.3f} s (index "
            f"{layer.index is not None}, fmbe sketch "
            f"{layer.fmbe_state is not None}); log_z for {q} queries "
            f"{ms:.3f} ms wall, plain {plain_ms:.3f} ms; |kernels - plain| "
            f"{err:.3e}; top_candidates k {LAYER_K}: {n_ids} ids checked; "
            f"launches build {({n: c for n, c in built.items() if c})} "
            f"log_z + top_candidates {({n: c for n, c in counts.items() if c})}"
            f"{extra} [{card}]")
        del layer
    gap = (lz["mimps"] - lz["exact"]).abs().max().item()
    check(gap < 0.05, f"estimators: mimps log_z off exact by {gap}")
    paper = est.mince_log_z(w, h, pc.k, pc.l, weighting="paper",
                            tail_pos=ranks)
    check(bool(torch.isfinite(paper).all()) and torch.equal(
        paper, est.mince_log_z(w, h, pc.k, pc.l, weighting="paper",
                               tail_pos=ranks)),
          "estimators: mince (paper weighting) not finite or not "
          "bit-equal over two calls")
    log("estimators: log Z - exact per method (max abs): "
        + ", ".join(f"{m} {(x - lz['exact']).abs().max().item():.4e}"
                    for m, x in lz.items())
        + f", mince paper weighting "
        f"{(paper - lz['exact']).abs().max().item():.4e} [{card}]")

    # -- the paper's tables at the JAX scripts' sizes --------------------------
    reset()
    t0 = time.time()
    res = pt.run(device=dev)
    study_s = time.time() - t0
    study = {name: dict(fn.by_variant) for name, fn in kernels.items()}
    for name in STUDY_KERNELS:
        check(study[name]["f32"] > 0 and study[name]["bf16"] == 0,
              f"studies: {name} launched {study[name]}, want f32 only")
    log(pt.format_tables(res))
    for name in ("fig1", "table1", "table2", "table3"):
        log(f"study {name}: {res[name]['seconds']:.3f} s wall [{card}]")
    orderings = pt.check_orderings(res)
    for name, ok in orderings.items():
        log(f"ordering {'holds' if ok else 'BROKEN'}: {name}")
    check(all(orderings.values()), f"studies: broken orderings "
          f"{[n for n, ok in orderings.items() if not ok]}")

    # -- the paper's Table 4 at the JAX script's full size ---------------------
    reset()
    t0 = time.time()
    t4 = t4lbl.run(device=dev)
    t4_s = time.time() - t0
    t4_counts = {name: dict(fn.by_variant) for name, fn in kernels.items()}
    for name in T4_KERNELS:
        check(t4_counts[name]["f32"] > 0 and t4_counts[name]["bf16"] == 0,
              f"table4: {name} launched {t4_counts[name]}, want f32 only")
    for name, c in t4_counts.items():
        study[name]["f32"] += c["f32"]
    log(t4lbl.format_table(t4))
    check(all(math.isfinite(r["abse_mips"]) for r in t4["rows"]),
          f"table4: {t4['rows']}")
    check(t4["kernel_max_abs_err"] <= TOL, f"table4: the kernels off "
          f"use_kernel=False by {t4['kernel_max_abs_err']}")
    check(t4["pad_max_abs_diff"] <= T4_PAD_TOL, f"table4: the padded plain "
          f"path off the unpadded one by {t4['pad_max_abs_diff']}")
    check(t4lbl.mimps_beats_z1(t4), "table4: MIMPS does not beat Z = 1 "
          "(the JAX package's own run shows it at every pair)")
    log(f"table4: V {t4['sizes']['vocab']} d {t4['sizes']['d']} + 1 padded "
        f"to {t4['sizes']['padded_d']}, {t4['sizes']['n_blocks']} blocks of "
        f"{t4['sizes']['block_rows']}, {t4['sizes']['steps']} NCE steps of "
        f"batch {t4['sizes']['batch']} in {t4['train_seconds']:.3f} s "
        f"({t4['train_us_per_step']:.1f} us/step), {t4['sizes']['n_test']} "
        f"held-out contexts; kernels (topk_z, ivf_score) vs plain max |d log "
        f"Z| {t4['kernel_max_abs_err']:.3e}; padded vs unpadded plain "
        f"{t4['pad_max_abs_diff']:.3e} (bit-equal {t4['pad_bit_equal']}); "
        f"MIMPS beats Z = 1 at every pair; launches "
        f"{ {n: c['f32'] for n, c in t4_counts.items() if c['f32']} }; "
        f"{t4_s:.1f} s [{card}]")
    log(f"estimators phase: {time.time() - t_phase:.1f} s (the four studies "
        f"{study_s:.1f} s, Table 4 {t4_s:.1f} s), study launches "
        f"{ {n: c['f32'] for n, c in study.items() if c['f32']} } [{card}]")
    return path, {name: c["f32"] for name, c in study.items()}


def lifecycle(torch, card, kernels, params, cfg, floor):
    """Phase 6: the fixed-capacity index lifecycle at full width (bf16),
    with its hard checks. A mimps engine with ``device_index=True`` and
    ``health_guard=True`` serves 8 requests (prompt 16, 16 new tokens): its
    tokens and log Z must equal the unguarded run's bit for bit. With NaN
    rows installed in its index every query of every step must be flagged
    and the tokens and log Z must be the exact engine's. ``swap_index`` to a
    new head (the old one plus seeded noise; trunk shared) must keep every
    state shape and serve a fresh ``device_index`` engine's tokens on the
    new params. Two live blocks swapped must be caught by
    ``verify_and_restore``, the restored tensors and the tokens after it
    equal to the clean ones bit for bit. ``shadow_exact_log_z`` must equal
    the exact tier's log Z bit for bit. Then topk, mince and fmbe serve
    through ``tier_state`` on the shared index. Every run goes through the
    captured ``generate`` and then the host loop (which records the guard's
    flags), bit-equal, each reseeding the engine's decode generator (the
    same tail draws); the runs after the swap and after the restore must
    each capture afresh. Each captured run of the path starts with the
    launch counts at 0. Times the build, swap, restore and
    digest, the gated ``topk_z`` with no query and with every query
    flagged, and a guarded against an unguarded output layer (CUDA graph
    replay, which also shows the guard makes no host read). Returns the
    gated ``topk_z`` record and the path's launches by kernel."""
    from repro_torch.core import mips
    from repro_torch.core.backends import shadow_exact_log_z
    from repro_torch.core.decode import apply_health_guard
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk_z import NEG, topk_z, topk_z_plain
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    from repro_torch.serve import engine as engine_mod

    dev = torch.device("cuda")
    pc = cfg.partition
    k = pc.sample_k
    max_len = PROMPT + NEW
    seed = 5
    gen = torch.Generator(device=dev).manual_seed(4)
    prompt = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen,
                           device=dev)
    w = params["lm_head"]
    path = {name: 0 for name in kernels}
    path_gated = [0]

    def counted(fn):
        """``fn()`` as a part of the path: its launches are the path's."""
        torch.cuda.synchronize()
        _build.reset_counts(kernels.values())
        res = fn()
        torch.cuda.synchronize()
        for name, kfn in kernels.items():
            path[name] += kfn.launches
        path_gated[0] += kernels["topk_z"].gated
        return res

    flags_log = []
    real_guard = engine_mod.apply_health_guard

    def recording_guard(*args, **kwargs):
        out, flags = real_guard(*args, **kwargs)
        flags_log.append(flags)
        return out, flags

    def serve_run(eng, label, *, on_path=True, tier=None):
        """``generate`` through the captured step (the path, when
        ``on_path``), then the host loop, bit-equal; the host loop records
        the guard's flags of every step."""
        captures = eng.captures
        (out, aux, secs), (_, _, host_secs) = served_pair(
            torch, eng, prompt, NEW, f"lifecycle {label}", tier=tier,
            seed=seed, wrap=counted if on_path else None,
            host_first=flags_log.clear)
        check(out.shape == (N_REQ, NEW), f"lifecycle {label}: tokens "
              f"{out.shape}")
        check(bool(torch.isfinite(aux["log_z"]).all()),
              f"lifecycle {label}: log_z not finite")
        flagged = [int((f > 0).sum()) for f in flags_log]
        if eng.health_guard:
            check(len(flagged) == PROMPT + NEW - 1, f"lifecycle {label}: "
                  f"{len(flagged)} guarded steps recorded")
        log(f"lifecycle {label}: captured {N_REQ * NEW / secs:.1f} new "
            f"tokens/s, host loop {N_REQ * NEW / host_secs:.1f}, bit-equal, "
            f"{eng.captures - captures} captures, flagged queries per step "
            f"{flagged if any(flagged) else 0} [{card}]")
        return out, aux, flagged, eng.captures - captures

    engine_mod.apply_health_guard = recording_guard
    try:
        # -- the fixed-capacity build, alone and in the engine ----------------
        v, d = w.shape
        nb = mips.ivf_capacity_blocks(v, pc.block_rows, pc.n_clusters)
        torch.cuda.synchronize()
        t0 = time.time()
        alone = mips.build_ivf_device(
            w, block_rows=pc.block_rows, n_clusters=pc.n_clusters,
            generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        build_s = time.time() - t0
        live = int(alone.valid.any(-1).sum())
        del alone
        t0 = time.time()
        eng = Engine(Model(cfg), params, max_len, seed=seed,
                     device_index=True, health_guard=True)
        torch.cuda.synchronize()
        engine_s = time.time() - t0
        idx = eng.index
        check(idx.n_blocks == nb, f"capacity index has {idx.n_blocks} "
              f"blocks, want {nb}")
        check(int(idx.valid.any(-1).sum()) == live, "the engine's build "
              "differs from build_ivf_device's")
        log(f"lifecycle: build_ivf_device {nb} blocks ({live} live) of "
            f"{pc.block_rows} rows, {idx.v_blocks.numel() * 2 / 1e9:.3f} GB, "
            f"{build_s:.3f} s; engine build {engine_s:.3f} s; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")

        # -- guarded healthy run against the unguarded one ---------------------
        toks, aux, flagged, _ = serve_run(eng, "mimps guarded")
        check(not any(flagged), f"a healthy run flagged {flagged}")
        eng.health_guard = False
        u_toks, u_aux, _, _ = serve_run(eng, "mimps unguarded",
                                        on_path=False)
        eng.health_guard = True
        for name in ("log_z", "log_prob"):
            check(torch.equal(aux[name], u_aux[name]),
                  f"guarded {name} differs from the unguarded run's")
        check(torch.equal(toks, u_toks), "guarded tokens differ from the "
              "unguarded run's")

        # -- a poisoned index: every step flagged, the exact engine's tokens --
        clean = eng.state
        poisoned = idx._replace(v_blocks=torch.full_like(idx.v_blocks,
                                                         float("nan")))
        eng._install_state(dataclasses.replace(clean, index=poisoned))
        p_toks, p_aux, flagged, _ = serve_run(eng, "mimps poisoned index")
        check(len(flagged) == PROMPT + NEW - 1 and
              all(f == N_REQ for f in flagged),
              f"poisoned run flagged {flagged} queries per step, want every "
              f"query of every step")
        eng._install_state(clean)
        del poisoned
        exact = Engine(Model(dataclasses.replace(
            cfg, partition=dataclasses.replace(pc, method="exact"))),
            params, max_len, seed=seed)
        e_toks, e_aux, _, _ = serve_run(exact, "exact", on_path=False)
        check(torch.equal(p_toks, e_toks), "poisoned guarded tokens differ "
              "from the exact engine's")
        check(torch.equal(p_aux["log_z"], e_aux["log_z"]), "poisoned guarded "
              "log_z differs from the exact engine's")

        # -- the shadow oracle against the exact tier --------------------------
        cache = exact.model.init_decode_state(N_REQ, max_len, dev)
        h = exact.model.decode_step(params, cache, prompt[:, 0], 0)
        shadow = counted(lambda: shadow_exact_log_z(eng.state, h, k=k))
        ex_out = exact.backend.decode(exact.state, h, pc, k=k)
        check(torch.equal(shadow, ex_out.log_z), "shadow_exact_log_z differs "
              "from the exact tier's log_z")

        # -- output layer, guarded against unguarded (graph replay) -----------
        tail_idx = torch.randint(0, v, (pc.l,), generator=gen, device=dev)

        def unguarded_out():
            return eng.backend.decode(eng.state, h, pc, k=k,
                                      tail_idx=tail_idx)

        def guarded_out():
            return real_guard(unguarded_out(), eng.state.w, h, k)

        g_out, g_flags = guarded_out()
        check(not g_flags.any(), "the timed step is not healthy")
        for a, b in zip(g_out[:6], unguarded_out()[:6]):
            check(torch.equal(a, b), "guarded step differs from unguarded")
        ms_u, ms_g = time_ms(torch, unguarded_out), time_ms(torch,
                                                            guarded_out)
        log(f"lifecycle: mimps output layer device time, unguarded "
            f"{ms_u:.4f} ms, guarded {ms_g:.4f} ms (+{ms_g - ms_u:.4f}; "
            f"both captured in a CUDA graph) [{card}]")

        # -- swap to a new head ------------------------------------------------
        noise = torch.randn(w.shape, generator=gen, device=dev,
                            dtype=w.dtype)
        new_params = dict(params, lm_head=w + 0.005 * noise)
        del noise
        before = engine_mod._shapes(eng.state)
        torch.cuda.synchronize()
        t0 = time.time()
        eng.swap_index(new_params)
        torch.cuda.synchronize()
        swap_s = time.time() - t0
        check(engine_mod._shapes(eng.state) == before,
              "swap_index changed a state shape")
        s_toks, s_aux, _, s_caps = serve_run(eng, "mimps after swap")
        check(s_caps == 1, f"the run after swap_index captured {s_caps} "
              f"times, want once afresh")
        fresh = Engine(Model(cfg), new_params, max_len, seed=seed,
                       device_index=True, health_guard=True)
        for a, b in zip(fresh.index, eng.index):
            check(a == b if isinstance(a, int) else torch.equal(a, b),
                  "the swapped index differs from a fresh build's")
        f_toks, f_aux, _, _ = serve_run(fresh, "fresh engine on the new head",
                                     on_path=False)
        del fresh
        check(torch.equal(s_toks, f_toks), "swapped tokens differ from a "
              "fresh engine's")
        check(torch.equal(s_aux["log_z"], f_aux["log_z"]), "swapped log_z "
              "differs from a fresh engine's")
        changed = (s_toks != toks).float().mean().item()

        # -- a two-block permutation, verify and restore -----------------------
        idx = eng.index
        clean_t = [t.clone() for t in idx if isinstance(t, torch.Tensor)]
        live_ids = torch.nonzero(idx.valid.any(-1))[:, 0].tolist()
        a_blk, b_blk = live_ids[0], live_ids[1]
        vb = idx.v_blocks.clone()
        vb[[a_blk, b_blk]] = vb[[b_blk, a_blk]]
        eng._install_state(dataclasses.replace(
            eng.state, index=idx._replace(v_blocks=vb)))
        del vb, idx
        torch.cuda.synchronize()
        t0 = time.time()
        restored = eng.verify_and_restore()
        torch.cuda.synchronize()
        verify_s = time.time() - t0
        check(restored, "verify_and_restore missed a two-block permutation")
        for a, b in zip((t for t in eng.index
                         if isinstance(t, torch.Tensor)), clean_t):
            check(torch.equal(a, b), "the restored index differs from the "
                  "clean one")
        del clean_t
        r_toks, r_aux, _, r_caps = serve_run(eng, "mimps after restore")
        check(r_caps == 1, f"the run after the restore captured {r_caps} "
              f"times, want once afresh")
        check(torch.equal(r_toks, s_toks) and
              torch.equal(r_aux["log_z"], s_aux["log_z"]),
              "tokens after the restore differ from the fault-free run's")
        check(not eng.verify_and_restore(), "a clean index failed its digest")
        t0 = time.time()
        dig = engine_mod._digest(eng.index.v_blocks)
        digest_s = time.time() - t0
        check(engine_mod._digest(eng.index.v_blocks) == dig,
              "the digest differs between two calls")
        torch.cuda.synchronize()
        t0 = time.time()
        eng.restore_index()
        torch.cuda.synchronize()
        restore_s = time.time() - t0
        log(f"lifecycle: swap_index {swap_s:.3f} s ({changed:.4f} of the "
            f"greedy tokens changed), verify_and_restore on a two-block "
            f"permutation of blocks {a_blk} and {b_blk} {verify_s:.3f} s, "
            f"restore_index {restore_s:.3f} s, digest {digest_s * 1e3:.2f} "
            f"ms ({dig[0]!r}, {dig[1]!r}), {eng.index_restores} restores "
            f"[{card}]")

        # -- degradation tiers on the shared index -----------------------------
        for tier in ("topk", "mince", "fmbe"):
            t0 = time.time()
            st = counted(lambda: eng.tier_state(tier))
            tier_s = time.time() - t0
            check(st.index is eng.index, f"the {tier} tier does not share "
                  f"the engine's index")
            log(f"lifecycle: {tier} tier state {tier_s:.3f} s")
            serve_run(eng, f"tier {tier}", tier=tier)
    finally:
        engine_mod.apply_health_guard = real_guard

    for name in ("ivf_decode", "union_scores", "fmbe_phi", "fmbe_z",
                 "topk_z"):
        check(path[name] > 0, f"lifecycle: the path never launched {name}")
    check(path_gated[0] > 0, "lifecycle: the guard never launched the "
          "gated topk_z")
    path["topk_z"] -= path_gated[0]            # the gated ones: their record
    log(f"lifecycle path launches {path}, gated topk_z {path_gated[0]}")

    # -- the gated topk_z against the ungated kernel and the plain version ---
    i32 = dict(dtype=torch.int32, device=dev)
    none, every = torch.zeros(N_REQ, **i32), torch.ones(N_REQ, **i32)
    full = topk_z(h, w, k)
    on = topk_z(h, w, k, rows=every)
    off = topk_z(h, w, k, rows=none)
    torch.cuda.synchronize()
    for a, b in zip(on, full):
        check(torch.equal(a, b), "gated topk_z with every query flagged "
              "differs from the ungated kernel's bits")
    check(bool(torch.isneginf(off[0]).all() and (off[1] == NEG).all()
               and not off[2].any()), "gated topk_z with no query flagged "
          "did not write the filler")
    p_lse, p_v, p_i = topk_z_plain(h, w, k + 1)
    err = compare_lse("topk_z[gated] lse", on[0], p_lse)
    err_v, _ = compare_topk("topk_z[gated]", on[1], on[2], p_v, p_i)
    q = N_REQ
    out_bytes = q * 4 + q * 4 + q * k * 8       # rows read; lse, top-k out
    g_bound, g_by = bound_ms(out_bytes, 0)
    rec = dict(name="topk_z[gated]", route="cuda",
               source="src/repro_torch/kernels/csrc/topk_z.cu",
               replaces="src/repro/kernels/topk_z.py:82",
               launches=path_gated[0], max_abs_err=max(err, err_v),
               ms=time_ms(torch, lambda: topk_z(h, w, k, rows=none)),
               plain_ms=time_ms(torch, lambda: topk_z_plain(h, w, k, none)),
               bound_ms=g_bound, bound_by=g_by, library_ms=None,
               graph10_ms=graph10_ms(torch,
                                     lambda: topk_z(h, w, k, rows=none)),
               floor_ms=floor,
               all_flagged_ms=time_ms(torch,
                                      lambda: topk_z(h, w, k, rows=every)),
               ungated_ms=time_ms(torch, lambda: topk_z(h, w, k)))
    log(f"topk_z[gated]: Q {q} k {k}: no query flagged {rec['ms']:.4f} ms "
        f"(ten {rec['graph10_ms']:.4f}; graph floor {floor:.4f}, bound "
        f"{g_bound:.6f} ms for {out_bytes} B); every query flagged "
        f"{rec['all_flagged_ms']:.4f} ms against ungated "
        f"{rec['ungated_ms']:.4f} ms (bit-equal); lse err {err:.2e} "
        f"[{card}]")
    return rec, path


def topk_z_phase(torch, card, h, w, k, tag=""):
    """``topk_z`` against its plain version on hidden states h and the head
    w (both bf16 or both f32); times it beside its byte bound, the plain
    version and a library call. Returns the record, named with ``tag``."""
    from repro_torch.kernels.topk_z import topk_z, topk_z_plain
    q, d, v = h.shape[0], h.shape[1], w.shape[0]
    es = h.element_size()
    lse, tv, ti = topk_z(h, w, k)
    torch.cuda.synchronize()
    p_lse, p_v, p_i = topk_z_plain(h, w, k + 1)
    err = compare_lse(f"topk_z{tag} lse", lse, p_lse)
    err_v, n_ids = compare_topk(f"topk_z{tag}", tv, ti, p_v, p_i)
    tz_bytes = v * d * es + q * d * es + q * 4 + q * k * 8
    tz_bound, tz_by = bound_ms(tz_bytes, 2 * q * v * d)

    def library_topk_z():
        logits = torch.matmul(h, w.T)
        return torch.logsumexp(logits.float(), -1), torch.topk(logits, k)

    tz = dict(name=f"topk_z{tag}", route="cuda",
              source="src/repro_torch/kernels/csrc/topk_z.cu",
              replaces="src/repro/kernels/topk_z.py:82",
              max_abs_err=max(err, err_v),
              ms=time_ms(torch, lambda: topk_z(h, w, k)),
              plain_ms=time_ms(torch, lambda: topk_z_plain(h, w, k)),
              bound_ms=tz_bound, bound_by=tz_by,
              library_ms=time_ms(torch, library_topk_z),
              graph10_ms=graph10_ms(torch, lambda: topk_z(h, w, k)))
    tz_eager = eager_ms(torch, lambda: topk_z(h, w, k))
    log(f"topk_z{tag}: Q {q} V {v} d {d} k {k} {h.dtype}: lse err "
        f"{err:.2e}, top-k err {err_v:.2e}, {n_ids} ids checked; kernel "
        f"{tz['ms']:.4f} ms (eager call {tz_eager:.4f} ms), plain "
        f"{tz['plain_ms']:.4f} ms, library {tz['library_ms']:.4f} ms, bound "
        f"{tz_bound:.4f} ms ({tz_by}, {tz_bytes / 1e6:.1f} MB) [{card}]")
    return tz


def ivf_decode_phase(torch, card, index, h, plan, pc, k, tag=""):
    """``ivf_decode`` against its plain version on the mimps plan of h, two
    calls bit-equal; times it as one call, as ten calls in one graph and
    with the L2 cache flushed before each call, beside its byte bound, the
    plain version and a composed library yardstick (``einsum`` over the
    gathered union blocks and the tail rows, masked ``logsumexp``,
    ``topk``). Returns the record, named with ``tag``."""
    from repro_torch.core.decode import _tail_rows
    from repro_torch.kernels.ivf_score import ivf_decode, ivf_decode_plain
    q, d = h.shape
    es = h.element_size()
    row_logw = torch.where(index.valid, 0.0, -1e30).float()
    tail_rows = _tail_rows(index, plan)
    args = (index.v_blocks, h, plan.head_ids, plan.head_live,
            plan.head_member, row_logw, tail_rows, plan.tail_accept)
    out = ivf_decode(*args, k=k)
    again = ivf_decode(*args, k=k)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f"ivf_decode{tag}: two calls differ in their bits")
    hl, tl, iv, ii = out
    p_hl, p_tl, p_v, p_i = ivf_decode_plain(*args, k=k + 1)
    err = max(compare_lse(f"ivf_decode{tag} head_lse", hl, p_hl),
              compare_lse(f"ivf_decode{tag} tail_lse", tl, p_tl))
    err_v, n_ids = compare_topk(f"ivf_decode{tag}", iv, ii, p_v, p_i)
    live, cap = int(plan.head_live), plan.head_ids.shape[0]
    br, l = index.block_rows, pc.l
    iv_bytes = (live * br * d * es + l * d * es + q * d * es + cap * 4
                + q * cap + live * br * 4 + q * l + q * (8 + 8 * k))
    iv_bound, iv_by = bound_ms(iv_bytes, 2 * q * (live * br + l) * d)
    ids = plan.head_ids.long()
    keep = (plan.head_member & (torch.arange(cap, device=h.device)
                                < plan.head_live)[None, :])[:, :, None]

    def library_ivf_decode():
        s = torch.einsum("qd,ubd->qub", h, index.v_blocks[ids]).float()
        eff = torch.where(keep, s + row_logw[ids][None],
                          torch.full_like(s, -1e30)).reshape(q, -1)
        ts = torch.matmul(h, tail_rows.T).float()
        return (torch.logsumexp(eff, -1), torch.topk(eff, k),
                torch.logsumexp(torch.where(plan.tail_accept, ts,
                                            torch.full_like(ts, -1e30)), -1))

    call = lambda: ivf_decode(*args, k=k)                   # noqa: E731
    ivf = dict(name=f"ivf_decode{tag}", route="cuda",
               source="src/repro_torch/kernels/csrc/ivf_decode.cu",
               replaces="src/repro/kernels/ivf_score.py:226",
               max_abs_err=max(err, err_v),
               ms=time_ms(torch, call),
               plain_ms=time_ms(torch, lambda: ivf_decode_plain(*args, k=k)),
               bound_ms=iv_bound, bound_by=iv_by,
               library_ms=time_ms(torch, library_ivf_decode),
               library_call="einsum over w_blocks[head_ids] and the tail "
               "rows, masked logsumexp, topk",
               graph10_ms=graph10_ms(torch, call),
               l2_flushed_ms=flushed_ms(torch, call),
               by_kernel_ms=kernel_split(torch, call))
    iv_eager = eager_ms(torch, call)
    log(f"ivf_decode{tag}: Q {q} union {live} live of {cap} slots x {br} "
        f"rows, l {l}, {h.dtype}: lse err {err:.2e}, top-k err "
        f"{err_v:.2e}, {n_ids} ids checked, two calls bit-equal; kernel "
        f"{ivf['ms']:.4f} ms ({share(iv_bound, ivf['ms'])} of the bound; "
        f"ten calls in one graph {ivf['graph10_ms']:.4f} ms a call, L2 "
        f"flushed before each call {ivf['l2_flushed_ms']:.4f} ms, eager "
        f"call {iv_eager:.4f} ms), plain {ivf['plain_ms']:.4f} ms, library "
        f"yardstick {ivf['library_ms']:.4f} ms, bound {iv_bound:.4f} ms "
        f"({iv_by}, {iv_bytes / 1e6:.1f} MB); device ms a call by kernel "
        f"(torch.profiler) {ivf['by_kernel_ms']} [{card}]")
    return ivf


def union_scores_phase(torch, card, index, h, plan, tag=""):
    """``union_scores`` on the mimps plan's union (the topk/mince/fmbe
    head), two calls bit-equal. Its live blocks (about 60 MB in bf16) sit
    near the 50 MB L2 cache, so it is also timed with the cache flushed
    before each call; the record takes that time if the warm one reads
    faster than the byte bound. Returns the record, named with ``tag``."""
    from repro_torch.kernels.ivf_score import union_scores, union_scores_plain
    q, d = h.shape
    es = h.element_size()
    live, cap = int(plan.head_live), plan.head_ids.shape[0]
    br = index.block_rows
    uargs = (index.v_blocks, h, plan.head_ids, plan.head_live)
    us = union_scores(*uargs)
    us_again = union_scores(*uargs)
    torch.cuda.synchronize()
    check(torch.equal(us, us_again),
          f"union_scores{tag}: two calls differ in their bits")
    p_us = union_scores_plain(*uargs)
    check(us.shape == (q, cap, br), f"union_scores shape {tuple(us.shape)}")
    err = (us[:, :live] - p_us[:, :live]).abs().max().item()
    check(err <= TOL, f"union_scores{tag}: live slots differ by {err}")
    check(bool((us[:, live:] == 0).all()),
          f"union_scores{tag}: pad slots not 0")
    us_bytes = (live * br * d * es + q * d * es + cap * 4 + 4
                + q * cap * br * 4)
    us_bound, us_by = bound_ms(us_bytes, 2 * q * live * br * d)

    def library_union_scores():
        return torch.einsum("qd,ubd->qub", h, index.v_blocks[plan.head_ids])

    warm = time_ms(torch, lambda: union_scores(*uargs))
    cold = flushed_ms(torch, lambda: union_scores(*uargs))
    uni = dict(name=f"union_scores{tag}", route="cuda",
               source="src/repro_torch/kernels/csrc/union_scores.cu",
               replaces="src/repro/kernels/ivf_score.py:110",
               max_abs_err=err,
               ms=warm if warm >= us_bound else cold,
               plain_ms=time_ms(torch, lambda: union_scores_plain(*uargs)),
               bound_ms=us_bound, bound_by=us_by,
               library_ms=time_ms(torch, library_union_scores),
               graph10_ms=graph10_ms(torch, lambda: union_scores(*uargs)),
               warm_ms=warm, l2_flushed_ms=cold,
               ms_is_l2_flushed=warm < us_bound)
    us_eager = eager_ms(torch, lambda: union_scores(*uargs))
    log(f"union_scores{tag}: Q {q} union {live} live of {cap} slots x {br} "
        f"rows, {h.dtype}: live err {err:.2e}, pad slots 0, two calls "
        f"bit-equal; kernel {warm:.4f} ms ({share(us_bound, warm)} of the "
        f"byte bound, {us_bytes / warm / 1e6:.1f} GB/s; eager call "
        f"{us_eager:.4f} ms), L2 flushed before each call {cold:.4f} ms "
        f"({share(us_bound, cold)}, {us_bytes / cold / 1e6:.1f} GB/s; the "
        f"record takes the {'flushed' if uni['ms_is_l2_flushed'] else 'warm'}"
        f" time), plain {uni['plain_ms']:.4f} ms, library "
        f"{uni['library_ms']:.4f} ms, bound {us_bound:.4f} ms ({us_by}, "
        f"{us_bytes / 1e6:.1f} MB) [{card}]")
    return uni


def fmbe_z_phase(torch, card, fm, fstate, h, plan, deg_sum, tag=""):
    """``fmbe_z`` (the tensor-core kernel on the build's pack,
    ``FMBEState.pack``) on the decode's per-query complement lambda,
    against its plain version and the pack's decomposition (f32: its
    planes), two calls bit-equal; times it as one call, as ten calls in
    one graph and with the L2 cache flushed before each call, beside the
    byte bound of the pack it reads and that of the f32 omega rows the
    CUDA-core kernel read before, the plain version and a composed library
    yardstick (``torch.matmul(x, pack.rows.T)``, the feature products, a
    matvec with lambda). Returns the record, named with ``tag``."""
    from repro_torch.kernels.fmbe import (PACK_TILE, fmbe_phi_plain, fmbe_z,
                                          fmbe_z_pack_plain,
                                          fmbe_z_planes_plain, fmbe_z_plain)
    q, d = h.shape
    es = h.element_size()
    n_feat, max_deg, _ = fm.omega.shape
    pack = fstate.pack
    check(pack is not None, f"fmbe_z{tag}: the fmbe build kept no pack")
    lam_rest = (fstate.lambda_tilde[None, :] -
                fstate.lambda_blocks[plan.block_ids.long()].sum(1))
    lam_rest = lam_rest.contiguous()
    zargs = (fm.omega, fm.degree, fm.coef, lam_rest, h)
    call = lambda: fmbe_z(*zargs, pack=pack)                # noqa: E731
    z = call()
    z_again = call()
    torch.cuda.synchronize()
    check(torch.equal(z, z_again), f"fmbe_z{tag} is not bit-reproducible")
    check(bool(torch.isfinite(z).all()), f"fmbe_z{tag} not finite")
    terms = fmbe_phi_plain(fm.omega, fm.degree, fm.coef, h) * lam_rest
    err, ratio = compare_signed_sum(f"fmbe_z{tag}", z, fmbe_z_plain(*zargs),
                                    terms)
    decomposition = (fmbe_z_planes_plain if h.dtype == torch.float32
                     else fmbe_z_pack_plain)
    d_err, d_ratio = compare_signed_sum(
        f"fmbe_z{tag} against its decomposition", z,
        decomposition(pack, lam_rest, h), terms)
    n_cols = pack.rows.shape[0]
    side = q * n_feat * 4 + q * d * es + q * 4
    fz_bytes = (n_cols * d * 2 + n_feat * 12 + (n_cols // PACK_TILE + 1) * 4
                + side)
    planes = 3 if h.dtype == torch.float32 else 1
    fz_bound, fz_by = bound_ms(fz_bytes, 2 * q * n_cols * d * planes)
    omega_bytes = deg_sum * d * 4 + n_feat * 8 + side
    omega_bound, _ = bound_ms(omega_bytes, 2 * q * deg_sum * d)
    rows = pack.rows if h.dtype == torch.bfloat16 else pack.rows.float()
    m_idx = torch.arange(max_deg, device=h.device)[:, None]
    use = pack.degree[None, :] > m_idx                        # (M, P)
    col = torch.where(use, pack.start[None, :] + m_idx, 0).long()

    def library_fmbe_z():
        proj = torch.matmul(h, rows.T).float()
        factors = torch.where(use[None], proj[:, col], 1.0)   # (Q, M, P)
        return (factors.prod(1) * pack.coef * lam_rest).sum(-1)

    fz = dict(name=f"fmbe_z{tag}", route="cuda",
              source="src/repro_torch/kernels/csrc/fmbe_z.cu",
              replaces="src/repro/kernels/fmbe.py:121",
              max_abs_err=max(err, d_err), max_err_over_tol=max(ratio,
                                                                 d_ratio),
              ms=time_ms(torch, call),
              plain_ms=time_ms(torch, lambda: fmbe_z_plain(*zargs)),
              bound_ms=fz_bound, bound_by=fz_by,
              library_ms=time_ms(torch, library_fmbe_z),
              library_call="torch.matmul(x, pack.rows.T), the feature "
              "products, a matvec with lambda",
              graph10_ms=graph10_ms(torch, call),
              l2_flushed_ms=flushed_ms(torch, call),
              bound_f32_omega_ms=omega_bound, pack_columns=n_cols,
              by_kernel_ms=kernel_split(torch, call))
    fz_eager = eager_ms(torch, call)
    log(f"fmbe_z{tag}: Q {q} P {n_feat} max degree {max_deg} (sum of "
        f"degrees {deg_sum}), pack {n_cols} columns, per-query lambda, "
        f"{h.dtype}: max abs err {err:.3e} = {ratio:.4f} of the tolerance "
        f"(against the pack's decomposition {d_ratio:.4f}), |z| up to "
        f"{z.abs().max().item():.3e}, two calls bit-equal; kernel "
        f"{fz['ms']:.4f} ms ({share(fz_bound, fz['ms'])} of the pack's "
        f"bound; ten calls in one graph {fz['graph10_ms']:.4f} ms a call, "
        f"L2 flushed before each call {fz['l2_flushed_ms']:.4f} ms, eager "
        f"call {fz_eager:.4f} ms), plain {fz['plain_ms']:.4f} ms, library "
        f"yardstick {fz['library_ms']:.4f} ms, bound {fz_bound:.4f} ms "
        f"({fz_by}, the pack's {fz_bytes / 1e6:.1f} MB; the f32 omega "
        f"rows' {omega_bytes / 1e6:.1f} MB: {omega_bound:.4f} ms); device ms "
        f"a call by kernel (torch.profiler) {fz['by_kernel_ms']} [{card}]")
    return fz


def fmbe_phi_phase(torch, card, fm, index, fstate, deg_sum):
    """``fmbe_phi`` (bf16 rows: the tensor-core kernel) on one real build
    chunk of ``PHI_CHUNK_BLOCKS`` blocks against its plain version, bit-equal
    over two calls, and that chunk's ``lambda_blocks`` as the build made
    them; times it beside its operations bound, the plain version, the
    product alone as ``torch.matmul(x, pack.rows.T)`` (the mainloop's
    yardstick, ``library_ms``: it does not compute phi), the packing, the
    build's masked block sum over the chunk's phi and the whole sketch
    (``build_fmbe_blocks``). Returns the record."""
    from repro_torch.core.feature_maps import build_fmbe_blocks
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import fmbe_pack, fmbe_phi, fmbe_phi_plain
    nbc = PHI_CHUNK_BLOCKS
    br, d = index.block_rows, index.v_blocks.shape[-1]
    x = index.v_blocks[:nbc].reshape(-1, d)
    rows = x.shape[0]
    n_feat = fm.omega.shape[0]
    pack = fmbe_pack(fm.omega, fm.degree, fm.coef)
    pargs = (fm.omega, fm.degree, fm.coef, x)
    phi = fmbe_phi(*pargs, pack=pack)
    again = fmbe_phi(*pargs, pack=pack)
    torch.cuda.synchronize()
    check(torch.equal(phi, again), "fmbe_phi is not bit-reproducible")
    del again
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
    fp_bytes = deg_sum * d * 2 + n_feat * 8 + rows * d * 2 + rows * n_feat * 4
    fp_bound, fp_by = bound_ms(fp_bytes, 2 * rows * deg_sum * d)
    n_cols = pack.rows.shape[0]
    fph = dict(name="fmbe_phi", route="cuda",
               source="src/repro_torch/kernels/csrc/fmbe_phi_wgmma.cu",
               replaces="src/repro/kernels/fmbe.py:89",
               max_abs_err=perr.max().item(), max_err_over_tol=p_ratio,
               ms=time_ms(torch, lambda: fmbe_phi(*pargs, pack=pack)),
               plain_ms=time_ms(torch, lambda: fmbe_phi_plain(*pargs),
                                reps=5),
               bound_ms=fp_bound, bound_by=fp_by,
               library_ms=time_ms(torch, lambda: torch.matmul(
                   x, pack.rows.T)),
               library_call="torch.matmul(x, pack.rows.T), bf16: the "
               "projections alone, not phi",
               pack_ms=wall_ms(torch, lambda: fmbe_pack(
                   fm.omega, fm.degree, fm.coef), reps=3),
               mask_sum_ms=time_ms(torch, lambda: (
                   phi.reshape(nbc, br, -1)
                   * index.valid[:nbc, :, None]).sum(1)),
               pack_columns=n_cols)
    del phi, perr, ptol
    fph["sketch_ms"] = wall_ms(torch, lambda: build_fmbe_blocks(
        fm, index.v_blocks, index.valid, pack=pack), reps=3)
    macs = rows * deg_sum * d
    log(f"fmbe_phi: {nbc} blocks = {rows} rows x P {n_feat}, pack {n_cols} "
        f"columns for {deg_sum} live rows: max abs err "
        f"{fph['max_abs_err']:.3e} = {p_ratio:.4f} of the tolerance, two "
        f"calls bit-equal; chunk lambda_blocks err {lerr:.3e} = "
        f"{l_ratio:.4f} of the tolerance; tensor-core kernel "
        f"{fph['ms']:.4f} ms ({macs / fph['ms'] / 1e6:.1f} TMAC/s on the "
        f"live rows, {fp_bound / fph['ms']:.3f} of the bound), plain "
        f"{fph['plain_ms']:.4f} ms, torch.matmul(x, pack.T) {fph['library_ms']:.4f} ms "
        f"(yardstick, no phi), bound {fp_bound:.4f} ms ({fp_by}, "
        f"{fp_bytes / 1e6:.1f} MB, {macs / 1e9:.1f} G multiply-adds); "
        f"pack (host clock) {fph['pack_ms']:.3f} ms, the build's masked "
        f"block sum of the chunk's phi {fph['mask_sum_ms']:.4f} ms; the "
        f"whole sketch (build_fmbe_blocks, host clock) "
        f"{fph['sketch_ms']:.3f} ms [{card}]")
    for line in ptxas_report(_build.build_log.get("fmbe_phi_wgmma", "")):
        log(f"  ptxas fmbe_phi_wgmma: {line}")
    return fph


def lsh_probe_phase(torch, card, lidx, w, h, pc, k, gen, tag=""):
    """``lsh_probe`` against its plain version at the lsh engine's plan for
    the hidden states h: on the trimmed union the main path scores, and on
    the dense fallback that a small ``head_cap`` forces. Returns the
    kernel's record (the trimmed branch's numbers, the dense branch's under
    ``dense_*``)."""
    from repro_torch.core.lsh import (_collide, device_cands, lsh_plan,
                                      resolve_cand_cap)
    from repro_torch.kernels.lsh_probe import (lsh_probe, lsh_probe_plain,
                                               lsh_query_codes)
    q, d = h.shape
    v = w.shape[0]
    ltab, kbits = lidx.n_tables, lidx.n_bits
    cap = resolve_cand_cap(pc.head_cap, lidx, v)
    plan = lsh_plan(lidx, h, pc.l, generator=gen)
    live = int(plan.cand_live)
    if live > cap:         # the union overflowed: widen it to hold the
        plan = lsh_plan(lidx, h, pc.l, tail_ids=plan.tail_ids,  # trimmed
                        cand_cap=live)                          # branch too
    log(f"lsh plan: union {live} rows (trimmed capacity {cap}), k_eff "
        f"{plan.k_eff.tolist()}, accepted tail samples "
        f"{plan.tail_accept.sum(-1).tolist()} of {pc.l}")

    # the kernel's query codes against the plan's (f64 projections)
    kq = lsh_query_codes(h, lidx.proj)
    differ = kq != plan.qcodes
    pm = lidx.proj[..., :d].reshape(ltab * kbits, d).double()
    rel = ((h.double() @ pm.T) / (h.double().norm(dim=1)[:, None]
                                  * pm.norm(dim=1)[None, :])).abs()
    flips = (((kq ^ plan.qcodes)[..., None] >> torch.arange(
        kbits, device=h.device)) & 1).bool().reshape(q, -1)
    worst = rel[flips].max().item() if flips.any() else 0.0
    check(worst <= CODE_REL, f"lsh_probe: a query code differs from the "
          f"plan's where the projection is {worst:.3e} of |h||p| from 0")
    log(f"lsh_probe query codes: {int(differ.sum())} of {differ.numel()} "
        f"differ from the plan's ({int(flips.sum())} bits, each within "
        f"{CODE_REL} of 0 relative)")

    def hold(label, plan_b):
        # the main path's columns: width V, the branch chosen on the device
        rows, col_live = device_cands(plan_b)
        c = rows.shape[0]
        n_live = min(int(col_live), c)
        member = plan_b.occ_q[:, rows.long()] & \
            (torch.arange(c, device=h.device) < n_live)[None, :]
        args = (w, h, lidx.proj, rows, col_live, lidx.codes,
                lidx.slot_of_row, plan_b.tail_ids, plan_b.tail_accept,
                plan_b.tail_bias)
        out = lsh_probe(*args, k=k)
        again = lsh_probe(*args, k=k)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"lsh_probe {label}: not bit-reproducible")
        hl, tl, tv, ti, cnt = out
        p_hl, p_tl, p_v, p_i, p_cnt = lsh_probe_plain(*args, k=k + 1)
        err = max(compare_lse(f"lsh_probe {label} head_lse", hl, p_hl),
                  compare_lse(f"lsh_probe {label} tail_lse", tl, p_tl))
        err_v, n_ids = compare_topk(f"lsh_probe {label}", tv, ti, p_v, p_i)
        check(torch.equal(cnt, p_cnt), f"lsh_probe {label}: counts differ "
              f"from the plain version's")
        # membership: the plan's, or for a query whose code flipped at a
        # projection within CODE_REL of 0, that of the kernel's codes
        want = member.clone()
        flipped = differ.any(-1)
        if flipped.any():
            want[flipped] = _collide(lidx, kq[flipped], rows) & \
                (torch.arange(c, device=h.device) < n_live)[None, :]
        got_member = cnt > 0
        check(torch.equal(got_member[:, :n_live], want[:, :n_live]),
              f"lsh_probe {label}: counts > 0 differ from the membership")
        moved = int((got_member[:, :n_live] != member[:, :n_live]).sum())
        check(not got_member[:, n_live:].any(), f"lsh_probe {label}: counts "
              f"past the live columns")
        n_tail = plan_b.tail_ids.shape[0]
        es = h.element_size()
        n_bytes = (n_live * d * es + n_tail * d * es + q * d * es
                   + ltab * kbits * (d + 1) * 4 + n_live * 4
                   + n_live * ltab * 8 + n_tail * 8 + q * n_tail + 4
                   + q * c * 4 + q * (8 + 8 * k))
        bound, by = bound_ms(n_bytes, 2 * q * (n_live + n_tail) * d,
                             f32_ops=2 * q * ltab * kbits * d)
        ids, t_ids = rows[:n_live].long(), plan_b.tail_ids.long()
        member_live = member[:, :n_live]

        def library():             # over the live columns only
            s = torch.matmul(h, w[ids].T).float()
            eff = torch.where(member_live, s, torch.full_like(s, -1e30))
            ts = torch.matmul(h, w[t_ids].T).float() + plan_b.tail_bias
            tl_ = torch.logsumexp(torch.where(plan_b.tail_accept, ts,
                                              torch.full_like(ts, -1e30)), -1)
            return torch.logsumexp(eff, -1), torch.topk(eff, k), tl_

        rec = dict(ms=time_ms(torch, lambda: lsh_probe(*args, k=k)),
                   plain_ms=time_ms(torch,
                                    lambda: lsh_probe_plain(*args, k=k),
                                    reps=10),
                   bound_ms=bound, bound_by=by,
                   library_ms=time_ms(torch, library, reps=10),
                   graph10_ms=graph10_ms(torch,
                                         lambda: lsh_probe(*args, k=k)),
                   max_abs_err=max(err, err_v))
        eager = eager_ms(torch, lambda: lsh_probe(*args, k=k))
        log(f"lsh_probe {label}: Q {q} C {c} columns, {n_live} live, "
            f"l {n_tail}, k {k}: lse err {err:.2e}, top-k err {err_v:.2e}, "
            f"{n_ids} ids checked, counts equal, membership equal "
            f"({moved} columns moved by flipped codes), two calls "
            f"bit-equal; kernel {rec['ms']:.4f} ms ({share(bound, rec['ms'])}"
            f" of the {by} bound, {n_bytes / rec['ms'] / 1e6:.1f} GB/s; "
            f"eager call {eager:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms']:.4f} ms, bound {bound:.4f} ms "
            f"({by}, {n_bytes / 1e6:.1f} MB) [{card}]")
        return rec

    trimmed = hold(f"trimmed{tag}", plan)
    # the trimmed union at its own width, as the host-chosen branch ran it
    narrow = (w, h, lidx.proj, plan.cand_rows, plan.cand_live, lidx.codes,
              lidx.slot_of_row, plan.tail_ids, plan.tail_accept,
              plan.tail_bias)
    trimmed["capacity_width_ms"] = time_ms(torch,
                                           lambda: lsh_probe(*narrow, k=k))
    log(f"lsh_probe trimmed{tag} at the capacity's width "
        f"({plan.cand_rows.shape[0]} columns, as the host-chosen branch "
        f"ran it): {trimmed['capacity_width_ms']:.4f} ms, at width V "
        f"{trimmed['ms']:.4f} ms [{card}]")
    dense_plan = lsh_plan(lidx, h, pc.l, tail_ids=plan.tail_ids,
                          cand_cap=64)
    check(int(dense_plan.cand_live) > 64, "lsh: head_cap 64 kept the union")
    dense = hold(f"dense{tag}", dense_plan)
    rec = dict(name=f"lsh_probe{tag}", route="cuda",
               source="src/repro_torch/kernels/csrc/lsh_probe.cu",
               replaces="src/repro/kernels/lsh_probe.py:133",
               trimmed_capacity=cap, query_codes_differing=int(differ.sum()),
               **trimmed)
    rec.update({f"dense_{key}": val for key, val in dense.items()})
    rec["max_abs_err"] = max(trimmed["max_abs_err"], dense["max_abs_err"])
    return rec


def ivf_score_phase(torch, card, kernels, index, h, plan, tag=""):
    """``ivf_score`` against its plain version on the mimps plan's (Q, p)
    probe ids, two calls bit-equal; times it as one call, as ten calls in
    one graph, with the L2 cache flushed before each call and by kernel
    (the prologue and the scores), beside its byte bound (each query tile's
    distinct blocks read once), the plain version and a library call; holds
    the rows its producers copy (the prologue's live counts x br rows) to
    the bound's. Then its main path: the entry point
    ``ops.ivf_block_scores``, driven once with the launch counts at 0.
    Returns the kernel's record with the path's launches under
    ``path_launches``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_score import (QT, ivf_score,
                                              ivf_score_plain, score_launch)
    from repro_torch.kernels.ops import ivf_block_scores
    nb, br, d = index.v_blocks.shape
    q, p = plan.block_ids.shape
    es = h.element_size()
    args = (index.v_blocks, h, plan.block_ids)
    got = ivf_score(*args)
    again = ivf_score(*args)
    torch.cuda.synchronize()
    check(got.shape == (q, p, br), f"ivf_score shape {tuple(got.shape)}")
    check(torch.equal(got, again),
          f"ivf_score{tag}: two calls differ in their bits")
    err = (got - ivf_score_plain(*args)).abs().max().item()
    check(err <= TOL, f"ivf_score{tag}: scores differ by {err}")
    # each query tile's distinct blocks, read once
    distinct = sum(int(torch.unique(plan.block_ids[t:t + QT]).numel())
                   for t in range(0, q, QT))
    block_bytes = distinct * br * d * es
    n_bytes = block_bytes + q * d * es + q * p * 4 + q * p * br * 4
    bound, by = bound_ms(n_bytes, 2 * q * p * br * d)
    live = score_launch(*args)[2]
    copied = int(live.sum()) * br * d * es
    check(copied == block_bytes, f"ivf_score{tag}: its producers copy "
          f"{copied} bytes of rows, the bound's distinct blocks are "
          f"{block_bytes}")
    ids = plan.block_ids.long()
    call = lambda: ivf_score(*args)                     # noqa: E731
    rec = dict(name=f"ivf_score{tag}", route="cuda",
               source="src/repro_torch/kernels/csrc/ivf_score.cu",
               replaces="src/repro/kernels/ivf_score.py:62",
               max_abs_err=err,
               ms=time_ms(torch, call),
               plain_ms=time_ms(torch, lambda: ivf_score_plain(*args),
                                reps=10),
               bound_ms=bound, bound_by=by,
               library_ms=time_ms(torch, lambda: torch.einsum(
                   "qd,qpbd->qpb", h, index.v_blocks[ids])),
               graph10_ms=graph10_ms(torch, call),
               l2_flushed_ms=flushed_ms(torch, call),
               by_kernel_ms=kernel_split(torch, call),
               copied_row_bytes=copied, bound_bytes=n_bytes)
    _build.reset_counts(kernels.values())
    scores = ivf_block_scores(*args)
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in kernels.items()}
    check(counts["ivf_score"] > 0, "ops.ivf_block_scores never launched "
          "ivf_score")
    check(torch.equal(scores, got), "ops.ivf_block_scores differs from "
          "ivf_score")
    rec["path_launches"] = counts["ivf_score"]
    log(f"ivf_score{tag}: Q {q} x p {p} probes of {br} x {d} blocks "
        f"({distinct} distinct a query tile, summed over "
        f"{-(-q // QT)} tiles, of {nb}), {h.dtype}: err {err:.2e}, two "
        f"calls bit-equal; kernel {rec['ms']:.4f} ms "
        f"({share(bound, rec['ms'])} of the bound; ten calls in one graph "
        f"{rec['graph10_ms']:.4f} ms a call, "
        f"{share(bound, rec['graph10_ms'])}; L2 flushed before each call "
        f"{rec['l2_flushed_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
        f"library {rec['library_ms']:.4f} ms (einsum over the gathered "
        f"blocks), bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB); "
        f"rows copied {copied / 1e6:.1f} MB, the bound's distinct blocks "
        f"{block_bytes / 1e6:.1f} MB, {q * p * br * d * es / 1e6:.1f} MB "
        f"without deduplication; device ms a call by kernel "
        f"(torch.profiler) {rec['by_kernel_ms']}; ops.ivf_block_scores "
        f"launches {counts} [{card}]")
    return rec


def compare_terms(name, got, want, terms, rel=GRAD_REL, mean_rel=GRAD_MEAN):
    """Gradients: per element |got - want| <= rel * sum |terms|, and
    mean_rel on average (defaults: a coefficient rounded to bf16 on both
    sides). Returns (max abs err, max ratio, mean ratio)."""
    ratio = (got - want).abs() / terms.clamp(min=1e-30)
    worst, mean = ratio.max().item(), ratio.mean().item()
    check(worst <= rel and mean <= mean_rel,
          f"{name}: error up to {worst:.3e} (mean {mean:.3e}) of sum "
          f"|terms|, allowed {rel:.3e} (mean {mean_rel:.3e})")
    return (got - want).abs().max().item(), worst, mean


def ptxas_report(text):
    """The lines of an ``nvcc -Xptxas -v`` report that give each entry
    function's registers, shared memory, stack and spills."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            out.append(line.split("'")[1] if "'" in line else line)
        elif "registers" in line or "spill" in line:
            out.append("  " + line.replace("ptxas info    : ", ""))
    return out


def kernel_split(torch, fn, reps=20):
    """Device milliseconds a call of ``fn`` spends in each kernel (mean of
    ``reps`` eager calls under torch.profiler), by kernel name. A kernel
    launched as a programmatic dependent starts while the one before it
    runs, and its time includes that wait."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")[:60]
            out[name] = out.get(name, 0.0) + (e.self_device_time_total
                                              / 1e3 / reps)
    return out


def profile_step(torch, fn, n_top=10):
    """Runs ``fn`` once under torch.profiler. Returns (wall ms, device busy
    ms, the n_top device kernels and the n_top host ops by self time, as
    (name, calls, ms))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev, host = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            dev.append((e.key, e.count, e.self_device_time_total / 1e3))
        else:
            host.append((e.key, e.count, e.self_cpu_time_total / 1e3))
    dev.sort(key=lambda r: -r[2])
    host.sort(key=lambda r: -r[2])
    return wall, sum(r[2] for r in dev), dev[:n_top], host[:n_top]


def train(torch, card, kernels):
    """Phases 6-7: the fused CE kernels against their plain versions at the
    training shapes, then train steps of full-width qwen1.5-4b. Returns the
    two kernel records."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_ce import (bwd_launch, bwd_schedule,
                                             ce_coef, fused_ce_bwd,
                                             fused_ce_bwd_chunked_plain,
                                             fused_ce_bwd_plain, fused_ce_fwd,
                                             fused_ce_fwd_plain, grad_items,
                                             grad_order)
    from repro_torch.models import Model
    from repro_torch.train import (adamw_update, harvest_train_metrics,
                                   init_train_metric_state, init_train_state,
                                   make_train_step, observe_train_step,
                                   streaming_ce)
    from repro_torch.train.optimizer import tree_leaves

    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state = init_train_state(model, TrainConfig(), seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"train state: {cfg.name} layers {cfg.n_layers} d {cfg.d_model} "
        f"vocab {cfg.vocab} remat {cfg.remat}, {cfg.dtype} parameters and "
        f"f32 moments, {torch.cuda.memory_allocated() / 1e9:.2f} GB, "
        f"{time.time() - t0:.1f} s")
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), TRAIN_B, TRAIN_S)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in next(it))
    batch = {"tokens": tokens, "labels": labels}

    # -- 6. the fused CE kernels at the training shapes ----------------------
    params = state.params
    with torch.no_grad():
        hidden, _ = model.forward(params, tokens)
    h = hidden.reshape(-1, cfg.d_model)
    w = model.head_matrix(params).detach()
    lab = labels.reshape(-1)
    t, d, v = h.shape[0], h.shape[1], w.shape[0]
    nll, lse = fused_ce_fwd(h, w, lab)
    nll2, lse2 = fused_ce_fwd(h, w, lab)
    torch.cuda.synchronize()
    check(torch.equal(nll, nll2) and torch.equal(lse, lse2),
          "fused_ce_fwd is not bit-reproducible")
    p_nll, p_lse = fused_ce_fwd_plain(h, w, lab)
    f_err = max((nll - p_nll).abs().max().item(),
                (lse - p_lse).abs().max().item())
    check(f_err <= TOL, f"fused_ce_fwd: nll/lse differ by {f_err}")
    alpha = TrainConfig().selfnorm_alpha
    g_nll = torch.full((t,), 1.0 / t, device=dev)
    g_lse = 2 * alpha * lse / t          # d(alpha mean lse^2)/d lse
    bargs = (h, w, lab, lse, g_nll, g_lse)
    dh, dw = fused_ce_bwd(*bargs, cast=False)
    dh2, dw2 = fused_ce_bwd(*bargs, cast=False)
    torch.cuda.synchronize()
    check(torch.equal(dh, dh2) and torch.equal(dw, dw2),
          "fused_ce_bwd is not bit-reproducible")
    del dh2, dw2
    p_dh, p_dw = fused_ce_bwd_plain(*bargs, cast=False)
    coef = ce_coef(*bargs).abs()
    dh_terms, dw_terms = coef @ w.float().abs(), coef.T @ h.float().abs()
    del coef
    dh_err = compare_terms("fused_ce_bwd dh", dh, p_dh, dh_terms)
    dw_err = compare_terms("fused_ce_bwd dw", dw, p_dw, dw_terms)
    # the kernel's own decomposition (chunks of C columns) in plain PyTorch
    del p_dh, p_dw
    c_dh, c_dw = fused_ce_bwd_chunked_plain(*bargs, cast=False)
    cdh_err = compare_terms("fused_ce_bwd dh vs chunked plain", dh, c_dh,
                            dh_terms)
    cdw_err = compare_terms("fused_ce_bwd dw vs chunked plain", dw, c_dw,
                            dw_terms)
    log(f"fused_ce_bwd against fused_ce_bwd_chunked_plain: dh max "
        f"{cdh_err[1]:.3e} (mean {cdh_err[2]:.3e}), dW max {cdw_err[1]:.3e} "
        f"(mean {cdw_err[2]:.3e}) of sum |terms|")
    del c_dh, c_dw, dh_terms, dw_terms, dh, dw
    torch.cuda.empty_cache()
    fwd_bytes = t * d * 2 + v * d * 2 + t * 4 + 2 * t * 4
    fwd_bound, fwd_by = bound_ms(fwd_bytes, 2 * t * v * d)
    bwd_bytes = 2 * (t * d * 2 + v * d * 2) + 4 * t * 4
    bwd_bound, bwd_by = bound_ms(bwd_bytes, 6 * t * v * d)
    gn = g_nll + g_lse

    def library_fwd():
        logits = torch.matmul(h, w.T).float()
        lse_ = torch.logsumexp(logits, -1)
        return lse_ - logits.gather(1, lab.long()[:, None])[:, 0], lse_

    def library_bwd():
        logits = torch.matmul(h, w.T).float()
        coef_ = torch.softmax(logits, -1) * gn[:, None]
        coef_.scatter_add_(1, lab.long()[:, None], -g_nll[:, None])
        c = coef_.to(w.dtype)
        return c @ w, c.T @ h

    fwd = dict(name="fused_ce_fwd", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_ce_fwd.cu",
               replaces="src/repro/kernels/fused_ce.py:128",
               max_abs_err=f_err,
               ms=time_ms(torch, lambda: fused_ce_fwd(h, w, lab)),
               plain_ms=time_ms(torch, lambda: fused_ce_fwd_plain(h, w, lab),
                                reps=5),
               bound_ms=fwd_bound, bound_by=fwd_by,
               library_ms=time_ms(torch, library_fwd))
    bwd = dict(name="fused_ce_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_ce_bwd.cu",
               replaces="src/repro/kernels/fused_ce.py:169",
               max_abs_err=max(dh_err[0], dw_err[0]),
               max_err_over_sum_terms=max(dh_err[1], dw_err[1]),
               ms=time_ms(torch, lambda: fused_ce_bwd(*bargs), reps=10),
               plain_ms=time_ms(torch, lambda: fused_ce_bwd_plain(*bargs),
                                reps=5),
               bound_ms=bwd_bound, bound_by=bwd_by,
               library_ms=time_ms(torch, library_bwd, reps=10))
    log(f"fused_ce_fwd: T {t} V {v} d {d}: nll/lse err {f_err:.2e}, two "
        f"calls bit-equal; kernel {fwd['ms']:.4f} ms, plain "
        f"{fwd['plain_ms']:.4f} ms, library {fwd['library_ms']:.4f} ms, "
        f"bound {fwd_bound:.4f} ms ({fwd_by}, {2 * t * v * d / 1e12:.3f} "
        f"TFLOP, {fwd_bytes / 1e6:.1f} MB) [{card}]")
    log(f"fused_ce_bwd: T {t} V {v} d {d}, g_lse = 2 alpha lse / T: dh err "
        f"{dh_err[0]:.2e} (max {dh_err[1]:.3e}, mean {dh_err[2]:.3e} of sum "
        f"|terms|), dW err {dw_err[0]:.2e} (max {dw_err[1]:.3e}, mean "
        f"{dw_err[2]:.3e}), two calls bit-equal; kernel {bwd['ms']:.4f} ms, "
        f"plain {bwd['plain_ms']:.4f} ms, library {bwd['library_ms']:.4f} "
        f"ms, bound {bwd_bound:.4f} ms ({bwd_by}, "
        f"{6 * t * v * d / 1e12:.3f} TFLOP, {bwd_bytes / 1e6:.1f} MB) "
        f"[{card}]")
    for rec, n_ops in ((fwd, 2 * t * v * d), (bwd, 6 * t * v * d)):
        log(f"{rec['name']}: {n_ops / rec['ms'] / 1e9:.1f} TFLOP/s achieved "
            f"(dense bf16 peak {BF16_FLOPS / 1e12:.0f}), "
            f"{rec['bound_ms'] / rec['ms']:.3f} of its bound [{card}]")
        for line in ptxas_report(_build.build_log.get(rec["name"], "")):
            log(f"  ptxas {rec['name']}: {line}")
        log(f"  {rec['name']}: {_build.load(rec['name']).hgemm_smem_bytes()} "
            f"bytes of dynamic shared memory a CTA")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sch = bwd_schedule(t, v)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fused_ce_bwd(*bargs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"fused_ce_bwd schedule: chunk C {sch['chunk']} of V {v} "
        f"({sch['n_chunks']} chunks), scratch {sch['scratch_bytes']} bytes "
        f"(T x C bf16), f32 dh sum {4 * t * d} bytes; max_memory_allocated "
        f"across one call {peak / 1e9:.3f} GB, {(peak - before) / 1e6:.1f} "
        f"MB above the {before / 1e9:.3f} GB before it (bf16 dh and dW "
        f"included) [{card}]")
    # each launch of the two kernels by name, device time a call
    reps = 5
    _, _, dev_top, _ = profile_step(torch, lambda: [
        (fused_ce_fwd(h, w, lab), fused_ce_bwd(*bargs)) for _ in range(reps)])
    for name, calls, ms in dev_top:
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        log(f"  launch {name.split('<')[0][-40:]:40s} {calls / reps:4.0f} a "
            f"call, {ms / reps:.4f} ms a call [{card}]")
    # the backward's dh + dW items dealt longest first (grad_order, the
    # kernel's path) against round-robin (what a strided loop walks):
    # the same bits, timed in the order longest first, round-robin,
    # round-robin, longest first
    rr = bwd_launch(*bargs, longest_first=False)
    torch.cuda.synchronize()
    check(torch.equal(out[0], rr[0]) and torch.equal(out[1], rr[1]),
          "fused_ce_bwd: round-robin deal changed the result")
    del out, rr
    deal_ms = {True: [], False: []}
    for lf in (True, False, False, True):
        deal_ms[lf].append(time_ms(
            torch, lambda lf=lf: bwd_launch(*bargs, longest_first=lf),
            reps=10))
    busiest = {lf: max(grad_order(t, d, sch["chunk"], sms, lf)[2])
               for lf in (True, False)}
    mean = sum(grad_items(t, d, sch["chunk"])) / sms
    log(f"fused_ce_bwd deal: longest first {deal_ms[True]} ms, round-robin "
        f"{deal_ms[False]} ms; busiest CTA of a full chunk {busiest[True]} "
        f"and {busiest[False]} stages of a mean {mean:.1f} [{card}]")
    del hidden, h, w, nll, lse, nll2, lse2, p_nll, p_lse, bargs, g_lse, gn
    del params
    torch.cuda.empty_cache()

    # -- 7. train ------------------------------------------------------------
    totals = {"fused_ce_fwd": 0, "fused_ce_bwd": 0}
    tm = init_train_metric_state(dev)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for loss_name, n_steps in (("fused_ce", FUSED_STEPS),
                               ("selfnorm", SELFNORM_STEPS)):
        tcfg = TrainConfig(loss=loss_name, warmup_steps=1)
        step = make_train_step(model, tcfg)
        for i in range(n_steps):
            _build.reset_counts(kernels.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {name: kernels[name].launches for name in totals}
            check(counts == {"fused_ce_fwd": 1, "fused_ce_bwd": 1},
                  f"{loss_name} step {i} launched {counts}, want one each")
            for name in totals:
                totals[name] += counts[name]
            tm = observe_train_step(tm, metrics)
            loss = metrics["loss_total"].item()
            check(math.isfinite(loss), f"{loss_name} step {i}: loss {loss}")
            losses.append((loss_name, loss, ms))
            log(f"train {loss_name} step {i}: loss {loss:.6f} (nll "
                f"{metrics['loss'].item():.6f}, mean log Z "
                f"{metrics['mean_log_z'].item():.4f}), grad norm "
                f"{metrics['grad_norm'].item():.4f}, lr {metrics['lr']:.3e}, "
                f"{ms:.1f} ms, {t / ms * 1e3:.1f} tokens/s, launches "
                f"{counts} [{card}]")
    fused = [x for x in losses if x[0] == "fused_ce"]
    check(fused[-1][1] < fused[0][1], f"fused_ce loss did not fall: "
          f"{[round(x[1], 6) for x in fused]}")
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(x[2] for x in losses[1:])
    log(f"train: {len(losses)} steps of B {TRAIN_B} x S {TRAIN_S} = {t} "
        f"tokens, steady {steady:.1f} ms/step (median of steps 2-"
        f"{len(losses)}), {t / steady * 1e3:.1f} tokens/s, peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated), depth {cfg.n_layers} "
        f"of {cfg.n_layers} [{card}]")
    log(f"train metrics: {harvest_train_metrics(tm)}")

    # one more fused_ce step, split into its parts: host clock with a
    # synchronise after each part, beside CUDA-event device time
    tcfg = TrainConfig(loss="fused_ce", warmup_steps=1)
    leaves = tree_leaves(state.params)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    walls = []

    def part(i, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[i].record()
        out = fn()
        events[i + 1].record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    hidden, _ = part(0, lambda: model.forward(state.params, tokens))
    loss = part(1, lambda: streaming_ce(
        hidden.reshape(-1, cfg.d_model), model.head_matrix(state.params),
        labels.reshape(-1))[0].mean())
    grads = part(2, lambda: torch.autograd.grad(loss, leaves))
    _, opt, _ = part(3, lambda: adamw_update(tcfg, state.params, grads,
                                             state.opt))
    state = state._replace(opt=opt)
    for i, name in enumerate(("forward", "loss", "backward", "optimizer")):
        log(f"train step part {name}: wall {walls[i]:.3f} ms, device "
            f"{events[i].elapsed_time(events[i + 1]):.3f} ms [{card}]")

    # one more fused_ce step under the profiler: the device's busy time and
    # idle share, and where the device and the host spend the step
    step = make_train_step(model, tcfg)
    wall, busy, dev_top, host_top = profile_step(
        torch, lambda: step(state, batch))
    log(f"train step profile: wall {wall:.1f} ms, device busy {busy:.1f} "
        f"ms, idle share {1 - busy / wall:.3f} [{card}]")
    for kind, rows in (("device", dev_top), ("host", host_top)):
        for name, calls, ms in rows:
            log(f"  {kind} {ms:9.3f} ms {calls:6d}x {name[:90]}")
    fwd["launches"] = totals["fused_ce_fwd"]
    bwd["launches"] = totals["fused_ce_bwd"]
    return [fwd, bwd]


def sparse_ce_float64(torch, h, w, sp, g_nll):
    """The sparse CE of the plan ``sp`` evaluated in float64 from the same
    operands, written apart from the port's code: (nll, log Z, dh, dw, and
    the sums of |terms| of dh and dw), for the loss mean(nll) (cotangent
    ``g_nll`` on nll, 0 on log Z). Only the head columns some token scores
    enter (the others add 0); dw is summed by ``index_add_``, whose order
    does not matter at float64."""
    neg = float("-inf")
    hd = h.double()
    live = sp.head_mask.any(0)
    rows = sp.head_rows[live].long()
    mask = sp.head_mask[:, live]
    wh = w[rows].double()
    s = hd @ wh.T
    head_lse = torch.logsumexp(torch.where(mask, s, neg), -1)
    tails, labels = sp.tail_ids.long(), sp.labels.long()
    wt, wl = w[tails].double(), w[labels].double()
    bias = sp.tail_bias.double()
    ts = hd @ wt.T + bias[None, :]
    acc = sp.tail_accept
    n_acc = (acc.double() * bias.exp()[None, :]).sum(-1)
    ntt = sp.n_tail_total.double()
    ok = (ntt > 0) & (n_acc > 0)
    scale = torch.log(ntt.clamp(min=1e-300)) - torch.log(
        n_acc.clamp(min=1e-300))
    log_tail = torch.where(ok, torch.logsumexp(
        torch.where(acc, ts, neg), -1) + scale, neg)
    s_lab = (hd * wl).sum(-1)
    log_z = torch.logsumexp(torch.stack(
        [head_lse, log_tail, torch.where(sp.label_in_head, neg, s_lab)]), 0)
    g = g_nll.double()
    p = torch.where(mask, (s - log_z[:, None]).exp(), 0.0) * g[:, None]
    del s
    sigma = torch.where(ok, ntt / n_acc.clamp(min=1e-300), 0.0)
    qc = torch.where(acc, (ts - log_z[:, None]).exp(), 0.0) \
        * (sigma * g)[:, None]
    lab = g * torch.where(sp.label_in_head, 0.0,
                          (s_lab - log_z).exp()) - g
    dh = p @ wh + qc @ wt + lab[:, None] * wl
    dh_terms = (p.abs() @ wh.abs() + qc.abs() @ wt.abs()
                + lab.abs()[:, None] * wl.abs())
    del wh
    dw = torch.zeros(w.shape, dtype=torch.float64, device=w.device)
    dw_terms = torch.zeros_like(dw)
    for ids, coef in ((rows, p), (tails, qc)):
        dw.index_add_(0, ids, coef.T @ hd)
        dw_terms.index_add_(0, ids, coef.abs().T @ hd.abs())
    dw.index_add_(0, labels, lab[:, None] * hd)
    dw_terms.index_add_(0, labels, lab.abs()[:, None] * hd.abs())
    return log_z - s_lab, log_z, dh, dw, dh_terms, dw_terms


def sparse_ce_checks(torch, name, h, w, sp, lsh_plan=None):
    """The hard checks of the sparse CE at one step's inputs: nll and log Z
    of the f32 path to F32_FWD_REL of 1 + |value| from float64; dh and dw
    before the cast to F32_GRAD_REL of the sum of their terms (F32_GRAD_MEAN
    on average), after it (bf16) to GRAD_REL; every dw row outside head ∪
    tail ∪ labels exactly 0; two calls bit-equal (nll, log Z, dh, dw). For
    lsh_ce also its invariant: each row of each token in exactly one of
    head, tail population and label term. Returns a dict for the log."""
    from repro_torch.train import losses as tl
    t = h.shape[0]
    g_nll = torch.full((t,), 1.0 / t, device=h.device)
    g_lz = torch.zeros_like(g_nll)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    outs = []
    for _ in range(2):
        torch.cuda.synchronize()
        ev[0].record()
        nll, lz, res = tl._sparse_ce_fwd(h, w, *sp)
        ev[1].record()
        dh, dw = tl._sparse_ce_bwd(res, g_nll, g_lz, cast=False)
        ev[2].record()
        torch.cuda.synchronize()
        del res
        outs.append((nll, lz, dh, dw))
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    check(same, f"{name}: two sparse CE calls differ (nll, log Z, dh, dw)")
    nll, lz, dh, dw = outs[0]
    del outs
    r_nll, r_lz, r_dh, r_dw, dh_terms, dw_terms = sparse_ce_float64(
        torch, h, w, sp, g_nll)
    fwd_err = max(((nll.double() - r_nll).abs() / (1 + r_nll.abs())).max()
                  .item(), ((lz.double() - r_lz).abs()
                            / (1 + r_lz.abs())).max().item())
    check(fwd_err <= F32_FWD_REL, f"{name}: nll/log Z off float64 by "
          f"{fwd_err:.3e} of 1 + |value|")
    errs = {}
    for what, got, want, terms in (("dh", dh, r_dh, dh_terms),
                                   ("dw", dw, r_dw, dw_terms)):
        errs[what] = compare_terms(f"{name} {what} (f32)", got.double(),
                                   want, terms, F32_GRAD_REL, F32_GRAD_MEAN)
        low = got.to(h.dtype if what == "dh" else w.dtype).double()
        errs[what + " cast"] = compare_terms(
            f"{name} {what} ({low.dtype})", low, want, terms, GRAD_REL,
            GRAD_REL)
    del r_dh, r_dw, dh_terms, dw_terms
    allowed = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
    allowed[sp.head_rows[sp.head_mask.any(0)].long()] = True
    allowed[sp.tail_ids.long()] = True
    allowed[sp.labels.long()] = True
    touched = dw.abs().sum(-1) > 0
    check(not bool(touched[~allowed].any()), f"{name}: dw rows outside "
          f"head, tail and labels are not 0")
    out = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_err": fwd_err,
           "dh": errs["dh"][1], "dw": errs["dw"][1],
           "dh_cast": errs["dh cast"][1], "dw_cast": errs["dw cast"][1],
           "rows": int(touched.sum()), "allowed": int(allowed.sum()),
           "head_cols": int(sp.head_mask.any(0).sum())}
    if lsh_plan is not None:
        ar = torch.arange(t, device=h.device)
        labels = sp.labels.long()
        occ = lsh_plan.occ_q
        label_term = ~occ[ar, labels]
        population = ~occ
        population[ar, labels] = False
        cols = sp.head_mask.any(0)           # live columns: distinct rows
        scored = torch.zeros_like(occ)
        scored[:, sp.head_rows[cols].long()] = sp.head_mask[:, cols]
        parts = occ.to(torch.int8) + population.to(torch.int8)
        parts[ar, labels] += label_term.to(torch.int8)
        check(torch.equal(label_term, ~sp.label_in_head)
              and torch.equal(sp.n_tail_total, population.sum(-1).float())
              and bool((parts == 1).all())
              and torch.equal(sp.tail_accept,
                              population[:, sp.tail_ids.long()])
              and torch.equal(scored, occ),
              f"{name}: a row outside exactly one of head, tail population "
              f"and label term")
        out["lsh_head_rows_mean"] = occ.sum(-1).float().mean().item()
    return out


def estimator_train(torch, card, kernels, ce_records):
    """Phase 7b: estimator-backed training of full-width qwen1.5-4b (bf16,
    40 layers, remat full) on the training phase's batch (B 4 x S 256).
    mimps_ce and lsh_ce: ``init_train_state`` builds the index (553-block
    IVF; 8 x 8-bit LSH), the sparse CE is held at the first step's inputs
    (``sparse_ce_checks``), then 4 steps on the repeated batch with one
    ``make_index_refresh`` between steps 2 and 3 (shapes kept, churn and
    drift finite), the loss finite and falling; mimps_ce then takes one
    step split into parts and 2 fused_ce steps on the same state, for
    comparison. mince_ce, nce and sampled take 2 steps each, finite and
    falling (nce and sampled on one noise draw, so that their objective is
    fixed). No step of an estimator loss launches one of the nine kernels
    (the JAX package's estimator losses have none); the fused_ce steps
    launch one CE kernel of each kind a step, counted into ``ce_records``.
    Logs wall and CUDA-event ms a step, tokens/s, peak memory, head_live,
    head_hit_rate, k_eff, the refresh's seconds and the loss part's ms."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.models import Model
    from repro_torch.train import (init_train_state, losses,
                                   make_index_refresh, make_train_step)

    t_phase = time.time()
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    model = Model(cfg)
    pc = cfg.partition
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), TRAIN_B, TRAIN_S)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in next(it))
    batch = {"tokens": tokens, "labels": labels}
    t = tokens.numel()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed_step(step, state):
        _build.reset_counts(kernels.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        state, metrics = step(state, batch)
        ev[1].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        return state, metrics, wall, ev[0].elapsed_time(ev[1]), counts

    summary = {}
    for loss_name, n_steps in (("mimps_ce", EST_STEPS), ("lsh_ce", EST_STEPS),
                               ("mince_ce", 2), ("nce", 2), ("sampled", 2)):
        tcfg = TrainConfig(loss=loss_name, warmup_steps=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        state = init_train_state(model, tcfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.time() - t0
        if loss_name in ("mimps_ce", "lsh_ce"):
            with torch.no_grad():
                hidden, _ = model.forward(state.params, tokens)
            h = hidden.reshape(-1, cfg.d_model)
            w = model.head_matrix(state.params).detach()
            lab = labels.reshape(-1)
            gen = torch.Generator(device=dev).manual_seed(4)
            t1 = time.perf_counter()
            if loss_name == "lsh_ce":
                sp, aux, plan = losses.lsh_estimator_plan(
                    state.index, h, lab, gen, l=pc.l, cand_cap=pc.head_cap)
            else:
                (sp, aux), plan = losses.estimator_plan(
                    state.index, h, lab, gen, n_probe=pc.n_probe, l=pc.l,
                    head_cap=pc.head_cap), None
            torch.cuda.synchronize()
            plan_ms = (time.perf_counter() - t1) * 1e3
            chk = sparse_ce_checks(torch, loss_name, h, w, sp, plan)
            log(f"{loss_name} sparse CE at step 1's inputs: T {t}, head "
                f"columns scored {chk['head_cols']} (union "
                f"{int(aux['head_live'])}, k_eff mean "
                f"{aux['k_eff'].item():.1f}), tail {pc.l}, dw rows touched "
                f"{chk['rows']} of {chk['allowed']} allowed (head, tail, "
                f"labels) of V {w.shape[0]}, the rest exactly 0; nll/log Z "
                f"off float64 {chk['fwd_err']:.3e} of 1 + |value|; dh "
                f"{chk['dh']:.3e}, dw {chk['dw']:.3e} of sum |terms| in "
                f"f32 (bf16 after the cast: {chk['dh_cast']:.3e}, "
                f"{chk['dw_cast']:.3e}); two calls bit-equal; plan "
                f"{plan_ms:.2f} ms wall, forward {chk['fwd_ms']:.2f} ms, "
                f"backward {chk['bwd_ms']:.2f} ms (CUDA events)"
                + (f"; every row in exactly one of head, tail population, "
                   f"label term (mean head rows a token "
                   f"{chk['lsh_head_rows_mean']:.1f})"
                   if plan is not None else "") + f" [{card}]")
            del hidden, h, w, sp, plan
            torch.cuda.empty_cache()
        draw_source = None
        if loss_name in ("nce", "sampled"):
            # one noise draw for both steps, so the objective is fixed and
            # its value on the repeated batch must fall
            noise = torch.randint(0, cfg.vocab, (t, tcfg.nce_noise),
                                  generator=torch.Generator(device=dev)
                                  .manual_seed(5), device=dev)
            draw_source = lambda s, i: noise  # noqa: E731
        step = make_train_step(model, tcfg, draw_source=draw_source)
        refresh = make_index_refresh(model, tcfg) \
            if loss_name in ("mimps_ce", "lsh_ce") else None
        vals, walls, devs = [], [], []
        for i in range(n_steps):
            if refresh is not None and i == 2:
                shapes = [tuple(x.shape) if torch.is_tensor(x) else x
                          for x in state.index]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, rm = refresh(state)
                torch.cuda.synchronize()
                ref_s = time.perf_counter() - t1
                check(shapes == [tuple(x.shape) if torch.is_tensor(x) else x
                                 for x in state.index],
                      f"{loss_name}: the refresh changed the index's shapes")
                churn, drift = rm["churn"].item(), rm["drift"].item()
                check(math.isfinite(churn) and math.isfinite(drift),
                      f"{loss_name}: refresh churn {churn} drift {drift}")
                log(f"{loss_name} refresh between steps 2 and 3: "
                    f"{ref_s:.3f} s wall, churn {churn:.4f}, drift "
                    f"{drift:.4e}, index shapes kept [{card}]")
            state, m, wall, dms, counts = timed_step(step, state)
            check(not counts, f"{loss_name} step {i} launched {counts}; the "
                  f"estimator losses run no kernel of the nine")
            loss = m["loss_total"].item()
            check(math.isfinite(loss), f"{loss_name} step {i}: loss {loss}")
            vals.append(loss)
            walls.append(wall)
            devs.append(dms)
            extra = ""
            if "head_live" in m:
                extra = (f", head_live {int(m['head_live'])}, head_hit_rate "
                         f"{m['head_hit_rate'].item():.4f}, k_eff "
                         f"{m['k_eff'].item():.1f}")
            log(f"train {loss_name} step {i}: loss {loss:.6f}, grad norm "
                f"{m['grad_norm'].item():.4f}, {wall:.1f} ms wall, "
                f"{dms:.1f} ms CUDA events, {t / wall * 1e3:.1f} tokens/s"
                f"{extra} [{card}]")
        check(vals[-1] < vals[0], f"{loss_name}: loss did not fall: {vals}")
        peak = torch.cuda.max_memory_allocated()
        summary[loss_name] = (statistics.median(walls[1:]),
                              statistics.median(devs[1:]), peak)
        log(f"train {loss_name}: {n_steps} steps of {t} tokens, init "
            f"(parameters, moments{', index' if refresh else ''}) "
            f"{init_s:.2f} s, steady {summary[loss_name][0]:.1f} ms wall / "
            f"{summary[loss_name][1]:.1f} ms CUDA events a step (median of "
            f"steps 2-{n_steps}), {t / summary[loss_name][0] * 1e3:.1f} "
            f"tokens/s, peak {peak / 1e9:.2f} GB [{card}]")
        if loss_name == "mimps_ce":
            est_parts(torch, card, model, state, tcfg, batch)
            fstep = make_train_step(model, TrainConfig(loss="fused_ce",
                                                       warmup_steps=1))
            fw = []
            for i in range(2):
                state, m, wall, dms, counts = timed_step(fstep, state)
                check(counts == {"fused_ce_fwd": 1, "fused_ce_bwd": 1},
                      f"fused_ce step {i} in the estimator phase launched "
                      f"{counts}")
                for rec in ce_records:
                    rec["launches"] += 1
                fw.append((wall, dms))
            log(f"train fused_ce on the mimps_ce state (this phase's "
                f"yardstick): {fw[-1][0]:.1f} ms wall, {fw[-1][1]:.1f} ms "
                f"CUDA events, {t / fw[-1][0] * 1e3:.1f} tokens/s; mimps_ce "
                f"{summary['mimps_ce'][0]:.1f} / {summary['mimps_ce'][1]:.1f} "
                f"ms [{card}]")
        del state, step, refresh
        gc.collect()
        torch.cuda.empty_cache()
    log(f"estimator training phase: {time.time() - t_phase:.1f} s [{card}]")


def est_parts(torch, card, model, state, tcfg, batch):
    """One mimps_ce step split into forward, loss (plan + sparse CE
    forward), backward and optimizer: wall ms with a synchronise after each
    part beside CUDA-event ms. The step's update is kept."""
    from repro_torch.train import adamw_update, losses
    from repro_torch.train.optimizer import tree_leaves
    cfg = model.cfg
    pc = cfg.partition
    leaves = tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    walls = []

    def part(i, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[i].record()
        out = fn()
        events[i + 1].record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    hidden, _ = part(0, lambda: model.forward(state.params, batch["tokens"]))
    nll = part(1, lambda: losses.estimator_ce(
        state.index, hidden.reshape(-1, cfg.d_model),
        model.head_matrix(state.params), batch["labels"].reshape(-1),
        state.rng, n_probe=pc.n_probe, l=pc.l, head_cap=pc.head_cap)[0])
    loss = nll.mean()
    grads = part(2, lambda: torch.autograd.grad(loss, leaves))
    part(3, lambda: adamw_update(tcfg, state.params, grads, state.opt))
    del grads, hidden, nll, loss
    for i, name in enumerate(("forward", "loss", "backward", "optimizer")):
        log(f"train mimps_ce step part {name}: wall {walls[i]:.3f} ms, "
            f"device {events[i].elapsed_time(events[i + 1]):.3f} ms [{card}]")


def checkpoint_round_trip(torch, card):
    """Phase 7c: ``CheckpointManager`` on the card, on the reduced qwen1.5-4b
    config (a full-width state is about 40 GB of disk a save), for mimps_ce
    and lsh_ce: 2 steps, save (the index and the generator in the state),
    restore: every leaf equal to the saved state bit for bit. Then step 3
    from two restored copies: if the two are bit-equal (the step is
    reproducible), step 3 of the uninterrupted run must equal them bit for
    bit; if not, where they first differ is logged."""
    import shutil
    import tempfile
    from repro_torch.configs import TrainConfig, reduced_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.models import Model
    from repro_torch.train import (CheckpointManager, init_train_state,
                                   make_train_step)
    from repro_torch.train.checkpoint import _flatten, config_fingerprint

    t_phase = time.time()
    dev = torch.device("cuda")
    cfg = reduced_config("qwen1.5-4b")
    model = Model(cfg)

    def first_diff(a, b):
        for k, x in _flatten(a).items():
            y = _flatten(b)[k]
            if isinstance(x, torch.Generator):
                same = torch.equal(x.get_state(), y.get_state())
            elif torch.is_tensor(x):
                same = x.dtype == y.dtype and x.device == y.device and \
                    torch.equal(x, y)
            else:
                same = type(x) is type(y) and x == y
            if not same:
                return k
        return None

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
    try:
        for loss_name in ("mimps_ce", "lsh_ce"):
            tcfg = TrainConfig(loss=loss_name, warmup_steps=1, lr=1e-3)
            state = init_train_state(model, tcfg, seed=0, device=dev)
            step = make_train_step(model, tcfg)
            it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), 4, 32)
            batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                        zip(("tokens", "labels"), next(it))}
                       for _ in range(3)]
            for b in batches[:2]:
                state, _ = step(state, b)
            mgr = CheckpointManager(f"{tmp}/{loss_name}", keep=2)
            fp = config_fingerprint(cfg, tcfg)
            t0 = time.perf_counter()
            mgr.save(2, state, config=fp, data_state={"step": 2})
            mgr.wait()
            save_ms = (time.perf_counter() - t0) * 1e3
            copies = []
            for _ in range(2):
                r, manifest = mgr.restore(None, like=state, config=fp)
                diff = first_diff(state, r)
                check(diff is None, f"checkpoint {loss_name}: restored {diff} "
                      f"differs from the saved state")
                copies.append(r)
            a, ma = step(copies[0], batches[2])
            b, mb = step(copies[1], batches[2])
            torch.cuda.synchronize()
            repro = first_diff(a, b)
            u, mu = step(state, batches[2])
            resumed = first_diff(u, a)
            if repro is None:
                check(resumed is None, f"checkpoint {loss_name}: step 3 after "
                      f"the restore differs from the uninterrupted step 3 "
                      f"first at {resumed}")
                verdict = ("step 3 reproducible; after the restore bit-equal "
                           "to the uninterrupted step 3")
            else:
                verdict = (f"step 3 not reproducible: two runs first differ "
                           f"at {repro}; the restored run against the "
                           f"uninterrupted one first at {resumed}, losses "
                           f"{mu['loss_total'].item():.9f} / "
                           f"{ma['loss_total'].item():.9f}")
            log(f"checkpoint {loss_name} (reduced qwen1.5-4b: d "
                f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.n_layers} layers; "
                f"{len(manifest['keys'])} arrays, index "
                f"{type(state.index).__name__}, generator on {dev}): save "
                f"{save_ms:.1f} ms, restore bit-equal to the saved state "
                f"(twice); {verdict} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"checkpoint phase: {time.time() - t_phase:.1f} s [{card}]")


def f32_phase(torch, card, kernels):
    """Phase 8: qwen1.5-4b at full width in f32 (d 2560, 20 heads of 128,
    d_ff 6912, vocab 151936), depth cut to F32_LAYERS, the one cut. Each
    serving method builds its engine (the fmbe build timed, its fmbe_phi
    launches all f32) and takes one decode step through the captured
    ``generate`` with the launch counts at 0, bit-equal to the host loop's;
    each kernel of its path must launch, and only at f32. Each kernel is held to its plain version at f32 at the path's
    shapes, under the bf16 phases' limits. Then F32_STEPS ``fused_ce``
    train steps, one f32 launch of each CE kernel a step, and the f32 CE
    pair against its plain versions (nll/lse to 1e-3, dh and dW to
    F32_GRAD_REL of the sum of their terms). Returns the f32 records,
    named ``<kernel>[f32]``, with the launches of this phase's main path
    runs."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.decode import make_plan
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import fmbe_phi
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    from repro_torch.train import init_train_state, make_train_step

    tag = "[f32]"
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen1.5-4b"), dtype="float32",
                              n_layers=F32_LAYERS)
    pc = cfg.partition
    k = pc.sample_k
    t0 = time.time()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"f32 model: {cfg.name} layers {cfg.n_layers} (cut from "
        f"{get_config('qwen1.5-4b').n_layers}) d {cfg.d_model} heads "
        f"{cfg.n_heads} x {cfg.d_model // cfg.n_heads} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab} {cfg.dtype}, {n_params / 1e9:.3f} B params, init "
        f"{time.time() - t0:.1f} s")
    totals = {name: 0 for name in kernels}
    records = {}
    floor = floor_ms(torch)
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (N_REQ, 1), generator=gen,
                           device=dev)
    h = None
    assign = None
    for method in SERVE_METHODS:
        mcfg = dataclasses.replace(cfg, partition=dataclasses.replace(
            pc, method=method))
        _build.reset_counts(kernels.values())
        t0 = time.time()
        eng = Engine(Model(mcfg), params, 1, seed=1, index_assign=(
            assign if method in ("topk", "mince", "fmbe") else None))
        torch.cuda.synchronize()
        secs = time.time() - t0
        build = {name: fn.launches for name, fn in kernels.items()}
        check(all(fn.by_variant["bf16"] == 0 for fn in kernels.values()),
              f"{method} f32 build launched a bf16 kernel")
        if method == "fmbe":
            check(fmbe_phi.by_variant["f32"] == build["fmbe_phi"] > 0,
                  f"the f32 fmbe build ran fmbe_phi {fmbe_phi.by_variant}")
            log(f"f32 fmbe build: {secs:.3f} s with fmbe_phi launches "
                f"{fmbe_phi.by_variant} [{card}]")
        if method == "mimps":
            assign = eng.index.assign
        if h is None:                      # the step's hidden states
            cache = eng.model.init_decode_state(N_REQ, 1, dev)
            h = eng.model.decode_step(params, cache, prompt[:, 0], 0)
            check(h.dtype == torch.float32, f"f32 trunk gave {h.dtype}")
            log(f"f32 hidden states: Q {h.shape[0]}, |h|_2 mean "
                f"{h.norm(dim=-1).mean().item():.2f}")
        path = {}

        def path_run(fn):
            _build.reset_counts(kernels.values())
            res = fn()
            path.update({name: (fn_.launches, dict(fn_.by_variant))
                         for name, fn_ in kernels.items()})
            return res

        (out, aux, secs), (_, _, host_secs) = served_pair(
            torch, eng, prompt, 1, f"f32 serve {method}", wrap=path_run)
        check(eng.captures == 1, f"f32 {method}: {eng.captures} captures")
        counts = {name: c for name, (_, c) in path.items()}
        check(out.shape == (N_REQ, 1), f"f32 {method}: tokens {out.shape}")
        check(bool(torch.isfinite(aux["log_z"]).all()),
              f"f32 {method}: log_z not finite")
        for name in PATH_KERNELS[method]:
            check(counts[name]["f32"] > 0 and counts[name]["bf16"] == 0,
                  f"f32 {method}: {name} launched {counts[name]}, want f32 "
                  f"only")
        for name, (n, _) in path.items():
            totals[name] += n + build[name]
        log(f"f32 serve {method}: one decode step of {N_REQ} requests, "
            f"captured (warm-up step, capture, replay) {secs * 1e3:.1f} ms, "
            f"host loop {host_secs * 1e3:.1f} ms, bit-equal, log_z "
            f"{aux['log_z'][:, 0].tolist()}, "
            f"launches by dtype "
            f"{ {n: c for n, c in counts.items() if c['f32'] or c['bf16']} } "
            f"[{card}]")
        # the path's kernels against their plain versions at f32
        if method == "exact":
            records["topk_z"] = topk_z_phase(torch, card, h, eng.state.w, k,
                                             tag)
        elif method == "mimps":
            plan = make_plan(eng.index, h, pc.n_probe, pc.l, generator=gen)
            records["ivf_decode"] = ivf_decode_phase(
                torch, card, eng.index, h, plan, pc, k, tag)
            rec = ivf_score_phase(torch, card, kernels, eng.index, h, plan,
                                  tag)
            variants = kernels["ivf_score"].by_variant
            check(variants["f32"] == rec["path_launches"],
                  f"ops.ivf_block_scores ran {variants}")
            totals["ivf_score"] += rec.pop("path_launches")
            records["ivf_score"] = rec
        elif method == "topk":
            plan = make_plan(eng.index, h, pc.n_probe, pc.l, generator=gen)
            records["union_scores"] = union_scores_phase(
                torch, card, eng.index, h, plan, tag)
        elif method == "fmbe":
            plan = make_plan(eng.index, h, pc.n_probe, pc.l, generator=gen)
            fstate = eng.state.fmbe
            deg_sum = int(fstate.fm.degree.sum())
            records["fmbe_z"] = fmbe_z_phase(torch, card, fstate.fm, fstate,
                                             h, plan, deg_sum, tag)
            records["fmbe_phi"] = fmbe_phi_f32(torch, card, fstate, eng.index,
                                               deg_sum)
        elif method == "lsh":
            records["lsh_probe"] = lsh_probe_phase(
                torch, card, eng.state.lsh, eng.state.w, h, pc, k, gen, tag)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    # -- training at f32 ------------------------------------------------------
    model = Model(cfg)
    state = init_train_state(model, TrainConfig(), seed=0, device=dev)
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), TRAIN_B, TRAIN_S)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in next(it))
    batch = {"tokens": tokens, "labels": labels}
    step = make_train_step(model, TrainConfig(loss="fused_ce",
                                              warmup_steps=1))
    for i in range(F32_STEPS):
        _build.reset_counts(kernels.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {n: dict(kernels[n].by_variant)
                  for n in ("fused_ce_fwd", "fused_ce_bwd")}
        check(all(c == {"bf16": 0, "f32": 1} for c in counts.values()),
              f"f32 fused_ce step {i} launched {counts}, want one f32 each")
        for name in counts:
            totals[name] += 1
        loss = metrics["loss_total"].item()
        check(math.isfinite(loss), f"f32 fused_ce step {i}: loss {loss}")
        log(f"f32 train fused_ce step {i}: loss {loss:.6f}, grad norm "
            f"{metrics['grad_norm'].item():.4f}, {ms:.1f} ms, B {TRAIN_B} x "
            f"S {TRAIN_S}, depth {cfg.n_layers} [{card}]")
    with torch.no_grad():
        hidden, _ = model.forward(state.params, tokens)
    records.update(ce_f32_phase(torch, card, hidden.reshape(-1, cfg.d_model),
                                model.head_matrix(state.params).detach(),
                                labels.reshape(-1)))
    del state, hidden
    torch.cuda.empty_cache()
    out = []
    for name in kernels:
        rec = records[name]
        rec["launches"] = totals[name]
        if "graph10_ms" in rec:                   # a decode kernel
            rec["floor_ms"] = floor
        out.append(rec)
    return out


def fmbe_phi_f32(torch, card, fstate, index, deg_sum):
    """``fmbe_phi`` at f32 (the tensor-core kernel on three exact bf16
    planes of x) on the f32 build's first chunk: against ``fmbe_phi_plain``
    (the limit), against ``fmbe_phi_planes_plain`` (the kernel's
    decomposition, the same limit) and against float64 (logged, beside the
    plain version's own error), two calls bit-equal, its split of x equal to
    ``split_planes`` bit for bit. Times it beside its bound for the bf16
    operations it issues and the f32-core bound, the plain version, the
    product alone in full f32 (``torch.matmul(x, pack.rows.float().T)``,
    the yardstick as at bf16) and the whole sketch (``build_fmbe_blocks``,
    host clock). Returns the record."""
    from repro_torch.core.feature_maps import build_fmbe_blocks
    from repro_torch.kernels.fmbe import (fmbe_pack, fmbe_phi,
                                         fmbe_phi_planes_plain,
                                         fmbe_phi_plain, phi_launch)
    from repro_torch.kernels.fused_ce import split_planes
    fm = fstate.fm
    nbc, d = PHI_CHUNK_BLOCKS, index.v_blocks.shape[-1]
    x = index.v_blocks[:nbc].reshape(-1, d)
    rows, n_feat = x.shape[0], fm.omega.shape[0]
    pack = fmbe_pack(fm.omega, fm.degree, fm.coef)
    pargs = (fm.omega, fm.degree, fm.coef, x)
    phi = fmbe_phi(*pargs, pack=pack)
    again = fmbe_phi(*pargs, pack=pack)
    torch.cuda.synchronize()
    check(torch.equal(phi, again), "fmbe_phi[f32] is not bit-reproducible")
    del again
    # the split of x: planes of the chunk's rows, zeros past d
    _, planes = phi_launch(pack, x)
    torch.cuda.synchronize()
    for q, plane in enumerate(split_planes(x)):
        check(torch.equal(planes[q, :, :d].view(torch.int16),
                          plane.view(torch.int16))
              and not planes[q, :, d:].any(),
              f"fmbe_phi[f32]: split plane {q} of x differs from "
              f"split_planes")
    del planes
    norm = x.norm(dim=-1).clamp(min=1.0)
    scale = fm.coef.abs()[None, :] * norm[:, None] ** fm.degree[None, :]
    ratios = {}
    for name, want in (("plain", fmbe_phi_plain(*pargs)),
                       ("planes", fmbe_phi_planes_plain(pack, x))):
        err = (phi - want).abs()
        ratios[name] = (err / (FMBE_REL * (want.abs() + scale))).max().item()
        check(ratios[name] <= 1.0, f"fmbe_phi[f32] vs {name}: error "
              f"{err.max().item():.3e} is {ratios[name]:.3f} of the "
              f"tolerance")
        if name == "plain":
            p_phi, max_err = want, err.max().item()
        del err, want
    # float64 from the same f32 rows: the kernel's and the plain version's
    proj64 = x.double() @ pack.rows.double().T
    want = torch.ones_like(phi, dtype=torch.float64)
    for m in range(fm.omega.shape[1]):
        use = pack.degree > m
        col = torch.where(use, pack.start + m, 0).long()
        want = torch.where(use[None, :], want * proj64[:, col], want)
    want = want * pack.coef.double()
    size = FMBE_REL * (want.abs() + scale.double())
    r64 = {name: ((got.double() - want).abs() / size).max().item()
           for name, got in (("kernel", phi), ("plain", p_phi))}
    del proj64, want, size, phi, p_phi
    n_bytes = deg_sum * d * 2 + n_feat * 8 + rows * d * 4 + rows * n_feat * 4
    macs = rows * deg_sum * d
    bound, by = bound_ms(n_bytes, 3 * 2 * macs)
    core_bound, _ = bound_ms(n_bytes, 0, f32_ops=2 * macs)
    rec = dict(name="fmbe_phi[f32]", route="cuda",
               source="src/repro_torch/kernels/csrc/fmbe_phi_wgmma.cu",
               replaces="src/repro/kernels/fmbe.py:89",
               max_abs_err=max_err, max_err_over_tol=ratios["plain"],
               planes_plain_err_over_tol=ratios["planes"],
               float64_err_over_tol=r64["kernel"],
               plain_float64_err_over_tol=r64["plain"],
               ms=time_ms(torch, lambda: fmbe_phi(*pargs, pack=pack)),
               plain_ms=time_ms(torch, lambda: fmbe_phi_plain(*pargs),
                                reps=5),
               bound_ms=bound, bound_by=by, f32_core_bound_ms=core_bound,
               library_ms=time_ms(torch, lambda: torch.matmul(
                   x, pack.rows.float().T)),
               library_call="torch.matmul(x, pack.rows.float().T), f32 "
               "without TF32: the projections alone, not phi")
    rec["sketch_ms"] = wall_ms(torch, lambda: build_fmbe_blocks(
        fm, index.v_blocks, index.valid, pack=pack), reps=3)
    log(f"fmbe_phi[f32]: {rows} rows x P {n_feat}, f32 x as three bf16 "
        f"planes on the tensor cores: max abs err {max_err:.3e} = "
        f"{ratios['plain']:.4f} of the tolerance against the plain version, "
        f"{ratios['planes']:.4f} against the plane decomposition; against "
        f"float64 {r64['kernel']:.4g} of the tolerance (plain f32 "
        f"{r64['plain']:.4g}); two calls bit-equal, split of x equal to "
        f"split_planes; kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, torch.matmul(x, pack.T) in f32 "
        f"{rec['library_ms']:.4f} ms (yardstick, no phi), bound "
        f"{bound:.4f} ms ({by}, {3 * 2 * macs / 1e12:.3f} TFLOP of bf16 "
        f"issued), f32-core bound {core_bound:.4f} ms; the whole sketch "
        f"(build_fmbe_blocks, host clock) {rec['sketch_ms']:.3f} ms "
        f"[{card}]")
    return rec


def forward64(torch, h, w, lab, block=256):
    """nll and lse in float64 from f32 h and w, a block of tokens at a
    time; a label outside [0, V) leaves the label score at NEG."""
    w64 = w.double()
    v = w.shape[0]
    lse = torch.empty(h.shape[0], dtype=torch.float64, device=h.device)
    picked = torch.full_like(lse, -1e30)
    for t0 in range(0, h.shape[0], block):
        s = slice(t0, t0 + block)
        logits = h[s].double() @ w64.T
        lse[s] = torch.logsumexp(logits, -1)
        ok = (lab[s] >= 0) & (lab[s] < v)
        got = logits.gather(1, lab[s].long().clamp(0, v - 1)[:, None])[:, 0]
        picked[s] = torch.where(ok, got, picked[s])
        del logits
    return lse - picked, lse


def ce_f32_phase(torch, card, h, w, lab):
    """The f32 fused CE kernels against their plain versions on the f32
    model's hidden states: nll and lse to 1e-3 (against
    ``fused_ce_fwd_plain`` and against ``fused_ce_fwd_planes_plain``, the
    forward's three-plane decomposition) and to F32_FWD_REL of 1 + |value|
    against float64 (the plain f32 version's error logged beside), the
    forward's split of h and w equal to ``split_planes`` bit for bit, dh
    and dW (f32) to
    F32_GRAD_REL of the sum of their terms' magnitudes per element and
    F32_GRAD_MEAN on average, against ``fused_ce_bwd_plain`` and against
    ``fused_ce_bwd_chunked_plain`` (the backward's three-plane chunked
    decomposition), and in three token slices (the route of T above
    F32_MAX_DEPTH), two calls bit-equal; the backward's split kernel equal
    to ``split_planes`` bit for bit on h and on the last (ragged) chunk of
    w. Times the forward beside its bound at the bf16 rate for the 12 T V d
    operations it issues and the f32-rate bound of its 2 T V d of f32 work,
    and the backward beside its bound for the 36 T V d operations it issues
    and the f32-rate bound of its 6 T V d, the backward's split kernel
    alone, plain versions and library calls (cuBLAS in full f32); profiles
    both by kernel. Returns the two records."""
    from repro_torch.configs import TrainConfig
    from repro_torch.kernels.fused_ce import (PAIRS, bwd_launch,
                                             bwd_schedule, ce_coef,
                                             fused_ce_bwd,
                                             fused_ce_bwd_chunked_plain,
                                             fused_ce_bwd_plain, fused_ce_fwd,
                                             fused_ce_fwd_planes_plain,
                                             fused_ce_fwd_plain, fwd_launch,
                                             planes_launch, split_planes)
    t, d = h.shape
    v = w.shape[0]
    nll, lse = fused_ce_fwd(h, w, lab)
    nll2, lse2 = fused_ce_fwd(h, w, lab)
    torch.cuda.synchronize()
    check(torch.equal(nll, nll2) and torch.equal(lse, lse2),
          "fused_ce_fwd[f32] is not bit-reproducible")
    del nll2, lse2
    f_errs = {}
    for name, plain in (("plain", fused_ce_fwd_plain),
                        ("planes", fused_ce_fwd_planes_plain)):
        p_nll, p_lse = plain(h, w, lab)
        f_errs[name] = max((nll - p_nll).abs().max().item(),
                           (lse - p_lse).abs().max().item())
        check(f_errs[name] <= TOL, f"fused_ce_fwd[f32]: nll/lse differ from "
              f"the {name} version by {f_errs[name]}")
        if name == "plain":
            plain_out = (p_nll, p_lse)
        del p_nll, p_lse
        torch.cuda.empty_cache()
    f_err = f_errs["plain"]
    want = forward64(torch, h, w, lab)
    f64 = {}
    for name, got in (("kernel", (nll, lse)), ("plain", plain_out)):
        f64[name] = max(((g.double() - x).abs() / (1 + x.abs())).max().item()
                        for g, x in zip(got, want))
    check(f64["kernel"] <= F32_FWD_REL, f"fused_ce_fwd[f32]: nll/lse "
          f"{f64['kernel']:.3e} of 1 + |value| from float64, allowed "
          f"{F32_FWD_REL}")
    del want, plain_out
    # the forward's split: h and all of w, as split_planes gives them
    _, _, fwd_planes = fwd_launch(h, w, lab)
    torch.cuda.synchronize()
    for name, x, got in (("h", h, fwd_planes[0]), ("w", w, fwd_planes[1])):
        for q, plane in enumerate(split_planes(x)):
            check(torch.equal(got[q, :, :d].view(torch.int16),
                              plane.view(torch.int16))
                  and not got[q, :, d:].any(),
                  f"fused_ce_fwd[f32]: split plane {q} of {name} differs "
                  f"from split_planes")
            del plane
    del fwd_planes
    torch.cuda.empty_cache()
    log(f"fused_ce_fwd[f32]: nll/lse {f_errs['plain']:.3e} from the plain "
        f"version, {f_errs['planes']:.3e} from the plane decomposition; "
        f"{f64['kernel']:.3e} of 1 + |value| from float64 (plain f32 "
        f"{f64['plain']:.3e}); its split planes of h and w equal "
        f"split_planes bit for bit")
    # the backward's split kernel: h, and the last chunk of w (rows past V
    # are zeros)
    sch = bwd_schedule(t, v, torch.float32)
    c, c0 = sch["chunk"], (sch["n_chunks"] - 1) * sch["chunk"]
    for name, x, rows in (("h", h, t), ("w chunk", w[c0:], c)):
        got = planes_launch(x, rows)
        torch.cuda.synchronize()
        want = torch.zeros_like(got)
        for q, plane in enumerate(split_planes(x)):
            want[q, :x.shape[0], :d] = plane
        check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
              f"fused_ce_bwd[f32]: split kernel planes of {name} differ from "
              f"split_planes")
        del got, want
    log(f"fused_ce_bwd[f32] split kernel: planes of h ({t} rows) and of the "
        f"last chunk of w ({v - c0} rows into {c}) equal split_planes bit "
        f"for bit")
    g_nll = torch.full((t,), 1.0 / t, device=h.device)
    g_lse = 2 * TrainConfig().selfnorm_alpha * lse / t
    bargs = (h, w, lab, lse, g_nll, g_lse)
    dh, dw = fused_ce_bwd(*bargs)
    dh2, dw2 = fused_ce_bwd(*bargs)
    torch.cuda.synchronize()
    check(torch.equal(dh, dh2) and torch.equal(dw, dw2),
          "fused_ce_bwd[f32] is not bit-reproducible")
    del dh2, dw2
    coef = ce_coef(*bargs).abs()
    dh_terms, dw_terms = coef @ w.abs(), coef.T @ h.abs()
    del coef
    p_dh, p_dw = fused_ce_bwd_plain(*bargs)
    dh_err = compare_terms("fused_ce_bwd[f32] dh", dh, p_dh, dh_terms,
                           F32_GRAD_REL, F32_GRAD_MEAN)
    dw_err = compare_terms("fused_ce_bwd[f32] dw", dw, p_dw, dw_terms,
                           F32_GRAD_REL, F32_GRAD_MEAN)
    # the route of T > F32_MAX_DEPTH: token slices whose dW add up in f32,
    # here three slices of T / 3 (launches not counted)
    s_dh, s_dw = bwd_launch(*bargs, depth=-(-t // 3))
    sdh_err = compare_terms("fused_ce_bwd[f32] dh in 3 token slices", s_dh,
                            p_dh, dh_terms, F32_GRAD_REL, F32_GRAD_MEAN)
    sdw_err = compare_terms("fused_ce_bwd[f32] dw in 3 token slices", s_dw,
                            p_dw, dw_terms, F32_GRAD_REL, F32_GRAD_MEAN)
    log(f"fused_ce_bwd[f32] in 3 token slices: dh max {sdh_err[1]:.3e} "
        f"(mean {sdh_err[2]:.3e}), dW max {sdw_err[1]:.3e} (mean "
        f"{sdw_err[2]:.3e}) of sum |terms| against the plain version")
    del p_dh, p_dw, s_dh, s_dw
    c_dh, c_dw = fused_ce_bwd_chunked_plain(*bargs)
    cdh_err = compare_terms("fused_ce_bwd[f32] dh vs chunked plain", dh, c_dh,
                            dh_terms, F32_GRAD_REL, F32_GRAD_MEAN)
    cdw_err = compare_terms("fused_ce_bwd[f32] dw vs chunked plain", dw, c_dw,
                            dw_terms, F32_GRAD_REL, F32_GRAD_MEAN)
    del c_dh, c_dw, dh_terms, dw_terms, dh, dw
    torch.cuda.empty_cache()
    fwd_bytes = t * d * 4 + v * d * 4 + t * 4 + 2 * t * 4
    fwd_issued = len(PAIRS) * 2 * t * v * d     # bf16 operations issued
    fwd_bound, fwd_by = bound_ms(fwd_bytes, fwd_issued)
    fwd_core, _ = bound_ms(fwd_bytes, 0, f32_ops=2 * t * v * d)
    bwd_bytes = 2 * (t * d * 4 + v * d * 4) + 4 * t * 4
    n_issued = 6 * len(PAIRS) * t * v * d       # bf16 operations issued
    bwd_bound, bwd_by = bound_ms(bwd_bytes, n_issued)
    core_bound, _ = bound_ms(bwd_bytes, 0, f32_ops=6 * t * v * d)
    gn = g_nll + g_lse

    def library_fwd():
        logits = torch.matmul(h, w.T)
        lse_ = torch.logsumexp(logits, -1)
        return lse_ - logits.gather(1, lab.long()[:, None])[:, 0], lse_

    def library_bwd():
        coef_ = torch.softmax(torch.matmul(h, w.T), -1) * gn[:, None]
        coef_.scatter_add_(1, lab.long()[:, None], -g_nll[:, None])
        return coef_ @ w, coef_.T @ h

    fwd = dict(name="fused_ce_fwd[f32]", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_ce_fwd.cu",
               replaces="src/repro/kernels/fused_ce.py:128",
               max_abs_err=f_err, planes_plain_err=f_errs["planes"],
               float64_err_rel=f64["kernel"],
               plain_float64_err_rel=f64["plain"],
               ms=time_ms(torch, lambda: fused_ce_fwd(h, w, lab), reps=5),
               plain_ms=time_ms(torch, lambda: fused_ce_fwd_plain(h, w, lab),
                                reps=5),
               bound_ms=fwd_bound, bound_by=fwd_by,
               f32_core_bound_ms=fwd_core,
               library_ms=time_ms(torch, library_fwd, reps=5))
    fwd["tflops_f32_work"] = 2 * t * v * d / fwd["ms"] / 1e9
    fwd["tflops_issued"] = fwd_issued / fwd["ms"] / 1e9
    split_h = time_ms(torch, lambda: planes_launch(h), reps=10)
    split_chunk = time_ms(torch, lambda: planes_launch(w[:c], c), reps=10)
    bwd = dict(name="fused_ce_bwd[f32]", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_ce_bwd.cu",
               replaces="src/repro/kernels/fused_ce.py:169",
               max_abs_err=max(dh_err[0], dw_err[0]),
               max_err_over_sum_terms=max(dh_err[1], dw_err[1]),
               ms=time_ms(torch, lambda: fused_ce_bwd(*bargs), reps=5),
               plain_ms=time_ms(torch, lambda: fused_ce_bwd_plain(*bargs),
                                reps=3),
               bound_ms=bwd_bound, bound_by=bwd_by,
               f32_core_bound_ms=core_bound,
               split_ms=split_h + sch["n_chunks"] * split_chunk,
               split_h_ms=split_h, split_chunk_ms=split_chunk,
               library_ms=time_ms(torch, library_bwd, reps=3))
    bwd["tflops_f32_work"] = 6 * t * v * d / bwd["ms"] / 1e9
    bwd["tflops_issued"] = n_issued / bwd["ms"] / 1e9
    log(f"fused_ce_fwd[f32]: T {t} V {v} d {d}, three bf16 planes, "
        f"{len(PAIRS)} plane pairs: nll/lse err {f_err:.2e}, two calls "
        f"bit-equal; kernel {fwd['ms']:.4f} ms "
        f"({fwd['tflops_f32_work']:.1f} TFLOP/s of f32 work, "
        f"{fwd['tflops_issued']:.1f} TFLOP/s of bf16 issued), plain "
        f"{fwd['plain_ms']:.4f} ms, library {fwd['library_ms']:.4f} ms, "
        f"bound {fwd_bound:.4f} ms ({fwd_by}, {fwd_issued / 1e12:.3f} TFLOP "
        f"bf16 at {BF16_FLOPS / 1e12:.0f} TFLOP/s; f32-core bound "
        f"{fwd_core:.4f} ms at {F32_FLOPS / 1e12:.0f} TFLOP/s) [{card}]")
    log(f"fused_ce_bwd[f32]: T {t} V {v} d {d}, g_lse = 2 alpha lse / T, "
        f"chunk C {c} ({sch['n_chunks']} chunks), three bf16 planes, "
        f"{len(PAIRS)} plane pairs: dh err {dh_err[0]:.2e} (max "
        f"{dh_err[1]:.3e}, mean {dh_err[2]:.3e} of sum |terms|), dW err "
        f"{dw_err[0]:.2e} (max {dw_err[1]:.3e}, mean {dw_err[2]:.3e}); "
        f"against the chunked plane decomposition dh max {cdh_err[1]:.3e} "
        f"(mean {cdh_err[2]:.3e}), dW max {cdw_err[1]:.3e} (mean "
        f"{cdw_err[2]:.3e}); two calls bit-equal; kernel {bwd['ms']:.4f} ms "
        f"({bwd['tflops_f32_work']:.1f} TFLOP/s of f32 work, "
        f"{bwd['tflops_issued']:.1f} TFLOP/s of bf16 issued), split "
        f"{bwd['split_ms']:.4f} ms a call (h {split_h:.4f} + "
        f"{sch['n_chunks']} x chunk {split_chunk:.4f}), plain "
        f"{bwd['plain_ms']:.4f} ms, library {bwd['library_ms']:.4f} ms, "
        f"bound {bwd_bound:.4f} ms ({bwd_by}, {n_issued / 1e12:.3f} TFLOP "
        f"bf16 at {BF16_FLOPS / 1e12:.0f} TFLOP/s; f32-core bound "
        f"{core_bound:.4f} ms) [{card}]")
    # device time by kernel: the forward's split, partial and merge; the
    # backward's split, coefficient and gradients
    reps = 2
    for name, fn in (("fused_ce_fwd[f32]", lambda: fused_ce_fwd(h, w, lab)),
                     ("fused_ce_bwd[f32]", lambda: fused_ce_bwd(*bargs))):
        _, busy, dev_top, _ = profile_step(
            torch, lambda fn=fn: [fn() for _ in range(reps)])
        for kernel, calls, ms in dev_top:
            kernel = kernel.replace("(anonymous namespace)::", "").split(
                "(")[0]
            log(f"  launch {kernel[-40:]:40s} {calls / reps:4.0f} a call, "
                f"{ms / reps:.4f} ms a call [{card}]")
        log(f"  {name}: device busy {busy / reps:.4f} ms a call [{card}]")
    for name in ("fused_ce_fwd", "fused_ce_bwd"):
        for line in ptxas_report(_build_log(name)):
            log(f"  ptxas {name}: {line}")
    return {"fused_ce_fwd": fwd, "fused_ce_bwd": bwd}


def _build_log(name):
    from repro_torch.kernels import _build
    return _build.build_log.get(name, "")


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
