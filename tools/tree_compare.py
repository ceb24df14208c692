#!/usr/bin/env python3
"""Two checkouts of the repository on one GPU, in turns: the bits and times
of the bf16 kernels of the fused cross-entropy and of ``fmbe_phi``, the f32
route's times, and the bits and times of the decode kernels at both dtypes.

    python3 tools/tree_compare.py OTHER       # from the repository root

OTHER is the root of another checkout (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each run is a process of its own that imports ``repro_torch`` from one
checkout and builds its kernels there; the runs go OTHER, this, this,
OTHER. Every run makes the same inputs from seed 0:
  - the fused CE pair at the training shape of ``chip_smoke.py`` (T 1024
    tokens, qwen1.5-4b's V 151936 and d 2560): h ~ N(0, 1) and W drawn as
    ``Model.init`` draws the head (N(0, 1/V)), labels uniform;
    ``fused_ce_fwd`` and ``fused_ce_bwd`` (the cotangents of the mean nll
    and of a selfnorm penalty, dh and dW both cast to bf16 and not) at bf16
    and, timed only, at f32;
  - ``fmbe_phi`` on the FMBE build's chunk (16 blocks of 512 rows of W)
    against a map of 4096 features (``make_feature_map``, seed 0) and its
    pack, at bf16 and, timed only, at f32, and the whole f32 sketch of the
    build's 474 blocks (``build_fmbe_blocks``, host clock; W's rows, then
    masked padding);
  - the decode kernels at bf16 and at f32, on the first 8 rows of that h
    and rows of that W: ``topk_z`` (k 8) over all of W, also on the first
    16 rows of h (the traffic path's lanes, ``topk_z q16``) and, at bf16
    only, on 8 queries over a head at the VLM's width (V 128256, d 8192,
    drawn as ``Model.init`` draws it, ``topk_z d8192``); ``union_scores``
    over 23 live blocks of a 128-slot union of 474 blocks of 512 rows
    (drawn from W; the bf16 main path's union) and over 31 (the f32
    phase's), ``ivf_decode`` on the 23-block union (random membership,
    1000 tail rows, random acceptance, k 8) and ``ivf_score`` on 16 random
    blocks a query and on 16 of the 23-block union a query (blocks shared
    between queries, as on the main path); ``fmbe_z`` with that map and a
    random per-query lambda;
    ``lsh_probe`` (k 8, l 1000 tail samples drawn uniformly from seed 1)
    on the trimmed union of an 8 x 8-bit index of W and on the dense
    fallback;
  - the f32 train step of ``chip_smoke.py``'s f32 phase (qwen1.5-4b at 4
    layers, B 4 x S 256, ``fused_ce``), three steps on the host clock.
Each bf16 output, and each decode kernel's output at both dtypes, is
fingerprinted (SHA-256 of its bytes) and must be the same in all four
runs, but for the kernels in ``REDESIGNED`` (the ones a change redesigns,
named with the dtype's tag; none at present): their bits change by
design, so each run holds them to their plain versions instead (scores,
LSEs and top-k values to 1e-3, top ids where the neighbouring scores are
more than 1e-3 apart, signed FMBE sums to 1e-4 of the sum of their terms'
magnitudes, + 1e-6), and their fingerprints must agree within each tree.
A CE or ``fmbe_phi`` time is the median of 20 calls timed with CUDA
events after 3 to warm up; a decode kernel's is the median of 20 replays
of a CUDA graph of one call. Prints each measurement's four values in run
order with the card's name and power limit, whether each fingerprint is the same in all four runs, and writes
all of it to ``chiprun_out/tree_compare.json``.
"""
from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
T, V, D = 1024, 151936, 2560
BLOCKS, BLOCK_ROWS, CHUNK_BLOCKS = 474, 512, 16
N_FEATURES = 4096
# the decode kernels whose bits a change alters by design, as
# "<kernel><tag>" ("[f32]" for f32; set while it is compared with its
# parent)
REDESIGNED = ()
V_WIDE, D_WIDE = 128256, 8192            # llama-3.2-vision-90b's head


def events_ms(torch, fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
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


def wall_ms(torch, fn, reps=3):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def graph_ms(torch, fn, reps=20, warm=3):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return events_ms(torch, graph.replay, reps, warm=0)


def held(torch, name, res, plain, terms=None):
    """The largest error of a redesigned kernel's output ``res`` against
    its plain version's ``plain`` under the limits above; raises past
    them."""
    if name.startswith("fmbe_z"):
        err = (res.double() - plain.double()).abs()
        tol = 1e-4 * terms.double().abs().sum(-1) + 1e-6
        ratio = (err / tol).max().item()
        if ratio > 1.0:
            raise RuntimeError(f"{name}: {ratio:.3f} of its tolerance")
        return err.max().item()
    if name == "ivf_score":
        worst = (res - plain).abs().max().item()
        if worst > 1e-3:
            raise RuntimeError(f"{name}: off its plain version by {worst}")
        return worst
    *lses, tv, ti = res                  # (head_lse, tail_lse) or (lse,)
    *p_lses, p_v, p_i = plain
    worst = 0.0
    for got, want in zip(lses, p_lses):
        if not torch.equal(got.isneginf(), want.isneginf()):
            raise RuntimeError(f"{name}: -inf pattern differs")
        fin = ~want.isneginf()
        if fin.any():
            worst = max(worst, (got[fin] - want[fin]).abs().max().item())
    k = tv.shape[1]
    worst = max(worst, (tv - p_v[:, :k]).abs().max().item())
    if worst > 1e-3:
        raise RuntimeError(f"{name}: off its plain version by {worst}")
    gap_up = torch.cat([torch.full_like(p_v[:, :1], float("inf")),
                        p_v[:, :k - 1] - p_v[:, 1:k]], 1)
    gap_down = p_v[:, :k] - p_v[:, 1:k + 1]
    sure = (gap_up > 1e-3) & (gap_down > 1e-3)
    if not torch.equal(ti[sure], p_i[:, :k][sure]):
        raise RuntimeError(f"{name}: top ids differ where the gaps exceed "
                           f"1e-3")
    return worst


def decode_kernels(torch, out, h32, w32, fm, pack):
    """Bits and graph times of the decode kernels at both dtypes."""
    import inspect

    from repro_torch.core import lsh as tlsh
    from repro_torch.kernels.fmbe import fmbe_phi_plain, fmbe_z, fmbe_z_plain
    from repro_torch.kernels.ivf_score import (ivf_decode, ivf_decode_plain,
                                              ivf_score, ivf_score_plain,
                                              union_scores)
    from repro_torch.kernels.lsh_probe import lsh_probe
    from repro_torch.kernels.topk_z import topk_z, topk_z_plain
    dev = h32.device
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, nb, br, cap, live, n_tail = 8, 8, 474, 512, 128, 23, 1000
    blocks = torch.randint(0, V, (nb * br,), generator=gen, device=dev)
    ids = torch.sort(torch.randperm(nb, generator=gen, device=dev)[:31]
                     ).values
    head_ids = torch.cat([ids[:live], ids[live - 1:live].expand(cap - live)]
                         ).to(torch.int32)
    head_live = torch.tensor(live, dtype=torch.int32, device=dev)
    ids31 = torch.cat([ids, ids[-1:].expand(cap - 31)]).to(torch.int32)
    live31 = torch.tensor(31, dtype=torch.int32, device=dev)
    member = torch.rand(q, cap, generator=gen, device=dev) < 0.3
    row_logw = torch.zeros(nb, br, device=dev)
    tail = torch.randint(0, V, (n_tail,), generator=gen, device=dev)
    accept = torch.rand(q, n_tail, generator=gen, device=dev) < 0.9
    probes = torch.randint(0, nb, (q, 16), generator=gen, device=dev,
                           dtype=torch.int32)
    # 16 probes a query among the 23-block union, so queries share blocks
    # as the main path's mimps plan does (its own generator: the other
    # inputs stay as they were)
    shared = head_ids[torch.randint(0, live, (q, 16), device=dev,
                                    generator=torch.Generator(device=dev)
                                    .manual_seed(2))]
    lam = torch.randn(q, fm.omega.shape[0], generator=gen, device=dev)
    idx = tlsh.build_lsh_device(w32, generator=gen, device=dev)
    lsh_tail = torch.randint(0, V, (n_tail,), generator=gen, device=dev)
    plan = tlsh.lsh_plan(idx, h32[:q], n_tail, tail_ids=lsh_tail)
    if int(plan.cand_live) > plan.cand_rows.shape[0]:
        plan = tlsh.lsh_plan(idx, h32[:q], n_tail, tail_ids=lsh_tail,
                             cand_cap=int(plan.cand_live))
    # a tree whose fmbe_z reads the map's pack is given it
    zpack = ({"pack": pack}
             if "pack" in inspect.signature(fmbe_z).parameters else {})
    trimmed = (plan.cand_rows, plan.cand_live)
    dense = (torch.arange(V, dtype=torch.int32, device=dev),
             torch.tensor(V, dtype=torch.int32, device=dev))
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "[f32]")):
        h, w = h32[:q].to(dtype), w32.to(dtype)
        h16 = h32[:16].to(dtype)
        wb = w[blocks].reshape(nb, br, D)
        tail_rows = w[tail]
        runs = {
            "topk_z": lambda: topk_z(h, w, k),
            "topk_z q16": lambda: topk_z(h16, w, k),
            "union_scores": lambda: union_scores(wb, h, head_ids, head_live),
            "union_scores 31 blocks": lambda: union_scores(wb, h, ids31,
                                                           live31),
            "ivf_decode": lambda: ivf_decode(
                wb, h, head_ids, head_live, member, row_logw, tail_rows,
                accept, k=k),
            "ivf_score": lambda: ivf_score(wb, h, probes),
            "ivf_score 23 blocks": lambda: ivf_score(wb, h, shared),
            "fmbe_z": lambda: fmbe_z(fm.omega, fm.degree, fm.coef, lam, h,
                                     **zpack),
        }
        for label, (rows, col) in (("trimmed", trimmed), ("dense", dense)):
            runs[f"lsh_probe {label}"] = lambda rows=rows, col=col: lsh_probe(
                w, h, idx.proj, rows, col, idx.codes, idx.slot_of_row,
                plan.tail_ids, plan.tail_accept, plan.tail_bias, k=k)
        plains = {
            "topk_z": lambda: topk_z_plain(h, w, k + 1),
            "topk_z q16": lambda: topk_z_plain(h16, w, k + 1),
            "ivf_decode": lambda: ivf_decode_plain(
                wb, h, head_ids, head_live, member, row_logw, tail_rows,
                accept, k=k + 1),
            "fmbe_z": lambda: fmbe_z_plain(fm.omega, fm.degree, fm.coef,
                                           lam, h),
            "ivf_score": lambda: ivf_score_plain(wb, h, probes),
            "ivf_score 23 blocks": lambda: ivf_score_plain(wb, h, shared),
        }
        if dtype == torch.bfloat16:
            hw = torch.randn(q, D_WIDE, generator=gen, device=dev).to(dtype)
            ww = (torch.randn(V_WIDE, D_WIDE, generator=gen, device=dev)
                  * V_WIDE ** -0.5).to(dtype)
            runs["topk_z d8192"] = lambda: topk_z(hw, ww, k)
            plains["topk_z d8192"] = lambda: topk_z_plain(hw, ww, k + 1)
        # the first graph timed after the host-side set-up reads some 15%
        # slow (a second kernel timed right after it does not): warm first
        graph_ms(torch, runs["topk_z"])
        for name, fn in runs.items():
            res = fn()
            bits = digest(*(res if isinstance(res, tuple) else (res,)))
            kernel = name.split()[0]
            if f"{kernel}{tag}" in REDESIGNED:
                terms = (fmbe_phi_plain(fm.omega, fm.degree, fm.coef, h)
                         * lam if kernel == "fmbe_z" else None)
                out["held"][f"{name}{tag}"] = held(
                    torch, kernel, res, plains[name](), terms)
                out["redesigned_bits"][f"{name}{tag}"] = bits
            else:
                out["bits"][f"{name}{tag}"] = bits
            out["ms"][f"{name}{tag}"] = graph_ms(torch, fn)
        del h, h16, w, wb, tail_rows, runs, plains
        hw = ww = None
        torch.cuda.empty_cache()


def digest(*tensors):
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def one(root: Path) -> dict:
    """The measurements of one checkout, imported from ``root``; the
    kernels in ``REDESIGNED`` are held to their plain versions."""
    sys.path.insert(0, str(root / "src"))
    import dataclasses

    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.feature_maps import (build_fmbe_blocks,
                                               make_feature_map)
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.kernels.fmbe import fmbe_pack, fmbe_phi, pack_if_needed
    from repro_torch.kernels.fused_ce import fused_ce_bwd, fused_ce_fwd
    from repro_torch.models import Model
    from repro_torch.train import init_train_state, make_train_step
    assert Path(fused_ce_fwd.__code__.co_filename).is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h32 = torch.randn(T, D, generator=gen, device=dev)
    w32 = torch.randn(V, D, generator=gen, device=dev) * V ** -0.5
    labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                           dtype=torch.int32)
    fm = make_feature_map(gen, D, N_FEATURES, device=dev)
    pack = fmbe_pack(fm.omega, fm.degree, fm.coef)
    out = {"bits": {}, "ms": {}, "held": {}, "redesigned_bits": {}}
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "[f32]")):
        h, w = h32.to(dtype), w32.to(dtype)
        nll, lse = fused_ce_fwd(h, w, labels)
        g_nll = torch.full((T,), 1.0 / T, device=dev)
        bargs = (h, w, labels, lse, g_nll, 0.2 * lse / T)
        x = w[:CHUNK_BLOCKS * BLOCK_ROWS]
        if dtype == torch.bfloat16:
            out["bits"]["fused_ce_fwd"] = digest(nll, lse)
            out["bits"]["fused_ce_bwd cast"] = digest(*fused_ce_bwd(*bargs))
            out["bits"]["fused_ce_bwd f32 sums"] = digest(
                *fused_ce_bwd(*bargs, cast=False))
            out["bits"]["fmbe_phi"] = digest(fmbe_phi(
                fm.omega, fm.degree, fm.coef, x, pack=pack))
        out["ms"][f"fused_ce_fwd{tag}"] = events_ms(
            torch, lambda: fused_ce_fwd(h, w, labels))
        out["ms"][f"fused_ce_bwd{tag}"] = events_ms(
            torch, lambda: fused_ce_bwd(*bargs), reps=10)
        p = pack if dtype == torch.bfloat16 else pack_if_needed(
            fm.omega, fm.degree, fm.coef, x)
        out["ms"][f"fmbe_phi{tag}"] = events_ms(
            torch, lambda: fmbe_phi(fm.omega, fm.degree, fm.coef, x, pack=p))
        del h, w, nll, lse, bargs, x
        torch.cuda.empty_cache()
    decode_kernels(torch, out, h32, w32, fm, pack)
    # the build's 474 blocks hold V rows and cluster padding: W's rows in
    # order, then its first rows again as masked padding
    slot = torch.arange(BLOCKS * BLOCK_ROWS, device=dev)
    blocks = w32[slot % V].reshape(BLOCKS, BLOCK_ROWS, D)
    valid = (slot < V).reshape(BLOCKS, BLOCK_ROWS)
    p = pack_if_needed(fm.omega, fm.degree, fm.coef, blocks)
    out["ms"]["f32 sketch (build_fmbe_blocks, host clock)"] = wall_ms(
        torch, lambda: build_fmbe_blocks(fm, blocks, valid, pack=p))
    del h32, w32, blocks, valid, slot
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen1.5-4b"), dtype="float32",
                              n_layers=4)
    model = Model(cfg)
    state = init_train_state(model, TrainConfig(), seed=0, device=dev)
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), 4, 256)
    tokens, lab = (torch.from_numpy(a).to(dev) for a in next(it))
    step = make_train_step(model, TrainConfig(loss="fused_ce",
                                              warmup_steps=1))
    steps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, {"tokens": tokens, "labels": lab})
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    out["ms"]["f32 fused_ce train step (host clock, 3 steps)"] = steps
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(Path(sys.argv[2]).resolve())))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    order = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    runs = []
    for name, root in order:
        res = subprocess.run([sys.executable, __file__, "--one", str(root)],
                             capture_output=True, text=True)
        if res.returncode:
            print(f"tree_compare: the {name} run failed:\n{res.stdout}"
                  f"{res.stderr}", file=sys.stderr)
            return 1
        runs.append(dict(json.loads(res.stdout.strip().splitlines()[-1]),
                         tree=name))
    print(f"card: {card}; runs: {' '.join(n for n, _ in order)}")
    same_all = True
    for key in runs[0]["bits"]:
        values = [r["bits"][key] for r in runs]
        same_all &= len(set(values)) == 1
        print(f"  bits {key}: {values}, all the same: "
              f"{len(set(values)) == 1}")
    for key in runs[0]["redesigned_bits"]:
        values = [r["redesigned_bits"][key] for r in runs]
        within = values[0] == values[3] and values[1] == values[2]
        same_all &= within
        print(f"  redesigned {key}: bits {values}, the same within each "
              f"tree: {within}; max error against its plain version "
              f"{[r['held'][key] for r in runs]}")
    for key in runs[0]["ms"]:
        print(f"  ms {key}: {[r['ms'][key] for r in runs]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "tree_compare.json").write_text(json.dumps(
        {"card": card, "other": str(other), "runs": runs}, indent=1))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
