#!/usr/bin/env python3
"""Fingerprints of the serving path's stages in two processes on one GPU:
the SHA-256 of every stage's bytes, and the first stage whose bits differ
between the processes.

    python3 tools/stage_fingerprints.py            # from the repository root
    python3 tools/stage_fingerprints.py --lsh-only # the lsh stages alone
    python3 tools/stage_fingerprints.py --one [--lsh-only]   # one process,
                                                             # JSON digests

Each process builds qwen1.5-4b at its published widths with the depth cut
to 2 layers (seeded random weights, seed 0) and, as ``chip_smoke.py`` does,
an lsh engine with seed 1 (the hyperplanes from the engine's CUDA
generator). It then fingerprints, in this order:
  - the hidden states of one decode step of 8 random tokens (seed 2);
  - the hyperplanes, the fitted norm cap and tail temperature, the codes,
    bucket tables, slots and tail logits (``pack_lsh``);
  - the queries' float64 ``hash_codes``, the tail proposal's running mass
    (``fixed_order_cumsum``), the tail draw (``inverse_cdf_sample`` on
    uniforms from seed 3), the plan (every field) and ``lsh_probe``'s
    outputs (k 8, l 1000, the trimmed union);
  - the same four from hidden states drawn from seed 4 in place of the
    trunk's ("injected h"), so that a difference in the trunk does not
    hide one in the lsh path;
  - beside the tail's running mass, ``torch.cumsum`` of the same mass as
    one 1-D scan (what the plan used before ``fixed_order_cumsum``);
and, without ``--lsh-only``: the mimps engine's k-means index (every
field, the assignment included), k-means sums by ``segment_sums`` and by
``index_add_`` on that assignment, the mimps plan and ``ivf_decode``'s
outputs, and the fmbe engine's feature map, pack, block sketch sums and
``fmbe_z`` (on the state's pack) on the plan's complement.
Prints each stage's digests and whether they agree, the card's name and
power limit, and writes all of it to
``chiprun_out/stage_fingerprints.json``. Exits 1 if a stage of the
package's path differs (the 1-D ``torch.cumsum`` and ``index_add_`` rows
are diagnostics and do not count).
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
Q, K, L_TAIL, LAYERS = 8, 8, 1000, 2
# rows that show what the package replaced, not what it runs
DIAGNOSTIC = ("tail mass, torch.cumsum 1-D", "k-means sums, index_add_")


def digest(*tensors) -> str:
    """The SHA-256 of the tensors' bytes, in order."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        t = torch.as_tensor(t)
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def lsh_stages(torch, out, tag, lidx, w, h, seed):
    """The lsh path's stages from hidden states h, the tail drawn with
    uniforms from ``seed``."""
    from repro_torch.core import lsh as tlsh
    from repro_torch.kernels.lsh_probe import hash_codes, lsh_probe
    dev = h.device
    out[f"{tag}query codes (hash_codes, float64)"] = digest(
        hash_codes(lidx.proj, h))
    logp = tlsh._tail_log_probs(lidx)
    out[f"{tag}tail mass (fixed_order_cumsum)"] = digest(
        tlsh.fixed_order_cumsum(torch.exp(logp)))
    u = torch.rand((L_TAIL,), generator=torch.Generator(device=dev)
                   .manual_seed(seed), device=dev)
    tail_ids = tlsh.inverse_cdf_sample(logp, u)
    out[f"{tag}tail draw"] = digest(tail_ids)
    plan = tlsh.lsh_plan(lidx, h, L_TAIL, tail_ids=tail_ids)
    out[f"{tag}plan"] = digest(*plan)
    cap = plan.cand_rows.shape[0]
    if int(plan.cand_live) > cap:
        plan = tlsh.lsh_plan(lidx, h, L_TAIL, tail_ids=tail_ids,
                             cand_cap=int(plan.cand_live))
    res = lsh_probe(w, h, lidx.proj, plan.cand_rows, plan.cand_live,
                    lidx.codes, lidx.slot_of_row, plan.tail_ids,
                    plan.tail_accept, plan.tail_bias, k=K)
    out[f"{tag}lsh_probe"] = digest(*res)
    return logp


def one(lsh_only: bool) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import lsh as tlsh
    from repro_torch.core.decode import _tail_rows, make_plan
    from repro_torch.core.kmeans import segment_sums
    from repro_torch.kernels.fmbe import fmbe_z
    from repro_torch.kernels.ivf_score import ivf_decode
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=LAYERS)

    def with_method(method):
        return dataclasses.replace(cfg, partition=dataclasses.replace(
            cfg.partition, method=method))

    out = {}
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    model = Model(with_method("lsh"))
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (Q,), generator=gen, device=dev)
    h = model.decode_step(params, model.init_decode_state(Q, 4, dev), toks, 0)
    out["h (trunk decode step)"] = digest(h)
    eng = Engine(model, params, 4, seed=1)
    lidx, w = eng.state.lsh, eng.state.w
    out["lsh hyperplanes (torch.randn)"] = digest(lidx.proj)
    out["lsh scales (_fit_aug_scale, _fit_tail_scale)"] = digest(
        lidx.aug_scale, lidx.tail_scale)
    out["lsh codes and tables (pack_lsh)"] = digest(
        lidx.codes, lidx.buckets, lidx.slot_of_row, lidx.tail_logits)
    logp = lsh_stages(torch, out, "", lidx, w, h, 3)
    h_inj = torch.randn(Q, cfg.d_model, generator=torch.Generator(
        device=dev).manual_seed(4), device=dev).to(h.dtype)
    lsh_stages(torch, out, "injected h: ", lidx, w, h_inj, 3)
    out["tail mass, torch.cumsum 1-D"] = digest(
        torch.cumsum(torch.exp(logp), 0))
    del eng, lidx
    if lsh_only:
        return out
    eng = Engine(Model(cfg), params, 4, seed=1)
    index = eng.index
    out["k-means index (every field)"] = digest(
        index.v_blocks, index.valid, index.row_id, index.slot_of_row,
        index.block_centroids, index.block_radius, index.assign)
    n_c = int(index.assign.max()) + 1
    out["k-means sums, segment_sums"] = digest(
        segment_sums(w, index.assign, n_c))
    out["k-means sums, index_add_"] = digest(
        torch.zeros((n_c, w.shape[1]), device=dev).index_add_(
            0, index.assign.long(), w.float()))
    pc = cfg.partition
    plan = make_plan(index, h, pc.n_probe, pc.l, generator=torch.Generator(
        device=dev).manual_seed(5))
    out["mimps plan"] = digest(*plan)
    row_logw = torch.where(index.valid, 0.0, -1e30).float()
    out["ivf_decode"] = digest(*ivf_decode(
        index.v_blocks, h, plan.head_ids, plan.head_live, plan.head_member,
        row_logw, _tail_rows(index, plan), plan.tail_accept, k=K))
    assign = index.assign
    del eng
    eng = Engine(Model(with_method("fmbe")), params, 4, seed=1,
                 index_assign=assign)
    fst = eng.state.fmbe
    fm = fst.fm
    out["fmbe feature map"] = digest(fm.omega, fm.degree, fm.coef)
    out["fmbe pack"] = digest(fst.pack.rows, fst.pack.tile_j0,
                              fst.pack.start)
    out["fmbe block sketch sums"] = digest(fst.lambda_tilde,
                                           fst.lambda_blocks)
    lam = (fst.lambda_tilde[None, :]
           - fst.lambda_blocks[plan.block_ids.long()].sum(1)).contiguous()
    out["fmbe_z"] = digest(fmbe_z(fm.omega, fm.degree, fm.coef, lam, h,
                                  pack=fst.pack))
    return out


def main() -> int:
    lsh_only = "--lsh-only" in sys.argv[1:]
    if "--one" in sys.argv[1:]:
        print(json.dumps(one(lsh_only)))
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    runs = []
    for _ in range(2):
        res = subprocess.run(
            [sys.executable, __file__, "--one"]
            + (["--lsh-only"] if lsh_only else []),
            capture_output=True, text=True)
        if res.returncode:
            print(f"stage_fingerprints: a run failed:\n{res.stdout}"
                  f"{res.stderr}", file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    print(f"card: {card}; two processes")
    first = None
    for key in runs[0]:
        same = runs[0][key] == runs[1][key]
        print(f"  {key}: {runs[0][key][:16]} {runs[1][key][:16]} "
              f"{'same' if same else 'DIFFER'}")
        if not same and first is None and key not in DIAGNOSTIC:
            first = key
    print(f"first stage of the path that differs: {first}")
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "stage_fingerprints.json").write_text(json.dumps(
        {"card": card, "runs": runs, "first_difference": first}, indent=1))
    return 0 if first is None else 1


if __name__ == "__main__":
    sys.exit(main())
