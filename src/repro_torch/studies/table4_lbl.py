"""The paper's Table 4 / SS5.2 on the port (counterpart of the JAX
package's ``benchmarks/table4_lbl.py``): a log-bilinear language model
trained with NCE (Z clamped to 1) on the synthetic Zipf corpus, then
partition-function estimation on held-out contexts.

AbsE-MIPS : sum |Z_hat - Z| with MIMPS over the block-IVF index
            (``core.estimators.mimps_ivf``: ``ivf_score`` on the card)
AbsE-NCE  : sum |1 - Z|, the self-normalisation heuristic
%Better   : how often MIMPS beats the Z = 1 heuristic
Speedup   : brute-force FLOPs / MIMPS FLOPs, and the measured µs per query
            of both

The exact log Z goes through ``topk_z``. LBL's class vectors are d + 1 =
101 wide and both kernels read rows of a multiple of 8 elements, so the
vectors and the queries are padded with zero columns (``pad_columns``):
every dot product is unchanged. ``run`` also holds the kernels to
``use_kernel=False`` and the padded plain path to the unpadded one.

Draws come from a ``torch.Generator`` (parameters, noise words, k-means,
tail samples), so the card's table equals the JAX package's only
statistically; every draw can be injected (``params``, ``noise``,
``assign``, ``draws``), which is how the tests reproduce JAX's table.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import estimators as est
from ..core.lsh import fixed_order_cumsum
from ..core.mips import build_ivf
from ..data import SyntheticCorpus, zipf_probs
from ..models import lbl

PAIRS = ((4, 10), (4, 100), (8, 100), (16, 100))
D, CTX, BATCH, N_NOISE, LR = 100, 4, 256, 32, 0.05
BLOCK_ROWS = 128
FULL = dict(vocab=10000, steps=300, n_test=500)
QUICK = dict(vocab=4000, steps=150, n_test=200)
HELD_OUT_STEP = 999_999           # the corpus step of the held-out contexts


def pad_columns(x: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    """x (..., d) with zero columns appended up to a multiple of
    ``multiple``: the rows the kernels read, every dot product exact."""
    pad = (-x.shape[-1]) % multiple
    return torch.nn.functional.pad(x, (0, pad)) if pad else x.contiguous()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def noise_sampler(vocab: int, device):
    """(log_probs (V,), sample(generator, shape) -> ids): Zipf noise words
    by inverse CDF over ``fixed_order_cumsum`` (the same ids in every
    process for the same uniforms)."""
    probs = torch.as_tensor(zipf_probs(vocab), dtype=torch.float32,
                            device=device)
    cdf = fixed_order_cumsum(probs)

    def sample(generator, shape):
        u = torch.rand(shape, generator=generator, device=device)
        ids = torch.searchsorted(cdf, (u * cdf[-1]).reshape(-1))
        return torch.clamp(ids, max=vocab - 1).reshape(shape)
    return torch.log(probs), sample


def train_lbl(generator: Optional[torch.Generator], vocab: int = 10000,
              d: int = D, ctx: int = CTX, steps: int = 300,
              batch: int = BATCH, n_noise: int = N_NOISE, lr: float = LR, *,
              params=None, noise: Optional[Sequence] = None,
              device="cuda"):
    """SGD on LBL's NCE loss with the global-norm clip at 1 (the JAX
    script's step), on ``SyntheticCorpus(vocab, seed=1)``'s batches.
    Parameters come from ``init_lbl(generator)`` or are given; step i's
    noise words from ``generator`` or ``noise[i]`` (batch, n_noise).
    Returns (params, corpus, the last step's loss)."""
    dev = resolve_device(device)
    corpus = SyntheticCorpus(vocab=vocab, seed=1)
    log_probs, sample = noise_sampler(vocab, dev)
    if params is None:
        params = lbl.init_lbl(generator, vocab, d, ctx, device=dev)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    leaves = list(params.values())
    loss = torch.zeros(())
    for i in range(steps):
        toks = torch.as_tensor(corpus.batch(i, batch, ctx), device=dev).long()
        ctx_t, tgt = toks[:, :ctx], toks[:, ctx]
        nz = (sample(generator, (toks.shape[0], n_noise)) if noise is None
              else torch.as_tensor(np.array(noise[i]), device=dev).long())
        loss = lbl.nce_loss(params, ctx_t, tgt, nz,
                            (log_probs[tgt], log_probs[nz]), n_noise)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            gn = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(1.0 / (gn + 1e-9), max=1.0)
            for p, g in zip(leaves, grads):
                p.sub_(lr * scale * g)
    return ({k: v.detach() for k, v in params.items()}, corpus,
            float(loss.detach()))


def held_out(params, corpus: SyntheticCorpus, n_test: int, ctx: int = CTX):
    """(class vectors (V, d + 1), query vectors (n_test, d + 1)) of the
    held-out contexts."""
    dev = params["r"].device
    toks = torch.as_tensor(corpus.batch(HELD_OUT_STEP, n_test, ctx),
                           device=dev).long()
    return lbl.class_vectors(params), lbl.query_vector(params, toks[:, :ctx])


def estimates(v: torch.Tensor, q: torch.Tensor, index, draws: Dict,
              pairs=PAIRS, *, use_kernel: bool = True):
    """(exact log Z (Q,), {pair: MIMPS log Ẑ (Q,)}) of the queries q over
    v and its index, with the tail rows ``draws[l]`` (Q, l) (one draw for
    each l, as the JAX script's keys are shared by the pairs)."""
    lz_true = est.estimate_log_z("exact", v, q, use_kernel=use_kernel)
    out = {}
    for n_probe, l in pairs:
        out[(n_probe, l)] = est.mimps_ivf(index, q, n_probe, l,
                                          idx=draws[l],
                                          use_kernel=use_kernel).log_z
    return lz_true, out


def table_rows(lz_true: torch.Tensor, lz: Dict, n: int, d1: int,
               n_blocks: int, block_rows: int = BLOCK_ROWS) -> list:
    """The table's rows from the estimates: AbsE-MIPS, AbsE-NCE, %Better
    (in float64 from the f32 log values, as the JAX script) and the FLOP
    speed-up (rows of width ``d1`` = d + 1)."""
    z_true = np.exp(lz_true.double().cpu().numpy())
    rows = []
    for (n_probe, l), lzp in lz.items():
        z_hat = np.exp(lzp.double().cpu().numpy())
        flops_mips = (n_blocks + n_probe * block_rows + l) * d1
        rows.append(dict(
            n_probe=n_probe, l=l,
            abse_mips=float(np.sum(np.abs(z_hat - z_true))),
            abse_nce=float(np.sum(np.abs(1.0 - z_true))),
            better=100 * float(np.mean(np.abs(z_hat - z_true)
                                       < np.abs(1.0 - z_true))),
            speedup_flops=n * d1 / flops_mips))
    return rows


def _timed_us(dev, fn, n_queries: int, reps: int = 5) -> float:
    """Median wall µs per query of ``fn`` over ``reps`` calls after one
    warm call, synchronised."""
    fn()
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6 / n_queries


def run(quick: bool = False, *, seed: int = 7, device="cuda",
        pairs=PAIRS, params=None, noise=None, assign=None,
        draws: Optional[Dict] = None, sizes: Optional[Dict] = None) -> dict:
    """Train, index, estimate: the table's rows (kernels by default), the
    training's seconds and last loss, each pair's µs per query beside the
    exact pass's, and the checks: kernels against ``use_kernel=False``
    (max |Δ log Z| of the exact pass and of MIMPS) and the padded plain
    path against the unpadded one (the same index assignment and draws).
    ``sizes`` overrides ``FULL``/``QUICK`` (vocab, steps, n_test)."""
    dev = resolve_device(device)
    cfg = dict(QUICK if quick else FULL, **(sizes or {}))
    g = torch.Generator(device=dev).manual_seed(seed)
    _sync(dev)
    t0 = time.perf_counter()
    params, corpus, final_loss = train_lbl(
        g, vocab=cfg["vocab"], steps=cfg["steps"], params=params,
        noise=noise, device=dev)
    _sync(dev)
    train_s = time.perf_counter() - t0

    v, q = held_out(params, corpus, cfg["n_test"])
    vp, qp = pad_columns(v), pad_columns(q)
    index = build_ivf(vp, BLOCK_ROWS, generator=g, assign=assign,
                      device=dev)
    draws = {} if draws is None else draws
    for _, l in pairs:
        if l not in draws:
            draws[l] = torch.randint(0, v.shape[0], (q.shape[0], l),
                                     generator=g, device=dev)
        draws[l] = torch.as_tensor(draws[l], device=dev).long()
    lz_true, lz = estimates(vp, qp, index, draws, pairs)
    rows = table_rows(lz_true, lz, v.shape[0], v.shape[1], index.n_blocks)
    exact_us = _timed_us(dev, lambda: est.estimate_log_z("exact", vp, qp),
                         q.shape[0])
    for r in rows:
        n_probe, l = r["n_probe"], r["l"]
        r["t_us"] = _timed_us(dev, lambda: est.mimps_ivf(
            index, qp, n_probe, l, idx=draws[l]), q.shape[0])
        r["exact_t_us"] = exact_us

    # the kernels against the plain path, padded against unpadded
    p_true, p_lz = estimates(vp, qp, index, draws, pairs, use_kernel=False)
    plain = build_ivf(v, BLOCK_ROWS, assign=index.assign, device=dev)
    u_true, u_lz = estimates(v, q, plain, draws, pairs, use_kernel=False)
    kernel_err = max([(lz_true - p_true).abs().max().item()]
                     + [(lz[k] - p_lz[k]).abs().max().item() for k in lz])
    pad_err = max([(p_true - u_true).abs().max().item()]
                  + [(p_lz[k] - u_lz[k]).abs().max().item() for k in lz])
    pad_equal = torch.equal(p_true, u_true) and all(
        torch.equal(p_lz[k], u_lz[k]) for k in lz)
    return {"sizes": dict(cfg, d=D, context=CTX, batch=BATCH,
                          n_noise=N_NOISE, lr=LR, block_rows=BLOCK_ROWS,
                          padded_d=vp.shape[1], n_blocks=index.n_blocks),
            "rows": rows, "train_seconds": train_s,
            "train_us_per_step": train_s * 1e6 / max(cfg["steps"], 1),
            "final_loss": final_loss,
            "kernel_max_abs_err": kernel_err, "pad_max_abs_diff": pad_err,
            "pad_bit_equal": pad_equal}


def format_table(result: dict) -> str:
    lines = [f"== Table 4: LBL NCE train loss {result['final_loss']:.3f}, "
             f"{result['train_seconds']:.2f} s ==",
             f"{'probe':>5s} {'l':>4s} {'AbsE-MIPS':>12s} {'AbsE-NCE':>12s} "
             f"{'%Better':>8s} {'Speedup':>8s} {'us/query':>9s} "
             f"{'exact us':>9s}"]
    for r in result["rows"]:
        lines.append(f"{r['n_probe']:5d} {r['l']:4d} {r['abse_mips']:12.1f} "
                     f"{r['abse_nce']:12.1f} {r['better']:8.1f} "
                     f"{r['speedup_flops']:8.1f} {r['t_us']:9.3f} "
                     f"{r['exact_t_us']:9.3f}")
    return "\n".join(lines)


# The ordering that the JAX package's own run of the script shows on the
# CPU (``python -m benchmarks.run --full --only t4``: %Better 96.6-99.4 and
# AbsE-MIPS under AbsE-NCE at every pair).
def mimps_beats_z1(result: dict) -> bool:
    return all(r["better"] > 50.0 and r["abse_mips"] < r["abse_nce"]
               for r in result["rows"])
