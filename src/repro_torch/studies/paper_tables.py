"""The paper's accuracy tables on the port: Fig. 1 (the mass CDF), Table 1
(mu over the (k, l) grid), Table 2 (query noise) and Table 3 (retrieval
errors), at the sizes and grids of the JAX package's
``benchmarks/fig1_cdf.py``, ``table1_grid.py``, ``table2_noise.py`` and
``table3_retrieval.py`` run with ``--full``; the CLI adds Table 4
(``table4_lbl``, the LBL model trained by NCE, MIMPS against Z = 1).

    python3 -m repro_torch.studies.paper_tables --out BENCH_torch_estimators.json

runs all five on one GPU (scores, sorts, solves, the exact log Z through
``topk_z``, the FMBE sketch through ``fmbe_phi`` and its estimate through
``fmbe_z``, Table 4's MIMPS head through ``ivf_score``), prints each
table, writes mu and sigma of every cell (Table 4: its rows), each
table's wall seconds and the card's name and power limit, and exits 1 if
one of ``ORDERINGS`` (the paper's orderings that the JAX package's own run
shows) or Table 4's ordering does not hold.

Each table function takes its data and, optionally, its draws: ``draws``
maps ("uniform", l) to the (Q, l) row ids of ``uniform_log_z`` and
("complement", k, l) to the (Q, l) offsets of ``_complement_sample``;
MIMPS and MINCE at one (k, l) share theirs, as they share keys in the JAX
scripts. A missing entry is drawn from ``generator`` and stored in the
dict. The data are the port's own (a torch generator), so the card's
numbers equal the JAX package's only statistically.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import estimators as est
from ..core.feature_maps import FeatureMap, build_fmbe, fmbe_z_batch, \
    make_feature_map
from . import table4_lbl
from .common import (make_embeddings, make_queries, neighbors_for_mass,
                     pct_abs_rel_error)

N, D, N_QUERIES, SEEDS = 20000, 64, 100, (0, 1, 2)
KS, LS = (1000, 100, 10, 1), (1000, 100, 10)
NOISES = (0.0, 0.1, 0.2, 0.3)
DROPS = {"None": None, "1": (0,), "2": (1,), "[1 2]": (0, 1)}
FMBE_FEATURES = 16384
FREQ_RANKS = (0, 5, 50)


def rare_ranks(n: int):
    return (n // 2, n - 100, n - 1)


def _cell(draws: dict, key, high: int, shape, generator, device):
    if key not in draws:
        if generator is None:
            raise ValueError(f"no draws given for {key} and no generator")
        draws[key] = torch.randint(0, high, shape, generator=generator,
                                   device=device)
    return torch.as_tensor(np.array(draws[key])
                           if not torch.is_tensor(draws[key])
                           else draws[key], device=device)


def _exact(v, q):
    return est.estimate_log_z("exact", v, q)        # topk_z on the card


def fig1(v: torch.Tensor, freq_ranks: Sequence[int] = FREQ_RANKS,
         rare: Optional[Sequence[int]] = None, mass: float = 0.8):
    """Rows needed for ``mass`` of Z(v_r) for frequent and rare ranks r."""
    n = v.shape[0]
    rare = rare_ranks(n) if rare is None else rare
    ranks = list(freq_ranks) + list(rare)
    k80 = neighbors_for_mass(v, v[torch.tensor(ranks, device=v.device)],
                             mass).tolist()
    kinds = ["frequent"] * len(freq_ranks) + ["rare"] * len(rare)
    return [{"kind": kind, "rank": int(r), "k80": int(k), "frac": k / n}
            for kind, r, k in zip(kinds, ranks, k80)]


def table1(v: torch.Tensor, q: torch.Tensor, ks=KS, ls=LS, *,
           generator: Optional[torch.Generator] = None,
           draws: Optional[dict] = None) -> Dict[tuple, np.ndarray]:
    """One seed's Table 1: {(method, k, l): mu of each query (Q,)} for
    Uniform (k 0), MIMPS and MINCE (the paper's Eq. 6/7 weighting)."""
    draws = {} if draws is None else draws
    n, nq, dev = v.shape[0], q.shape[0], q.device
    true = _exact(v, q)
    out = {}
    for l in ls:
        idx = _cell(draws, ("uniform", l), n, (nq, l), generator, dev)
        out[("Uniform", 0, l)] = pct_abs_rel_error(
            est.uniform_log_z(v, q, l, idx=idx), true)
    for k in ks:
        for l in ls:
            pos = _cell(draws, ("complement", k, l), max(n - k, 1), (nq, l),
                        generator, dev)
            out[("MIMPS", k, l)] = pct_abs_rel_error(
                est.mimps_log_z(v, q, k, l, tail_pos=pos), true)
            out[("MINCE", k, l)] = pct_abs_rel_error(
                est.mince_log_z(v, q, k, l, weighting="paper",
                                tail_pos=pos), true)
    return out


def table2(v: torch.Tensor, idx, noise, feature_map: FeatureMap, *,
           noises=NOISES, k: int = 1000, l: int = 1000, mince_k: int = 1,
           generator: Optional[torch.Generator] = None,
           draws: Optional[dict] = None) -> Dict[tuple, np.ndarray]:
    """Table 2: {(method, noise): mu of each query} for Uniform (l),
    MIMPS (k, l), MINCE (mince_k, l; the paper's weighting) and FMBE (the
    sketch of ``feature_map`` over v), on the queries ``idx`` with the
    direction ``noise`` scaled to each relative norm in ``noises``."""
    draws = {} if draws is None else draws
    n, dev = v.shape[0], v.device
    state = build_fmbe(feature_map, v)                # fmbe_phi on the card
    out = {}
    for nz in noises:
        q, _ = make_queries(None, v, len(idx), nz, idx=idx, noise=noise)
        nq = q.shape[0]
        true = _exact(v, q)
        u = _cell(draws, ("uniform", l), n, (nq, l), generator, dev)
        pos = _cell(draws, ("complement", k, l), max(n - k, 1), (nq, l),
                    generator, dev)
        pos1 = _cell(draws, ("complement", mince_k, l), max(n - mince_k, 1),
                     (nq, l), generator, dev)
        out[("Uniform", nz)] = pct_abs_rel_error(
            est.uniform_log_z(v, q, l, idx=u), true)
        out[("MIMPS", nz)] = pct_abs_rel_error(
            est.mimps_log_z(v, q, k, l, tail_pos=pos), true)
        out[("MINCE", nz)] = pct_abs_rel_error(
            est.mince_log_z(v, q, mince_k, l, weighting="paper",
                            tail_pos=pos1), true)
        z = fmbe_z_batch(state, q).double()               # fmbe_z on the card
        zt = torch.exp(true.double())
        out[("FMBE", nz)] = (100.0 * torch.abs((z - zt) / zt)).cpu().numpy()
    return out


def table3(v: torch.Tensor, q: torch.Tensor, *, drops=None, k: int = 1000,
           l: int = 1000, mince_k: int = 1,
           generator: Optional[torch.Generator] = None,
           draws: Optional[dict] = None) -> Dict[tuple, np.ndarray]:
    """Table 3: {(method, case): mu of each query} for MIMPS (k, l) with
    the head ranks of each case of ``drops`` removed, and MINCE (mince_k, l,
    anchored weighting), which drops nothing."""
    drops = DROPS if drops is None else drops
    draws = {} if draws is None else draws
    n, nq, dev = v.shape[0], q.shape[0], q.device
    true = _exact(v, q)
    pos = _cell(draws, ("complement", k, l), max(n - k, 1), (nq, l),
                generator, dev)
    pos1 = _cell(draws, ("complement", mince_k, l), max(n - mince_k, 1),
                 (nq, l), generator, dev)
    out = {}
    for case, dr in drops.items():
        out[("MIMPS", case)] = pct_abs_rel_error(
            est.mimps_log_z(v, q, k, l, drop_ranks=dr, tail_pos=pos), true)
        out[("MINCE", case)] = pct_abs_rel_error(
            est.mince_log_z(v, q, mince_k, l, tail_pos=pos1), true)
    return out


# ---------------------------------------------------------------------------
# The four studies at the scripts' sizes, their rows, and the orderings
# ---------------------------------------------------------------------------

def _seed_gen(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _timed(dev, fn):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def run(n: int = N, d: int = D, n_queries: int = N_QUERIES, seeds=SEEDS,
        fmbe_features: int = FMBE_FEATURES, device="cuda") -> dict:
    """All four studies with fresh seeded data (seed s for Table 1's seed
    s, 0 for the others, as the JAX scripts' PRNGKeys): each table's rows
    and wall seconds (data made inside the timed region)."""
    dev = resolve_device(device)

    def fig():
        v = make_embeddings(_seed_gen(0, dev), n, d, device=dev)
        return fig1(v)

    def t1():
        per_seed = []
        for seed in seeds:
            g = _seed_gen(seed, dev)
            v = make_embeddings(g, n, d, device=dev)
            q, _ = make_queries(g, v, n_queries)
            per_seed.append(table1(v, q, generator=g))
        return table1_rows(per_seed)

    def t2():
        g = _seed_gen(0, dev)
        v = make_embeddings(g, n, d, device=dev)
        _, idx = make_queries(g, v, n_queries)
        noise = torch.randn((n_queries, d), generator=g, device=dev)
        fm = make_feature_map(g, d, fmbe_features, device=dev)
        return stat_rows(table2(v, idx, noise, fm, generator=g),
                         ("method", "noise"))

    def t3():
        g = _seed_gen(0, dev)
        v = make_embeddings(g, n, d, device=dev)
        q, _ = make_queries(g, v, n_queries)
        return stat_rows(table3(v, q, generator=g), ("method", "ret_err"))

    out = {"sizes": {"n": n, "d": d, "n_queries": n_queries,
                     "seeds": list(seeds), "fmbe_features": fmbe_features,
                     "ks": list(KS), "ls": list(LS)}}
    for name, fn in (("fig1", fig), ("table1", t1), ("table2", t2),
                     ("table3", t3)):
        rows, secs = _timed(dev, fn)
        out[name] = {"rows": rows, "seconds": secs}
    return out


def table1_rows(per_seed) -> list:
    """Table 1's rows: mu is the mean over seeds of each seed's mean, sigma
    their standard error (the JAX script's aggregation)."""
    cells = {}
    for errs in per_seed:
        for key, e in errs.items():
            cells.setdefault(key, []).append(float(np.mean(e)))
    rows = []
    for (name, k, l), vals in sorted(cells.items()):
        rows.append({"method": name, "k": k, "l": l,
                     "mu": float(np.mean(vals)),
                     "sigma": float(np.std(vals) / np.sqrt(len(vals)))})
    return rows


def stat_rows(cells: dict, names) -> list:
    """Rows of {names..., mu, sigma}: the mean over queries and its
    standard error."""
    return [dict(zip(names, key), mu=float(np.mean(e)),
                 sigma=float(np.std(e) / np.sqrt(len(e))))
            for key, e in cells.items()]


def _mu(rows, **match) -> float:
    for r in rows:
        if all(r[k] == v for k, v in match.items()):
            return r["mu"]
    raise KeyError(match)


# The paper's orderings that hold in the JAX package's own run of the four
# scripts at these sizes (CPU, ``python -m benchmarks.run --full --only
# fig1,t1,t2,t3``); each takes the results of ``run``.
ORDERINGS = {
    "table1: MIMPS mu falls from (k 100, l 100) to (k 1000, l 1000)":
        lambda r: _mu(r["table1"]["rows"], method="MIMPS", k=100, l=100)
        > _mu(r["table1"]["rows"], method="MIMPS", k=1000, l=1000),
    "table1: MIMPS (k 1000, l 1000) below Uniform at l 1000":
        lambda r: _mu(r["table1"]["rows"], method="MIMPS", k=1000, l=1000)
        < _mu(r["table1"]["rows"], method="Uniform", k=0, l=1000),
    "table2: FMBE mu above MIMPS mu at every noise level":
        lambda r: all(
            _mu(r["table2"]["rows"], method="FMBE", noise=nz)
            > _mu(r["table2"]["rows"], method="MIMPS", noise=nz)
            for nz in NOISES),
    "table3: dropping rank 1 costs more than rank 2, rank 2 more than "
    "nothing":
        lambda r: _mu(r["table3"]["rows"], method="MIMPS", ret_err="1")
        > _mu(r["table3"]["rows"], method="MIMPS", ret_err="2")
        > _mu(r["table3"]["rows"], method="MIMPS", ret_err="None"),
    "fig1: every frequent rank needs more neighbours than every rare rank":
        lambda r: min(x["k80"] for x in r["fig1"]["rows"]
                      if x["kind"] == "frequent")
        > max(x["k80"] for x in r["fig1"]["rows"] if x["kind"] == "rare"),
}


TABLE4_ORDERING = ("table4: MIMPS beats Z = 1 (%Better over 50, AbsE-MIPS "
                   "under AbsE-NCE) at every (n_probe, l)")


def check_orderings(results: dict) -> Dict[str, bool]:
    return {name: bool(fn(results)) for name, fn in ORDERINGS.items()}


def format_tables(results: dict) -> str:
    """The four tables as the JAX scripts print them."""
    lines = ["== Fig. 1: neighbours for 80% of Z =="]
    for x in results["fig1"]["rows"]:
        lines.append(f"  {x['kind']:9s} rank={x['rank']:6d}: {x['k80']:6d} "
                     f"neighbours ({100 * x['frac']:.1f}% of vocab)")
    lines.append("== Table 1: mu % (sigma over seeds) ==")
    lines.append(f"{'method':8s} {'k':>5s} {'l':>5s} {'mu %':>10s} "
                 f"{'sigma':>8s}")
    for x in results["table1"]["rows"]:
        lines.append(f"{x['method']:8s} {x['k']:5d} {x['l']:5d} "
                     f"{x['mu']:10.2f} {x['sigma']:8.2f}")
    lines.append("== Table 2: mu % (sigma) by query noise ==")
    for m in ("Uniform", "MIMPS", "MINCE", "FMBE"):
        cells = [f"{_mu(results['table2']['rows'], method=m, noise=nz):7.2f}"
                 for nz in NOISES]
        lines.append(f"{m:8s} " + " ".join(cells))
    lines.append("== Table 3: mu % by dropped head ranks ==")
    for m in ("MIMPS", "MINCE"):
        cells = [f"{_mu(results['table3']['rows'], method=m, ret_err=c):12.2f}"
                 for c in DROPS]
        lines.append(f"{m:8s} " + " ".join(cells))
    return "\n".join(lines)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="BENCH_torch_estimators.json")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    # a small run first, untimed, so that no table's seconds carry the
    # process's CUDA start-up (library loads, first launches)
    run(n=4096, n_queries=8, seeds=(0,), fmbe_features=512, device=dev)
    results = run(device=dev)
    t0 = time.perf_counter()
    results["table4"] = table4_lbl.run(device=dev)
    results["table4"]["seconds"] = time.perf_counter() - t0
    results["card"] = card_line()
    results["device"] = torch.cuda.get_device_name(dev)
    results["orderings"] = check_orderings(results)
    results["orderings"][TABLE4_ORDERING] = table4_lbl.mimps_beats_z1(
        results["table4"])
    print(format_tables(results))
    print(table4_lbl.format_table(results["table4"]))
    for name in ("fig1", "table1", "table2", "table3", "table4"):
        print(f"{name}: {results[name]['seconds']:.3f} s [{results['card']}]")
    for name, ok in results["orderings"].items():
        print(f"{'holds' if ok else 'BROKEN'}: {name}")
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0 if all(results["orderings"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
