"""Shared setup of the port's traffic-serving parity tests: the JAX serving
tests' engine (qwen1.5-4b reduced, vocab 1024, mimps with 64-row blocks,
n_probe 4, l 64, max_len 24; f32 on both sides so greedy tokens can be
compared bit for bit) built in the JAX package, and the same engine in the
port from its params (``interop.params_from_numpy``) and its k-means
assignment. The JAX scheduler's draws are replayed into the port: the
shared tail of step t (``fold_in(fold_in(key, 0xE57), t)``'s ``randint``)
through ``Scheduler(tail_source=)``, and each request's Gumbel noise (its
key folded with its stream step, split) through ``Request.gumbel``."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.serve import Engine, Request

MAX_LEN = 24
VOCAB = 1024


def cfg(reduced, **part):
    c = reduced("qwen1.5-4b")
    return dataclasses.replace(
        c, vocab=VOCAB, dtype="float32", partition=dataclasses.replace(
            c.partition, method="mimps", block_rows=64, n_probe=4, l=64,
            **part))


def engines(seed: int = 42, **part):
    """(JAX engine, port engine) on the same params and index."""
    jcfg, tcfg = cfg(j_reduced_config, **part), cfg(reduced_config, **part)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.fold_in(jax.random.PRNGKey(0), seed))
    jeng = JEngine(jm, jp, max_len=MAX_LEN)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assign = torch.from_numpy(np.array(jeng.index.assign))
    teng = Engine(Model(tcfg), tp, MAX_LEN, seed=1, device="cpu",
                  index_assign=assign)
    return jeng, teng


def tail_source(sched_key, l: int, n: int):
    """The JAX scheduler's shared tail draw of step ``t``."""
    est_key = jax.random.fold_in(sched_key, 0xE57)

    def source(t):
        return np.array(jax.random.randint(jax.random.fold_in(est_key, t),
                                           (l,), 0, n))
    return source


def request_gumbel(key, p_len: int, n_new: int, kc: int) -> np.ndarray:
    """A JAX request's noise of each stream step: ``fold_in(key, s)`` while
    replaying, ``fold_in(key, 10_000 + s - p_len)`` after, split, gumbel."""
    rows = []
    for s in range(p_len + n_new - 1):
        fold = s if s < p_len else 10_000 + s - p_len
        k_samp = jax.random.split(jax.random.fold_in(key, fold))[1]
        rows.append(np.asarray(jax.random.gumbel(k_samp, (1, kc))[0]))
    return np.stack(rows).astype(np.float32)


def pair(prompt, n_new: int, key_seed: int, kc: int, **kw):
    """The same request for the JAX package and the port (the port's with
    the JAX key's noise injected)."""
    prompt = np.asarray(prompt, np.int32)
    key = jax.random.PRNGKey(key_seed)
    jr = JRequest(prompt=prompt, max_new_tokens=n_new, key=key, **kw)
    tr = Request(prompt=prompt, max_new_tokens=n_new,
                 gumbel=request_gumbel(key, len(prompt), n_new, kc), **kw)
    return jr, tr


def mixed_pairs(kc: int, n: int = 6, base: int = 0):
    """Mixed lengths, budgets and temperatures (the traffic a synchronous
    batch cannot serve)."""
    rng = np.random.default_rng(100 + base)
    out = []
    for i in range(n):
        out.append(pair(rng.integers(0, VOCAB, 2 + (3 * i) % 7),
                        3 + i % 4, 50 + base + i, kc,
                        temperature=(0.0, 0.9, 0.5)[i % 3]))
    return out


def by_request(report, requests):
    """The report's completions in the order of ``requests``."""
    got = {c.request.req_id: c for c in report.completions}
    return [got[r.req_id] for r in requests]
