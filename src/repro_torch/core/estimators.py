"""The paper's partition-function estimators (SS4; counterpart of
``repro.core.estimators``), log-domain throughout.

Every estimator takes q (d,) or a batch (..., d) and returns log Ẑ of
shape q.shape[:-1]; the batched call equals the per-query calls, as
``jax.vmap`` of the JAX functions does. Scores are f32 whatever the dtype
of v and q (the JAX functions keep the input dtype; its studies run f32).

Oracle variants (``mimps_log_z``, ``mince_log_z``, ``nmimps_log_z``) score
and sort all N rows: they reproduce the paper's SS5.1 controlled-accuracy
studies, where retrieval is perfect and errors are injected on purpose. The
sublinear ``mimps_ivf`` goes through the block-IVF index.

Randomness: a ``torch.Generator`` draws the uniform samples, or they are
injected (the tests pass the JAX package's ``randint`` draws):
``tail_pos (..., l)``, offsets into the ranks [k, N) of
``_complement_sample`` (so ranks k + tail_pos), drawn from [0, max(N - k,
1)); ``idx (..., l)``, row ids in [0, N) of ``uniform_log_z`` and
``mimps_ivf``. With k = 0 the two coincide, as they do in JAX.

``use_kernel=True`` takes the port's kernel where one computes the same
function (``topk_z`` for the exact log Z, ``ivf_score`` for ``mimps_ivf``'s
head, ``fmbe_z`` for FMBE); on CPU tensors each kernel wrapper runs its
plain version, and ``use_kernel=False`` is the plain path everywhere.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels.ivf_score import ivf_score, ivf_score_plain
from ..kernels.topk_z import topk_z
from . import mince as _mince
from . import mips as _mips
from .feature_maps import FMBEState, fmbe_estimate_z, fmbe_z_batch

NEG_INF = -1e30


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _scores(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """f32 scores q . v_i: q (..., d) -> (..., N)."""
    return torch.matmul(q.float(), v.float().T)


def _lse(x: torch.Tensor, mask: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    if mask is not None:
        x = torch.where(mask, x, torch.full_like(x, NEG_INF))
    return torch.logsumexp(x, dim=-1)


def _draw(generator: Optional[torch.Generator], high: int, shape,
          device) -> torch.Tensor:
    """Uniform ints in [0, high) of ``shape`` from ``generator``."""
    if generator is None:
        raise ValueError("a draw needs a torch.Generator or injected draws "
                         "(tail_pos / idx)")
    return torch.randint(0, high, tuple(shape), generator=generator,
                         device=device)


def _as_rows(q: torch.Tensor) -> torch.Tensor:
    """q (..., d) as a contiguous (B, d) batch for the kernels."""
    return q.reshape(-1, q.shape[-1]).contiguous()


# ---------------------------------------------------------------------------
# Exact (brute force) baseline
# ---------------------------------------------------------------------------

def exact_log_z(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """log Z = logsumexp_i (v_i . q). O(N d)."""
    return _lse(_scores(v, q))


# ---------------------------------------------------------------------------
# Head/tail core (Eq. 5) in log domain
# ---------------------------------------------------------------------------

def combine_head_tail_lse(log_head: torch.Tensor, log_tail: torch.Tensor,
                          n_tail_total: torch.Tensor,
                          n_tail_samples: torch.Tensor) -> torch.Tensor:
    """Eq. 5 combine from precomputed logsumexps:

        log( exp(log_head) + (n_tail_total / n_tail_samples) * exp(log_tail) )

    The tail term is dropped when the tail population is empty or no sample
    survived; log_tail == -inf goes through the same guard, so no NaN leaks
    out of -inf + finite.
    """
    log_scale = torch.log(torch.clamp(n_tail_total, min=1e-9)) - \
        torch.log(torch.clamp(n_tail_samples, min=1e-9))
    ok = (n_tail_total > 0) & (n_tail_samples > 0)
    tail = torch.clamp(log_tail, min=NEG_INF) + log_scale
    log_tail = torch.where(ok, tail, torch.full_like(tail, NEG_INF))
    return torch.logaddexp(log_head, log_tail)


def head_tail_log_z(head_scores: torch.Tensor, tail_scores: torch.Tensor,
                    n_tail_total, n_tail_samples,
                    head_mask: Optional[torch.Tensor] = None,
                    tail_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """log( sum_head exp + (n_tail_total / n_tail_samples) * sum_tail exp );
    an empty head or tail (last axis 0) contributes NEG_INF."""

    def side(scores, mask):
        if scores.shape[-1]:
            return _lse(scores, mask)
        return torch.full(scores.shape[:-1], NEG_INF, device=scores.device)

    log_head = side(head_scores, head_mask)
    log_tail = side(tail_scores, tail_mask)
    return combine_head_tail_lse(log_head, log_tail,
                                 _f32(n_tail_total, log_head),
                                 _f32(n_tail_samples, log_head))


# ---------------------------------------------------------------------------
# Oracle retrieval (paper SS5.1): full sort, deterministic error injection
# ---------------------------------------------------------------------------

class OracleRetrieval(NamedTuple):
    scores_sorted: torch.Tensor   # (..., N) descending
    order: torch.Tensor           # (..., N) ids


def oracle_retrieve(v: torch.Tensor, q: torch.Tensor) -> OracleRetrieval:
    """Every row's f32 score, sorted descending; among equal scores the
    lower id first (JAX's stable ``argsort(-s)``)."""
    s, order = torch.sort(_scores(v, q), dim=-1, descending=True,
                          stable=True)
    return OracleRetrieval(scores_sorted=s, order=order)


def _complement_sample(generator: Optional[torch.Generator],
                       ret: OracleRetrieval, k: int, l: int,
                       tail_pos: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """l uniform samples from ranks [k, N): the scores at ranks k +
    ``tail_pos``, drawn from [0, max(N - k, 1)) unless injected. k == N
    clamps to the last rank; Eq. 5 then drops the tail (n_tail_total 0)."""
    s = ret.scores_sorted
    n = s.shape[-1]
    batch = s.shape[:-1]
    if tail_pos is None:
        tail_pos = _draw(generator, max(n - k, 1), batch + (l,), s.device)
    pos = torch.clamp(k + tail_pos.to(s.device).long(), max=n - 1)
    return torch.gather(s, -1, pos.expand(*batch, l))


def mimps_log_z(v: torch.Tensor, q: torch.Tensor, k: int, l: int,
                generator: Optional[torch.Generator] = None,
                drop_ranks: Optional[Tuple[int, ...]] = None, *,
                tail_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MIMPS (Eq. 5) with oracle retrieval. ``drop_ranks`` simulates
    retrieval errors (Table 3): the listed head ranks (0-based) are removed
    from S_k, as if the index failed to return them."""
    ret = oracle_retrieve(v, q)
    s = ret.scores_sorted
    batch = s.shape[:-1]
    head_mask = None
    if k > 0:
        head = s[..., :k]
        head_mask = torch.ones((k,), dtype=torch.bool, device=s.device)
        for r in drop_ranks or ():
            head_mask[r] = False
    else:
        head = s.new_zeros(batch + (0,))
    if l > 0:
        tail = _complement_sample(generator, ret, k, l, tail_pos)
    else:
        tail = s.new_zeros(batch + (0,))
    n = v.shape[0]
    return head_tail_log_z(head, tail, n - k, l, head_mask=head_mask)


def uniform_log_z(v: torch.Tensor, q: torch.Tensor, l: int,
                  generator: Optional[torch.Generator] = None, *,
                  idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform importance sampling (the k = 0 case of MIMPS) over the rows
    ``idx`` (..., l), drawn from [0, N) unless injected."""
    n = v.shape[0]
    batch = q.shape[:-1]
    if idx is None:
        idx = _draw(generator, n, batch + (l,), q.device)
    idx = idx.to(q.device).long().expand(*batch, l)
    tail = torch.einsum("...ld,...d->...l", v[idx].float(), q.float())
    return head_tail_log_z(tail.new_zeros(batch + (0,)), tail, n, l)


def nmimps_log_z(v: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """Naive MIMPS (Eq. 4): the head alone, shown inadequate in the
    paper."""
    return _lse(torch.topk(_scores(v, q), k, dim=-1).values)


def mince_log_z(v: torch.Tensor, q: torch.Tensor, k: int, l: int,
                generator: Optional[torch.Generator] = None,
                iters: int = 25, solver: str = "halley",
                weighting: str = "anchored", *,
                tail_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MINCE (Eq. 6/7): Z solved for by NCE with S_k as data and uniform
    noise from ranks [k, N).

    weighting='paper' is the literal Eq. 6/7 setup (alpha_i = s_i +
    log(k (N - k) / l) over the enumerated head, beta_j likewise over the
    noise), what Table 1 reproduces. weighting='anchored' enters every
    atom with its importance weight anchored at the Eq. 5 plug-in
    (``mince.anchored_atoms``) and solves with ``solve_shared_atoms``; its
    root is the anchor (see ``repro.core.mince``).

    k <= 0 leaves no data samples: the estimate is uniform importance
    sampling on the same draws. k >= N is the whole vocabulary: the exact
    log Z."""
    n = v.shape[0]
    if k <= 0:
        return uniform_log_z(v, q, l, generator, idx=tail_pos)
    if k >= n:
        return exact_log_z(v, q)
    if weighting not in ("paper", "anchored"):
        raise ValueError(f"unknown MINCE weighting {weighting!r}; have "
                         f"'paper' and 'anchored'")
    ret = oracle_retrieve(v, q)
    head = ret.scores_sorted[..., :k]
    noise = _complement_sample(generator, ret, k, l, tail_pos)
    theta0 = _lse(head)            # the head mass is a sane start
    fk, fl, fnk = (_f32(x, head) for x in (k, l, n - k))
    if weighting == "paper":
        log_ratio = torch.log(fk) + torch.log(fnk) - torch.log(fl)
        return _mince.solve_log_z(head + log_ratio, noise + log_ratio,
                                  theta0, iters=iters, solver=solver)
    scores = torch.cat([head, noise], -1)
    mult = torch.cat([torch.ones((k,), device=head.device),
                      (fnk / fl).expand(l)]).expand_as(scores)
    anchor = head_tail_log_z(head, noise, n - k, l)
    alpha, wd, wn = _mince.anchored_atoms(scores, mult, n, fk, fl, anchor)
    return _mince.solve_shared_atoms(alpha, wd, wn, anchor, iters=iters,
                                     solver=solver)


def fmbe_log_z(state: FMBEState, q: torch.Tensor) -> torch.Tensor:
    """FMBE's Z estimate is signed; the log of its value clipped at 1e-30."""
    return torch.log(torch.clamp(fmbe_estimate_z(state, q), min=1e-30))


def fmbe_z(state: FMBEState, q: torch.Tensor) -> torch.Tensor:
    """The signed FMBE estimate phi(q) . lambda_tilde."""
    return fmbe_estimate_z(state, q)


# ---------------------------------------------------------------------------
# Sublinear MIMPS via block-IVF
# ---------------------------------------------------------------------------

class IVFEstimate(NamedTuple):
    log_z: torch.Tensor
    k_eff: torch.Tensor        # real rows covered by the probed blocks
    top_score: torch.Tensor    # best inner product found (for p(i_hat))
    top_id: torch.Tensor       # original row id of the argmax


def mimps_ivf(index: _mips.IVFIndex, q: torch.Tensor, n_probe: int, l: int,
              generator: Optional[torch.Generator] = None, *,
              idx: Optional[torch.Tensor] = None,
              use_kernel: bool = True) -> IVFEstimate:
    """Sublinear MIMPS: the head is every row of the top-n_probe IVF blocks,
    scored exactly (``ivf_score`` with ``use_kernel``, else its plain
    version); the tail is l uniform rows ``idx`` (..., l), those in probed
    blocks rejected, scaled by (N - k_eff) / #survivors (Eq. 5 with
    rejection). Cost O(n_blocks d + n_probe block_rows d + l d)."""
    batch = q.shape[:-1]
    qb = _as_rows(q)
    nq, d = qb.shape
    br = index.block_rows
    blocks = _mips.probe_batch(index, qb, n_probe)             # (B, p)
    score = ivf_score if use_kernel else ivf_score_plain
    head_scores = score(index.v_blocks, qb, blocks).reshape(nq, -1)
    head_valid = index.valid[blocks.long()].reshape(nq, -1)
    k_eff = head_valid.sum(-1)
    n = index.n
    if idx is None:
        idx = _draw(generator, n, (nq, l), qb.device)
    idx = idx.to(qb.device).long().reshape(-1, l).expand(nq, l)
    slots = index.slot_of_row[idx].long()
    in_head = ((slots // br)[..., None] == blocks[:, None, :].long()).any(-1)
    flat = index.v_blocks.reshape(-1, d)
    tail_scores = torch.einsum("qld,qd->ql", flat[slots].float(), qb.float())
    log_z = head_tail_log_z(head_scores, tail_scores,
                            (n - k_eff).float(), (~in_head).sum(-1).float(),
                            head_mask=head_valid, tail_mask=~in_head)
    masked = torch.where(head_valid, head_scores,
                         torch.full_like(head_scores, NEG_INF))
    best = torch.argmax(masked, -1)
    best_block = torch.gather(blocks.long(), 1, (best // br)[:, None])[:, 0]
    top_id = index.row_id[best_block, best % br]
    top_score = torch.gather(masked, 1, best[:, None])[:, 0]
    return IVFEstimate(log_z=log_z.reshape(batch),
                       k_eff=k_eff.reshape(batch),
                       top_score=top_score.reshape(batch),
                       top_id=top_id.reshape(batch))


# ---------------------------------------------------------------------------
# Per-query dispatcher (oracle/study path)
# ---------------------------------------------------------------------------
# The single-query analogue of the batched serving registry in
# ``core.backends``: same method names, same semantics, for the paper's
# accuracy studies. ``draws`` is the method's injected uniform draws (idx
# for uniform and index-backed mimps, tail_pos for oracle mimps and mince).

def _exact(v, q, use_kernel):
    if not use_kernel:
        return exact_log_z(v, q)
    return topk_z(_as_rows(q), v, 1)[0].reshape(q.shape[:-1])


def _fmbe(state, q, use_kernel):
    if not use_kernel:
        return fmbe_log_z(state, q)
    z = fmbe_z_batch(state, _as_rows(q), True).reshape(q.shape[:-1])
    return torch.log(torch.clamp(z, min=1e-30))


_PER_QUERY = {
    "exact": lambda v, q, gen, opt: _exact(v, q, opt["use_kernel"]),
    "mimps": lambda v, q, gen, opt: (
        mimps_ivf(opt["index"], q, opt["n_probe"], opt["l"], gen,
                  idx=opt["draws"], use_kernel=opt["use_kernel"]).log_z
        if opt["index"] is not None
        else mimps_log_z(v, q, opt["k"], opt["l"], gen,
                         tail_pos=opt["draws"])),
    "nmimps": lambda v, q, gen, opt: nmimps_log_z(v, q, opt["k"]),
    "uniform": lambda v, q, gen, opt: uniform_log_z(v, q, opt["l"], gen,
                                                    idx=opt["draws"]),
    "mince": lambda v, q, gen, opt: mince_log_z(
        v, q, opt["k"], opt["l"], gen, iters=opt["mince_iters"],
        solver=opt["mince_solver"], tail_pos=opt["draws"]),
    "fmbe": lambda v, q, gen, opt: _fmbe(opt["fmbe_state"], q,
                                         opt["use_kernel"]),
    "selfnorm": lambda v, q, gen, opt: torch.zeros(q.shape[:-1],
                                                   device=q.device),
}


def estimate_log_z(method: str, v: torch.Tensor, q: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   k: int = 100, l: int = 100,
                   index: Optional[_mips.IVFIndex] = None,
                   n_probe: int = 8,
                   fmbe_state: Optional[FMBEState] = None,
                   mince_iters: int = 25, mince_solver: str = "halley",
                   draws: Optional[torch.Tensor] = None,
                   use_kernel: bool = True) -> torch.Tensor:
    """log Ẑ of ``method`` for q (d,) or (..., d)."""
    try:
        fn = _PER_QUERY[method]
    except KeyError:
        raise ValueError(f"unknown partition method {method!r}; "
                         f"have {sorted(_PER_QUERY)}") from None
    if method == "fmbe" and fmbe_state is None:
        raise ValueError("fmbe requires a prebuilt FMBEState")
    return fn(v, q, generator, dict(
        k=k, l=l, index=index, n_probe=n_probe, fmbe_state=fmbe_state,
        mince_iters=mince_iters, mince_solver=mince_solver, draws=draws,
        use_kernel=use_kernel))


def relative_error(log_z_hat: torch.Tensor,
                   log_z_true: torch.Tensor) -> torch.Tensor:
    """|Z_hat - Z| / Z, computed stably in the log domain (the paper's mu
    over 100)."""
    return torch.abs(1.0 - torch.exp(log_z_hat - log_z_true))
