"""Training losses (counterpart of ``repro.train.losses``).

 * fused_ce : streaming softmax CE through the fused CE kernels
   (``kernels.ops.fused_cross_entropy``). The device chooses the
   implementation: CUDA tensors always launch the kernel pair, CPU tensors
   run its plain version. ``backend`` keeps the JAX package's name and
   values ("xla", "pallas") and selects nothing.
 * ce       : naive full-logits CE (small vocab / tests).
 * selfnorm : streaming CE + alpha * log(Z)^2 penalty (Devlin et al.).
 * nce      : noise-contrastive estimation with Z clamped to 1, uniform
   noise (the paper's SS5.2 training setup).
 * sampled  : importance-sampled softmax with a uniform proposal.
 * mimps_ce / mince_ce : estimator-backed CE. log Ẑ comes from the IVF
   probe-union head, scored exactly against the live ``w``, plus the
   Rao-Blackwellised uniform tail (Eq. 5); the backward writes embedding
   gradients into the head, tail and label rows only (``_SparseCE``). The
   two names share one estimate: the anchored MINCE root is the Eq. 5
   anchor. They need the ``IVFIndex`` that ``init_train_state`` puts in
   ``TrainState.index``.
 * lsh_ce   : the same sparse CE over the SimHash collision head
   (``core.lsh``), with an ``LSHIndex`` in ``TrainState.index``.

Randomness: ``key`` is a ``torch.Generator`` (the JAX package's PRNG key);
every draw can be injected instead (``noise``, ``tail_idx``, ``tail_ids``),
as the tests do with the JAX package's draws. The probe and tail plans
carry no gradient: they are built from ``h.detach()`` under ``no_grad``.

``_SparseCE`` scores with plain ``torch.matmul`` over gathered rows (the
JAX package computes these products outside any Pallas kernel). Its dw is
bit-reproducible on CUDA: the head's rows are unique once the columns no
token scores are dropped, so they are written once, and the tail and label
rows, which repeat, are summed by ``core.kmeans.segment_sums`` in a fixed
order (``index_add_`` adds with atomics on CUDA).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core import lsh as _lsh
from ..core.distributed import (data_coord, data_groups, gather_data,
                                split_group)
from ..core.decode import (_masked_tail_lse, _with_trimmed_head,
                           head_row_table, make_plan, tail_row_ids)
from ..core.estimators import NEG_INF, combine_head_tail_lse
from ..core.kmeans import segment_sums
from ..kernels.ops import fused_cross_entropy

BACKENDS = ("xla", "pallas")


def streaming_ce(h, w, labels, *, backend: str = "xla", vocab: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse) per token; h (T, d), w (V, d). ``backend`` is accepted
    for the JAX signature; the tensors' device picks kernel or plain
    version. Where w holds fewer than ``vocab`` rows (a train step's vocab
    slice), the pair runs vocab-parallel over the 'model' group."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    split = bool(vocab) and w.shape[0] != vocab
    return fused_cross_entropy(h, w, labels,
                               split_group() if split else None)


def _flatten_head(model, params, hidden, labels):
    """Returns (h2d (T, d), w (V, d), lab (T,)). A codebook head (C, V, d)
    becomes one head of C·V rows, as in the JAX package: each token's
    hidden state repeated C times (token-major), codebook c's label
    offset by c·V. So the streaming losses normalise a token over all C·V
    rows together, where ``loss_ce`` normalises each codebook over its own
    V."""
    cfg = model.cfg
    w = model.head_matrix(params)
    if cfg.n_codebooks:
        c, t = cfg.n_codebooks, hidden.shape[0] * hidden.shape[1]
        h2 = hidden.reshape(t, -1).repeat_interleave(c, dim=0)
        offset = torch.arange(c, device=labels.device) * cfg.vocab
        lab = labels.reshape(t, c).long() + offset
        return h2, w.reshape(c * cfg.vocab, -1), lab.reshape(-1)
    return hidden.reshape(-1, hidden.shape[-1]), w, labels.reshape(-1)


def _head_rows(cfg) -> int:
    """Rows of the whole (flattened) head: V, or C·V with codebooks."""
    return cfg.vocab * max(cfg.n_codebooks, 1)


def _moe_terms(aux) -> Dict:
    return {k: v for k, v in aux.items() if "moe" in k}


def loss_fused_ce(model, params, batch, key, train_cfg, *,
                  backend="xla") -> Tuple[torch.Tensor, Dict]:
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = model.forward(params, tokens, img=batch.get("img"))
    h2, w, lab = _flatten_head(model, params, hidden, labels)
    nll, lse = streaming_ce(h2, w, lab, backend=backend,
                            vocab=_head_rows(model.cfg))
    loss = nll.mean()
    metrics = {"loss": loss, "ppl_proxy": loss, "mean_log_z": lse.mean(),
               **_moe_terms(aux)}
    total = loss + aux.get("moe_balance", 0.0) + aux.get("moe_zloss", 0.0)
    return total, metrics


def loss_ce(model, params, batch, key, train_cfg) -> Tuple[torch.Tensor,
                                                           Dict]:
    """Naive full-logits CE — small vocabs/tests. With codebooks the
    logits are (B, S, C, V): each codebook normalised over its own V."""
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = model.forward(params, tokens, img=batch.get("img"))
    logits = model.logits(params, hidden)
    lse = torch.logsumexp(logits, -1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (lse - picked).mean()
    total = nll + aux.get("moe_balance", 0.0) + aux.get("moe_zloss", 0.0)
    return total, {"loss": nll, "mean_log_z": lse.mean()}


def loss_selfnorm(model, params, batch, key, train_cfg, *,
                  backend="xla") -> Tuple[torch.Tensor, Dict]:
    """CE + alpha log(Z)^2 (Devlin) — trains Z(q) ~= 1 so that serving can
    use method='selfnorm'."""
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = model.forward(params, tokens, img=batch.get("img"))
    h2, w, lab = _flatten_head(model, params, hidden, labels)
    nll, lse = streaming_ce(h2, w, lab, backend=backend,
                            vocab=_head_rows(model.cfg))
    alpha = train_cfg.selfnorm_alpha
    penalty = torch.mean(lse ** 2)
    loss = nll.mean() + alpha * penalty
    return loss + aux.get("moe_balance", 0.0), {
        "loss": nll.mean(), "mean_log_z": lse.mean(),
        "selfnorm_penalty": penalty}


# ---------------------------------------------------------------------------
# Sparse estimator-backed CE (``repro.train.losses._sparse_ce``)
# ---------------------------------------------------------------------------

class SparseCERes(NamedTuple):
    """What the backward of ``_SparseCE`` reads: the inputs, the head's
    live columns (``rows`` unique, ``mask`` (T, H)) and the forward's f32
    (or f64) scores and estimate."""
    h: torch.Tensor
    w: torch.Tensor
    labels: torch.Tensor
    rows: torch.Tensor
    mask: torch.Tensor
    tail_ids: torch.Tensor
    tail_accept: torch.Tensor
    n_tail_total: torch.Tensor
    label_in_head: torch.Tensor
    scores: torch.Tensor
    ts: torch.Tensor
    s_lab: torch.Tensor
    n_acc: torch.Tensor
    log_z: torch.Tensor


def _compute_dtype(h: torch.Tensor) -> torch.dtype:
    """f32 products for f32 and bf16 operands (JAX's preferred_element_type);
    float64 operands are evaluated in float64 (a reference)."""
    return torch.float64 if h.dtype == torch.float64 else torch.float32


def _sparse_ce_fwd(h, w, labels, head_rows, head_mask, tail_ids,
                   tail_accept, tail_bias, n_tail_total, label_in_head
                   ) -> Tuple[torch.Tensor, torch.Tensor, SparseCERes]:
    """(nll (T,), log Ẑ (T,), residual) of the sparse CE.

    Head columns that no token scores (pad slots, pad rows, a trimmed
    union's tail) add exactly 0 to every sum, forward and backward, so they
    are dropped first; the columns left hold distinct rows. Tail samples
    get ``tail_bias`` added (the Hajek form of an importance-sampled tail;
    all zeros is the uniform ratio estimator), and the label's exact term
    joins Ẑ where its block (or bucket) was not probed."""
    ct = _compute_dtype(h)
    live = head_mask.any(0)
    rows = head_rows[live].long()
    mask = head_mask[:, live]
    hf = h.to(ct)
    scores = hf @ w[rows].to(ct).T                              # (T, H)
    # an empty head gives -inf, which the combine below guards
    head_lse = torch.logsumexp(
        torch.where(mask, scores, torch.full_like(scores, NEG_INF)), -1)
    bias = tail_bias.to(ct)
    ts = hf @ w[tail_ids.long()].to(ct).T + bias[None, :]       # (T, l)
    n_acc = (tail_accept * torch.exp(bias)[None, :]).sum(-1)
    tail_lse = _masked_tail_lse(ts, tail_accept)
    log_z0 = combine_head_tail_lse(head_lse, tail_lse,
                                   n_tail_total.to(ct), n_acc)
    s_lab = (hf * w[labels.long()].to(ct)).sum(-1)
    log_z = torch.where(label_in_head, log_z0,
                        torch.logaddexp(log_z0, s_lab))
    res = SparseCERes(h=h, w=w, labels=labels, rows=rows, mask=mask,
                      tail_ids=tail_ids, tail_accept=tail_accept,
                      n_tail_total=n_tail_total.to(ct),
                      label_in_head=label_in_head, scores=scores, ts=ts,
                      s_lab=s_lab, n_acc=n_acc, log_z=log_z)
    return log_z - s_lab, log_z, res


def _add_rows(dw: torch.Tensor, ids: torch.Tensor, x: torch.Tensor) -> None:
    """dw[ids] += x for ids that may repeat, in a fixed order: the rows of
    x are summed per distinct id by ``segment_sums`` (row order), then each
    sum is added to its row of dw once."""
    uniq, inv = torch.unique(ids.long(), return_inverse=True)
    sums = segment_sums(x, inv, uniq.shape[0]).to(dw.dtype)
    dw[uniq] = dw[uniq] + sums


def _sparse_ce_bwd(res: SparseCERes, g_nll: torch.Tensor,
                   g_lz: torch.Tensor, *, cast: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh, dw) of the sparse CE: d nll / d s_i is p̂_i over the sparse
    support, so dw has the head, tail and label rows only, added in JAX's
    order (head, tail, label). ``cast=False`` returns them in the compute
    dtype, before the cast to h's and w's dtypes."""
    ct = res.scores.dtype
    hf = res.h.to(ct)
    g_nll = g_nll.to(ct)
    g1 = g_nll + g_lz.to(ct)                                    # log Ẑ path
    log_z = res.log_z[:, None]
    p = torch.where(res.mask, torch.exp(res.scores - log_z),
                    torch.zeros_like(res.scores)) * g1[:, None]  # (T, H)
    ok = (res.n_tail_total > 0) & (res.n_acc > 0)
    sigma = torch.where(ok, res.n_tail_total
                        / torch.clamp(res.n_acc, min=1e-9),
                        torch.zeros_like(res.n_acc))
    qc = torch.where(res.tail_accept, torch.exp(res.ts - log_z),
                     torch.zeros_like(res.ts)) * (sigma * g1)[:, None]
    r = torch.where(res.label_in_head, torch.zeros_like(res.s_lab),
                    torch.exp(res.s_lab - res.log_z))
    lab_coef = g1 * r - g_nll                                   # (T,)
    w_head = res.w[res.rows].to(ct)
    w_tail = res.w[res.tail_ids.long()].to(ct)
    dh = (p @ w_head + qc @ w_tail
          + lab_coef[:, None] * res.w[res.labels.long()].to(ct))
    del w_head, w_tail
    dw = torch.zeros(res.w.shape, dtype=ct, device=res.w.device)
    dw[res.rows] = p.T @ hf                      # distinct rows: one write
    del p
    _add_rows(dw, res.tail_ids, qc.T @ hf)
    _add_rows(dw, res.labels, lab_coef[:, None] * hf)
    if cast:
        return dh.to(res.h.dtype), dw.to(res.w.dtype)
    return dh, dw


class _SparseCE(torch.autograd.Function):
    """(nll, log Ẑ) per token from a sparse row table, with the sparse
    backward of ``_sparse_ce_bwd``. Only h and w take gradients."""

    @staticmethod
    def forward(ctx, h, w, labels, head_rows, head_mask, tail_ids,
                tail_accept, tail_bias, n_tail_total, label_in_head):
        nll, log_z, res = _sparse_ce_fwd(
            h.detach(), w.detach(), labels, head_rows, head_mask, tail_ids,
            tail_accept, tail_bias, n_tail_total, label_in_head)
        ctx.res = res
        return nll, log_z

    @staticmethod
    def backward(ctx, g_nll, g_lz):
        dh, dw = _sparse_ce_bwd(ctx.res, g_nll, g_lz)
        del ctx.res
        return (dh, dw) + (None,) * 8


def _sparse_ce(h, w, labels, head_rows, head_mask, tail_ids, tail_accept,
               tail_bias, n_tail_total, label_in_head):
    """(nll, log Ẑ) per token; see ``_sparse_ce_fwd``."""
    return _SparseCE.apply(h, w, labels, head_rows, head_mask, tail_ids,
                           tail_accept, tail_bias, n_tail_total,
                           label_in_head)


class SparsePlan(NamedTuple):
    """The arguments of ``_sparse_ce`` besides h and w, as an estimator
    loss builds them (``estimator_plan``, ``lsh_estimator_plan``)."""
    labels: torch.Tensor
    head_rows: torch.Tensor
    head_mask: torch.Tensor
    tail_ids: torch.Tensor
    tail_accept: torch.Tensor
    tail_bias: torch.Tensor
    n_tail_total: torch.Tensor
    label_in_head: torch.Tensor


def _aux(label_in_head, k_eff, head_live) -> Dict[str, torch.Tensor]:
    return {"head_hit_rate": label_in_head.float().mean(),
            "k_eff": k_eff.float().mean(), "head_live": head_live}


def estimator_plan(index, h, labels, generator=None, *, n_probe: int,
                   l: int, head_cap: int = 0,
                   tail_idx: Optional[torch.Tensor] = None):
    """The plan of ``estimator_ce`` without the loss: (``SparsePlan`` on
    the union trimmed to ``head_cap`` blocks when it fits, aux metrics)."""
    with torch.no_grad():
        plan = make_plan(index, h.detach(), n_probe, l, generator=generator,
                         tail_idx=tail_idx)
        br = index.v_blocks.shape[1]
        lab = labels.long()
        lab_block = torch.div(index.slot_of_row[lab], br,
                              rounding_mode="floor")
        label_in_head = (plan.block_ids == lab_block[:, None]).any(-1)
        tail_ids = tail_row_ids(index, plan)
        # a tail sample that IS the label is dropped: its mass enters Ẑ
        # exactly (head or explicit term), so the tail estimates the rest
        accept = plan.tail_accept & (tail_ids[None, :] != lab[:, None])
        n_tail_total = (index.n - plan.k_eff).float() \
            - (~label_in_head).float()

        def table(head_ids, member):
            head_rows, head_mask = head_row_table(index, head_ids, member)
            return SparsePlan(labels, head_rows, head_mask, tail_ids, accept,
                              torch.zeros(tail_ids.shape, device=h.device),
                              n_tail_total, label_in_head)

        capacity = plan.head_ids.shape[0]
        sp = _with_trimmed_head(plan, head_cap if head_cap > 0 else capacity,
                                table)
    return sp, _aux(label_in_head, plan.k_eff, plan.head_live)


def estimator_ce(index, h: torch.Tensor, w: torch.Tensor,
                 labels: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 n_probe: int, l: int, head_cap: int = 0,
                 tail_idx: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Estimator-backed CE over a token batch: plan once, score sparsely.

    The index supplies routing only (probe centroids, block layout, tail
    map); every score comes from the live ``w`` through ``head_row_table``
    and ``tail_row_ids``, so the loss is exact at the current parameters
    even when the index is a few refreshes stale (the index's row copies
    are what drifts between refreshes, which is why this path does not
    score through ``ivf_score``). The l tail rows come from ``generator``
    or are given as ``tail_idx (l,)``. ``head_cap`` (blocks) trims the
    scored union when the measured union fits (one host read), else the
    full min(T * n_probe, n_blocks) capacity is scored; 0 = no trim.

    Returns (nll (T,), log Ẑ (T,), aux metrics)."""
    sp, aux = estimator_plan(index, h, labels, generator, n_probe=n_probe,
                             l=l, head_cap=head_cap, tail_idx=tail_idx)
    nll, log_z = _sparse_ce(h, w, *sp)
    return nll, log_z, aux


def lsh_estimator_plan(lsh_index, h, labels, generator=None, *, l: int,
                       cand_cap: int = 0,
                       tail_ids: Optional[torch.Tensor] = None):
    """The plan of ``lsh_estimator_ce`` without the loss: (``SparsePlan``,
    aux metrics, the ``LshPlan``)."""
    with torch.no_grad():
        plan = _lsh.lsh_plan(lsh_index, h.detach(), l, generator=generator,
                             tail_ids=tail_ids,
                             cand_cap=cand_cap if cand_cap > 0
                             else lsh_index.n)
        lab = labels.long()
        lab_codes = lsh_index.codes[lab]                        # (T, L)
        lab_ok = lsh_index.slot_of_row[lab] >= 0
        label_in_head = ((plan.qcodes == lab_codes) & lab_ok).any(-1)
        accept = plan.tail_accept & (plan.tail_ids[None, :].long()
                                     != lab[:, None])
        n_tail_total = (lsh_index.n - plan.k_eff).float() \
            - (~label_in_head).float()

        def table(rows, member, col_live):
            del col_live       # membership already encodes dead columns
            return SparsePlan(labels, rows, member, plan.tail_ids, accept,
                              plan.tail_bias, n_tail_total, label_in_head)

        sp = _lsh._with_trimmed_cands(plan, table)
    return sp, _aux(label_in_head, plan.k_eff, plan.cand_live), plan


def lsh_estimator_ce(lsh_index, h: torch.Tensor, w: torch.Tensor,
                     labels: torch.Tensor,
                     generator: Optional[torch.Generator] = None, *, l: int,
                     cand_cap: int = 0,
                     tail_ids: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Estimator-backed CE routed through the SimHash index: the LSH twin
    of ``estimator_ce`` on the same ``_sparse_ce``. The head is the
    row-granular candidate union. Head membership, tail rejection and
    ``label_in_head`` all evaluate the one collision predicate, so every
    row lands in exactly one of {head, tail population, explicit label
    term}. The tail is drawn from ``generator`` (the defensive-mixture
    proposal) or given as ``tail_ids (l,)``; ``cand_cap`` trims the union
    like ``head_cap`` (0 = no trim)."""
    sp, aux, _ = lsh_estimator_plan(lsh_index, h, labels, generator, l=l,
                                    cand_cap=cand_cap, tail_ids=tail_ids)
    nll, log_z = _sparse_ce(h, w, *sp)
    return nll, log_z, aux


# ---------------------------------------------------------------------------
# nce, sampled and the estimator-backed loss entry points
# ---------------------------------------------------------------------------

def _noise(key, shape, v: int, device, noise):
    if noise is not None:
        return torch.as_tensor(noise, device=device).long()
    if key is None:
        raise ValueError("a sampled loss needs a torch.Generator or "
                         "injected noise")
    return torch.randint(0, v, shape, generator=key, device=device)


def _sampled_scores(model, params, batch, key, train_cfg, noise):
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = model.forward(params, tokens, img=batch.get("img"))
    h2, w, lab = _flatten_head(model, params, hidden, labels)
    t, v = h2.shape[0], w.shape[0]
    kn = train_cfg.nce_noise
    ids = _noise(key, (t, kn), v, h2.device, noise)
    s_t = (h2 * w[lab.long()]).sum(-1).float()
    s_n = torch.einsum("td,tkd->tk", h2, w[ids]).float()
    return s_t, s_n, v, kn, aux


def loss_nce(model, params, batch, key, train_cfg, *,
             noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor,
                                                            Dict]:
    """NCE with Z clamped to 1 and uniform noise (the paper's SS5.2
    setup): ``train_cfg.nce_noise`` noise words a token, drawn from ``key``
    or given as ``noise (T, k)``."""
    s_t, s_n, v, kn, aux = _sampled_scores(model, params, batch, key,
                                           train_cfg, noise)
    log_q = -math.log(float(v))                      # uniform noise
    log_k = math.log(float(kn))
    pos = torch.nn.functional.logsigmoid(s_t - log_k - log_q)
    neg = torch.nn.functional.logsigmoid(-(s_n - log_k - log_q))
    loss = -(pos.mean() + neg.sum(-1).mean())
    return loss + aux.get("moe_balance", 0.0), {"loss": loss}


def loss_sampled(model, params, batch, key, train_cfg, *,
                 noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor,
                                                                Dict]:
    """Importance-sampled softmax with a uniform proposal (the UNIFORM
    baseline as a training objective): log Ẑ = log((V / k) sum exp s_n)
    over ``noise (T, k)`` samples, drawn from ``key`` or given."""
    s_t, s_n, v, kn, aux = _sampled_scores(model, params, batch, key,
                                           train_cfg, noise)
    log_z = (torch.logsumexp(s_n, -1) + math.log(float(v))
             - math.log(float(kn)))
    loss = (log_z - s_t).mean()
    return loss + aux.get("moe_balance", 0.0), {"loss": loss,
                                                "mean_log_z": log_z.mean()}


_PER_TOKEN = ("labels", "head_mask", "tail_accept", "n_tail_total",
              "label_in_head")


def _plan_whole_batch(plan_fn, h2, lab):
    """``plan_fn(h, labels) -> (SparsePlan, aux)`` over the whole batch
    where a train step splits its rows over data replicas
    (``core.distributed.data_groups``): the detached hidden states and
    labels gathered from every replica, one head union and one tail
    planned on every rank (equal generator states draw an equal tail),
    and the plan's per-token entries cut to this rank's rows. The aux
    metrics are the whole batch's."""
    if not data_groups():
        return plan_fn(h2, lab)
    sp, aux = plan_fn(gather_data(h2), gather_data(lab))
    t = h2.shape[0]
    rows = slice(data_coord() * t, (data_coord() + 1) * t)
    return sp._replace(**{k: getattr(sp, k)[rows] for k in _PER_TOKEN}), aux


def _estimator_head(model, params, batch, index, what: str):
    if index is None:
        raise ValueError(
            f"{what} needs a retrieval index threaded through TrainState "
            f"(init_train_state builds it; make_index_refresh refreshes it)")
    if model.cfg.n_codebooks:
        raise NotImplementedError(
            "estimator-backed CE serves single-stream heads; audio "
            "codebook training uses the per-codebook exact losses")
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = model.forward(params, tokens, img=batch.get("img"))
    h2, w, lab = _flatten_head(model, params, hidden, labels)
    return h2, w, lab, aux


def _estimator_metrics(nll, lse, est_aux, aux):
    loss = nll.mean()
    metrics = {"loss": loss, "ppl_proxy": loss, "mean_log_z": lse.mean(),
               **est_aux, **_moe_terms(aux)}
    total = loss + aux.get("moe_balance", 0.0) + aux.get("moe_zloss", 0.0)
    return total, metrics


def _loss_estimator_ce(model, params, batch, key, train_cfg, *, index,
                       tail_idx: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """Shared body of mimps_ce and mince_ce (by the collapse identity the
    anchored MINCE root is the Eq. 5 anchor: one estimate, one sparse
    backward). The tail is drawn from ``key`` or given as ``tail_idx``."""
    h2, w, lab, aux = _estimator_head(model, params, batch, index,
                                      "an estimator-backed loss")
    pc = model.cfg.partition
    sp, est_aux = _plan_whole_batch(
        lambda h, lb: estimator_plan(index, h, lb, key, n_probe=pc.n_probe,
                                     l=pc.l, head_cap=pc.head_cap,
                                     tail_idx=tail_idx), h2, lab)
    nll, lse = _sparse_ce(h2, w, *sp)
    return _estimator_metrics(nll, lse, est_aux, aux)


def loss_mimps_ce(model, params, batch, key, train_cfg, *, index,
                  tail_idx: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Eq. 5-backed CE: exact probe-union head + Rao-Blackwellised uniform
    tail, sparse embedding gradients."""
    return _loss_estimator_ce(model, params, batch, key, train_cfg,
                              index=index, tail_idx=tail_idx)


def loss_mince_ce(model, params, batch, key, train_cfg, *, index,
                  tail_idx: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Anchored-MINCE CE: its root is the Eq. 5 anchor, so the estimate
    and the gradient are ``mimps_ce``'s; registered so that loss names
    mirror the serving methods."""
    return _loss_estimator_ce(model, params, batch, key, train_cfg,
                              index=index, tail_idx=tail_idx)


def loss_lsh_ce(model, params, batch, key, train_cfg, *, index,
                tail_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """SimHash-backed estimator CE: the ``lsh`` serving method's training
    twin, with an ``LSHIndex`` in ``TrainState.index``. The tail is drawn
    from ``key`` or given as ``tail_ids``."""
    h2, w, lab, aux = _estimator_head(model, params, batch, index, "lsh_ce")
    pc = model.cfg.partition
    sp, est_aux = _plan_whole_batch(
        lambda h, lb: lsh_estimator_plan(index, h, lb, key, l=pc.l,
                                         cand_cap=pc.head_cap,
                                         tail_ids=tail_ids)[:2], h2, lab)
    nll, lse = _sparse_ce(h2, w, *sp)
    return _estimator_metrics(nll, lse, est_aux, aux)


LOSSES: Dict[str, Callable] = {
    "fused_ce": loss_fused_ce,
    "ce": loss_ce,
    "selfnorm": loss_selfnorm,
    "nce": loss_nce,
    "sampled": loss_sampled,
    "mimps_ce": loss_mimps_ce,
    "mince_ce": loss_mince_ce,
    "lsh_ce": loss_lsh_ce,
}

# losses whose forward/backward go through a device-resident retrieval index
# (an IVFIndex for mimps_ce/mince_ce, an LSHIndex for lsh_ce)
ESTIMATOR_LOSSES = ("mimps_ce", "mince_ce", "lsh_ce")

# the injected draw of each sampled loss: its keyword argument
DRAW_ARGS = {"nce": "noise", "sampled": "noise", "mimps_ce": "tail_idx",
             "mince_ce": "tail_idx", "lsh_ce": "tail_ids"}


def get_loss(name: str) -> Callable:
    return LOSSES[name]
