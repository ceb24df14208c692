"""Batched decode paths from coarse probe to log Ẑ (counterpart of
``repro.core.decode``: MIMPS, MINCE, FMBE, the head-only top-k, the exact
pass and the self-normalised head).

Per decode step for a query batch h (Q, d):

    probe_batch ──► (Q, p) block ids
    plan_heads  ──► union table (U,) + membership mask (Q, U)
    plan_tail   ──► l shared tail samples + rejection mask (Q, l)
    ivf_decode  ──► head_lse, tail_lse, top-k        (CUDA kernel, MIMPS)
    combine_head_tail_lse ──► log Ẑ                   Eq. 5, n_tail = N - k_eff

MINCE, FMBE and the top-k decode share the plan and score the union through
``union_scores`` (CUDA kernel) instead; FMBE estimates the complement with
the feature sketch (``fmbe_z``, CUDA kernel) and plans no tail.

Tail samples come from a ``torch.Generator`` or are injected as ``tail_idx``
(the tests inject the JAX package's ``randint`` draws).

The plain branches (``use_kernel=False``, the CPU reference) trim the union
to ``head_cap`` slots when the measured union fits (``_with_trimmed_head``,
one host read of its size); the kernel branches read the live count on the
device and never trim. ``apply_health_guard`` routes unhealthy queries to
the exact pass (the gated ``topk_z``) without a host read.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..kernels.ivf_score import ivf_decode, union_scores
from ..kernels.topk_z import select_topk, topk_z
from . import mips as _mips
from .estimators import NEG_INF, combine_head_tail_lse
from .feature_maps import FMBEState, fmbe_tail_z, fmbe_z_batch


class DecodePlan(NamedTuple):
    block_ids: torch.Tensor    # (Q, p)  per-query probed blocks
    head_ids: torch.Tensor     # (U,)    deduplicated union (pad = repeat last)
    head_live: torch.Tensor    # ()      number of real (non-pad) union slots
    head_member: torch.Tensor  # (Q, U)  bool membership mask
    tail_blocks: torch.Tensor  # (l,)    block of each shared tail sample
    tail_rows: torch.Tensor    # (l,)    row-in-block of each shared tail sample
    tail_accept: torch.Tensor  # (Q, l)  bool rejection mask
    k_eff: torch.Tensor        # (Q,)    real rows covered by probed blocks
    n_accept: torch.Tensor     # (Q,)    post-rejection tail sample count


class DecodeOut(NamedTuple):
    log_z: torch.Tensor        # (Q,)
    top_score: torch.Tensor    # (Q, k)
    top_id: torch.Tensor       # (Q, k) original row ids
    head_lse: torch.Tensor     # (Q,)
    tail_lse: torch.Tensor     # (Q,)  -inf where no tail sample survived
    k_eff: torch.Tensor        # (Q,)
    head_live: Any = None      # ()   measured union size U (probe paths)


def plan_heads(block_ids: torch.Tensor, capacity: int):
    """Deduplicate a (Q, p) probe table into (head_ids (capacity,) int32,
    member (Q, capacity) bool, n_unique ()). The union is sorted and
    compacted to the front; pad slots repeat the last unique id and are
    masked out of every membership row. No host synchronisation."""
    flat = torch.sort(block_ids.reshape(-1)).values
    is_new = torch.ones_like(flat, dtype=torch.bool)
    is_new[1:] = flat[1:] != flat[:-1]
    tgt = torch.cumsum(is_new.long(), 0) - 1               # slot per element
    n_unique = tgt[-1] + 1
    head_ids = flat[-1].expand(capacity).to(torch.int32).clone()
    head_ids[tgt] = flat.to(torch.int32)
    slot_live = torch.arange(capacity, device=flat.device) < n_unique
    member = (head_ids[None, :, None] == block_ids[:, None, :]).any(-1) \
        & slot_live[None, :]
    return head_ids, member, n_unique


def draw_tail_idx(index: _mips.IVFIndex, l: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """``l`` uniform tail row ids over the index's original rows, from
    ``generator``. They do not depend on the hidden states, so a caller may
    draw them ahead of the step (``serve.generate`` fills a buffer a
    step)."""
    return torch.randint(0, index.n, (l,), generator=generator,
                         device=index.v_blocks.device)


def plan_tail(index: _mips.IVFIndex, l: int, block_ids: torch.Tensor, *,
              generator: Optional[torch.Generator] = None,
              tail_idx: Optional[torch.Tensor] = None):
    """l uniform tail samples over original rows, shared across the batch:
    (tail_blocks (l,), tail_rows (l,), accept (Q, l)). Sample j is rejected
    for query q iff its block is in q's probed set. The samples are drawn
    from ``generator`` or given as ``tail_idx (l,)``."""
    dev = block_ids.device
    if tail_idx is None:
        tail_idx = draw_tail_idx(index, l, generator)
    slots = index.slot_of_row[torch.as_tensor(tail_idx, device=dev).long()]
    tb = torch.div(slots, index.block_rows, rounding_mode="floor") \
        .to(torch.int32)
    tr = (slots % index.block_rows).to(torch.int32)
    accept = ~(tb[None, None, :] == block_ids[:, :, None]).any(1)
    return tb, tr, accept


def make_plan(index: _mips.IVFIndex, h: torch.Tensor, n_probe: int, l: int,
              *, generator: Optional[torch.Generator] = None,
              tail_idx: Optional[torch.Tensor] = None,
              active: Optional[torch.Tensor] = None) -> DecodePlan:
    """Probe + dedup + tail sample: everything the fused kernel consumes.
    ``active`` (Q,) bool marks the real queries of a padded batch; masked
    rows adopt the first live row's probe set so they never grow U."""
    block_ids = _mips.probe_batch(index, h, n_probe)
    if active is not None:
        # the first live row, gathered on the device (no host read)
        donor = block_ids.index_select(0, torch.argmax(active.int()).view(1))
        block_ids = torch.where(active[:, None], block_ids, donor)
    capacity = min(h.shape[0] * n_probe, index.n_blocks)
    head_ids, member, n_unique = plan_heads(block_ids, capacity)
    tb, tr, accept = plan_tail(index, l, block_ids, generator=generator,
                               tail_idx=tail_idx)
    k_eff = _mips.head_count(index, block_ids)
    return DecodePlan(block_ids=block_ids, head_ids=head_ids,
                      head_live=n_unique.to(torch.int32),
                      head_member=member, tail_blocks=tb, tail_rows=tr,
                      tail_accept=accept, k_eff=k_eff,
                      n_accept=accept.sum(-1))


def head_row_table(index: _mips.IVFIndex, head_ids: torch.Tensor,
                   member: torch.Tensor):
    """Original-row view of a (possibly trimmed) union slice: (head_rows
    (U*br,) row ids with pads clamped to 0, head_mask (Q, U*br) =
    membership and slot validity). With ``tail_row_ids`` it scores a plan
    against a live weight matrix: the index routes, ``w[head_rows]`` and
    ``w[tail_ids]`` supply the rows."""
    rid = index.row_id[head_ids.long()]                    # (U, br), -1 pad
    head_rows = torch.clamp(rid, min=0).reshape(-1)
    head_mask = (member[:, :, None] & (rid >= 0)[None]
                 ).reshape(member.shape[0], -1)
    return head_rows, head_mask


def tail_row_ids(index: _mips.IVFIndex, plan: DecodePlan) -> torch.Tensor:
    """Original row id of every shared tail sample, (l,)."""
    br = index.v_blocks.shape[1]
    return index.row_id.reshape(-1)[plan.tail_blocks.long() * br +
                                    plan.tail_rows.long()]


def _resolve_head_cap(head_cap: int, n_probe: int, capacity: int) -> int:
    """0 = auto: the probe width plus headroom for partial overlap."""
    if head_cap <= 0:
        head_cap = max(n_probe + max(4, n_probe // 2), 8)
    return min(head_cap, capacity)


def _with_trimmed_head(plan: DecodePlan, head_cap: int, branch_fn):
    """``branch_fn(head_ids, member)`` on the first ``head_cap`` union slots
    when the measured union fits, else on the full capacity (the same math;
    an overflow costs time, not correctness). Reads the union size to the
    host: the plain branches only."""
    capacity = plan.head_ids.shape[0]
    if head_cap >= capacity or int(plan.head_live) > head_cap:
        return branch_fn(plan.head_ids, plan.head_member)
    return branch_fn(plan.head_ids[:head_cap],
                     plan.head_member[:, :head_cap])


def _tail_rows(index: _mips.IVFIndex, plan: DecodePlan) -> torch.Tensor:
    """Shared tail rows gathered once into a dense (l, d) staging buffer."""
    flat = index.v_blocks.reshape(-1, index.v_blocks.shape[-1])
    slots = plan.tail_blocks.long() * index.block_rows + plan.tail_rows.long()
    return flat[slots]


def _masked_tail_lse(ts: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """Per-query tail LSE; genuine -inf where no sample survived."""
    tail_lse = torch.logsumexp(
        torch.where(accept, ts, torch.full_like(ts, NEG_INF)), -1)
    return torch.where(accept.any(-1), tail_lse,
                       torch.full_like(tail_lse, float("-inf")))


def _head_scores_plain(index: _mips.IVFIndex, h: torch.Tensor, head_ids,
                       member, tail_rows: torch.Tensor):
    """Gather the union's rows once and score head and tail rows with one
    f32-accumulated matmul: (scores (Q, U*br), mask (Q, U*br), tail scores
    (Q, l), global slot ids (U*br,))."""
    nb, br, d = index.v_blocks.shape
    flat = index.v_blocks.reshape(-1, d)
    slot = (head_ids.long()[:, None] * br +
            torch.arange(br, device=h.device)[None, :]).reshape(-1)
    w = torch.cat([flat[slot], tail_rows.to(flat.dtype)], 0)
    scores = h.float() @ w.float().T
    mask = (member[:, :, None] & index.valid[head_ids.long()][None]
            ).reshape(h.shape[0], -1)
    n_head = slot.shape[0]
    return scores[:, :n_head], mask, scores[:, n_head:], slot


def mimps_decode(index: _mips.IVFIndex, h: torch.Tensor, *, n_probe: int,
                 l: int, k: int = 1, use_kernel: bool = True,
                 head_cap: int = 0,
                 generator: Optional[torch.Generator] = None,
                 tail_idx: Optional[torch.Tensor] = None,
                 active: Optional[torch.Tensor] = None,
                 kernel_cfg: Optional[dict] = None) -> DecodeOut:
    """Batched sublinear decode: h (Q, d) -> log Ẑ and top-k rows, per Eq. 5.

    ``use_kernel=True`` goes through ``kernels.ivf_score.ivf_decode`` (the
    CUDA kernel on a GPU tensor, its plain version on a CPU tensor), with
    ``kernel_cfg``'s launch knobs (``kernels.autotune``);
    ``use_kernel=False`` is the reference branch of the JAX package's XLA
    path (one gather, one matmul over head and tail rows), on the union
    trimmed to ``head_cap`` slots (0 = auto) when it fits."""
    plan = make_plan(index, h, n_probe, l, generator=generator,
                     tail_idx=tail_idx, active=active)
    tail_rows_g = _tail_rows(index, plan)
    if use_kernel:
        row_logw = torch.where(index.valid, 0.0, NEG_INF).float()
        head_lse, tail_lse, topv, topi = ivf_decode(
            index.v_blocks, h, plan.head_ids, plan.head_live,
            plan.head_member, row_logw, tail_rows_g, plan.tail_accept, k=k,
            **(kernel_cfg or {}))
    else:
        def branch(ids, member):
            scores, mask, ts, slot = _head_scores_plain(
                index, h, ids, member, tail_rows_g)
            eff = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
            topv, topi = select_topk(eff, slot, k)
            return (torch.logsumexp(eff, -1), topv, topi,
                    _masked_tail_lse(ts, plan.tail_accept))

        cap = _resolve_head_cap(head_cap, n_probe, plan.head_ids.shape[0])
        head_lse, topv, topi, tail_lse = _with_trimmed_head(plan, cap,
                                                            branch)
    log_z = combine_head_tail_lse(
        head_lse, tail_lse, (index.n - plan.k_eff).float(),
        plan.n_accept.float())
    return _probe_out(index, plan, log_z, head_lse, tail_lse, topv, topi)


def union_head_scores(index: _mips.IVFIndex, h: torch.Tensor,
                      plan: DecodePlan, kernel_cfg: Optional[dict] = None):
    """Score the deduplicated probe union for every query through
    ``kernels.ivf_score.union_scores`` (with ``kernel_cfg``'s launch
    knobs), which reads the U live blocks once: (scores (Q, U, br) f32,
    mask (Q, U, br) bool)."""
    scores = union_scores(index.v_blocks, h, plan.head_ids, plan.head_live,
                          **(kernel_cfg or {}))
    mask = (plan.head_member[:, :, None] &
            index.valid[plan.head_ids.long()][None])
    return scores, mask


def _head_topk(index: _mips.IVFIndex, head_ids: torch.Tensor,
               scores: torch.Tensor, mask: torch.Tensor, k: int):
    """(head_lse, topv, top global slot ids) over masked union scores
    (Q, U*br). Ties go to the lowest slot id, which is the lowest position
    because the live head_ids are sorted (``lax.top_k``'s rule). An empty
    head keeps the logsumexp-over-NEG sentinel (about -1e30)."""
    br = index.block_rows
    eff = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    head_lse = torch.logsumexp(eff, -1)
    slot = (head_ids.long()[:, None] * br +
            torch.arange(br, device=scores.device)[None, :]).reshape(-1)
    topv, topi = select_topk(eff, slot, k)
    return head_lse, topv, topi


def _scored_head(index: _mips.IVFIndex, h: torch.Tensor, plan: DecodePlan,
                 k: int, use_kernel: bool,
                 tail_rows: Optional[torch.Tensor] = None,
                 head_cap: int = 0, kernel_cfg: Optional[dict] = None):
    """Head LSE and top-k of the plan's union, plus the (Q, l) f32 scores
    of ``tail_rows`` when given: the union through ``union_head_scores``
    (with ``kernel_cfg``) and the tail by one matmul, or (plain branch) head
    and tail rows in one gather and one matmul over the union trimmed to
    ``head_cap`` slots (0 = auto) when it fits."""
    q, d = h.shape
    if use_kernel:
        scores, mask = union_head_scores(index, h, plan, kernel_cfg)
        scores, mask = scores.reshape(q, -1), mask.reshape(q, -1)
        ts = None if tail_rows is None else h.float() @ tail_rows.float().T
        return _head_topk(index, plan.head_ids, scores, mask, k) + (ts,)
    rows = tail_rows if tail_rows is not None else h.new_zeros((0, d))

    def branch(ids, member):
        scores, mask, ts, _ = _head_scores_plain(index, h, ids, member, rows)
        return _head_topk(index, ids, scores, mask, k) + (ts,)

    cap = _resolve_head_cap(head_cap, plan.block_ids.shape[1],
                            plan.head_ids.shape[0])
    return _with_trimmed_head(plan, cap, branch)


def _probe_out(index: _mips.IVFIndex, plan: DecodePlan, log_z, head_lse,
               tail_lse, topv, topi) -> DecodeOut:
    return DecodeOut(log_z=log_z, top_score=topv,
                     top_id=index.row_id.reshape(-1)[topi.long()],
                     head_lse=head_lse, tail_lse=tail_lse, k_eff=plan.k_eff,
                     head_live=plan.head_live)


def topk_head_decode(index: _mips.IVFIndex, h: torch.Tensor, *,
                     n_probe: int, k: int = 1, use_kernel: bool = True,
                     head_cap: int = 0,
                     active: Optional[torch.Tensor] = None,
                     kernel_cfg: Optional[dict] = None) -> DecodeOut:
    """Head-only decode (Eq. 4 at the output layer), the cheapest serving
    tier: the MIMPS probe plan and candidates with no tail, so log Ẑ is the
    probed head's LSE, a deterministic underestimate of log Z.
    ``kernel_cfg``: ``union_scores``'s launch knobs."""
    plan = make_plan(index, h, n_probe, 0, active=active)
    head_lse, topv, topi, _ = _scored_head(index, h, plan, k, use_kernel,
                                           head_cap=head_cap,
                                           kernel_cfg=kernel_cfg)
    no_tail = torch.full_like(head_lse, float("-inf"))
    return _probe_out(index, plan, head_lse, head_lse, no_tail, topv, topi)


def mince_decode(index: _mips.IVFIndex, h: torch.Tensor, *, n_probe: int,
                 l: int, k: int = 1, iters: int = 2, solver: str = "halley",
                 use_kernel: bool = True, head_cap: int = 0,
                 generator: Optional[torch.Generator] = None,
                 tail_idx: Optional[torch.Tensor] = None,
                 active: Optional[torch.Tensor] = None,
                 kernel_cfg: Optional[dict] = None) -> DecodeOut:
    """Batched sublinear MINCE (Eq. 6/7): the IVF probe head against the
    plan's shared uniform tail as the noise set. The anchored NCE
    equation's root is the Eq. 5 anchor (the collapse identity of the JAX
    package's ``mince.anchored_solve``), so the estimate is taken in closed
    form there; ``iters``/``solver`` parameterise the general solvers,
    which the serving path does not run, and are ignored.

    Degenerate heads are guarded per query: k_eff == 0 falls back to the
    uniform-noise estimate over the tail, and an empty complement (k_eff ==
    N or no surviving sample) to the exactly scored head. ``kernel_cfg``:
    ``union_scores``'s launch knobs."""
    del iters, solver
    if l < 1:
        raise ValueError("MINCE needs at least one noise sample (l >= 1)")
    plan = make_plan(index, h, n_probe, l, generator=generator,
                     tail_idx=tail_idx, active=active)
    head_lse, topv, topi, ts = _scored_head(
        index, h, plan, k, use_kernel, tail_rows=_tail_rows(index, plan),
        head_cap=head_cap, kernel_cfg=kernel_cfg)
    tail_lse = _masked_tail_lse(ts, plan.tail_accept)
    k_eff = plan.k_eff.float()
    n_acc = plan.n_accept.float()
    n_tail = torch.clamp(index.n - k_eff, min=0.0)
    theta = combine_head_tail_lse(head_lse, tail_lse, n_tail, n_acc)
    uniform = combine_head_tail_lse(
        torch.full_like(head_lse, NEG_INF), tail_lse,
        torch.full_like(n_acc, float(index.n)), n_acc)
    log_z = torch.where(k_eff == 0, uniform, theta)
    log_z = torch.where((n_acc == 0) | (n_tail == 0), head_lse, log_z)
    return _probe_out(index, plan, log_z, head_lse, tail_lse, topv, topi)


def fmbe_decode(state: FMBEState, index: _mips.IVFIndex, h: torch.Tensor,
                *, n_probe: int, k: int = 1, use_kernel: bool = True,
                head_cap: int = 0,
                active: Optional[torch.Tensor] = None,
                kernel_cfg: Optional[dict] = None) -> DecodeOut:
    """Batched FMBE decode: the probed head scored exactly, the feature
    sketch estimating only the complement mass (``fmbe_tail_z``):

        log Ẑ = logaddexp(head_lse, log max(phi(h) . lambda_rest, 1e-30))

    With no per-block table the global sketch estimates all of Z. The
    estimate is deterministic given the feature map; no tail is planned.
    ``kernel_cfg``: ``fmbe_z``'s launch knobs (the head's ``union_scores``
    launches as it is)."""
    plan = make_plan(index, h, n_probe, 0, active=active)
    head_lse, topv, topi, _ = _scored_head(index, h, plan, k, use_kernel,
                                           head_cap=head_cap)
    if state.lambda_blocks is not None:
        z_tail = fmbe_tail_z(state, h, plan.block_ids, use_kernel,
                             kernel_cfg)
        log_z = torch.logaddexp(head_lse,
                                torch.log(torch.clamp(z_tail, min=1e-30)))
    else:
        z = fmbe_z_batch(state, h, use_kernel, kernel_cfg)
        log_z = torch.log(torch.clamp(z, min=1e-30))
    no_tail = torch.full_like(log_z, float("-inf"))
    return _probe_out(index, plan, log_z, head_lse, no_tail, topv, topi)


def exact_topk_decode(w: torch.Tensor, h: torch.Tensor, *, k: int = 1,
                      use_kernel: bool = True,
                      kernel_cfg: Optional[dict] = None) -> DecodeOut:
    """Exact log Z + top-k in one pass: ``kernels.topk_z.topk_z`` (with
    ``kernel_cfg``'s launch knobs) or the reference branch (logits in the
    input dtype, then f32, as the JAX package's XLA path computes them)."""
    if use_kernel:
        lse, topv, topi = topk_z(h, w, k, **(kernel_cfg or {}))
    else:
        logits = (h @ w.T).float()
        lse = torch.logsumexp(logits, -1)
        topv, topi = select_topk(
            logits, torch.arange(w.shape[0], device=h.device), k)
    q, v = h.shape[0], w.shape[0]
    return DecodeOut(log_z=lse, top_score=topv, top_id=topi,
                     head_lse=lse,
                     tail_lse=torch.full((q,), float("-inf"), device=h.device),
                     k_eff=torch.full((q,), v, dtype=torch.int32,
                                      device=h.device))


def selfnorm_decode(w: torch.Tensor, h: torch.Tensor, *, k: int = 1,
                    use_kernel: bool = True,
                    kernel_cfg: Optional[dict] = None) -> DecodeOut:
    """Self-normalised head: the exact pass's candidates with Z taken as 1
    (log Ẑ == 0; the model was trained with the selfnorm penalty)."""
    out = exact_topk_decode(w, h, k=k, use_kernel=use_kernel,
                            kernel_cfg=kernel_cfg)
    return out._replace(log_z=torch.zeros_like(out.log_z))


# ---------------------------------------------------------------------------
# Estimator health guard: no NaN reaches sampling
# ---------------------------------------------------------------------------

HEALTH_NONFINITE_Z = 1      # log Ẑ is NaN/Inf (corrupt rows, fault injection)
HEALTH_EMPTY_HEAD = 2       # the probe union covered no real row
HEALTH_NONFINITE_SCORE = 4  # a retrieved candidate score is NaN/Inf


def health_flags(out: DecodeOut) -> torch.Tensor:
    """Per-query health bitmask (Q,) int32: a non-finite log Ẑ, an empty
    probe head (k_eff == 0) or a non-finite candidate score.
    ``tail_lse == -inf`` (no surviving sample) is not flagged."""
    bad_z = ~torch.isfinite(out.log_z)
    empty = out.k_eff == 0
    bad_s = (~torch.isfinite(out.top_score)).any(-1)
    return (bad_z.int() * HEALTH_NONFINITE_Z + empty.int() * HEALTH_EMPTY_HEAD
            + bad_s.int() * HEALTH_NONFINITE_SCORE).to(torch.int32)


def apply_health_guard(out: DecodeOut, w: torch.Tensor, h: torch.Tensor,
                       k: int, active: Optional[torch.Tensor] = None, *,
                       use_kernel: bool = True):
    """Route unhealthy queries through the exact pass (the Eq. 2 fallback).

    Returns ``(guarded DecodeOut, flags (Q,) int32)``. The flags stay on the
    device: the exact pass is ``topk_z`` gated by them (``rows=flags``),
    which scores only the flagged queries, and its results are spliced into
    the flagged rows with ``torch.where``. No host read, so the guard can
    sit in every step (and in a captured graph); a healthy batch costs one
    gated launch that exits at once, and its outputs are the unguarded
    decode's, bit for bit. ``active`` (Q,) bool keeps padded lanes out of
    the check. ``use_kernel=False`` scores every row with the reference
    exact decode instead."""
    flags = health_flags(out)
    if active is not None:
        flags = torch.where(active, flags, torch.zeros_like(flags))
    bad = flags > 0
    if use_kernel:
        lse, topv, topi = topk_z(h, w, k, rows=flags)
    else:
        ex = exact_topk_decode(w, h, k=k, use_kernel=False)
        lse, topv, topi = ex.log_z, ex.top_score, ex.top_id
    row = bad[:, None]
    return DecodeOut(
        log_z=torch.where(bad, lse, out.log_z),
        top_score=torch.where(row, topv, out.top_score),
        top_id=torch.where(row, topi.to(out.top_id.dtype), out.top_id),
        head_lse=torch.where(bad, lse, out.head_lse),
        tail_lse=torch.where(bad, torch.full_like(out.tail_lse,
                                                  float("-inf")),
                             out.tail_lse),
        k_eff=out.k_eff, head_live=out.head_live), flags
