"""The output layer under the serving mesh (counterpart of the mesh-serving
bodies of ``repro.serve.output_layer``): each returns the full
``DecodeOut`` of its single-device ``core.decode`` path, bit for bit at
every mesh size (``exact`` and ``selfnorm``: the same top ids and scores,
log Z within 1e-5).

The index is split differently from the training mesh:

* the ``model`` group splits only the O(V d) payloads, the embedding rows
  ``w`` and the IVF ``v_blocks`` (``core.backends.local_shard``); every
  piece of per-block metadata (centroids, radius, valid, row_id,
  slot_of_row), the FMBE sketch and the LSH tables stay replicated;
* so the probe, dedup, trim and tail plan run the single-device code on
  replicated inputs, and every rank of a model group derives the plan a
  single device would;
* only the embedding rows are distributed: each rank gives the rows of the
  step's working set (the union head and the shared tail) that it owns
  into a zero staging buffer, and one all-reduce of their bit patterns
  (``gather_rows``) makes every rank hold the rows the single device
  reads, bit for bit. Scoring then runs on identical operands.

With ``use_kernel`` the bodies launch the kernels of the single-device
decode on the staged operands: ``ivf_decode`` (mimps) and
``union_scores`` (mince, topk, fmbe) read the staging buffer as a block
table of the union's U blocks, ids ``0 .. U - 1``, so they see the rows
of the single-device launch in the same order (``ivf_decode``'s top-k
slot ids are mapped back to the index's); ``fmbe_z`` reads the replicated
sketch as before. The staging buffer has the plan's static capacity, so
nothing here reads the host and the step can be captured in a CUDA graph.
``exact``, ``selfnorm`` and the guard run ``topk_z`` on each rank's rows
with a global id offset, then ``logspace_psum`` and the k-candidate merge.

``lsh`` keeps the plain path under the mesh: ``lsh_probe`` reads rows by
id with a dense fallback as wide as the vocabulary, which a staging buffer
would have to hold whole, so its mesh body stages the trimmed union on the
host's choice (one host read) and cannot be captured.

The dry-run bodies of the JAX module (``streaming_logz_argmax``,
``IVFSpecs``, ``sharded_*_decode``, ``sharded_decode``) serve only its
HLO dry run and are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import decode as _decode
from ..core import lsh as _lsh
from ..core import mips as _mips
from ..core.decode import DecodeOut, DecodePlan
from ..core.distributed import (bitsum_, group_rank, group_size,
                                logspace_psum, merge_topk)
from ..core.estimators import NEG_INF, combine_head_tail_lse
from ..core.feature_maps import FMBEState, fmbe_tail_z, fmbe_z_batch
from ..kernels.ivf_score import ivf_decode, union_scores
from ..kernels.topk_z import NEG, select_topk, topk_z


def gather_rows(flat_local: torch.Tensor, slots: torch.Tensor,
                group) -> torch.Tensor:
    """Rows ``slots`` of a table split by rows over ``group``: each rank
    writes the rows it owns (zeros elsewhere) and one all-reduce of their
    bit patterns gives every rank the rows exactly (one real addend an
    element, the rest 0), -0.0 and NaN included."""
    if group_size(group) == 1:             # every row is this rank's
        return bitsum_(flat_local[slots.long()], group)
    n_loc = flat_local.shape[0]
    loc = slots.long() - group_rank(group) * n_loc
    own = (loc >= 0) & (loc < n_loc)
    rows = flat_local[torch.clamp(loc, 0, n_loc - 1)]
    rows = torch.where(own[:, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return bitsum_(rows, group)


def _mesh_plan(index: _mips.IVFIndex, h: torch.Tensor, n_probe: int, l: int,
               generator, tail_idx, active) -> DecodePlan:
    """``core.decode.make_plan`` on an index whose ``v_blocks`` is the
    local shard: the capacity comes from the replicated ``valid`` (the
    global block count)."""
    block_ids = _mips.probe_batch(index, h, n_probe)
    if active is not None:
        donor = block_ids.index_select(0, torch.argmax(active.int()).view(1))
        block_ids = torch.where(active[:, None], block_ids, donor)
    capacity = min(h.shape[0] * n_probe, index.valid.shape[0])
    head_ids, member, n_unique = _decode.plan_heads(block_ids, capacity)
    tb, tr, accept = _decode.plan_tail(index, l, block_ids,
                                       generator=generator, tail_idx=tail_idx)
    k_eff = _mips.head_count(index, block_ids)
    return DecodePlan(block_ids=block_ids, head_ids=head_ids,
                      head_live=n_unique.to(torch.int32),
                      head_member=member, tail_blocks=tb, tail_rows=tr,
                      tail_accept=accept, k_eff=k_eff,
                      n_accept=accept.sum(-1))


def _tail_slots(index: _mips.IVFIndex, plan: DecodePlan) -> torch.Tensor:
    return plan.tail_blocks.long() * index.block_rows + plan.tail_rows.long()


def _gather_union(index: _mips.IVFIndex, head_ids: torch.Tensor,
                  tail_slots: Optional[torch.Tensor], group):
    """The union's rows in slot order, then the tail rows, gathered into
    one staging buffer: (rows (U * br [+ l], d), the union's global slot
    ids (U * br,))."""
    br, d = index.block_rows, index.v_blocks.shape[-1]
    slot = (head_ids.long()[:, None] * br +
            torch.arange(br, device=head_ids.device)[None, :]).reshape(-1)
    wanted = slot if tail_slots is None else torch.cat([slot, tail_slots])
    return gather_rows(index.v_blocks.reshape(-1, d), wanted, group), slot


def _stage(index: _mips.IVFIndex, head_ids: torch.Tensor,
           tail_slots: Optional[torch.Tensor], group):
    """The gathered union as a (U, br, d) block table in slot order, and
    the (l, d) tail rows or None."""
    rows, slot = _gather_union(index, head_ids, tail_slots, group)
    n_head = slot.shape[0]
    blocks = rows[:n_head].view(head_ids.shape[0], index.block_rows, -1)
    return blocks, (None if tail_slots is None else rows[n_head:])


def _head_scores(index: _mips.IVFIndex, h: torch.Tensor, head_ids, member,
                 tail_slots, group):
    """``core.decode._head_scores_plain`` with the rows gathered over the
    model group: the same staging layout and one f32 matmul over head and
    tail rows, so the same bits."""
    w, slot = _gather_union(index, head_ids, tail_slots, group)
    n_head = slot.shape[0]
    scores = h.float() @ w.float().T
    mask = (member[:, :, None] & index.valid[head_ids.long()][None]
            ).reshape(h.shape[0], -1)
    return scores[:, :n_head], mask, scores[:, n_head:], slot


def _union_kernel_scores(index: _mips.IVFIndex, h: torch.Tensor,
                         plan: DecodePlan, k: int, tail_slots, group):
    """``core.decode._scored_head``'s kernel branch on staged rows:
    ``union_scores`` over the staged union (ids 0 .. U - 1, the plan's live
    count), the tail by one matmul."""
    blocks, tail = _stage(index, plan.head_ids, tail_slots, group)
    u = plan.head_ids.shape[0]
    scores = union_scores(blocks, h, torch.arange(u, dtype=torch.int32,
                                                  device=h.device),
                          plan.head_live)
    q = h.shape[0]
    mask = (plan.head_member[:, :, None] &
            index.valid[plan.head_ids.long()][None]).reshape(q, -1)
    ts = None if tail is None else h.float() @ tail.float().T
    return _decode._head_topk(index, plan.head_ids, scores.reshape(q, -1),
                              mask, k) + (ts,)


def _scored_head(index, h, plan, k, use_kernel, tail_slots, head_cap, group):
    """``core.decode._scored_head`` under the mesh: (head_lse, topv, top
    slot ids, tail scores or None)."""
    if use_kernel:
        return _union_kernel_scores(index, h, plan, k, tail_slots, group)

    def branch(ids, member):
        scores, mask, ts, _ = _head_scores(index, h, ids, member, tail_slots,
                                           group)
        return _decode._head_topk(index, ids, scores, mask, k) + (
            None if tail_slots is None else ts,)

    cap = _decode._resolve_head_cap(head_cap, plan.block_ids.shape[1],
                                    plan.head_ids.shape[0])
    return _decode._with_trimmed_head(plan, cap, branch)


def mesh_mimps_decode(index: _mips.IVFIndex, h: torch.Tensor, *,
                      n_probe: int, l: int, k: int = 1,
                      use_kernel: bool = True, head_cap: int = 0,
                      generator: Optional[torch.Generator] = None,
                      tail_idx: Optional[torch.Tensor] = None,
                      active: Optional[torch.Tensor] = None,
                      group=None) -> DecodeOut:
    """MIMPS (Eq. 5) under the serving mesh, bit-equal to
    ``mimps_decode`` at every mesh size: ``ivf_decode`` on the staged union
    and tail, or the plain branch on the same staged rows."""
    plan = _mesh_plan(index, h, n_probe, l, generator, tail_idx, active)
    tail_slots = _tail_slots(index, plan)
    if use_kernel:
        blocks, tail = _stage(index, plan.head_ids, tail_slots, group)
        u, br = plan.head_ids.shape[0], index.block_rows
        row_logw = torch.where(index.valid[plan.head_ids.long()], 0.0,
                               NEG_INF).float()
        head_lse, tail_lse, topv, topi = ivf_decode(
            blocks, h, torch.arange(u, dtype=torch.int32, device=h.device),
            plan.head_live, plan.head_member, row_logw, tail,
            plan.tail_accept, k=k)
        # staged slot u * br + r is the index's head_ids[u] * br + r
        glob = plan.head_ids.long()[topi.long() // br] * br + topi.long() % br
        topi = torch.where(topv > NEG * 0.5, glob,
                           torch.zeros_like(glob)).to(torch.int32)
    else:
        def branch(ids, member):
            scores, mask, ts, slot = _head_scores(index, h, ids, member,
                                                  tail_slots, group)
            eff = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
            topv, topi = select_topk(eff, slot, k)
            return (torch.logsumexp(eff, -1), topv, topi,
                    _decode._masked_tail_lse(ts, plan.tail_accept))

        cap = _decode._resolve_head_cap(head_cap, n_probe,
                                        plan.head_ids.shape[0])
        head_lse, topv, topi, tail_lse = _decode._with_trimmed_head(
            plan, cap, branch)
    log_z = combine_head_tail_lse(
        head_lse, tail_lse, (index.n - plan.k_eff).float(),
        plan.n_accept.float())
    return _decode._probe_out(index, plan, log_z, head_lse, tail_lse, topv,
                              topi)


def mesh_mince_decode(index: _mips.IVFIndex, h: torch.Tensor, *,
                      n_probe: int, l: int, k: int = 1, iters: int = 2,
                      solver: str = "halley", use_kernel: bool = True,
                      head_cap: int = 0,
                      generator: Optional[torch.Generator] = None,
                      tail_idx: Optional[torch.Tensor] = None,
                      active: Optional[torch.Tensor] = None,
                      group=None) -> DecodeOut:
    """MINCE (Eq. 6/7) under the serving mesh: ``mince_decode``'s closed
    form on gathered rows (``iters``/``solver`` ignored, as there)."""
    del iters, solver
    if l < 1:
        raise ValueError("MINCE needs at least one noise sample (l >= 1)")
    plan = _mesh_plan(index, h, n_probe, l, generator, tail_idx, active)
    head_lse, topv, topi, ts = _scored_head(
        index, h, plan, k, use_kernel, _tail_slots(index, plan), head_cap,
        group)
    tail_lse = _decode._masked_tail_lse(ts, plan.tail_accept)
    k_eff = plan.k_eff.float()
    n_acc = plan.n_accept.float()
    n_tail = torch.clamp(index.n - k_eff, min=0.0)
    theta = combine_head_tail_lse(head_lse, tail_lse, n_tail, n_acc)
    uniform = combine_head_tail_lse(
        torch.full_like(head_lse, NEG_INF), tail_lse,
        torch.full_like(n_acc, float(index.n)), n_acc)
    log_z = torch.where(k_eff == 0, uniform, theta)
    log_z = torch.where((n_acc == 0) | (n_tail == 0), head_lse, log_z)
    return _decode._probe_out(index, plan, log_z, head_lse, tail_lse, topv,
                              topi)


def mesh_topk_decode(index: _mips.IVFIndex, h: torch.Tensor, *,
                     n_probe: int, k: int = 1, use_kernel: bool = True,
                     head_cap: int = 0,
                     active: Optional[torch.Tensor] = None,
                     group=None) -> DecodeOut:
    """The head-only tier (``topk_head_decode``) under the serving mesh."""
    plan = _mesh_plan(index, h, n_probe, 0, None, None, active)
    head_lse, topv, topi, _ = _scored_head(index, h, plan, k, use_kernel,
                                           None, head_cap, group)
    no_tail = torch.full_like(head_lse, float("-inf"))
    return _decode._probe_out(index, plan, head_lse, head_lse, no_tail, topv,
                              topi)


def mesh_fmbe_decode(state: FMBEState, index: _mips.IVFIndex,
                     h: torch.Tensor, *, n_probe: int, k: int = 1,
                     use_kernel: bool = True, head_cap: int = 0,
                     active: Optional[torch.Tensor] = None,
                     group=None) -> DecodeOut:
    """FMBE under the serving mesh: the sketch and its per-block lambdas
    are replicated (``fmbe_z`` as on one device); only the candidate head
    rows are gathered."""
    plan = _mesh_plan(index, h, n_probe, 0, None, None, active)
    head_lse, topv, topi, _ = _scored_head(index, h, plan, k, use_kernel,
                                           None, head_cap, group)
    if state.lambda_blocks is not None:
        z_tail = fmbe_tail_z(state, h, plan.block_ids, use_kernel)
        log_z = torch.logaddexp(head_lse,
                                torch.log(torch.clamp(z_tail, min=1e-30)))
    else:
        z = fmbe_z_batch(state, h, use_kernel)
        log_z = torch.log(torch.clamp(z, min=1e-30))
    no_tail = torch.full_like(log_z, float("-inf"))
    return _decode._probe_out(index, plan, log_z, head_lse, no_tail, topv,
                              topi)


def _exact_parts(w_local: torch.Tensor, h: torch.Tensor, k: int,
                 use_kernel: bool, rows, group):
    """(log Z, topv, global top ids) with the embedding row-split over
    ``group``: each rank's LSE and top-k (``topk_z``, gated by ``rows``, or
    the reference logits), the LSEs combined in log domain and the
    candidates merged."""
    n_loc = w_local.shape[0]
    if use_kernel:
        lse, topv, topi = topk_z(h, w_local, k, rows=rows)
    else:
        logits = (h @ w_local.T).float()
        lse = torch.logsumexp(logits, -1)
        topv, topi = select_topk(
            logits, torch.arange(n_loc, device=h.device), min(k, n_loc))
    log_z = logspace_psum(lse, group)
    topv, topi = merge_topk(topv, topi + group_rank(group) * n_loc, k, group)
    return log_z, topv, topi


def mesh_exact_decode(w_local: torch.Tensor, h: torch.Tensor, *, k: int = 1,
                      use_kernel: bool = True, group=None) -> DecodeOut:
    """Exact log Z and top-k with the embedding row-split over the model
    group. The candidates are the single-device pass's (each a score of
    one row); log Z agrees to the rounding of the reduction order."""
    log_z, topv, topi = _exact_parts(w_local, h, k, use_kernel, None, group)
    q = h.shape[0]
    v = w_local.shape[0] * group_size(group)
    return DecodeOut(log_z=log_z, top_score=topv, top_id=topi,
                     head_lse=log_z,
                     tail_lse=torch.full((q,), float("-inf"),
                                         device=h.device),
                     k_eff=torch.full((q,), v, dtype=torch.int32,
                                      device=h.device))


def mesh_selfnorm_decode(w_local: torch.Tensor, h: torch.Tensor, *,
                         k: int = 1, use_kernel: bool = True,
                         group=None) -> DecodeOut:
    out = mesh_exact_decode(w_local, h, k=k, use_kernel=use_kernel,
                            group=group)
    return out._replace(log_z=torch.zeros_like(out.log_z))


def mesh_lsh_decode(lsh_index: _lsh.LSHIndex, w_local: torch.Tensor,
                    h: torch.Tensor, *, l: int, k: int = 1,
                    cand_cap: int = 0,
                    generator: Optional[torch.Generator] = None,
                    tail_ids: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None,
                    group=None) -> DecodeOut:
    """LSH decode under the serving mesh, bit-equal to ``lsh_decode(...,
    use_kernel=False)``: the replicated index plans verbatim and the
    trimmed union (or, past its capacity, every row) with the shared tail
    is gathered with one ``gather_rows``. The trim is the host's choice
    (one read), so this body runs eagerly only (see the module
    docstring)."""
    if l < 1:
        raise ValueError("lsh_decode needs at least one tail sample (l >= 1)")
    if h.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the lsh tier under the serving mesh reads the host (its trim) "
            "and cannot be captured; serve it with Scheduler(eager=True)")
    plan = _lsh.lsh_plan(lsh_index, h, l, generator=generator,
                         tail_ids=tail_ids, active=active, cand_cap=cand_cap)

    def branch(rows, member, col_live):
        del col_live         # membership already encodes dead columns
        c = rows.shape[0]
        stacked = gather_rows(w_local, torch.cat([rows.long(),
                                                  plan.tail_ids.long()]),
                              group).float()
        scores = h.float() @ stacked.T
        eff = torch.where(member, scores[:, :c],
                          torch.full_like(scores[:, :c], NEG_INF))
        topv, topi = select_topk(eff, rows, k)
        tail_lse = _decode._masked_tail_lse(
            scores[:, c:] + plan.tail_bias[None, :], plan.tail_accept)
        return torch.logsumexp(eff, -1), tail_lse, topv, topi

    head_lse, tail_lse, topv, topi = _lsh._with_trimmed_cands(plan, branch)
    log_z = combine_head_tail_lse(head_lse, tail_lse,
                                  (lsh_index.n - plan.k_eff).float(),
                                  plan.n_accept)
    return DecodeOut(log_z=log_z, top_score=topv, top_id=topi,
                     head_lse=head_lse, tail_lse=tail_lse, k_eff=plan.k_eff,
                     head_live=plan.cand_live)


def mesh_health_guard(out: DecodeOut, w_local: torch.Tensor,
                      h: torch.Tensor, k: int,
                      active: Optional[torch.Tensor] = None, *,
                      use_kernel: bool = True, group=None):
    """``core.decode.apply_health_guard`` with the exact fallback split
    over the model group. The flags come from outputs every rank of the
    group holds alike, and the fallback's collectives (the gated
    ``topk_z``'s log-domain combine and candidate merge) are issued every
    step whatever the flags, so every rank issues the same collectives in
    the same order; the flagged rows are spliced in with ``torch.where``,
    and healthy rows keep their bits."""
    flags = _decode.health_flags(out)
    if active is not None:
        flags = torch.where(active, flags, torch.zeros_like(flags))
    bad = flags > 0
    lse, topv, topi = _exact_parts(w_local, h, k, use_kernel,
                                   flags if use_kernel else None, group)
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


def mesh_shadow_log_z(w_local: torch.Tensor, h: torch.Tensor, *, k: int = 1,
                      use_kernel: bool = True,
                      rows: Optional[torch.Tensor] = None,
                      group=None) -> torch.Tensor:
    """The shadow oracle's exact log Z under the mesh: the exact tier's
    log Z term for term (``topk_z`` on each rank's rows, gated by
    ``rows``, then ``logspace_psum``), so the exact tier's shadow error is
    zero bit for bit; -inf in the rows ``rows`` leaves out."""
    if use_kernel:
        lse = topk_z(h, w_local, k, rows=rows)[0]
    else:
        lse = torch.logsumexp((h @ w_local.T).float(), -1)
    log_z = logspace_psum(lse, group)
    if rows is not None and not use_kernel:
        log_z = torch.where(rows != 0, log_z,
                            torch.full_like(log_z, float("-inf")))
    return log_z
