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

The dry-run bodies (``streaming_logz_argmax``, ``IVFSpecs``,
``sharded_*_decode``, ``sharded_decode``; ``launch.dryrun`` counts them)
split everything by rank instead: each rank of the model group probes and
tail-samples only its own blocks (``IVFSpecs`` of its shard), the partial
log Z terms are combined by ``logspace_psum`` (mince: one all-reduce of
the stacked ``MinceStats`` sums, then the same solve on every rank) and
the top-1 candidates by one gather. Their estimates differ from the
single-device decode's (another head and tail), as the JAX bodies' do;
they serve throughput studies, not tokens. Every shape is static and
nothing reads the host, so they trace under ``FakeTensorMode`` and can be
captured. With ``use_kernel`` the block scores are ``ivf_score``, the
fmbe estimate ``fmbe_z`` and ``streaming_logz_argmax`` ``topk_z`` at k 1;
the tail and centroid products stay ``torch.matmul``, as the JAX package
computes them outside Pallas. Tail draws are injected: each rank's
``slots`` (l_local,), or an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core import decode as _decode
from ..core import lsh as _lsh
from ..core import mince as _mince
from ..core import mips as _mips
from ..core.decode import DecodeOut, DecodePlan
from ..core.distributed import (bitsum_, gather_stack, group_rank,
                                group_size, logspace_psum, merge_topk)
from ..core.estimators import NEG_INF, combine_head_tail_lse
from ..core.feature_maps import FMBEState, fmbe_tail_z, fmbe_z_batch
from ..kernels.ivf_score import (ivf_decode, ivf_score, ivf_score_plain,
                                 union_scores)
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
                         plan: DecodePlan, k: int, tail_slots, group,
                         kernel_cfg=None):
    """``core.decode._scored_head``'s kernel branch on staged rows:
    ``union_scores`` (with ``kernel_cfg``'s launch knobs) over the staged
    union (ids 0 .. U - 1, the plan's live count), the tail by one
    matmul."""
    blocks, tail = _stage(index, plan.head_ids, tail_slots, group)
    u = plan.head_ids.shape[0]
    scores = union_scores(blocks, h, torch.arange(u, dtype=torch.int32,
                                                  device=h.device),
                          plan.head_live, **(kernel_cfg or {}))
    q = h.shape[0]
    mask = (plan.head_member[:, :, None] &
            index.valid[plan.head_ids.long()][None]).reshape(q, -1)
    ts = None if tail is None else h.float() @ tail.float().T
    return _decode._head_topk(index, plan.head_ids, scores.reshape(q, -1),
                              mask, k) + (ts,)


def _scored_head(index, h, plan, k, use_kernel, tail_slots, head_cap, group,
                 kernel_cfg=None):
    """``core.decode._scored_head`` under the mesh: (head_lse, topv, top
    slot ids, tail scores or None)."""
    if use_kernel:
        return _union_kernel_scores(index, h, plan, k, tail_slots, group,
                                    kernel_cfg)

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
                      group=None, kernel_cfg=None) -> DecodeOut:
    """MIMPS (Eq. 5) under the serving mesh, bit-equal to
    ``mimps_decode`` at every mesh size: ``ivf_decode`` (with
    ``kernel_cfg``'s launch knobs) on the staged union and tail, or the
    plain branch on the same staged rows."""
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
            plan.tail_accept, k=k, **(kernel_cfg or {}))
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
                      group=None, kernel_cfg=None) -> DecodeOut:
    """MINCE (Eq. 6/7) under the serving mesh: ``mince_decode``'s closed
    form on gathered rows (``iters``/``solver`` ignored, as there)."""
    del iters, solver
    if l < 1:
        raise ValueError("MINCE needs at least one noise sample (l >= 1)")
    plan = _mesh_plan(index, h, n_probe, l, generator, tail_idx, active)
    head_lse, topv, topi, ts = _scored_head(
        index, h, plan, k, use_kernel, _tail_slots(index, plan), head_cap,
        group, kernel_cfg)
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
                     group=None, kernel_cfg=None) -> DecodeOut:
    """The head-only tier (``topk_head_decode``) under the serving mesh."""
    plan = _mesh_plan(index, h, n_probe, 0, None, None, active)
    head_lse, topv, topi, _ = _scored_head(index, h, plan, k, use_kernel,
                                           None, head_cap, group, kernel_cfg)
    no_tail = torch.full_like(head_lse, float("-inf"))
    return _decode._probe_out(index, plan, head_lse, head_lse, no_tail, topv,
                              topi)


def mesh_fmbe_decode(state: FMBEState, index: _mips.IVFIndex,
                     h: torch.Tensor, *, n_probe: int, k: int = 1,
                     use_kernel: bool = True, head_cap: int = 0,
                     active: Optional[torch.Tensor] = None,
                     group=None, kernel_cfg=None) -> DecodeOut:
    """FMBE under the serving mesh: the sketch and its per-block lambdas
    are replicated (``fmbe_z`` as on one device, with ``kernel_cfg``'s
    launch knobs); only the candidate head rows are gathered."""
    plan = _mesh_plan(index, h, n_probe, 0, None, None, active)
    head_lse, topv, topi, _ = _scored_head(index, h, plan, k, use_kernel,
                                           None, head_cap, group)
    if state.lambda_blocks is not None:
        z_tail = fmbe_tail_z(state, h, plan.block_ids, use_kernel,
                             kernel_cfg)
        log_z = torch.logaddexp(head_lse,
                                torch.log(torch.clamp(z_tail, min=1e-30)))
    else:
        z = fmbe_z_batch(state, h, use_kernel, kernel_cfg)
        log_z = torch.log(torch.clamp(z, min=1e-30))
    no_tail = torch.full_like(log_z, float("-inf"))
    return _decode._probe_out(index, plan, log_z, head_lse, no_tail, topv,
                              topi)


def _exact_parts(w_local: torch.Tensor, h: torch.Tensor, k: int,
                 use_kernel: bool, rows, group, kernel_cfg=None):
    """(log Z, topv, global top ids) with the embedding row-split over
    ``group``: each rank's LSE and top-k (``topk_z``, gated by ``rows``,
    with ``kernel_cfg``'s launch knobs, or the reference logits), the LSEs
    combined in log domain and the candidates merged."""
    n_loc = w_local.shape[0]
    if use_kernel:
        lse, topv, topi = topk_z(h, w_local, k, rows=rows,
                                 **(kernel_cfg or {}))
    else:
        logits = (h @ w_local.T).float()
        lse = torch.logsumexp(logits, -1)
        topv, topi = select_topk(
            logits, torch.arange(n_loc, device=h.device), min(k, n_loc))
    log_z = logspace_psum(lse, group)
    topv, topi = merge_topk(topv, topi + group_rank(group) * n_loc, k, group)
    return log_z, topv, topi


def mesh_exact_decode(w_local: torch.Tensor, h: torch.Tensor, *, k: int = 1,
                      use_kernel: bool = True, group=None,
                      kernel_cfg=None) -> DecodeOut:
    """Exact log Z and top-k with the embedding row-split over the model
    group. The candidates are the single-device pass's (each a score of
    one row); log Z agrees to the rounding of the reduction order."""
    log_z, topv, topi = _exact_parts(w_local, h, k, use_kernel, None, group,
                                     kernel_cfg)
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
                         group=None, kernel_cfg=None) -> DecodeOut:
    out = mesh_exact_decode(w_local, h, k=k, use_kernel=use_kernel,
                            group=group, kernel_cfg=kernel_cfg)
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


# ---------------------------------------------------------------------------
# the dry-run bodies: everything split by rank (see the module docstring)
# ---------------------------------------------------------------------------

def streaming_logz_argmax(h: torch.Tensor, w: torch.Tensor,
                          chunk: int = 8192, *,
                          use_kernel: Optional[bool] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """h (B, d), w (V, d) -> (log_z (B,) f32, top_id (B,) int32,
    top_score (B,) f32): exact log Z and top-1 over the rows ``w``.

    With ``use_kernel`` (None: when both are CUDA tensors) one ``topk_z``
    at k 1, whose products are f32 sums; on CPU tensors its plain version.
    Else the JAX package's scan: chunks interleaved by row (chunk j holds
    rows j, j + n, j + 2n, ... of its n chunks), each chunk's f32 products
    folded into a running max and sum and its first maximum kept where it
    beats the earlier chunks'. JAX rounds each product to the input dtype
    before the f32 cast; here the products are f32 sums, as in the kernel,
    so both routes agree on bf16 rows too."""
    if use_kernel is None:
        use_kernel = h.is_cuda and w.is_cuda
    if use_kernel:
        lse, topv, topi = topk_z(h, w, 1)
        return lse, topi[:, 0], topv[:, 0]
    v = w.shape[0]
    n_chunks = -(-v // chunk)
    b, dev = h.shape[0], h.device
    m = torch.full((b,), NEG, dtype=torch.float32, device=dev)
    s = torch.zeros((b,), dtype=torch.float32, device=dev)
    bi = torch.zeros((b,), dtype=torch.int32, device=dev)
    bs = torch.full((b,), NEG, dtype=torch.float32, device=dev)
    hf = h.float()
    for j in range(n_chunks):
        wi = w[j::n_chunks]
        scores = hf @ wi.float().T
        col = torch.arange(wi.shape[0], device=dev, dtype=torch.int32) \
            * n_chunks + j
        cmax, am = scores.amax(-1), scores.argmax(-1)
        m_new = torch.maximum(m, cmax)
        s = s * torch.exp(m - m_new) + torch.exp(
            scores - m_new[:, None]).sum(-1)
        better = cmax > bs
        bi = torch.where(better, col[am], bi)
        bs = torch.maximum(bs, cmax)
        m = m_new
    return m + torch.log(s), bi, bs


class IVFSpecs(NamedTuple):
    """A block-IVF index's tensors; the leading (block) dim splits over
    the model group (``ivf_partition_specs``), each rank holding its
    blocks."""
    v_blocks: torch.Tensor   # (nb, br, d)
    centroids: torch.Tensor  # (nb, d)
    radius: torch.Tensor     # (nb,) f32
    valid: torch.Tensor      # (nb, br) bool


def ivf_specs_for(vocab: int, d: int, block_rows: int, dtype,
                  shard_multiple: int = 16, device="meta") -> IVFSpecs:
    """Empty tensors of the dry run's index shapes (perfect packing
    assumed), on ``device`` (``meta``; under ``FakeTensorMode`` any device
    gives fake tensors): the block count rounded up to ``shard_multiple``
    so it splits over the model group, as the index build pads it."""
    nb = -(-vocab // block_rows)
    nb = -(-nb // shard_multiple) * shard_multiple
    return IVFSpecs(
        v_blocks=torch.empty((nb, block_rows, d), dtype=dtype, device=device),
        centroids=torch.empty((nb, d), dtype=dtype, device=device),
        radius=torch.empty((nb,), dtype=torch.float32, device=device),
        valid=torch.empty((nb, block_rows), dtype=torch.bool, device=device))


def ivf_partition_specs() -> IVFSpecs:
    """Each tensor's spec (``launch.mesh``'s tuples): blocks over
    'model'."""
    return IVFSpecs(v_blocks=("model", None, None), centroids=("model", None),
                    radius=("model",), valid=("model", None))


def _local_probe(ivf: IVFSpecs, h: torch.Tensor, n_probe_local: int,
                 use_kernel: bool = True):
    """The rank's blocks ranked by their ball's upper bound, the best
    ``n_probe_local`` scored (``ivf_score``, or its plain version):
    (bids (B, p) int32, scores (B, p, br) f32 with invalid rows NEG,
    bvalid (B, p, br), k_eff (B,))."""
    nb_l = ivf.v_blocks.shape[0]
    qn = torch.linalg.vector_norm(h.float(), dim=-1, keepdim=True)
    cs = (h @ ivf.centroids.T).float() + ivf.radius[None] * qn
    # lax.top_k's order: score descending, the lowest block on ties
    bids = torch.sort(cs, dim=-1, descending=True, stable=True).indices[
        :, :n_probe_local].to(torch.int32)
    score = ivf_score if use_kernel else ivf_score_plain
    scores = score(ivf.v_blocks, h, bids)
    bvalid = ivf.valid[bids.long()]
    scores = torch.where(bvalid, scores, torch.full_like(scores, NEG))
    return bids, scores, bvalid, bvalid.sum((-2, -1))


def _local_tail(ivf: IVFSpecs, bids: torch.Tensor, h: torch.Tensor,
                l_local: int, slots: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
    """A uniform tail of ``l_local`` slots of the rank's blocks, shared by
    the batch (``slots``, or drawn from ``generator``), each rejected for
    the queries that probed its block: (tail (B, l) f32, ok (B, l),
    n_valid_local ())."""
    nb_l, br, d = ivf.v_blocks.shape
    n_slots = nb_l * br
    flat = ivf.v_blocks.reshape(n_slots, d)
    flat_valid = ivf.valid.reshape(n_slots)
    if slots is None:
        if generator is None:
            raise ValueError("the tail needs its slots or a generator")
        slots = torch.randint(0, n_slots, (l_local,), generator=generator,
                              device=h.device)
    slots = slots.long()
    sblk = slots // br
    unprobed = ~(sblk[None, :, None] == bids.long()[:, None, :]).any(-1)
    ok = unprobed & flat_valid[slots][None, :]
    tail = h.float() @ flat[slots].float().T
    return tail, ok, flat_valid.sum()


def _merge_candidates(bids: torch.Tensor, scores: torch.Tensor, nb_l: int,
                      br: int, group):
    """Each rank's best probed row, one gather of the (score, slot) pairs,
    the first best over the ranks: (global slot id (B,) int32, its score
    (B,))."""
    b = scores.shape[0]
    fs = scores.reshape(b, -1)
    am = fs.argmax(-1)
    cand_s = fs.gather(1, am[:, None])[:, 0]
    cand_i = bids.long().gather(1, (am // br)[:, None])[:, 0] * br + am % br
    packed = torch.stack([cand_s.float().contiguous().view(torch.int32),
                          cand_i.to(torch.int32)])
    both = gather_stack(packed, group)                       # (T, 2, B)
    all_s = both[:, 0].contiguous().view(torch.float32)
    all_i = both[:, 1]
    best = all_s.argmax(0)
    top_score = all_s.gather(0, best[None])[0]
    top_slot = all_i.gather(0, best[None])[0]
    return (best * nb_l * br + top_slot).to(torch.int32), top_score


def _masked_lse(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(torch.where(ok, x, torch.full_like(x, NEG)), -1)


def _local_ivf_logz(ivf: IVFSpecs, h: torch.Tensor, n_probe_local: int,
                    l_local: int, group, *, slots=None, generator=None,
                    use_kernel: bool = True):
    """MIMPS (Eq. 5) on the rank's blocks, the partial log Z combined over
    the group: each query's probed head, one tail shared by the batch
    scaled by its unprobed population over its accepted samples."""
    nb_l, br, _ = ivf.v_blocks.shape
    bids, scores, _, k_eff = _local_probe(ivf, h, n_probe_local, use_kernel)
    head_lse = torch.logsumexp(scores.reshape(h.shape[0], -1), -1)
    tail, ok, n_valid = _local_tail(ivf, bids, h, l_local, slots, generator)
    local = combine_head_tail_lse(
        head_lse, _masked_lse(tail, ok),
        torch.clamp(n_valid - k_eff, min=0).float(), ok.sum(-1).float())
    top_id, top_score = _merge_candidates(bids, scores, nb_l, br, group)
    return logspace_psum(local, group), top_id, top_score


def _local_mince_logz(ivf: IVFSpecs, h: torch.Tensor, n_probe_local: int,
                      l_local: int, group, *, iters: int = 3,
                      solver: str = "halley", n_bins: int = 128,
                      slots=None, generator=None, use_kernel: bool = True):
    """MINCE (Eq. 6/7): each rank's atoms (its probed head and tail) in the
    ``MinceStats`` histograms around the global Eq. 5 anchor, ONE
    all-reduce of the stacked (B, S, 4) sums, then the same bracketed
    solve on every rank (no collective an iteration)."""
    import torch.distributed as dist
    nb_l, br, _ = ivf.v_blocks.shape
    b = h.shape[0]
    bids, scores, bvalid, k_eff_l = _local_probe(ivf, h, n_probe_local,
                                                 use_kernel)
    tail, ok, n_valid_l = _local_tail(ivf, bids, h, l_local, slots,
                                      generator)
    counts = torch.stack([k_eff_l.long(), ok.sum(-1).long(),
                          n_valid_l.long().expand(b)])
    dist.all_reduce(counts, group=group)
    k_eff, n_acc, n_valid = counts.float().unbind(0)
    n_tail = torch.clamp(n_valid - k_eff, min=0.0)
    c_t = n_tail / torch.clamp(n_acc, min=1.0)
    theta0 = logspace_psum(torch.logsumexp(scores.reshape(b, -1), -1), group)
    tail_lse = logspace_psum(_masked_lse(tail, ok), group)
    anchor = combine_head_tail_lse(theta0, tail_lse, n_tail, n_acc)
    s_all = torch.cat([scores.reshape(b, -1), tail], -1)
    m_all = torch.cat([bvalid.reshape(b, -1).float(),
                       ok.float() * c_t[:, None]], -1)
    alpha, wd, wn = _mince.anchored_atoms(s_all, m_all, n_valid, k_eff,
                                          n_acc, anchor)
    st = _mince.mince_stats(alpha, wd, wn, anchor, n_bins=n_bins)
    g = torch.stack([st.w_data, st.w_noise, st.a_data * st.w_data,
                     st.a_noise * st.w_noise], -1).contiguous()
    dist.all_reduce(g, group=group)
    stats = _mince.MinceStats(
        a_data=g[..., 2] / torch.clamp(g[..., 0], min=1e-30),
        w_data=g[..., 0],
        a_noise=g[..., 3] / torch.clamp(g[..., 1], min=1e-30),
        w_noise=g[..., 1], lo=st.lo, hi=st.hi)
    theta = _mince.solve_from_stats(stats, anchor, iters=iters,
                                    solver=solver)
    uniform = tail_lse + torch.log(torch.clamp(n_valid, min=1.0)) - \
        torch.log(torch.clamp(n_acc, min=1.0))
    log_z = torch.where(k_eff == 0, uniform, theta)
    log_z = torch.where((n_acc == 0) | (n_tail == 0), theta0, log_z)
    top_id, top_score = _merge_candidates(bids, scores, nb_l, br, group)
    return log_z, top_id, top_score


def _local_ivf_topk(ivf: IVFSpecs, h: torch.Tensor, n_probe_local: int,
                    group, use_kernel: bool = True):
    """The candidates alone (FMBE): the probe and the top-1 merge."""
    nb_l, br, _ = ivf.v_blocks.shape
    bids, scores, _, _ = _local_probe(ivf, h, n_probe_local, use_kernel)
    return _merge_candidates(bids, scores, nb_l, br, group)


def _model_group(mesh):
    from ..launch.mesh import axis_group
    return axis_group(mesh, "model")


def sharded_ivf_decode(mesh, ivf: IVFSpecs, h: torch.Tensor, *,
                       n_probe_local: int, l_local: int, slots=None,
                       generator=None, use_kernel: bool = True):
    """MIMPS over the model group of ``mesh``: ``ivf`` is this rank's
    shard, h (B, d) its lanes. Returns (log_z, top_id, top_score), each
    (B,)."""
    return _local_ivf_logz(ivf, h, n_probe_local, l_local,
                           _model_group(mesh), slots=slots,
                           generator=generator, use_kernel=use_kernel)


def sharded_mince_decode(mesh, ivf: IVFSpecs, h: torch.Tensor, *,
                         n_probe_local: int, l_local: int, iters: int = 3,
                         solver: str = "halley", slots=None, generator=None,
                         use_kernel: bool = True):
    """MINCE over the model group (one stats all-reduce, local solve)."""
    return _local_mince_logz(ivf, h, n_probe_local, l_local,
                             _model_group(mesh), iters=iters, solver=solver,
                             slots=slots, generator=generator,
                             use_kernel=use_kernel)


def sharded_fmbe_decode(mesh, ivf: IVFSpecs, h: torch.Tensor, *,
                        n_probe_local: int, fmbe_state: FMBEState,
                        l_local: int = 0, slots=None, generator=None,
                        use_kernel: bool = True):
    """FMBE: the replicated sketch's estimate (``fmbe_z``) and the
    candidates over the model group."""
    del l_local, slots, generator
    z = fmbe_z_batch(fmbe_state, h, use_kernel)
    log_z = torch.log(torch.clamp(z, min=1e-30))
    top_id, top_score = _local_ivf_topk(ivf, h, n_probe_local,
                                        _model_group(mesh), use_kernel)
    return log_z, top_id, top_score


SHARDED_BACKENDS = {
    "mimps": sharded_ivf_decode,
    "mince": sharded_mince_decode,
    "fmbe": sharded_fmbe_decode,
}


def sharded_decode(mesh, method: str, ivf: IVFSpecs, h: torch.Tensor, *,
                   n_probe_local: int, l_local: int, **method_kwargs):
    """The method's dry-run body over the model group of ``mesh``:
    (log_z, top_id, top_score), each (B,). 'exact' has no index: call
    ``streaming_logz_argmax`` on the rank's rows instead."""
    try:
        fn = SHARDED_BACKENDS[method]
    except KeyError:
        raise ValueError(
            f"no sharded backend for method {method!r}; have "
            f"{sorted(SHARDED_BACKENDS)} + 'exact' via streaming_logz_argmax"
        ) from None
    return fn(mesh, ivf, h, n_probe_local=n_probe_local, l_local=l_local,
              **method_kwargs)
