"""SimHash/ALSH-MIPS index and its batched decode (counterpart of
``repro.core.lsh``).

A row's address is its K-bit sign pattern under each of L tables of fixed
random hyperplanes. Bucket tables have a fixed capacity ``(L, 2**K, cap)``;
a row past a bucket's capacity is dropped from that table's routing and
recorded in ``slot_of_row`` (-1), so it belongs to the tail population and
no mass is lost. Everything hangs off one predicate:

    collide(q, r)  :=  exists table t with codes[r, t] == qcodes[q, t]
                       AND slot_of_row[r, t] >= 0

Head membership and tail rejection both evaluate it, so every row is
counted once. Serving combines the collision head with a shared,
norm-tempered tail sample by the paper's Eq. 5 (``lsh_decode``); the
analytic collision probability gives Spring & Shrivastava's unbiased
estimator (``sns_log_z``), a tool for accuracy studies.

Hyperplanes come from a ``torch.Generator`` or are injected (``proj=``);
tail samples are drawn from a generator or injected (``tail_ids=``), as the
tests do with the JAX package's draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from ..kernels.lsh_probe import hash_codes, lsh_probe
from ..kernels.topk_z import select_topk
from .decode import DecodeOut, _masked_tail_lse
from .estimators import NEG_INF, combine_head_tail_lse

# Q*V*L ceiling under which lsh_plan computes collisions by broadcast code
# compare instead of bucket scatter (the JAX package's threshold).
_BCAST_COLLIDE_LIMIT = 1 << 25
# row width of fixed_order_cumsum's two-level scan
_SCAN_WIDTH = 1024


class LSHIndex(NamedTuple):
    """Device-resident SimHash MIPS index; static facts live in shapes.

    Rows hash as ``[w_r, sqrt(M^2 - |w_r|^2)]`` and queries as ``[h, 0]``
    (MIPS augmentation), so the collision probability is monotone in the
    inner product."""
    proj: torch.Tensor         # (L, K, d+1) f32 fixed random hyperplanes
    aug_scale: torch.Tensor    # () f32 norm cap M of the augmentation
    tail_scale: torch.Tensor   # () f32 tail-proposal temperature tau
    tail_logits: torch.Tensor  # (V,) f32 tau * |w_r|
    codes: torch.Tensor        # (V, L) int32 packed K-bit code per table
    buckets: torch.Tensor      # (L, 2**K, cap) int32 row ids, -1 = empty
    slot_of_row: torch.Tensor  # (V, L) int32 slot in own bucket, -1 = dropped

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def n_tables(self) -> int:
        return self.proj.shape[0]

    @property
    def n_bits(self) -> int:
        return self.proj.shape[1]

    @property
    def n_buckets(self) -> int:
        return self.buckets.shape[1]

    @property
    def bucket_cap(self) -> int:
        return self.buckets.shape[2]


def lsh_bucket_cap(n: int, n_bits: int) -> int:
    """Auto bucket capacity: 4x the uniform-hash expectation, floored at 8
    and rounded up to a multiple of 8."""
    mean = max(1, -(-n // (1 << n_bits)))      # ceil(n / 2**K)
    return max(8, -(-4 * mean // 8) * 8)


def _row_aug(w: torch.Tensor, aug_scale: torch.Tensor) -> torch.Tensor:
    """(V,) augmented coordinate sqrt(max(M^2 - |w_r|^2, 0))."""
    sq = (w.float() ** 2).sum(-1)
    return torch.sqrt(torch.clamp(aug_scale.float() ** 2 - sq, min=0.0))


def _pack_one_table(col: torch.Tensor, n_buckets: int, cap: int):
    """Scatter one table's (V,) codes into a (n_buckets, cap) bucket array
    (-1 = empty) and a (V,) slot assignment (-1 = overflow-dropped): the
    JAX package's stable-sort/rank scatter, so buckets and slots equal its
    own bit for bit."""
    n = col.shape[0]
    dev = col.device
    col = col.long()
    sizes = torch.bincount(col, minlength=n_buckets)
    start = torch.cumsum(sizes, 0) - sizes                     # exclusive
    order = torch.argsort(col, stable=True)
    rank = torch.arange(n, device=dev) - start[col[order]]
    keep = rank < cap
    # dropped rows all land on one spare slot past the end, cut off below
    tgt = torch.where(keep, col[order] * cap + rank, n_buckets * cap)
    flat = torch.full((n_buckets * cap + 1,), -1, dtype=torch.int32,
                      device=dev)
    flat[tgt] = order.to(torch.int32)
    slots = torch.full((n,), -1, dtype=torch.int32, device=dev)
    slots[order] = torch.where(keep, rank, -1).to(torch.int32)
    return flat[:-1].reshape(n_buckets, cap), slots


def _max_norm(w: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((w.float() ** 2).sum(-1).max())


def _fit_aug_scale(w: torch.Tensor, mips_scale: float) -> torch.Tensor:
    """() f32 norm cap M = mips_scale * max row norm (0 = angle-only)."""
    return mips_scale * _max_norm(w)


def _fit_tail_scale(w: torch.Tensor, tail_beta: float) -> torch.Tensor:
    """() f32 tail-proposal temperature tau = tail_beta / max|w_r|."""
    return tail_beta / torch.clamp(_max_norm(w), min=1e-12)


def pack_lsh(proj: torch.Tensor, w: torch.Tensor, aug_scale, tail_scale, *,
             bucket_cap: int) -> LSHIndex:
    """Hash every row of w (MIPS-augmented), fit the tail-proposal logits,
    and pack the L bucket tables."""
    aug_scale = torch.as_tensor(aug_scale, dtype=torch.float32,
                                device=w.device)
    tail_scale = torch.as_tensor(tail_scale, dtype=torch.float32,
                                 device=w.device)
    codes = hash_codes(proj, w, aug=_row_aug(w, aug_scale))    # (V, L)
    n_buckets = 1 << proj.shape[1]
    packed = [_pack_one_table(codes[:, t], n_buckets, bucket_cap)
              for t in range(proj.shape[0])]
    norms = torch.sqrt((w.float() ** 2).sum(-1))
    return LSHIndex(proj=proj, aug_scale=aug_scale, tail_scale=tail_scale,
                    tail_logits=tail_scale * norms, codes=codes,
                    buckets=torch.stack([b for b, _ in packed]),
                    slot_of_row=torch.stack([s for _, s in packed], 1))


def build_lsh_device(w: torch.Tensor, *, n_bits: int = 8, n_tables: int = 8,
                     bucket_cap: int = 0, mips_scale: float = 0.0,
                     tail_beta: float = 8.0,
                     generator: Optional[torch.Generator] = None,
                     proj: Optional[torch.Tensor] = None,
                     device="cuda") -> LSHIndex:
    """Fresh index of ``w (V, d)`` on ``device``: the (L, K, d+1) normal
    hyperplanes drawn from ``generator`` (which must live on ``device``) or
    injected as ``proj``, the MIPS norm cap and tail temperature fitted,
    and the tables packed. The hyperplanes are never re-drawn:
    ``rehash_lsh`` and ``update_rows`` keep them."""
    dev = resolve_device(device)
    if not 1 <= n_bits <= 24:
        raise ValueError(f"n_bits={n_bits}: packed codes must stay f32-exact "
                         f"(1 <= K <= 24)")
    w = w.to(dev)
    n, d = w.shape
    if bucket_cap <= 0:
        bucket_cap = lsh_bucket_cap(n, n_bits)
    shape = (n_tables, n_bits, d + 1)
    if proj is None:
        if generator is None:
            raise ValueError("build_lsh_device needs a generator or proj")
        proj = torch.randn(shape, generator=generator, device=dev)
    else:
        proj = torch.as_tensor(proj, device=dev).float()
        if tuple(proj.shape) != shape:
            raise ValueError(f"proj {tuple(proj.shape)} != {shape}")
    return pack_lsh(proj, w, _fit_aug_scale(w, mips_scale),
                    _fit_tail_scale(w, tail_beta), bucket_cap=bucket_cap)


def update_rows(index: LSHIndex, w: torch.Tensor,
                rows: torch.Tensor) -> LSHIndex:
    """Re-hash the given rows against the current w and splice them into
    the bucket tables, one row after another: out of the old bucket slot,
    into the first free slot of the new bucket (slot -1 when it is full,
    the overflow rule of a fresh ``pack_lsh``). Returns a new index; the
    given one is not changed."""
    codes = index.codes.clone()
    buckets = index.buckets.clone()
    slots = index.slot_of_row.clone()
    tlog = index.tail_logits.clone()
    t_idx = torch.arange(index.n_tables, device=codes.device)
    for r in torch.as_tensor(rows).reshape(-1).tolist():
        wr = w[r:r + 1]
        new_c = hash_codes(index.proj, wr,
                           aug=_row_aug(wr, index.aug_scale))[0].long()
        old_c, old_s = codes[r].long(), slots[r].long()
        was = old_s >= 0
        buckets[t_idx[was], old_c[was], old_s[was]] = -1
        free = buckets[t_idx, new_c] == -1                     # (L, cap)
        has = free.any(-1)
        slot = torch.where(has, free.int().argmax(-1), -1)     # first free
        buckets[t_idx[has], new_c[has], slot[has]] = r
        codes[r] = new_c.to(torch.int32)
        slots[r] = slot.to(torch.int32)
        tlog[r] = index.tail_scale * torch.sqrt((wr[0].float() ** 2).sum())
    return index._replace(codes=codes, buckets=buckets, slot_of_row=slots,
                          tail_logits=tlog)


def rehash_lsh(index: LSHIndex, w: torch.Tensor,
               mips_scale: Optional[float] = None,
               tail_beta: Optional[float] = None):
    """Full re-hash against the current w, keeping the hyperplanes (and, by
    default, the stored norm cap and tail temperature): ``(index,
    {"churn", "drift"})``, churn the fraction of rows whose code changed in
    any table, drift the mean fraction of flipped code bits."""
    aug = (index.aug_scale if mips_scale is None
           else _fit_aug_scale(w, mips_scale))
    tscale = (index.tail_scale if tail_beta is None
              else _fit_tail_scale(w, tail_beta))
    new = pack_lsh(index.proj, w, aug, tscale, bucket_cap=index.bucket_cap)
    diff = index.codes ^ new.codes                             # (V, L)
    churn = (diff != 0).any(-1).float().mean()
    pop = sum((diff >> b) & 1 for b in range(index.n_bits))
    drift = pop.float().mean() / index.n_bits
    return new, {"churn": churn, "drift": drift}


# ---------------------------------------------------------------------------
# Collision predicate + probe plan
# ---------------------------------------------------------------------------

def _collide(index: LSHIndex, qcodes: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """(Q, R) bool: does row r collide with query q in any table where r is
    routed?"""
    rows = rows.long()
    hit = ((qcodes[:, None, :] == index.codes[rows][None]) &
           (index.slot_of_row[rows] >= 0)[None])
    return hit.any(-1)


class LshPlan(NamedTuple):
    qcodes: torch.Tensor       # (Q, L)  query codes (after active masking)
    occ_q: torch.Tensor        # (Q, V)  full collision mask
    cand_rows: torch.Tensor    # (C,)    ascending candidate union (pad = 0)
    cand_live: torch.Tensor    # ()      measured unique candidate count
    member: torch.Tensor       # (Q, C)  collision membership (live slots)
    k_eff: torch.Tensor        # (Q,)    |C(q)|, rows colliding with q
    tail_ids: torch.Tensor     # (l,)    shared tail row ids ~ p
    tail_bias: torch.Tensor    # (l,)    -log(n p_j), added to the score
    tail_accept: torch.Tensor  # (Q, l)  the sample does not collide
    n_accept: torch.Tensor     # (Q,) f32 sum_j accept * exp(tail_bias_j)


def _occupancy_compare(index: LSHIndex, qcodes: torch.Tensor) -> torch.Tensor:
    """(Q, V) collision mask by per-table code compare: O(Q V L)."""
    # -2 never equals a code in [0, 2**K): unrouted rows never collide
    eff = torch.where(index.slot_of_row >= 0, index.codes,
                      torch.full_like(index.codes, -2))
    occ_q = torch.zeros((qcodes.shape[0], index.n), dtype=torch.bool,
                        device=qcodes.device)
    for t in range(index.n_tables):
        occ_q |= qcodes[:, t:t + 1] == eff[None, :, t]
    return occ_q


def _occupancy_scatter(index: LSHIndex, qcodes: torch.Tensor) -> torch.Tensor:
    """(Q, V) collision mask by scattering the probed buckets' row ids:
    O(Q L cap). Buckets hold only routed rows, so it equals
    ``_occupancy_compare`` bit for bit."""
    q, n = qcodes.shape[0], index.n
    t_idx = torch.arange(index.n_tables, device=qcodes.device)
    flat = index.buckets[t_idx[None, :], qcodes.long()].reshape(q, -1)
    safe = torch.where(flat < 0, n, flat).long()        # empty -> spare col
    occ = torch.zeros((q, n + 1), dtype=torch.bool, device=qcodes.device)
    occ.scatter_(1, safe, True)
    return occ[:, :n]


def _tail_log_probs(index: LSHIndex) -> torch.Tensor:
    """(V,) log-probabilities of the defensive-mixture tail proposal
    p = 1/2 uniform + 1/2 softmax(tail_logits): the tilted half catches
    heavy rows that escaped the head, the uniform half keeps every count
    weight 1/(n p) <= 2."""
    n = index.n
    uniform = torch.full_like(index.tail_logits, -math.log(float(n)))
    return (torch.logaddexp(torch.log_softmax(index.tail_logits, 0), uniform)
            - math.log(2.0))


def fixed_order_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of a 1-D float tensor, added in an order fixed
    by its length: rows of ``_SCAN_WIDTH`` are scanned each on its own,
    then their totals are scanned the same way and added to the rows after
    them. ``torch.cumsum`` of a 1-D CUDA tensor is one device-wide scan
    whose blocks take their predecessors' sums as these become ready, so
    its float bits change from run to run; a scan along the last dimension
    of a tensor of two rows or more runs each row in one block, in a fixed
    order (a zero row pads a single one)."""
    n = x.shape[0]
    rows = -(-n // _SCAN_WIDTH)
    buf = x.new_zeros((max(rows, 2), _SCAN_WIDTH))
    buf.view(-1)[:n] = x
    part = torch.cumsum(buf, 1)
    if rows > 1:
        part[1:rows] += fixed_order_cumsum(part[:rows - 1, -1])[:, None]
    return part.view(-1)[:n]


def inverse_cdf_sample(logp: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Row ids drawn from exp(logp) (V,) by inverse CDF for uniforms u in
    [0, 1): the first row whose running mass reaches u * total. The mass
    is summed by ``fixed_order_cumsum``, so every process draws the same
    rows."""
    cdf = fixed_order_cumsum(torch.exp(logp))
    ids = torch.searchsorted(cdf, u * cdf[-1])
    return torch.clamp(ids, 0, logp.shape[0] - 1).to(torch.int32)


def resolve_cand_cap(cand_cap: int, index: LSHIndex, n: int) -> int:
    """0 = auto: twice one query's worst-case bucket pull (L * cap). This
    cap is the plan's static candidate footprint."""
    if cand_cap <= 0:
        cand_cap = 2 * index.n_tables * index.bucket_cap
    return min(cand_cap, n)


def draw_tail_ids(index: LSHIndex, l: int,
                  generator: Optional[torch.Generator] = None, *,
                  logp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plan's ``l`` shared tail row ids (int32), drawn from the
    defensive-mixture proposal with uniforms from ``generator``. They depend
    on the index and the draw only, so a caller may draw them ahead of the
    step (``serve.generate`` fills a buffer a step)."""
    if logp is None:
        logp = _tail_log_probs(index)
    u = torch.rand((max(l, 1),), generator=generator, device=logp.device)
    return inverse_cdf_sample(logp, u)[:l]


def lsh_plan(index: LSHIndex, h: torch.Tensor, l: int, *,
             generator: Optional[torch.Generator] = None,
             tail_ids: Optional[torch.Tensor] = None,
             active: Optional[torch.Tensor] = None,
             cand_cap: int = 0) -> LshPlan:
    """Hash the batch, union the probed buckets, build the collision head
    and the shared rejected tail. The tail is drawn from ``generator`` or
    given as ``tail_ids (l,)``; it depends only on the index and the draw,
    not on ``h``.

    The union ``cand_rows`` has the static width ``resolve_cand_cap``;
    rows past it are not lost: ``_with_trimmed_cands`` then scores densely
    over ``occ_q``. ``active`` (Q,) bool masks padded lanes at the code
    level (they adopt the first live lane's codes)."""
    n = index.n
    dev = h.device
    qcodes = hash_codes(index.proj, h)                         # (Q, L)
    if active is not None:
        donor = qcodes[torch.argmax(active.int())]
        qcodes = torch.where(active[:, None], qcodes, donor[None, :])
    q = h.shape[0]
    capacity = resolve_cand_cap(cand_cap, index, n)
    # two bit-identical strategies, chosen by static shapes as in JAX
    if q * n * index.n_tables <= _BCAST_COLLIDE_LIMIT:
        occ_q = _occupancy_compare(index, qcodes)
    else:
        occ_q = _occupancy_scatter(index, qcodes)
    # prefix-sum compaction: the j-th candidate is the first row whose
    # running count reaches j (ascending unique ids, zero-padded)
    occ_cs = torch.cumsum(occ_q.any(0), 0)
    live = occ_cs[-1]
    j = torch.arange(1, capacity + 1, device=dev)
    cand_rows = torch.searchsorted(occ_cs, j, side="left")
    cand_rows = torch.where(j <= live, cand_rows, 0)
    member = occ_q[:, cand_rows] & (j <= live)[None, :]
    k_eff = occ_q.sum(-1).to(torch.int32)

    logp_all = _tail_log_probs(index)
    if tail_ids is None:
        tail_ids = draw_tail_ids(index, l, generator, logp=logp_all)
    tail_ids = torch.as_tensor(tail_ids, device=dev).to(torch.int32)
    tail_bias = -(logp_all[tail_ids.long()] + math.log(float(n)))
    tail_accept = ~occ_q[:, tail_ids.long()]
    n_accept = (tail_accept * torch.exp(tail_bias)[None, :]).sum(-1)
    return LshPlan(qcodes=qcodes, occ_q=occ_q,
                   cand_rows=cand_rows.to(torch.int32),
                   cand_live=live.to(torch.int32), member=member,
                   k_eff=k_eff, tail_ids=tail_ids, tail_bias=tail_bias,
                   tail_accept=tail_accept, n_accept=n_accept.float())


def _with_trimmed_cands(plan: LshPlan, branch_fn):
    """Run ``branch_fn(cand_rows, member, col_live)`` on the compact union
    when the measured unique count fits its static capacity, else densely on
    every vocabulary row with ``occ_q`` as the membership (identical math).

    The choice is made on the host: it reads ``cand_live`` back, one device
    synchronisation per decode step whenever the capacity is below V. The
    plain branch only; the kernel branch chooses on the device
    (``device_cands``)."""
    capacity = plan.cand_rows.shape[0]
    n = plan.occ_q.shape[1]
    if capacity >= n or int(plan.cand_live) <= capacity:
        return branch_fn(plan.cand_rows, plan.member, plan.cand_live)
    dev = plan.occ_q.device
    return branch_fn(torch.arange(n, dtype=torch.int32, device=dev),
                     plan.occ_q, torch.tensor(n, dtype=torch.int32,
                                              device=dev))


def device_cands(plan: LshPlan):
    """The candidate columns of ``lsh_probe`` with the trimmed-or-dense
    choice of ``_with_trimmed_cands`` made on the device, as the JAX
    package's ``lax.cond`` makes it: ``(rows (V,) int32, live () int32)``.
    ``rows`` holds the compact union (zero past it) when the union fits its
    static capacity, else every row id; ``live`` is the union's size, or V.
    One launch at width V serves both branches, since the kernel reads only
    the ``live`` leading columns and writes 0 counts past them; nothing is
    read to the host, so the decode can be captured in a CUDA graph."""
    capacity = plan.cand_rows.shape[0]
    n = plan.occ_q.shape[1]
    if capacity >= n:
        return plan.cand_rows, plan.cand_live
    dev = plan.occ_q.device
    fits = plan.cand_live <= capacity
    rows = torch.where(
        fits, torch.nn.functional.pad(plan.cand_rows, (0, n - capacity)),
        torch.arange(n, dtype=torch.int32, device=dev))
    live = torch.where(fits, plan.cand_live,
                       torch.full_like(plan.cand_live, n))
    return rows, live


# ---------------------------------------------------------------------------
# Batched decode (Eq. 5 combine over the collision head)
# ---------------------------------------------------------------------------

def lsh_decode(index: LSHIndex, w: torch.Tensor, h: torch.Tensor, *, l: int,
               k: int = 1, cand_cap: int = 0, use_kernel: bool = True,
               generator: Optional[torch.Generator] = None,
               tail_ids: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None) -> DecodeOut:
    """Batched sublinear decode through the LSH index: h (Q, d) -> log Ẑ
    and top-k rows, per Eq. 5 with the collision head as S(q).

    The index supplies routing only: candidate and tail rows are read from
    the live ``w``. ``use_kernel=True`` goes through
    ``kernels.lsh_probe.lsh_probe`` (the CUDA kernel on a GPU tensor, its
    plain version on a CPU tensor), with the trimmed-or-dense choice made on
    the device (``device_cands``: no host read); ``use_kernel=False`` is the
    reference branch of the JAX package's XLA path (one gather, one matmul
    over head and tail rows), which reads the union size to the host."""
    if l < 1:
        raise ValueError("lsh_decode needs at least one tail sample (l >= 1)")
    plan = lsh_plan(index, h, l, generator=generator, tail_ids=tail_ids,
                    active=active, cand_cap=cand_cap)
    if use_kernel:
        rows, live = device_cands(plan)
        head_lse, tail_lse, topv, topi = lsh_probe(
            w, h, index.proj, rows, live, index.codes, index.slot_of_row,
            plan.tail_ids, plan.tail_accept, plan.tail_bias, k=k)[:4]
    else:
        tail_rows = w[plan.tail_ids.long()].float()

        def branch(rows, member, col_live):
            del col_live         # membership already encodes dead columns
            stacked = torch.cat([w[rows.long()].float(), tail_rows], 0)
            scores = h.float() @ stacked.T
            c = rows.shape[0]
            eff = torch.where(member, scores[:, :c],
                              torch.full_like(scores[:, :c], NEG_INF))
            topv, topi = select_topk(eff, rows, k)
            tail_lse = _masked_tail_lse(
                scores[:, c:] + plan.tail_bias[None, :], plan.tail_accept)
            return torch.logsumexp(eff, -1), tail_lse, topv, topi

        head_lse, tail_lse, topv, topi = _with_trimmed_cands(plan, branch)
    log_z = combine_head_tail_lse(head_lse, tail_lse,
                                  (index.n - plan.k_eff).float(),
                                  plan.n_accept)
    return DecodeOut(log_z=log_z, top_score=topv, top_id=topi,
                     head_lse=head_lse, tail_lse=tail_lse, k_eff=plan.k_eff,
                     head_live=plan.cand_live)


# ---------------------------------------------------------------------------
# Unbiasedness: analytic collision probability (Spring & Shrivastava 2017)
# ---------------------------------------------------------------------------

def collision_log_prob(index: LSHIndex, h: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """(Q, V) log P[collide(q, r)] under SimHash: per-bit agreement
    p = 1 - theta/pi, per table p**K, across L tables 1 - (1 - p**K)**L,
    with theta the angle in the MIPS-augmented space. Analytic: it does not
    consult the realised tables."""
    hf, wf = h.float(), w.float()
    hnorm = torch.clamp(torch.linalg.vector_norm(hf, dim=-1, keepdim=True),
                        min=1e-12)
    wnorm = torch.linalg.vector_norm(wf, dim=-1)               # (V,)
    denom = torch.clamp(torch.maximum(index.aug_scale, wnorm), min=1e-12)
    cos = torch.clamp((hf @ wf.T) / (hnorm * denom[None, :]), -1.0, 1.0)
    p_bit = torch.clamp(1.0 - torch.arccos(cos) / math.pi, 1e-9, 1.0 - 1e-9)
    p_tab = index.n_bits * torch.log(p_bit)                    # log p**K
    return torch.log1p(-torch.exp(
        index.n_tables * torch.log1p(-torch.exp(p_tab))))


def sns_log_z(index: LSHIndex, w: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """Spring & Shrivastava's sampled partition estimate
    Ẑ(q) = sum_{r in C(q)} e^{s_r} / P[collide(q, r)], unbiased over the
    hyperplane draw. O(V L) compare and O(V d) scores: an accuracy-study
    tool, not a serving path."""
    qcodes = hash_codes(index.proj, h)
    member = _collide(index, qcodes, torch.arange(index.n, device=h.device))
    s = h.float() @ w.float().T
    logp = collision_log_prob(index, h, w)
    return torch.logsumexp(torch.where(member, s - logp,
                                       torch.full_like(s, NEG_INF)), -1)
