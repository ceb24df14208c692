"""Continuous-batching slot scheduler: one mixed prefill/decode step over a
fixed-capacity slot table (counterpart of ``repro.serve.scheduler``).

``generate`` serves one synchronous same-length batch a call; under traffic
that leaves lanes idle while the longest request drains. The scheduler
holds each request's decode state in a lane of a padded device batch of
``n_slots`` lanes (a KV lane, the position, the remaining budget, the
sampling temperature and ``sample_k``, the request's Gumbel noise) and
advances every live lane with one step:

* **Mixed prefill/decode.** A prompt is replayed through the decode path
  one token a step (as ``generate`` replays it), so a lane mid-replay and a
  lane mid-generation take the same step.
* **Shared estimator work.** The backend decodes all lanes at once; the
  probe-union dedup runs across requests, and inactive lanes are masked out
  of the union (``core.decode.make_plan(active=...)``).
* **Per-request draws.** Admission draws the request's Gumbel noise for all
  its steps from its own generator, with the calls ``generate`` makes for a
  batch of one, so a request in a busy table gives the tokens it gives
  alone through ``generate(..., generator=)``. The tail samples of the
  estimators are shared by all lanes of a step (as the JAX step's
  ``fold_in(est_key, step_idx)`` is) and come from the scheduler's own
  generator or ``tail_source``.
* **Slot recycling.** A finished lane goes inactive on the device and back
  to the host's free list; the next admission rewinds it to position 0,
  and the per-lane validity mask hides the stale KV above the frontier.
  As in the JAX package, admission does not reset the lane's decode state
  and every step runs the trunk over every lane, dead ones included: a
  recurrent leaf (RWKV, Mamba) carries the previous occupant's history and
  the dead-lane steps into the next request. KV leaves are rewritten
  before they are attended, so there it does no harm.

**The slot table is a set of static device tensors updated in place**
(``SlotTable``): admission, recycling, ``drain``, the prefix pool's loads,
the fault masks and the draws are a few ``copy_``/``fill_`` calls outside
the step. On a GPU each tier's step is captured in one CUDA graph at its
first step and replayed once a step; on the CPU the same step runs
eagerly. Where the JAX package counts zero recompiles after warm-up, the
port counts zero captures (``captures``): admission, recycling,
temperatures, deadlines, fault masks, the shadow cadence and a switch back
to a tier already captured capture nothing. Before each replay the host
checks that every captured tensor kept its storage (``data_ptr``): a
rebound field would make the graph read stale memory without an error.

A new retrieval state or new params (``Engine.swap_index``,
``restore_index``, ``verify_and_restore``, a fault's ``_install_state``)
put other tensors in place of the ones a graph captured. The JAX step
takes them as traced arguments; a graph cannot, so the scheduler compares
the objects it captured with the engine's at every step (as the JAX
scheduler's ``_placed`` memo compares identity) and captures the tier
again when one changed, logging the seconds (``recapture_log``). It never
copies a new state into the captured tensors: those may be the engine's
restore source.

The robustness layer is the JAX package's: deadlines count down on the
device and a lapsed lane is evicted through the normal finish path;
``set_tier`` switches the estimator tier of the next step (the server's
degradation ladder); the health guard routes unhealthy lanes through the
exact pass (the gated ``topk_z``); an injector can raise before a step,
corrupt the retrieval state (caught by the digest cadence) or set per-lane
fault masks. The shadow oracle (JAX's ``lax.cond``) is the gated
``topk_z`` over ``active & do_shadow``: off its cadence it is one launch
that exits at once.

Speculative decoding (``spec_draft``/``spec_k``) drafts ``spec_k`` tokens
a lane with a cheap backend and verifies them with one decode of the
lane's tier. It is the same step body: at ``spec_k = 1`` (no draft) the
body is the plain step.

**The serving mesh.** On an engine with a (data, model) mesh
(``Engine(mesh=)``, ``launch.mesh``) lane s lives on data replica
s // lanes_per_replica, and admissions go to the least-loaded replica
(JAX's ``_pick_slot``). Each rank holds only its replica's lanes of the
slot table (``launch.mesh.serve_cache_spec``) and its model shard of the
retrieval payloads (``core.backends.local_shard``); the parameters are
whole on every rank. The step is the same ``_step_body``; the differences
are the output layer's ``shard_decode`` over the model group, the mesh
health guard and shadow oracle, and the combine of the packed per-lane
outputs over the data group: each replica writes its lanes into a zero
buffer and one all-reduce of their bit patterns gives every rank all S
lanes, with the step's counters (``_finish``). The metric state is then
accumulated from the combined outputs, so it is the same on every rank
and any rank may harvest.

The ranks keep in step as one SPMD host: every rank runs the same
``Server``/``Scheduler`` loop on the same arrivals, and every host decision
(admission, routing, completion, the prefix pool's trie, the injector)
reads only the virtual clock, the queue and the combined outputs, which
are the same on every rank. Every rank issues the same collectives in the
same order every step: none sits behind a host branch (the guard's exact
fallback runs every step, its rows spliced by ``torch.where``). Tail draws
come from the scheduler's generator, seeded alike on every rank. An NCCL
mesh step is captured in a CUDA graph as on one device; a gloo group
cannot be captured, so the caller passes ``eager=True`` there (nothing
chooses it from the backend).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.backends import (get_backend, local_shard, shadow_exact_log_z,
                             verify_decode)
from ..core.decode import (HEALTH_EMPTY_HEAD, HEALTH_NONFINITE_SCORE,
                           HEALTH_NONFINITE_Z, DecodeOut, apply_health_guard,
                           health_flags)
from ..core.distributed import bitsum_
from ..kernels import _build
from ..models import tree_paths
from ..obs.metrics import (TIER_IX, harvest, init_metric_state, observe_step,
                           reset_metric_state, shadow_rel_err)
from .engine import _draw_gumbel
from .output_layer import mesh_health_guard
from .prefix_cache import PrefixPool, cache_is_kv_only

_REQ_IDS = itertools.count()

# deadline sentinel: far above any real step count, small enough that the
# int32 countdown never wraps
NO_DEADLINE = 1 << 30


@dataclasses.dataclass
class Request:
    """One serving request. ``seed`` (or an explicit ``generator``) drives
    its sampling as ``generate(..., generator=)`` would for a batch of one.
    ``sample_k=0`` means the engine's configured ``sample_k``; smaller
    values restrict Gumbel-max to the top candidates. ``gumbel``, a
    (len(prompt) + max_new_tokens - 1, sample_k) array, injects the noise
    of each of the request's steps instead (parity tests)."""
    prompt: Any                       # (L,) ints (list / numpy / tensor)
    max_new_tokens: int
    seed: int = 0
    temperature: float = 0.0
    sample_k: int = 0
    deadline: int = 0                 # virtual steps from submission before
                                      # the request is shed/evicted (0 =
                                      # none; the server may stamp its
                                      # default)
    on_token: Optional[Callable] = None     # fn(request, token, wall_time)
    on_complete: Optional[Callable] = None  # fn(request, completion)
    generator: Optional[torch.Generator] = None
    gumbel: Any = None
    req_id: int = dataclasses.field(default_factory=lambda: next(_REQ_IDS))

    def __post_init__(self):
        if isinstance(self.prompt, torch.Tensor):
            self.prompt = self.prompt.cpu().numpy()
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)


@dataclasses.dataclass
class Completion:
    """Streamed back through ``Request.on_complete`` and returned by
    ``Scheduler.step`` when a lane finishes."""
    request: Request
    tokens: List[int]
    log_probs: List[float]
    log_zs: List[float]
    admit_time: float
    first_token_time: Optional[float]
    done_time: float
    overflowed: bool = False
    error: Optional[str] = None    # set when the request did not complete
                                   # normally (admission rejected: tokens
                                   # empty; evicted mid-decode: partial)
    reason: Optional[str] = None   # machine-readable code for error
                                   # completions: 'queue_full',
                                   # 'deadline_queue', 'deadline_evicted',
                                   # 'admit_rejected', 'fault_injected',
                                   # 'server_stopped'
    tiers: List[str] = dataclasses.field(default_factory=list)
                                   # estimator tier(s) this request's tokens
                                   # were served at, in order


@dataclasses.dataclass
class SlotTable:
    """The device state the step reads and writes, every field a static
    tensor updated in place (S = this rank's lanes: ``n_slots`` on one
    device, ``lanes_per_replica`` under the mesh)."""
    cache: Dict[str, Any]      # the model's decode-state tree, S lanes:
                               #      KV leaves (*stack, S, len, n_kv, hd)
                               #      and recurrent leaves (*stack, S, ...)
    prompt: torch.Tensor       # (S, P_cap) int64 padded prompt tokens
    last_token: torch.Tensor   # (S,) int64 lane's previous sampled token
    t_stream: torch.Tensor     # (S,) int32 step index within the request ==
                               #      the lane's next KV position
    t_replay: torch.Tensor     # (S,) int32 lane's prompt length
    budget: torch.Tensor       # (S,) int32 tokens still to emit
    temperature: torch.Tensor  # (S,) f32 sampling temperature
    sample_k: torch.Tensor     # (S,) int32 candidate restriction
    deadline: torch.Tensor     # (S,) int32 steps left before eviction
    active: torch.Tensor       # (S,) bool lane holds a live request
    step_idx: torch.Tensor     # ()   int64 steps taken
    noise: torch.Tensor        # (S, max_len, sample_k) f32 each lane's
                               #      Gumbel noise by stream step
    tail: torch.Tensor         # (l,) int64 the step's shared tail draw
    draft_tail: torch.Tensor   # (spec_k - 1, l) int64 the drafts' tails
    fault_nan: torch.Tensor    # (S,) bool injected NaN lanes
    fault_inf: torch.Tensor    # (S,) bool injected Inf lanes
    extras: torch.Tensor       # (4,) f32 queue depth, last step ms, last
                               #      step's tier, shadow flag
    outs: torch.Tensor         # (S + 1 + R, 4 k + 6) f32 the step's
                               #      outputs of all S lanes, read back in
                               #      one copy (row S: the active count and
                               #      the union size as int32 bits; row
                               #      S + 1 + r: replica r's shadow sum,
                               #      max and count)


def sample_slots(out: DecodeOut, noise: torch.Tensor,
                 temperature: torch.Tensor,
                 sample_k: Optional[torch.Tensor] = None):
    """Per-lane Gumbel-max over retrieved candidates: ``generate``'s
    sampler (``engine._sample_candidates``) with one temperature, noise row
    and candidate budget a row. ``noise`` (S, kc) is each lane's draw of
    the step; ``temperature`` (S,) with 0 = greedy (candidate 0, the top
    score); ``sample_k`` (S,) restricts lane s to its top ``sample_k[s]``
    candidates. Returns (token (S,) int64, score (S,) f32)."""
    kc = out.top_score.shape[1]
    t = temperature.float()
    hot = t > 0.0
    safe_t = torch.where(hot, t, torch.ones_like(t))
    noisy = out.top_score / safe_t[:, None] + noise
    if sample_k is not None:
        allowed = torch.arange(kc, device=noisy.device)[None, :] < \
            torch.clamp(sample_k, min=1)[:, None]
        noisy = torch.where(allowed, noisy,
                            torch.full_like(noisy, float("-inf")))
    drawn = torch.argmax(noisy, dim=-1)
    pick = torch.where(hot, drawn, torch.zeros_like(drawn))
    tok = torch.gather(out.top_id, 1, pick[:, None])[:, 0]
    score = torch.gather(out.top_score, 1, pick[:, None])[:, 0]
    return tok.long(), score


def spec_accept(n_ok: torch.Tensor, t_stream: torch.Tensor,
                t_replay: torch.Tensor, budget: torch.Tensor,
                active: torch.Tensor, draft_bad: torch.Tensor, max_len: int,
                spec_k: int) -> torch.Tensor:
    """Accepted-position count per lane for one speculative round.

    ``n_ok`` is the leading-correct-input count over the round's spec_k
    positions (position 0's input is correct, so n_ok >= 1). The accepted
    count ``a`` is n_ok capped three ways: a lane may not emit past its
    budget (replay positions emit nothing, so the first r = clip(t_replay -
    1 - t_stream, 0, k) positions are free), may not advance past the KV
    capacity, and a lane whose draft was health-flagged takes a = 1, the
    non-speculative step. Inactive lanes advance 0. Invariants: active
    lanes get 1 <= a <= spec_k; the emitted count max(0, a - r) never
    exceeds the budget; t_stream + a never exceeds max_len + 1, with
    equality only at the overflow finish."""
    r = torch.clamp(t_replay - 1 - t_stream, 0, spec_k)
    a = torch.minimum(n_ok, r + torch.clamp(budget, min=0))
    a = torch.where(draft_bad, torch.ones_like(a), a)
    a = torch.clamp(a, 1, spec_k)
    a = torch.minimum(a, torch.clamp(max_len - t_stream, min=1))
    return torch.where(active, a, torch.zeros_like(a)).to(torch.int32)


def vlm_refusal(cfg) -> str:
    """Why the slot scheduler does not step a VLM (``cfg.family ==
    "vlm"``)."""
    return (f"{cfg.name!r} is a VLM: the slot table carries no image for "
            f"its cross blocks (the JAX scheduler builds for a VLM engine "
            f"and fails on its first step for the same reason); serve it "
            f"through serve.generate(img=)")


@dataclasses.dataclass
class _StepGraph:
    """A tier's captured step: the objects it read at capture (compared by
    identity every step), the launches it records, the tensors' storage."""
    graph: Any
    deps: tuple
    counts: dict
    ptrs: List[tuple]


class Scheduler:
    """Fixed-capacity continuous-batching scheduler over one ``Engine``.

    Host side: a free-slot list, per-slot request bookkeeping, streaming
    callbacks. Device side: the ``SlotTable`` and one step a tier (a CUDA
    graph on a GPU). ``seed`` seeds the scheduler's generator, which draws
    the estimators' shared tail samples; ``tail_source(step_idx)``
    supplies them instead (parity tests). ``eager=True`` runs the step
    uncaptured on a GPU too (the counterpart of ``generate``'s
    ``host_loop=True``, for comparisons, and the mode of a gloo mesh).
    Audio (multi-codebook) heads and VLMs (no image in the slot table)
    have no slot-table path; use ``generate``. Under the engine's mesh
    ``n_slots`` counts the lanes of every replica and must divide the data
    degree; the table holds this rank's ``lanes_per_replica``."""

    def __init__(self, engine, n_slots: int, prompt_cap: Optional[int] = None,
                 seed: int = 0, injector=None, health_guard: bool = True,
                 spec_draft: Optional[str] = None, spec_k: int = 1,
                 spec_draft_probes: int = 0, prefix_cache_blocks: int = 0,
                 prefix_block_tokens: int = 8,
                 tail_source: Optional[Callable[[int], Any]] = None,
                 eager: bool = False):
        if engine.cfg.n_codebooks:
            raise NotImplementedError(
                "the slot scheduler serves single-stream text heads; "
                "audio codebook decoding goes through serve.generate")
        self.mesh = getattr(engine, "mesh", None)
        self._data_group = self._model_group = None
        self.n_replicas, self.replica = 1, 0
        self._n_model, self._model_rank = 1, 0
        if self.mesh is not None:
            from ..launch.mesh import (axis_group, axis_rank, axis_size,
                                       data_size)
            self.n_replicas = data_size(self.mesh)
            if n_slots % self.n_replicas:
                raise ValueError(
                    f"n_slots {n_slots} must divide the mesh's data degree "
                    f"{self.n_replicas} (each replica owns an equal set of "
                    f"KV lanes)")
            self.replica = axis_rank(self.mesh, "data")
            self._n_model = axis_size(self.mesh, "model")
            self._model_rank = axis_rank(self.mesh, "model")
            self._data_group = axis_group(self.mesh, "data")
            self._model_group = axis_group(self.mesh, "model")
        self.lanes_per_replica = n_slots // self.n_replicas
        self._lane0 = self.replica * self.lanes_per_replica
        if engine.cfg.family == "vlm":
            raise NotImplementedError(vlm_refusal(engine.cfg))
        dev = engine.device
        if dev.type == "cuda" and not engine.use_kernel:
            raise ValueError(
                "a GPU engine with use_kernel=False cannot be captured (its "
                "plain decode branches read the host)")
        self.engine = engine
        self.device = dev
        self.n_slots = n_slots
        self.prompt_cap = int(prompt_cap or engine.max_len)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.tail_source = tail_source
        self.eager = eager
        self.health_guard = health_guard
        self.injector = injector           # serve.faults.FaultInjector | None
        self.verify_index_every = 0        # digest-check cadence (0 = off);
                                           # the server sets it
        self.tier = engine.backend.method  # tier the next step decodes with
        self.captures = 0
        self.captures_by_tier: Dict[str, int] = {}
        self.recapture_log: List[tuple] = []   # (tier, seconds) of every
                                               # capture a state change forced
        self.steps_done = 0
        self._free = list(range(n_slots))
        self._slot_req: List[Optional[Request]] = [None] * n_slots
        self._slot_acc: List[Optional[Completion]] = [None] * n_slots
        self._faults_set = False
        self.shadow_every = 0              # shadow-oracle cadence (0 = off)
        self.metrics_state = init_metric_state(dev)
        self._last_step_ms = -1.0          # previous step's device phase,
                                           # fed into the latency histogram
        self._last_step_tier = engine.backend.method
        self.spec_draft = spec_draft
        self.spec_k = max(1, int(spec_k)) if spec_draft else 1
        pc = engine.cfg.partition
        self.spec_draft_probes = int(spec_draft_probes) or \
            max(1, pc.n_probe // 2)
        self.table = self._init_table()
        self._shards: Dict[str, tuple] = {}
        if self.mesh is not None:
            self._first_collectives()
        self.prefix: Optional[PrefixPool] = None
        if self.spec_k > 1 or prefix_cache_blocks:
            if engine.cfg.sliding_window or \
                    not cache_is_kv_only(self.table.cache):
                raise NotImplementedError(
                    "speculative decoding and the prefix cache rely on "
                    "rewindable full-attention KV lanes (a rejected or "
                    "stale position is overwritten before it is attended); "
                    "sliding-window ring buffers and recurrent decode "
                    "states break that argument")
        if self.spec_k > 1:
            get_backend(spec_draft)      # unknown drafts fail at init
        if prefix_cache_blocks:
            self.prefix = PrefixPool(
                self.table.cache, prefix_cache_blocks, prefix_block_tokens,
                max_match_blocks=max(
                    1, (self.prompt_cap - 1) // prefix_block_tokens),
                n_replicas=self.n_replicas, replica=self.replica)
        self._graphs: Dict[str, _StepGraph] = {}

    # -- device state --------------------------------------------------------

    def _init_table(self) -> SlotTable:
        """This rank's lanes of the table (all of them on one device); the
        outputs buffer holds every lane of every replica."""
        s, dev = self.lanes_per_replica, self.device
        eng = self.engine
        pc = eng.cfg.partition
        i32 = dict(dtype=torch.int32, device=dev)
        i64 = dict(dtype=torch.long, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        kk = self.spec_k
        return SlotTable(
            cache=eng.model.init_decode_state(s, eng.max_len, dev),
            prompt=torch.zeros((s, self.prompt_cap), **i64),
            last_token=torch.zeros((s,), **i64),
            t_stream=torch.zeros((s,), **i32),
            t_replay=torch.ones((s,), **i32),
            budget=torch.zeros((s,), **i32),
            temperature=torch.zeros((s,), **f32),
            sample_k=torch.ones((s,), **i32),
            deadline=torch.full((s,), NO_DEADLINE, **i32),
            active=torch.zeros((s,), dtype=torch.bool, device=dev),
            step_idx=torch.zeros((), **i64),
            noise=torch.zeros((s, eng.max_len, pc.sample_k), **f32),
            tail=torch.zeros((max(pc.l, 1),), **i64),
            draft_tail=torch.zeros((max(kk - 1, 1), max(pc.l, 1)), **i64),
            fault_nan=torch.zeros((s,), dtype=torch.bool, device=dev),
            fault_inf=torch.zeros((s,), dtype=torch.bool, device=dev),
            extras=torch.tensor([0.0, -1.0, 0.0, 0.0], **f32),
            outs=torch.zeros((self.n_slots + 1 + self.n_replicas,
                              4 * kk + 6), **f32))

    def _first_collectives(self) -> None:
        """One collective on each of the mesh's groups, so that a
        communicator's first call (which cannot be captured) comes before
        any graph capture."""
        for g in (self._data_group, self._model_group):
            bitsum_(torch.zeros((1,), dtype=torch.int32, device=self.device),
                    g)

    def _tier_state(self, method: str):
        """The state a step of ``method`` reads: the engine's, or under the
        mesh this rank's shard of it (views, made again when the engine's
        state object changes)."""
        st = self.engine.tier_state(method)
        if self.mesh is None:
            return st
        hit = self._shards.get(method)
        if hit is None or hit[0] is not st:
            hit = self._shards[method] = (
                st, local_shard(st, self._n_model, self._model_rank))
        return hit[1]

    def _decode(self, backend, state, h, cfg, **kw) -> DecodeOut:
        if self._model_group is None:
            return backend.decode(state, h, cfg, **kw)
        return backend.shard_decode(state, h, cfg, group=self._model_group,
                                    **kw)

    def _storage(self) -> List[tuple]:
        """(name, tensor) of every tensor a captured step reads or writes;
        a cache leaf is named by its path, as ``cache['rwkv']['wkv']``."""
        out = []
        for f in dataclasses.fields(self.table):
            v = getattr(self.table, f.name)
            if isinstance(v, dict):
                out += list(tree_paths(v, f.name))
            else:
                out.append((f.name, v))
        out += [(f"metrics_state.{f.name}", getattr(self.metrics_state,
                                                    f.name))
                for f in dataclasses.fields(self.metrics_state)]
        return out

    def _small_state(self) -> List[torch.Tensor]:
        """The tensors a step writes, but the KV leaves of the cache (a
        warm-up's KV writes are the ones its step makes again, once the
        rest is put back) and the outputs. A recurrent leaf (RWKV's
        ``wkv``, Mamba's ``ssm`` and conv states) is among them: a step
        folds it into itself, so a warm-up left in it would be applied
        twice."""
        tb = self.table
        recurrent = [t for path, t in tree_paths(tb.cache)
                     if not path.endswith(("['k']", "['v']"))]
        return [tb.last_token, tb.t_stream, tb.budget, tb.deadline,
                tb.active, tb.step_idx] + recurrent + [
            getattr(self.metrics_state, f.name)
            for f in dataclasses.fields(self.metrics_state)]

    # -- the step --------------------------------------------------------------

    def _fill_draws(self, tier: str) -> None:
        """The step's shared tail draws, into the table before the step
        (from ``tail_source(step_idx)`` or the scheduler's generator; the
        drafts' always from the generator)."""
        eng = self.engine
        pc = eng.cfg.partition
        backend, state = get_backend(tier), eng.tier_state(tier)
        if backend.has_tail(state):
            if self.tail_source is not None:
                tail = torch.as_tensor(
                    np.asarray(self.tail_source(self.steps_done)))
            else:
                tail = backend.draw_tail(state, pc, self.generator)
            self.table.tail.copy_(tail)
        if self.spec_k > 1:
            draft = get_backend(self.spec_draft)
            dstate = eng.tier_state(self.spec_draft)
            if draft.has_tail(dstate):
                for j in range(self.spec_k - 1):
                    self.table.draft_tail[j].copy_(
                        draft.draw_tail(dstate, pc, self.generator))

    def _lane_rows(self, buf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Row ``pos[s]`` of lane s of a (S, max_len, w) buffer: (S, w)."""
        idx = pos.long()[:, None, None].expand(-1, 1, buf.shape[-1])
        return torch.gather(buf, 1, idx)[:, 0]

    def _input_tokens(self, pos: torch.Tensor, prev: torch.Tensor):
        """The token each lane consumes at stream position ``pos``: its
        prompt token while replaying, else ``prev``."""
        tb = self.table
        t_clamp = torch.clamp(pos, max=self.prompt_cap - 1).long()
        ptok = torch.gather(tb.prompt, 1, t_clamp[:, None])[:, 0]
        is_rep = pos < tb.t_replay
        return torch.where(is_rep, ptok, prev), is_rep

    def _corrupt(self, out: DecodeOut, reps: int = 1) -> DecodeOut:
        """Lane-scoped fault injection: NaN or Inf log Ẑ and candidate
        scores in the lanes the masks name (all False in normal service);
        ``reps`` rows a lane."""
        tb = self.table
        nan, inf = tb.fault_nan, tb.fault_inf
        if reps > 1:
            nan = nan[:, None].expand(-1, reps).reshape(-1)
            inf = inf[:, None].expand(-1, reps).reshape(-1)
        corrupt = nan | inf
        lz = out.log_z
        bad = torch.where(inf, torch.full_like(lz, float("inf")),
                          torch.full_like(lz, float("nan")))
        return out._replace(
            log_z=torch.where(corrupt, bad, lz),
            top_score=torch.where(corrupt[:, None], bad[:, None],
                                  out.top_score))

    def _guard(self, out: DecodeOut, w: torch.Tensor, h: torch.Tensor,
               active: torch.Tensor):
        k = self.engine.cfg.partition.sample_k
        if self.health_guard and self._model_group is not None:
            return mesh_health_guard(out, w, h, k, active=active,
                                     use_kernel=self.engine.use_kernel,
                                     group=self._model_group)
        if self.health_guard:
            return apply_health_guard(out, w, h, k, active=active,
                                      use_kernel=self.engine.use_kernel)
        return out, torch.zeros(active.shape, dtype=torch.int32,
                                device=active.device)

    def _shadow(self, log_z, state, h, active):
        """The shadow oracle over ``active & do_shadow``: the gated exact
        pass, which off the cadence scores no row."""
        eng = self.engine
        rows = active & (self.table.extras[3] > 0)
        ref = shadow_exact_log_z(state, h, k=eng.cfg.partition.sample_k,
                                 use_kernel=eng.use_kernel,
                                 rows=rows.to(torch.int32),
                                 group=self._model_group)
        return shadow_rel_err(log_z, ref, rows)

    def _finish(self, tier: str, act, emit, finished, overflow, expired,
                flags, head_live, tok, log_prob, log_z, shadow, spec=None):
        """The step's packed outputs, then its metrics from them. This
        replica's lanes go to their rows of a zero buffer, its counters to
        row S (int32 bits) and its shadow triple to row S + 1 + replica;
        under the mesh one all-reduce of the bit patterns over the data
        group makes every rank hold every replica's rows, and the metrics
        read the combined buffer. The previous step's host ms differs from
        rank to rank, so under the mesh the latency histogram takes the
        largest (a MAX over the model group, then over the replicas' rows)
        and the metric state stays the same on every rank."""
        tb = self.table
        s, kk, n_rep = self.n_slots, self.spec_k, self.n_replicas
        n_active = act.to(torch.int32).sum()
        if head_live is None:
            head_live = torch.zeros((), dtype=torch.int32, device=act.device)
        a = (torch.zeros_like(n_active).expand(act.shape) if spec is None
             else spec["accepted"])
        dflag = (torch.zeros_like(act) if spec is None
                 else spec["flagged_lanes"])
        f = torch.float32
        cols = [tok.to(f), log_prob.to(f), log_z.to(f), emit.to(f)] + [
            v.to(f)[:, None] for v in (finished, overflow, expired, flags, a,
                                       dflag)]
        o = tb.outs
        oi = o.view(torch.int32)
        o.zero_()
        o[self._lane0:self._lane0 + self.lanes_per_replica].copy_(
            torch.cat(cols, 1))
        oi[s, :2].copy_(torch.stack([n_active, head_live.to(torch.int32)]))
        sh_sum, sh_max, sh_n = shadow
        me = s + 1 + self.replica
        o[me, :2].copy_(torch.stack([torch.as_tensor(sh_sum).to(f),
                                     torch.as_tensor(sh_max).to(f)]))
        oi[me, 2].copy_(torch.as_tensor(sh_n).to(torch.int32))
        x = tb.extras
        last_ms = x[1]
        if self._data_group is not None:
            ms = x[1:2].clone()
            dist.all_reduce(ms, op=dist.ReduceOp.MAX,
                            group=self._model_group)
            o[me, 3:4].copy_(ms)
            bitsum_(o, self._data_group)
            last_ms = o[s + 1:s + 1 + n_rep, 3].max()
        lanes, reps = o[:s], o[s + 1:s + 1 + n_rep]
        kw = {} if spec is None else dict(
            spec_proposed=oi[s, 0] * kk,
            spec_accepted=lanes[:, 4 * kk + 4].sum(),
            draft_flagged=lanes[:, 4 * kk + 5].sum())
        observe_step(self.metrics_state, TIER_IX[tier], s,
                     n_active=oi[s, 0], head_live=oi[s, 1],
                     n_emitted=(lanes[:, 3 * kk:4 * kk] > 0).sum(),
                     health_flags=lanes[:, 4 * kk + 3].to(torch.int32),
                     queue_depth=x[0], last_ms=last_ms, last_tier=x[2],
                     shadow=(reps[:, 0].sum(), reps[:, 1].max(),
                             oi[s + 1:s + 1 + n_rep, 2].sum()), **kw)

    def _step_body(self, tier: str) -> None:
        """The mixed replay/decode step on the table, in place: what a
        CUDA graph captures. ``spec_k`` trunk steps, each but the last
        followed by a draft decode at ``spec_draft_probes``, then one
        decode of all S x spec_k positions by the tier (the verifier), and
        each lane advanced by ``spec_accept``. At spec_k 1 (no draft) this
        is the plain step: one trunk step, one decode of the S lanes, and
        every live lane advanced by one.

        Sampling is Gumbel-max on the request's noise row of each position,
        so the verifier's sample at position j is what the plain step would
        emit there, provided position j's input was right. The accepted
        prefix is exactly the positions whose inputs were right, so the
        emitted tokens are the plain scheduler's for greedy and temperature
        lanes alike. Rejected positions leave KV above the frontier, which
        a later step rewrites before it is attended, and the per-lane mask
        hides the rest. The ladder changes the verifier; the draft stays."""
        eng = self.engine
        pc = eng.cfg.partition
        backend, bstate = get_backend(tier), self._tier_state(tier)
        if self.spec_k > 1:
            draft = get_backend(self.spec_draft)
            dstate = self._tier_state(self.spec_draft)
            draft_pc = dataclasses.replace(pc, method=self.spec_draft,
                                           n_probe=self.spec_draft_probes)
        kk, s = self.spec_k, self.lanes_per_replica
        tb = self.table
        max_len = eng.max_len
        act = tb.active.clone()
        hs, noises, reps, ovfls, dtoks = [], [], [], [], []
        draft_bad = torch.zeros_like(act)
        d_prev = tb.last_token
        for j in range(kk):
            pos = tb.t_stream + j
            tok_in, is_rep = self._input_tokens(pos, d_prev)
            ovfls.append(act & (pos >= max_len))
            pos_safe = torch.clamp(pos, max=max_len - 1)
            h = eng.model.decode_step(eng.params, tb.cache, tok_in, pos_safe)
            noise = self._lane_rows(tb.noise, pos_safe)
            hs.append(h)
            noises.append(noise)
            reps.append(is_rep)
            if j < kk - 1:
                dout = self._decode(
                    draft, dstate, h, draft_pc, k=pc.sample_k,
                    use_kernel=eng.use_kernel,
                    tail_idx=(tb.draft_tail[j] if draft.has_tail(dstate)
                              else None), active=act)
                # the lane fault masks corrupt the draft too: a flagged
                # draft takes that lane to a = 1 below
                dout = self._corrupt(dout)
                draft_bad = draft_bad | (health_flags(dout) > 0)
                d_tok, _ = sample_slots(dout, noise, tb.temperature,
                                        tb.sample_k)
                dtoks.append(d_tok)
                d_prev = d_tok
        hseq = torch.stack(hs, 1)
        # the engine's tuned launch knobs are its own method's, at this
        # verify's rows; the other tiers and the draft launch as they are
        kernel_cfg = eng.knobs(hseq.shape[0] * hseq.shape[1]) \
            if tier == eng.backend.method else {}
        out = verify_decode(
            backend, bstate, hseq, pc, k=pc.sample_k, active=act,
            use_kernel=eng.use_kernel,
            tail_idx=tb.tail if backend.has_tail(bstate) else None,
            group=self._model_group, **kernel_cfg)
        act_r = act[:, None].expand(-1, kk).reshape(-1)
        hflat = hseq.reshape(-1, hseq.shape[-1])
        out, vflags = self._guard(self._corrupt(out, kk), bstate.w, hflat,
                                  act_r)

        def rep(v):
            return v[:, None].expand(-1, kk).reshape(-1)

        v_tok, v_score = sample_slots(
            out, torch.stack(noises, 1).reshape(s * kk, -1),
            rep(tb.temperature), rep(tb.sample_k))
        v_tok = v_tok.reshape(s, kk)
        v_score = v_score.reshape(s, kk)
        log_z = out.log_z.reshape(s, kk)
        vflags = vflags.reshape(s, kk)
        # acceptance: the leading positions whose inputs were right
        ok = torch.ones_like(act)
        oks = [ok]
        for j in range(1, kk):
            ok = ok & (reps[j] | (dtoks[j - 1] == v_tok[:, j - 1]))
            oks.append(ok)
        n_ok = torch.stack(oks, 1).to(torch.int32).sum(1)
        a = spec_accept(n_ok, tb.t_stream, tb.t_replay, tb.budget, act,
                        draft_bad, max_len, kk)
        jpos = torch.arange(kk, device=act.device)[None, :]
        accepted_m = jpos < a[:, None]
        ovfl_m = torch.stack(ovfls, 1)
        emit = accepted_m & act[:, None] & (
            (tb.t_stream[:, None] + jpos) >= (tb.t_replay[:, None] - 1)) \
            & ~ovfl_m
        e = emit.to(torch.int32).sum(1)
        new_budget = tb.budget - e
        overflow = ovfl_m[:, 0]
        done = (act & (e > 0) & (new_budget <= 0)) | overflow
        # one speculative round is one virtual step of deadline service
        new_ddl = tb.deadline - act.to(torch.int32)
        expired = act & ~done & (new_ddl <= 0)
        finished = done | expired
        idx = torch.clamp(a - 1, 0, kk - 1).long()
        lt = torch.gather(v_tok, 1, idx[:, None])[:, 0]
        tb.last_token.copy_(torch.where(act, lt, tb.last_token))
        tb.t_stream.add_(a)
        tb.budget.copy_(new_budget)
        tb.deadline.copy_(new_ddl)
        tb.active.copy_(act & ~finished)
        tb.step_idx.add_(1)
        flags_l = torch.zeros_like(n_ok)
        for j in range(kk):
            flags_l = flags_l | torch.where(accepted_m[:, j], vflags[:, j],
                                            torch.zeros_like(vflags[:, j]))
        # the shadow oracle scores the same S x spec_k verify rows
        shadow = self._shadow(out.log_z, bstate, hflat, act_r)
        spec = None if kk == 1 else dict(accepted=a,
                                         flagged_lanes=draft_bad & act)
        self._finish(tier, act, emit, finished, overflow, expired,
                     flags_l, out.head_live, v_tok, v_score - log_z, log_z,
                     shadow, spec=spec)

    def _deps(self, tier: str) -> tuple:
        """What a tier's captured step read besides the table: compared by
        identity before every replay."""
        eng = self.engine
        dstate = eng.tier_state(self.spec_draft) if self.spec_k > 1 else None
        return (eng.params, eng.tier_state(tier), dstate, self.health_guard,
                eng.use_kernel)

    def _capture(self, tier: str, deps: tuple) -> _StepGraph:
        """Warm the step up once on a side stream (first-use loads, tier
        state builds), put back the state it advanced, then capture one
        step in a CUDA graph. A capture that fails raises: nothing falls
        back to the eager step."""
        dev = self.device
        keep = [t.clone() for t in self._small_state()]
        before = _build.snapshot()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step_body(tier)
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, k in zip(self._small_state(), keep):
            t.copy_(k)
        mid = _build.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step_body(tier)
        counts = _build.counts_since(mid)
        _build.restore(before)           # a capture launches nothing
        self.captures += 1
        self.captures_by_tier[tier] = self.captures_by_tier.get(tier, 0) + 1
        return _StepGraph(graph=graph, deps=deps, counts=counts,
                          ptrs=[(n, t.data_ptr()) for n, t in
                                self._storage()])

    def _check_storage(self, g: _StepGraph) -> None:
        for (name, ptr), (_, t) in zip(g.ptrs, self._storage()):
            if t.data_ptr() != ptr:
                raise RuntimeError(
                    f"slot table field {name} was rebound after its step was "
                    f"captured: the graph would read its old storage; update "
                    f"table tensors in place (copy_/fill_)")

    def _run_step(self, tier: str) -> None:
        """One step: eager on the CPU; on a GPU the tier's graph, captured
        at its first step and again when the engine's state changed."""
        if self.device.type != "cuda" or self.eager:
            self._step_body(tier)
            return
        deps = self._deps(tier)
        g = self._graphs.get(tier)
        if g is not None and any(a is not b for a, b in zip(g.deps, deps)):
            self._graphs.pop(tier)
            g = None
            t0 = time.perf_counter()
            g = self._graphs[tier] = self._capture(tier, deps)
            torch.cuda.synchronize(self.device)
            secs = time.perf_counter() - t0
            self.recapture_log.append((tier, secs))
            if self.engine.obs is not None:
                self.engine.obs.instant("recapture", args={
                    "tier": tier, "seconds": secs,
                    "captures": self.captures})
        elif g is None:
            g = self._graphs[tier] = self._capture(tier, deps)
        self._check_storage(g)
        g.graph.replay()
        _build.add_counts(g.counts)

    def set_tier(self, method: str) -> None:
        """Switch the estimator tier the next step decodes with (the
        server's degradation ladder). Each tier's step is captured once,
        lazily; tier states reuse the engine's index (``Engine.tier_state``),
        so after warm-up a switch is a host pointer update."""
        if method == self.tier:
            return
        get_backend(method)   # unknown tiers fail here, not in a step
        self.tier = method

    # -- host API -------------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    def _pick_slot(self, preferred_replica: Optional[int] = None) -> int:
        """Claim a free lane: the lowest on one replica; under the mesh the
        lowest lane of the least-loaded replica (most free lanes, ties to
        the lowest replica), so staggered admissions spread over the
        replicas. ``preferred_replica`` (the owner of a matched prefix
        chain) is tried first; without a free lane there the admission
        falls through to the least-loaded replica and forfeits the hit."""
        if self.n_replicas == 1:
            return self._free.pop(0)
        lpr = self.lanes_per_replica
        if preferred_replica is not None:
            cand = [s for s in self._free if s // lpr == preferred_replica]
            if cand:
                slot = min(cand)
                self._free.remove(slot)
                return slot
        free_per = [0] * self.n_replicas
        for s in self._free:
            free_per[s // lpr] += 1
        rep = max(range(self.n_replicas), key=lambda r: (free_per[r], -r))
        slot = min(s for s in self._free if s // lpr == rep)
        self._free.remove(slot)
        return slot

    def free_in_replica(self, replica: int) -> int:
        """Free lanes of one data replica (the whole table on one): the
        server's look-ahead admission asks it before holding a request for
        its prefix's owner."""
        if self.n_replicas == 1:
            return len(self._free)
        return sum(1 for s in self._free
                   if s // self.lanes_per_replica == replica)

    def prefix_preview(self, request: Request):
        """(cached prefix tokens, owner replica) the prefix pool would give
        ``request`` at admission; owner None with the pool off or on a
        miss. The same host walk as admission (it touches the LRU ticks, as
        the JAX pool's does)."""
        if self.prefix is None:
            return 0, None
        p_len = int(request.prompt.shape[0])
        if p_len < 1:
            return 0, None
        m, _, owner = self.prefix.match(request.prompt, p_len)
        return m * self.prefix.block_tokens, owner

    def _local(self, slot: int) -> Optional[int]:
        """``slot``'s lane in this rank's table, or None on another
        replica."""
        lane = slot - self._lane0
        return lane if 0 <= lane < self.lanes_per_replica else None

    @property
    def n_in_flight(self) -> int:
        return self.n_slots - len(self._free)

    def _request_noise(self, request: Request,
                       total: int) -> Optional[torch.Tensor]:
        """The request's Gumbel noise of each of its ``total`` steps: the
        injected ``gumbel``, or ``total`` draws of (1, sample_k) from its
        generator (``generate``'s calls for a batch of one); None at
        temperature 0, where no noise is read."""
        k = self.engine.cfg.partition.sample_k
        if request.gumbel is not None:
            g = torch.as_tensor(np.asarray(request.gumbel, np.float32))
            if tuple(g.shape) != (total, k):
                raise ValueError(f"Request.gumbel has shape "
                                 f"{tuple(g.shape)}, want {(total, k)}")
            return g
        if request.temperature <= 0.0:
            return None
        gen = request.generator or torch.Generator(
            device=self.device).manual_seed(int(request.seed))
        return torch.cat([_draw_gumbel((1, k), gen, self.device)
                          for _ in range(total)])

    def admit(self, request: Request,
              deadline_steps: Optional[int] = None) -> int:
        """Place a request in a free lane; returns the slot index. Raises
        when the table is full (callers queue: see serve.server) or when
        the request cannot fit the engine's caches. ``deadline_steps`` is
        the lane's eviction countdown in steps (None = no deadline); the
        server passes the request's remaining deadline."""
        if self.injector is not None:
            # the fault hook fires before any state changes: a rejected
            # admission leaves the scheduler as it was
            self.injector.on_admit(request, self)
        if deadline_steps is not None and deadline_steps < 1:
            raise ValueError("deadline already expired at admission")
        p_len = int(request.prompt.shape[0])
        if p_len < 1:
            raise ValueError("request needs a non-empty prompt")
        if p_len > self.prompt_cap:
            raise ValueError(
                f"prompt length {p_len} > scheduler prompt_cap "
                f"{self.prompt_cap}")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        need = p_len + request.max_new_tokens - 1
        if need > self.engine.max_len:
            raise ValueError(
                f"request needs {need} cache positions (prompt {p_len} + "
                f"{request.max_new_tokens} tokens) but engine max_len is "
                f"{self.engine.max_len}")
        if not self._free:
            raise RuntimeError("no free slot; queue the request instead")
        noise = self._request_noise(request, need)
        # prefix cache: a host trie match, then the cached KV copied into
        # the lane in place; the replay resumes at t0. Under the mesh a
        # lane on another replica than the chain's owner forfeits the hit.
        pref_ids: List[int] = []
        owner = None
        if self.prefix is not None:
            _, pref_ids, owner = self.prefix.match(request.prompt, p_len)
        slot = self._pick_slot(owner)
        lane = self._local(slot)
        tb = self.table
        t0 = 0
        if pref_ids and slot // self.lanes_per_replica == owner:
            pref_ids = self.prefix.owned_run(pref_ids, owner)
            self.prefix.load(None if lane is None else tb.cache, pref_ids,
                             lane)
            t0 = len(pref_ids) * self.prefix.block_tokens
        self._slot_req[slot] = request
        self._slot_acc[slot] = Completion(
            request=request, tokens=[], log_probs=[], log_zs=[],
            admit_time=time.perf_counter(), first_token_time=None,
            done_time=0.0)
        if lane is None:                  # another replica's lane
            return slot
        prompt_row = np.zeros((self.prompt_cap,), np.int64)
        prompt_row[:p_len] = request.prompt
        pc = self.engine.cfg.partition
        sk = request.sample_k or pc.sample_k
        sk = max(1, min(sk, pc.sample_k))
        ddl = NO_DEADLINE if deadline_steps is None else int(deadline_steps)
        tb.prompt[lane].copy_(torch.from_numpy(prompt_row))
        tb.last_token[lane] = int(request.prompt[0])
        tb.t_stream[lane] = t0
        tb.t_replay[lane] = p_len
        tb.budget[lane] = int(request.max_new_tokens)
        tb.temperature[lane] = float(request.temperature)
        tb.sample_k[lane] = sk
        tb.deadline[lane] = ddl
        if noise is not None:
            tb.noise[lane, :need].copy_(noise)
        tb.active[lane] = True
        return slot

    def step(self, queue_depth: int = 0) -> dict:
        """Advance every live lane one step. Returns a host-side record:
        emitted tokens (streamed through ``on_token``), finished requests
        (``on_complete``, and under ``"completions"``), occupancy, probe
        dedup, tier and estimator-health metrics. ``queue_depth`` is the
        server's admission backlog, written into the device's queue gauge.

        Order: the injector fires first (a raised ``FaultError`` leaves the
        table unadvanced, and the server retries), then the digest cadence,
        so a corrupted retrieval state is repaired before the step reads
        it, then the step, then one readback of its outputs.

        ``wall_device_s`` covers the draws, the step and the readback;
        ``wall_host_s`` everything else (injector, digest, bookkeeping,
        callbacks)."""
        t0 = time.perf_counter()
        if self.injector is not None:
            self.injector.on_step_begin(self)
        restored = False
        if self.verify_index_every and \
                self.steps_done % self.verify_index_every == 0:
            restored = self.engine.verify_and_restore(self.tier)
        tb = self.table
        lanes = None if self.injector is None else \
            self.injector.lane_faults(self)
        if lanes is not None:
            mine = slice(self._lane0, self._lane0 + self.lanes_per_replica)
            tb.fault_nan.copy_(torch.from_numpy(
                np.asarray(lanes[0], bool)[mine]))
            tb.fault_inf.copy_(torch.from_numpy(
                np.asarray(lanes[1], bool)[mine]))
            self._faults_set = True
        elif self._faults_set:
            tb.fault_nan.zero_()
            tb.fault_inf.zero_()
            self._faults_set = False
        do_shadow = bool(self.shadow_every
                         and self.steps_done % self.shadow_every == 0)
        tb.extras.copy_(torch.tensor(
            [max(queue_depth, 0), self._last_step_ms,
             TIER_IX[self._last_step_tier], float(do_shadow)],
            dtype=torch.float32))
        t_dispatch = time.perf_counter()
        self._fill_draws(self.tier)
        self._run_step(self.tier)
        self.steps_done += 1
        out = tb.outs.cpu().numpy()
        now = time.perf_counter()
        self._last_step_ms = (now - t_dispatch) * 1e3
        self._last_step_tier = self.tier
        s, kk = self.n_slots, self.spec_k
        tok = out[:s, :kk].astype(np.int64)
        lp = out[:s, kk:2 * kk]
        lz = out[:s, 2 * kk:3 * kk]
        em = out[:s, 3 * kk:4 * kk] > 0
        finished, overflow, expired = (out[:s, 4 * kk + i] > 0
                                       for i in range(3))
        flags = out[:s, 4 * kk + 3].astype(np.int64)
        n_active, head_live = (int(v) for v in out.view(np.int32)[s, :2])
        completions = []
        for lane in range(s):
            req = self._slot_req[lane]
            if req is None:
                continue
            acc = self._slot_acc[lane]
            for j in range(kk):
                if not em[lane, j]:
                    continue
                if acc.first_token_time is None:
                    acc.first_token_time = now
                acc.tokens.append(int(tok[lane, j]))
                acc.log_probs.append(float(lp[lane, j]))
                acc.log_zs.append(float(lz[lane, j]))
                if not acc.tiers or acc.tiers[-1] != self.tier:
                    acc.tiers.append(self.tier)
                if req.on_token is not None:
                    req.on_token(req, int(tok[lane, j]), now)
            if finished[lane]:
                acc.done_time = now
                acc.overflowed = bool(overflow[lane])
                if expired[lane]:
                    acc.error = "deadline exceeded (evicted mid-decode)"
                    acc.reason = "deadline_evicted"
                if self.prefix is not None and acc.error is None \
                        and not acc.overflowed:
                    # a cleanly finished lane's prompt KV is valid: register
                    # its block-aligned prefix before the slot recycles
                    self.prefix.insert(req.prompt, int(req.prompt.shape[0]),
                                       tb.cache, self._local(lane),
                                       lane // self.lanes_per_replica)
                self._slot_req[lane] = None
                self._slot_acc[lane] = None
                self._free.append(lane)
                self._free.sort()
                completions.append(acc)
                if req.on_complete is not None:
                    req.on_complete(req, acc)
        t_done = time.perf_counter()
        rec = {"wall_s": t_done - t0,
               "wall_device_s": now - t_dispatch,
               "wall_host_s": (t_dispatch - t0) + (t_done - now),
               "t_start": t0, "t_dispatch": t_dispatch,
               "t_device_done": now, "t_done": t_done,
               "n_active": n_active,
               "head_live": head_live,
               "occupancy": n_active / self.n_slots,
               "completions": completions,
               "tier": self.tier,
               "n_emitted": int(em.sum()),
               "index_restored": restored,
               "health_flagged": int((flags > 0).sum()),
               "health_nonfinite_z":
                   int((flags & HEALTH_NONFINITE_Z > 0).sum()),
               "health_empty_head":
                   int((flags & HEALTH_EMPTY_HEAD > 0).sum()),
               "health_nonfinite_score":
                   int((flags & HEALTH_NONFINITE_SCORE > 0).sum())}
        if kk > 1:
            rec["spec_proposed"] = n_active * kk
            rec["spec_accepted"] = int(out[:s, 4 * kk + 4].sum())
            rec["draft_flagged"] = int(out[:s, 4 * kk + 5].sum())
        return rec

    def harvest_metrics(self) -> dict:
        """One device-to-host read of the cumulative metric state (see
        ``obs.metrics.harvest``). Counters are monotone."""
        return harvest(self.metrics_state, self.n_slots)

    def reset_metrics(self) -> None:
        """Zero the device metric state in place (between benchmark
        phases): the captured steps keep reading it."""
        reset_metric_state(self.metrics_state)
        self._last_step_ms = -1.0

    def drain(self, reason: str = "server_stopped") -> List[Completion]:
        """Close out every in-flight lane host-side: each open request
        becomes an errored completion with the tokens it already emitted,
        its lane returns to the free list, and the table's lanes are
        deactivated in place. The server flushes through this at shutdown
        or ``max_steps``."""
        now = time.perf_counter()
        completions = []
        for s in range(self.n_slots):
            req = self._slot_req[s]
            if req is None:
                continue
            acc = self._slot_acc[s]
            acc.done_time = now
            acc.error = f"evicted: {reason}"
            acc.reason = reason
            self._slot_req[s] = None
            self._slot_acc[s] = None
            self._free.append(s)
            completions.append(acc)
            if req.on_complete is not None:
                req.on_complete(req, acc)
        if completions:
            self._free.sort()
            tb = self.table
            tb.active.zero_()
            tb.budget.zero_()
            tb.deadline.fill_(NO_DEADLINE)
        return completions
