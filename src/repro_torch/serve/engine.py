"""Serving engine: prefill and cached decode with partition-estimated
probabilities (counterpart of ``repro.serve.engine``; the port carries
``Engine`` with its retrieval-state lifecycle, ``decode_step``,
``next_token_distribution`` and ``generate``).

Every method dispatches through the estimator-backend registry: one batched
decode returns log Ẑ plus the retrieved top ``sample_k`` candidates, and
sampling (greedy, or Gumbel-max at temperature T over the candidates)
happens once on top. The retrieval state is checksummed (``_digest``) at
every build, swap and restore, so ``verify_and_restore`` can catch a
corrupted index before a step reads it.

On a GPU ``generate`` replays one captured CUDA graph per decode step
(``_GraphRunner``, the counterpart of the JAX ``_scan_runner``): the step
reads its position, prompt token, tail draw and Gumbel noise from device
buffers filled before the replays, so nothing in it reads the host.

A VLM (llama-3.2-vision) serves with its image: ``prefill``,
``decode_step`` and ``generate`` take ``img`` (B, n_image_tokens, d), and
the captured step reads it from a buffer of the runner, so a new image
replays the same graph.

An audio model (``n_codebooks`` C > 0) has no retrieval state: each step
takes tokens (B, C) and samples every codebook from its exact softmax over
V (``_codebook_distribution``); prompts are (B, S, C) and ``generate``
returns (B, n_tokens, C).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import resolve_device
from ..core.backends import (BACKENDS, BackendState, fmbe_block_state,
                             get_backend)
from ..core.decode import DecodeOut, apply_health_guard
from ..core.feature_maps import FeatureMap, make_feature_map
from ..kernels import _build
from ..kernels.autotune import QUERY_TILE, query_tiles
from ..models import Model, tree_leaves
from ..models.transformer import _check_img, torch_dtype

# blocks of the index the digest reads at a time (64 blocks of 512 x 2560
# f32: 336 MB)
_DIGEST_BLOCKS = 64


@dataclasses.dataclass
class ServeState:
    cache: Any                   # the model's decode-state tree, updated in
                                 # place
    pos: torch.Tensor            # int32 next position to write: 0-d or (B,)
    last_token: torch.Tensor     # (B,), or (B, C) with codebooks


def _capturing(device: torch.device) -> bool:
    """True while the current CUDA stream of ``device`` is being captured
    into a graph (a captured step cannot read the host)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _index_digest(v_blocks: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Two-scalar integrity checksum of an IVF block tensor (0-d f32 on its
    device): a position-weighted sum, sum_p (1 + p) * sum_d x[p, d] over
    the flattened rows p, which catches row and block permutations, and the
    sum of squares, which catches zeroing and drift. Every sum is a
    reduction in a fixed order, no atomics, so the same data gives the same
    bits in every call and process. Dead blocks add nothing."""
    nb, br, d = v_blocks.shape
    parts_a, parts_b = [], []
    for b0 in range(0, nb, _DIGEST_BLOCKS):
        x = v_blocks[b0:b0 + _DIGEST_BLOCKS].float()
        wts = 1.0 + torch.arange(b0 * br, b0 * br + x.shape[0] * br,
                                 dtype=torch.float32, device=x.device)
        parts_a.append((x.sum(-1).reshape(-1) * wts).sum())
        parts_b.append((x * x).sum())
        del x
    return torch.stack(parts_a).sum(), torch.stack(parts_b).sum()


def _digest(v_blocks: torch.Tensor) -> tuple:
    a, b = _index_digest(v_blocks)
    return (float(a), float(b))


def _shapes(obj, path: str = "state") -> list:
    """(path, shape, dtype) of every tensor in a retrieval state, and the
    value of every int, walking dataclasses and named tuples."""
    if isinstance(obj, torch.Tensor):
        return [(path, tuple(obj.shape), obj.dtype)]
    if dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = list(zip(obj._fields, obj))
    elif isinstance(obj, (int, float)) or obj is None:
        return [(path, obj)]
    else:
        return []
    return [e for name, v in items for e in _shapes(v, f"{path}.{name}")]


class Engine:
    """Batched serving for one model. The retrieval state (IVF index, FMBE
    sketch, LSH index) is built from the output embedding by the method's
    backend; training-only methods serve through ``exact``.

    ``seed`` seeds the engine's generator on ``device``, which draws the
    tail samples and the Gumbel noise. Builds, swaps and restores draw the
    FMBE feature map, the k-means initialisation and the LSH hyperplanes
    from a fresh generator seeded the same way (``_build_generator``), so a
    rebuild from the same params gives the same state bit for bit and never
    advances the decode draws. ``index_assign`` injects the index's k-means
    assignment, ``feature_map`` the feature map and ``lsh_proj`` the (L, K,
    d+1) hyperplanes of the construction-time build instead.

    ``device_index=True`` builds the index at its fixed capacity
    (``mips.build_ivf_device``), so ``swap_index`` keeps every shape;
    ``health_guard=True`` routes unhealthy queries of every step to the
    exact pass (``core.decode.apply_health_guard``). An audio model builds
    no retrieval state (``state`` and ``index`` are None) and takes no
    guard, as in the JAX engine.

    ``autotune=True`` measures the launch knobs of the backend's kernel at
    build (``EstimatorBackend.tune``, ``kernels.autotune``: sweeps cached
    on disk), once a query-tile count up to ``autotune_batch``'s
    (``autotune.query_tiles``: the grid that wins depends on it), each on
    the first rows of one seeded batch of ``autotune_batch`` hidden states
    drawn from 0.1 N(0, 1) in the model's dtype. ``kernel_cfg`` keeps them
    by tile count, and every decode of the engine's own method takes those
    of its batch's count (``knobs``: ``generate``'s captured step and host
    loop, the scheduler's steps); a batch of a count not tuned launches as
    by default. Only a CUDA engine with ``use_kernel`` sweeps; otherwise
    ``kernel_cfg`` is {}. Swaps and restores keep it: the shapes it was
    tuned for stay.

    ``mesh`` (``launch.mesh.make_serving_mesh``) is the (data, model)
    serving mesh the slot scheduler steps over; every rank of it builds
    the engine from the same seed and params, and the construction checks
    that they agree (a digest of the params and the index, MAX - MIN over
    the ranks). The index's block axis is padded to a multiple of the
    model degree. The engine keeps the whole retrieval state, as the JAX
    engine does: its own paths (``generate``, ``prefill``) stay on one
    device and are what the mesh step is held to, and the scheduler takes
    each rank's rows as views of it. Unlike the JAX engine, which refuses
    ``use_pallas`` under a mesh because a Pallas call could not run inside
    ``shard_map``, the port keeps ``use_kernel``: the mesh bodies launch
    the kernels on gathered operands and compute the same function."""

    def __init__(self, model: Model, params, max_len: int, *, seed: int = 0,
                 use_kernel: bool = True, device="cuda",
                 device_index: bool = False, health_guard: bool = False,
                 index_assign: Optional[torch.Tensor] = None,
                 feature_map: Optional[FeatureMap] = None,
                 lsh_proj: Optional[torch.Tensor] = None, mesh=None,
                 autotune: bool = False, autotune_batch: int = 64):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.mesh = mesh
        self._block_multiple = self._mesh_multiple(mesh)
        self.params = params
        self.max_len = max_len
        self.use_kernel = use_kernel
        self.device_index = device_index
        self.health_guard = health_guard
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        pc = self.cfg.partition
        method = pc.method if pc.method in BACKENDS else "exact"
        self.backend = get_backend(method)
        # the build's injected randomness, which a restore reuses
        self._injected = dict(assign=index_assign, feature_map=feature_map,
                              lsh_proj=lsh_proj)
        # audio: an exact softmax per codebook, no retrieval state
        self.state = (None if self.cfg.n_codebooks else
                      self._build(self.backend.build, params,
                                  **self._injected))
        self.index = None if self.state is None else self.state.index
        # degradation-tier states, and the digests recorded at every build,
        # swap and restore
        self._tier_states: Dict[str, BackendState] = {}
        self._digests: Dict[str, tuple] = {}
        self.index_restores = 0
        # generate's captured steps, and how many were captured
        self._graph_runners: Dict[tuple, _GraphRunner] = {}
        self.captures = 0
        # observability sink (obs.Observability.attach): index swaps and
        # restores land in the trace as instants. None = off.
        self.obs = None
        self._record_digest()
        if mesh is not None:
            self._check_ranks_agree()
        self.kernel_cfg: Dict[int, dict] = {}
        if autotune and use_kernel and self.state is not None and \
                self.device.type == "cuda":
            self.kernel_cfg = self._tune(autotune_batch)

    def _tune(self, batch: int) -> Dict[int, dict]:
        """The backend's ``tune`` at each query-tile count up to
        ``batch``'s, on the first min(batch, tiles x ``QUERY_TILE``) rows of
        a seeded (batch, d) batch of 0.1 N(0, 1) in the model's dtype, from
        a generator of its own (the decode draws stay as they were). The
        counts whose tune returns nothing are left out."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed + 0xA07)
        h = (0.1 * torch.randn((batch, self.cfg.d_model), generator=gen,
                               device=self.device)
             ).to(torch_dtype(self.cfg.dtype))
        out = {}
        for tiles in range(1, query_tiles(batch) + 1):
            q = min(batch, tiles * QUERY_TILE)
            knobs = self.backend.tune(self.state, self.cfg.partition, h[:q],
                                      generator=gen)
            if knobs:
                out[tiles] = knobs
        return out

    def knobs(self, q: int) -> dict:
        """The tuned launch knobs of a decode of ``q`` queries: those
        measured at its query-tile count, {} (the default launch) where
        none were."""
        return self.kernel_cfg.get(query_tiles(q), {})

    def _mesh_multiple(self, mesh) -> int:
        """The JAX engine's mesh checks; returns the index's block
        multiple (the model degree, 1 without a mesh)."""
        if mesh is None:
            return 1
        from ..launch.mesh import axis_size
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        for ax in ("data", "model"):
            if ax not in names:
                raise ValueError(f"serving mesh must have ('data', 'model') "
                                 f"dims, got {names}")
        m = axis_size(mesh, "model")
        if self.cfg.n_codebooks:
            raise ValueError("mesh serving does not support audio heads")
        if m > 1 and self.cfg.vocab % m:
            raise ValueError(
                f"vocab {self.cfg.vocab} must divide the model-parallel "
                f"degree {m} to shard the output embedding rows")
        return m

    def _check_ranks_agree(self) -> None:
        """Every rank of the mesh must hold the same params and index: a
        digest of each (the sum and norm of every parameter, the index's
        ``_digest``) compared across the ranks."""
        from ..launch.mesh import check_replicated
        f32 = torch.float32
        parts = [torch.stack([torch.sum(t, dtype=f32),
                              torch.linalg.vector_norm(t, dtype=f32)])
                 for t in tree_leaves(self.params) if t.is_floating_point()]
        vals = torch.cat(parts).tolist() if parts else []
        vals += list(self._digests.get(self.backend.method, ()))
        check_replicated(vals, what="params and index")

    # -- retrieval-state lifecycle ---------------------------------------------

    def _build_generator(self) -> torch.Generator:
        """A fresh generator in the state the construction-time build drew
        from."""
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def _build(self, build_fn, params, **inject) -> BackendState:
        """``build_fn`` (a backend's ``build``, or its ``refresh`` bound to
        the old state) on the head of ``params``, from a fresh build
        generator."""
        return build_fn(self.cfg.partition, self.model.head_matrix(params),
                        generator=self._build_generator(), device=self.device,
                        device_index=self.device_index,
                        block_multiple=self._block_multiple, **inject)

    def _record_digest(self) -> None:
        if self.index is not None:
            self._digests[self.backend.method] = _digest(self.index.v_blocks)

    def swap_index(self, params, *,
                   index_assign: Optional[torch.Tensor] = None,
                   feature_map: Optional[FeatureMap] = None,
                   lsh_proj: Optional[torch.Tensor] = None) -> None:
        """Swap new params in and rebuild the retrieval state from their
        output embedding (``backend.refresh``, the build's fresh generator).
        With ``device_index=True`` it raises, leaving the engine as it was,
        if any tensor's shape or dtype would change (another vocab, width or
        partition config), so whatever took the old state's tensors can take
        the new one's. ``index_assign``/``feature_map``/``lsh_proj`` inject
        the new build's randomness (parity tests); the construction-time
        assignment belongs to the old head and is never reused. An audio
        engine only takes the new params and drops its captured steps,
        which read the old params' storage."""
        if self.cfg.n_codebooks:
            self.params = params
            self._graph_runners = {}
            return
        injected = dict(assign=index_assign, feature_map=feature_map,
                        lsh_proj=lsh_proj)
        new_state = self._build(
            functools.partial(self.backend.refresh, self.state), params,
            **injected)
        if self.device_index and _shapes(new_state) != _shapes(self.state):
            raise ValueError(
                "swap_index produced a retrieval state with different "
                "shapes: the new head does not match the engine's (vocab, "
                "d_model or partition config changed?)")
        self.params = params
        self._injected = injected
        self._install(new_state)
        if self.obs is not None:
            self.obs.instant("index_swap",
                             args={"method": self.backend.method})

    def _install(self, state: BackendState) -> None:
        """A freshly built state in place of the engine's: the tier states
        and digests derive from the old one, so they go, and the new digest
        is recorded. The captured steps read the old state's tensors, so
        they go too (the next ``generate`` captures afresh)."""
        self.state = state
        self.index = state.index
        self._tier_states = {}
        self._digests = {}
        self._graph_runners = {}
        self._record_digest()

    def tier_state(self, method: str) -> BackendState:
        """The retrieval state that serves ``method`` as a degradation tier.
        Index tiers (mimps, mince, topk) reuse the engine's index; the fmbe
        tier builds only its feature map and per-block lambdas over that
        shared index; anything else builds once. Cached until the next
        swap or restore. An audio engine has no tiers."""
        if self.cfg.n_codebooks:
            raise NotImplementedError(
                f"{self.cfg.name!r} has an audio codebook head: it serves an "
                f"exact softmax per codebook and has no degradation tiers")
        if method == self.backend.method:
            return self.state
        st = self._tier_states.get(method)
        if st is None:
            st = self._build_tier_state(method)
            self._tier_states[method] = st
            if st.index is not None and method not in self._digests:
                self._digests[method] = _digest(st.index.v_blocks)
        return st

    def _build_tier_state(self, method: str) -> BackendState:
        w, idx = self.state.w, self.state.index
        if method in ("exact", "selfnorm"):
            return BackendState(w=w)
        if method in ("mimps", "mince", "topk") and idx is not None:
            return BackendState(w=w, index=idx)
        if method == "fmbe" and idx is not None:
            pc = self.cfg.partition
            fm = make_feature_map(self._build_generator(), w.shape[-1],
                                  pc.fmbe_features,
                                  max_degree=pc.fmbe_max_degree, p=pc.fmbe_p,
                                  device=self.device)
            return BackendState(w=w, index=idx,
                                fmbe=fmbe_block_state(fm, idx, w))
        return self._build(get_backend(method).build, self.params)

    def verify_and_restore(self, method: Optional[str] = None) -> bool:
        """Checksums ``method``'s index against the digest recorded when it
        was built; on a mismatch rebuilds every retrieval state from the
        params (``restore_index``) before any step reads the corruption.
        Returns True iff it restored (never for an audio engine, which has
        no index)."""
        if self.cfg.n_codebooks:
            return False
        method = method or self.backend.method
        st = self.tier_state(method)
        if st.index is None:
            return False
        ref = self._digests.get(method)
        d = _digest(st.index.v_blocks)
        if ref is None:
            self._digests[method] = d
            return False
        if d == ref:
            return False
        self.restore_index()
        return True

    def restore_index(self) -> None:
        """Rebuild the retrieval state from the current params with the
        build's fresh generator and the randomness the build was given
        (``index_assign``, ``feature_map``, ``lsh_proj``): bit-identical to
        the original build (and the decode generator untouched, so the
        tokens after a restore are the fault-free run's). An audio engine
        has nothing to rebuild."""
        if self.cfg.n_codebooks:
            return
        self._install(self._build(self.backend.build, self.params,
                                  **self._injected))
        self.index_restores += 1
        if self.obs is not None:
            self.obs.instant("index_restore",
                             args={"method": self.backend.method,
                                   "restores": self.index_restores})

    def _install_state(self, state: BackendState,
                       method: Optional[str] = None) -> None:
        """Fault-injection hook: installs a (possibly corrupted) retrieval
        state without updating its digest, as a bad swap or in-place bit
        rot would; ``verify_and_restore`` must catch it. Not a serving
        API."""
        method = method or self.backend.method
        if method == self.backend.method:
            self.state = state
            self.index = state.index
        else:
            self._tier_states[method] = state
        self._graph_runners = {}

    # -- steps ---------------------------------------------------------------

    def prefill(self, tokens: torch.Tensor,
                img: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ServeState]:
        """Full-sequence forward of tokens (B, S) (or (B, S, C)), with a
        VLM's image ``img`` (B, n_image_tokens, d), under
        ``torch.inference_mode``: (hidden of the last position (B, d), a
        fresh decode state whose next token is the last prompt token; the
        KV cache is filled decode-side, as ``generate`` replays prompts)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        with torch.inference_mode():
            hidden, _ = self.model.forward(self.params, tokens, img=img)
        state = ServeState(
            cache=self.model.init_decode_state(tokens.shape[0], self.max_len,
                                               self.device),
            pos=torch.zeros((), dtype=torch.int32, device=self.device),
            last_token=tokens[:, -1])
        return hidden[:, -1], state

    def _serving(self, tier: Optional[str] = None
                ) -> Tuple[Any, BackendState]:
        """(backend, retrieval state) that serve ``tier`` (None: the
        engine's own method)."""
        if tier is None:
            return self.backend, self.state
        return get_backend(tier), self.tier_state(tier)

    def decode_step(self, state: ServeState, temperature=0.0,
                    tail_idx: Optional[torch.Tensor] = None, *,
                    gumbel: Optional[torch.Tensor] = None,
                    tier: Optional[str] = None,
                    img: Optional[torch.Tensor] = None
                    ) -> tuple[Dict[str, torch.Tensor], ServeState]:
        """One token for every stream; returns sampling outputs + new state.
        ``state.pos`` is a device int tensor, 0-d or (B,) (per lane). A VLM
        takes its image ``img`` (B, n_image_tokens, d) at every step.

        Cache-capacity guard: outside a CUDA graph capture a position past
        ``max_len`` raises (one host read): the KV write would clobber.
        Under capture the position is clamped to the last slot and
        ``out["overflow"]`` (a device bool, per lane for (B,) positions)
        flags the step, as the JAX step flags a traced position; callers
        that loop bound their step counts so it never fires."""
        pos = state.pos
        if not _capturing(self.device) and int(pos.max()) >= self.max_len:
            raise ValueError(
                f"decode position {int(pos.max())} is past the KV-cache "
                f"capacity max_len={self.max_len}; the write would "
                f"wrap/clobber earlier positions")
        overflow = pos >= self.max_len
        pos_safe = torch.clamp(pos, max=self.max_len - 1)
        h = self.model.decode_step(self.params, state.cache,
                                   state.last_token, pos_safe, img=img)
        out = self.next_token_distribution(h, temperature, tail_idx=tail_idx,
                                           gumbel=gumbel, tier=tier)
        out["overflow"] = overflow
        return out, ServeState(cache=state.cache, pos=state.pos + 1,
                               last_token=out["token"])

    def next_token_distribution(self, h: torch.Tensor, temperature=0.0, *,
                                tail_idx: Optional[torch.Tensor] = None,
                                gumbel: Optional[torch.Tensor] = None,
                                tier: Optional[str] = None
                                ) -> Dict[str, torch.Tensor]:
        """Sample one token per stream: greedy at temperature 0, else
        Gumbel-max over the retrieved candidates; the reported probability
        is normalised by the estimated log Ẑ. ``tier`` serves another
        method on ``tier_state(tier)`` (the degradation ladder).

        ``temperature`` is data: a Python float, or a 0-d f32 tensor on the
        device, which needs ``gumbel``, the (Q, sample_k) noise of the step
        (``generate`` fills it ahead). With a float and no ``gumbel`` the
        noise is drawn from the engine's generator after the decode (none at
        temperature 0), as are the tail samples without ``tail_idx``. An
        audio head takes (B, C, V) noise (``_codebook_distribution``)."""
        if self.cfg.n_codebooks:
            return self._codebook_distribution(h, temperature, gumbel)
        pc = self.cfg.partition
        backend, st = self._serving(tier)
        kernel_cfg = self.knobs(h.shape[0]) if backend is self.backend \
            else {}
        out = backend.decode(st, h, pc, k=pc.sample_k,
                             use_kernel=self.use_kernel,
                             generator=self.generator, tail_idx=tail_idx,
                             **kernel_cfg)
        if self.health_guard:
            out, _ = apply_health_guard(out, st.w, h, pc.sample_k,
                                        use_kernel=self.use_kernel)
        temperature, gumbel = _noise_for(temperature, gumbel,
                                         out.top_score.shape, self.generator,
                                         h.device)
        return _sample_candidates(out, temperature, gumbel)

    def _codebook_distribution(self, h: torch.Tensor, temperature,
                               gumbel: Optional[torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
        """The audio head (the JAX engine's ``n_codebooks`` branch): the
        (B, C, V) logits of every codebook in the config dtype, log Z the
        logsumexp over V of each in that dtype (``jax.nn.logsumexp``'s
        steps: the max, the sum of exp(logits - max), its log plus the
        max), the token greedy at temperature 0, else the argmax of
        logits / T + g over all V (in f32); log_prob = the token's logit -
        log Z in the config dtype. Every output is (B, C); log_prob and
        log Z are returned in f32, as the output buffers hold them."""
        w = self.model.head_matrix(self.params)
        logits = torch.einsum("bd,cvd->bcv", h, w)
        amax = logits.amax(-1)
        amax = torch.where(torch.isfinite(amax), amax,
                           torch.zeros_like(amax))
        log_z = torch.log((logits - amax[..., None]).exp().sum(-1)) + amax
        temperature, gumbel = _noise_for(temperature, gumbel, logits.shape,
                                         self.generator, h.device)
        hot = temperature > 0.0
        safe_t = torch.where(hot, temperature, torch.ones_like(temperature))
        tok = torch.where(hot,
                          torch.argmax(logits.float() / safe_t + gumbel, -1),
                          torch.argmax(logits, -1))
        top = torch.gather(logits, -1, tok[..., None])[..., 0]
        return {"token": tok, "log_prob": (top - log_z).float(),
                "log_z": log_z.float()}


def _noise_for(temperature, gumbel: Optional[torch.Tensor], shape,
               generator: torch.Generator, device):
    """(temperature as a 0-d f32 tensor, the step's noise): ``gumbel`` as
    given, or, with a float temperature and none given, drawn from
    ``generator`` (zeros at temperature 0)."""
    if isinstance(temperature, torch.Tensor):
        if gumbel is None:
            raise ValueError("a temperature tensor needs its gumbel noise "
                             "(gumbel=)")
        return temperature, gumbel
    if gumbel is None:
        gumbel = (_draw_gumbel(shape, generator, device)
                  if temperature > 0.0 else
                  torch.zeros(shape, dtype=torch.float32, device=device))
    return (torch.tensor(float(temperature), dtype=torch.float32,
                         device=device), gumbel)


def _draw_gumbel(shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` (f32) from ``generator``."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -torch.log(e.exponential_(generator=generator).clamp_min(1e-30))


def _sample_candidates(out: DecodeOut, temperature: torch.Tensor,
                       gumbel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gumbel-max over retrieved candidates: token ~ softmax(s/T) restricted
    to the head (filler candidates at NEG are never drawn). log_prob is the
    T=1 probability of the chosen token, normalised with the estimated
    log Ẑ. ``temperature`` is a 0-d f32 tensor: both picks are made and
    one is chosen with ``torch.where``, so one captured step serves every
    temperature. At temperature 0 the pick is candidate 0, the top
    score."""
    hot = temperature > 0.0
    safe_t = torch.where(hot, temperature, torch.ones_like(temperature))
    drawn = torch.argmax(out.top_score / safe_t + gumbel, dim=-1)
    pick = torch.where(hot, drawn, torch.zeros_like(drawn))
    tok = torch.gather(out.top_id, 1, pick[:, None])[:, 0]
    score = torch.gather(out.top_score, 1, pick[:, None])[:, 0]
    return {"token": tok.long(), "log_prob": score - out.log_z,
            "log_z": out.log_z}


def _step_draws(engine: Engine, backend, state: BackendState, batch: int,
                total: int, t_replay: int, temperature: float,
                tail_source: Optional[Callable[[int], Any]],
                generator: Optional[torch.Generator] = None):
    """The randomness of ``total`` decode steps, drawn ahead (the
    counterpart of the JAX engine's pre-split per-step keys): (tails
    (total, l) int64 or None where the decode samples no tail, gumbel
    (total, batch, sample_k) f32, or (total, batch, C, V) for an audio
    head, zeros at temperature 0). Step ``s`` draws
    its tail (from ``tail_source(step_id)``, ``step_id`` ``s`` for a replay
    step and ``10_000 + t`` for generation step ``t``, or from the engine's
    generator), then its noise: the order a step drawing its own would
    take. ``generator`` draws the noise instead of the engine's (one
    (batch, sample_k) call a step, as the slot scheduler draws a request's
    noise at admission)."""
    pc = engine.cfg.partition
    noise_gen = engine.generator if generator is None else generator
    dev = engine.device
    tails, noise = [], []
    has_tail = _has_tail(backend, state)
    shape = _noise_shape(engine.cfg, batch)
    for s in range(total):
        if has_tail:
            if tail_source is not None:
                step_id = s if s < t_replay else 10_000 + s - t_replay
                tail = torch.as_tensor(tail_source(step_id), device=dev)
            else:
                tail = backend.draw_tail(state, pc, engine.generator)
            tails.append(tail.long())
        noise.append(_draw_gumbel(shape, noise_gen, dev)
                     if temperature > 0.0 else
                     torch.zeros(shape, dtype=torch.float32, device=dev))
    return (torch.stack(tails) if has_tail else None), torch.stack(noise)


def _has_tail(backend, state: Optional[BackendState]) -> bool:
    return state is not None and backend.has_tail(state)


def _noise_shape(cfg, batch: int) -> tuple:
    """One step's Gumbel noise: (batch, sample_k) over the retrieved
    candidates, or (batch, C, V) over every row of an audio head."""
    if cfg.n_codebooks:
        return (batch, cfg.n_codebooks, cfg.vocab)
    return (batch, cfg.partition.sample_k)


class _GraphRunner:
    """The decode step of one (engine, batch, tier), as ``generate``
    replays it (the counterpart of the JAX ``_scan_runner``).

    It owns its decode state and device buffers: the step index, the
    position, the last token, the prompt step-major with a replay flag a
    step (a replay step force-feeds its prompt token with
    ``torch.where``), the temperature, the per-step tail draws and Gumbel
    noise, and the per-step outputs, each ``max_len`` steps long; for a
    VLM also the image (B, n_image_tokens, d) in the model's dtype, which
    the graph reads as the JAX ``_scan_runner`` takes its traced ``img``,
    so a new image is a copy into it and no capture again. The step
    reads its inputs at the step index and advances the index, the
    position and the last token itself, so on a GPU it is captured once
    in a CUDA graph and replayed once a step, for every prompt length,
    ``n_tokens`` and temperature; on the CPU it runs eagerly. The launches
    its capture counted are added to the kernels' counts at every replay.
    It keeps no reference to its engine (which caches it), so dropping
    the engine frees the graph."""

    def __init__(self, engine: Engine, batch: int, tier: Optional[str]):
        self.tier = tier
        cfg = engine.cfg
        dev, n = engine.device, engine.max_len
        backend, state = engine._serving(tier)
        i64 = dict(dtype=torch.long, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        # a lane's token: (), or (C,) with codebooks
        lane = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        self.cache = engine.model.init_decode_state(batch, n, dev)
        self.step = torch.zeros((), **i64)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.last = torch.zeros((batch,) + lane, **i64)
        self.prompt = torch.zeros((n, batch) + lane, **i64)
        self.replay_flag = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.temperature = torch.zeros((), **f32)
        self.gumbel = torch.zeros((n,) + _noise_shape(cfg, batch), **f32)
        self.tails = (torch.zeros((n, cfg.partition.l), **i64)
                      if _has_tail(backend, state) else None)
        self.outs = {name: torch.zeros((n, batch) + lane, **kind)
                     for name, kind in (("token", i64), ("log_prob", f32),
                                        ("log_z", f32))}
        self.img = (torch.zeros((batch, cfg.n_image_tokens, cfg.d_model),
                                dtype=torch_dtype(cfg.dtype), device=dev)
                    if cfg.family == "vlm" else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: dict = {}

    def load(self, prompt: torch.Tensor, tails: Optional[torch.Tensor],
             gumbel: torch.Tensor, temperature: float,
             img: Optional[torch.Tensor] = None) -> None:
        """Reset the step for a new request batch: step 0, position 0,
        every leaf of the decode state zeroed (KV and recurrent), and the
        prompt, draws and temperature in place; a VLM's image ``img``, when
        given, copied into the image buffer (else the buffer keeps the
        last one)."""
        t_replay, total = prompt.shape[1], gumbel.shape[0]
        self.step.zero_()
        self.pos.zero_()
        for buf in tree_leaves(self.cache):
            buf.zero_()
        self.prompt[:t_replay].copy_(prompt.transpose(0, 1))
        self.replay_flag.copy_(torch.arange(self.replay_flag.shape[0],
                                            device=prompt.device) < t_replay)
        self.last.copy_(prompt[:, 0])
        self.temperature.fill_(float(temperature))
        self.gumbel[:total].copy_(gumbel)
        if self.tails is not None:
            self.tails[:total].copy_(tails)
        if img is not None:
            self.img.copy_(img)

    def run_step(self, engine: Engine) -> None:
        """One decode step from the buffers: no host read and no draw."""
        t = self.step.view(1)
        tok = self.prompt.index_select(0, t)[0]
        last = torch.where(self.replay_flag.index_select(0, t), tok,
                           self.last)
        tail = (None if self.tails is None
                else self.tails.index_select(0, t)[0])
        state = ServeState(cache=self.cache, pos=self.pos, last_token=last)
        out, new = engine.decode_step(
            state, self.temperature, tail_idx=tail,
            gumbel=self.gumbel.index_select(0, t)[0], tier=self.tier,
            img=self.img)
        for name, buf in self.outs.items():
            buf.index_copy_(0, t, out[name][None].to(buf.dtype))
        self.last.copy_(out["token"])
        self.pos.copy_(new.pos)
        self.step.add_(1)

    def capture(self, engine: Engine) -> None:
        """Warm the step up once on a side stream (the kernels' first-use
        build and load, any tier state's build), then capture one step in a
        CUDA graph. A capture that fails raises: nothing falls back to the
        eager step. Leaves the buffers to ``load``."""
        side = torch.cuda.Stream(engine.device)
        side.wait_stream(torch.cuda.current_stream(engine.device))
        with torch.cuda.stream(side):
            self.run_step(engine)
        torch.cuda.current_stream(engine.device).wait_stream(side)
        before = _build.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.run_step(engine)
        self.counts = _build.counts_since(before)
        _build.restore(before)           # a capture launches nothing
        self.graph = graph
        engine.captures += 1

    def replay(self, engine: Engine) -> None:
        if self.graph is None:
            self.run_step(engine)
        else:
            self.graph.replay()
            _build.add_counts(self.counts)


def _graph_runner(engine: Engine, batch: int,
                  tier: Optional[str]) -> _GraphRunner:
    """Fetch (or make) the engine's runner for (batch, tier, the cache
    dtype), also keyed by what the step reads at capture besides tensors
    (the backend object, the guard, the kernel choice). One runner serves
    every prompt length and ``n_tokens``: the JAX package buckets replay
    lengths to powers of two because a scan's length is static; a replayed
    step has no length, so nothing here corresponds to that bucket. The
    engine drops its runners when its state's tensors change."""
    key = (batch, tier, engine.cfg.dtype, engine.backend,
           engine.health_guard, engine.use_kernel)
    run = engine._graph_runners.get(key)
    if run is None:
        run = engine._graph_runners[key] = _GraphRunner(engine, batch, tier)
    return run


def generate(engine: Engine, prompt, n_tokens: int, *,
             temperature: float = 0.0,
             tail_source: Optional[Callable[[int], Any]] = None,
             return_aux: bool = False, tier: Optional[str] = None,
             host_loop: bool = False,
             generator: Optional[torch.Generator] = None,
             img: Optional[torch.Tensor] = None):
    """Generation loop; returns (B, n_tokens) token ids on the engine's
    device. The prompt is replayed through the decode cache one step per
    token, and the last replay step emits the first sample. A VLM needs
    its image ``img`` (B, n_image_tokens, d), which every step reads; the
    captured step reads it from its runner's buffer, so a new image runs on
    the same graph.

    On a GPU every step is one replay of the engine's captured decode step
    (``_GraphRunner``); on the CPU the same step runs eagerly.
    An audio prompt is (B, S, C) and gives (B, n_tokens, C).
    ``host_loop=True`` is the eager per-step loop over
    ``Engine.decode_step`` (the JAX ``_generate_host``); both read the same
    draws and give the same bits. A GPU engine built with
    ``use_kernel=False`` serves only through ``host_loop=True``: its plain
    branches read the host.

    ``tail_source(step_id)`` optionally supplies the tail sample indices of
    each step, where ``step_id`` is ``t`` for replay step ``t`` and
    ``10_000 + t`` for generation step ``t`` (the JAX engine's key
    schedule); without it the engine's generator draws them, ahead of the
    steps, as it draws the Gumbel noise at a temperature above 0. ``tier``
    serves another method on the engine's ``tier_state``. ``generator``
    (the counterpart of the JAX ``generate``'s key) draws the Gumbel noise
    instead of the engine's generator, so a request served by the slot
    scheduler with the same seeded generator gives the same tokens; the
    tails still come from ``tail_source`` or the engine's generator."""
    prompt = torch.as_tensor(prompt, device=engine.device).long()
    if prompt.shape[1] == 0:
        raise ValueError(
            "generate() needs a non-empty prompt: the first sample is "
            "emitted by the last prompt-replay step")
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    # checked here: the captured step reads the runner's image buffer
    _check_img(engine.cfg, img)
    if img is not None:
        img = img.to(device=engine.device,
                     dtype=torch_dtype(engine.cfg.dtype))
    t_replay = prompt.shape[1]
    if t_replay + n_tokens - 1 > engine.max_len:
        raise ValueError(
            f"prompt length {t_replay} + {n_tokens} generated tokens needs "
            f"{t_replay + n_tokens - 1} cache positions but the engine was "
            f"built with max_len={engine.max_len}")
    on_gpu = engine.device.type == "cuda"
    if on_gpu and not engine.use_kernel and not host_loop:
        raise ValueError(
            "a GPU engine with use_kernel=False cannot be captured (its "
            "plain decode branches read the host): pass host_loop=True")
    batch, total = prompt.shape[0], t_replay + n_tokens - 1
    backend, state = engine._serving(tier)
    tails, gumbel = _step_draws(engine, backend, state, batch, total,
                                t_replay, temperature, tail_source,
                                generator)
    if host_loop:
        outs = _generate_host(engine, prompt, tails, gumbel, temperature,
                              tier, img)
    else:
        run = _graph_runner(engine, batch, tier)
        if on_gpu and run.graph is None:
            run.capture(engine)
        run.load(prompt, tails, gumbel, temperature, img)
        for _ in range(total):
            run.replay(engine)
        outs = {name: buf[t_replay - 1:total].transpose(0, 1).clone()
                for name, buf in run.outs.items()}
    if return_aux:
        return outs["token"], {"log_prob": outs["log_prob"],
                               "log_z": outs["log_z"]}
    return outs["token"]


def _generate_host(engine: Engine, prompt: torch.Tensor,
                   tails: Optional[torch.Tensor], gumbel: torch.Tensor,
                   temperature: float, tier: Optional[str],
                   img: Optional[torch.Tensor] = None):
    """The eager loop: one ``Engine.decode_step`` a step on the same draws
    as the captured step. Returns the emitted steps' outputs (B, n_tokens)
    (or (B, n_tokens, C)) by name."""
    t_replay, total = prompt.shape[1], gumbel.shape[0]
    temp = torch.tensor(float(temperature), dtype=torch.float32,
                        device=engine.device)
    state = ServeState(
        cache=engine.model.init_decode_state(prompt.shape[0],
                                             engine.max_len, engine.device),
        pos=torch.zeros((), dtype=torch.int32, device=engine.device),
        last_token=prompt[:, 0])
    outs = []
    for s in range(total):
        if s < t_replay:
            state = dataclasses.replace(state, last_token=prompt[:, s])
        out, state = engine.decode_step(
            state, temp, tail_idx=None if tails is None else tails[s],
            gumbel=gumbel[s], tier=tier, img=img)
        if s >= t_replay - 1:
            outs.append(out)
    return {name: torch.stack([o[name] for o in outs], dim=1)
            for name in ("token", "log_prob", "log_z")}
