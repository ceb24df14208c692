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
from ..models import Model

# blocks of the index the digest reads at a time (64 blocks of 512 x 2560
# f32: 336 MB)
_DIGEST_BLOCKS = 64


@dataclasses.dataclass
class ServeState:
    cache: Any                   # KV cache dict, updated in place
    pos: int                     # next position to write
    last_token: torch.Tensor     # (B,)


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
    exact pass (``core.decode.apply_health_guard``)."""

    def __init__(self, model: Model, params, max_len: int, *, seed: int = 0,
                 use_kernel: bool = True, device="cuda",
                 device_index: bool = False, health_guard: bool = False,
                 index_assign: Optional[torch.Tensor] = None,
                 feature_map: Optional[FeatureMap] = None,
                 lsh_proj: Optional[torch.Tensor] = None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
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
        self.state = self._build(self.backend.build, params,
                                 assign=index_assign, feature_map=feature_map,
                                 lsh_proj=lsh_proj)
        self.index = self.state.index
        # degradation-tier states, and the digests recorded at every build,
        # swap and restore
        self._tier_states: Dict[str, BackendState] = {}
        self._digests: Dict[str, tuple] = {}
        self.index_restores = 0
        self._record_digest()

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
                        device_index=self.device_index, **inject)

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
        assignment belongs to the old head and is never reused."""
        new_state = self._build(
            functools.partial(self.backend.refresh, self.state), params,
            assign=index_assign, feature_map=feature_map, lsh_proj=lsh_proj)
        if self.device_index and _shapes(new_state) != _shapes(self.state):
            raise ValueError(
                "swap_index produced a retrieval state with different "
                "shapes: the new head does not match the engine's (vocab, "
                "d_model or partition config changed?)")
        self.params = params
        self._install(new_state)

    def _install(self, state: BackendState) -> None:
        """A freshly built state in place of the engine's: the tier states
        and digests derive from the old one, so they go, and the new digest
        is recorded."""
        self.state = state
        self.index = state.index
        self._tier_states = {}
        self._digests = {}
        self._record_digest()

    def tier_state(self, method: str) -> BackendState:
        """The retrieval state that serves ``method`` as a degradation tier.
        Index tiers (mimps, mince, topk) reuse the engine's index; the fmbe
        tier builds only its feature map and per-block lambdas over that
        shared index; anything else builds once. Cached until the next
        swap or restore."""
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
        Returns True iff it restored."""
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
        build's fresh generator: bit-identical to the original build (and
        the decode generator untouched, so the tokens after a restore are
        the fault-free run's)."""
        self._install(self._build(self.backend.build, self.params))
        self.index_restores += 1

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

    # -- steps ---------------------------------------------------------------

    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, ServeState]:
        """Full-sequence forward of tokens (B, S) under
        ``torch.inference_mode``: (hidden of the last position (B, d), a
        fresh decode state whose next token is the last prompt token; the
        KV cache is filled decode-side, as ``generate`` replays prompts)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        with torch.inference_mode():
            hidden, _ = self.model.forward(self.params, tokens)
        state = ServeState(
            cache=self.model.init_decode_state(tokens.shape[0], self.max_len,
                                               self.device),
            pos=0, last_token=tokens[:, -1])
        return hidden[:, -1], state

    def decode_step(self, state: ServeState, temperature: float = 0.0,
                    tail_idx: Optional[torch.Tensor] = None, *,
                    tier: Optional[str] = None
                    ) -> tuple[Dict[str, torch.Tensor], ServeState]:
        """One token for every stream; returns sampling outputs + new state.
        A position past ``max_len`` raises: the KV write would clobber.
        ``out["overflow"]`` (a device bool) is the JAX step's flag for a
        traced position past capacity; a host position never sets it."""
        if state.pos >= self.max_len:
            raise ValueError(
                f"decode position {state.pos} is past the KV-cache capacity "
                f"max_len={self.max_len}; the write would wrap/clobber "
                f"earlier positions")
        h = self.model.decode_step(self.params, state.cache,
                                   state.last_token, state.pos)
        out = self.next_token_distribution(h, temperature, tail_idx=tail_idx,
                                           tier=tier)
        out["overflow"] = torch.full((), state.pos >= self.max_len,
                                     dtype=torch.bool, device=self.device)
        return out, ServeState(cache=state.cache, pos=state.pos + 1,
                               last_token=out["token"])

    def next_token_distribution(self, h: torch.Tensor,
                                temperature: float = 0.0, *,
                                tail_idx: Optional[torch.Tensor] = None,
                                tier: Optional[str] = None
                                ) -> Dict[str, torch.Tensor]:
        """Sample one token per stream: greedy at temperature 0, else
        Gumbel-max over the retrieved candidates; the reported probability
        is normalised by the estimated log Ẑ. ``tier`` serves another
        method on ``tier_state(tier)`` (the degradation ladder)."""
        pc = self.cfg.partition
        backend, st = self.backend, self.state
        if tier is not None:
            backend, st = get_backend(tier), self.tier_state(tier)
        out = backend.decode(st, h, pc, k=pc.sample_k,
                             use_kernel=self.use_kernel,
                             generator=self.generator, tail_idx=tail_idx)
        if self.health_guard:
            out, _ = apply_health_guard(out, st.w, h, pc.sample_k,
                                        use_kernel=self.use_kernel)
        return _sample_candidates(out, temperature, self.generator)


def _sample_candidates(out: DecodeOut, temperature: float,
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Gumbel-max over retrieved candidates: token ~ softmax(s/T) restricted
    to the head (filler candidates at NEG are never drawn). log_prob is the
    T=1 probability of the chosen token, normalised with the estimated
    log Ẑ. At temperature 0 the pick is candidate 0, the top score."""
    q = out.top_score.shape[0]
    if temperature > 0.0:
        e = torch.empty(out.top_score.shape, dtype=torch.float32,
                        device=out.top_score.device)
        gumbel = -torch.log(e.exponential_(generator=generator)
                            .clamp_min(1e-30))
        pick = torch.argmax(out.top_score / temperature + gumbel, dim=-1)
    else:
        pick = torch.zeros((q,), dtype=torch.long,
                           device=out.top_score.device)
    tok = torch.gather(out.top_id, 1, pick[:, None])[:, 0]
    score = torch.gather(out.top_score, 1, pick[:, None])[:, 0]
    return {"token": tok.long(), "log_prob": score - out.log_z,
            "log_z": out.log_z}


def generate(engine: Engine, prompt, n_tokens: int, *,
             temperature: float = 0.0,
             tail_source: Optional[Callable[[int], Any]] = None,
             return_aux: bool = False, tier: Optional[str] = None):
    """Generation loop; returns (B, n_tokens) token ids on the engine's
    device. The prompt is replayed through the decode cache one step per
    token, and the last replay step emits the first sample.

    ``tail_source(step_id)`` optionally supplies the tail sample indices of
    each step, where ``step_id`` is ``t`` for replay step ``t`` and
    ``10_000 + t`` for generation step ``t`` (the JAX engine's key
    schedule); without it the engine's generator draws them. ``tier``
    serves another method on the engine's ``tier_state``."""
    prompt = torch.as_tensor(prompt, device=engine.device).long()
    if prompt.shape[1] == 0:
        raise ValueError(
            "generate() needs a non-empty prompt: the first sample is "
            "emitted by the last prompt-replay step")
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    t_replay = prompt.shape[1]
    if t_replay + n_tokens - 1 > engine.max_len:
        raise ValueError(
            f"prompt length {t_replay} + {n_tokens} generated tokens needs "
            f"{t_replay + n_tokens - 1} cache positions but the engine was "
            f"built with max_len={engine.max_len}")

    def tail(step_id):
        if tail_source is None:
            return None
        return torch.as_tensor(tail_source(step_id), device=engine.device)

    batch = prompt.shape[0]
    state = ServeState(
        cache=engine.model.init_decode_state(batch, engine.max_len,
                                             engine.device),
        pos=0, last_token=prompt[:, 0])
    outs = []
    out = None
    for t in range(t_replay):
        state = dataclasses.replace(state, last_token=prompt[:, t])
        out, state = engine.decode_step(state, temperature, tail_idx=tail(t),
                                        tier=tier)
    outs.append(out)
    for t in range(n_tokens - 1):
        out, state = engine.decode_step(state, temperature,
                                        tail_idx=tail(10_000 + t), tier=tier)
        outs.append(out)
    toks = torch.stack([o["token"] for o in outs], dim=1)
    if return_aux:
        return toks, {
            "log_prob": torch.stack([o["log_prob"] for o in outs], dim=1),
            "log_z": torch.stack([o["log_z"] for o in outs], dim=1)}
    return toks
