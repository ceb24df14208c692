"""Config dataclasses for the framework.

Every assigned architecture is expressed as a ``ModelConfig``; the paper's
technique is configured via ``PartitionConfig`` and is a first-class field of
the model config (it parameterizes the output layer / serving path).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Configuration of the sublinear partition estimator (the paper's core).

    method:
      exact    - brute force Z (baseline; also the fused-kernel path)
      mimps    - Eq.5: head via MIPS + uniform tail correction (paper's winner)
      nmimps   - Eq.4: head only (shown inadequate in the paper)
      uniform  - k=0 special case (importance sampling baseline)
      mince    - Eq.6/7: NCE-for-Z with Halley's method
      fmbe     - Eq.8/10: Kar-Karnick random feature maps
      selfnorm - assume Z == 1 (Devlin/NCE-clamped heuristic, paper SS5.2)
      topk     - Eq.4 head-only (nmimps at the output layer): cheapest
                 retrieval tier — no tail sampling, log Ẑ from the probed
                 head alone. Biased low (the paper shows Eq.4 inadequate as
                 an *estimator*), kept as the last rung of the serving
                 degradation ladder where finishing requests beats
                 calibrated log Ẑ.
      lsh      - Eq.5 head/tail combine over a SimHash collision head
                 (Spring & Shrivastava 2017): fixed random hyperplanes, O(1)
                 per-row index updates, no centroid maintenance (core.lsh).
    """
    method: str = "exact"
    k: int = 100                  # head size |S_k(q)|
    l: int = 100                  # tail sample size |U_l|
    sample_k: int = 8             # head candidates kept for temperature
                                  # sampling (Gumbel-max over the retrieved
                                  # top-sample_k; greedy decode retrieves 1)
    # IVF (TPU-native MIPS) parameters
    n_clusters: int = 256
    n_probe: int = 8
    block_rows: int = 512         # vocab rows per Pallas block (cluster pad)
    head_cap: int = 0             # static union capacity of the XLA decode
                                  # paths (blocks); 0 = auto (n_probe plus
                                  # overlap headroom, decode._resolve_head_cap).
                                  # Shared-context decode batches dedup to
                                  # U ~ n_probe, so the trimmed gather is the
                                  # common case; overflow falls back to the
                                  # full min(Q*n_probe, n_blocks) trace
                                  # (slower, never wrong).
    # FMBE parameters
    fmbe_features: int = 4096     # P
    fmbe_max_degree: int = 8      # cap on M ~ Geometric(1/p)
    fmbe_p: float = 2.0
    # LSH (SimHash/ALSH-MIPS) parameters — the second retrieval structure
    lsh_bits: int = 8             # K sign bits per table (<= 24: packed
                                  # codes stay f32-exact for the kernel's
                                  # matmul packing)
    lsh_tables: int = 8           # L independent hash tables
    lsh_bucket_cap: int = 0       # rows per bucket (static shape); 0 = auto
                                  # (4x the uniform-hash mean, lsh.lsh_bucket_cap)
    lsh_mips_scale: float = 0.0   # MIPS norm cap M = scale * max|w|: rows
                                  # heavier than M hash by pure angle,
                                  # lighter rows sink toward the tail;
                                  # 0 = angle-only SimHash everywhere
    lsh_tail_beta: float = 8.0    # norm-tempered tail proposal
                                  # p_r ∝ exp(beta * |w_r|/max|w|);
                                  # 0 = uniform tail
    # MINCE solver
    mince_iters: int = 2          # iterations of the general bracketed
                                  # Halley solvers (oracle weighting='paper'
                                  # and the sharded stats solve); the
                                  # single-node anchored serving estimate is
                                  # closed-form — its root IS the Eq.5
                                  # anchor (mince.anchored_solve) — so it
                                  # needs none. The seed's 25 dated from the
                                  # unbracketed cold-start solver
    mince_solver: str = "halley"  # or "newton"

    def validate(self) -> None:
        assert self.method in (
            "exact", "mimps", "nmimps", "uniform", "mince", "fmbe",
            "selfnorm", "topk", "lsh")
        assert self.k >= 0 and self.l >= 0
        assert self.sample_k >= 1
        assert 1 <= self.lsh_bits <= 24 and self.lsh_tables >= 1


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Overload policy for ``serve.Server`` (DESIGN.md SS14).

    Every knob is in **virtual steps** (the server's deterministic clock),
    so the same trace degrades/sheds identically on any machine. Defaults
    keep every mechanism off — a Server without a ServingConfig behaves
    exactly like the PR-4 unbounded-queue loop.
    """
    max_queue: int = 0            # admission-queue bound; arrivals past it
                                  # are shed as errored completions with
                                  # reason 'queue_full' (0 = unbounded)
    default_deadline: int = 0     # deadline (virtual steps from submission)
                                  # stamped on requests that carry none
                                  # (0 = no default; requests may still set
                                  # their own Request.deadline)
    # estimator-tier graceful degradation: under sustained queue pressure
    # the server walks DOWN the ladder (cheaper tiers keep lanes moving),
    # and restores UP with hysteresis once pressure drops. () = the
    # method's default ladder (serve.server.default_ladder).
    degrade_ladder: Tuple[str, ...] = ()
    degrade_high: int = 0         # queue depth that counts as pressure
                                  # (0 = degradation disabled)
    degrade_low: int = 0          # queue depth that counts as calm
    degrade_after: int = 3        # consecutive pressured steps -> step down
    restore_after: int = 8        # consecutive calm steps -> step up
                                  # (> degrade_after: the hysteresis band)
    # estimator health: when True the compiled step routes queries whose
    # estimate is unhealthy (non-finite log Ẑ / empty probe union /
    # non-finite candidate scores) through the exact fused fallback under
    # lax.cond — no NaN ever reaches sampling.
    health_guard: bool = True
    # retrieval-state integrity: every N scheduler steps the engine's
    # current-tier state is checksummed against the digest recorded at
    # build/swap time; a mismatch (bit-rotted or bad-swap index) rebuilds
    # the state from params BEFORE the step consumes it. The digest pass
    # reads the whole index (O(V d)), so this is a chaos-test / low-cadence
    # production knob, not a per-step default (0 = off).
    verify_index_every: int = 0
    # admission lookahead: on a mesh with the prefix cache, the server may
    # HOLD up to admit_window queued requests whose cached blocks live on a
    # full data replica, force-admitting one after admit_hold holds. The
    # port serves one replica, so its Server refuses admit_window > 0;
    # 0 = strict FIFO.
    admit_window: int = 0
    admit_hold: int = 8

    def validate(self) -> None:
        assert self.max_queue >= 0 and self.default_deadline >= 0
        assert self.degrade_high >= self.degrade_low >= 0
        assert self.degrade_after >= 1 and self.restore_after >= 1
        assert self.verify_index_every >= 0
        assert self.admit_window >= 0 and self.admit_hold >= 1


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability layer (``obs``, DESIGN.md SS17).

    Cadences are in **scheduler steps**. Everything here is host policy:
    the device-resident metric state is threaded through the compiled step
    unconditionally (same executable with observability on or off — that is
    what keeps tokens bit-identical), and this config only decides how often
    the host harvests it and where the results go. Defaults give live
    metrics with shadow sampling at 1/16 steps and no file/network sinks.
    """
    metrics: bool = True          # harvest device metrics into the registry
    harvest_every: int = 16       # steps between device->host metric reads
                                  # (the only readback observability adds;
                                  # the per-step outs readback already
                                  # exists for token streaming)
    shadow_every: int = 16        # steps between shadow-sampled exact log-Z
                                  # passes (0 = off). The pass runs under
                                  # lax.cond inside the SAME executable; the
                                  # cadence flag is traced data
    trace_path: str = ""          # per-request span trace (Chrome-trace
                                  # JSONL); "" = tracing off
    metrics_port: int = 0         # Prometheus text exposition on
                                  # 127.0.0.1:port (0 = no HTTP server)
    snapshot_path: str = ""       # periodic JSON metric snapshots ("" = off)
    snapshot_every: int = 4       # snapshots are written every N harvests

    def validate(self) -> None:
        assert self.harvest_every >= 1
        assert self.shadow_every >= 0
        assert self.snapshot_every >= 1
        assert 0 <= self.metrics_port < 65536


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    n_shared: int = 2
    top_k: int = 6
    expert_d_ff: int = 1408
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) / RWKV6 parameters."""
    state_dim: int = 64
    conv_dim: int = 4
    n_ssm_heads: int = 0          # 0 -> derived
    expand: int = 2
    wkv_head_size: int = 64       # RWKV6


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 3072
    vocab: int = 32000
    max_seq_len: int = 131072
    act: str = "silu"             # silu | gelu | sqrelu
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # sliding-window / local:global attention (gemma3)
    sliding_window: int = 0       # 0 -> full attention
    local_global_ratio: int = 0   # e.g. 5 -> every 6th layer is global
    # VLM cross attention
    cross_attn_every: int = 0     # e.g. 5 -> layers 4,9,... are cross-attn
    n_image_tokens: int = 1601
    # audio (musicgen)
    n_codebooks: int = 0          # >0 -> audio token streams w/ delay pattern
    # hybrid (zamba2): shared attention block every `shared_attn_every` layers
    shared_attn_every: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    partition: PartitionConfig = dataclasses.field(default_factory=PartitionConfig)
    # remat policy for the scanned blocks: 'none' | 'full' | 'dots'
    remat: str = "full"
    dtype: str = "bfloat16"
    # which attention impl decode uses; long-context capability flag
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline checks)."""
        d, L, v = self.d_model, self.n_layers, self.vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.act == "sqrelu":
            mlp = 2 * d * self.d_ff
        else:
            mlp = 3 * d * self.d_ff
        if self.family in ("moe",) and self.moe is not None:
            m = self.moe
            e_ff = m.expert_d_ff
            mlp = (m.n_experts + m.n_shared) * 3 * d * e_ff + d * m.n_experts
        if self.family == "ssm":   # rwkv6: time-mix + channel-mix
            s = self.ssm or SSMConfig()
            attn = 5 * d * d + 2 * d * (32 * 5) + d * d  # r,k,v,g,o + lora decay
            mlp = 2 * d * self.d_ff + d * d
        per_layer = attn + mlp + 2 * d
        total = emb + L * per_layer
        if self.shared_attn_every:
            total += attn + mlp  # one shared block
        if self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            total += n_cross * (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                                + self.n_heads * hd * d)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE-aware) for 6*N_active*D FLOPs."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        m = self.moe
        dense_like = self.param_count()
        all_experts = m.n_experts * 3 * d * m.expert_d_ff * L
        active_experts = m.top_k * 3 * d * m.expert_d_ff * L
        return int(dense_like - all_experts + active_experts)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned (input-shape) cell: seq_len x global_batch + step kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # 'train' | 'prefill' | 'decode'


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1         # gradient accumulation
    loss: str = "fused_ce"        # any key of train.losses.LOSSES (fused_ce,
                                  # ce, nce, selfnorm, sampled, mimps_ce,
                                  # mince_ce)
    nce_noise: int = 64
    # estimator-backed losses: IVF index maintenance cadence (steps between
    # recluster/repack refreshes, and Lloyd iterations per refresh)
    index_refresh_every: int = 100
    index_refresh_kmeans_iters: int = 1
    selfnorm_alpha: float = 0.1
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    grad_compression: str = "none"  # none | int8  (pod axis)
