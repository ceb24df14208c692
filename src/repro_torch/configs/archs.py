"""The 10 assigned architectures + the paper's own LBL model, exactly as
specified in the assignment (sources in brackets there). One function per
arch so ``--arch <id>`` resolves through the registry in __init__.py."""
from __future__ import annotations

from .base import ModelConfig, MoEConfig, PartitionConfig, SSMConfig

# Partition-estimation defaults: MIMPS for the big-vocab archs (the paper's
# winner), exact for vocab < 16k where k+l+probes approaches N (DESIGN.md SS5).
_MIMPS = PartitionConfig(method="mimps", k=1000, l=1000, n_probe=16,
                         block_rows=512)
_EXACT = PartitionConfig(method="exact")


def mistral_nemo_12b() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=131072,
        max_seq_len=131072, act="silu", rope_theta=1e6, partition=_MIMPS)


def gemma3_4b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense", n_layers=34, d_model=2560,
        n_heads=8, n_kv_heads=4, head_dim=256, d_ff=10240, vocab=262144,
        max_seq_len=131072, act="gelu", sliding_window=1024,
        local_global_ratio=5, tie_embeddings=True, rope_theta=1e6,
        partition=_MIMPS, subquadratic=True)


def nemotron_4_15b() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
        n_heads=48, n_kv_heads=8, head_dim=128, d_ff=24576, vocab=256000,
        max_seq_len=4096, act="sqrelu", rope_theta=1e4, partition=_MIMPS)


def qwen15_4b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
        n_heads=20, n_kv_heads=20, head_dim=128, d_ff=6912, vocab=151936,
        max_seq_len=32768, act="silu", qkv_bias=True, rope_theta=1e6,
        partition=_MIMPS)


def llama32_vision_90b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm", n_layers=100,
        d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672,
        vocab=128256, max_seq_len=131072, act="silu", cross_attn_every=5,
        n_image_tokens=1601, rope_theta=5e5, partition=_MIMPS)


def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
        max_seq_len=4096, act="silu", rope_theta=1e4,
        moe=MoEConfig(n_experts=64, n_shared=2, top_k=6, expert_d_ff=1408),
        partition=_MIMPS)


def moonshot_v1_16b_a3b() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab=163840,
        max_seq_len=8192, act="silu", rope_theta=5e4,
        moe=MoEConfig(n_experts=64, n_shared=2, top_k=6, expert_d_ff=1408),
        partition=_MIMPS)


def rwkv6_7b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
        n_heads=64, n_kv_heads=64, d_ff=14336, vocab=65536,
        max_seq_len=1048576, act="sqrelu",
        ssm=SSMConfig(wkv_head_size=64),
        partition=_MIMPS, subquadratic=True)


def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
        n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
        max_seq_len=1048576, act="silu", shared_attn_every=6,
        ssm=SSMConfig(state_dim=64, conv_dim=4, expand=2),
        partition=_EXACT, subquadratic=True)


def musicgen_medium() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
        n_heads=24, n_kv_heads=24, head_dim=64, d_ff=6144, vocab=2048,
        max_seq_len=32768, act="gelu", n_codebooks=4, rope_theta=1e4,
        partition=_EXACT)


def lbl_paper() -> ModelConfig:
    """The paper SS5.2 log-bilinear LM (Mnih & Hinton 2008): d=300, ctx=9.
    Modeled as cfg carrying (vocab, d); the LBL itself lives in models/lbl.py."""
    return ModelConfig(
        name="lbl-paper", family="dense", n_layers=1, d_model=300,
        n_heads=1, n_kv_heads=1, head_dim=300, d_ff=300, vocab=10000,
        max_seq_len=9, act="silu",
        partition=PartitionConfig(method="mimps", k=100, l=100, n_probe=8,
                                  block_rows=128))
