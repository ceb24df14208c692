"""Config registry: ``get_config(arch_id)`` + reduced smoke variants."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from . import archs
from .base import (ModelConfig, MoEConfig, PartitionConfig, SSMConfig,
                   ServingConfig, ShapeConfig, TrainConfig, SHAPES,
                   get_shape)

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {
    "mistral-nemo-12b": archs.mistral_nemo_12b,
    "gemma3-4b": archs.gemma3_4b,
    "nemotron-4-15b": archs.nemotron_4_15b,
    "qwen1.5-4b": archs.qwen15_4b,
    "llama-3.2-vision-90b": archs.llama32_vision_90b,
    "deepseek-moe-16b": archs.deepseek_moe_16b,
    "moonshot-v1-16b-a3b": archs.moonshot_v1_16b_a3b,
    "rwkv6-7b": archs.rwkv6_7b,
    "zamba2-7b": archs.zamba2_7b,
    "musicgen-medium": archs.musicgen_medium,
    "lbl-paper": archs.lbl_paper,
}

ASSIGNED_ARCHS: List[str] = [k for k in _REGISTRY if k != "lbl-paper"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch]()


def reduced_config(arch: str) -> ModelConfig:
    """Same family/topology, laptop-scale: used by per-arch smoke tests.

    Keeps every structural feature (grouping pattern, MoE routing, ssm state)
    while shrinking width/depth/vocab."""
    cfg = get_config(arch)
    opts = dict(
        d_model=128, n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads
                                               // max(cfg.n_heads, 1)),
        head_dim=32, d_ff=256, vocab=512, max_seq_len=256,
        remat="none",
        partition=dataclasses.replace(cfg.partition, k=16, l=16, n_probe=2,
                                      block_rows=32, n_clusters=8),
    )
    if cfg.family == "moe":
        opts["moe"] = MoEConfig(n_experts=8, n_shared=1, top_k=2,
                                expert_d_ff=64)
        opts["n_layers"] = 2
    elif cfg.local_global_ratio:
        opts["n_layers"] = 8        # one (5L+1G) group + 2 tail locals
        opts["sliding_window"] = 32
    elif cfg.family == "vlm":
        opts["n_layers"] = 10       # two (4 self + 1 cross) groups
        opts["n_image_tokens"] = 16
    elif cfg.family == "hybrid":
        opts["n_layers"] = 8        # one group of 6 + 2 tail
        opts["shared_attn_every"] = 6
        opts["ssm"] = SSMConfig(state_dim=16, conv_dim=4, expand=2)
        opts["head_dim"] = 32
    elif cfg.family == "ssm":
        opts["n_layers"] = 2
        opts["ssm"] = SSMConfig(wkv_head_size=32)
        opts["d_model"] = 128
    elif cfg.family == "audio":
        opts["n_layers"] = 2
        opts["vocab"] = 64
    else:
        opts["n_layers"] = 2
    return dataclasses.replace(cfg, **opts)


__all__ = ["get_config", "reduced_config", "ASSIGNED_ARCHS", "ModelConfig",
           "MoEConfig", "PartitionConfig", "ServingConfig", "SSMConfig",
           "ShapeConfig", "TrainConfig", "SHAPES", "get_shape"]
