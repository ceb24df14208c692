"""Hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch version beside it, and their launch-knob autotuner
(``kernels.autotune``: ``autotune``, ``cache_key``, ``cache_path`` and the
``tune_*`` sweeps, the last three exported here). Importing this package
builds nothing."""
from .autotune import (cache_key, cache_path, tune_fmbe_z, tune_ivf_decode,
                       tune_lsh_probe, tune_topk_z, tune_union_scores)

__all__ = ["cache_key", "cache_path", "tune_fmbe_z", "tune_ivf_decode",
           "tune_lsh_probe", "tune_topk_z", "tune_union_scores"]
