"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/kernels/lib<name>.so`` under the repository
root at first use, then loaded with ``ctypes``. Nothing is built or loaded
when this module is imported. ``build_all`` starts one ``nvcc`` per source
at once.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("topk_z", "ivf_decode", "union_scores", "fmbe_phi_wgmma",
           "fmbe_z", "fused_ce_fwd", "fused_ce_bwd", "lsh_probe",
           "ivf_score")
# C entry points ``<entry>_launch`` of a source, where they are not just
# its own ``<name>_launch``
ENTRIES = {"lsh_probe": ("lsh_probe", "lsh_codes"),
           "fused_ce_bwd": ("fused_ce_bwd", "ce_split")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each entry point ``<name>_launch``; every function returns
# its cudaError_t (0 = success). ``f32`` is 1 for f32 rows and queries, 0
# for bf16.
SIGNATURES = {
    # h, w, Q, V, d, k, grid_x, part_m, part_s, part_v, part_i,
    # lse, topv, topi, f32, stream
    "topk_z": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
               _P],
    # w_blocks, h, head_ids, head_live, head_member, row_logw, tail_rows,
    # tail_accept, Q, U, br, d, L, k, grid_x, part_hm, part_hs, part_v,
    # part_i, part_tm, part_ts, head_lse, tail_lse, topv, topi, f32, stream
    "ivf_decode": [_P] * 8 + [_I] * 7 + [_P] * 10 + [_I, _P],
    # w_blocks, h, head_ids, head_live, Q, U, br, d, grid_x, out, f32, stream
    "union_scores": [_P] * 4 + [_I] * 5 + [_P, _I, _P],
    # x, pack, start, tile_j0, degree, coef, Q, P, d, n_tiles, grid, out,
    # x_planes, f32, stream
    "fmbe_phi_wgmma": [_P] * 6 + [_I] * 5 + [_P] * 2 + [_I, _P],
    # x, pack, tile_j0, start, degree, coef, lam, lam_stride, Q, P, d,
    # n_tiles, grid_x, proj, z, x_planes, f32, stream
    "fmbe_z": [_P] * 7 + [_I] * 6 + [_P] * 3 + [_I, _P],
    # h, w, labels, T, V, d, n_split, per, grid, part_m, part_s, part_p,
    # nll, lse, h_planes, w_planes, f32, stream
    "fused_ce_fwd": [_P] * 3 + [_I] * 6 + [_P] * 7 + [_I, _P],
    # h, w, labels, lse, gn, go, T, V, d, C, grid, cast, dw_add,
    # order_full, start_full, grid_full, order_last, start_last, grid_last,
    # scratch, dh32, dh, dw, h_planes, w_planes, f32, stream
    "fused_ce_bwd": [_P] * 6 + [_I] * 7 + [_P, _P, _I] * 2 + [_P] * 6
                    + [_I, _P],
    # x, R, d, rows, dp, planes, stream
    "ce_split": [_P] + [_I] * 4 + [_P] * 2,
    # h, proj, Q, d, L, K, qcodes, f32, stream
    "lsh_codes": [_P] * 2 + [_I] * 4 + [_P, _I, _P],
    # w, h, proj, cand_rows, cand_live, codes, slot_of_row, tail_ids,
    # tail_accept, tail_bias, Q, C, d, L, K, NT, k, grid_x, qcodes, counts,
    # part_hm, part_hs, part_v, part_i, part_tm, part_ts, head_lse,
    # tail_lse, topv, topi, f32, stream
    "lsh_probe": [_P] * 10 + [_I] * 8 + [_P] * 12 + [_I, _P],
    # w_blocks, h, block_ids, Q, P, nb, br, d, out, f32, stream
    "ivf_score": [_P] * 3 + [_I] * 5 + [_P, _I, _P],
}
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}   # -> the f32 flag
# CTAs per SM of the gathered-row kernels' persistent grid
# (``csrc/gather_stream.cuh``, whose GS_CTAS sizes their shared memory)
STREAM_CTAS_PER_SM = 1

_LIBS: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}       # name -> nvcc's -Xptxas -v report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest


def build_all(names=SOURCES) -> List[str]:
    """Compile every stale source, one ``nvcc`` per source, all at once.
    Returns the names that were built; raises with nvcc's output on
    failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for entry in ENTRIES.get(name, (name,)):
        fn = getattr(lib, f"{entry}_launch")
        fn.argtypes = SIGNATURES[entry]
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def stream_grid(dev: torch.device) -> int:
    """The persistent grid of ``union_scores``, ``ivf_decode`` and
    ``lsh_probe``: every SM, ``STREAM_CTAS_PER_SM`` CTAs each."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * STREAM_CTAS_PER_SM


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def f32_flag(name: str, **tensors) -> int:
    """The kernels' ``f32`` argument: 1 if every named tensor is f32, 0 if
    every one is bf16; a ValueError naming each tensor's dtype otherwise."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or not dtypes <= KERNEL_DTYPES.keys():
        got = ", ".join(f"{k} {t.dtype}" for k, t in tensors.items())
        raise ValueError(f"{name}: kernel takes {' and '.join(tensors)} "
                         f"all bf16 or all f32, got {got}")
    return KERNEL_DTYPES[dtypes.pop()]


def counted(fn):
    """Gives a kernel wrapper its launch counts: ``fn.launches``, the total,
    and ``fn.by_variant``, launches by input dtype ("bf16" or "f32")."""
    fn.launches = 0
    fn.by_variant = {"bf16": 0, "f32": 0}
    return fn


def count(fn, f32: int) -> None:
    """One launch of ``fn``'s kernel at the dtype given by ``f32``."""
    fn.launches += 1
    fn.by_variant["f32" if f32 else "bf16"] += 1


def reset_counts(fns) -> None:
    for fn in fns:
        fn.launches = 0
        fn.by_variant = {"bf16": 0, "f32": 0}
