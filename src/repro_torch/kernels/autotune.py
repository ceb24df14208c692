"""Kernel autotuner: measured launch-knob sweeps with an on-disk cache
(counterpart of ``repro.kernels.autotune``).

The Hopper kernels' knob is their own, not the Pallas tiles: ``grid_x``,
the persistent grid's CTA count (all five tuned kernels). A knob left out
is the default launch, bit for bit:

    cfg = tune_ivf_decode(w_blocks, h, ...)     # {'grid_x': ..}
    ivf_decode(..., **cfg)

The grid that wins depends on the batch through its query tiles (each
kernel launches its grid once a tile of ``QUERY_TILE`` queries), so a
caller that decodes at several batch sizes tunes once a tile count
(``query_tiles``) and picks by it, as ``serve.Engine`` does.

A sweep runs the real kernel on the caller's operands. Each candidate is
timed by CUDA events over bursts of ``BURST`` back-to-back calls queued
behind a device sleep (so the host's launch cost stays out of the burst),
the median of ``reps`` bursts; a single call of these kernels sits on the
replay floor, which moves more than the candidates differ. The winner is
cached with the whole sweep in a JSON file, written atomically, under a key
of the kernel, the operands' shapes and dtypes, ``extra``, the torch and
CUDA versions, the device's name and a hash of the kernel's sources (so a
rebuilt kernel sweeps again). A candidate that raises is skipped once the
device and the kernel's library are checked clean of CUDA errors; if every
candidate fails, the first (the default launch) is returned. Cache:
``$REPRO_TORCH_AUTOTUNE_CACHE``, else ``~/.cache/repro_torch/autotune.json``.

On CPU tensors there is no kernel to time: every ``tune_*`` returns ``{}``
(``autotune`` itself times any callable, on the host clock there).
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from . import _build

ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
BURST = 10                    # back-to-back calls a timed burst
GRID_SHARES = (1.0, 0.25, 0.5, 2.0)   # grid_x candidates x SMs, default first
QUERY_TILE = 8                # queries a grid row of the gathered-row kernels
SLEEP_CYCLES = 4_000_000      # the device sleep a burst is queued behind

# the last sweep or cache hit of each kernel: {"key", "hit", "seconds",
# "config", "ms", "swept", "call"} (for logs and checks; the cache is the
# record)
LAST: Dict[str, dict] = {}


def cache_path(path: Optional[str] = None) -> str:
    return path or os.environ.get(ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def _sig(args) -> str:
    parts = []
    for a in args:
        if isinstance(a, torch.Tensor):
            parts.append(f"{tuple(a.shape)}:{a.dtype}")
        else:
            parts.append(repr(a))
    return ",".join(parts)


def _device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def library_hash(kernel: str) -> str:
    """SHA-256 (first 16 hex digits) of what builds ``kernel``'s library:
    its ``csrc/<kernel>.cu``, every header beside it and the nvcc flags;
    "none" for a name that is not one of the sources."""
    if kernel not in _build.SOURCES:
        return "none"
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for p in [_build.CSRC / f"{kernel}.cu"] + sorted(
            _build.CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def cache_key(kernel: str, args: Iterable[Any], extra: str = "") -> str:
    """The kernel, its operands' shapes and dtypes, ``extra``, the torch
    and CUDA versions, the device's name and the kernel's source hash."""
    args = list(args)
    return (f"{kernel}|{_sig(args)}|{extra}|torch {torch.__version__}|"
            f"cuda {torch.version.cuda}|{device_name(_device(args))}|"
            f"{library_hash(kernel)}")


def _load(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store(path: str, cache: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)    # atomic: concurrent tuners, last write wins


def burst_ms(fn: Callable[[], Any], dev: torch.device, reps: int) -> float:
    """Per-call ms of ``fn``: one warm-up call, then the median over
    ``reps`` bursts of ``BURST`` calls. On a GPU each burst is timed by
    CUDA events and queued behind a device sleep, so the calls run back to
    back; on the CPU by the host clock."""
    fn()
    times = []
    for _ in range(max(1, reps)):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            for _ in range(BURST):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / BURST)
        else:
            t0 = time.perf_counter()
            for _ in range(BURST):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / BURST)
    return statistics.median(times)


def _clean(kernel: str, dev: torch.device) -> None:
    """After a candidate raised: the device synchronises (a sticky error
    would surface here and end the sweep) and the kernel's library holds
    no launch error (read and cleared), so the next candidate starts
    clean."""
    if dev.type != "cuda":
        return
    torch.cuda.synchronize(dev)
    if kernel in _build.SOURCES:
        err = _build.last_error(kernel)
        if err:
            raise RuntimeError(f"autotune {kernel}: a failed candidate left "
                               f"cudaError_t {err} behind")


def autotune(kernel: str, candidates: List[Dict[str, int]],
             build: Callable[[Dict[str, int]], Callable[[], Any]],
             args: Iterable[Any], *, reps: int = 5,
             path: Optional[str] = None, extra: str = "",
             call: Optional[tuple] = None) -> Dict[str, int]:
    """The fastest candidate config, cached on disk.

    ``build(cfg)`` returns a zero-argument callable that runs the kernel
    with that config on the caller's operands. A candidate that raises is
    skipped (its error recorded in the sweep); if every one fails, the
    first is returned and nothing is cached. ``call``, the swept call as
    (wrapper, args, kwargs) without its knobs, is kept in ``LAST`` for a
    caller that holds the winner to something."""
    args = list(args)
    path = cache_path(path)
    key = cache_key(kernel, args, extra)
    dev = _device(args)
    t0 = time.perf_counter()
    cache = _load(path)
    hit = cache.get(key)
    if hit is not None:
        LAST[kernel] = dict(hit, key=key, hit=True, call=call,
                            seconds=time.perf_counter() - t0)
        return dict(hit["config"])
    best_cfg, best_ms = None, float("inf")
    swept = []
    for cfg in candidates:
        try:
            ms = burst_ms(build(cfg), dev, reps)
        except Exception as e:                 # a launch the kernel refuses
            _clean(kernel, dev)
            swept.append({"config": cfg,
                          "error": f"{type(e).__name__}: {e}"[:200]})
            continue
        swept.append({"config": cfg, "ms": ms})
        if ms < best_ms:
            best_cfg, best_ms = cfg, ms
    seconds = time.perf_counter() - t0
    if best_cfg is None:
        LAST[kernel] = dict(key=key, hit=False, seconds=seconds,
                            config=dict(candidates[0]), ms=None,
                            swept=swept, call=call)
        return dict(candidates[0])
    record = {"config": best_cfg, "ms": best_ms, "swept": swept}
    cache = _load(path)                    # another tuner may have written
    cache[key] = record
    _store(path, cache)
    LAST[kernel] = dict(record, key=key, hit=False, seconds=seconds,
                        call=call)
    return dict(best_cfg)


# ---------------------------------------------------------------------------
# per-kernel sweeps
# ---------------------------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _sweep_build(call: tuple):
    """``autotune``'s ``build`` for ``call`` = (wrapper, args, kwargs): the
    wrapper on those operands with a candidate's knobs added."""
    fn, args, kwargs = call
    return lambda cfg: lambda: fn(*args, **kwargs, **cfg)


def grid_candidates(dev: torch.device, default: int,
                    clamp: Callable[[int], int] = lambda g: g) -> List[int]:
    """``default`` first, then the SM count times ``GRID_SHARES``, each
    through ``clamp`` (the kernel's own limit), without repeats."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = [default]
    for share in GRID_SHARES:
        g = clamp(max(1, int(sms * share)))
        if g not in out:
            out.append(g)
    return out


def query_tiles(q: int) -> int:
    """The grid rows a batch of ``q`` queries launches (``QUERY_TILE``
    queries a row; ``topk_z``'s bf16 instance takes 8 or 16 a row, which
    this count separates as well)."""
    return -(-q // QUERY_TILE)


def _stream_cands(dev: torch.device) -> List[Dict[str, int]]:
    return [{"grid_x": g}
            for g in grid_candidates(dev, _build.stream_grid(dev))]


def tune_ivf_decode(w_blocks, h, head_ids, head_live, head_member, row_logw,
                    tail_rows, tail_accept, *, k: int = 1,
                    path: Optional[str] = None,
                    reps: int = 5) -> Dict[str, int]:
    """Sweep grid_x of the fused MIMPS decode kernel."""
    from .ivf_score import ivf_decode
    args = (w_blocks, h, head_ids, head_live, head_member, row_logw,
            tail_rows, tail_accept)
    if _on_cpu(*args):
        return {}
    call = (ivf_decode, args, {"k": k})
    return autotune("ivf_decode", _stream_cands(h.device), _sweep_build(call),
                    (w_blocks, h, head_ids, tail_rows, k), reps=reps,
                    path=path, call=call)


def tune_union_scores(w_blocks, h, head_ids, head_live, *,
                      path: Optional[str] = None,
                      reps: int = 5) -> Dict[str, int]:
    """Sweep grid_x of the deduplicated union-scoring kernel (the MINCE
    and top-k candidate head)."""
    from .ivf_score import union_scores
    args = (w_blocks, h, head_ids, head_live)
    if _on_cpu(*args):
        return {}
    call = (union_scores, args, {})
    return autotune("union_scores", _stream_cands(h.device), _sweep_build(call),
                    (w_blocks, h, head_ids), reps=reps, path=path, call=call)


def tune_lsh_probe(lsh_index, w, h, *, l: int, cand_cap: int = 0,
                   k: int = 1, generator: Optional[torch.Generator] = None,
                   path: Optional[str] = None,
                   reps: int = 5) -> Dict[str, int]:
    """Sweep grid_x of the fused Hamming-probe decode kernel, on
    the candidate set a real decode scores (``core.lsh.device_cands`` of
    the plan: the trimmed union, or every row where it overflows)."""
    if _on_cpu(w, h):
        return {}
    from ..core import lsh as _lsh
    from .lsh_probe import lsh_probe
    plan = _lsh.lsh_plan(lsh_index, h, l, generator=generator,
                         cand_cap=cand_cap)
    rows, live = _lsh.device_cands(plan)
    args = (w, h, lsh_index.proj, rows, live, lsh_index.codes,
            lsh_index.slot_of_row, plan.tail_ids, plan.tail_accept,
            plan.tail_bias)
    call = (lsh_probe, args, {"k": k})
    return autotune("lsh_probe", _stream_cands(h.device), _sweep_build(call),
                    (w, h, lsh_index.proj, rows, plan.tail_ids, k),
                    reps=reps, path=path, call=call)


def tune_fmbe_z(omega, degree, coef, lam, x, *, pack=None,
                path: Optional[str] = None,
                reps: int = 5) -> Dict[str, int]:
    """Sweep grid_x of the fused feature-map estimate's projections."""
    from .fmbe import fmbe_pack, fmbe_z
    if _on_cpu(omega, degree, coef, lam, x):
        return {}
    pack = fmbe_pack(omega, degree, coef) if pack is None else pack
    call = (fmbe_z, (omega, degree, coef, lam, x), {"pack": pack})
    return autotune("fmbe_z", _stream_cands(x.device), _sweep_build(call),
                    (pack.rows, lam, x), reps=reps, path=path, call=call)


def tune_topk_z(h, w, k: int, *, path: Optional[str] = None,
                reps: int = 5) -> Dict[str, int]:
    """Sweep grid_x of the fused exact log-Z/top-k kernel (at most one CTA
    a 128-row box in bf16, one a 32-row group in f32: ``geometry``)."""
    from .topk_z import geometry, topk_z
    if _on_cpu(h, w):
        return {}
    dev = h.device
    q, d = h.shape
    v = w.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def clamp(g):
        return geometry(q, v, d, h.dtype, sms, g)["grid_x"]

    cands = [{"grid_x": g} for g in grid_candidates(
        dev, geometry(q, v, d, h.dtype, sms)["grid_x"], clamp)]
    call = (topk_z, (h, w, k), {})
    return autotune("topk_z", cands, _sweep_build(call), (h, w, k),
                    reps=reps, path=path, call=call)
