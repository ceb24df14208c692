"""Kar-Karnick feature-map kernels, the FMBE substrate (paper Eq. 9/10;
counterpart of ``repro.kernels.fmbe``).

    phi_j(x) = coef_j * prod_{m < degree_j} (omega_{j,m} . x)

``fmbe_phi`` writes the (Q, P) feature matrix (the build-time kernel that
forms the sketch sums); ``fmbe_z`` folds it straight into
``z = phi(x) . lambda`` (the decode kernel), so no (Q, P) tensor reaches
device memory. Each wrapper launches a CUDA kernel on CUDA tensors and runs
its plain version on CPU tensors. The kernels compute only the projections
with ``m < degree_j``; the plain versions, like the TPU kernels, compute
all ``max_degree`` and multiply by 1 past the degree, which gives the same
result.

``fmbe_phi`` runs its projections as one GEMM on the tensor cores
(``csrc/fmbe_phi_wgmma.cu``): the live rows of omega, which are +-1 and so
exact in bf16, are gathered once per feature map into a bf16 matrix
(``fmbe_pack``), and the epilogue multiplies each feature's columns. bf16
``x`` is read as it is; f32 ``x`` is split into three exact bf16 planes
(``fused_ce.split_planes``), each run against the pack, smallest first, so
every product is exact and only the f32 sums round
(``fmbe_phi_planes_plain`` is that decomposition in plain PyTorch).
``fmbe_z`` (``csrc/fmbe_z.cu``) reads the same pack on the tensor cores
through the gathered-row pipeline (``csrc/gather_stream.cuh``): the
projections of every pack column, bf16 ``x`` as it is and f32 ``x`` as its
three planes, smallest first; then each feature's columns multiplied, times
coef and lambda, and summed in a fixed order (``fmbe_z_pack_plain`` and
``fmbe_z_planes_plain`` are its decompositions). A decode passes the
map's pack (``FMBEState.pack``): ``fmbe_pack`` reads ``degree`` to the host.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
from .fused_ce import planes_width, split_planes

MAX_DEGREE = 8              # the kernels' MMAX: factors a feature multiplies
PACK_TILE = 128             # columns of an output tile (hopper_gemm.cuh BN)


class FmbePack(NamedTuple):
    """The live projection rows of a feature map, laid out for the
    tensor-core ``fmbe_phi`` (``fmbe_pack``).

    Feature j's rows (j, m) for m < degree_j lie in ``rows`` at columns
    ``start[j] + m``, features in order; no feature crosses a 128-column
    tile (the kernel's epilogue reads a feature's columns from one tile of
    accumulators) and the rest is zero. Column tile i writes phi for the
    features [tile_j0[i], tile_j0[i + 1]), at most 128, degree-0 ones
    included. ``source`` holds the omega, degree and coef the pack was made
    from and ``versions`` their version counters then: ``fmbe_phi`` raises
    if it is given other ones, or if they changed since."""
    rows: torch.Tensor       # (n_tiles * 128, d) bf16
    tile_j0: torch.Tensor    # (n_tiles + 1,) int32
    start: torch.Tensor      # (P,) int32, -1 for degree 0
    degree: torch.Tensor     # (P,) int32, at most max_degree
    coef: torch.Tensor       # (P,) f32
    source: Tuple[torch.Tensor, ...]
    versions: Tuple[int, ...]


def pack_layout(degree: List[int], max_degree: int
                ) -> Tuple[List[int], List[int], int]:
    """Where ``fmbe_pack`` puts each feature's rows: (start (P,), -1 for
    degree 0; tile_j0 (n_tiles + 1,); n_tiles). Features are placed in
    order; one that would cross a 128-column tile starts the next tile, as
    does the feature after a tile's 128th (the kernel's 32 lanes take 4 of
    a tile's features each). A degree-0 feature belongs to the tile of the
    next free column."""
    start, tile = [], []
    pos = 0
    cur, n_cur = 0, 0                   # current tile and its features
    for g in degree:
        g = max(min(int(g), max_degree), 0)
        t = pos // PACK_TILE
        if (t == cur and n_cur == PACK_TILE) or (
                g > 0 and (pos + g - 1) // PACK_TILE != t):
            t += 1                      # the tile is full, or g would cross
            pos = t * PACK_TILE
        if t != cur:
            cur, n_cur = t, 0
        n_cur += 1
        tile.append(t)
        start.append(pos if g > 0 else -1)
        pos += g
    n_tiles = max([1, -(-pos // PACK_TILE)] + [t + 1 for t in tile[-1:]])
    tile_j0, j = [0], 0
    for i in range(1, n_tiles):
        while j < len(tile) and tile[j] < i:
            j += 1
        tile_j0.append(j)
    tile_j0.append(len(degree))
    return start, tile_j0, n_tiles


def fmbe_pack(omega, degree, coef) -> FmbePack:
    """Gathers the live rows (j, m < degree_j) of omega (P, M, d) into the
    bf16 layout of ``pack_layout``, once per feature map. Reads ``degree``
    to the host (build time, never in a decode step). Raises if a live row
    is not exact in bf16 (the kernel would round it)."""
    _, m, d = omega.shape
    if not 1 <= m <= MAX_DEGREE:
        raise ValueError(f"fmbe_pack: max_degree {m} outside [1, "
                         f"{MAX_DEGREE}]")
    deg = degree.clamp(0, m).to(torch.int32)
    start, tile_j0, n_tiles = pack_layout(deg.tolist(), m)
    dev = omega.device
    start_t = torch.tensor(start, dtype=torch.int32, device=dev)
    live = torch.arange(m, device=dev)[None, :] < deg[:, None].long()
    src = omega[live]                                   # (n_live, d) j, m order
    cols = (start_t[:, None].long() + torch.arange(m, device=dev))[live]
    packed = src.to(torch.bfloat16)
    if not torch.equal(packed.float(), src.float()):
        raise ValueError("fmbe_pack: a live omega row is not exact in bf16 "
                         "(the tensor-core kernel needs +-1 projections)")
    rows = torch.zeros((n_tiles * PACK_TILE, d), dtype=torch.bfloat16,
                       device=dev)
    rows[cols] = packed
    return FmbePack(rows=rows,
                    tile_j0=torch.tensor(tile_j0, dtype=torch.int32,
                                         device=dev),
                    start=start_t, degree=deg,
                    coef=coef.float().contiguous(),
                    source=(omega, degree, coef),
                    versions=(omega._version, degree._version,
                              coef._version))


def _reads_pack(x) -> bool:
    """Whether ``fmbe_phi`` runs rows like x on the tensor-core kernel,
    which reads a pack: bf16 or f32 on the GPU."""
    return x.is_cuda and x.dtype in _build.KERNEL_DTYPES


def pack_if_needed(omega, degree, coef, x) -> Optional[FmbePack]:
    """The map's ``fmbe_pack`` where ``fmbe_phi`` reads one for rows like
    x, else None."""
    return fmbe_pack(omega, degree, coef) if _reads_pack(x) else None


def _check_pack(pack: FmbePack, omega, degree, coef,
                name: str = "fmbe_phi") -> None:
    same = all(s.data_ptr() == t.data_ptr() and s.shape == t.shape
               and s.stride() == t.stride() and s.dtype == t.dtype
               and t._version == v
               for s, t, v in zip(pack.source, (omega, degree, coef),
                                  pack.versions))
    _check(same, "the pack was made from another omega, degree or coef, "
           "or they changed since", name)


def fmbe_phi_plain(omega, degree, coef, x):
    """Plain PyTorch version of ``fmbe_phi``: factors multiplied in m
    order, then ``coef``, all in f32."""
    xf = x.float()
    prod = torch.ones((x.shape[0], omega.shape[0]), dtype=torch.float32,
                      device=x.device)
    for m in range(omega.shape[1]):
        proj = xf @ omega[:, m, :].float().T
        prod = prod * torch.where(degree[None, :] > m, proj,
                                  torch.ones_like(proj))
    return prod * coef.float()


def fmbe_z_plain(omega, degree, coef, lam, x):
    """Plain PyTorch version of ``fmbe_z``."""
    phi = fmbe_phi_plain(omega, degree, coef, x)
    return (phi * lam.float()).sum(-1)


def fmbe_phi_pack_plain(pack: FmbePack, x):
    """Plain PyTorch version of the tensor-core ``fmbe_phi``: the
    projections as one f32 product with the packed rows, then each
    feature's columns multiplied in m order, then coef."""
    return _feature_products(pack, x.float() @ pack.rows.float().T)


def fmbe_z_pack_plain(pack: FmbePack, lam, x):
    """Plain PyTorch version of the tensor-core ``fmbe_z``: phi from the
    pack (``fmbe_phi_pack_plain``) times lambda, summed."""
    return (fmbe_phi_pack_plain(pack, x) * lam.float()).sum(-1)


def fmbe_z_planes_plain(pack: FmbePack, lam, x):
    """The f32 ``fmbe_z`` kernel's decomposition: phi from the three planes
    of x (``fmbe_phi_planes_plain``) times lambda, summed. For tests and
    ``chip_smoke.py``, never on the main path."""
    return (fmbe_phi_planes_plain(pack, x) * lam.float()).sum(-1)


def fmbe_phi_planes_plain(pack: FmbePack, x):
    """The f32 kernel's decomposition in plain PyTorch: the projections as
    three f32 products of ``split_planes(x)`` with the packed rows, added
    smallest plane first, then ``fmbe_phi_pack_plain``'s feature products.
    For tests and ``chip_smoke.py``, never on the main path."""
    rows = pack.rows.float().T
    proj = None
    for plane in reversed(split_planes(x)):
        term = plane.float() @ rows
        proj = term if proj is None else proj + term
    return _feature_products(pack, proj)


def _feature_products(pack: FmbePack, proj):
    """phi from the (Q, n_cols) f32 projections on the pack's columns."""
    prod = torch.ones((proj.shape[0], pack.start.shape[0]),
                      dtype=torch.float32, device=proj.device)
    for m in range(MAX_DEGREE):
        use = pack.degree > m
        if not bool(use.any()):
            break
        col = torch.where(use, pack.start + m, 0).long()
        prod = torch.where(use[None, :], prod * proj[:, col], prod)
    return prod * pack.coef


def _check(cond: bool, msg: str, name: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_inputs(name, omega, degree, coef, x, extra=()):
    tensors = (omega, degree, coef, x) + tuple(extra)
    dev = x.device
    _check(all(t.device == dev for t in tensors) and dev.type == "cuda",
           "every input must be on one GPU", name)
    _check(omega.dtype == torch.float32 and coef.dtype == torch.float32
           and degree.dtype == torch.int32
           and x.dtype in _build.KERNEL_DTYPES,
           f"kernel takes f32 omega/coef, int32 degree and bf16 or f32 x, "
           f"got {omega.dtype}, {coef.dtype}, {degree.dtype}, {x.dtype}",
           name)
    _check(omega.dim() == 3 and x.dim() == 2, "shapes", name)
    p, m, d = omega.shape
    q = x.shape[0]
    _check(degree.shape == (p,) and coef.shape == (p,) and x.shape == (q, d),
           f"shapes omega {tuple(omega.shape)} degree {tuple(degree.shape)} "
           f"coef {tuple(coef.shape)} x {tuple(x.shape)}", name)
    _check(1 <= m <= MAX_DEGREE, f"max_degree {m} outside [1, {MAX_DEGREE}]",
           name)
    _check(all(t.is_contiguous() for t in tensors), "inputs not contiguous",
           name)
    _check(d % 8 == 0 and omega.data_ptr() % 16 == 0
           and x.data_ptr() % 16 == 0,
           "rows must be 16-byte aligned (d % 8 == 0)", name)
    _check(q >= 1 and p >= 1, "empty input", name)
    return q, p, m, d


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check_pack_rows(pack: FmbePack, x, name: str) -> int:
    """n_tiles of a pack whose rows x (Q, d) can be scored against."""
    dev = x.device
    tensors = (pack.rows, pack.start, pack.tile_j0, pack.degree, pack.coef)
    _check(all(t.device == dev for t in tensors),
           "x and the pack must be on one GPU", name)
    d = x.shape[1]
    n_cols = pack.rows.shape[0]
    n_tiles = n_cols // PACK_TILE
    _check(pack.rows.dtype == torch.bfloat16 and pack.rows.shape[1] == d
           and n_cols == n_tiles * PACK_TILE
           and pack.tile_j0.shape == (n_tiles + 1,),
           f"pack rows {tuple(pack.rows.shape)} {pack.rows.dtype} for x "
           f"{tuple(x.shape)}", name)
    _check(pack.rows.is_contiguous() and pack.rows.data_ptr() % 16 == 0,
           "pack rows not contiguous and 16-byte aligned", name)
    return n_tiles


def phi_launch(pack: FmbePack, x, *, lib=None):
    """``fmbe_phi``'s kernel (``csrc/fmbe_phi_wgmma.cu``) on x (Q, d) bf16
    or f32 on the GPU against the pack of its map, without its launch
    count: (phi (Q, P) f32, planes). f32 x is first split by the
    ``ce_split`` kernel into (3, Q, dp) bf16 planes, dp = d rounded up to
    64 columns; ``planes`` is that buffer, for holding the split to
    ``split_planes``, and None at bf16. ``lib`` is the built library to
    launch (default: the package's), for tools."""
    dev = x.device
    n_tiles = _check_pack_rows(pack, x, "fmbe_phi")
    q, d = x.shape
    p = pack.start.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = min(sms, -(-q // PACK_TILE) * n_tiles)
    is_f32 = _build.KERNEL_DTYPES[x.dtype]
    planes = (torch.empty((3, q, planes_width(d)), dtype=torch.bfloat16,
                          device=dev) if is_f32 else None)
    lib = _build.load("fmbe_phi_wgmma") if lib is None else lib
    out = torch.empty((q, p), dtype=torch.float32, device=dev)
    ptr = ctypes.c_void_p
    err = lib.fmbe_phi_wgmma_launch(
        *[ptr(t.data_ptr()) for t in (x, pack.rows, pack.start,
                                      pack.tile_j0, pack.degree, pack.coef)],
        q, p, d, n_tiles, grid,
        ptr(out.data_ptr()), ptr(planes.data_ptr() if is_f32 else None),
        is_f32, _stream(dev))
    _build.check("fmbe_phi_wgmma", err)
    return out, planes


@_build.counted
def fmbe_phi(omega, degree, coef, x, *, pack: Optional[FmbePack] = None):
    """phi(x) without the (Q, P, max_degree) projection tensor.

      omega  (P, M, d) f32 +-1   degree (P,) int32   coef (P,) f32
      x      (Q, d) bf16 or f32
      pack   ``fmbe_pack(omega, degree, coef)`` of these very tensors, made
             once per feature map (``pack_if_needed``) and read by the
             tensor-core kernel; a call on the GPU without it packs the map
             itself

    Returns (Q, P) f32. On the GPU, x runs the tensor-core kernel
    (``csrc/fmbe_phi_wgmma.cu``): bf16 as it is, counted as a "bf16"
    launch, f32 as three exact bf16 planes, counted as "f32". On CPU
    tensors: ``fmbe_phi_pack_plain`` given a pack, else
    ``fmbe_phi_plain``."""
    if pack is not None:
        _check_pack(pack, omega, degree, coef)
    if all(t.device.type == "cpu" for t in (omega, degree, coef, x)):
        if pack is not None:
            return fmbe_phi_pack_plain(pack, x)
        return fmbe_phi_plain(omega, degree, coef, x)
    _check_inputs("fmbe_phi", omega, degree, coef, x)
    out, _ = phi_launch(
        pack if pack is not None else fmbe_pack(omega, degree, coef), x)
    _build.count(fmbe_phi, _build.KERNEL_DTYPES[x.dtype])
    return out


@_build.counted
def fmbe_z(omega, degree, coef, lam, x, *, pack: Optional[FmbePack] = None,
           grid_x=None):
    """Fused decode estimate z(x) = phi(x) . lambda, (Q,) signed f32.

    ``lam`` is (P,), one shared sketch sum (the global-Z path), or (Q, P),
    a per-query lambda (the block-partitioned complement path,
    ``core.feature_maps.fmbe_tail_z``). x is bf16 or f32. ``pack`` is
    ``fmbe_pack(omega, degree, coef)`` of these very tensors, made once per
    feature map and read by the kernel; a call on the GPU without it packs
    the map itself, which reads ``degree`` to the host (never in a decode
    step). On the GPU, bf16 x is counted as a "bf16" launch and f32 x
    (three planes) as "f32". On CPU tensors: ``fmbe_z_pack_plain`` given a
    pack, else ``fmbe_z_plain``. ``grid_x`` (None: ``_build.stream_grid``)
    is the projections' launch knob (``kernels.autotune``); every
    projection is written by one thread and summed in a fixed order, so it
    leaves the bits as they are. CPU tensors ignore it."""
    if pack is not None:
        _check_pack(pack, omega, degree, coef, "fmbe_z")
    if all(t.device.type == "cpu" for t in (omega, degree, coef, lam, x)):
        if pack is not None:
            return fmbe_z_pack_plain(pack, lam, x)
        return fmbe_z_plain(omega, degree, coef, lam, x)
    q, p, _, d = _check_inputs("fmbe_z", omega, degree, coef, x, (lam,))
    _check(lam.dtype == torch.float32 and lam.shape in ((p,), (q, p)),
           f"lam must be f32 (P,) or (Q, P), got {lam.dtype} "
           f"{tuple(lam.shape)}", "fmbe_z")
    if pack is None:
        pack = fmbe_pack(omega, degree, coef)
    n_tiles = _check_pack_rows(pack, x, "fmbe_z")
    dev = x.device
    grid_x = _build.grid_knob("fmbe_z", dev, grid_x)
    is_f32 = _build.KERNEL_DTYPES[x.dtype]
    # f32 x: the (3, Q, d) bf16 planes that the kernel splits it into
    planes = (torch.empty((3, q, d), dtype=torch.bfloat16, device=dev)
              if is_f32 else None)
    proj = torch.empty((q, n_tiles * PACK_TILE), dtype=torch.float32,
                       device=dev)
    z = torch.empty((q,), dtype=torch.float32, device=dev)
    ptr = ctypes.c_void_p
    err = _build.load("fmbe_z").fmbe_z_launch(
        *[ptr(t.data_ptr()) for t in (x, pack.rows, pack.tile_j0,
                                      pack.start, pack.degree, pack.coef,
                                      lam)],
        p if lam.dim() == 2 else 0, q, d, n_tiles, grid_x,
        ptr(proj.data_ptr()), ptr(z.data_ptr()),
        ptr(planes.data_ptr() if is_f32 else None), is_f32, _stream(dev))
    _build.check("fmbe_z", err)
    _build.count(fmbe_z, is_f32)
    return z
