"""Cost counts of one traced step (counterpart of
``repro.launch.hlo_analysis``).

The JAX package parses the post-partitioning HLO text of a compiled step
and multiplies loop bodies by their trip counts. The port has no compiled
program to read: it counts the ATen ops the step dispatches, one by one,
as the step runs (usually on fake tensors, ``launch.dryrun``), so every
loop is already unrolled and nothing needs a trip count.

``CostCounter`` is a ``TorchDispatchMode`` that records for each op

  * flops            the products' multiply-adds x 2 (matmuls,
                     convolutions, attention), as ``FlopCounterMode``
                     counts them (``torch.utils.flop_counter``'s
                     registry); the JAX package's ``analyze`` adds one a
                     result element for elementwise ops, this count does
                     not
  * bytes            operand + result bytes; view and metadata ops
                     (``view``, ``permute``, ``expand``, ``detach``,
                     ``alias``, ``empty``, ...) move nothing and count 0;
                     an in-place op counts the tensor it writes once
  * transcendentals  result elements of exp, log, sqrt, tanh, sigmoid,
                     softmax, ...
  * collectives      result bytes of each ``c10d`` op by type:
                     all-reduce, all-gather, reduce-scatter, all-to-all,
                     collective-permute (send/recv), broadcast
  * peak_bytes       the most bytes of live tensor storage during the
                     step, storages counted once however many views share
                     them (the counterpart of JAX's ``memory_analysis``);
                     storages alive when counting starts count only where
                     ``track`` was given them

With ``trips`` a time loop written with ``scan`` (the recurrent families'
prefill and training) runs two steps, one counted for every step but the
last, forward and backward, as JAX multiplies a loop body by its trip
count: its products and its forward's bytes are the whole loop's; its
backward leaves out all but one of the sums that gather the gradients of
the inputs each step slices, and its memory holds two steps'
intermediates.

A call of a kernel wrapper (``kernels._build.counted``) is counted as the
kernel: its tensor arguments and results are its bytes, the FLOPs and
transcendentals of its plain version (whose products are the kernel's)
are its own, and the plain version's intermediates count neither bytes nor
memory. With ``tags`` each op also carries the last three ``repro_torch``
frames that issued it (``launch.breakdown``).
"""
from __future__ import annotations

import bisect
import contextlib
import sys
import weakref
from collections import Counter
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast"}
# ops that move no data: views, metadata and uninitialised allocations
METADATA = {"view", "_unsafe_view", "reshape", "permute", "transpose", "t",
            "expand", "squeeze", "unsqueeze", "detach", "alias", "as_strided",
            "slice", "select", "unbind", "split", "split_with_sizes",
            "chunk", "narrow", "diagonal", "unfold", "view_as_real",
            "view_as_complex", "lift_fresh", "empty", "empty_like",
            "empty_strided", "new_empty", "new_empty_strided", "_to_dense",
            "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
            "sym_storage_offset", "is_same_size", "_local_scalar_dense"}
TRANSCENDENTAL = {"exp", "exp_", "exp2", "expm1", "log", "log_", "log1p",
                  "log2", "log10", "rsqrt", "sqrt", "tanh", "sigmoid",
                  "pow", "sin", "cos", "erf", "erfinv", "_softmax",
                  "_log_softmax", "logsumexp", "silu", "gelu", "softplus",
                  "logaddexp", "reciprocal"}


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's distinct bytes: a broadcast (stride 0) dim counts
    once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else min(size, 1)
    return n * t.element_size()


def kernel_bytes(name: str, args, kwargs, out) -> int:
    """The bytes a kernel moves: each tensor argument read once and each
    result written once, except the tables the gathered-row kernels read
    only in part: ``ivf_score`` reads each tile's union of probed blocks
    (at most min(QT * p, nb) blocks a tile of QT queries), ``union_scores``
    and ``ivf_decode`` the U blocks of their union, ``lsh_probe`` the
    rows of its C candidates and its tail (``union_scores``,
    ``ivf_decode`` and ``lsh_probe`` at their static capacity, an upper
    bound: the live union is data); ``fmbe_z`` and ``fmbe_phi`` given a
    pack read the pack, not omega; a gated ``topk_z`` (``rows=``) counts
    as the healthy case, every query unflagged, where its CTAs return at
    once: no rows read and no products (``CostCounter`` drops its plain
    version's)."""
    from ..kernels.ivf_score import QT
    rest, table = list(args), 0
    if name in ("ivf_score", "union_scores", "ivf_decode"):
        w, ids = rest[0], rest[2]
        blk = w[0].numel() * w.element_size()
        if name == "ivf_score":
            q, p = ids.shape
            nb = w.shape[0]
            n = sum(min(min(QT, q - i) * p, nb) for i in range(0, q, QT))
        else:
            n = ids.shape[0]
        rest[0], table = None, n * blk
    elif name == "lsh_probe":
        w, cand, tail = rest[0], rest[3], rest[7]
        rest[0] = None
        table = (cand.shape[0] + tail.shape[0]) * w.shape[1] * \
            w.element_size()
    elif name in ("fmbe_z", "fmbe_phi") and kwargs.get("pack") is not None:
        rest[0] = None
    elif name == "topk_z" and kwargs.get("rows") is not None:
        rest[1] = None
    return table + sum(_nbytes(t) for t in _tensors((rest, kwargs))) + \
        sum(_nbytes(t) for t in _tensors(out))


# ops that read rows by index: their result's rows and the indices move
GATHERS = {"index", "index_select", "gather", "embedding", "take_along_dim"}
# ops that write rows by index into their first argument, in place or into
# a copy: the rows written (their source) and the indices move
SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "index_add",
            "index_add_", "index_copy", "index_copy_", "scatter_reduce",
            "scatter_reduce_"}


def _op_bytes(name: str, args, kwargs, outs) -> int:
    """An op's operand + result bytes, each tensor once (an in-place op's
    result is its operand); a gather or scatter moves its rows, read and
    written, and its indices, as the JAX package counts a (dynamic)
    slice, gather or update."""
    if name in GATHERS:
        idx = [t for t in _tensors((args[1:], kwargs))
               if not t.is_floating_point()]
        return 2 * sum(_nbytes(t) for t in outs) + sum(
            _nbytes(t) for t in idx)
    if name in SCATTERS:
        rest = list(_tensors((args[1:], kwargs)))
        src = [t for t in rest if t.is_floating_point()
               or t.dtype == args[0].dtype]
        idx = [t for t in rest if all(t is not u for u in src)]
        return 2 * sum(_nbytes(t) for t in src) + sum(
            _nbytes(t) for t in idx)
    ins = list(_tensors((args, kwargs)))
    seen = {id(t) for t in ins}
    return sum(_nbytes(t) for t in ins) + sum(
        _nbytes(t) for t in outs if id(t) not in seen)


# modules whose frames a tag leaves out
SKIP = (__name__, "repro_torch.kernels._build")


def _frames_tag() -> str:
    """The last three ``repro_torch`` frames of the stack (outermost
    first), as ``module.function``, the modules ``SKIP`` left out."""
    out = []
    f = sys._getframe(2)
    while f is not None and len(out) < 3:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch") and mod not in SKIP:
            out.append(f"{mod.removeprefix('repro_torch.')}."
                       f"{f.f_code.co_name}")
        f = f.f_back
    return "/".join(reversed(out)) or "(outside repro_torch)"


class CostCounter(TorchDispatchMode):
    """Counts every ATen op dispatched while it is active (see the module
    docstring). ``tags``: keep each op's counts by (tag, op) in ``by_tag``
    as well. ``trips``: run two steps of a ``scan``, one counted for all
but its last (see the module docstring)."""

    def __init__(self, tags: bool = False, trips: bool = False):
        super().__init__()
        self.trips = trips
        self.scale = 1                 # ``repeated``'s multiplier
        self._regions: list = []       # (first, last autograd node, trips)
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.collectives: Counter = Counter()
        self.by_op: Dict[str, Counter] = {}
        self.by_tag: Optional[Dict[tuple, Counter]] = {} if tags else None
        self._kernel = 0               # depth of kernel wrapper calls
        self._kname = ""               # the outermost one's record name
        self._ktag = None              # and its tag
        self._kgated = False           # and whether it is a gated topk_z
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.sections: Dict[str, Counter] = {}

    # -- memory ----------------------------------------------------------

    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def track(self, tree) -> None:
        """Count the storages of the tensors in ``tree`` as live from now
        until they are freed."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            weakref.finalize(st, self._free, key, n)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- counting --------------------------------------------------------

    def _mult(self) -> int:
        """``scale``, times a ``scan`` step's trips while the autograd
        engine runs a node that step made."""
        if not self._regions:
            return self.scale
        node = torch._C._current_autograd_node()
        if node is None:
            return self.scale
        seq = node._sequence_nr()
        i = bisect.bisect_right(self._regions, (seq, float("inf"))) - 1
        if i >= 0 and self._regions[i][1] >= seq:
            return self.scale * self._regions[i][2]
        return self.scale

    def _add(self, name: str, tag, flops=0, nbytes=0, trans=0, coll=None,
             call=True):
        m = self._mult()
        flops, nbytes, trans = flops * m, nbytes * m, trans * m
        if coll is not None:
            coll = (coll[0], coll[1] * m)
        self.flops += flops
        self.bytes += nbytes
        self.transcendentals += trans
        row = self.by_op.setdefault(name, Counter())
        row["flops"] += flops
        row["bytes"] += nbytes
        row["transcendentals"] += trans
        row["calls"] += m if call else 0
        if coll is not None:
            self.collectives[coll[0]] += coll[1]
            row["collective_bytes"] += coll[1]
        if self.by_tag is not None:
            t = self.by_tag.setdefault((tag, name), Counter())
            t["flops"] += flops
            t["bytes"] += nbytes
            t["collective_bytes"] += 0 if coll is None else coll[1]

    def kernel_call(self, name: str, fn, args, kwargs):
        """A kernel wrapper's call, counted as its kernel (the hook of
        ``kernels._build.counted``)."""
        tag = _frames_tag() if self.by_tag is not None else None
        if self._kernel == 0:
            self._kname, self._ktag = f"kernel:{name}", tag
            self._kgated = name == "topk_z" and kwargs.get("rows") is not None
        self._kernel += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._kernel -= 1
        if self._kernel == 0:
            self._add(self._kname, tag,
                      nbytes=kernel_bytes(name, args, kwargs, out))
            self.track(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        out = func(*args, **kwargs)
        name = packet.__name__
        ns = func.namespace
        tag = None
        if ns in ("c10d", "_c10d_functional"):
            kind = COLLECTIVES.get(name)
            if kind is not None and not self._kernel:
                n = sum(_nbytes(t) for t in _tensors(args[0]))
                if self.by_tag is not None:
                    tag = _frames_tag()
                self._add(f"{ns}.{name}", tag, nbytes=2 * n, coll=(kind, n))
            return out
        if ns != "aten" or name in METADATA or func.is_view:
            return out
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        trans = 0
        if name in TRANSCENDENTAL:
            trans = sum(t.numel() for t in _tensors(out))
        if self._kernel:
            # inside a kernel wrapper: the plain version's products are
            # the kernel's, its traffic and memory are not
            if (flops or trans) and not self._kgated:
                self._add(self._kname, self._ktag, flops=flops, trans=trans,
                          call=False)
            return out
        outs = list(_tensors(out))
        nbytes = _op_bytes(name, args, kwargs, outs)
        if self.by_tag is not None:
            tag = _frames_tag()
        self._add(f"aten.{name}", tag, flops=flops, nbytes=nbytes,
                  trans=trans)
        self.track(outs)
        return out

    def __enter__(self):
        from ..kernels import _build
        self._prev_hook = _build.set_cost_hook(self.kernel_call)
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from ..kernels import _build
        _ACTIVE.remove(self)
        _build.set_cost_hook(self._prev_hook)
        return super().__exit__(*exc)

    def _totals(self) -> Counter:
        return Counter(flops=self.flops, bytes=self.bytes,
                       transcendentals=self.transcendentals,
                       collective_bytes=sum(self.collectives.values()),
                       **{f"collective:{k}": v
                          for k, v in self.collectives.items()})

    def summary(self) -> Dict[str, Any]:
        return {"flops": float(self.flops),
                "transcendentals": float(self.transcendentals),
                "bytes": float(self.bytes),
                "collectives": dict(self.collectives),
                "peak_bytes": float(self.peak_bytes)}


def fake_copy(obj, fake_mode, device="cpu"):
    """A copy of ``obj``'s object graph for counting on fake tensors: every
    tensor becomes a fake tensor of ``fake_mode`` on ``device`` with its
    shape, strides and dtype (its data is not copied: nothing is read),
    every ``torch.device`` ``device``, every generator a new one there;
    tuples, lists, dicts and objects with a ``__dict__`` are copied with
    their contents converted, anything else is kept. Objects reached
    twice are converted once."""
    import copy
    import types

    dev = torch.device(device)
    memo: Dict[int, Any] = {}
    keep = (int, float, complex, str, bytes, bool, type(None), type,
            types.FunctionType, types.BuiltinFunctionType, types.ModuleType,
            types.MethodType, torch.dtype)

    def conv(x):
        got = memo.get(id(x))
        if got is not None:
            return got[1]
        if isinstance(x, keep):
            return x
        if isinstance(x, torch.Tensor):
            with fake_mode:
                y = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                        device=dev)
        elif isinstance(x, torch.device):
            y = dev
        elif isinstance(x, torch.Generator):
            y = torch.Generator(device=dev)
        elif isinstance(x, tuple):
            items = [conv(v) for v in x]
            y = type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
        elif isinstance(x, list):
            y = []
            memo[id(x)] = (x, y)
            y.extend(conv(v) for v in x)
        elif isinstance(x, dict):
            y = type(x)() if type(x) is dict else copy.copy(x)
            memo[id(x)] = (x, y)
            y.clear()
            y.update({k: conv(v) for k, v in x.items()})
        elif hasattr(x, "__dict__") and not isinstance(x, torch.nn.Module):
            try:
                y = copy.copy(x)
            except Exception:                               # noqa: BLE001
                y = x                          # not copyable: kept
            if y is not x:
                memo[id(x)] = (x, y)
                y.__dict__.update({k: conv(v) for k, v in vars(x).items()})
        else:
            y = x
        memo[id(x)] = (x, y)          # x kept alive: its id stays its own
        return y
    return conv(obj)


_ACTIVE: list = []


@contextlib.contextmanager
def repeated(n: int):
    """What the active counters count inside this block counts ``n``
    times."""
    scales = [(c, c.scale) for c in _ACTIVE]
    for c, sc in scales:
        c.scale = sc * n
    try:
        yield
    finally:
        for c, sc in scales:
            c.scale = sc


def _autograd_seq() -> int:
    """The sequence number of the last autograd node made (this probe's
    own, counted by nothing)."""
    with torch.enable_grad(), repeated(0):
        return (torch.zeros((), requires_grad=True) * 1).grad_fn \
            ._sequence_nr()


class _Copies(torch.autograd.Function):
    """The loop's stacked outputs from its two steps that ran: the first's
    y standing for steps 0 .. n - 2, the last's for step n - 1. Each
    step's gradient is a view of the stack's, as in the loop."""

    @staticmethod
    def forward(ctx, y_mid, y_last, n):
        return torch.stack([y_mid] * (n - 1) + [y_last], 1)

    @staticmethod
    def backward(ctx, g):
        return g.select(1, 0), g.select(1, g.shape[1] - 1), None


def scan(step, carry, xs):
    """The loop over time: ``carry, y_t = step(carry, *(x[:, t] for x in
    xs))`` for each t of the tensors ``xs`` (B, S, ...); returns (the y_t
    stacked along dim 1, the last carry). The steps' inputs are views
    taken once (``unbind``), so the backward stacks their gradients once.
    Under a counter with ``trips`` (see the module docstring) two steps
    run: the first, counted for steps 0 .. S - 2, and the last on its
    carry, so every input and the carry chain reach the outputs as in the
    loop."""
    n = xs[0].shape[1]
    counters = [c for c in _ACTIVE if c.trips]
    if n > 1 and counters:
        first = [x.select(1, 0) for x in xs]
        last = [x.select(1, n - 1) for x in xs]
        lo = _autograd_seq()
        with repeated(n - 1):
            carry, y_mid = step(carry, *first)
        hi = _autograd_seq()
        for c in counters:
            c._regions.append((lo, hi, n - 1))
        carry, y_last = step(carry, *last)
        return _Copies.apply(y_mid, y_last, n), carry
    steps = [x.unbind(1) for x in xs]
    ys = []
    for t in range(n):
        carry, y = step(carry, *(p[t] for p in steps))
        ys.append(y)
    return torch.stack(ys, 1), carry


@contextlib.contextmanager
def section(name: str):
    """What the active counters count inside this block is also added to
    their ``sections[name]`` (flops, bytes, transcendentals,
    collective_bytes, and ``collective:<type>`` by type); without a
    counter it does nothing."""
    before = [(c, c._totals()) for c in _ACTIVE]
    try:
        yield
    finally:
        for c, t0 in before:
            row = c.sections.setdefault(name, Counter())
            for k, v in c._totals().items():
                row[k] += v - t0[k]


def analyze(fn, *args, track=None, **kwargs) -> Dict[str, Any]:
    """Counts one call ``fn(*args, **kwargs)``: the keys of the JAX
    package's ``analyze`` (``flops``, ``bytes``, ``transcendentals``,
    ``collectives`` by type) and ``peak_bytes``, the live storage of
    ``track`` (default: the call's arguments) and of every tensor the call
    makes, at its most. Run it under ``FakeTensorMode`` to count a step
    at any size without memory or a device."""
    with CostCounter() as c:
        c.track((args, kwargs) if track is None else track)
        fn(*args, **kwargs)
    return c.summary()
