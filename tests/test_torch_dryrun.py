"""The port's dry run (``repro_torch.launch.dryrun``, ``hlo_analysis``,
``breakdown``) on the CPU.

* FLOPs: ``hlo_analysis``'s count of ``dryrun.build_step`` at reduced
  configs (a prefill of 2 x 64 tokens and a decode of 4 lanes at KV 64,
  on a fake one-rank mesh) equals the JAX package's trip-aware HLO dot
  FLOPs of the same step (``repro.launch.hlo_analysis.parse_module``,
  ``_called`` and ``_dot_flops`` over the compiled HLO of the model's
  ``forward`` or ``decode_step`` and its exact head on one CPU device;
  JAX's ``streaming_logz_argmax`` at chunk = V, as its default chunk pads
  the rows to 8192 and counts the pad's products), for seven families.
* The ``fused_ce`` train step equals 3 x the trunk's forward plus 4 head
  products (the forward, and the backward's recomputed logits, dh and
  dW).
* The split train step at (1, m) counts the one-device step's FLOPs
  divided by m. On a 2 x 2 fake mesh its collective bytes equal their
  closed form (the activations' sums, the vocab-parallel lookup and CE
  pair, the gradient slices' mean over 'data'); the decode step's equal
  the head's combine.
* ``ivf_specs_for`` gives JAX's shapes and dtypes for every arch.
* ``run_cell`` at full width writes only under its ``out`` and leaves no
  process group; qwen1.5-4b's decode trunk is the config's closed form;
  ``main`` exits non-zero on a failing cell; ``breakdown.run`` ranks the
  counts by tag; the counter's bytes, peak memory and kernel rule.

About 30 s on one worker: JAX's compiles.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.launch.hlo_analysis import _called, _dot_flops, parse_module
from repro.models import Model as JModel
from repro.serve.output_layer import ivf_specs_for as jax_ivf_specs_for
from repro.serve.output_layer import streaming_logz_argmax as jax_stream
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import breakdown, dryrun
from repro_torch.launch.hlo_analysis import CostCounter, analyze
from repro_torch.models import Model
from repro_torch.serve.output_layer import ivf_specs_for

FAMILIES = ("qwen1.5-4b", "gemma3-4b", "deepseek-moe-16b", "rwkv6-7b",
            "zamba2-7b")
OTHERS = ("llama-3.2-vision-90b", "musicgen-medium")
PREFILL = ShapeConfig("prefill_r", 64, 2, "prefill")
DECODE = ShapeConfig("decode_r", 64, 4, "decode")
TRAIN = ShapeConfig("train_r", 64, 2, "train")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the JAX side ---------------------------------------------------------


def jax_dot_flops(fn, *args) -> int:
    """Trip-aware dot FLOPs of ``fn``'s compiled HLO on one CPU device."""
    comps = parse_module(jax.jit(fn).lower(*args).compile().as_text())

    def trip(c):
        if c is None or c not in comps:
            return 1
        return max(comps[c].consts) if comps[c].consts else 1

    memo = {}

    def walk(name):
        if name in memo:
            return memo[name]
        comp, f = comps.get(name), 0
        for nm, _, op, line in (comp.instrs if comp else ()):
            if op == "dot":
                f += _dot_flops(line, comp.shapes[nm][0], comp)
            for kind, cond, callee in _called(line):
                f += (trip(cond) if kind == "while" else 1) * walk(callee)
        memo[name] = f
        return f
    return walk(next(n for n, c in comps.items() if c.entry))


def jax_step_flops(arch: str, sc: ShapeConfig) -> int:
    """JAX's prefill or decode step (its dry run's ``prefill_step`` and
    exact ``serve_step``) at the reduced config, one device."""
    cfg = jax_reduced(arch)
    m = JModel(cfg)
    sds = jax.ShapeDtypeStruct
    ps = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0)))
    img = (sds((sc.global_batch, cfg.n_image_tokens, cfg.d_model),
               jnp.dtype(cfg.dtype)) if cfg.family == "vlm" else None)
    c = cfg.n_codebooks

    def head(p, h):
        w = m.head_matrix(p)
        if c:
            logits = jnp.einsum("bd,cvd->bcv", h, w)
            return jax.nn.logsumexp(logits, -1), jnp.argmax(logits, -1)
        return jax_stream(h, w, chunk=cfg.vocab)

    if sc.kind == "prefill":
        tok = sds((sc.global_batch, sc.seq_len) + ((c,) if c else ()),
                  jnp.int32)

        def step(p, t, i):
            return head(p, m.forward(p, t, img=i)[0][:, -1])
        return jax_dot_flops(step, ps, tok, img)
    state = jax.eval_shape(lambda: m.init_decode_state(sc.global_batch,
                                                       sc.seq_len))
    tok = sds((sc.global_batch,) + ((c,) if c else ()), jnp.int32)

    def step(p, st, t, i):
        # the new state is an output, as in JAX's serve_step (else XLA
        # drops the products that only update it)
        h, new_state = m.decode_step(p, st, t, sc.seq_len - 1, img=i)
        return head(p, h), new_state
    return jax_dot_flops(step, ps, state, tok, img)


# -- the port's side --------------------------------------------------------


def port_counts(cfg, sc, mode="exact", shape=(1, 1), tags=False):
    with dryrun.fake_mesh(shape, ("data", "model")) as mesh:
        step = dryrun.build_step(cfg, sc, mesh, mode)
        with CostCounter(tags=tags) as c:
            c.track(step.inputs)
            step.run()
    return c


@pytest.mark.parametrize("sc", [PREFILL, DECODE], ids=lambda s: s.kind)
@pytest.mark.parametrize("arch", FAMILIES + OTHERS)
def test_flops_equal_jax_hlo_dots(arch, sc):
    got = port_counts(reduced_config(arch), sc).flops
    assert got == jax_step_flops(arch, sc), arch


def test_fused_ce_train_step_is_3_forwards_and_4_head_products():
    """JAX's step at this config counts 482,344,960 dot FLOPs, 138,412,032
    more: 8 more head products (134,217,728: its streaming CE computes
    the (T, V) product 12 times in forward and backward) and its flash
    attention's rematerialised QK product (4,194,304, under
    ``jax.checkpoint``), by the HLO's dots grouped by op_name."""
    cfg = reduced_config("qwen1.5-4b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((TRAIN.global_batch, TRAIN.seq_len),
                         dtype=torch.long)
    fwd = analyze(lambda: model.forward(params, tokens))["flops"]
    n_tok = TRAIN.global_batch * TRAIN.seq_len
    head = 2 * n_tok * cfg.vocab * cfg.d_model
    got = port_counts(cfg, TRAIN).flops
    assert got == 3 * fwd + 4 * head == 343_932_928


@pytest.mark.parametrize("m", [2, 4])
def test_split_train_step_flops_are_the_closed_form_over_m(m):
    """At mesh (1, m) the split step computes on the rank's heads, d_ff
    columns and vocab rows: its FLOPs are one device's closed form (3
    trunk forwards + 4 head products, above) divided by m."""
    got = port_counts(reduced_config("qwen1.5-4b"), TRAIN, shape=(1, m))
    assert got.flops * m == 343_932_928


def _placed_bytes(cfg, mesh_shape):
    """(the count of leaves split over 'model', the f32 bytes of this
    rank's slices of every leaf) by ``params_placements``."""
    from repro_torch.train.train_loop import params_placements
    with dryrun.fake_mesh(mesh_shape, ("data", "model")) as mesh:
        model = Model(cfg)
        meta = model.init(torch.Generator(), "meta")
        place = params_placements(model, mesh)
    from repro_torch.launch.mesh import placements_like
    from repro_torch.models.transformer import tree_leaves
    leaves = tree_leaves(meta)
    m = mesh_shape[1]
    n_split, local = 0, 0
    for x, p in zip(leaves, placements_like(meta, place)):
        cut = any(e is not None for e in p.spec)
        n_split += cut
        local += 4 * x.numel() // (m if cut else 1)
    return n_split, local


def test_collective_bytes_on_a_2x2_mesh():
    """The split train step gathers no leaf of qwen1.5-4b: its collectives
    are the activations' sums over 'model' (for each layer the attention's
    and the MLP's output forward and their input gradients backward,
    (T, d) f32 each), the vocab-parallel lookup ((T, d) bit patterns),
    the CE pair's (the label score and the LSE's two all-reduces of (T,)
    f32 forward, dh (T, d) f32 backward), the slices' squares for the
    norm (one f32 a split leaf); then every gradient slice averaged over
    'data' in f32 and the scalar metrics once. The exact decode step
    combines log Z (two all-reduces of (B,) f32) and gathers the top-1
    candidates ((2, B, 2) int32)."""
    cfg = dataclasses.replace(reduced_config("qwen1.5-4b"), dtype="float32")
    sc = ShapeConfig("t", 16, 4, "train")
    c = port_counts(cfg, sc, shape=(2, 2))
    n_split, grads = _placed_bytes(cfg, (2, 2))
    t = sc.global_batch // 2 * sc.seq_len                # the rank's tokens
    act = (4 * cfg.n_layers + 2) * t * cfg.d_model * 4 + 3 * t * 4
    n_metrics = c.collectives["all-reduce"] - act - 4 * n_split - grads
    assert 0 < n_metrics <= 4 * 16, c.collectives
    assert set(c.collectives) == {"all-reduce"}
    d = port_counts(cfg, ShapeConfig("d", 16, 4, "decode"), shape=(2, 2))
    lanes = 2
    assert dict(d.collectives) == {"all-reduce": 2 * 4 * lanes
                                   + 2 * lanes * 2 * 4}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_ivf_specs_for_matches_jax(arch):
    cfg = get_config(arch)
    pc = cfg.partition
    want = jax_ivf_specs_for(cfg.vocab, cfg.d_model, pc.block_rows,
                             jnp.dtype(cfg.dtype))
    got = ivf_specs_for(cfg.vocab, cfg.d_model, pc.block_rows,
                        getattr(torch, cfg.dtype))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.device.type == "meta"
        assert str(g.dtype).removeprefix("torch.") == {
            "bool": "bool"}.get(str(w.dtype), str(w.dtype))


def test_run_cell_full_width_decode(tmp_path):
    import torch.distributed as dist
    r = dryrun.run_cell("qwen1.5-4b", "decode_32k", "single",
                        out_dir=str(tmp_path))
    assert not dist.is_initialized()
    files = [p.relative_to(tmp_path) for p in tmp_path.rglob("*")
             if p.is_file()]
    assert [str(f) for f in files] == ["single/qwen1.5-4b__decode_32k.json"]
    assert json.loads((tmp_path / files[0]).read_text()) == r
    cfg = get_config("qwen1.5-4b")
    hd, s, lanes = cfg.resolved_head_dim, 32768, 8
    proj = cfg.d_model * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + \
        cfg.n_heads * hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff
    attn = 2 * cfg.n_heads * hd * s
    trunk = 2 * (proj + attn) * cfg.n_layers * lanes
    assert r["sections"]["trunk"]["flops"] == trunk == 158_125_260_800
    assert r["lanes_per_rank"] == lanes and r["n_chips"] == 256
    head = 2 * lanes * (cfg.vocab // 16) * cfg.d_model
    assert r["flops_per_device"] == trunk + head
    # KV 40 x 8 x 32768 x 20 x 128 x 2 bf16 + the weights live at once
    kv = 2 * cfg.n_layers * lanes * s * cfg.n_kv_heads * hd * 2
    assert r["peak_bytes_per_device"] > kv + 2 * cfg.param_count()
    assert r["collective_bytes"] == {"all-reduce": 2 * 4 * lanes
                                     + 16 * lanes * 2 * 4}


def test_long_500k_skipped_for_full_attention(tmp_path):
    r = dryrun.run_cell("qwen1.5-4b", "long_500k", "single",
                        out_dir=str(tmp_path))
    assert "skipped" in r and not any(tmp_path.iterdir())


def test_main_exits_nonzero_on_a_failed_cell(monkeypatch, tmp_path, capsys):
    def boom(*a, **k):
        raise RuntimeError("cannot trace")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", "qwen1.5-4b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert "[FAIL]" in capsys.readouterr().out


def test_breakdown_ranks_counts_by_tag():
    cfg = reduced_config("qwen1.5-4b")
    c = port_counts(cfg, DECODE, tags=True)
    flops = breakdown.meta_tag_counts(c, "flops")
    assert sum(flops.values()) == c.flops
    tags = {tag for tag, _ in flops}
    assert any("decode_self_attention" in t for t in tags)
    assert any(op == "kernel:topk_z" for _, op in flops)
    coll = breakdown.meta_tag_counts(c, "collective")
    assert sum(coll.values()) == sum(c.collectives.values())
    kinds = breakdown.count_by_kind(c)
    assert sum(k["flops"] for k in kinds.values()) == c.flops
    assert not [k for k in kinds if k.startswith("unmatched")]


def test_counter_bytes_views_and_peak():
    a = torch.zeros(256, 64)
    b = torch.zeros(64, 32)
    with CostCounter() as c:
        c.track((a, b))
        x = a @ b                       # 64 KB + 8 KB in, 32 KB out
        y = x.t().reshape(-1)           # views: nothing moves
        y.add_(1.0)                     # in place: 32 KB in, none out
        del x, y
        z = torch.zeros(1024, 1024)     # 4 MB written
        del z
    assert c.flops == 2 * 256 * 64 * 32
    assert c.by_op["aten.mm"]["bytes"] == 4 * (256 * 64 + 64 * 32
                                               + 256 * 32)
    assert "aten.t" not in c.by_op and "aten.view" not in c.by_op
    assert c.by_op["aten.add_"]["bytes"] == 4 * 256 * 32
    assert c.peak_bytes == 4 * (256 * 64 + 64 * 32 + 1024 * 1024)
    assert c.live_bytes == 4 * (256 * 64 + 64 * 32)


def test_kernel_call_counts_its_operands_not_the_plain_version():
    from repro_torch.kernels.ivf_score import ivf_score
    from repro_torch.kernels.topk_z import topk_z
    h = torch.randn(4, 32)
    w = torch.randn(1000, 32)
    blocks = torch.randn(16, 8, 32)
    ids = torch.tensor([[0, 1], [1, 2], [3, 3], [15, 0]], dtype=torch.int32)
    with CostCounter() as c:
        topk_z(h, w, 1)
        ivf_score(blocks, h, ids)
    assert set(c.by_op) == {"kernel:topk_z", "kernel:ivf_score"}
    tz = c.by_op["kernel:topk_z"]
    assert tz["flops"] == 2 * 4 * 1000 * 32 and tz["calls"] == 1
    assert tz["bytes"] == 4 * (4 * 32 + 1000 * 32) + 4 * 4 + 2 * 4 * 4
    # one tile of 4 queries x 2 probes: 8 blocks at most, 5 here read
    iv = c.by_op["kernel:ivf_score"]
    assert iv["bytes"] == 8 * 8 * 32 * 4 + 4 * 4 * 32 + 4 * 8 + 4 * 2 * 8 * 4
    assert topk_z.launches == 0 and ivf_score.launches == 0


def test_train_microbatches_extrapolate_exactly():
    """A train cell of more than 2 microbatches is traced at 2 and its
    second microbatch added for each further one: the same counts as the
    whole step traced."""
    cfg = reduced_config("qwen1.5-4b")
    sc = ShapeConfig("t", 16, 5, "train")
    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        got = dryrun.count_cell(cfg, sc, mesh)
        whole = dryrun.count_step(dryrun.build_step(cfg, sc, mesh))
    assert got["traced_microbatches"] == 2 and got["microbatches"] == 5
    for k in ("flops", "bytes", "transcendentals", "collectives"):
        assert got[k] == whole[k], k


def test_train_microbatches_extrapolate_the_split_collectives():
    """Under the compute split (mesh (1, 2)) each microbatch issues its
    own all-reduces over 'model': extrapolated from 2 microbatches, the
    counts and collective bytes equal the whole step's traced at 5."""
    cfg = reduced_config("qwen1.5-4b")
    sc = ShapeConfig("t", 16, 5, "train")
    with dryrun.fake_mesh((1, 2), ("data", "model")) as mesh:
        got = dryrun.count_cell(cfg, sc, mesh)
        whole = dryrun.count_step(dryrun.build_step(cfg, sc, mesh))
    assert got["traced_microbatches"] == 2
    assert whole["sections"]["microbatch 4"]["collective_bytes"] > 0
    for k in ("flops", "bytes", "transcendentals", "collectives"):
        assert got[k] == whole[k], k


@pytest.mark.parametrize("sc", [PREFILL, TRAIN], ids=lambda s: s.kind)
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_scan_trips_count_the_whole_loop(arch, sc):
    """``CostCounter(trips=True)`` runs two steps of a ``scan`` and counts
    one for every step but the last: the same products and
    transcendentals as the whole loop, and in a prefill the same bytes;
    a train step's backward sums the steps' gradients once (fewer
    bytes)."""
    cfg = reduced_config(arch)
    got = []
    for trips in (False, True):
        with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
            step = dryrun.build_step(cfg, sc, mesh)
            with CostCounter(trips=trips) as c:
                step.run()
        got.append(c.summary())
    whole, trips = got
    assert trips["flops"] == whole["flops"]
    assert trips["transcendentals"] == whole["transcendentals"]
    if sc.kind == "prefill":
        assert trips["bytes"] == whole["bytes"]
    else:
        assert 0.85 * whole["bytes"] < trips["bytes"] <= whole["bytes"]
