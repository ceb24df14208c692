"""Shared setup of the family parity tests (gemma3, RWKV6, Zamba2, the
VLM and the configs no card run has served): a
reduced config in f32 on both sides, the JAX init carried into the port by
``interop.params_from_numpy``, and the checks each family runs against the
JAX package on the same numpy inputs: the init tree, ``forward``, decode
steps state leaf by state leaf, ``generate`` on the JAX draws and the slot
scheduler on the JAX scheduler's draws. A VLM's checks take its image
``img`` as a numpy array."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_serving as S
from repro.configs import reduced_config as j_reduced_config
from repro.models import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import Server as JServer
from repro.serve import generate as j_generate
from repro.serve import trace_arrivals as j_trace_arrivals
from repro_torch.configs import reduced_config
from repro_torch.interop import decode_state_to_numpy, params_from_numpy
from repro_torch.models import Model
from repro_torch.serve import Engine, Scheduler, Server, generate
from repro_torch.serve import trace_arrivals


def cfgs(arch, method="mimps", **kw):
    """(JAX config, port config): the reduced config at f32 with the
    serving tests' vocab and partition (vocab 1024, blocks of 64, n_probe
    4, l 64) at ``method``."""
    return tuple(dataclasses.replace(
        c, dtype="float32", vocab=S.VOCAB, partition=dataclasses.replace(
            c.partition, method=method, block_rows=64, n_probe=4, l=64),
        **kw) for c in (r(arch) for r in (j_reduced_config,
                                          reduced_config)))


def build(arch, **kw):
    """The family's reduced model in both packages on one JAX init."""
    jcfg, tcfg = cfgs(arch, **kw)
    jm = JModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(5))
    npp = jax.tree.map(np.asarray, jp)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jm=jm, jp=jp, npp=npp,
                tm=Model(tcfg), tp=params_from_numpy(npp, tcfg,
                                                     device="cpu"))


def leaves(tree):
    """{path: array} of a JAX or numpy tree (the port's trees compare after
    ``decode_state_to_numpy``)."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def shape_tree(tree):
    return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)
                                      .removeprefix("torch."))
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def init_shapes(arch):
    """(the port's bf16 init, JAX's ``eval_shape``) leaf by leaf, at the
    reduced config as it is."""
    jcfg, tcfg = j_reduced_config(arch), reduced_config(arch)
    jp = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    tp = Model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    return shape_tree(tp), shape_tree(jp)


def rel_err(got, want):
    """max |got - want| over max(1, max |want|): a leaf compared relative
    to its magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _imgs(img):
    """(JAX image, port image) of a numpy image, or (None, None)."""
    if img is None:
        return None, None
    return jnp.asarray(img), torch.from_numpy(img)


def forward_err(m, toks, img=None):
    jimg, timg = _imgs(img)
    jh, _ = jax.jit(m["jm"].forward)(m["jp"], jnp.asarray(toks), img=jimg)
    th, _ = m["tm"].forward(m["tp"], torch.from_numpy(toks), img=timg)
    return rel_err(th.numpy(), jh)


def decode_errs(m, toks, max_len, img=None):
    """Both models step through ``toks`` (B, steps) from zero states: the
    worst hidden error of any step, and each state leaf's worst error
    relative to its magnitude over the steps."""
    b, steps = toks.shape
    jimg, timg = _imgs(img)
    jstate = m["jm"].init_decode_state(b, max_len)
    tstate = m["tm"].init_decode_state(b, max_len, "cpu")
    step = jax.jit(m["jm"].decode_step)
    h_err, leaf_err = 0.0, {}
    for pos in range(steps):
        jh, jstate = step(m["jp"], jstate, jnp.asarray(toks[:, pos]),
                          jnp.asarray(pos, jnp.int32), img=jimg)
        th = m["tm"].decode_step(m["tp"], tstate,
                                 torch.from_numpy(toks[:, pos]), pos,
                                 img=timg)
        h_err = max(h_err, rel_err(th.float().numpy(), jh))
        # the JAX dense and MoE state {"kv": {"k", "v"}} is the port's
        # flat {"k", "v"} (interop.decode_state_from_numpy)
        jl = leaves(jstate["kv"] if set(jstate) == {"kv"} else jstate)
        tl = leaves(decode_state_to_numpy(tstate))
        assert jl.keys() == tl.keys()
        for name in jl:
            assert tl[name].shape == jl[name].shape, name
            leaf_err[name] = max(leaf_err.get(name, 0.0),
                                 rel_err(tl[name], jl[name]))
    return h_err, leaf_err


def engines(m, method, max_len):
    """(JAX engine, port engine) of ``build``'s model at ``method``, on the
    same params and index."""
    jcfg, tcfg = (dataclasses.replace(c, partition=dataclasses.replace(
        c.partition, method=method)) for c in (m["jcfg"], m["tcfg"]))
    jeng = JEngine(JModel(jcfg), m["jp"], max_len=max_len)
    assign = None if jeng.index is None else \
        torch.from_numpy(np.array(jeng.index.assign))
    teng = Engine(Model(tcfg), m["tp"], max_len, device="cpu",
                  index_assign=assign)
    return jeng, teng


def _tail_source(key, l, n):
    """The JAX engine's tail draw of step ``step_id``."""
    def source(step_id):
        k_est = jax.random.split(jax.random.fold_in(key, step_id))[0]
        return np.array(jax.random.randint(k_est, (l,), 0, n))
    return source


def generate_pair(m, method, prompt_len, n_new, max_len):
    """``generate`` in both packages on the JAX draws: (JAX tokens, port
    tokens, JAX log Ẑ, port log Ẑ)."""
    jeng, teng = engines(m, method, max_len)
    key = jax.random.PRNGKey(9)
    prompt = np.random.default_rng(5).integers(0, S.VOCAB, (3, prompt_len))
    jt, jaux = j_generate(jeng, jnp.asarray(prompt, jnp.int32), n_new, key,
                          return_aux=True)
    tt, taux = generate(teng, prompt, n_new, return_aux=True,
                        tail_source=_tail_source(key, 64, S.VOCAB))
    return (np.asarray(jt), tt.numpy(), np.asarray(jaux["log_z"]),
            taux["log_z"].numpy())


def scheduler_pair(m, max_len, reqs, at, n_slots=3):
    """The same staggered trace through the JAX scheduler and the port's
    (mimps, the JAX scheduler's tail draws and each request's noise
    injected). ``reqs`` is [(prompt length, new tokens, temperature)].
    Returns (JAX completions, port completions, port engine, port
    requests), both in trace order."""
    jeng, teng = engines(m, "mimps", max_len)
    pc = teng.cfg.partition
    rng = np.random.default_rng(7)
    pairs = [S.pair(rng.integers(0, S.VOCAB, p), n, 60 + i, pc.sample_k,
                    temperature=t) for i, (p, n, t) in enumerate(reqs)]
    key = jax.random.PRNGKey(3)
    jrep = JServer(JScheduler(jeng, n_slots=n_slots, key=key)).run(
        arrivals=j_trace_arrivals([p[0] for p in pairs], at))
    trep = Server(Scheduler(teng, n_slots, tail_source=S.tail_source(
        key, pc.l, S.VOCAB))).run(
        arrivals=trace_arrivals([p[1] for p in pairs], at))
    assert trep.steps == jrep.steps
    return (S.by_request(jrep, [p[0] for p in pairs]),
            S.by_request(trep, [p[1] for p in pairs]), teng,
            [p[1] for p in pairs])
