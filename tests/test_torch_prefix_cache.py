"""The port's prefix pool against the JAX package's (f32, CPU).

Unit: the same sequence of inserts, matches and loads on both pools over
the same KV contents gives the same matches, block ids, owners, counters,
evictions (LRU over leaves, a parent with a live child pinned), pool
contents and loaded lanes. Scheduler: the JAX serving tests' engine
(``_torch_serving``) serves two waves of shared-prefix prompts through a
pool of 2-token blocks, with the JAX scheduler's draws injected; tokens,
steps and the pool's hits, saved replay steps and inserts equal JAX's, and
equal the no-pool run's tokens on the cold and the warm pool. The pool
copies into the scheduler's own cache tensors in place."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serving as S
from repro.serve import Scheduler as JScheduler
from repro.serve import Server as JServer
from repro.serve import trace_arrivals as j_trace_arrivals
from repro.serve.prefix_cache import PrefixPool as JPrefixPool
from repro_torch.serve import Request, Scheduler, Server, trace_arrivals
from repro_torch.serve.prefix_cache import PrefixPool, cache_is_kv_only


def _leaf(batch=2, t=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, t, 1, 4)).astype(np.float32)


def _pools(n_blocks=4, block_tokens=2, max_match=4, t=16):
    template = _leaf(t=t)
    jp = JPrefixPool({"layers": [{"k": jnp.asarray(template),
                                  "v": jnp.asarray(template)}]}, n_blocks,
                     block_tokens, max_match)
    tp = PrefixPool({"k": torch.from_numpy(template.copy()),
                     "v": torch.from_numpy(template.copy())}, n_blocks,
                    block_tokens, max_match)
    return jp, tp


def _caches(seed, t=16):
    k, v = _leaf(t=t, seed=seed), _leaf(t=t, seed=seed + 100)
    return ({"layers": [{"k": jnp.asarray(k), "v": jnp.asarray(v)}]},
            {"k": torch.from_numpy(k), "v": torch.from_numpy(v)})


def _same_pool(jp, tp):
    assert tp.stats() == {k: v for k, v in jp.stats().items()}
    assert tp._node == jp._node and tp._children == jp._children
    assert tp._lru == jp._lru
    for name in ("k", "v"):
        np.testing.assert_array_equal(tp.pool[name].numpy(),
                                      np.asarray(jp.pool["layers"][0][name]))


def test_insert_match_load_equal_jax():
    jp, tp = _pools()
    prompts = [[3, 1, 4, 1, 5], [3, 1, 9, 9, 9], [2, 7, 1, 8, 2, 8],
               [3, 1, 4, 1, 5, 9, 2]]
    for i, p in enumerate(prompts):
        jc, tc = _caches(i)
        lane = i % 2
        toks = np.asarray(p, np.int32)
        assert tp.insert(toks, len(p), tc, lane) == \
            jp.insert(toks, len(p), jc, lane)
        _same_pool(jp, tp)
    for p in prompts + [[3, 1, 4, 0, 0], [6, 6]]:
        toks = np.asarray(p, np.int32)
        assert tp.match(toks, len(p)) == jp.match(toks, len(p))
    toks = np.asarray(prompts[3], np.int32)
    _, ids, _ = jp.match(toks, 7)
    assert tp.match(toks, 7)[1] == ids
    jc, tc = _caches(50)
    jout = jp.load(jc, ids, 1)
    tout = tp.load(tc, ids, 1)
    assert tout is tc                             # in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(),
                                      np.asarray(jout["layers"][0][name]))
    _same_pool(jp, tp)
    assert tp.hits == 1 and tp.saved_steps == 2 * len(ids)


def test_refcounted_eviction_equals_jax():
    jp, tp = _pools()
    rng = np.random.default_rng(1)
    jc, tc = _caches(3)
    seqs = [np.asarray([1, 2, 3, 4, 0], np.int32)] + [
        rng.integers(0, 100, 5).astype(np.int32) for _ in range(6)]
    for toks in seqs:
        assert tp.insert(toks, 5, tc, 0) == jp.insert(toks, 5, jc, 0)
        tp.match(seqs[0], 5)
        jp.match(seqs[0], 5)
        _same_pool(jp, tp)
    assert tp.evictions > 0 and tp.n_cached_blocks <= 4
    for bid, (parent, _) in list(tp._key_of.items()):
        while parent >= 0:
            assert parent in tp._key_of
            parent = tp._key_of[parent][0]


def test_full_pool_of_protected_blocks_degrades():
    jp, tp = _pools(n_blocks=2, max_match=8, t=32)
    jc, tc = _caches(4, t=32)
    toks = np.arange(10, dtype=np.int32)
    assert tp.insert(toks, 10, tc, 0) == jp.insert(toks, 10, jc, 0) == 2
    assert tp.match(toks, 10) == jp.match(toks, 10)
    assert tp.match(toks, 10)[0] == jp.match(toks, 10)[0] == 2
    _same_pool(jp, tp)


def test_kv_only_and_refusals():
    leaf = torch.zeros((2, 16, 1, 4))
    assert cache_is_kv_only({"k": leaf, "v": leaf})
    assert not cache_is_kv_only({"k": leaf, "conv": leaf})
    assert not cache_is_kv_only({"k": torch.zeros((2, 16))})
    assert not cache_is_kv_only({})
    with pytest.raises(NotImplementedError, match="KV"):
        PrefixPool({"k": leaf, "s": leaf}, 4, 2, 2)
    with pytest.raises(ValueError, match="divide the data degree"):
        PrefixPool({"k": leaf}, 5, 2, 2, n_replicas=2)
    with pytest.raises(ValueError, match="n_blocks"):
        PrefixPool({"k": leaf}, 0, 2, 2)


PREFIX = [11, 12, 13, 14, 15, 16]


@pytest.fixture(scope="module")
def run():
    jeng, teng = S.engines()
    pc = teng.cfg.partition
    key = jax.random.PRNGKey(12)

    def wave(base):
        return [S.pair(PREFIX + [base + i] * (1 + i % 3), 3 + i % 2,
                       700 + i, pc.sample_k, temperature=(0.0, 0.7)[i % 2])
                for i in range(4)]

    waves = [wave(20), wave(20)]
    at = [0, 0, 1, 2]
    jsched = JScheduler(jeng, n_slots=3, key=key, prefix_cache_blocks=8,
                        prefix_block_tokens=2)
    tsched = Scheduler(teng, 3, prefix_cache_blocks=8, prefix_block_tokens=2,
                       tail_source=S.tail_source(key, pc.l, S.VOCAB))
    ptrs = [t.data_ptr() for _, t in tsched._storage()]
    reps = []
    for w in waves:
        reps.append((JServer(jsched).run(arrivals=j_trace_arrivals(
            [p[0] for p in w], at)), Server(tsched).run(
                arrivals=trace_arrivals([p[1] for p in w], at))))
    return dict(teng=teng, waves=waves, reps=reps, at=at, tsched=tsched,
                ptrs=ptrs, key=key)


@pytest.mark.parametrize("i", [0, 1], ids=["cold", "warm"])
def test_prefix_runs_equal_jax(run, i):
    w, (jrep, trep) = run["waves"][i], run["reps"][i]
    jc = S.by_request(jrep, [p[0] for p in w])
    tc = S.by_request(trep, [p[1] for p in w])
    for a, b in zip(jc, tc):
        assert b.tokens == a.tokens
        np.testing.assert_allclose(b.log_zs, a.log_zs, rtol=1e-5)
    assert trep.prefix == jrep.prefix and trep.steps == jrep.steps
    if i:
        assert trep.prefix["hits"] > 0 and trep.prefix["saved_steps"] > 0
        assert trep.steps < run["reps"][0][1].steps


def test_prefix_runs_equal_the_plain_run(run):
    pc = run["teng"].cfg.partition
    plain = [p[1] for p in run["waves"][0]]
    plain = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                     temperature=r.temperature, gumbel=r.gumbel)
             for r in plain]
    rep = Server(Scheduler(run["teng"], 3, tail_source=S.tail_source(
        run["key"], pc.l, S.VOCAB))).run(
        arrivals=trace_arrivals(plain, run["at"]))
    want = [c.tokens for c in S.by_request(rep, plain)]
    for w, (_, trep) in zip(run["waves"], run["reps"]):
        assert [c.tokens for c in S.by_request(
            trep, [p[1] for p in w])] == want
    assert [t.data_ptr() for _, t in run["tsched"]._storage()] == \
        run["ptrs"]
