"""The port's ``generate`` on its step runner (f32, CPU; qwen1.5-4b reduced
to 2 layers, vocab 2048). On the CPU the runner's step, the one a GPU
captures in a CUDA graph, runs eagerly from its device buffers; it must
give ``host_loop=True``'s tokens, log_prob and log_z bit for bit for every
serving method at temperature 0 and above, with one runner for every
prompt length and ``n_tokens``. ``swap_index``, ``restore_index`` and
``_install_state`` drop the runners. The step clamps a position past
``max_len`` and flags it when called as under a capture, and raises
otherwise. The lsh decode's trimmed-or-dense choice, made on the device
(``device_cands``), takes JAX's ``lax.cond`` branch and gives its outputs
(JAX's ``lsh_probe`` in interpret mode) on both branches: LSEs and log Ẑ
to 1e-4, top ids equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro_torch.configs import reduced_config
from repro_torch.core import lsh as tlsh
from repro_torch.interop import lsh_from_numpy
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeState, generate
from repro_torch.serve import engine as engine_mod

ATOL = 1e-4
METHODS = ["exact", "mimps", "selfnorm", "topk", "mince", "fmbe", "lsh"]
MAX_LEN = 16


def _cfg(method):
    cfg = reduced_config("qwen1.5-4b")
    return dataclasses.replace(
        cfg, vocab=2048, dtype="float32", partition=dataclasses.replace(
            cfg.partition, method=method, block_rows=128, n_probe=4, l=64,
            fmbe_features=64))


@pytest.fixture(scope="module")
def params():
    cfg = _cfg("exact")
    return Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")


def _engine(method, params, **kw):
    return Engine(Model(_cfg(method)), params, MAX_LEN, seed=1,
                  device="cpu", **kw)


def _prompt(b=3, t=4, seed=2):
    return np.random.default_rng(seed).integers(0, 2048, (b, t))


def _both(eng, prompt, n, **kw):
    eng.generator.manual_seed(5)
    run = generate(eng, prompt, n, return_aux=True, **kw)
    eng.generator.manual_seed(5)
    host = generate(eng, prompt, n, return_aux=True, host_loop=True, **kw)
    return run, host


def _assert_bit_equal(run, host):
    assert torch.equal(run[0], host[0])
    for name in ("log_prob", "log_z"):
        assert torch.equal(run[1][name], host[1][name]), name


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("method", METHODS)
def test_runner_equals_host_loop(params, method, temperature):
    eng = _engine(method, params)
    run, host = _both(eng, _prompt(), 4, temperature=temperature)
    _assert_bit_equal(run, host)
    assert run[0].shape == (3, 4)
    assert eng.captures == 0                   # no graph on the CPU


def test_one_runner_serves_every_length(params):
    eng = _engine("mimps", params)
    for t, n in ((2, 5), (5, 3), (5, 5)):
        _assert_bit_equal(*_both(eng, _prompt(t=t), n))
    assert len(eng._graph_runners) == 1


def test_temperature_is_data(params):
    """A temperature change reuses the runner; at temperature 0 the noise
    is never drawn, so the generator does not move."""
    eng = _engine("exact", params)
    generate(eng, _prompt(), 3, temperature=0.7)
    before = eng.generator.get_state()
    generate(eng, _prompt(), 3)
    assert torch.equal(eng.generator.get_state(), before)
    assert len(eng._graph_runners) == 1


def test_tail_source_feeds_the_runner(params):
    """Injected tail draws (the JAX key schedule's step ids) reach both
    loops, and the engine's generator is not used for them."""
    eng = _engine("mince", params)
    ids = []

    def source(step_id):
        ids.append(step_id)
        return np.random.default_rng(step_id).integers(0, 2048, 64)

    before = eng.generator.get_state()
    run = generate(eng, _prompt(t=3), 3, tail_source=source,
                   return_aux=True)
    assert ids == [0, 1, 2, 10_000, 10_001]
    assert torch.equal(eng.generator.get_state(), before)
    host = generate(eng, _prompt(t=3), 3, tail_source=source,
                    return_aux=True, host_loop=True)
    _assert_bit_equal(run, host)


@pytest.mark.parametrize("how", ["swap", "restore", "install_state"])
def test_state_changes_drop_the_runners(params, how):
    eng = _engine("mimps", params, device_index=True)
    generate(eng, _prompt(), 2)
    assert eng._graph_runners
    if how == "swap":
        eng.swap_index(params)
    elif how == "restore":
        eng.restore_index()
    else:
        eng._install_state(dataclasses.replace(eng.state))
    assert not eng._graph_runners
    _assert_bit_equal(*_both(eng, _prompt(), 2))


def test_guard_toggle_takes_its_own_runner(params):
    eng = _engine("mimps", params)
    generate(eng, _prompt(), 2)
    eng.health_guard = True
    generate(eng, _prompt(), 2)
    assert len(eng._graph_runners) == 2


def test_overflow_clamps_under_capture_and_raises_eagerly(params,
                                                          monkeypatch):
    eng = _engine("exact", params)
    b = 2
    cache = eng.model.init_decode_state(b, MAX_LEN, "cpu")
    tok = torch.tensor([3, 4])
    over = ServeState(cache=cache, last_token=tok,
                      pos=torch.tensor([MAX_LEN - 1, MAX_LEN],
                                       dtype=torch.int32))
    with pytest.raises(ValueError, match="max_len"):
        eng.decode_step(over)
    monkeypatch.setattr(engine_mod, "_capturing", lambda dev: True)
    out, new = eng.decode_step(over)
    assert out["overflow"].tolist() == [False, True]
    assert new.pos.tolist() == [MAX_LEN, MAX_LEN + 1]
    # the clamped lane wrote and read the last slot, as the lane at
    # MAX_LEN - 1 did: the same token on the same cache gives the same step
    last = ServeState(cache=eng.model.init_decode_state(b, MAX_LEN, "cpu"),
                      last_token=tok,
                      pos=torch.full((b,), MAX_LEN - 1, dtype=torch.int32))
    want, _ = eng.decode_step(last)
    assert torch.equal(out["log_z"], want["log_z"])
    assert torch.equal(out["token"], want["token"])


def test_temperature_tensor_needs_its_noise(params):
    eng = _engine("exact", params)
    h = torch.zeros((2, eng.cfg.d_model))
    with pytest.raises(ValueError, match="gumbel"):
        eng.next_token_distribution(h, torch.tensor(0.5))


def _lsh_data(v=2048, d=32, q=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d))
    w = centers[rng.integers(0, 16, v)] + 0.5 * rng.standard_normal((v, d))
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * np.sqrt(d) * 0.35
    h = 0.4 * rng.standard_normal((q, d))
    return w.astype(np.float32), h.astype(np.float32)


@pytest.mark.parametrize("branch", ["trimmed", "dense"])
def test_lsh_device_branch_matches_jax_cond(branch):
    w, h = _lsh_data()
    v = w.shape[0]
    j = jlsh.build_lsh_device(jax.random.PRNGKey(3), jnp.asarray(w),
                              n_bits=4, n_tables=8, bucket_cap=64,
                              tail_beta=16.0)
    idx = lsh_from_numpy(*(np.asarray(a) for a in j), device="cpu")
    key = jax.random.PRNGKey(8)
    jplan = jlsh.lsh_plan(j, jnp.asarray(h), key, 64)
    live = int(jplan.cand_live)
    cap = live + 64 if branch == "trimmed" else max(8, live // 4)
    plan = tlsh.lsh_plan(idx, torch.from_numpy(h), 64, cand_cap=cap,
                         tail_ids=torch.from_numpy(np.array(jplan.tail_ids)))
    rows, n_live = tlsh.device_cands(plan)
    assert rows.shape == (v,)
    if branch == "trimmed":
        assert int(n_live) == live
        assert torch.equal(rows[:cap], plan.cand_rows)
        assert not rows[cap:].any()
    else:
        assert int(n_live) == v
        assert torch.equal(rows, torch.arange(v, dtype=torch.int32))
    jo = jlsh.lsh_decode(j, jnp.asarray(w), jnp.asarray(h), key, l=64, k=4,
                         cand_cap=cap, use_pallas=True, interpret=True)
    to = tlsh.lsh_decode(idx, torch.from_numpy(w), torch.from_numpy(h),
                         l=64, k=4, cand_cap=cap, use_kernel=True,
                         tail_ids=torch.from_numpy(np.array(jplan.tail_ids)))
    for name in ("log_z", "head_lse", "tail_lse", "top_score"):
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name)), atol=ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(to.top_id.numpy(), np.asarray(jo.top_id))
