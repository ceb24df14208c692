"""The port's ``CheckpointManager`` (``repro_torch.train.checkpoint``), as
the JAX package's ``tests/test_infra.py::TestCheckpoint`` holds its own:
the round trip of a training state with its index and generator, a resume
bit-identical to the uninterrupted run, atomic writes, keep-K and the
writer thread; and the manifest's configuration fingerprint and data
state. On the CPU: every step here is bit-reproducible.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, reduced_config
from repro_torch.data import DataIterator, DataState, SyntheticCorpus
from repro_torch.models import Model
from repro_torch.train import (CheckpointManager, init_train_state,
                               make_index_refresh, make_train_step)
from repro_torch.train.checkpoint import _flatten, config_fingerprint


def _cfg():
    cfg = reduced_config("qwen1.5-4b")
    return dataclasses.replace(cfg, vocab=2048, partition=dataclasses.replace(
        cfg.partition, block_rows=64, n_probe=4, l=64, n_clusters=8,
        lsh_bits=4, lsh_tables=6))


def _equal_states(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), k
        elif torch.is_tensor(x):
            assert x.dtype == y.dtype and x.device == y.device, k
            assert torch.equal(x, y), k
        else:
            assert type(x) is type(y) and x == y, k


def _batches(vocab, n):
    it = DataIterator(SyntheticCorpus(vocab, seed=3), 2, 16)
    return it, [{k: torch.from_numpy(v) for k, v in
                 zip(("tokens", "labels"), next(it))} for _ in range(n)]


@pytest.mark.parametrize("loss", ["mimps_ce", "lsh_ce", "fused_ce"])
def test_roundtrip_and_resume_bit_identical(loss, tmp_path):
    """Save after two steps (and, for an estimator loss, a refresh, so the
    saved index is not the initial one), restore: the state equals the
    saved one bit for bit (parameters, moments, step, index with its int
    fields, generator); the next step from the restore equals the next
    step of the uninterrupted run bit for bit."""
    cfg = _cfg()
    model = Model(cfg)
    tc = TrainConfig(loss=loss, lr=1e-3, warmup_steps=1)
    state = init_train_state(model, tc, 0, device="cpu")
    step = make_train_step(model, tc)
    it, batches = _batches(cfg.vocab, 3)
    for b in batches[:2]:
        state, _ = step(state, b)
    if loss != "fused_ce":
        state, _ = make_index_refresh(model, tc)(state)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    fp = config_fingerprint(cfg, tc)
    mgr.save(2, state, config=fp, data_state=it.state.to_dict())
    restored, manifest = mgr.restore(None, like=state, config=fp)
    assert manifest["step"] == 2 and manifest["config"] == fp
    assert DataState.from_dict(manifest["data"]).step == 3
    _equal_states(state, restored)
    assert restored.opt.step == 2 and isinstance(restored.opt.step, int)
    if loss != "fused_ce":
        assert type(restored.index) is type(state.index)
    uninterrupted, m1 = step(state, batches[2])
    resumed, m2 = step(restored, batches[2])
    assert torch.equal(m1["loss_total"], m2["loss_total"])
    _equal_states(uninterrupted, resumed)


def test_restore_refuses_another_config(tmp_path):
    cfg = _cfg()
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    state = {"w": torch.ones(3)}
    mgr.save(1, state, config=config_fingerprint(cfg))
    other = dataclasses.replace(cfg, vocab=4096)
    assert config_fingerprint(other) != config_fingerprint(cfg)
    with pytest.raises(ValueError, match="configuration"):
        mgr.restore(None, like=state, config=config_fingerprint(other))
    restored, _ = mgr.restore(None, like=state,
                              config=config_fingerprint(cfg))
    assert torch.equal(restored["w"], state["w"])


def test_bf16_and_dtypes_roundtrip(tmp_path):
    """bf16 leaves are stored as f32 (exact) and come back as bf16; ints,
    bools and None come back as they were."""
    g = torch.Generator().manual_seed(5)
    state = {"w": torch.randn(4, 8, generator=g).bfloat16(),
             "i": torch.arange(5, dtype=torch.int32),
             "m": torch.tensor([True, False]), "n": 7, "none": None,
             "rng": g}
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(3, state)
    restored, _ = mgr.restore(3, like=state)
    _equal_states({k: v for k, v in state.items() if k != "none"},
                  {k: v for k, v in restored.items() if k != "none"})
    assert restored["none"] is None
    assert torch.equal(torch.rand(3, generator=restored["rng"]),
                       torch.rand(3, generator=state["rng"]))


def test_atomicity_torn_write_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    state = {"w": torch.ones(3)}
    mgr.save(1, state)
    # a torn write: a step directory without its manifest
    os.makedirs(tmp_path / "step_0000000002")
    assert mgr.latest_step() == 1
    _, manifest = mgr.restore(None, like=state)
    assert manifest["step"] == 1
    assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in range(5):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    assert mgr.all_steps() == [3, 4]
    restored, _ = mgr.restore(3, like={"w": torch.zeros(2)})
    assert torch.equal(restored["w"], torch.full((2,), 3.0))


def test_async_write_snapshots_at_save(tmp_path):
    """The writer thread writes the values of the call, not later ones
    (the train step updates parameters in place)."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    w = torch.arange(4.0)
    mgr.save(7, {"w": w})
    w.add_(100.0)
    mgr.wait()
    assert mgr.latest_step() == 7
    restored, _ = mgr.restore(7, like={"w": w})
    assert torch.equal(restored["w"], torch.arange(4.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(None, like={})
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(4.0))
