"""The training mesh on the card, at a small width (qwen1.5-4b reduced to
its test size, bf16).

* A one-rank NCCL group, mesh (1, 1): two sharded fused_ce steps from
  ``init_train_state(mesh=)`` equal two one-device steps from the same seed
  bit for bit (every leaf of the parameters, m and v, and each step's loss
  and grad norm), and every step of both launches each fused CE kernel
  once.
* ``compress_psum`` over the one-rank group: int8 gives the quantised
  gradient (the same arithmetic on the host) and issues one int32
  all-reduce; none returns the gradient's bits.

These tests need a GPU and skip without one. On the GPU machine, which has
no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_cuda_train_mesh.py
"""
import dataclasses
import datetime

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_2d
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh_2d((1, 1))
    finally:
        dist.destroy_process_group()


def _whole(model, state, mesh):
    from repro_torch.launch.mesh import gather_tree
    from repro_torch.models.transformer import tree_paths
    from repro_torch.train import params_placements
    out = {}
    for part, tree in (("params", state.params), ("m", state.opt.m),
                       ("v", state.opt.v)):
        if mesh is not None:
            tree = gather_tree(tree, params_placements(model, mesh))
        for path, leaf in tree_paths(tree):
            out[part + path] = leaf.detach().clone()
    return out


def _steps(model, tc, batches, mesh=None):
    from repro_torch.kernels.fused_ce import fused_ce_bwd, fused_ce_fwd
    from repro_torch.train import init_train_state, make_train_step
    state = init_train_state(model, tc, 0, "cuda", mesh=mesh)
    step = make_train_step(model, tc, mesh=mesh)
    logs = []
    for batch in batches:
        fused_ce_fwd.launches = fused_ce_bwd.launches = 0
        state, met = step(state, batch)
        torch.cuda.synchronize()
        assert (fused_ce_fwd.launches, fused_ce_bwd.launches) == (1, 1)
        logs.append((met["loss_total"].item(), met["grad_norm"].item()))
    return _whole(model, state, mesh), logs


def test_one_rank_nccl_step_equals_one_device(nccl_mesh):
    from repro_torch.configs import TrainConfig, reduced_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.models import Model
    cfg = dataclasses.replace(reduced_config("qwen1.5-4b"), vocab=2048,
                              dtype="bfloat16")
    model = Model(cfg)
    tc = TrainConfig(loss="fused_ce", warmup_steps=1)
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), 4, 32)
    batches = [{k: torch.from_numpy(a).cuda()
                for k, a in zip(("tokens", "labels"), next(it))}
               for _ in range(2)]
    got, logs = _steps(model, tc, batches, nccl_mesh)
    want, ref_logs = _steps(model, tc, batches)
    assert logs == ref_logs
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].view(torch.uint8), want[k].view(
            torch.uint8)), k


def test_compress_psum_on_one_rank(nccl_mesh):
    import torch.distributed as dist
    from repro_torch.launch.mesh import axis_group
    from repro_torch.train import compress_psum
    group = axis_group(nccl_mesh, "data")
    g = (torch.randn((3, 1000), generator=torch.Generator().manual_seed(2))
         * 0.1).to(torch.bfloat16)
    calls, real = [], dist.all_reduce

    def counted(t, *args, **kwargs):
        calls.append(t.dtype)
        return real(t, *args, **kwargs)
    dist.all_reduce = counted
    try:
        (q,) = compress_psum([g.cuda()], group, "int8")
        (s,) = compress_psum([g.cuda()], group, "none")
    finally:
        dist.all_reduce = real
    gf = g.float()
    scale = (gf.abs().max() + 1e-12) / torch.tensor(127.0)
    q8 = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int32)
    want = (q8.float() * scale).to(torch.bfloat16)    # -0.0 comes back 0.0
    bad = (q.cpu().view(torch.int16) != want.view(torch.int16)).nonzero()
    assert len(bad) == 0, (len(bad), [(gf[tuple(i)].item(),
                                       q.cpu()[tuple(i)].item(),
                                       want[tuple(i)].item())
                                      for i in bad[:4].tolist()],
                           scale.item())
    assert torch.equal(s.cpu().view(torch.int16), g.view(torch.int16))
    assert calls == [torch.float32, torch.int32, torch.bfloat16]
