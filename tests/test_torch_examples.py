"""The port's five examples (``repro_torch.examples``), each ``main`` at a
tiny size on the CPU and held to its own contract: quickstart's exact row
has relative error 0 and every estimate is finite; serve_sublinear serves
every method and MIMPS's log Z is near the exact one; serve_traffic's slot
tokens equal each request's solo ``generate``, with the prefix pool and
speculation too; train_sublinear's swapped engine serves a fresh engine's
tokens; train_selfnorm_vs_mimps trains finitely and MIMPS beats Z = 1."""
import math

import numpy as np
import pytest
import torch

from repro_torch.examples import (quickstart, serve_sublinear, serve_traffic,
                                  train_selfnorm_vs_mimps, train_sublinear)

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and beside other test workers on the same cores more threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart():
    out = quickstart.main(CPU + ["--n", "2048", "--d", "16", "--features",
                                 "512"])
    rows = {r["name"]: r for r in out["rows"]}
    assert rows["exact"]["rel_err"] == 0.0
    assert rows["exact"]["log_z"] == out["log_z"]
    assert len(rows) == 8
    assert all(math.isfinite(r["log_z"]) for r in rows.values())
    ivf = next(r for n, r in rows.items() if n.startswith("IVF-MIMPS"))
    assert ivf["rel_err"] < 0.5


def test_serve_sublinear():
    out = serve_sublinear.main(CPU + ["--batch", "2", "--prompt", "3",
                                      "--gen", "3", "--vocab", "2048",
                                      "--features", "256"])
    assert set(out["methods"]) == set(serve_sublinear.METHODS)
    for m, r in out["methods"].items():
        assert torch.isfinite(r["log_z"]).all(), m
    assert torch.equal(out["methods"]["selfnorm"]["log_z"],
                       torch.zeros(2))
    assert float(out["mimps_rel_err"].max()) < 0.05
    assert out["greedy"].shape == out["sampled"].shape == (2, 3)


def test_serve_traffic():
    out = serve_traffic.main(CPU + ["--vocab", "1024", "--requests", "4",
                                    "--gen", "3"])
    assert out["parity"] == [True] * 4
    assert len(out["report"].completions) == 4
    for wave in out["waves"]:
        assert wave["parity"] == [True] * 4
    assert out["waves"][1]["report"].prefix["hits"] > 0   # the warm pool


def test_train_sublinear(tmp_path):
    out = train_sublinear.main(CPU + ["--vocab", "1024", "--steps", "3",
                                      "--refresh-every", "2", "--ckpt-dir",
                                      str(tmp_path)])
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["match"]
    assert out["before"] != out["after"]      # the swap serves new params
    assert all(len(t) == 5 for t in out["after"])


def test_train_selfnorm_vs_mimps():
    out = train_selfnorm_vs_mimps.main(CPU + [
        "--vocab", "1024", "--steps", "3", "--batch", "4", "--seq", "8",
        "--block-rows", "32", "--probes", "4", "--l", "64"])
    assert all(math.isfinite(x) for x in out["losses"])
    assert np.isfinite(out["abs_err_mimps"]).all()
    assert out["better"] > 0.5
