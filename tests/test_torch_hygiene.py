"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package; its configs equal the JAX
package's field by field; and its entry points refuse to run on a missing
GPU instead of moving to the CPU."""
import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced_config

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(%r))\n" % _modules())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15          # every module was imported


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [ROOT / "chip_smoke.py"]
    + list((ROOT / "src" / "repro_torch").rglob("*.py"))), ids=str)
def test_sources_import_no_jax_or_repro(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, name)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + ["lbl-paper"])
def test_configs_equal_jax_package(arch):
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (reduced_config(arch), j_reduced_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_qwen_config_field_by_field():
    mine, theirs = get_config("qwen1.5-4b"), j_get_config("qwen1.5-4b")
    for f in dataclasses.fields(theirs):
        assert getattr(mine, f.name) == getattr(theirs, f.name) or \
            dataclasses.asdict(getattr(mine, f.name)) == \
            dataclasses.asdict(getattr(theirs, f.name)), f.name


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    import numpy as np

    from repro_torch.configs import TrainConfig
    from repro_torch.core.feature_maps import make_feature_map
    from repro_torch.core.lsh import build_lsh_device
    from repro_torch.core.mips import build_ivf
    from repro_torch.interop import ivf_from_numpy, params_from_numpy
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    from repro_torch.train import init_train_metric_state, init_train_state
    cfg = reduced_config("qwen1.5-4b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(model, params, max_len=8)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        build_ivf(torch.zeros((64, 8)), block_rows=8,
                  assign=torch.zeros(64, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="cuda"):
        make_feature_map(torch.Generator().manual_seed(0), 8, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(model, TrainConfig(), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_metric_state()
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({"lm_head": np.zeros((4, 4), np.float32)}, cfg)
    z = np.zeros((2, 4), np.int32)
    with pytest.raises(RuntimeError, match="cuda"):
        ivf_from_numpy(np.zeros((2, 4, 8), np.float32), z > 0, z, z[0], z,
                       z[0], n=4, block_rows=4)
    with pytest.raises(RuntimeError, match="cuda"):
        build_lsh_device(torch.zeros((64, 8)),
                         generator=torch.Generator().manual_seed(0))
