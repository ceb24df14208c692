"""The port's serving entry point and trace summary
(``repro_torch.launch.serve``, ``repro_torch.launch.obs_report``) on the
CPU: the workload equals the JAX CLI's; a run with ``--stream
--sequential`` exits 0 and every request's slot-table tokens equal its
sequential ``generate``; an overload run sheds by reason and walks the tier
ladder down and back; an audio arch serves one ``generate`` batch; with
``--trace-out`` and ``--metrics-snapshot`` the port's ``obs_report``
reconciles the trace and summarises it as the JAX package's does; a VLM is refused with the scheduler's message; and the CLI
under ``--mesh data=1,model=2`` on two gloo ranks (the spawn of
``tests/_torch_mesh_rank.py``) streams the one-device run's tokens."""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import obs_report as j_obs_report
from repro.launch.serve import build_workload as j_build_workload
from repro_torch.launch import obs_report, serve

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--device", "cpu", "--reduced"]
SMALL = BASE + ["--slots", "4", "--requests", "6", "--gen", "4", "--stream"]
# SKILL.md's surface 5: the overload run
OVERLOAD = BASE + ["--method", "mimps", "--rate", "2.0", "--max-queue", "3",
                   "--deadline", "30", "--degrade-high", "2",
                   "--degrade-low", "1", "--verify-index-every", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and beside other test workers on the same cores more threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_build_workload_equals_jax(seed):
    args = (12, 1000, 5, 3, 11, 0.7, seed)
    got = serve.build_workload(*args)
    want = j_build_workload(*args)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.prompt, np.asarray(w.prompt))
        assert g.max_new_tokens == w.max_new_tokens
        assert g.temperature == w.temperature
        assert g.seed == seed + 1000 + i


def _streamed(text):
    """{request index in arrival order: tokens} from the --stream lines."""
    lines = re.findall(r"req\s+(\d+) T=\S+ len\s+\d+ -> (\[[^\]]*\])", text)
    first = min(int(r) for r, _ in lines)
    return {int(r) - first: json.loads(t) for r, t in lines}


@pytest.fixture(scope="module")
def small_run():
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(SMALL + ["--sequential"])
    return rc, buf.getvalue()


def test_cli_serves_and_matches_sequential(small_run):
    rc, out = small_run
    assert rc == 0, out
    assert "continuous: 6 requests" in out
    assert "tokens equal to the slot table's for 6/6 requests" in out
    assert len(_streamed(out)) == 6
    assert "captures after warm-up: 0" in out


@pytest.fixture(scope="module")
def overload_run(tmp_path_factory):
    import contextlib
    import io
    tmp = tmp_path_factory.mktemp("serve")
    trace, snap = str(tmp / "trace.jsonl"), str(tmp / "snap.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(OVERLOAD + ["--trace-out", trace,
                                    "--metrics-snapshot", snap])
    return rc, buf.getvalue(), trace, snap


def test_overload_sheds_and_walks_the_ladder(overload_run):
    rc, out, _, _ = overload_run
    assert rc == 0, out
    shed = re.search(r"by reason: (\{[^}]*\})", out)
    assert shed and "queue_full" in shed.group(1), out
    path = re.search(r"tier transitions: (\S+) -> (\S+);", out)
    assert path, out
    assert path.group(1).startswith("topk@")
    assert path.group(2).startswith("mimps@")


def test_obs_report_reconciles_and_equals_jax(overload_run, capsys):
    rc, _, trace, snap = overload_run
    assert rc == 0
    assert obs_report.main([trace, "--snapshot", snap]) == 0
    assert "reconciled" in capsys.readouterr().out
    events, bad = obs_report.load_events(trace)
    j_events, j_bad = j_obs_report.load_events(trace)
    assert bad == j_bad == 0 and events == j_events
    assert obs_report.summarize(events) == j_obs_report.summarize(j_events)
    assert obs_report.reconcile(obs_report.summarize(events),
                                json.load(open(snap))) == []


def test_obs_report_exit_codes(overload_run, tmp_path):
    _, _, trace, snap = overload_run
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert obs_report.main([str(empty)]) == 2
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"ph": "X", "name": "a"}\nnot json\n')
    assert obs_report.main([str(bad)]) == 2
    tampered = json.load(open(snap))
    tampered["harvest"]["tokens_by_tier"]["fmbe"] = 99
    tp = tmp_path / "snap.json"
    tp.write_text(json.dumps(tampered))
    assert obs_report.main([trace, "--snapshot", str(tp)]) == 3
    out = tmp_path / "chrome.json"
    assert obs_report.main([trace, "--to-json", str(out)]) == 0
    assert len(json.load(open(out))["traceEvents"]) == \
        len(obs_report.load_events(trace)[0])


def test_audio_serves_one_generate_batch(capsys):
    assert serve.main(BASE + ["--arch", "musicgen-medium", "--slots", "2",
                              "--gen", "2"]) == 0
    assert "generated 2x2 codebook tokens" in capsys.readouterr().out


def test_vlm_is_refused_with_the_schedulers_message(capsys):
    assert serve.main(BASE + ["--arch", "llama-3.2-vision-90b"]) == 2
    assert "is a VLM: the slot table carries no image" in \
        capsys.readouterr().err


def test_mesh_data1_model2_streams_one_devices_tokens(small_run, tmp_path):
    """Two gloo ranks of the CLI at --mesh data=1,model=2 (each rank's
    state the model group's half of the rows): every request's tokens as
    the one-device run streamed them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = []
    t0 = time.time()
    for r in range(2):
        log = open(tmp_path / f"log{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_mesh_rank.py"),
             "serve-cli", str(r), "2", str(tmp_path / "store"),
             str(tmp_path), *SMALL, "--mesh", "data=1,model=2"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, t0 + 120 - time.time()))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = "".join((tmp_path / f"log{r}.txt").read_text() for r in range(2))
    assert all(p.returncode == 0 for p, _ in procs), logs[-4000:]
    out0 = (tmp_path / "serve0.txt").read_text()
    assert out0.startswith("rc 0\n"), out0
    assert "mesh data=1,model=2" in out0
    assert (tmp_path / "serve1.txt").read_text() == "rc 0\n"  # rank 0 says
    assert _streamed(out0) == _streamed(small_run[1])
