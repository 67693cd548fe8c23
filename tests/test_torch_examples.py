"""The port's examples (``examples/torch_*.py``) as a user runs them, on the
CPU (``--device cpu``) at a small size, each in a subprocess of its own
working directory; all of them started at once by a module fixture.

Where the reference's example is deterministic (the cost-model anomaly
hunt, and the explanation of the cost-model demo census) the port's output
equals the reference example's, run with the same flags, line for line.
The others must exit 0 and print their headline: the quickstart's verdict,
each site's report, the generated tokens, and a training run whose loss
falls and whose ``--resume`` continues from its checkpoint."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
TIMEOUT_S = 300
HUNT = ("--backend", "cost_model", "--n", "4", "--lo", "16", "--hi", "64", "--chain", "3", "--out", "hunt")
TRAIN = ("--preset", "tiny", "--seq", "64", "--log-every", "4", "--ckpt-every", "6")
RUNS = {
    "quickstart": ("torch_quickstart.py", "--device", "cpu"),
    "rank_algorithms": ("torch_rank_algorithms.py", "--scale", "0.25", "--max-steps", "6", "--device", "cpu"),
    "anomaly_hunt": ("torch_anomaly_hunt.py", *HUNT, "--device", "cpu"),
    "ref_anomaly_hunt": ("anomaly_hunt.py", *HUNT),
    "explain": ("torch_explain_anomalies.py", "--out", "demo", "--device", "cpu"),
    "ref_explain": ("explain_anomalies.py", "--out", "demo"),
    "serve": ("torch_serve_lm.py", "--tokens", "8", "--device", "cpu"),
    "train": ("torch_train_lm.py", *TRAIN, "--steps", "12", "--device", "cpu"),
}
RESUME = ("torch_train_lm.py", *TRAIN, "--steps", "16", "--resume", "--device", "cpu")


def _start(argv, cwd, env):
    cwd.mkdir(exist_ok=True)
    return subprocess.Popen([sys.executable, str(EXAMPLES / argv[0]), *argv[1:]], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc, name, deadline):
    try:
        out, err = proc.communicate(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"example {name} did not finish in {TIMEOUT_S} s")
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (exit code, stdout, stderr)} of every run."""
    pytest.importorskip("torch")
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    ckpt = ("--ckpt-dir", str(tmp / "train_ckpt"))
    procs = {name: _start(argv + (ckpt if name == "train" else ()), tmp / name, env) for name, argv in RUNS.items()}
    deadline = time.time() + TIMEOUT_S
    out = {}
    for name, proc in procs.items():
        out[name] = _finish(proc, name, deadline)
        if name == "train" and out[name][0] == 0:
            out["resume"] = _finish(_start(RESUME + ckpt, tmp / "train", env), "resume", deadline)
    return out


def _ok(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, f"{name} exited {rc}:\n{err[-3000:]}"
    return out


@pytest.mark.parametrize("name", ["anomaly_hunt", "explain"])
def test_deterministic_example_prints_what_the_reference_prints(runs, name):
    port, ref = _ok(runs, name).splitlines(), _ok(runs, f"ref_{name}").splitlines()
    assert port == ref
    assert len(port) > 3


def test_anomaly_hunt_reports_its_rate(runs):
    out = _ok(runs, "anomaly_hunt")
    assert "anomaly rate:" in out and "census state: hunt" in out


def test_explain_prints_the_cause_table(runs):
    out = _ok(runs, "explain")
    assert "anomalies explained, mean evidence" in out and "state: demo" in out


def test_quickstart_gives_a_verdict(runs):
    out = _ok(runs, "quickstart")
    assert "instance anomaly_331" in out and "FLOPs test:" in out


def test_rank_algorithms_reports_every_site(runs):
    out = _ok(runs, "rank_algorithms")
    for site in ("moe_dispatch[", "attention[", "ssd_chunk["):
        assert f"site {site}" in out, out


def test_serve_generates(runs):
    out = _ok(runs, "serve")
    assert "generated 8 tokens/seq" in out and "seq0:" in out


def _losses(out):
    return {int(line.split()[1]): float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if line.startswith("step ")}


def test_train_lm_loss_falls_and_resume_continues(runs):
    first = _losses(_ok(runs, "train"))
    assert sorted(first) == [0, 4, 8, 11]
    assert first[11] < first[0], first
    out = _ok(runs, "resume")
    assert "resumed from step 11" in out
    resumed = _losses(out)
    assert sorted(resumed) == [12, 15] and resumed[15] < first[0], resumed
