"""The port's explain surface (``python -m repro_torch explain ...``)
against the reference's (``python -m repro explain ...``): a CLI campaign,
a rerun, a SIGKILLed and resumed one, a queue drain, ``calibrate`` and
``report`` must leave and print what the reference's leave and print, byte
for byte, on the censuses of the reference's CI explain lanes. Also what
the port adds: its workers are ``repro_torch`` processes, one per GPU for a
wall-clock census. Every subprocess carries its own timeout; no test
asserts a time."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.sweep as port_sweep  # noqa: E402
import repro_torch.launch.explain as port_explain  # noqa: E402
from repro_torch.launch import cli  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

#: the censuses of the reference's CI explain lanes (.github/workflows/ci.yml,
#: "Explain smoke" and "Taxonomy smoke"), cut to test size, as SweepSpec
#: fields, and the explain flags each lane passes
CENSUSES = {
    "cost_model": dict(
        backend="cost_model", eff_sigma=0.25, noise_sigma=0.01, max_measurements=9,
        families={"chain": {"count": 24, "n_matrices": [3, 4], "lo": 24, "hi": 128},
                  "bilinear": {"sizes": [32, 64], "per_size": 4}}),
    "simulated": dict(
        backend="simulated", eff_sigma=0.0, noise_sigma=0.01, max_measurements=12,
        bimodal_shift=0.5, bimodal_prob=0.35, bimodal_frac=0.4,
        cache_reuse_frac=0.3, cache_reuse_saving=0.4,
        families={"chain": {"count": 24, "n_matrices": [3, 4], "lo": 24, "hi": 128},
                  "bilinear": {"sizes": [32, 48, 64], "per_size": 4}}),
}
EXPLAIN_FLAGS = {"cost_model": [], "simulated": ["--eps", "-1.0", "--max-measurements", "12"]}
#: eps < 0 never converges: every explanation runs its full measurement
#: budget, keeping the campaign long enough to kill (tests/test_explain.py's)
KILL_FLAGS = ["--eps", "-1.0", "--max-measurements", "24",
              "--shards", "4", "--chunk-size", "2", "--save-every", "4"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    for var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS"):
        env.setdefault(var, "1")
    return env


def _cli(package, args, timeout=300):
    return subprocess.run([sys.executable, "-m", package] + args, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def _ok(out):
    assert out.returncode == 0, out.stderr
    return out


def _store_bytes(root):
    return {p.name: p.read_bytes() for p in sorted(Path(root).iterdir())
            if p.is_file() and not p.name.endswith("timings.json")}


@pytest.fixture(scope="module")
def censuses(tmp_path_factory):
    """kind -> a finished census root (in process; the census CLI is held
    to the reference's in tests/test_torch_census_cli.py)."""
    out = {}
    for kind, fields in CENSUSES.items():
        root = tmp_path_factory.mktemp(f"census_{kind}")
        spec = port_sweep.SweepSpec(name=kind, n_shards=4, **fields)
        spec.save(str(root / "spec.json"))
        for shard in range(spec.n_shards):
            port_sweep.run_shard(spec, str(root), shard, device="cpu")
        port_sweep.write_merged(spec, str(root))
        out[kind] = str(root)
    return out


@pytest.mark.parametrize("kind", sorted(CENSUSES))
def test_cli_explain_equals_reference_and_reruns_as_a_no_op(censuses, tmp_path, kind):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    args = ["explain", "run", "--census", censuses[kind], "--workers", "2"] + EXPLAIN_FLAGS[kind]
    _ok(_cli("repro_torch", args + ["--out", port]))
    _ok(_cli("repro", args + ["--out", ref]))
    first = _store_bytes(port)
    assert first == _store_bytes(ref)
    assert {"espec.json", "merged.jsonl", "shard-0003.jsonl"} <= set(first)
    rerun = _ok(_cli("repro_torch", ["explain", "run", "--out", port, "--workers", "2"]))
    assert "anomalies explained" in rerun.stdout
    assert _store_bytes(port) == first
    for extra in ([], ["--json"]) if kind == "simulated" else ([],):
        got = _ok(_cli("repro_torch", ["explain", "report", "--out", port] + extra)).stdout
        assert got == _ok(_cli("repro", ["explain", "report", "--out", ref] + extra)).stdout
    census = [json.loads(line) for line in open(os.path.join(censuses[kind], "merged.jsonl"))]
    rows = [json.loads(line) for line in open(os.path.join(port, "merged.jsonl"))]
    assert [r["uid"] for r in rows] == [r["uid"] for r in census if r["is_anomaly"]]


def test_cli_explain_survives_sigkill(censuses, tmp_path):
    """A 2-worker explain run SIGKILLed mid-campaign (the whole process
    group) and resumed merges to the reference's uninterrupted bytes."""
    census = censuses["cost_model"]
    ref, killed = str(tmp_path / "ref"), str(tmp_path / "killed")
    _ok(_cli("repro", ["explain", "run", "--census", census, "--out", ref, "--workers", "2"]
             + KILL_FLAGS))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "explain", "run", "--census", census,
         "--out", killed, "--workers", "2"] + KILL_FLAGS,
        env=_env(), start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.time() + 180
        while time.time() < deadline and proc.poll() is None:
            jsonls = [f for f in os.listdir(killed) if f.endswith(".jsonl")] \
                if os.path.isdir(killed) else []
            if any(os.path.getsize(os.path.join(killed, f)) > 0 for f in jsonls):
                break
            time.sleep(0.005)
        was_running = proc.poll() is None
        os.killpg(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=60)
    assert was_running, "explain finished before the kill; enlarge the campaign"
    _ok(_cli("repro_torch", ["explain", "run", "--out", killed, "--workers", "2"]))
    assert _store_bytes(killed) == _store_bytes(ref)


def test_queue_drains_an_explain_store(censuses, tmp_path):
    """``queue run`` with two hosts and ``queue work`` drain a planned
    explain store to the bytes of ``explain run``."""
    census = censuses["simulated"]
    flags = EXPLAIN_FLAGS["simulated"] + ["--shards", "3"]
    straight, shared, single = (str(tmp_path / n) for n in ("straight", "shared", "single"))
    _ok(_cli("repro_torch", ["explain", "run", "--census", census, "--out", straight,
                             "--workers", "1"] + flags))
    for root in (shared, single):
        plan = _ok(_cli("repro_torch", ["explain", "plan", "--census", census, "--out", root] + flags))
        assert "anomaly explanations over 3 shards" in plan.stdout
    run = _ok(_cli("repro_torch", ["queue", "run", "--out", shared, "--hosts", "2", "--poll", "0.1"]))
    assert "merged" in run.stdout
    _ok(_cli("repro_torch", ["queue", "work", "--out", single, "--host", "h1"]))
    _ok(_cli("repro_torch", ["explain", "merge", "--out", single]))
    want = (Path(straight) / "merged.jsonl").read_bytes()
    assert (Path(shared) / "merged.jsonl").read_bytes() == want
    assert (Path(single) / "merged.jsonl").read_bytes() == want
    status = _ok(_cli("repro_torch", ["queue", "status", "--out", shared]))
    assert "[done]" in status.stdout


def test_cli_status_merge_fsck_and_plan_guard(censuses, tmp_path):
    census = censuses["cost_model"]
    out = str(tmp_path / "explain")
    clash = _cli("repro_torch", ["explain", "plan", "--census", census, "--out", census])
    assert clash.returncode != 0 and "--out must differ" in clash.stderr
    _ok(_cli("repro_torch", ["explain", "plan", "--census", census, "--out", out, "--shards", "2"]))
    _ok(_cli("repro_torch", ["explain", "work", "--out", out, "--shards", "0"]))
    status = _ok(_cli("repro_torch", ["explain", "status", "--out", out])).stdout
    ref_status = _ok(_cli("repro", ["explain", "status", "--out", out])).stdout
    assert status == ref_status and "anomalies explained" in status
    merge = _ok(_cli("repro_torch", ["explain", "merge", "--out", out]))
    assert "explanations ->" in merge.stdout
    with open(Path(out) / "shard-0001.jsonl", "ab") as fh:
        fh.write(b'{"uid": "torn')
    dry = _cli("repro_torch", ["explain", "fsck", "--out", out, "--dry-run"])
    assert dry.returncode == 1 and "(explain, 2 shards)" in dry.stdout and "[torn_tail]" in dry.stdout
    fsck = _ok(_cli("repro_torch", ["fsck", "--out", out]))
    assert "(explain, 2 shards)" in fsck.stdout and "repaired" in fsck.stdout


def test_cli_calibrate_synthetic_writes_the_reference_file(tmp_path):
    """The reference's CI calibration (a synthetic ground-truth machine)
    gives the same file and table in both packages."""
    args = ["explain", "calibrate", "--backend", "synthetic", "--machine", "ci-synth",
            "--peak-flops", "5e10", "--truth-dispatch-us", "2.0", "--truth-eff-knee", "0",
            "--reps", "25"]
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    got = _ok(_cli("repro_torch", args + ["--out-file", str(port)])).stdout
    want = _ok(_cli("repro", args + ["--out-file", str(ref)])).stdout
    assert port.read_bytes() == ref.read_bytes()
    assert got.replace(str(port), "F") == want.replace(str(ref), "F")
    assert json.loads(port.read_text())["machine"]["name"] == "ci-synth:calibrated"


# ------------------------------------------------------ what the port adds ---

class _FakeProc:
    def wait(self):
        return 0


def _wall_clock_census(root):
    spec = port_sweep.SweepSpec(name="w", backend="wall_clock", n_shards=1,
                                families={"bilinear": {"sizes": [16], "per_size": 1}})
    spec.save(str(root / "spec.json"))
    return str(root)


def test_explain_run_spawns_repro_torch_workers_one_gpu_each(censuses, tmp_path, monkeypatch):
    """A wall-clock census is explained by ``-m repro_torch explain work``
    workers on ``--device``, one GPU each; a deterministic census takes any
    worker count and gives no GPU."""
    import repro_torch.launch.sweep as port_launch

    spawned = []
    monkeypatch.setattr(port_explain.subprocess, "Popen",
                        lambda cmd, env: spawned.append((cmd, env)) or _FakeProc())
    monkeypatch.setattr(port_launch, "visible_gpus", lambda: ["3", "5"])
    monkeypatch.setattr(port_explain, "explain_progress",
                        lambda *a, **k: {"anomalies": 1, "completed": 0})
    census = _wall_clock_census(tmp_path)
    rc = port_explain.main(["run", "--census", census, "--out", str(tmp_path / "e"),
                            "--workers", "2", "--shards", "2"])
    assert rc == 0
    assert [cmd[1:6] for cmd, _ in spawned] == [["-m", "repro_torch", "explain", "work", "--out"]] * 2
    assert [cmd[cmd.index("--device") + 1] for cmd, _ in spawned] == ["cuda", "cuda"]
    assert [env["CUDA_VISIBLE_DEVICES"] for _, env in spawned] == ["3", "5"]
    assert Path(spawned[0][1]["PYTHONPATH"].split(os.pathsep)[0]) == REPO / "src"
    spawned.clear()
    rc = port_explain.main(["run", "--census", censuses["cost_model"], "--out", str(tmp_path / "c"),
                            "--workers", "3", "--shards", "3", "--device", "cpu"])
    assert rc == 0 and len(spawned) == 3
    assert [cmd[cmd.index("--device") + 1] for cmd, _ in spawned] == ["cpu"] * 3


@pytest.mark.parametrize("workers,gpus,message", [
    (2, ["0"], "one worker per GPU: 2 worker.*at most 1"),
    (1, [], "needs a visible GPU.*--device cpu"),
])
def test_wall_clock_explain_workers_beyond_visible_gpus_refused(tmp_path, monkeypatch, workers,
                                                                 gpus, message):
    import repro_torch.launch.sweep as port_launch

    monkeypatch.setattr(port_launch, "visible_gpus", lambda: gpus)
    monkeypatch.setattr(port_explain.subprocess, "Popen", lambda *a, **k: pytest.fail("spawned"))
    monkeypatch.setattr(port_explain, "explain_progress",
                        lambda *a, **k: {"anomalies": 1, "completed": 0})
    with pytest.raises(SystemExit, match=message):
        port_explain.main(["run", "--census", _wall_clock_census(tmp_path),
                           "--out", str(tmp_path / "e"), "--workers", str(workers),
                           "--shards", "2"])


def test_explain_surface_is_routed(capsys):
    """``python -m repro_torch explain`` reaches the port's explain CLI."""
    with pytest.raises(SystemExit) as exit_:
        cli.main(["explain", "--help"])
    assert exit_.value.code == 0
    out = capsys.readouterr().out
    for verb in ("plan", "run", "work", "status", "merge", "fsck", "calibrate", "report"):
        assert verb in out
