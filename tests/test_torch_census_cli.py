"""The port's census surfaces (``python -m repro_torch census|queue|fsck``)
against the reference's (``python -m repro``): a CLI census, a SIGKILLed
and resumed one, a two-host queue drain and an fsck repair must leave the
stores the reference leaves, byte for byte. Also what the port adds: its
workers are ``repro_torch`` processes, one per GPU on wall clock.
Every subprocess carries its own timeout; no test asserts a time."""

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
import repro_torch.launch.queue as port_queue  # noqa: E402
import repro_torch.launch.sweep as port_launch  # noqa: E402
from repro_torch.launch import cli  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

#: Sized so that a SIGKILL lands while shards are in flight (as
#: tests/test_sweep.py's CLI grid): 40 instances, small chunks.
CLI_GRID = [
    "--chains", "32", "--chain-sizes", "4,5", "--lo", "24", "--hi", "160",
    "--families", "bilinear", "--sizes", "32,64", "--per-size", "4",
    "--shards", "4", "--max-measurements", "12",
    "--chunk-size", "2", "--save-every", "4",
]
SMALL_GRID = ["--chains", "8", "--chain-sizes", "3", "--lo", "16", "--hi", "64",
              "--families", "bilinear,solve", "--sizes", "32", "--per-size", "2",
              "--shards", "4", "--max-measurements", "6",
              "--chunk-size", "2", "--save-every", "4"]


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


def _merged(root):
    return (Path(root) / "merged.jsonl").read_bytes()


# ------------------------------------------------- stores equal the reference ---

def test_cli_census_equals_reference_and_survives_sigkill(tmp_path):
    """The acceptance scenario on the port: a 2-worker CLI census equals the
    reference's CLI census byte for byte; a run SIGKILLed mid-census (the
    whole process group) and resumed merges to the same bytes."""
    port, ref, killed = (str(tmp_path / n) for n in ("port", "ref", "killed"))
    done = _cli("repro_torch", ["census", "run", "--out", port, "--workers", "2"] + CLI_GRID)
    assert done.returncode == 0, done.stderr
    want = _cli("repro", ["census", "run", "--out", ref, "--workers", "2"] + CLI_GRID)
    assert want.returncode == 0, want.stderr
    assert _merged(port) == _merged(ref)
    assert (Path(port) / "spec.json").read_bytes() == (Path(ref) / "spec.json").read_bytes()
    assert _merged(port).count(b"\n") == 40  # 32 chains + 8 bilinear

    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "census", "run", "--out", killed,
         "--workers", "2"] + CLI_GRID,
        env=_env(), start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        # wait until a record batch hit disk, then SIGKILL the process group
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
    assert was_running, "census finished before the kill; enlarge CLI_GRID"
    resumed = _cli("repro_torch", ["census", "run", "--out", killed, "--workers", "2"])
    assert resumed.returncode == 0, resumed.stderr
    assert _merged(killed) == _merged(ref)

    report = _cli("repro_torch", ["census", "report", "--out", killed])
    assert report.returncode == 0, report.stderr
    assert report.stdout == _cli("repro", ["census", "report", "--out", ref]).stdout


def test_queue_two_hosts_equal_one_host_store(tmp_path):
    straight, shared = str(tmp_path / "straight"), str(tmp_path / "shared")
    done = _cli("repro_torch", ["census", "run", "--out", straight, "--workers", "1"] + SMALL_GRID)
    assert done.returncode == 0, done.stderr
    plan = _cli("repro_torch", ["census", "plan", "--out", shared] + SMALL_GRID)
    assert plan.returncode == 0, plan.stderr
    run = _cli("repro_torch", ["queue", "run", "--out", shared, "--hosts", "2", "--poll", "0.1"])
    assert run.returncode == 0, run.stderr
    assert "merged" in run.stdout
    assert _merged(shared) == _merged(straight)
    status = _cli("repro_torch", ["queue", "status", "--out", shared])
    assert status.returncode == 0 and "[done]" in status.stdout


# ------------------------------------------------------------------- fsck ---

def _damage(root):
    """The same damage in a store of either package: a checksum-failing
    interior line, a torn tail, a stale manifest and a leftover temp."""
    shard0 = Path(root) / "shard-0000.jsonl"
    lines = shard0.read_bytes().splitlines(keepends=True)
    lines[1] = lines[1].replace(b'"is_anomaly":false', b'"is_anomaly":true ') \
        if b'"is_anomaly":false' in lines[1] else lines[1].replace(b'"is_anomaly":true', b'"is_anomaly":false')
    shard0.write_bytes(b"".join(lines))
    with open(Path(root) / "shard-0001.jsonl", "ab") as fh:
        fh.write(b'{"uid": "torn')
    manifest = Path(root) / "shard-0002.manifest.json"
    doc = json.loads(manifest.read_text())
    doc["n_completed"] += 3
    manifest.write_text(json.dumps(doc))
    (Path(root) / "spec.json.tmp").write_text("{")


def test_fsck_repairs_a_damaged_store_as_the_reference_does(tmp_path):
    from repro.core import sweep as ref_sweep
    from repro.launch.fsck import fsck_store as ref_fsck
    from repro_torch.launch.fsck import fsck_store

    kwargs = dict(name="f", n_shards=3, max_measurements=9, chunk_size=2,
                  families={"chain": {"count": 6, "n_matrices": [3, 4], "lo": 16, "hi": 64},
                            "gram": {"sizes": [24], "per_size": 3}})
    reports = {}
    for name, sweep, fsck, kw in (("port", port_sweep, fsck_store, {"device": "cpu"}),
                                  ("ref", ref_sweep, ref_fsck, {})):
        root = tmp_path / name
        spec = sweep.SweepSpec(**kwargs)
        root.mkdir()
        spec.save(str(root / "spec.json"))
        for shard in range(3):
            sweep.run_shard(spec, str(root), shard, **kw)
        straight = sweep.merge_shards(spec, str(root))
        _damage(root)
        with pytest.raises(sweep.StoreDamaged):
            sweep.merge_shards(spec, str(root))
        report = fsck(str(root)).to_dict()
        report.pop("out")
        reports[name] = report
        for shard in range(3):  # re-drain what fsck excised
            sweep.run_shard(spec, str(root), shard, **kw)
        assert sweep.merge_shards(spec, str(root)) == straight
    assert reports["port"] == reports["ref"]
    assert reports["port"]["by_kind"] == {"checksum_mismatch": 1, "torn_tail": 1,
                                          "manifest_drift": 2, "leftover_tmp": 1}
    assert _store_bytes(tmp_path / "port") == _store_bytes(tmp_path / "ref")


def _store_bytes(root):
    return {p.name: p.read_bytes() for p in sorted(Path(root).glob("shard-*"))
            if not p.name.endswith("timings.json")}


def test_fsck_cli_on_an_unported_store_kind_scans_shard_files(tmp_path):
    """fsck on a damaged oracle store (``ocache.json`` of ``{}``) takes the
    shard count from its spec (the default 4) and prints and repairs what
    the reference's fsck does on the same root. The name is the refusal
    test's that this one replaced, kept so that its history stays
    traceable."""
    outs = {}
    for package in ("repro_torch", "repro"):
        root = tmp_path / package
        root.mkdir()
        (root / "ocache.json").write_text("{}")
        port_sweep.ShardStore(str(root), 1).open().append_records([{"uid": "a", "index": 0}])
        with open(root / "shard-0001.jsonl", "ab") as fh:
            fh.write(b"{torn")
        out = subprocess.run([sys.executable, "-m", package, "fsck", "--out", "."], env=_env(), cwd=root,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        outs[package] = out.stdout
    assert outs["repro_torch"] == outs["repro"]
    assert "(oracle, 4 shards)" in outs["repro"] and "[torn_tail]" in outs["repro"]
    assert _store_bytes(tmp_path / "repro_torch") == _store_bytes(tmp_path / "repro")


# ------------------------------------------------------ what the port adds ---

class _FakeProc:
    def wait(self):
        return 0


def test_census_run_spawns_repro_torch_workers_one_gpu_each(tmp_path, monkeypatch):
    spawned = []
    monkeypatch.setattr(port_launch.subprocess, "Popen",
                        lambda cmd, env: spawned.append((cmd, env)) or _FakeProc())
    monkeypatch.setattr(port_launch, "visible_gpus", lambda: ["3", "5"])
    rc = port_launch.main(["run", "--out", str(tmp_path), "--workers", "2",
                           "--backend", "wall_clock", "--chains", "4", "--families", "",
                           "--shards", "2"])
    assert rc == 0
    assert [cmd[1:6] for cmd, _ in spawned] == [["-m", "repro_torch", "census", "work", "--out"]] * 2
    assert [cmd[cmd.index("--device") + 1] for cmd, _ in spawned] == ["cuda", "cuda"]
    assert [env["CUDA_VISIBLE_DEVICES"] for _, env in spawned] == ["3", "5"]
    assert Path(spawned[0][1]["PYTHONPATH"].split(os.pathsep)[0]) == REPO / "src"


def test_queue_run_spawns_repro_torch_hosts(tmp_path, monkeypatch):
    spawned = []
    monkeypatch.setattr(port_queue.subprocess, "Popen",
                        lambda cmd, env: spawned.append((cmd, env)) or _FakeProc())
    port_sweep.SweepSpec(families={"bilinear": {"sizes": [16]}}, n_shards=1).save(
        str(tmp_path / "spec.json"))
    port_queue.main(["run", "--out", str(tmp_path), "--hosts", "3", "--device", "cpu"])
    assert [cmd[1:5] for cmd, _ in spawned] == [["-m", "repro_torch", "queue", "work"]] * 3
    assert all(cmd[cmd.index("--device") + 1] == "cpu" for cmd, _ in spawned)
    assert all("CUDA_VISIBLE_DEVICES" not in env or env["CUDA_VISIBLE_DEVICES"] == os.environ.get(
        "CUDA_VISIBLE_DEVICES") for _, env in spawned)


@pytest.mark.parametrize("workers,gpus,message", [
    (2, ["0"], "one worker per GPU: 2 worker.*at most 1"),
    (1, [], "needs a visible GPU.*--device cpu"),
])
def test_wall_clock_workers_beyond_visible_gpus_refused(tmp_path, monkeypatch, workers, gpus, message):
    monkeypatch.setattr(port_launch, "visible_gpus", lambda: gpus)
    monkeypatch.setattr(port_launch.subprocess, "Popen", lambda *a, **k: pytest.fail("spawned"))
    with pytest.raises(SystemExit, match=message):
        port_launch.main(["run", "--workers", str(workers), "--backend", "wall_clock",
                          "--out", str(tmp_path), "--chains", "2", "--families", ""])
    assert not (tmp_path / "spec.json").exists()  # refused before planning


def test_wall_clock_cpu_and_deterministic_censuses_take_any_worker_count(monkeypatch):
    monkeypatch.setattr(port_launch, "visible_gpus", lambda: [])
    assert len(port_launch.worker_envs(4, "wall_clock", "cpu")) == 4
    assert len(port_launch.worker_envs(4, "cost_model", "cuda")) == 4


def test_census_plan_refuses_a_predictor(tmp_path):
    """``census plan --predictor`` plans an active census and writes the
    reference's ``spec.json``. The name is the refusal test's that this one
    replaced, kept so that its history stays traceable."""
    import repro.launch.sweep as ref_launch

    args = ["plan", "--predictor", "m.json", "--predict-threshold", "0.9"] + SMALL_GRID
    assert port_launch.main(args + ["--out", str(tmp_path / "port")]) == 0
    assert ref_launch.main(args + ["--out", str(tmp_path / "ref")]) == 0
    spec = (tmp_path / "port" / "spec.json").read_bytes()
    assert spec == (tmp_path / "ref" / "spec.json").read_bytes()
    assert json.loads(spec)["predictor_model"] == "m.json"


@pytest.mark.parametrize("surface", ["oracle", "predict"])
def test_unported_surfaces_say_which_item_ports_them(surface, capsys):
    """``oracle --help`` and ``predict --help`` dispatch to their parsers
    and exit 0. The name is the refusal test's that this one replaced, kept
    so that its history stays traceable."""
    with pytest.raises(SystemExit) as done:
        cli.main([surface, "--help"])
    assert done.value.code == 0
    assert capsys.readouterr().out.startswith(f"usage: repro_torch {surface}")


def test_queue_refuses_an_unported_store_kind(tmp_path):
    """An oracle cache (``ocache.json``) opens as the oracle's queue, with
    its spec's shard count, on the device asked for. The name is the
    refusal test's that this one replaced, kept so that its history stays
    traceable."""
    from repro_torch.serve.cache import OracleCache, OracleCacheSpec
    from repro_torch.serve.oracle import OracleQueue

    port_sweep.SweepSpec(families={"bilinear": {"sizes": [16]}}, n_shards=1).save(
        str(tmp_path / "spec.json"))
    OracleCache.create(str(tmp_path / "cache"), OracleCacheSpec(census=str(tmp_path), n_shards=3))
    queue = port_queue.open_queue(str(tmp_path / "cache"), device="cpu")
    assert isinstance(queue, OracleQueue) and queue.device == "cpu" and queue.n_shards == 3


def test_queue_refuses_an_ambiguous_store(tmp_path):
    (tmp_path / "spec.json").write_text("{}")
    (tmp_path / "espec.json").write_text("{}")
    with pytest.raises(SystemExit, match="multiple campaign kinds"):
        port_queue.open_queue(str(tmp_path))


def test_umbrella_help_and_fsck_routes():
    out = _cli("repro_torch", ["--help"], timeout=120)
    assert out.returncode == 0
    for surface in cli.SURFACES:
        assert surface in out.stdout
    helps = [_cli("repro_torch", route + ["--help"], timeout=120).stdout.split("\n", 1)[1]
             for route in (["fsck"], ["census", "fsck"], ["queue", "fsck"])]
    assert "--dry-run" in helps[0] and helps[1] == helps[2]


def test_census_help_runs_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.argv = ['repro_torch', 'census', '--help']\n"
        "import runpy\n"
        "runpy.run_module('repro_torch', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: repro_torch census")
