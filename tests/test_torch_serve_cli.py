"""The port's ``oracle`` and ``predict`` surfaces (``python -m repro_torch
oracle|predict ...``) against the reference's (``python -m repro ...``):
on the same census and explain directories, each command prints and
writes what the reference's prints and writes, byte for byte. Each
package runs in a working directory of its own with the same relative
``--out``, so the printed paths agree. ``oracle serve`` answers every
query line, with its refresher draining misses on the plain versions
(``--device cpu``). Every subprocess carries its own timeout; no test
asserts a time."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.sweep as port_sweep  # noqa: E402
import repro_torch.explain.runner as port_runner  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

#: a cost-model census with anomalies to explain (bilinear) and families
#: whose FLOPs differ 2x or more (solve, distributive)
CENSUS = dict(name="cli", n_shards=2, backend="cost_model", max_measurements=9,
              families={"bilinear": {"sizes": [32, 64], "per_size": 3},
                        "solve": {"sizes": [32, 64], "per_size": 3},
                        "distributive": {"sizes": [32], "per_size": 3},
                        "chain": {"count": 6, "n_matrices": [3], "lo": 24, "hi": 96}})

QUERIES = [
    {"family": "bilinear", "params": {"size": 32, "seed": 0}},          # measured
    {"family": "solve", "params": {"size": 40, "seed": 9}},             # bucketed
    {"family": "distributive", "params": {"size": 300, "seed": 1}},     # miss
    {"family": "chain", "params": {"n_matrices": 3, "lo": 24, "hi": 96, "seed": 2}},  # measured
    {"family": "gram", "params": {"size": 64, "seed": 0}},              # miss (family not censused)
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    for var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS"):
        env.setdefault(var, "1")
    return env


def _cli(package, args, cwd, timeout=300):
    out = subprocess.run([sys.executable, "-m", package] + args, env=_env(), cwd=cwd,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr
    return out


def _both(tmp, args, **kw):
    """The same command from both packages, each in its own directory."""
    return (_cli("repro_torch", args, tmp / "port", **kw), _cli("repro", args, tmp / "ref", **kw))


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(Path(root).iterdir())
            if p.is_file() and not p.name.endswith(("timings.json", ".lease"))}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(census root, explain root), made by the port in process."""
    base = tmp_path_factory.mktemp("stores")
    census, explain = base / "census", base / "explain"
    census.mkdir()
    spec = port_sweep.SweepSpec(**CENSUS)
    spec.save(str(census / "spec.json"))
    for shard in range(spec.n_shards):
        port_sweep.run_shard(spec, str(census), shard, device="cpu")
    port_sweep.write_merged(spec, str(census))
    explain.mkdir()
    espec = port_runner.ExplainSpec(census=str(census), n_shards=2)
    espec.save(str(explain / port_runner.SPEC_FILE))
    for shard in range(espec.n_shards):
        port_runner.run_explain_shard(espec, str(explain), shard, device="cpu")
    port_runner.write_merged_explained(espec, str(explain))
    return str(census), str(explain)


@pytest.fixture()
def dirs(tmp_path):
    for name in ("port", "ref"):
        (tmp_path / name).mkdir()
    return tmp_path


def test_oracle_cli_equals_reference(stores, dirs):
    """warm, query (batch and single), status, a `queue work` drain of the
    enqueued misses and fsck: the same output and the same cache files."""
    census, explain = stores
    port, ref = _both(dirs, ["oracle", "warm", "--out", "cache", "--census", census, "--explain", explain,
                             "--shards", "3"])
    assert port.stdout == ref.stdout and "entries written" in port.stdout
    assert _files(dirs / "port" / "cache") == _files(dirs / "ref" / "cache")
    for name in ("port", "ref"):
        (dirs / name / "q.jsonl").write_text("".join(json.dumps(q) + "\n" for q in QUERIES))
    port, ref = _both(dirs, ["oracle", "query", "--out", "cache", "--batch", "q.jsonl", "--json", "v.jsonl"])
    assert port.stderr.splitlines()[-1] == ref.stderr.splitlines()[-1]
    assert "2 enqueued for measurement" in port.stderr
    verdicts = (dirs / "port" / "v.jsonl").read_text()
    assert verdicts == (dirs / "ref" / "v.jsonl").read_text()
    confidences = [json.loads(v)["confidence"] for v in verdicts.splitlines()]
    assert confidences == ["measured", "bucketed", "model_only", "measured", "model_only"]
    port, ref = _both(dirs, ["oracle", "query", "--out", "cache", "--family", "bilinear",
                             "--params", '{"size": 64, "seed": 1}', "--no-enqueue"])
    assert port.stdout == ref.stdout and '"confidence":"measured"' in port.stdout
    port, ref = _both(dirs, ["oracle", "status", "--out", "cache"])
    assert port.stdout == ref.stdout and "2 misses enqueued, 2 pending" in port.stdout
    _cli("repro_torch", ["queue", "work", "--out", "cache", "--device", "cpu", "--poll", "0.1"], dirs / "port")
    _cli("repro", ["queue", "work", "--out", "cache", "--poll", "0.1"], dirs / "ref")
    assert _files(dirs / "port" / "cache") == _files(dirs / "ref" / "cache")
    port, ref = _both(dirs, ["oracle", "status", "--out", "cache"])
    assert port.stdout == ref.stdout and "2 misses enqueued, 0 pending" in port.stdout
    port, ref = _both(dirs, ["oracle", "fsck", "--out", "cache"])
    assert port.stdout == ref.stdout and "(oracle, 3 shards)" in port.stdout


def test_predict_cli_equals_reference(stores, dirs):
    census, _ = stores
    port, ref = _both(dirs, ["predict", "train", "--census", census, "--out", "m.json"])
    assert port.stdout == ref.stdout and "(instance, algorithm) rows" in port.stdout
    assert (dirs / "port" / "m.json").read_bytes() == (dirs / "ref" / "m.json").read_bytes()
    for extra in ([], ["--json", "--threshold", "0.9"]):
        port, ref = _both(dirs, ["predict", "predict", "--census", census, "--model", "m.json"] + extra)
        assert (port.stdout, port.stderr) == (ref.stdout, ref.stderr)
        assert "instances would skip measurement" in port.stderr
    for extra in ([], ["--json"]):
        port, ref = _both(dirs, ["predict", "eval", "--census", census, "--model", "m.json"] + extra)
        assert port.stdout == ref.stdout
    assert "would skip" in port.stdout or "skipped" in port.stdout


def test_oracle_serve_answers_every_line(stores, dirs):
    """`oracle serve --queries F --refresh` answers every line as the
    reference's does (the refresher drains the misses on the plain
    versions; the answers come from the cache as opened, reloaded every 100
    queries)."""
    census, explain = stores
    lines = QUERIES * 3
    for name in ("port", "ref"):
        (dirs / name / "q.jsonl").write_text("".join(json.dumps(q) + "\n\n" for q in lines))
    _both(dirs, ["oracle", "warm", "--out", "cache", "--census", census, "--explain", explain])
    port = _cli("repro_torch", ["oracle", "serve", "--out", "cache", "--queries", "q.jsonl", "--refresh",
                                "--poll", "0.1", "--device", "cpu"], dirs / "port")
    ref = _cli("repro", ["oracle", "serve", "--out", "cache", "--queries", "q.jsonl", "--refresh",
                         "--poll", "0.1"], dirs / "ref")
    verdicts = port.stdout.splitlines()
    assert len(verdicts) == len(lines) and port.stdout == ref.stdout
    assert port.stderr.splitlines()[-1] == ref.stderr.splitlines()[-1] \
        == f"# served {len(lines)} verdicts: hit rate 0.60"
    assert "refresh pass failed" not in port.stderr


def test_oracle_serve_refresh_needs_a_card_for_cuda(stores, dirs):
    """Without a card, the refresher of `serve --refresh` on a wall-clock
    census's cache fails its passes (the default device is the card) and
    the server keeps answering, as the reference's prints a failed pass and
    goes on; the miss stays pending, and `oracle status` shows it."""
    census, _ = stores
    wall = dirs / "wall"
    wall.mkdir()
    doc = json.loads(Path(census, "spec.json").read_text())
    doc["backend"] = "wall_clock"
    (wall / "spec.json").write_text(json.dumps(doc))
    _cli("repro_torch", ["oracle", "warm", "--out", "cache", "--census", str(wall)], dirs / "port")
    _cli("repro_torch", ["oracle", "query", "--out", "cache", "--family", QUERIES[2]["family"],
                         "--params", json.dumps(QUERIES[2]["params"])], dirs / "port")
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from repro_torch.launch.cli import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    proc = subprocess.Popen([sys.executable, "-c", code, "oracle", "serve", "--out", "cache", "--refresh",
                             "--poll", "0.2"], env=_env(), cwd=dirs / "port", text=True,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        first = proc.stderr.readline()  # blocks until the refresher's first pass has failed
        out, err = proc.communicate(json.dumps(QUERIES[2]) + "\n", timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert first.startswith("# refresh pass failed:") and "device='cpu'" in first
    assert len(out.splitlines()) == 1 and '"confidence":"model_only"' in out
    status = _cli("repro_torch", ["oracle", "status", "--out", "cache"], dirs / "port")
    assert "1 misses enqueued, 1 pending" in status.stdout
