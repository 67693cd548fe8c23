"""The port's ranking core (``repro_torch.core``) against the JAX package's
(``repro.core``): Procedures 1-4, the engine and its saved campaigns must
agree exactly (tolerance 0: the deterministic backends draw the same numpy
streams and the analysis is the same float64 arithmetic). Also the guards
that keep the port free of jax and of ``repro``."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_SRC = REPO / "src" / "repro_torch"


def _profiles(seed, n=5):
    """Noise profiles made with numpy from a seed, as plain dicts."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        out[f"alg{i}"] = dict(
            base=float(rng.uniform(1e-3, 2e-3)),
            rel_sigma=float(rng.uniform(0.01, 0.1)),
            bimodal_shift=float(rng.uniform(0.0, 0.3)),
            bimodal_prob=float(rng.choice([0.0, 0.2])),
            outlier_prob=float(rng.choice([0.0, 0.05])),
        )
    return out


def _timer(pkg, kind, seed):
    profiles = _profiles(seed)
    if kind == "simulated":
        return pkg.SimulatedTimer(
            {k: pkg.NoiseProfile(**v) for k, v in profiles.items()}, seed=seed
        )
    costs = {k: v["base"] for k, v in profiles.items()}
    rel_sigma = 0.0 if kind == "cost_model_exact" else 0.05
    return pkg.CostModelTimer(costs, rel_sigma=rel_sigma, seed=seed)


KINDS = ["simulated", "cost_model", "cost_model_exact"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_measure_and_rank_parity(kind, seed):
    h0 = sorted(_profiles(seed))
    kw = dict(m_per_iteration=3, eps=0.03, max_measurements=30, shuffle_seed=seed)
    r_ref = ref.measure_and_rank(h0, _timer(ref, kind, seed), **kw)
    r_port = port.measure_and_rank(h0, _timer(port, kind, seed), **kw)
    assert dataclasses.asdict(r_port) == dataclasses.asdict(r_ref)
    assert r_port.ranks == r_ref.ranks


@pytest.mark.parametrize("seed", range(4))
def test_mean_ranks_and_discriminant_parity(seed):
    rng = np.random.default_rng(seed)
    names = [f"a{i}" for i in range(6)]
    meas = {n: list(rng.normal(1.0 + 0.05 * i, 0.04, size=12)) for i, n in enumerate(names)}
    mr_ref = ref.mean_ranks(names, meas)
    mr_port = port.mean_ranks(names, meas)
    assert dataclasses.asdict(mr_port) == dataclasses.asdict(mr_ref)

    flops = {n: float(rng.choice([10, 10, 12, 15])) for n in names}
    single = {n: float(np.median(v)) for n, v in meas.items()}
    c_ref = ref.filter_candidates(flops, single, rt_threshold=0.1)
    c_port = port.filter_candidates(flops, single, rt_threshold=0.1)
    assert dataclasses.asdict(c_port) == dataclasses.asdict(c_ref)
    assert port.initial_hypothesis_by_time(single) == ref.initial_hypothesis_by_time(single)

    ranking_ref = ref.measure_and_rank(c_ref.names, ref.CostModelTimer(single))
    ranking_port = port.measure_and_rank(c_port.names, port.CostModelTimer(single))
    d_ref = ref.flops_discriminant_test(ranking_ref, flops)
    d_port = port.flops_discriminant_test(ranking_port, flops)
    assert dataclasses.asdict(d_port) == dataclasses.asdict(d_ref)


def _engine(pkg, policy):
    engine = pkg.ExperimentEngine(policy=policy)
    for i, kind in enumerate(KINDS):
        timer = _timer(pkg, kind, seed=10 + i)
        order = sorted(_profiles(10 + i))
        engine.add_session(
            pkg.MeasurementSession(
                f"{kind}_{i}", order, timer, m_per_iteration=2,
                max_measurements=12, shuffle_seed=i,
            )
        )
    return engine


def _results(engine):
    return {k: dataclasses.asdict(v) for k, v in engine.results().items()}


@pytest.mark.parametrize("policy", ["round_robin", "least_converged_first"])
def test_engine_campaign_parity(policy, tmp_path):
    e_ref, e_port = _engine(ref, policy), _engine(port, policy)
    e_ref.run(max_steps=4)
    e_port.run(max_steps=4)
    assert json.dumps(e_port.to_dict()) == json.dumps(e_ref.to_dict())
    e_ref.run()
    e_port.run()
    assert e_port.done and e_ref.done
    assert _results(e_port) == _results(e_ref)
    p_ref = e_ref.save(str(tmp_path / "ref.json"))
    p_port = e_port.save(str(tmp_path / "port.json"))
    assert Path(p_port).read_bytes() == Path(p_ref).read_bytes()


def test_reference_saved_campaign_resumes_in_port(tmp_path):
    """A campaign the reference saved mid-run loads in the port and finishes
    exactly as the reference finishes it."""
    path = str(tmp_path / "campaign.json")
    e = _engine(ref, "round_robin")
    e.run(max_steps=3)
    e.save(path)

    r_ref = ref.ExperimentEngine.load(path)
    r_port = port.ExperimentEngine.load(path)
    assert _results(r_port) == _results(r_ref)
    r_ref.run()
    r_port.run()
    assert _results(r_port) == _results(r_ref)
    assert json.dumps(r_port.to_dict()) == json.dumps(r_ref.to_dict())


def test_wallclock_timer_on_cpu_tensors():
    a = torch.randn(32, 32)
    timer = port.WallClockTimer({"mm": lambda: a @ a}, min_time_s=1e-3)
    samples = timer.measure_many("mm", 4)
    assert len(samples) == 4 and all(t > 0 for t in samples)
    assert timer.inner_repeats["mm"] >= 1
    assert port.timer_to_dict(timer) == {"kind": "wall_clock", "workloads": ["mm"]}


def test_wallclock_timer_refuses_unsynchronised_workload(monkeypatch):
    """Where CUDA is initialised, a workload whose post-call synchronise
    costs more than the call itself is refused (here a fake device that
    stays busy for 5 ms after every call)."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: time.sleep(5e-3))
    timer = port.WallClockTimer({"async": lambda: None})
    with pytest.raises(RuntimeError, match="not blocking"):
        timer.measure("async")


def test_wallclock_timer_accepts_synchronised_workload(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    timer = port.WallClockTimer({"sync": lambda: time.sleep(2e-4)})
    assert timer.measure("sync") > 0
    assert timer.inner_repeats == {"sync": 1}


def test_port_core_exports_match_reference_minus_census():
    """The name is the one it had before the census was ported; the port's
    core now exports everything the reference's does."""
    assert set(port.__all__) == set(ref.__all__)
    assert all(hasattr(port, n) for n in port.__all__)


# ------------------------------------------------------------------ guards --

def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_reference():
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert len(examples) == 6
    files = sorted(PORT_SRC.rglob("*.py")) + examples + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = {
        (str(f.relative_to(REPO)), root)
        for f in files
        for root in _imported_roots(f)
        if root in {"jax", "jaxlib", "repro"}
    }
    assert not bad


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.core, repro_torch.expressions, repro_torch.autotune\n"
        "import repro_torch.kernels.matmul.ops\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.kernels.ssd.ops\n"
        "import repro_torch.models.attention, repro_torch.models.mamba2\n"
        "import repro_torch.core.sweep, repro_torch.launch.cli\n"
        "import repro_torch.expressions.generalized\n"
        "import repro_torch.explain, repro_torch.explain.runner, repro_torch.roofline\n"
        "import repro_torch.graphs, repro_torch.launch.explain\n"
        "import repro_torch.predict, repro_torch.serve.oracle, repro_torch.api\n"
        "import repro_torch.launch.oracle, repro_torch.launch.predict\n"
        "import repro_torch.train, repro_torch.data, repro_torch.checkpoint, repro_torch.distributed\n"
        "import repro_torch.launch.train, repro_torch.train.elastic\n"
        "from repro_torch import run_census, query\n"
        "import importlib, pkgutil, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')\n"
        "        if not m.name.endswith('__main__')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert {'repro_torch.models.model', 'repro_torch.serve.engine', 'repro_torch.launch.serve',\n"
        "        'repro_torch.configs.qwen2_moe_a2_7b', 'repro_torch.train.trainer', 'repro_torch.train.ft',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.checkpoint.manager',\n"
        "        'repro_torch.distributed.compression', 'repro_torch.distributed.sharding',\n"
        "        'repro_torch.distributed.pipeline', 'repro_torch.launch.compat', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.launch.specs', 'repro_torch.launch.dryrun', 'repro_torch.launch.perf',\n"
        "        'repro_torch.launch.reanalyze', 'repro_torch.launch.finalize_experiments',\n"
        "        'repro_torch.roofline.counts', 'repro_torch.configs.paper_chain'} <= set(mods), mods\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "assert not [m for m, mod in sys.modules.items()"
        " if mod is not None and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("modules", [
    ("repro_torch.launch.sweep", "repro_torch.core.sweep"),      # the census planner
    ("repro_torch.launch.fsck", "repro_torch.launch.queue"),
    ("repro_torch.serve.oracle", "repro_torch.launch.oracle", "repro_torch.predict"),  # an oracle query
    ("repro_torch.launch.explain", "repro_torch.core", "repro_torch.device"),
])
def test_host_only_surfaces_import_without_torch(modules):
    """The census, fsck and oracle surfaces touch no device and import no
    torch, as the reference's import no jax (its census workers never do)."""
    code = (
        "import importlib, sys\n"
        f"for m in {list(modules)!r}: importlib.import_module(m)\n"
        "leaked = sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.'))\n"
        "assert not leaked, leaked[:5]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
