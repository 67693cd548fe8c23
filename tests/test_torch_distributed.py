"""The port's sharding plans, cell plans, per-device counts, dry run and
§Perf campaigns against the JAX package's, on the CPU.

* Plans are held exactly: for every architecture's FULL config on both
  production meshes every leaf's spec and every fallback string equals the
  reference's, built on a ``jax.sharding.AbstractMesh`` (a plan needs only
  axis names and sizes); so do the activation and decode-state specs, the
  strategies, the microbatch counts and the sharding options' notes.
* Cells run rank 0's shard on a ``fake`` process group of eight ranks (one
  per module): the reference's small-mesh cell tests, 2x4 and 2x2x2, on
  granite-8b SMOKE. Fake collectives move no data, so no value is asserted:
  the counts and that the step runs are.
* The analyzer's per-device FLOPs of the reference's DTensor MLP are within
  2 % of the mesh's total over eight, with an all-reduce of nonzero bytes.
* ``perf --rank-labels`` campaign states and ``reanalyze --campaign``
  output are byte-identical to the reference's for the same logged rows
  (each package in its own process: the reference's perf module sets a
  512-device XLA flag when imported).
"""

import functools
import gzip
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding, PartitionSpec  # noqa: E402

import repro.distributed.sharding as RS  # noqa: E402
import repro.launch.specs as RSP  # noqa: E402
from repro.configs import ARCH_NAMES, SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.shapes import ShapeSpec  # noqa: E402
from repro.models import init_encdec_state as ref_encdec_state  # noqa: E402
from repro.models import init_lm_state as ref_lm_state  # noqa: E402

import repro_torch.distributed.sharding as PS  # noqa: E402
import repro_torch.launch.specs as PSP  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_encdec_state, init_lm_state  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec):
    """A spec's entries as None or tuples of names (jax prints a one-name
    entry as the bare name)."""
    return tuple(None if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec)


def _meshes(label):
    sizes, names = MESHES[label]
    return AbstractMesh(sizes, names), PS.AbstractMesh(sizes, names)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    return RSP.param_shapes(ref_config(arch))


# ------------------------------------------------------------------ plans --

@pytest.mark.parametrize("label", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_plan_matches_reference_leaf_for_leaf(arch, label):
    rmesh, pmesh = _meshes(label)
    r_shapes, r_axes = _ref_param_shapes(arch)
    p_shapes, p_axes = PSP.param_shapes(get_config(arch))
    rplan = RS.make_plan(ref_config(arch), rmesh)
    pplan = PS.make_plan(get_config(arch), pmesh)
    assert (pplan.attention, pplan.experts) == (rplan.attention, rplan.experts)
    assert pplan.rules == rplan.rules
    r_sh = dict(_leaves(RS.tree_shardings(rplan, r_axes, r_shapes)))
    p_sh = dict(_leaves(PS.tree_shardings(pplan, p_axes, p_shapes)))
    assert set(r_sh) == set(p_sh)
    for path, sh in r_sh.items():
        assert p_sh[path].spec == _norm(sh.spec), path
        assert tuple(dict(_leaves(p_shapes))[path].shape) == tuple(dict(_leaves(r_shapes))[path].shape)
    assert pplan.fallbacks == rplan.fallbacks


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_state_and_activation_specs_match_reference(arch):
    rc, pc = ref_config(arch), get_config(arch)
    for label in MESHES:
        rmesh, pmesh = _meshes(label)
        for b in (1, 3, 16, 128, 256):
            assert _norm(PS.batch_spec(pmesh, b, 1)) == _norm(RS.batch_spec(rmesh, b, 1))
            assert _norm(PS.batch_spec(pmesh, b, 2)) == _norm(RS.batch_spec(rmesh, b, 2))
            assert _norm(PS.cache_seq_spec(pmesh, b)) == _norm(RS.cache_seq_spec(rmesh, b))
        for shape in ("decode_32k", "long_500k"):
            b, s = SHAPES[shape].global_batch, SHAPES[shape].seq_len
            if rc.is_encoder_decoder:
                r_st = jax.eval_shape(lambda: ref_encdec_state(rc, b, s, rc.encoder_seq))
                p_st = init_encdec_state(pc, b, s, pc.encoder_seq, device="meta")
            else:
                r_st = jax.eval_shape(lambda: ref_lm_state(rc, b, s))
                p_st = init_lm_state(pc, b, s, device="meta")
            r_sp = dict(_leaves(RS.state_specs(rc, RS.make_plan(rc, rmesh, "decode"), r_st, b)))
            p_sp = dict(_leaves(PS.state_specs(pc, PS.make_plan(pc, pmesh, "decode"), p_st, b)))
            assert set(r_sp) == set(p_sp)
            for path, sh in r_sp.items():
                assert p_sp[path].spec == _norm(sh.spec), (label, shape, path)


def test_strategies_match_reference():
    for arch in ARCH_NAMES:
        for tp in (1, 2, 4, 8, 16, 32):
            assert PS.attention_strategy(get_config(arch), tp) == RS.attention_strategy(ref_config(arch), tp)
            assert PS.expert_strategy(get_config(arch), tp) == RS.expert_strategy(ref_config(arch), tp)


@pytest.mark.parametrize("label", sorted(MESHES))
def test_microbatches_and_sharding_opts_match_reference(label):
    rmesh, pmesh = _meshes(label)
    for arch in ARCH_NAMES:
        rc, pc = ref_config(arch), get_config(arch)
        for shape in SHAPES.values():
            for seq_sharded in (False, True):
                assert PSP.pick_microbatches(pc, shape, pmesh, seq_sharded) == \
                    RSP.pick_microbatches(rc, shape, rmesh, seq_sharded)
            if shape.kind == "decode":
                continue
            training = shape.kind == "train"
            r = RSP._sharding_opts(rc, shape, rmesh, RS.make_plan(rc, rmesh), {}, training)
            p = PSP._sharding_opts(pc, shape, pmesh, PS.make_plan(pc, pmesh), {}, training)
            for rs, ps in zip(r[:4], p[:4]):
                assert (ps is None) == (rs is None)
                if rs is not None:
                    assert ps.spec == _norm(rs.spec)
            assert p[4:] == r[4:], (arch, shape.name)


def test_spec_divisibility_fallback_and_placements():
    from repro_torch.launch.compat import Replicate, Shard
    from repro_torch.models import ModelConfig

    mesh = PS.AbstractMesh((2, 4), ("data", "model"))
    cfg = ModelConfig(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=65)
    plan = PS.make_plan(cfg, mesh)
    assert plan.spec_for(("vocab", "embed"), (65, 64)) == (None, ("data",))
    assert plan.fallbacks == ["axis 'vocab' dim 65 !% mesh('model',) -> replicated"]
    mesh3 = PS.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert PS.placements(mesh3, PS.Spec(("pod", "data"), None, ("model",))) == (Shard(0), Shard(0), Shard(2))
    assert PS.placements(mesh3, PS.Spec(None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        PS.placements(mesh3, PS.Spec(("data", "pod")))


def test_local_slices_match_reference_device_shards():
    """Each device's slice under a spec, the one over two axes included,
    is the one jax gives the device at the same mesh coordinate."""
    sizes, names = (2, 2, 2), ("pod", "data", "model")
    jmesh = jax.make_mesh(sizes, names, devices=jax.devices()[:8])
    pmesh = PS.AbstractMesh(sizes, names)
    shape = (8, 16, 4)
    for spec in [(("pod", "data"), None, ("model",)), (None, ("pod", "data", "model"), None),
                 (("data",), ("model",), None), (None, None, None)]:
        idx = JNamedSharding(jmesh, PartitionSpec(*spec)).devices_indices_map(shape)
        for coord in np.ndindex(*sizes):
            dev = jmesh.devices[coord]
            want = tuple((s.start or 0, s.stop if s.stop is not None else n) for s, n in zip(idx[dev], shape))
            got = PS.local_slices(pmesh, spec, shape, dict(zip(names, coord)))
            assert tuple((s.start, s.stop) for s in got) == want, (spec, coord)


def test_h100_machine_and_registry_unchanged():
    from repro.roofline.terms import DEFAULT_MACHINE as REF_DEFAULT
    from repro.roofline.terms import MACHINES as REF_MACHINES
    from repro_torch.roofline.terms import DEFAULT_MACHINE, H100_SXM_BF16, MACHINES

    h100 = H100_SXM_BF16
    assert (h100.peak_flops, h100.hbm_bw, h100.ici_bw) == (989e12, 3.35e12, 50e9)
    assert h100.name not in MACHINES and set(MACHINES) == set(REF_MACHINES)
    assert DEFAULT_MACHINE.to_dict() == REF_DEFAULT.to_dict()


def test_paper_chain_instances_match_reference():
    from repro.configs import paper_chain as ref
    from repro_torch.configs import paper_chain as port

    for smoke in (False, True):
        r, p = ref.get_instances(smoke), port.get_instances(smoke)
        assert list(r) == list(p)
        assert all(tuple(r[k].dims) == tuple(p[k].dims) for k in r)


# ------------------------------------------------------- cells on a fake PG --

@pytest.fixture(scope="module")
def fake_pg():
    from repro_torch.launch.compat import destroy_process_group, init_process_group

    init_process_group("fake", world_size=8, rank=0)
    yield
    destroy_process_group()


def _run_cell(cell):
    from repro_torch.launch.compat import implicit_replication
    from repro_torch.roofline.counts import CountingMode

    fn, args = cell.build("cpu")
    with implicit_replication(), CountingMode() as mode:
        fn(*args)
    return mode.counts


@pytest.mark.parametrize("shape", [
    ShapeSpec("t", 128, 8, "train"),
    ShapeSpec("p", 256, 8, "prefill"),
    ShapeSpec("d", 256, 8, "decode"),
])
def test_build_cell_runs_small_mesh(fake_pg, shape):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(n_pods=1, dp=2, tp=4, device_type="cpu")
    cell = PSP.build_cell("granite-8b", get_config("granite-8b", smoke=True), shape, mesh)
    counts = _run_cell(cell)
    assert counts.flops > 0 and counts.bytes > 0
    rcell = RSP.build_cell("granite-8b", ref_config("granite-8b", smoke=True), shape,
                           jax.make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8]))
    assert (cell.num_microbatches, cell.attention_strategy, cell.notes) == \
        (rcell.num_microbatches, rcell.attention_strategy, rcell.notes)


def test_build_cell_multipod_smoke(fake_pg):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(n_pods=2, dp=2, tp=2, device_type="cpu")
    cell = PSP.build_cell("granite-8b", get_config("granite-8b", smoke=True), ShapeSpec("t", 64, 8, "train"), mesh)
    counts = _run_cell(cell)
    # gradient sync must span the pod axis: some collective exists
    assert counts.total_collective_bytes > 0


def test_analyzer_collectives_and_per_device_flops(fake_pg):
    from repro_torch.launch.compat import DTensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline.counts import CountingMode

    mesh = make_mesh(n_pods=1, dp=2, tp=4, device_type="cpu")
    g = torch.Generator().manual_seed(0)

    def dt(shape, spec):
        sh = PS.NamedSharding(mesh, PS.Spec(*spec))
        return PS.from_local(torch.randn(PS.local_shape(sh, shape), generator=g), sh, shape)

    x, w1, w2 = dt((64, 256), (("data",), None)), dt((256, 512), (None, ("model",))), dt((512, 256), (("model",), None))
    out_sh = PS.NamedSharding(mesh, PS.Spec(("data",), None))
    with CountingMode() as mode:
        y = (torch.relu(x @ w1) @ w2).redistribute(mesh, out_sh.placements)
    assert isinstance(y, DTensor)
    counts = mode.counts
    total = 2 * 64 * 256 * 512 * 2
    assert abs(counts.flops / (total / 8) - 1) < 0.02
    assert counts.collective_bytes.get("all-reduce", 0) > 0


def test_breakdown_and_score_traffic_from_records():
    from repro_torch.roofline.counts import CountingMode, attention_score_traffic, breakdown_by_opcode

    b, h, s, d = 2, 2, 64, 8
    q, k = torch.randn(b, h, s, d), torch.randn(b, h, s, d)
    with CountingMode() as mode:
        torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k), dim=-1)
    recs = mode.records()
    table = breakdown_by_opcode(recs)
    assert sum(r["flops"] for r in table.values()) == pytest.approx(2.0 * b * h * s * s * d)
    traffic = attention_score_traffic(recs, [s])
    assert traffic >= 4 * b * h * s * s
    assert attention_score_traffic(recs, [s + 1]) == 0.0
    # the cached (list) form gives the same
    assert attention_score_traffic([r.to_list() for r in recs], [s]) == traffic


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")


def test_dryrun_cli_on_cpu_caches_counts(tmp_path):
    out = tmp_path / "dryrun_2x4.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu", "--smoke",
         "--mesh-shape", "2x4", "--arch", "granite-moe-3b-a800m", "--shape", "train:64:8", "--out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    (row,) = json.loads(out.read_text())
    assert row["status"] == "ok" and row["mesh"] == "2x4" and row["machine"] == "h100-sxm-bf16"
    for key in ("mem_per_dev_gb", "fit_attempts", "num_microbatches", "attention_strategy", "notes",
                "t_compute_s", "t_memory_s", "t_collective_s", "dominant", "params_total", "params_active"):
        assert key in row
    assert float(row["hlo_flops_per_dev"]) > 0 and row["collectives"]
    assert row["attention_strategy"] == PS.attention_strategy(get_config("granite-moe-3b-a800m", smoke=True), 4)
    cached = tmp_path / "counts" / "granite-moe-3b-a800m_train:64:8_2x4.json.gz"
    from repro_torch.roofline.counts import analyze

    counts = analyze(json.load(gzip.open(cached, "rt")))
    assert f"{counts.flops:.4e}" == row["hlo_flops_per_dev"]


# -------------------------------------------------------------- campaigns --

_ROWS = [
    {"arch": "granite-8b", "shape": "train_4k", "label": lbl, "hlo_flops_per_dev": f"{f:.4e}",
     "kernel_adjusted": {"t_compute_s": tc, "t_memory_s": tm, "t_collective_s": tx}}
    for lbl, f, tc, tm, tx in [("base", 1.1e15, 0.91, 0.52, 0.13), ("micro8", 1.1e15, 0.93, 0.41, 0.13),
                               ("nosp", 1.2e15, 0.99, 0.77, 0.31)]
]

_CAMPAIGN = (
    "import json, os, sys\n"
    "import {pkg}.launch.perf as P\n"
    "P.LOG = os.path.abspath('log.json'); P.ROOT = os.getcwd()\n"
    "P.campaign_path = lambda a, s: os.path.abspath('state.json')\n"
    "r = P.rank_logged_labels('granite-8b', 'train_4k', max_steps={steps}, resume={resume})\n"
    "print(r.summary())\n"
)


def _campaign(pkg, cwd, steps, resume=False):
    code = _CAMPAIGN.format(pkg=pkg, steps=steps, resume=resume)
    res = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=cwd, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def _state_bytes(path):
    """A campaign state's bytes with the engine's wall-clock start time
    blanked: it differs between two runs of either package."""
    return re.sub(rb'"t_start": [0-9.e+-]+', b'"t_start": 0', path.read_bytes())


def test_rank_labels_campaign_state_byte_identical(tmp_path):
    outs = {}
    for pkg in ("repro", "repro_torch"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "log.json").write_text(json.dumps(_ROWS))
        first = _campaign(pkg, d, steps=3)
        part = _state_bytes(d / "state.json")
        rest = _campaign(pkg, d, steps=None, resume=True)
        outs[pkg] = (first, part, rest, _state_bytes(d / "state.json"))
    assert outs["repro_torch"] == outs["repro"]


def test_reanalyze_campaign_output_byte_identical(tmp_path):
    outs = {}
    for pkg in ("repro", "repro_torch"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "log.json").write_text(json.dumps(_ROWS))
        _campaign(pkg, d, steps=None)
        res = subprocess.run([sys.executable, "-m", f"{pkg}.launch.reanalyze", "--campaign", "state.json"],
                             env=_env(), cwd=d, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        outs[pkg] = res.stdout
    assert outs["repro_torch"] == outs["repro"]


def test_report_tables_match_reference(tmp_path, monkeypatch):
    import repro.launch.report_md as RM
    import repro_torch.launch.report_md as PM

    rows = [
        {"arch": "granite-8b", "shape": "train_4k", "status": "ok", "t_compute_s": 1.5, "t_memory_s": 0.25,
         "t_collective_s": 0.5, "dominant": "compute", "model_hlo_ratio": 0.9, "roofline_fraction": 0.41,
         "mem_per_dev_gb": 12.5, "num_microbatches": 2, "attention_strategy": "head"},
        {"arch": "granite-8b", "shape": "long_500k", "status": "skipped", "reason": "pure full attention"},
        {"arch": "whisper-tiny", "shape": "decode_32k", "status": "error", "error": "RuntimeError: x"},
    ]
    perf = [{"arch": "granite-8b", "shape": "train_4k", "label": "it1", "t_compute_s": 1.0, "t_memory_s": 2.0,
             "t_collective_s": 0.5, "mem_per_dev_gb": 3.0, "roofline_fraction": 0.2,
             "kernel_adjusted": {"roofline_fraction": 0.3}, "hypothesis": "h"}]
    (tmp_path / "reports").mkdir()
    for name, data in (("dryrun_16x16.json", rows), ("perf_iterations.json", perf)):
        (tmp_path / "reports" / name).write_text(json.dumps(data))
    monkeypatch.setattr(RM, "ROOT", str(tmp_path))
    monkeypatch.setattr(PM, "REPORT_DIR", str(tmp_path / "reports"))
    assert PM.roofline_table("16x16") == RM.roofline_table("16x16")
    assert PM.perf_table() == RM.perf_table().replace("frac (XLA)", "frac (plain)")
