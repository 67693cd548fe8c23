"""Elastic training across processes on a ``DeviceMesh``, the sharded
checkpoint restore and the dense MoE dispatch on DTensors, each run by
eight spawned ``gloo`` ranks on the CPU and held against the JAX package's
on eight host devices, from the same numpy weights
(``init_lm_params(CFG, PRNGKey(0))``, CFG the reference's system-test
config); and the training launcher under ``torchrun`` with four ranks.

One spawn serves the ranks' cases (a module fixture): the ranks run every
case in turn (the dense MoE dispatch, the reference's checkpoint restored
onto a port mesh and saved again from DTensors, 12 steps uninterrupted on
dp 4 x tp 2, the membership change dp 4 x tp 2 -> dp 2 x tp 2 before step 6
with ranks 4-7 leaving, auto-resume on the survivors' mesh), write their
results to ``.npz`` files, and the tests compare. Each rank runs with one
intra-op thread.

Tolerances: the losses within ``TRAIN_RTOL`` (as ``test_torch_pipeline.py``:
f32 sums in other orders across the steps of AdamW) of the reference's
``ElasticTrainer`` at every step, and of the uninterrupted run; auto-resume
bit for bit (the same mesh, the same restored bytes); checkpoints restored
across packages and meshes exactly; the sharded dense MoE forward within
``MOE_TOL`` (relative to the largest) of the reference's sharded dense
forward, its loss within ``MOE_TOL`` of the reference's, and two dense
training steps within ``TRAIN_RTOL``."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from test_torch_pipeline import _flat, _unflat

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
JOIN_TIMEOUT_S = 300
TRAIN_RTOL = 1e-4
MOE_TOL = 1e-5
CFG_KW = dict(name="sys-test", n_layers=4, d_model=64, n_heads=8, n_kv_heads=4,
              d_ff=128, vocab_size=512, dtype="float32", param_dtype="float32")
DATA_KW = dict(vocab_size=512, seq_len=32, global_batch=8)
SCHEDULE = (1e-3, 2, 50)
STEPS, EVENTS, CKPT_EVERY = 12, {6: 2}, 4
REF_CKPT_STEP = 3
# qwen2-moe-a2.7b SMOKE on dp 2 x tp 4: 8 experts split over `model`
# (expert parallelism); 6 experts do not divide 4, so each expert's d_ff is
# split instead (the `tensor` strategy)
MOE_CASES = {"expert": {}, "tensor": {"n_experts": 6, "top_k": 2}}
MOE_DATA = dict(vocab_size=512, seq_len=16, global_batch=4)
MOE_STEPS = 2


def _moe_cfg(package, name):
    return package.get_config("qwen2-moe-a2.7b", smoke=True).replace(**MOE_CASES[name])


# ------------------------------------------------------------------- ranks --

def _value(v) -> float:
    return float(v.full_tensor() if hasattr(v, "full_tensor") else v)


def _rank_main(rank: int, port: int, tmp: str) -> None:
    """One gloo rank: every case, results to ``out<rank>.npz``."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import NamedSharding, batch_spec, make_plan, shard_tensor, shard_tree, tree_shardings
    from repro_torch.distributed.sharding import local_shape, local_slices, mesh_coordinate
    from repro_torch.launch.compat import ElasticGroup, implicit_replication, make_mesh, mesh_axis_sizes
    from repro_torch.launch.mesh import make_mesh as make_train_mesh
    from repro_torch.models import ForwardOptions, ModelConfig, init_lm_params, lm_forward
    from repro_torch.models.layers import params_from_numpy
    from repro_torch.train import (AdamW, AdamWState, ElasticConfig, ElasticTrainer, LossConfig, TrainState,
                                   cosine_schedule, init_train_state, make_loss_fn, make_train_step)

    torch.set_num_threads(1)
    tmp = Path(tmp)
    group = ElasticGroup("gloo", rank, WORLD, f"tcp://localhost:{port}")
    inp = dict(np.load(tmp / "inputs.npz"))
    out = {}

    def tree(prefix):
        return _unflat({k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)})

    try:
        # 5. the dense MoE dispatch (and the gather dispatch) on DTensors
        mesh24 = make_mesh((2, 4), ("data", "model"), "cpu")
        bsh = NamedSharding(mesh24, batch_spec(mesh24, MOE_DATA["global_batch"], 1))
        data = SyntheticLM(DataConfig(**MOE_DATA))
        for name in MOE_CASES:
            cfg = _moe_cfg(configs, name)
            _, axes = init_lm_params(cfg, device="meta")
            plan = make_plan(cfg, mesh24, mode="train")
            out[f"moe_{name}_strategy"] = np.array(plan.experts)

            def sharded():
                full = params_from_numpy(tree(f"m{name}:"), "cpu")
                return shard_tree(full, tree_shardings(plan, axes, full))

            def batch(i):
                return {k: shard_tensor(torch.as_tensor(v), bsh) for k, v in data.batch(i).items()}

            params = sharded()
            for dispatch in ("dense", "gather"):
                opts = ForwardOptions(attn_impl="reference", moe_dispatch=dispatch)
                with implicit_replication():
                    logits, aux = lm_forward(cfg, params, tokens=batch(0)["tokens"], opts=opts)
                    loss, _ = make_loss_fn(cfg, opts, LossConfig())(params, batch(0))
                out[f"moe_{name}_{dispatch}_logits"] = logits.full_tensor().numpy()
                out[f"moe_{name}_{dispatch}_aux"] = np.array(_value(aux))
                out[f"moe_{name}_{dispatch}_loss"] = np.array(_value(loss))
            opt = AdamW(schedule=cosine_schedule(*SCHEDULE))
            state = init_train_state(cfg, opt, sharded())
            step = make_train_step(cfg, opt, ForwardOptions(attn_impl="reference", moe_dispatch="dense"))
            metrics = []
            with implicit_replication():
                for i in range(MOE_STEPS):
                    state, m = step(state, batch(i))
                    metrics.append([_value(m[k]) for k in ("loss", "grad_norm")])
            out[f"moe_{name}_train"] = np.array(metrics)
        del params, state

        # 4. the reference's checkpoint restored onto a port mesh, leaf by
        # leaf, each rank holding only its shard; then saved from DTensors
        cfg = ModelConfig(**CFG_KW)
        meta, axes = init_lm_params(cfg, device="meta")
        like = init_train_state(cfg, AdamW(schedule=cosine_schedule(*SCHEDULE)), meta)
        psh = tree_shardings(make_plan(cfg, mesh24, mode="train"), axes, meta)
        shardings = TrainState(params=psh, opt=AdamWState(step=None, master=psh, mu=psh, nu=psh))
        state, step_no, extra = restore_checkpoint(str(tmp / "ref_ckpt"), like, shardings=shardings)
        placed = dict(_flatten_with_paths(shardings))
        exact, local_shapes, n_sharded = True, True, 0
        with np.load(tmp / "ref_ckpt" / f"step_{REF_CKPT_STEP:08d}" / "arrays_0.npz") as ref:
            for key, leaf in _flatten_with_paths(state):
                want = ref[key]
                if key in placed:
                    sh = placed[key]
                    local = leaf.to_local()
                    n_sharded += local.numel() < want.size
                    local_shapes &= tuple(local.shape) == local_shape(sh, want.shape)
                    want = want[local_slices(mesh24, sh.spec, want.shape, mesh_coordinate(mesh24))]
                    exact &= np.array_equal(local.numpy(), want)
                else:
                    exact &= np.array_equal(np.asarray(leaf), want)
        out["ref_restore"] = np.array([exact, local_shapes, n_sharded, step_no, extra["next_step"]])
        CheckpointManager(str(tmp / "port_ckpt")).save(step_no, state, extra=extra)
        del state

        # 2 and 1: the reference's ElasticTrainer sequence, on dp 4 x tp 2
        def trainer(directory):
            return ElasticTrainer(
                cfg, AdamW(schedule=cosine_schedule(*SCHEDULE)), SyntheticLM(DataConfig(**DATA_KW)),
                CheckpointManager(str(tmp / directory), keep=3),
                make_mesh_fn=lambda n: make_train_mesh(n_pods=1, dp=n, tp=2, device_type="cpu"),
                opts=ForwardOptions(attn_impl="reference"), elastic_cfg=ElasticConfig(checkpoint_every=CKPT_EVERY),
                device="cpu", group=group, mesh_size_fn=lambda n: 2 * n)

        def init():
            return params_from_numpy(tree("p:"), "cpu")

        straight = trainer("straight")
        straight.start(n_hosts=4, init_params_fn=init)
        out["straight"] = np.array([h["loss"] for h in straight.run(STEPS)])
        del straight

        elastic = trainer("elastic")
        elastic.start(n_hosts=4, init_params_fn=init)
        history = elastic.run(STEPS, membership_events=dict(EVENTS))
        out["steps"] = np.array([h["step"] for h in history])
        out["losses"] = np.array([h["loss"] for h in history])
        out["left"] = np.array(elastic.left)
        if not elastic.left:
            out["data_width"] = np.array(mesh_axis_sizes(elastic.mesh)["data"])
            out["world_after"] = np.array(group.world_size)

            # 3. auto-resume: a fresh trainer over the survivors' mesh
            def no_init():
                raise AssertionError("resume must not draw new params")

            resumed = trainer("elastic")
            resumed.start(n_hosts=2, init_params_fn=no_init)
            out["resumed_at"] = np.array([resumed.step, int(resumed.state.opt.step)])
            out["resumed_loss"] = np.array(resumed.run(1)[0]["loss"])
            out["next_loss"] = np.array(elastic.run(1)[0]["loss"])
        np.savez(tmp / f"out{rank}.npz", **out)
    finally:
        group.close()


# --------------------------------------------------------------- reference --

def _ref_moe(cfg, params, jax, np_batches):
    """The reference's sharded forward (both dispatches), loss and aux, and
    two dense training steps, on dp 2 x tp 4."""
    from jax.sharding import NamedSharding

    from repro.distributed.sharding import batch_spec, make_plan, tree_shardings
    from repro.launch.compat import make_mesh
    from repro.models import ForwardOptions, init_lm_params, lm_forward
    from repro.train.optimizer import AdamW, cosine_schedule
    from repro.train.trainer import LossConfig, init_train_state, make_loss_fn, make_train_step

    mesh = make_mesh((2, 4), ("data", "model"))
    _, axes = init_lm_params(cfg, jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
    psh = tree_shardings(make_plan(cfg, mesh, mode="train"), axes, shapes)
    bsh = NamedSharding(mesh, batch_spec(mesh, MOE_DATA["global_batch"], 1))
    batches = [{k: jax.device_put(v, bsh) for k, v in b.items()} for b in np_batches]
    out = {}
    with mesh:
        sharded = jax.device_put(params, psh)
        for dispatch in ("dense", "gather"):
            opts = ForwardOptions(attn_impl="reference", moe_dispatch=dispatch)
            logits, aux = jax.jit(lambda p, t: lm_forward(cfg, p, tokens=t, opts=opts))(sharded, batches[0]["tokens"])
            loss, _ = jax.jit(make_loss_fn(cfg, opts, LossConfig()))(sharded, batches[0])
            out[dispatch] = (np.asarray(logits), float(aux), float(loss))
        opt = AdamW(schedule=cosine_schedule(*SCHEDULE))
        state = init_train_state(cfg, opt, sharded)
        step = jax.jit(make_train_step(cfg, opt, ForwardOptions(attn_impl="reference", moe_dispatch="dense")))
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        out["train"] = np.array(metrics)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, per-rank port results, the work directory)."""
    pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    import repro.configs as ref_configs
    from repro.checkpoint import CheckpointManager
    from repro.data import DataConfig, SyntheticLM
    from repro.launch.mesh import make_mesh
    from repro.models import ForwardOptions, ModelConfig, init_lm_params
    from repro.train.elastic import ElasticConfig, ElasticTrainer
    from repro.train.optimizer import AdamW, AdamWState, cosine_schedule
    from repro.train.trainer import TrainState
    from repro_torch.launch.compat import free_port

    tmp = tmp_path_factory.mktemp("elastic_mesh")
    cfg = ModelConfig(**CFG_KW)
    params, _ = init_lm_params(cfg, jax.random.PRNGKey(0))
    flat = {f"p:{k}": np.asarray(v) for k, v in _flat(params).items()}
    moe_params = {}
    for name in MOE_CASES:
        moe_params[name], _ = init_lm_params(_moe_cfg(ref_configs, name), jax.random.PRNGKey(0))
        flat.update({f"m{name}:{k}": np.asarray(v) for k, v in _flat(moe_params[name]).items()})
    np.savez(tmp / "inputs.npz", **flat)

    # a reference checkpoint whose optimizer trees are not the params' copies
    rng = np.random.default_rng(0)
    moment = lambda tree, f: jax.tree.map(lambda x: jnp.asarray(f(rng.standard_normal(x.shape)), x.dtype), tree)  # noqa: E731
    ref_state = TrainState(params=params, opt=AdamWState(
        step=jnp.int32(REF_CKPT_STEP + 1), master=moment(params, lambda a: a),
        mu=moment(params, lambda a: 0.1 * a), nu=moment(params, np.abs)))
    CheckpointManager(str(tmp / "ref_ckpt")).save(REF_CKPT_STEP, ref_state, extra={"next_step": REF_CKPT_STEP + 1})

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    port = free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]

    # the reference's results while the ranks run
    ref = {}
    trainer = ElasticTrainer(
        cfg=cfg, optimizer=AdamW(schedule=cosine_schedule(*SCHEDULE)), data=SyntheticLM(DataConfig(**DATA_KW)),
        ckpt=CheckpointManager(str(tmp / "ref_elastic"), keep=3),
        make_mesh_fn=lambda n: make_mesh(n_pods=1, dp=n, tp=2),
        opts=ForwardOptions(attn_impl="reference"), elastic_cfg=ElasticConfig(checkpoint_every=CKPT_EVERY))
    trainer.start(n_hosts=4, init_params_fn=lambda: params)
    history = trainer.run(STEPS, membership_events=dict(EVENTS))
    ref["steps"] = [h["step"] for h in history]
    ref["losses"] = np.array([h["loss"] for h in history])
    ref["data_width"] = trainer.mesh.shape["data"]
    moe_batches = [SyntheticLM(DataConfig(**MOE_DATA)).batch(i) for i in range(MOE_STEPS)]
    for name in MOE_CASES:
        ref[f"moe_{name}"] = _ref_moe(_moe_cfg(ref_configs, name), moe_params[name], jax, moe_batches)

    logs = []
    deadline = time.time() + JOIN_TIMEOUT_S
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"gloo ranks did not finish in {JOIN_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    ranks = [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]
    return ref, ranks, tmp


# ------------------------------------------------------------------- tests --

def test_membership_change_matches_reference(runs):
    """dp 4 x tp 2 -> dp 2 x tp 2 before step 6: ranks 4-7 leave after step
    5's checkpoint; the survivors train steps 0-11 within TRAIN_RTOL of the
    reference's ElasticTrainer, on a mesh of data width 2."""
    from repro_torch.checkpoint import all_steps

    ref, ranks, tmp = runs
    assert ref["steps"] == list(range(STEPS)) and ref["data_width"] == 2
    for r, out in enumerate(ranks):
        if r < 4:
            assert not out["left"] and int(out["data_width"]) == 2 and int(out["world_after"]) == 4
            assert list(out["steps"]) == list(range(STEPS))
            losses = out["losses"]
            assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
            np.testing.assert_allclose(losses, ref["losses"], rtol=TRAIN_RTOL)
        else:
            assert out["left"] and list(out["steps"]) == list(range(6))
            np.testing.assert_allclose(out["losses"], ref["losses"][:6], rtol=TRAIN_RTOL)
    assert all_steps(str(tmp / "elastic")) == [5, 7, 11]   # keep 3: 3, 5 (the event), 7, 11


def test_uninterrupted_run_matches_membership_change(runs):
    _, ranks, _ = runs
    for out in ranks[:4]:
        np.testing.assert_allclose(out["straight"], out["losses"], rtol=TRAIN_RTOL)
    for out in ranks:
        np.testing.assert_array_equal(out["straight"], ranks[0]["straight"])


def test_auto_resume_on_the_survivors_mesh_is_bit_equal(runs):
    _, ranks, _ = runs
    for out in ranks[:4]:
        assert list(out["resumed_at"]) == [STEPS, STEPS]
        assert float(out["resumed_loss"]) == float(out["next_loss"])
    assert all("resumed_loss" not in out for out in ranks[4:])


def test_reference_checkpoint_restores_onto_port_mesh_shard_by_shard(runs):
    """Every leaf of the reference's checkpoint lands exactly on each rank of
    dp 2 x tp 4, and each rank holds only its local shape of a sharded leaf
    (no rank places a whole sharded leaf)."""
    _, ranks, _ = runs
    for out in ranks:
        exact, local_shapes, n_sharded, step, next_step = (int(x) for x in out["ref_restore"])
        assert exact and local_shapes
        assert n_sharded > 0
        assert (step, next_step) == (REF_CKPT_STEP, REF_CKPT_STEP + 1)


def test_port_checkpoint_from_dtensors_restores_in_both_packages(runs):
    """The checkpoint the ranks wrote from DTensors restores in the reference
    (with no shardings, and re-sharded onto a mesh of its own) and in the
    port with no shardings, equal to the reference's own checkpoint."""
    import jax
    import torch

    from repro.checkpoint.manager import restore_checkpoint as ref_restore
    from repro.distributed.sharding import make_plan, tree_shardings
    from repro.launch.compat import make_mesh
    from repro.models import ModelConfig, init_lm_params
    from repro.train.optimizer import AdamW, cosine_schedule
    from repro.train.trainer import TrainState, init_train_state
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.models import ModelConfig as PortConfig
    from repro_torch.models import init_lm_params as port_init
    from repro_torch.train import AdamW as PortAdamW
    from repro_torch.train import cosine_schedule as port_schedule
    from repro_torch.train import init_train_state as port_state

    _, _, tmp = runs
    with np.load(tmp / "ref_ckpt" / f"step_{REF_CKPT_STEP:08d}" / "arrays_0.npz") as f:
        want = {k: f[k] for k in f.files}

    cfg = ModelConfig(**CFG_KW)
    params, axes = init_lm_params(cfg, jax.random.PRNGKey(0))
    like = jax.eval_shape(lambda p: init_train_state(cfg, AdamW(schedule=cosine_schedule(*SCHEDULE)), p), params)
    mesh = make_mesh((4, 2), ("data", "model"))
    psh = tree_shardings(make_plan(cfg, mesh, mode="train"), axes, like.params)
    shardings = TrainState(params=psh, opt=type(like.opt)(
        step=jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()), master=psh, mu=psh, nu=psh))
    for sh in (None, shardings):
        tree, step, extra = ref_restore(str(tmp / "port_ckpt"), like, shardings=sh)
        assert (step, extra) == (REF_CKPT_STEP, {"next_step": REF_CKPT_STEP + 1})
        got = dict(_flatten_with_paths(jax.tree.map(np.asarray, tree)))
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])

    port_cfg = PortConfig(**CFG_KW)
    port_like = port_state(port_cfg, PortAdamW(schedule=port_schedule(*SCHEDULE)), port_init(port_cfg, device="meta")[0])
    tree, step, _ = restore_checkpoint(str(tmp / "port_ckpt"), port_like)
    assert step == REF_CKPT_STEP
    for key, leaf in _flatten_with_paths(tree):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        np.testing.assert_array_equal(leaf.numpy(), want[key])


@pytest.mark.parametrize("name", list(MOE_CASES))
@pytest.mark.parametrize("dispatch", ["dense", "gather"])
def test_sharded_moe_dispatch_matches_reference(runs, name, dispatch):
    """qwen2-moe SMOKE's forward on dp 2 x tp 4 through the train plan, each
    dispatch against the reference's sharded forward of the same dispatch:
    logits within MOE_TOL of the largest, aux and loss within MOE_TOL."""
    ref, ranks, _ = runs
    logits, aux, loss = ref[f"moe_{name}"][dispatch]
    for out in ranks:
        assert str(out[f"moe_{name}_strategy"]) == name
        got = out[f"moe_{name}_{dispatch}_logits"]
        assert np.max(np.abs(got - logits)) <= MOE_TOL * np.max(np.abs(logits))
        np.testing.assert_allclose(float(out[f"moe_{name}_{dispatch}_aux"]), aux, rtol=MOE_TOL)
        np.testing.assert_allclose(float(out[f"moe_{name}_{dispatch}_loss"]), loss, rtol=MOE_TOL)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_sharded_dense_moe_trains_as_reference(runs, name):
    ref, ranks, _ = runs
    for out in ranks:
        np.testing.assert_allclose(out[f"moe_{name}_train"], ref[f"moe_{name}"]["train"], rtol=TRAIN_RTOL)


def test_launcher_under_torchrun_re_meshes_four_gloo_ranks(tmp_path):
    """The training launcher as a user runs it under torchrun: four gloo
    ranks start on a (1, 4) mesh and re-split to (2, 2) before step 3."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "6", "--seq", "64",
         "--simulate-failure", "3:2", "--ckpt-dir", str(tmp_path / "ckpt")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "on cpu (data width 2) over 4 of 4 ranks" in run.stdout, run.stdout
    assert "re-mesh before step 3" in run.stdout


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
