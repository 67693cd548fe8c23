"""The port's collectives on real process groups: ``pipeline_apply``,
``compressed_psum``, and sharded training and decode on DTensors, each run
by eight spawned ``gloo`` ranks on the CPU and held against the JAX
package's on eight host devices, from the same numpy inputs.

One spawn serves the whole file (a module fixture): the ranks run every
case, write their results to ``.npz`` files, and the tests compare. Each
rank runs with one intra-op thread.

Tolerances: the pipeline within rtol = atol = 1e-5 of the sequential stages
and of the reference's pipeline, as the reference's own test; int8 payloads
exactly and ``compressed_psum`` within 1e-6 of the reference's; the sharded
training losses within ``TRAIN_RTOL`` of the reference's sharded ones at
every step (f32 sums in other orders across 8 steps of AdamW) and falling;
the sharded decode's logits within the reference's 5e-2 (relative to the
largest) of the dense forward."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

WORLD = 8
JOIN_TIMEOUT_S = 300
TRAIN_RTOL = 1e-4
N_STAGES, N_MICRO, MB, D = 4, 6, 2, 16
CFG_KW = dict(name="sys-test", n_layers=4, d_model=64, n_heads=8, n_kv_heads=4,
              d_ff=128, vocab_size=512, dtype="float32", param_dtype="float32")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 64
SHARD_SHAPE = (8, 16, 4)
SHARD_SPECS = [(("pod", "data"), None, ("model",)), (None, ("pod", "data", "model"), None),
               (("data",), ("model",), None)]


# ------------------------------------------------------------------ inputs --

def _inputs():
    rng = np.random.default_rng(0)
    return {
        "pipe_w": (rng.standard_normal((N_STAGES, D, D)) / np.sqrt(D)).astype(np.float32),
        "pipe_b": (rng.standard_normal((N_STAGES, D)) * 0.1).astype(np.float32),
        "pipe_x": rng.standard_normal((N_MICRO, MB, D)).astype(np.float32),
        "psum_a": rng.standard_normal((WORLD, 64, 16)).astype(np.float32),
        "psum_b": (rng.standard_normal((WORLD, 10)) * np.arange(1, WORLD + 1)[:, None]).astype(np.float32),
        "tokens": rng.integers(0, CFG_KW["vocab_size"], (8, 24)).astype(np.int64),
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ------------------------------------------------------------------- ranks --

def _stage_fn(params, x):
    import torch

    return torch.tanh(x @ params["w"] + params["b"])


def _rank_main(rank: int, port: int, tmp: str) -> None:
    """One gloo rank: every case, results to ``out<rank>.npz``."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import (NamedSharding, batch_spec, compressed_psum, make_plan,
                                         pipeline_apply, state_specs, tree_shardings)
    from repro_torch.distributed.sharding import shard_tensor, shard_tree
    from repro_torch.distributed.sharding import placements
    from repro_torch.launch.compat import destroy_process_group, distribute_tensor, implicit_replication
    from repro_torch.launch.compat import init_process_group, make_mesh
    from repro_torch.models import (ForwardOptions, ModelConfig, init_lm_params, init_lm_state, lm_decode_inplace,
                                    lm_prefill_inplace)
    from repro_torch.models.layers import params_from_numpy
    from repro_torch.train import AdamW, cosine_schedule, init_train_state, make_train_step

    torch.set_num_threads(1)
    init_process_group("gloo", WORLD, rank, f"tcp://localhost:{port}")
    inp = np.load(Path(tmp) / "inputs.npz")
    out = {}
    try:
        # pipeline: two replicas of a 4-stage pipeline
        mesh = make_mesh((2, N_STAGES), ("data", "stage"), "cpu")
        params = {"w": torch.from_numpy(inp["pipe_w"]), "b": torch.from_numpy(inp["pipe_b"])}
        out["pipeline"] = pipeline_apply(_stage_fn, params, torch.from_numpy(inp["pipe_x"]), mesh).numpy()

        # DTensor's own split of a dimension over two mesh axes
        mesh222 = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        full = torch.arange(int(np.prod(SHARD_SHAPE)), dtype=torch.float32).reshape(SHARD_SHAPE)
        for i, spec in enumerate(SHARD_SPECS):
            out[f"shard{i}"] = distribute_tensor(full, mesh222, placements(mesh222, spec)).to_local().numpy()
        out["coord"] = np.array(mesh222.get_coordinate())

        # compressed_psum over all eight ranks
        mesh8 = make_mesh((WORLD,), ("data",), "cpu")
        grads = {"a": torch.from_numpy(inp["psum_a"][rank]), "b": torch.from_numpy(inp["psum_b"][rank])}
        res = compressed_psum(grads, "data", mesh8)
        out["psum_a"], out["psum_b"] = res["a"].numpy(), res["b"].numpy()

        # sharded training, dp 2 x tp 4
        cfg = ModelConfig(**CFG_KW)
        mesh24 = make_mesh((2, 4), ("data", "model"), "cpu")
        plan = make_plan(cfg, mesh24, mode="train")
        ref_params = _unflat({k[2:]: v for k, v in inp.items() if k.startswith("p:")})
        _, axes = init_lm_params(cfg, device="meta")
        full = params_from_numpy(ref_params, "cpu")
        sharded = shard_tree(full, tree_shardings(plan, axes, full))
        opt = AdamW(schedule=cosine_schedule(1e-3, 5, 100))
        state = init_train_state(cfg, opt, sharded)
        step = make_train_step(cfg, opt, ForwardOptions(attn_impl="reference"), num_microbatches=2)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
        bsh = NamedSharding(mesh24, batch_spec(mesh24, TRAIN_BATCH, 1))
        losses = []
        with implicit_replication():
            for i in range(TRAIN_STEPS):
                batch = {k: shard_tensor(torch.as_tensor(v), bsh) for k, v in data.batch(i).items()}
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"].full_tensor()))
        out["losses"] = np.array(losses)

        # sharded decode against the dense forward (the initial weights)
        plan_d = make_plan(cfg, mesh24, mode="decode")
        dparams = shard_tree(full, tree_shardings(plan_d, axes, full))
        st = init_lm_state(cfg, 8, 32, device="cpu")
        st = shard_tree(st, state_specs(cfg, plan_d, st, 8))
        tokens = torch.from_numpy(inp["tokens"])
        tsh = NamedSharding(mesh24, batch_spec(mesh24, 8, 1))
        with implicit_replication():
            lm_prefill_inplace(cfg, dparams, st, tokens=shard_tensor(tokens[:, :23].contiguous(), tsh))
            logits = lm_decode_inplace(cfg, dparams, st, shard_tensor(tokens[:, 23:24].contiguous(), tsh),
                                       torch.tensor(23))
        out["decode"] = logits.full_tensor().numpy()
        np.savez(Path(tmp) / f"out{rank}.npz", **out)
    finally:
        destroy_process_group()


# --------------------------------------------------------------- reference --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, per-rank port results)."""
    pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.data import DataConfig, SyntheticLM
    from repro.distributed.compression import compressed_psum, quantize_int8
    from repro.distributed.pipeline import pipeline_apply
    from repro.distributed.sharding import make_plan, tree_shardings
    from repro.launch.compat import make_mesh, shard_map
    from repro.models import ForwardOptions, ModelConfig, init_lm_params, lm_forward
    from repro.train.optimizer import AdamW, cosine_schedule
    from repro.train.trainer import init_train_state, make_train_step
    from repro_torch.launch.compat import free_port

    tmp = tmp_path_factory.mktemp("gloo")
    inp = _inputs()
    cfg = ModelConfig(**CFG_KW)
    params, axes = init_lm_params(cfg, jax.random.PRNGKey(0))
    flat_p = {f"p:{k}": np.asarray(v) for k, v in _flat(params).items()}
    np.savez(tmp / "inputs.npz", **inp, **flat_p)

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"), OMP_NUM_THREADS="1")
    port = free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]

    ref = {}
    # the reference's results while the ranks run
    mesh = make_mesh((N_STAGES,), ("stage",))
    ref["pipeline"] = np.asarray(pipeline_apply(
        lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
        {"w": jnp.asarray(inp["pipe_w"]), "b": jnp.asarray(inp["pipe_b"])}, jnp.asarray(inp["pipe_x"]), mesh))
    mesh8 = make_mesh((WORLD,), ("data",))
    fn = shard_map(lambda a, b: compressed_psum({"a": a[0], "b": b[0]}, "data"), mesh=mesh8,
                   in_specs=(PartitionSpec("data"), PartitionSpec("data")),
                   out_specs={"a": PartitionSpec(), "b": PartitionSpec()}, check_vma=False)
    res = fn(jnp.asarray(inp["psum_a"]), jnp.asarray(inp["psum_b"]))
    ref["psum_a"], ref["psum_b"] = np.asarray(res["a"]), np.asarray(res["b"])
    ref["quantize"] = [(np.asarray(quantize_int8(jnp.asarray(inp[k][r])).q), np.asarray(quantize_int8(jnp.asarray(inp[k][r])).scale))
                       for k in ("psum_a", "psum_b") for r in range(WORLD)]
    # each rank's payload requantised against the shared (max) scale
    ref["payloads"] = {}
    for k in ("psum_a", "psum_b"):
        shared = max(float(quantize_int8(jnp.asarray(g)).scale) for g in inp[k])
        ref["payloads"][k] = [np.asarray(jnp.clip(jnp.round(jnp.asarray(g) / shared), -127, 127).astype(jnp.int8))
                              for g in inp[k]]

    mesh24 = make_mesh((2, 4), ("data", "model"))
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
    sharded = jax.device_put(params, tree_shardings(make_plan(cfg, mesh24, mode="train"), axes, shapes))
    opt = AdamW(schedule=cosine_schedule(1e-3, 5, 100))
    state = init_train_state(cfg, opt, sharded)
    step = jax.jit(make_train_step(cfg, opt, ForwardOptions(attn_impl="reference"), num_microbatches=2),
                   donate_argnums=(0,))
    data = SyntheticLM(DataConfig(vocab_size=512, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    from repro.distributed.sharding import batch_spec

    bsh = NamedSharding(mesh24, batch_spec(mesh24, TRAIN_BATCH, 1))
    losses = []
    with mesh24:
        for i in range(TRAIN_STEPS):
            state, metrics = step(state, {k: jax.device_put(v, bsh) for k, v in data.batch(i).items()})
            losses.append(float(metrics["loss"]))
    ref["losses"] = np.array(losses)
    ref["dense"] = np.asarray(lm_forward(cfg, params, tokens=jnp.asarray(inp["tokens"]))[0][:, 23])

    jmesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=jax.devices()[:8])
    full = np.arange(int(np.prod(SHARD_SHAPE)), dtype=np.float32).reshape(SHARD_SHAPE)
    ref["shards"] = []
    for spec in SHARD_SPECS:
        idx = NamedSharding(jmesh, PartitionSpec(*spec)).devices_indices_map(SHARD_SHAPE)
        ref["shards"].append({c: full[idx[jmesh.devices[c]]] for c in np.ndindex(2, 2, 2)})

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
    return inp, ref, ranks


# ------------------------------------------------------------------- tests --

def test_pipeline_matches_sequential(runs):
    import torch

    inp, ref, ranks = runs
    seq = torch.from_numpy(inp["pipe_x"])
    for s in range(N_STAGES):
        seq = _stage_fn({"w": torch.from_numpy(inp["pipe_w"][s]), "b": torch.from_numpy(inp["pipe_b"][s])}, seq)
    for r in ranks:
        np.testing.assert_allclose(r["pipeline"], seq.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["pipeline"], ref["pipeline"], rtol=1e-5, atol=1e-5)


def test_bubble_fraction():
    from repro_torch.distributed import bubble_fraction

    assert bubble_fraction(4, 6) == 3 / 9
    assert bubble_fraction(1, 8) == 0.0


def test_two_axis_shard_order_matches_reference(runs):
    """DTensor splits a dimension over ("pod", "data") major to minor, as
    PartitionSpec does: each rank's local shard is the reference's device
    shard at the same mesh coordinate."""
    _, ref, ranks = runs
    for r in ranks:
        coord = tuple(int(c) for c in r["coord"])
        for i, want in enumerate(ref["shards"]):
            np.testing.assert_array_equal(r[f"shard{i}"], want[coord])


def test_compressed_psum_matches_reference(runs):
    import torch

    from repro_torch.distributed import quantize_int8

    inp, ref, ranks = runs
    port_q = [quantize_int8(torch.from_numpy(inp[k][r])) for k in ("psum_a", "psum_b") for r in range(WORLD)]
    for (rq, rs), pq in zip(ref["quantize"], port_q):
        np.testing.assert_array_equal(pq.q.numpy(), rq)
        assert float(pq.scale) == float(rs)
    for k in ("psum_a", "psum_b"):  # the payloads compressed_psum sums
        shared = max(quantize_int8(torch.from_numpy(g)).scale for g in inp[k])
        for g, want in zip(inp[k], ref["payloads"][k]):
            got = torch.clamp(torch.round(torch.from_numpy(g) / shared), -127, 127).to(torch.int8)
            np.testing.assert_array_equal(got.numpy(), want)
    for r in ranks:
        np.testing.assert_allclose(r["psum_a"], ref["psum_a"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["psum_b"], ref["psum_b"], rtol=0, atol=1e-6)


def test_sharded_training_loss_decreases(runs):
    _, ref, ranks = runs
    for r in ranks:
        assert r["losses"][-1] < r["losses"][0], r["losses"]
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=TRAIN_RTOL)


def test_sharded_decode_matches_dense(runs):
    _, ref, ranks = runs
    dense = ref["dense"]
    for r in ranks:
        err = np.max(np.abs(r["decode"] - dense)) / (np.max(np.abs(dense)) + 1e-9)
        assert err < 5e-2, err


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
