"""The reference's checkpoint / data / fault-tolerance / compression /
optimizer cases (``tests/test_infra.py``) on the port, and the port held
against the reference where both compute the same thing: ``SyntheticLM``
batches byte for byte, quantisation exactly, a checkpoint written by
``repro.checkpoint.save_checkpoint`` restored bit for bit, and the
manifest's keys, shapes and dtypes for the same train state."""

import json
import os
import shutil

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as rckpt  # noqa: E402
import repro.data as rdata  # noqa: E402
import repro.distributed.compression as rcomp  # noqa: E402
import repro.models as R  # noqa: E402
import repro.train.optimizer as ropt  # noqa: E402
import repro.train.trainer as rtrain  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    all_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    ErrorFeedback,
    compressed_psum,
    dequantize_tree,
    quantize_int8,
    quantize_tree,
)
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamW,
    Adafactor,
    FailureDetector,
    StragglerMonitor,
    cosine_schedule,
    global_norm,
    reassign_shards,
    train_state_from_numpy,
)


# ------------------------------------------------------------- checkpoint --

def _state():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones((4,))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 42, state, extra={"next_step": 43})
    restored, step, extra = restore_checkpoint(str(tmp_path), state)
    assert step == 42 and extra["next_step"] == 43
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity_and_latest(tmp_path):
    d = str(tmp_path)
    state = _state()
    save_checkpoint(d, 1, state)
    save_checkpoint(d, 2, state)
    assert latest_step(d) == 2
    # a crash leaving a tmp dir must be ignored
    os.makedirs(os.path.join(d, "step_00000003.tmp0"))
    assert latest_step(d) == 2
    # LATEST pointing at a deleted dir falls back to newest valid
    shutil.rmtree(os.path.join(d, "step_00000002"))
    assert latest_step(d) == 1


def test_checkpoint_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _state())
    assert all_steps(str(tmp_path)) == [3, 4]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 0, _state())
    bad = {"params": {"w": torch.zeros((2, 2)), "b": torch.ones((4,))}, "step": torch.tensor(0)}
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), bad)


def test_async_checkpoint_holds_the_values_at_save(tmp_path):
    """The state is copied at ``save``: an in-place update right after it
    (what the train step does) does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_writes=True)
    state = _state()
    mgr.save(0, state)
    state["params"]["w"].add_(100.0)
    mgr.wait()
    restored, _, _ = restore_checkpoint(str(tmp_path), _state())
    assert torch.equal(restored["params"]["w"], _state()["params"]["w"])


def test_restore_places_meta_leaves_on_the_device(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 0, _state())
    like = {"params": {"w": torch.empty((3, 4), device="meta"), "b": torch.empty(4, device="meta")},
            "step": torch.tensor(0, dtype=torch.int32)}
    restored, _, _ = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(restored))
    assert torch.equal(restored["params"]["w"], _state()["params"]["w"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(str(tmp_path), like, device="cuda")


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    """bf16, f32 and int32 leaves written by the reference come back with
    their dtypes and bits."""
    rng = np.random.default_rng(3)
    ref_state = {
        "params": {"w": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16),
                   "b": jnp.asarray(rng.standard_normal(7), jnp.float32)},
        "opt": {"step": jnp.int32(11), "mu": jnp.asarray(rng.standard_normal((5, 7)), jnp.float32)},
    }
    rckpt.save_checkpoint(str(tmp_path), 3, ref_state, extra={"next_step": 4})
    like = {"params": {"w": torch.empty((5, 7), device="meta"), "b": torch.empty(7, device="meta")},
            "opt": {"step": torch.empty((), device="meta"), "mu": torch.empty((5, 7), device="meta")}}
    restored, step, extra = restore_checkpoint(str(tmp_path), like)
    assert step == 3 and extra == {"next_step": 4}
    w = restored["params"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.view(torch.int16).numpy(), np.asarray(ref_state["params"]["w"]).view(np.int16))
    for path in (("params", "b"), ("opt", "mu"), ("opt", "step")):
        ref = np.asarray(ref_state[path[0]][path[1]])
        got = restored[path[0]][path[1]]
        assert str(got.dtype).removeprefix("torch.") == str(ref.dtype)
        np.testing.assert_array_equal(got.numpy(), ref)


def _members(path):
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return {i.filename: zf.read(i.filename) for i in zf.infolist()}


def test_checkpoint_members_are_np_savez_bytes(tmp_path):
    """The streamed writer's members are the bytes ``np.savez`` writes for
    the same arrays (f32, int32 and a bf16 leaf as ``V2``, a 0-d leaf)."""
    state = {**_state(), "h": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
    path = save_checkpoint(str(tmp_path / "port"), 0, state)
    arrays = {"h": state["h"].view(torch.int16).numpy().view("V2"),
              "params/b": state["params"]["b"].numpy(), "params/w": state["params"]["w"].numpy(),
              "step": state["step"].numpy()}
    np.savez(tmp_path / "ref.npz", **arrays)
    assert _members(os.path.join(path, "arrays_0.npz")) == _members(tmp_path / "ref.npz")


def test_checkpoint_restore_detects_a_damaged_member(tmp_path):
    import zipfile

    path = save_checkpoint(str(tmp_path), 0, _state())
    npz = os.path.join(path, "arrays_0.npz")
    data = bytearray(open(npz, "rb").read())
    at = data.index(np.arange(12.0, dtype=np.float32).reshape(3, 4).tobytes())
    data[at + 5] ^= 0x40   # one bit of params/w's data
    open(npz, "wb").write(bytes(data))
    with pytest.raises(zipfile.BadZipFile, match="params/w"):
        restore_checkpoint(str(tmp_path), _state())


def test_checkpoint_refuses_a_compressed_archive(tmp_path):
    """Both packages write stored members (``np.savez``); a compressed
    archive is refused by name, not mapped."""
    path = save_checkpoint(str(tmp_path), 0, _state())
    npz = os.path.join(path, "arrays_0.npz")
    with np.load(npz) as f:
        arrays = {k: f[k] for k in f.files}
    np.savez_compressed(npz, **arrays)
    with pytest.raises(ValueError, match="compressed"):
        restore_checkpoint(str(tmp_path), _state())


def test_manifest_matches_reference_for_a_train_state(tmp_path):
    """The same AdamW train state (bf16 params, f32 master and moments, the
    int32 step) written by both packages: equal keys (the reference's
    sorted-path order), shapes and dtypes."""
    rc = ref_config("granite-moe-3b-a800m", smoke=True).replace(param_dtype="bfloat16", dtype="bfloat16")
    rp, _ = R.init_lm_params(rc, jax.random.PRNGKey(0))
    rs = rtrain.init_train_state(rc, ropt.AdamW(schedule=ropt.constant_schedule(1e-3)), rp)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, rs), "cpu")
    rckpt.save_checkpoint(str(tmp_path / "ref"), 0, rs)
    save_checkpoint(str(tmp_path / "port"), 0, ts)
    rm, tm = (json.loads((tmp_path / w / "step_00000000" / "manifest.json").read_text()) for w in ("ref", "port"))
    assert tm["keys"] == rm["keys"]
    assert tm["shapes"] == rm["shapes"] and tm["dtypes"] == rm["dtypes"]
    assert rm["keys"][0].startswith("params/") and "opt/step" in rm["keys"]
    assert tm["dtypes"]["params/embed/table"] == "bfloat16"


# ------------------------------------------------------------------- data --

def test_data_deterministic_and_shard_consistent():
    pipe = SyntheticLM(DataConfig(vocab_size=211, seq_len=32, global_batch=8))
    g = pipe.global_batch(5)
    assert g["tokens"].shape == (8, 32)
    parts = [pipe.batch(5, i, 4)["tokens"] for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), g["tokens"])
    np.testing.assert_array_equal(pipe.batch(5, 2, 4)["tokens"], parts[2])
    full = np.concatenate([g["tokens"], g["labels"][:, -1:]], axis=1)
    np.testing.assert_array_equal(full[:, 1:], g["labels"])


def test_data_has_learnable_structure():
    cfg = DataConfig(vocab_size=97, seq_len=128, global_batch=4, structure=0.8)
    b = SyntheticLM(cfg).global_batch(0)
    toks = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
    assert (toks[:, cfg.copy_offset:] == toks[:, : -cfg.copy_offset]).mean() > 0.5


@given(st.integers(0, 50), st.integers(1, 4))
@settings(max_examples=15, deadline=None)
def test_data_elastic_invariance(step, log_shards):
    n_shards = 2 ** (log_shards - 1)
    pipe = SyntheticLM(DataConfig(vocab_size=64, seq_len=8, global_batch=8))
    g = pipe.global_batch(step)["tokens"]
    parts = [pipe.batch(step, i, n_shards)["tokens"] for i in range(n_shards)]
    np.testing.assert_array_equal(np.concatenate(parts), g)


@pytest.mark.parametrize("kw", [dict(vocab_size=49155, seq_len=64, global_batch=4),
                                dict(vocab_size=97, seq_len=33, global_batch=6, seed=5, structure=0.3,
                                     copy_offset=7, zipf_a=1.05)])
def test_batches_equal_reference_byte_for_byte(kw):
    port, ref = SyntheticLM(DataConfig(**kw)), rdata.SyntheticLM(rdata.DataConfig(**kw))
    for step in (0, 1, 17):
        for shard, n in ((0, 1), (1, 2)):
            p, r = port.batch(step, shard, n), ref.batch(step, shard, n)
            assert set(p) == set(r)
            for k in p:
                assert p[k].dtype == r[k].dtype and p[k].tobytes() == r[k].tobytes(), (step, shard, k)


# --------------------------------------------------------------------- ft --

def test_failure_detector_and_rejoin():
    t = [0.0]
    fd = FailureDetector([0, 1, 2], timeout_s=10, clock=lambda: t[0])
    t[0] = 8.0
    for h in (0, 1):
        fd.heartbeat(h)
    t[0] = 15.0
    ev = fd.check(step=3)
    assert ev.removed == (2,) and set(ev.healthy) == {0, 1}
    fd.join(2)
    ev = fd.check(step=4)
    assert ev is not None and ev.added == (2,)


def test_straggler_flagging_needs_patience():
    sm = StragglerMonitor([0, 1, 2], threshold=1.5, patience=3)
    for _ in range(4):
        sm.record(0, 1.0)
        sm.record(1, 1.0)
        sm.record(2, 2.5)
    assert sm.check() == []
    assert sm.check() == []
    assert sm.check() == [2]


def test_reassign_shards_total_and_deterministic():
    table = reassign_shards([3, 1, 7], 8)
    assert sorted(s for v in table.values() for s in v) == list(range(8))
    assert table == reassign_shards([7, 3, 1], 8)


# ------------------------------------------------------------ compression --

@given(st.lists(st.floats(-100, 100), min_size=1, max_size=64))
@settings(max_examples=30, deadline=None)
def test_quantize_roundtrip_error_bound_and_reference(values):
    x = np.asarray(values, np.float32)
    leaf = quantize_int8(torch.from_numpy(x))
    rec = leaf.q.numpy().astype(np.float32) * float(leaf.scale)
    amax = float(np.max(np.abs(x))) or 1.0
    assert np.max(np.abs(rec - x)) <= amax / 127.0 + 1e-6
    ref = rcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(ref.q))
    assert float(leaf.scale) == float(ref.scale)


def test_error_feedback_bounded():
    rng = np.random.default_rng(0)
    res = ErrorFeedback.init({"w": torch.zeros(128)})
    true_sum = np.zeros(128)
    rec_sum = np.zeros(128)
    for _ in range(30):
        g = {"w": torch.from_numpy(rng.normal(size=128).astype(np.float32))}
        true_sum += g["w"].numpy()
        q, res = ErrorFeedback.compress(g, res)
        rec_sum += dequantize_tree(q)["w"].numpy()
    assert np.abs(rec_sum - true_sum).max() < 0.25


def test_quantize_tree_and_psum_refusal():
    tree = {"a": {"w": torch.linspace(-1, 1, 9)}, "b": torch.zeros(3)}
    back = dequantize_tree(quantize_tree(tree))
    assert torch.equal(back["b"], tree["b"])
    assert float((back["a"]["w"] - tree["a"]["w"]).abs().max()) <= 1 / 127 + 1e-7
    # compressed_psum is ported (distributed slice): over a world of one it
    # is quantise-then-dequantise
    from repro_torch.launch.compat import destroy_process_group, init_process_group, make_mesh

    init_process_group("gloo")
    try:
        synced = compressed_psum(tree, "data", make_mesh((1,), ("data",), "cpu"))
    finally:
        destroy_process_group()
    assert torch.equal(synced["a"]["w"], back["a"]["w"]) and torch.equal(synced["b"], back["b"])


# -------------------------------------------------------------- optimizer --

def _quadratic_loss(params):
    return sum(torch.sum(torch.square(p)) for p in tree_leaves(params))


@pytest.mark.parametrize("opt_cls", [AdamW, Adafactor])
def test_optimizers_descend(opt_cls):
    opt = opt_cls(schedule=cosine_schedule(0.05, 0, 100))
    params = {"w": torch.ones((4, 8)), "b": torch.ones((8,))}
    state = opt.init(params)
    loss0 = float(_quadratic_loss(params))
    for _ in range(20):
        grads = {k: 2 * v for k, v in params.items()}  # d/dp sum(p^2)
        params, state, metrics = opt.update(grads, state, torch.float32)
    assert float(_quadratic_loss(params)) < loss0 * 0.5
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(state.step) == 20


def test_adamw_grad_clipping():
    opt = AdamW(schedule=cosine_schedule(0.1, 0, 10), clip_norm=1.0)
    params = {"w": torch.ones((4,))}
    state = opt.init(params)
    new_params, state, metrics = opt.update({"w": torch.full((4,), 1e6)}, state, torch.float32)
    assert float(metrics["grad_norm"]) > 1.0
    assert float((new_params["w"] - params["w"]).abs().max()) < 1.0
    assert float(global_norm({"a": torch.full((1,), 3.0), "b": {"c": torch.full((1,), 4.0)}})) == 5.0


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(kind):
    """One update of a bf16 tree from the same numbers: new params, master
    and moments within 1e-6 relative, the learning rate to the f32 bit."""
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "s": (3, 4, 5), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    if kind == "adamw":
        ref_opt, port_opt = ropt.AdamW(schedule=ropt.cosine_schedule(1e-2, 3, 20)), \
            AdamW(schedule=cosine_schedule(1e-2, 3, 20))
    else:
        ref_opt, port_opt = ropt.Adafactor(schedule=ropt.cosine_schedule(1e-2, 3, 20)), \
            Adafactor(schedule=cosine_schedule(1e-2, 3, 20))
    rp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in params.items()}
    rs, ts = ref_opt.init(rp), port_opt.init(tp)
    for step in range(4):
        rg = {k: jnp.asarray(v * (step + 1), jnp.bfloat16) for k, v in grads.items()}
        tg = {k: torch.from_numpy(v * (step + 1)).to(torch.bfloat16) for k, v in grads.items()}
        rp, rs, rm = ref_opt.update(rg, rs, jnp.bfloat16)
        tp, ts, tm = port_opt.update(tg, ts, torch.bfloat16)
        assert float(tm["lr"]) == float(rm["lr"])
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-6 * float(rm["grad_norm"])
        for k in shapes:
            ref = np.asarray(rs.master[k])
            np.testing.assert_allclose(ts.master[k].numpy(), ref, rtol=1e-6, atol=1e-7)
            assert tp[k].dtype == torch.bfloat16
