"""The port's training step (``repro_torch.train``) against the JAX package's,
on the CPU, from the same numpy weights and the same ``SyntheticLM`` batches:
the reference's train state goes across through ``np.asarray`` and
``train_state_from_numpy``.

Tolerances: losses within ``LOSS_TOL * (1 + |ref|)`` at every step (the two
packages round the same f32 arithmetic in other orders: the observed gap
over five AdamW steps is below 1e-6); grad norms within ``LOSS_TOL`` for
AdamW and ``ADAFACTOR_GNORM_TOL`` for Adafactor, whose RMS-normalised
updates amplify rounding. The remat policies change no number: their loss
and grads are held equal to ``remat="none"`` bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import repro.models as R  # noqa: E402
import repro.train.optimizer as ropt  # noqa: E402
import repro.train.trainer as rtrain  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch import train as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ForwardOptions, init_encdec_params, init_lm_params  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.train.trainer import _grads  # noqa: E402

LOSS_TOL = 1e-5
ADAFACTOR_GNORM_TOL = 1e-4
SEQ, BATCH = 32, 4


def _optimizers(kind):
    if kind == "adamw":
        return ropt.AdamW(schedule=ropt.cosine_schedule(1e-3, 2, 50)), T.AdamW(schedule=T.cosine_schedule(1e-3, 2, 50))
    return (ropt.Adafactor(schedule=ropt.cosine_schedule(1e-2, 2, 50)),
            T.Adafactor(schedule=T.cosine_schedule(1e-2, 2, 50)))


def _train_both(arch, kind="adamw", steps=5, num_microbatches=1, port_microbatches=None):
    """Per step: (reference metrics, port metrics) as floats."""
    rc, tc = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    ro, to = _optimizers(kind)
    rp, _ = R.init_lm_params(rc, jax.random.PRNGKey(0))
    rs = rtrain.init_train_state(rc, ro, rp)
    ts = T.train_state_from_numpy(jax.tree.map(np.asarray, rs), "cpu")
    rstep = jax.jit(rtrain.make_train_step(rc, ro, R.ForwardOptions(attn_impl="reference"),
                                           num_microbatches=num_microbatches))
    tstep = T.make_train_step(tc, to, ForwardOptions(attn_impl="reference"),
                              num_microbatches=port_microbatches or num_microbatches)
    data = SyntheticLM(DataConfig(vocab_size=rc.vocab_size, seq_len=SEQ, global_batch=BATCH))
    out = []
    for step in range(steps):
        batch = data.global_batch(step)
        rs, rm = rstep(rs, batch)
        ts, tm = tstep(ts, batch)
        out.append(({k: float(v) for k, v in rm.items()}, {k: float(v) for k, v in tm.items()}))
    return out


def _close(port, ref, tol):
    return abs(port - ref) <= tol * (1 + abs(ref))


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-1.3b"])
def test_adamw_losses_match_reference(arch):
    history = _train_both(arch)
    for step, (r, t) in enumerate(history):
        assert set(t) == set(r), (set(t), set(r))
        for key in ("loss", "nll", "grad_norm", "lr", "tokens", "aux"):
            assert _close(t[key], r[key], LOSS_TOL), (arch, step, key, t[key], r[key])
    assert history[-1][1]["loss"] < history[0][1]["loss"]


def test_adafactor_losses_match_reference():
    for step, (r, t) in enumerate(_train_both("granite-8b", "adafactor")):
        assert _close(t["loss"], r["loss"], LOSS_TOL), (step, t["loss"], r["loss"])
        assert _close(t["grad_norm"], r["grad_norm"], ADAFACTOR_GNORM_TOL), (step, t, r)


def test_microbatches_match_reference_and_single_batch():
    """``num_microbatches=2`` against the reference's 2, and against the
    port's own single batch (the same mean loss and gradient)."""
    two = _train_both("granite-8b", steps=3, num_microbatches=2)
    one = _train_both("granite-8b", steps=3, num_microbatches=2, port_microbatches=1)
    for (r, t), (_, t1) in zip(two, one):
        for key in ("loss", "grad_norm", "tokens"):
            assert _close(t[key], r[key], LOSS_TOL), (key, t[key], r[key])
            assert _close(t[key], t1[key], LOSS_TOL), (key, t[key], t1[key])
    assert two[0][1]["tokens"] == BATCH * SEQ


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_moe_step_matches_reference(arch):
    """One step's loss (router aux included) and grad norm."""
    (r, t), = _train_both(arch, steps=1)
    for key in ("loss", "aux", "grad_norm"):
        assert _close(t[key], r[key], LOSS_TOL), (key, t[key], r[key])


def _smoke_batch(cfg, rng):
    if cfg.is_encoder_decoder:
        return {"enc_embeds": torch.from_numpy(0.02 * rng.standard_normal((2, cfg.encoder_seq, cfg.d_model))
                                               .astype(np.float32)),
                "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))),
                "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))}
    tokens = rng.integers(0, cfg.vocab_size, (2, 17))
    return {"tokens": torch.from_numpy(tokens[:, :-1]), "labels": torch.from_numpy(tokens[:, 1:])}


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-1.3b", "jamba-v0.1-52b", "whisper-tiny"])
def test_remat_policies_match_none(arch):
    """Every remat policy gives ``remat="none"``'s loss and grads bit for bit
    (the recomputation repeats the forward exactly), and the backward's
    matrix-product FLOPs show what each saves: ``full`` recomputes every
    product, ``dots`` none, ``dots_no_batch`` the batched ones (``bmm``)."""
    cfg = get_config(arch, smoke=True)
    init = init_encdec_params if cfg.is_encoder_decoder else init_lm_params
    params, _ = init(cfg, seed=0, device="cpu")
    batch = _smoke_batch(cfg, np.random.default_rng(0))
    results, backward_flops = {}, {}
    for remat in ("none", "full", "dots", "dots_no_batch"):
        loss_fn = T.make_loss_fn(cfg, ForwardOptions(remat=remat), T.LossConfig())
        results[remat] = _grads(loss_fn, params, batch)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = loss_fn(params, batch)
        with FlopCounterMode(display=False) as counter:
            torch.autograd.grad(loss, leaves, allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        backward_flops[remat] = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    g0, m0 = results["none"]
    for remat in ("full", "dots", "dots_no_batch"):
        g, m = results[remat]
        assert torch.equal(m["loss"], m0["loss"]), remat
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g), tree_leaves(g0))), remat
    none, full = backward_flops["none"], backward_flops["full"]
    assert all(full[op] > none[op] for op in none), (full, none)
    assert backward_flops["dots"] == none
    nb = backward_flops["dots_no_batch"]
    assert nb.get("aten.mm") == none.get("aten.mm") and nb.get("aten.bmm") == full.get("aten.bmm")


def test_remat_option_refuses_unknown_policy_and_sharding():
    with pytest.raises(ValueError, match="remat"):
        ForwardOptions(remat="offload").check()
    # the sharding fields are ported (distributed slice): accepted
    assert ForwardOptions(remat="full", interior_sharding="x").check().interior_sharding == "x"
    assert ForwardOptions(remat="dots").check().remat == "dots"


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_reference(z_loss):
    """Ignored labels (-1) are masked out of the mean; z-loss adds
    ``z * mean(lse^2)``."""
    rng = np.random.default_rng(7)
    logits = (3 * rng.standard_normal((3, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, -1] = -1
    rl, rm = rtrain.cross_entropy(jax.numpy.asarray(logits), jax.numpy.asarray(labels),
                                  rtrain.LossConfig(z_loss=z_loss))
    tl, tm = T.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), T.LossConfig(z_loss=z_loss))
    assert set(tm) == set(rm)
    assert _close(float(tl), float(rl), 1e-6)
    for key in rm:
        assert _close(float(tm[key]), float(rm[key]), 1e-6), key
    assert float(tm["tokens"]) == labels.size - 5


def test_train_state_from_numpy_keeps_dtypes_and_copies():
    """bf16 params and f32 master/moments carry across with their bits; the
    step counter lands on the host; the port's own init copies the master
    weights even for f32 params (an in-place update must not alias them)."""
    rc = ref_config("granite-moe-3b-a800m", smoke=True).replace(param_dtype="bfloat16", dtype="bfloat16")
    rp, _ = R.init_lm_params(rc, jax.random.PRNGKey(0))
    ro = ropt.AdamW(schedule=ropt.constant_schedule(1e-3))
    rs = jax.tree.map(np.asarray, rtrain.init_train_state(rc, ro, rp))
    ts = T.train_state_from_numpy(rs, "cpu")
    assert isinstance(ts.opt, T.AdamWState) and ts.opt.step.device.type == "cpu" and int(ts.opt.step) == 0
    table = ts.params["embed"]["table"]
    assert table.dtype == torch.bfloat16
    np.testing.assert_array_equal(table.view(torch.int16).numpy(), rs.params["embed"]["table"].view(np.int16))
    assert ts.opt.master["embed"]["table"].dtype == torch.float32

    f32 = {"w": torch.ones(3)}
    state = T.AdamW(schedule=T.constant_schedule(1e-3)).init(f32)
    assert state.master["w"].data_ptr() != f32["w"].data_ptr()


def test_ssd_chunked_backward_is_finite_at_real_step_sizes():
    """At chunk 256 with mamba2-like step sizes the decays above the
    diagonal overflow f32 (exp of several hundred): the forward selects them
    away, and the backward must too. The chunked scan's gradients are held
    to the sequential scan's (the oracle) within 1e-3 relative."""
    mamba2 = __import__("repro_torch.models.mamba2", fromlist=["ssd_chunked"])
    rng = np.random.default_rng(5)
    b, s, h, p, n = 1, 512, 4, 8, 8
    leaves = [
        torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32)),            # x
        torch.from_numpy(rng.uniform(0.05, 0.2, (b, s, h)).astype(np.float32)),            # dt
        torch.from_numpy(np.log(rng.uniform(1.0, 16.0, h)).astype(np.float32)),            # A_log
        torch.from_numpy(0.3 * rng.standard_normal((b, s, 1, n)).astype(np.float32)),      # B
        torch.from_numpy(0.3 * rng.standard_normal((b, s, 1, n)).astype(np.float32)),      # C
    ]
    weight = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    grads = {}
    for name, fn in (("chunked", lambda *a: mamba2.ssd_chunked(*a, chunk=256)), ("sequential", mamba2.ssd_reference)):
        inputs = [t.clone().requires_grad_(True) for t in leaves]
        y, _ = fn(*inputs)
        grads[name] = torch.autograd.grad((y * weight).sum(), inputs)
    for got, ref in zip(grads["chunked"], grads["sequential"]):
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= 1e-3 * (1 + float(ref.abs().max()))
