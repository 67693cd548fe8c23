"""The port's model stack (``repro_torch.models``) against the JAX package's,
on the same parameters and inputs: the reference's ``init_*`` output through
``np.asarray`` and ``params_from_numpy``, tokens and embeddings made with
numpy. Tolerances: the FLOP and parameter tables exactly; logits within
``2e-4 * (1 + max|ref|)``. The serving path is in ``test_torch_decode.py``."""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as R  # noqa: E402
import repro_torch.models as T  # noqa: E402
from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.layers import params_from_numpy  # noqa: E402

LOGIT_TOL = 2e-4

ref_moe = importlib.import_module("repro.models.moe")
port_moe = importlib.import_module("repro_torch.models.moe")


def _params(arch):
    """(reference config, port config, reference params, port params)."""
    rc, tc = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    init = R.init_encdec_params if rc.is_encoder_decoder else R.init_lm_params
    rp, _ = init(rc, jax.random.PRNGKey(0))
    return rc, tc, rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _assert_logits(port, ref, what):
    ref = np.asarray(ref)
    err = float(np.abs(port.numpy() - ref).max())
    assert err <= LOGIT_TOL * (1 + float(np.abs(ref).max())), f"{what}: max|port - ref| {err}"


# ------------------------------------------------------- tables and trees --

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_and_flops_equal_reference(arch, smoke):
    rc, tc = ref_config(arch, smoke), get_config(arch, smoke)
    assert tc == type(tc)(**{f: getattr(rc, f) for f in rc.__dataclass_fields__})
    assert dataclasses.asdict(T.param_counts(tc)) == dataclasses.asdict(R.param_counts(rc))
    for batch, seq in ((1, 128), (4, 4096)):
        assert T.prefill_flops(tc, batch, seq) == R.prefill_flops(rc, batch, seq)
        assert T.decode_flops(tc, batch, seq) == R.decode_flops(rc, batch, seq)
        assert T.training_flops(tc, batch, seq) == R.training_flops(rc, batch, seq)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_trees_equal_reference(arch):
    """Keys, shapes, dtypes and logical axes of every leaf, stacked units
    included, are the reference's."""
    rc, tc = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    if rc.is_encoder_decoder:
        rv, ra = R.init_encdec_params(rc, jax.random.PRNGKey(0))
        tv, ta = T.init_encdec_params(tc, seed=0, device="cpu")
    else:
        rv, ra = R.init_lm_params(rc, jax.random.PRNGKey(0))
        tv, ta = T.init_lm_params(tc, seed=0, device="cpu")
    rflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(rv)}
    tflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tv)}
    assert sorted(rflat) == sorted(tflat)
    for key, r in rflat.items():
        t = tflat[key]
        assert tuple(t.shape) == r.shape, key
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), key
        assert t.device.type == "cpu"
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.leaves(ta, is_leaf=is_axes) == jax.tree.leaves(ra, is_leaf=is_axes)
    assert jax.tree.structure(ta, is_leaf=is_axes) == jax.tree.structure(ra, is_leaf=is_axes)


def test_param_counts_match_actual_tree():
    """The reference's check on the port's trees (analytic skips norm scales)."""
    for arch in ("granite-8b", "qwen2-moe-a2.7b", "mamba2-1.3b"):
        cfg = get_config(arch, smoke=True)
        params, _ = T.init_lm_params(cfg, seed=0, device="cpu")
        actual = sum(x.numel() for x in jax.tree.leaves(params))
        analytic = T.param_counts(cfg).total
        assert abs(actual - analytic) / actual < 0.015, (arch, actual, analytic)


def test_params_from_numpy_carries_bf16_bits():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a), "n": {"i": np.arange(4)}}, "cpu")
    assert t["w"].dtype == torch.bfloat16 and t["n"]["i"].dtype == torch.int64
    np.testing.assert_array_equal(t["w"].float().numpy(), np.asarray(a.astype(jnp.float32)))
    assert params_from_numpy({"w": np.asarray(a)}, "cpu", dtype="float32")["w"].dtype == torch.float32


# -------------------------------------------------------------- forward ----

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_logits_match_reference(arch):
    """Every SMOKE arch's forward logits on the reference's weights; for the
    MoE archs the routers' top-k indices are first held equal, sublayer by
    sublayer."""
    rc, tc, rp, tp = _params(arch)
    b, s = 2, 24
    rng = np.random.default_rng(3)
    routed = {"ref": [], "port": []}
    if rc.is_moe:
        ref_routing, port_routing = ref_moe._routing, port_moe._routing

        def ref_spy(cfg, params, x2d):
            out = ref_routing(cfg, params, x2d)
            jax.debug.callback(lambda ti: routed["ref"].append(np.asarray(ti)), out[2])
            return out

        def port_spy(cfg, params, x):
            out = port_routing(cfg, params, x)
            routed["port"].append(out[2].numpy())
            return out

        ref_moe._routing, port_moe._routing = ref_spy, port_spy
    try:
        if rc.is_encoder_decoder:
            enc = 0.02 * rng.standard_normal((b, rc.encoder_seq, rc.d_model)).astype(np.float32)
            dec = _tokens(rc, (b, 16))
            ref, _ = R.encdec_forward(rc, rp, jnp.asarray(enc), jnp.asarray(dec))
            port, _ = T.encdec_forward(tc, tp, torch.from_numpy(enc), torch.from_numpy(dec))
        elif rc.frontend == "vision_stub":
            tok = _tokens(rc, (b, 64))
            patches = 0.02 * rng.standard_normal((b, 16, rc.d_model)).astype(np.float32)
            rte = R.merge_vision_embeds(rc, R.layers.embed_tokens(rc, rp["embed"], jnp.asarray(tok)),
                                        jnp.asarray(patches))
            tte = T.merge_vision_embeds(tc, T.layers.embed_tokens(tc, tp["embed"], torch.from_numpy(tok)),
                                        torch.from_numpy(patches))
            np.testing.assert_array_equal(tte.numpy(), np.asarray(rte))
            ref, _ = R.lm_forward(rc, rp, embeds=rte)
            port, _ = T.lm_forward(tc, tp, embeds=tte)
        else:
            tok = _tokens(rc, (b, s))
            ref, _ = R.lm_forward(rc, rp, tokens=jnp.asarray(tok))
            port, _ = T.lm_forward(tc, tp, tokens=torch.from_numpy(tok))
    finally:
        if rc.is_moe:
            ref_moe._routing, port_moe._routing = ref_routing, port_routing
    if rc.is_moe:
        # the reference routes row by row (vmap), the port every row at once
        ref_idx = np.concatenate([i.reshape(-1, rc.top_k) for i in routed["ref"]])
        port_idx = np.concatenate([i.reshape(-1, rc.top_k) for i in routed["port"]])
        assert len(routed["port"]) == tc.n_layers // max(tc.moe_layer_period, 1)
        np.testing.assert_array_equal(port_idx, ref_idx)
    assert port.shape == tuple(ref.shape)
    _assert_logits(port, ref, arch)


# -------------------------------------------------------------- contract ---

def test_unported_options_are_refused():
    cfg = get_config("granite-8b", smoke=True)
    params, _ = T.init_lm_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    # remat is ported (training slice): the policies run, an unknown one is refused
    for remat in ("full", "dots", "dots_no_batch"):
        T.lm_forward(cfg, params, tokens=tokens, opts=T.ForwardOptions(remat=remat))
    with pytest.raises(ValueError, match="remat"):
        T.lm_forward(cfg, params, tokens=tokens, opts=T.ForwardOptions(remat="everything"))
    # the sharding fields are ported (distributed slice): accepted, and with
    # none set (an empty or all-None MoE pin included) nothing changes
    opts = T.ForwardOptions(boundary_sharding="x", interior_sharding="y", attn_q_sharding="q")
    assert opts.check() is opts
    moe_cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    moe_params, _ = T.init_lm_params(moe_cfg, seed=0, device="cpu")
    moe = moe_params["units"]["sub0"]["moe"]
    moe = {k: (v[0] if isinstance(v, torch.Tensor) else {kk: vv[0] for kk, vv in v.items()}) for k, v in moe.items()}
    x = torch.randn(1, 4, moe_cfg.d_model, generator=torch.Generator().manual_seed(0))
    plain, _ = T.apply_moe(moe_cfg, moe, x)
    for pins in ({}, {"wi": None, "wg": None, "wo": None}):
        pinned, _ = T.apply_moe(moe_cfg, moe, x, shardings=pins)
        assert torch.equal(pinned, plain)


def test_stacked_state_is_not_aliased():
    """Each unit's cache is its own memory (``expand`` would alias them)."""
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    state = T.init_lm_state(cfg, 2, 16, device="cpu")
    leaves = jax.tree.leaves(state)
    assert all(leaf.stride(0) > 0 for leaf in leaves)
    ptrs = [leaf[u].data_ptr() for leaf in leaves for u in range(cfg.n_units)]
    assert len(set(ptrs)) == len(ptrs)


def test_entry_points_refuse_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal needs a host without one")
    cfg = get_config("granite-8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_lm_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_lm_state(cfg, 1, 8)
