"""The port's MoE dispatch (``repro_torch.models.moe``) and its autotune site
against the JAX package's, on the same weights and numpy-made inputs.
Tolerances: dispatch tables and FLOP tables exactly, outputs within 1e-5,
gather against dense (no drops) within 1e-5."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.autotune import moe_dispatch_site as jax_moe_dispatch_site  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.layers import split_params as ref_split  # noqa: E402
from repro_torch.autotune import moe_dispatch_site, rank_site  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.layers import params_from_numpy, split_params  # noqa: E402

ref_moe = importlib.import_module("repro.models.moe")
port_moe = importlib.import_module("repro_torch.models.moe")
TOL = 1e-5


def _moe(arch="qwen2-moe-a2.7b", **replace):
    """(reference config, port config, reference init_moe values, the same
    values in the port)."""
    rc = ref_config(arch, smoke=True).replace(**replace)
    tc = get_config(arch, smoke=True).replace(**replace)
    rp, _ = ref_split(ref_moe.init_moe(rc, jax.random.PRNGKey(0)))
    return rc, tc, rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(port, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, atol=tol * (1 + np.abs(ref).max()), rtol=0)


def _gathered(module, fn, *args):
    """``fn(*args)`` with every [E, C, d] input of ``module._expert_ffn``
    recorded (the gathered token rows: the dispatch table, row by row)."""
    seen, inner = [], module._expert_ffn

    def spy(cfg, params, xe, *rest):
        seen.append(np.asarray(xe))
        return inner(cfg, params, xe, *rest)

    module._expert_ffn = spy
    try:
        return fn(*args), seen
    finally:
        module._expert_ffn = inner


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_gather_with_forced_drops_matches_reference(arch):
    """Capacity factor 0.25 drops assignments: the same tokens in the same
    (expert, slot) cells, and the same output."""
    rc, tc, rp, tp = _moe(arch, moe_capacity_factor=0.25)
    x = _x((64, rc.d_model))
    (rout, raux), rxe = _gathered(ref_moe, ref_moe.moe_gather, rc, rp, jnp.asarray(x))
    (tout, taux), txe = _gathered(port_moe, port_moe.moe_gather, tc, tp, torch.from_numpy(x))
    cap = port_moe.capacity(tc, 64)
    assert cap * tc.n_experts < 64 * tc.top_k  # drops are forced
    assert len(rxe) == len(txe) == 1 and rxe[0].shape == txe[0].shape == (tc.n_experts, cap, tc.d_model)
    np.testing.assert_array_equal(txe[0], rxe[0])
    _close(tout, rout)
    _close(taux, raux)
    # the table itself: token ids, T where unfilled
    _, _, top_i, _ = port_moe._routing(tc, tp, torch.from_numpy(x)[None])
    disp, _ = port_moe.dispatch_table(tc, top_i)
    x_pad = np.concatenate([x, np.zeros((1, tc.d_model), np.float32)])
    np.testing.assert_array_equal(x_pad[disp[0].numpy()], rxe[0])
    assert int((disp[0] < 64).sum()) == tc.n_experts * cap


@pytest.mark.parametrize("t", [1, 24])
def test_apply_moe_keeps_per_row_capacity(t):
    """The batched dispatch against the reference's vmap over rows: at t 1
    (decode) every expert has capacity 4; at t 24 rows route apart."""
    rc, tc, rp, tp = _moe()
    x = _x((3, t, rc.d_model), seed=t)
    ry, raux = ref_moe.apply_moe(rc, rp, jnp.asarray(x))
    ty, taux = port_moe.apply_moe(tc, tp, torch.from_numpy(x))
    _close(ty, ry)
    _close(taux, raux)
    assert port_moe.capacity(tc, 1) == 4


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_gather_equals_dense_without_drops(arch):
    """With capacity n_experts / top_k no assignment is dropped, and the two
    dispatches compute the same function (here and in the reference)."""
    rc, tc, rp, tp = _moe(arch)
    factor = tc.n_experts / tc.top_k
    rc, tc = rc.replace(moe_capacity_factor=factor), tc.replace(moe_capacity_factor=factor)
    x = _x((48, rc.d_model), seed=5)
    gather, _ = port_moe.moe_gather(tc, tp, torch.from_numpy(x))
    dense, _ = port_moe.moe_dense(tc, tp, torch.from_numpy(x))
    _close(gather, dense.numpy())
    rdense, _ = ref_moe.moe_dense(rc, rp, jnp.asarray(x))
    _close(dense, rdense)


def test_routing_primitives_match_reference():
    """top-k (sorted), softmax probabilities and the aux loss on the same
    router weights; renormalised top-k (granite) and not (qwen2-moe)."""
    for arch in ("qwen2-moe-a2.7b", "granite-moe-3b-a800m"):
        rc, tc, rp, tp = _moe(arch)
        x = _x((40, rc.d_model), seed=7)
        rprobs, rw, ri, raux = ref_moe._routing(rc, rp, jnp.asarray(x))
        tprobs, tw, ti, taux = port_moe._routing(tc, tp, torch.from_numpy(x))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        _close(tw, rw)
        _close(tprobs, rprobs)
        _close(taux, raux)
        assert np.allclose(tw.sum(-1).numpy(), 1.0) == tc.moe_norm_topk


@pytest.mark.parametrize("kwargs", [{}, dict(tokens=128, d=32, e=4, top_k=2, d_ff=16)])
def test_moe_dispatch_site_flops_table_equals_reference(kwargs):
    port, ref = moe_dispatch_site(**kwargs, device="cpu"), jax_moe_dispatch_site(**kwargs)
    assert port.name == ref.name
    assert port.flops_table() == ref.flops_table()
    assert [v.meta for v in port.variants] == [v.meta for v in ref.variants]


def test_moe_dispatch_site_selects_gather():
    """The reference's test on the port, on the CPU, with one intra-op
    thread. The reference times each variant as one compiled executable;
    the port's variants run eagerly, and with eight intra-op threads every
    one of gather's ~30 small operations pays a thread fork and join, which
    at these widths costs as much as dense's 3.2x FLOPs: dense then ranks
    first in about half the runs (ROADMAP Queue 3). One thread is the
    ``cpu-1core`` host the reference's wall-clock machine model assumes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rep = rank_site(
            moe_dispatch_site(tokens=512, d=64, e=8, top_k=2, d_ff=32, device="cpu"),
            max_measurements=12,
        )
    finally:
        torch.set_num_threads(threads)
    assert rep.selected == "gather"
    ranks = rep.ranking.ranks
    if "dense" in ranks:  # dense may be dropped by the RT pre-filter
        assert ranks["gather"] <= ranks["dense"]
    else:
        assert "dense" in rep.dropped


def test_moe_dispatch_site_variants_agree():
    """The site's variants are the same function up to dropped tokens (the
    reference's bound), and its weights are ``init_moe``'s on its device."""
    site = moe_dispatch_site(tokens=128, d=32, e=4, top_k=2, d_ff=16, device="cpu")
    tensors = site.make_inputs(0)
    assert tensors[0].device.type == "cpu" and tensors[0].shape == (128, 32)
    outs = {v.name: v.build(*tensors)().numpy() for v in site.variants}
    agree = (np.abs(outs["gather"] - outs["dense"]) < 1e-3).mean()
    assert agree > 0.9, f"only {agree:.2%} of outputs agree"


def test_moe_dispatch_site_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe_dispatch_site()


def test_split_params_matches_reference_layout():
    """``init_moe``'s tree (values and axes) is the reference's."""
    rc, tc = ref_config("qwen2-moe-a2.7b", smoke=True), get_config("qwen2-moe-a2.7b", smoke=True)
    rv, ra = ref_split(ref_moe.init_moe(rc, jax.random.PRNGKey(0)))
    tv, ta = split_params(port_moe.init_moe(tc, torch.Generator().manual_seed(0)))
    assert jax.tree.map(lambda a: a.shape, rv) == jax.tree.map(lambda a: tuple(a.shape), tv)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.leaves(ta, is_leaf=is_axes) == jax.tree.leaves(ra, is_leaf=is_axes)
