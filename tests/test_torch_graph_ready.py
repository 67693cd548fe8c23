"""The port's graph-ready serving step and measured thunks, on the CPU.

On the card the serving engine captures ``lm_prefill_inplace`` and
``lm_decode_inplace`` as CUDA graphs, and the generalized families and the
autotune sites capture their timed thunks. A capture refuses any read of a
device value on the host. These tests hold the in-place steps to the
reference's functional ones on the reference's weights (logits within
``2e-4 * (1 + max|ref|)``, caches within 1e-4), their state buffers to
their addresses, and the whole step to the ``meta`` device, where a host
read of a tensor's value raises as a capture would; the device-position
slice update is held exactly to ``lax.dynamic_update_slice``, and the
checked factorizations of ``solve_family`` exactly to the checked calls.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as R  # noqa: E402
import repro_torch.models as T  # noqa: E402
from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.expressions.generalized import solve_family  # noqa: E402
from repro_torch.models.layers import params_from_numpy, tree_leaves, tree_map, update_slice_  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402

LM_ARCHS = [a for a in ARCH_NAMES if a != "whisper-tiny"]
LOGIT_TOL = 2e-4


def _params(arch):
    rc, tc = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    rp, _ = R.init_lm_params(rc, jax.random.PRNGKey(0))
    return rc, tc, rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _assert_logits(port, ref, what):
    ref = np.asarray(ref)
    err = float(np.abs(port.numpy() - ref).max())
    assert err <= LOGIT_TOL * (1 + float(np.abs(ref).max())), f"{what}: max|port - ref| {err}"


def _assert_state(port, ref, what):
    for (path, r), t in zip(jax.tree_util.tree_leaves_with_path(ref), jax.tree.leaves(port)):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(r, np.float32), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _run_inplace(arch, prompt_len, max_len, n_steps, batch=2):
    """The reference's prefill and decode steps beside the port's in-place
    ones on one state, the position a 0-d int64 tensor advanced in place."""
    rc, tc, rp, tp = _params(arch)
    tok = _tokens(rc, (batch, prompt_len + n_steps))
    rstate = R.init_lm_state(rc, batch, max_len)
    state = T.init_lm_state(tc, batch, max_len, device="cpu")
    rl, rstate = R.lm_prefill(rc, rp, rstate, tokens=jnp.asarray(tok[:, :prompt_len]))
    tl = T.lm_prefill_inplace(tc, tp, state, tokens=torch.from_numpy(tok[:, :prompt_len]))
    _assert_logits(tl, rl, f"{arch} prefill")
    position = torch.tensor(prompt_len, dtype=torch.int64)
    for t in range(prompt_len, prompt_len + n_steps):
        rl, rstate = R.lm_decode_step(rc, rp, rstate, jnp.asarray(tok[:, t: t + 1]), jnp.int32(t))
        tl = T.lm_decode_inplace(tc, tp, state, torch.from_numpy(tok[:, t: t + 1]), position)
        position.add_(1)
        _assert_logits(tl, rl, f"{arch} decode at {t}")
    _assert_state(state, rstate, arch)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_inplace_prefill_and_decode_match_reference(arch):
    _run_inplace(arch, prompt_len=12, max_len=24, n_steps=4)


def test_inplace_decode_across_the_ring_wrap_matches_reference():
    """gemma2's windowed layers keep a 128-slot ring: a 130-token prompt
    fills it in two segments and decode writes across the wrap."""
    _run_inplace("gemma2-27b", prompt_len=130, max_len=160, n_steps=6, batch=1)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_inplace_steps_keep_state_addresses(arch):
    cfg = get_config(arch, smoke=True)
    params, _ = T.init_lm_params(cfg, seed=0, device="cpu")
    state = T.init_lm_state(cfg, 2, 16, device="cpu")
    before = [leaf.data_ptr() for leaf in tree_leaves(state)]
    tok = torch.from_numpy(_tokens(cfg, (2, 10)))
    T.lm_prefill_inplace(cfg, params, state, tokens=tok[:, :8])
    position = torch.tensor(8)
    for t in (8, 9):
        T.lm_decode_inplace(cfg, params, state, tok[:, t: t + 1], position)
        position.add_(1)
    assert [leaf.data_ptr() for leaf in tree_leaves(state)] == before


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "gemma2-27b", "jamba-v0.1-52b", "mamba2-1.3b"])
def test_functional_steps_leave_their_input_state_unchanged(arch):
    cfg = get_config(arch, smoke=True)
    params, _ = T.init_lm_params(cfg, seed=0, device="cpu")
    tok = torch.from_numpy(_tokens(cfg, (2, 10)))
    state = T.init_lm_state(cfg, 2, 16, device="cpu")
    _, state = T.lm_prefill(cfg, params, state, tokens=tok[:, :8])
    kept = tree_map(torch.clone, state)
    logits, new = T.lm_decode_step(cfg, params, state, tok[:, 8:9], 8)
    for a, b in zip(tree_leaves(state), tree_leaves(kept)):
        assert torch.equal(a, b)
    # and the functional step is the in-place one on a copy
    inplace = tree_map(torch.clone, state)
    torch.testing.assert_close(T.lm_decode_inplace(cfg, params, inplace, tok[:, 8:9], torch.tensor(8)), logits,
                               rtol=0, atol=0)
    for a, b in zip(tree_leaves(inplace), tree_leaves(new)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("start", [-1, 0, 9, 13])  # S = 10: -1 and S + 3 are clamped
def test_update_slice_at_a_device_position_matches_dynamic_update_slice(start):
    rng = np.random.default_rng(start + 2)
    t = rng.standard_normal((2, 10, 3)).astype(np.float32)
    new = rng.standard_normal((2, 1, 3)).astype(np.float32)
    want = jax.lax.dynamic_update_slice(jnp.asarray(t), jnp.asarray(new), (0, start, 0))
    out = torch.from_numpy(t.copy())
    got = update_slice_(out, torch.from_numpy(new), torch.tensor(start, dtype=torch.int64), dim=1)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    # a block wider than one row, clamped the same way
    wide = rng.standard_normal((2, 4, 3)).astype(np.float32)
    want = jax.lax.dynamic_update_slice(jnp.asarray(t), jnp.asarray(wide), (0, start, 0))
    out = update_slice_(torch.from_numpy(t.copy()), torch.from_numpy(wide), torch.tensor(start), dim=1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    # a host integer start takes the same place
    out = update_slice_(torch.from_numpy(t.copy()), torch.from_numpy(wide), start, dim=1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("position", [0, 60])  # 60 + 8 > 64: the write is clamped
def test_quant_cache_update_at_a_device_position(position):
    """The int8 cache's update takes its position as a device tensor (no
    host read: it runs on ``meta``) and writes where a host integer does."""
    from repro_torch.serve import quant as tq

    rng = np.random.default_rng(position)
    k, v = (torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(np.float32)) for _ in range(2))
    cache = tq.init_quant_kv_cache(2, 64, 2, 16, device="cpu")
    want = tq.update_quant_kv_cache(cache, k, v, position)
    got = tq.update_quant_kv_cache(cache, k, v, torch.tensor(position))
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert not cache["k_q"].any()  # the input cache is unchanged
    meta = tq.update_quant_kv_cache(tq.init_quant_kv_cache(2, 64, 2, 16, device="meta"), k.to("meta"),
                                    v.to("meta"), torch.tensor(position, device="meta"))
    assert all(t.is_meta for t in meta.values())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_inplace_steps_run_on_the_meta_device(arch):
    """Parameters, state, tokens and position on ``meta``: a tensor there
    has no value, so any read of one on the host (``int``, ``.item()``,
    ``.tolist()``, a branch) raises, as it would break a CUDA graph's
    capture."""
    cfg = get_config(arch, smoke=True)
    params, _ = T.init_lm_params(cfg, device="meta")
    state = T.init_lm_state(cfg, 2, 16, device="meta")
    assert all(leaf.is_meta for leaf in tree_leaves(params) + tree_leaves(state))
    prompt = torch.zeros((2, 8), dtype=torch.int64, device="meta")
    logits = T.lm_prefill_inplace(cfg, params, state, tokens=prompt)
    assert logits.is_meta and logits.shape == (2, cfg.vocab_size)
    position = torch.zeros((), dtype=torch.int64, device="meta")
    logits = T.lm_decode_inplace(cfg, params, state, prompt[:, :1], position)
    assert logits.is_meta and logits.shape == (2, cfg.vocab_size)
    with pytest.raises((RuntimeError, NotImplementedError)):
        int(position)  # the guard is real: a host read on meta raises


def test_engine_refuses_graphs_on_the_cpu():
    cfg = get_config("granite-8b", smoke=True)
    with pytest.raises(ValueError, match="graphs=True needs a CUDA device"):
        ServingEngine(cfg, {}, device="cpu", graphs=True)
    assert ServingEngine(cfg, {}, device="cpu").graphs is False


def test_engine_reuses_its_buffers_across_generations():
    """One engine, three generations of two prompt lengths on the same
    static buffers: each equals a fresh engine's (the prefill clears what
    an earlier generation left in the state)."""
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    params, _ = T.init_lm_params(cfg, seed=0, device="cpu")
    engine = ServingEngine(cfg, params, max_len=32, device="cpu", graphs=False)
    long_, short = (torch.from_numpy(_tokens(cfg, (2, s), seed=s)) for s in (12, 5))
    first = engine.generate(long_, 8)
    state = engine.slots[2].state
    ptrs = [leaf.data_ptr() for leaf in tree_leaves(state)]
    second = engine.generate(short, 8)
    third = engine.generate(long_, 8)
    assert torch.equal(first, third)
    assert torch.equal(second, ServingEngine(cfg, params, max_len=32, device="cpu").generate(short, 8))
    assert [leaf.data_ptr() for leaf in tree_leaves(engine.slots[2].state)] == ptrs
    assert sorted(engine.slots[2].prefills) == [5, 12] and list(engine.slots) == [2]


# ------------------------------------------------------------ thunks ---

def _spd(size, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((size, size)).astype(np.float32) / np.sqrt(size)
    return (a @ a.T + size * np.eye(size, dtype=np.float32)).astype(np.float32), \
        rng.standard_normal(size).astype(np.float32)


@pytest.mark.parametrize("size", [16, 64])
def test_solve_family_checked_variants_equal_the_checked_calls(size):
    a, b = _spd(size, size)
    table = solve_family(size).workloads_from_reference([a, b], device="cpu")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    l = torch.linalg.cholesky(ta)
    y = torch.linalg.solve_triangular(l, tb[:, None], upper=False)
    want = {"solve_inverse": torch.linalg.inv(ta) @ tb, "solve_lu": torch.linalg.solve(ta, tb),
            "solve_chol": torch.linalg.solve_triangular(l.T, y, upper=True)[:, 0]}
    assert list(table) == list(want)
    for name, thunk in table.items():
        assert torch.equal(thunk(), want[name]), name


@pytest.mark.parametrize("variant", ["solve_inverse", "solve_lu", "solve_chol"])
def test_solve_family_refuses_a_failed_factorization_at_warm_up(variant):
    a, b = _spd(16, 3)
    bad = -a if variant == "solve_chol" else np.zeros_like(a)  # not SPD / singular
    fam = solve_family(16)
    build = {v.name: v.build for v in fam.variants}[variant]
    with pytest.raises(torch.linalg.LinAlgError, match="info"):
        build(torch.from_numpy(bad), torch.from_numpy(b))


def test_measured_thunk_runs_eagerly_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    x = torch.arange(4.0)
    thunk = graphs.measured_thunk(fn, x)
    assert len(calls) == 1  # the warm-up
    assert torch.equal(thunk(), x * 2) and len(calls) == 2
    with graphs.eager_thunks():
        graphs.measured_thunk(fn, x)()
    assert len(calls) == 4 and not graphs._eager_thunks.get()
