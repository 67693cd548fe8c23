"""The port's attention variants (``repro_torch.models.attention``) and the
``attention_impl`` / ``ssd_chunk`` autotune sites against the JAX package's,
on numpy-made inputs at the shapes of ``tests/test_models.py``.
Tolerances: 2e-5 for the same function in both packages and for
grouped == broadcast, 2e-4 for blockwise against full scores (the
reference's), 3e-4 for the SSD scans."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.autotune.variants import attention_site as jax_attention_site  # noqa: E402
from repro.autotune.variants import ssd_chunk_site as jax_ssd_chunk_site  # noqa: E402
from repro_torch.autotune import attention_site, rank_site_costmodel, ssd_chunk_site  # noqa: E402
from repro_torch.models.layers import softcap  # noqa: E402
from repro_torch.models.mamba2 import ssd_reference  # noqa: E402

# the modules, not the like-named functions the two ``models`` packages export
jatt = importlib.import_module("repro.models.attention")
tatt = importlib.import_module("repro_torch.models.attention")


def _qkv(b=2, s=128, h=4, kv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _close(out, expect, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expect, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("gqa", ["grouped", "broadcast"])
@pytest.mark.parametrize("causal,window,cap,q_offset",
                         [(True, None, None, 0), (False, None, None, 0),
                          (True, 48, 30.0, 0), (True, None, None, 16)])
def test_attention_reference_parity(gqa, causal, window, cap, q_offset):
    jx, tx = _qkv()
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset, gqa=gqa)
    out = tatt.attention_reference(*tx, **kw)
    _close(out, jatt.attention_reference(*jx, **kw), 2e-5)


def test_attention_variants_agree():
    """grouped == broadcast == chunked, as test_attention_variants_agree."""
    _, tx = _qkv()
    ref_g = tatt.attention_reference(*tx, gqa="grouped")
    ref_b = tatt.attention_reference(*tx, gqa="broadcast")
    chk = tatt.attention_chunked(*tx, q_block=32, kv_block=64)
    _close(ref_b, ref_g.numpy(), 2e-5)
    _close(chk, ref_g.numpy(), 2e-4)


@pytest.mark.parametrize("qb,kb", [(16, 32), (32, 32), (64, 128)])
@pytest.mark.parametrize("window,cap", [(None, None), (40, 50.0)])
def test_attention_chunked_parity(qb, kb, window, cap):
    jx, tx = _qkv()
    kw = dict(window=window, logit_cap=cap, q_block=qb, kv_block=kb)
    out = tatt.attention_chunked(*tx, **kw)
    _close(out, jatt.attention_chunked(*jx, **kw), 2e-5)
    _close(out, tatt.attention_reference(*tx, window=window, logit_cap=cap).numpy(), 2e-4)


def test_attention_chunked_rejects_ragged_blocks():
    _, tx = _qkv(s=96)
    with pytest.raises(ValueError):
        tatt.attention_chunked(*tx, q_block=64, kv_block=64)


@pytest.mark.parametrize("window,q_block", [(48, 32), (200, 64)])  # sliced span; span >= skv
def test_local_chunked_parity(window, q_block):
    jx, tx = _qkv(s=256)
    out = tatt.attention_local_chunked(*tx, window=window, q_block=q_block)
    _close(out, jatt.attention_local_chunked(*jx, window=window, q_block=q_block), 2e-5)
    _close(out, tatt.attention_reference(*tx, window=window).numpy(), 2e-4)


@pytest.mark.parametrize("cache_len,window,cap", [(20, None, None), (32, 8, 30.0),
                                                  ([5, 27], None, None)])
def test_decode_attention_parity(cache_len, window, cap):
    b, S, h, kv, d = 2, 32, 4, 2, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, S, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, S, kv, d)).astype(np.float32)
    kw = dict(window=window, logit_cap=cap)
    out = tatt.decode_attention(*map(torch.from_numpy, (q, k, v)), torch.tensor(cache_len), **kw)
    expect = jatt.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(cache_len), **kw)
    _close(out, expect, 2e-5)


def test_decode_attention_ring_positions_parity():
    """A ring cache: slot -> absolute position, -1 for unwritten slots."""
    b, S, h, kv, d = 1, 8, 2, 2, 16
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, 1, h, d), (b, S, kv, d), (b, S, kv, d)))
    pos = np.array([8, 9, 10, 3, 4, 5, 6, 7], np.int32)
    out = tatt.decode_attention(*map(torch.from_numpy, (q, k, v)), 11, window=6,
                                kv_positions=torch.from_numpy(pos))
    expect = jatt.decode_attention(*map(jnp.asarray, (q, k, v)), 11, window=6,
                                   kv_positions=jnp.asarray(pos))
    _close(out, expect, 2e-5)


@pytest.mark.parametrize("position", [0, 3, 7, 100])  # 100: clamped so the update fits
def test_kv_cache_helpers_parity(position):
    rng = np.random.default_rng(position)
    k_new = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    v_new = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    cache = tatt.init_kv_cache(2, 10, 2, 8, torch.float32, device="cpu")
    jcache = jatt.init_kv_cache(2, 10, 2, 8, jnp.float32)
    out = tatt.update_kv_cache(cache, torch.from_numpy(k_new), torch.from_numpy(v_new), position)
    expect = jatt.update_kv_cache(jcache, jnp.asarray(k_new), jnp.asarray(v_new), position)
    for name in ("k", "v"):
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(expect[name]))
        assert not cache[name].any()  # the input cache is unchanged


def test_mask_bias_and_softcap_parity():
    q_pos, kv_pos = np.arange(6) + 2, np.arange(9)
    out = tatt._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(kv_pos), True, 3, kv_len=7)
    expect = jatt._mask_bias(jnp.asarray(q_pos), jnp.asarray(kv_pos), True, 3, kv_len=7)
    np.testing.assert_array_equal(out.numpy(), np.asarray(expect))
    x = torch.linspace(-300, 300, 31)
    assert torch.equal(softcap(x, None), x)
    assert torch.allclose(softcap(x, 50.0), 50.0 * torch.tanh(x / 50.0))


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attention_site()  # device="cuda" by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tatt.init_kv_cache(1, 8, 1, 16, torch.float32)


# ------------------------------------------------------------------ sites --

@pytest.mark.parametrize("kw", [{}, dict(b=1, s=64, h=4, kv=2, d=16)])
def test_attention_site_names_and_flops_equal_the_reference(kw):
    port, ref = attention_site(device="cpu", **kw), jax_attention_site(**kw)
    assert port.name == ref.name
    assert [v.name for v in port.variants] == [v.name for v in ref.variants]
    assert port.flops_table() == ref.flops_table()
    assert [v.meta for v in port.variants] == [v.meta for v in ref.variants]


@pytest.mark.parametrize("kw", [{}, dict(b=1, s=128, h=2, p=8, n=4, chunks=(16, 32, 64))])
def test_ssd_chunk_site_names_and_flops_equal_the_reference(kw):
    port, ref = ssd_chunk_site(device="cpu", **kw), jax_ssd_chunk_site(**kw)
    assert port.name == ref.name
    assert [v.name for v in port.variants] == [v.name for v in ref.variants]
    assert port.flops_table() == ref.flops_table()
    assert [v.meta for v in port.variants] == [v.meta for v in ref.variants]


def test_attention_site_variants_equal_the_oracle():
    site = attention_site(b=1, s=64, h=4, kv=2, d=16, device="cpu")
    q, k, v = site.make_inputs(0)
    assert all(t.device.type == "cpu" for t in (q, k, v))
    expect = tatt.attention_reference(q, k, v)
    for variant in site.variants:
        _close(variant.build(q, k, v)(), expect.numpy(), 2e-4)
    again = site.make_inputs(0)  # the site's generator is seeded, inputs repeat
    assert all(torch.equal(a, b) for a, b in zip((q, k, v), again))


def test_ssd_chunk_site_variants_equal_the_oracle():
    site = ssd_chunk_site(b=1, s=128, h=2, p=8, n=4, chunks=(16, 32, 64), device="cpu")
    x, dt, a_log, bm, cm = site.make_inputs(0)
    assert bool((dt > 0).all())
    expect, _ = ssd_reference(x, dt, a_log, bm, cm)
    for variant in site.variants:
        _close(variant.build(x, dt, a_log, bm, cm)(), expect.numpy(), 3e-4)


def test_sites_rank_under_the_cost_model():
    """The sites plug into the tuner (FLOP-only cost model, no timing)."""
    for site in (attention_site(b=1, s=64, h=4, kv=2, d=16, device="cpu"),
                 ssd_chunk_site(b=1, s=128, h=2, p=8, n=4, chunks=(16, 32, 64), device="cpu")):
        flops = site.flops_table()
        costs = {name: f / 1e12 for name, f in flops.items()}  # a FLOP-only cost model
        report = rank_site_costmodel(site.name, costs, flops)
        assert report.selected in flops
