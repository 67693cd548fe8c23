"""Kimi Delta Attention's chunked core (``models/kda.py``) on the CPU.

``kda_chunked`` is held to the recurrence taken one token at a time in
float64, at every chunk length, with and without an incoming state, and
with the decay at its steepest (g = -16 · 0.1 on every channel of every
token: A's largest initial value times softplus at the top of its range)
over whole chunks, where the cumulative decay of a chunk of 128 reaches
exp(-204.8), far below float32's range. Tolerance: the core in float32
reads about 4e-7 of the largest output at these sizes (roundings of sums
of at most a few hundred terms); 5e-6 holds that with room, while the same
core with its matrix products in TF32 (operands rounded to 10 mantissa
bits) reads 1e-4 or more and must fail it. The gradient through the core
is held to the recurrence's, and stays finite at the steepest decay.
"""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import formulas_kda
from repro_torch.autotune import kda_chunk_site
from repro_torch.models import kda as K
from repro_torch.models.flops import kda_chunk_flops

TOL = 5e-6
CHUNKS = (16, 32, 64, 128)


def rel(a, b):
    return float((a.double() - b).abs().max() / b.abs().max())


def draw(b=2, s=200, h=3, d=32, steep=False, seed=0):
    """q, k, v, g, beta, state in float64; s not a multiple of the chunks,
    so the last chunk is padded."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    q = K.l2_normalize(normal(b, s, h, d)) * d ** -0.5
    k = K.l2_normalize(normal(b, s, h, d))
    v = normal(b, s, h, d)
    g = (torch.full((b, s, h, d), -16 * 0.1, dtype=torch.float64) if steep
         else -torch.rand((b, s, h, d), generator=gen, dtype=torch.float64) * 0.3)
    beta = torch.sigmoid(normal(b, s, h))
    return q, k, v, g, beta, normal(b, h, d, d)


def recurrence64(q, k, v, g, beta, state):
    """The recurrence one token at a time, in float64."""
    outs = []
    for t in range(q.shape[1]):
        state = state * torch.exp(g[:, t])[..., None]
        u = beta[:, t, :, None] * (v[:, t] - torch.einsum("bhkv,bhk->bhv", state, k[:, t]))
        state = state + k[:, t, :, :, None] * u[:, :, None, :]
        outs.append(torch.einsum("bhkv,bhk->bhv", state, q[:, t]))
    return torch.stack(outs, dim=1), state


def tf32(t):
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("incoming", [False, True])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_matches_the_recurrence(chunk, incoming, steep):
    q, k, v, g, beta, s0 = draw(steep=steep)
    init = s0 if incoming else torch.zeros_like(s0)
    want_o, want_s = recurrence64(q, k, v, g, beta, init)
    o, s = K.kda_chunked(*(t.float() for t in (q, k, v, g, beta)), chunk,
                         init.float() if incoming else None)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    assert o.dtype == torch.float32 and o.shape == want_o.shape and s.shape == want_s.shape
    assert rel(o, want_o) < TOL and rel(s, want_s) < TOL


def test_a_tf32_core_fails_the_tolerance(monkeypatch):
    q, k, v, g, beta, s0 = draw(steep=True)
    want_o, want_s = recurrence64(q, k, v, g, beta, s0)
    real = torch.Tensor.__matmul__
    monkeypatch.setattr(torch.Tensor, "__matmul__", lambda a, b: real(tf32(a), tf32(b)))
    o, s = K.kda_chunked(*(t.float() for t in (q, k, v, g, beta)), 64, s0.float())
    monkeypatch.undo()
    assert max(rel(o, want_o), rel(s, want_s)) > 20 * TOL


def test_steepest_decay_underflows_and_never_overflows():
    """A chunk of 128 at the steepest decay: the decays from the chunk's
    start reach exp(-204.8), zero in float32; nothing reaches inf."""
    q, k, v, g, beta, s0 = draw(b=1, s=256, h=1, d=16, steep=True)
    assert float(g[0, :128, 0, 0].sum()) == pytest.approx(-204.8)
    assert math.exp(-204.8) > 0 and torch.exp(torch.tensor(-204.8, dtype=torch.float32)) == 0
    o, s = K.kda_chunked(*(t.float() for t in (q, k, v, g, beta)), 128, s0.float())
    assert torch.isfinite(o).all() and torch.isfinite(s).all()


def test_diagonal_groups_bound_memory_and_change_nothing(monkeypatch):
    """The diagonal sub-blocks taken one chunk at a time (the smallest
    group) give what one group of all chunks gives."""
    q, k, v, g, beta, s0 = (t.float() for t in draw(s=160))
    whole = K.kda_chunked(q, k, v, g, beta, 32, s0)
    monkeypatch.setattr(K, "DIAG_ELEMENTS", 1)
    grouped = K.kda_chunked(q, k, v, g, beta, 32, s0)
    assert all(rel(a, b.double()) < 1e-6 for a, b in zip(grouped, whole))


def test_recurrent_step_is_the_recurrence():
    q, k, v, g, beta, s0 = draw(s=24)
    want_o, want_s = recurrence64(q, k, v, g, beta, s0)
    o, s = K.kda_recurrent(*(t.float() for t in (q, k, v, g, beta)), s0.float())
    assert rel(o, want_o) < TOL and rel(s, want_s) < TOL


@pytest.mark.parametrize("steep", [False, True])
def test_gradient_matches_the_recurrence(steep):
    """The training path's backward through the chunked core: finite, and
    within 1e-4 of the token-by-token recurrence's."""
    leaves = [t.float() for t in draw(b=1, s=80, h=2, d=16, steep=steep, seed=3)]
    weight = torch.randn((1, 80, 2, 16), generator=torch.Generator().manual_seed(4))
    grads = {}
    for name, fn in (("chunked", lambda *a: K.kda_chunked(*a[:5], 32, a[5])),
                     ("recurrent", K.kda_recurrent)):
        inputs = [t.clone().requires_grad_(True) for t in leaves]
        o, s = fn(*inputs)
        ((o * weight).sum() + s.sum()).backward()
        grads[name] = [t.grad for t in inputs]
    for got, want in zip(grads["chunked"], grads["recurrent"]):
        assert torch.isfinite(got).all()
        assert rel(got, want.double()) < 1e-4


def test_chunk_must_be_whole_sub_blocks():
    q, k, v, g, beta, _ = (t.float() for t in draw(s=32))
    with pytest.raises(ValueError):
        K.kda_chunked(q, k, v, g, beta, 24)


def test_flop_table_is_the_frozen_one_and_least_at_the_shortest_chunk():
    site = kda_chunk_site(b=8, s=2048, h=32, dk=128, dv=128, device="cpu")
    table = site.flops_table()
    assert set(table) == {"chunk_32", "chunk_64", "chunk_128"}
    for b, s in ((1, 16384), (2, 8192), (4, 4096), (8, 2048)):
        for c in (32, 64, 128):
            assert kda_chunk_flops(b, s, 32, 128, 128, c) == formulas_kda.kda_flops(b, s, 32, 128, 128, c)
    assert table == {f"chunk_{c}": formulas_kda.kda_flops(8, 2048, 32, 128, 128, c) for c in (32, 64, 128)}
    assert min(table, key=table.get) == "chunk_32"
    # per token and head: 3C(dk + dv) + 2·16·dk + 6·dk·dv
    assert table["chunk_64"] == 8 * 2048 * 32 * (3 * 64 * 256 + 2 * 16 * 128 + 6 * 128 * 128)


def test_site_variants_agree_with_the_recurrence():
    site = kda_chunk_site(b=2, s=96, h=2, dk=16, dv=16, chunks=(16, 32, 64), device="cpu")
    q, k, v, g, beta, s0 = site.make_inputs(3)
    assert float(g.max()) < 0 and float(g.min()) >= -16 * 1.1
    want_o, want_s = recurrence64(*(t.double() for t in (q, k, v, g, beta, s0)))
    for name, fn in site.workloads(seed=3).items():
        o, s = fn()
        assert rel(o, want_o) < TOL and rel(s, want_s) < TOL, name


def test_core_opens_its_spans():
    q, k, v, g, beta, s0 = (t.float() for t in draw(s=64))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        K.kda_chunked(q, k, v, g, beta, 32, s0)
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("rt.kda.")]
    names = [e.name() for e in events]
    assert names.count("rt.kda.chunk") == 1 and names.count("rt.kda.pass") == 1
    chunk = next(e for e in events if e.name() == "rt.kda.chunk")
    loop = next(e for e in events if e.name() == "rt.kda.pass")
    assert chunk.start_ns() <= loop.start_ns() and loop.end_ns() <= chunk.end_ns()
