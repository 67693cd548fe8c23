"""The free list of graph memory pools (``repro_torch/graphs.py``).

On the CPU, with a stub pool factory: an empty list makes a pool, a pool
comes back when the owner of its graph is collected, the next capture gets
the pool that came back first, lists are kept per device, ``release_pools``
empties them, taking a pool is one ``rt.graph.pool.*`` span, and threads
that take and return pools at once lose none and share none.

The hand kernels' launches and counts (``kernels/build.py``'s
``HandKernel``), on the CPU with the bound C function faked: each wrapper's
call matches its kernel's declared arguments, a nonzero return raises
naming the kernel, and ``reset`` zeroes every count.

On the card (marked ``cuda``, skipped without one): a second build of the
same chain instance allocates no device memory, an output kept past its
graph survives the next instance's capture into the recycled pool,
``release_pools`` with ``empty_cache`` gives the pools' memory back, and
each hand kernel launched inside ``graphs.capture`` counts once a replay.
"""

import gc
import itertools
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import graphs
from repro_torch.expressions import build_workloads, generate_chain_algorithms, make_chain_inputs
from repro_torch.kernels.flash_attention import flash_attention as fmod
from repro_torch.kernels.matmul import matmul as kmod
from repro_torch.kernels.ssd import ssd as smod


class Owner:
    """Stands in for a replay: the only holder of its graph."""


@pytest.fixture
def stub_pools(monkeypatch):
    """Fresh free lists and a factory of numbered stub pools; yields the
    list of pools made so far."""
    made = []
    counter = itertools.count()

    def new_pool():
        made.append(f"pool{next(counter)}")
        return made[-1]

    monkeypatch.setattr(graphs, "_free_pools", {})
    monkeypatch.setattr(graphs, "_Pool", new_pool)
    return made


def free(index):
    """Device ``index``'s free list, first to be taken first."""
    return list(graphs._free_pools.get(index, ()))


def lend(index, pool):
    """An owner whose collection returns ``pool`` to device ``index``."""
    owner = Owner()
    graphs._return_pool_with(owner, index, pool)
    return owner


def test_empty_list_makes_a_pool(stub_pools):
    assert graphs._take_pool(0) == "pool0"
    assert graphs._take_pool(0) == "pool1"
    assert stub_pools == ["pool0", "pool1"]


def test_pool_comes_back_when_its_owner_is_collected(stub_pools):
    pool = graphs._take_pool(0)
    owner = lend(0, pool)
    gc.collect()
    assert free(0) == []
    del owner
    assert free(0) == [pool]
    assert graphs._take_pool(0) == pool
    assert stub_pools == [pool]


def test_pool_comes_back_when_a_cycle_holding_its_owner_is_collected(stub_pools):
    pool = graphs._take_pool(0)
    owner = lend(0, pool)
    owner.me = owner
    del owner
    assert free(0) == []
    gc.collect()
    assert free(0) == [pool]


def test_next_capture_gets_the_pool_that_came_back_first(stub_pools):
    first, second, third = (graphs._take_pool(0) for _ in range(3))
    owners = [lend(0, pool) for pool in (first, second, third)]
    del owners[2], owners[0], owners[0]  # third, then first, then second collected
    assert free(0) == [third, first, second]
    assert [graphs._take_pool(0) for _ in range(4)] == [third, first, second, "pool3"]


def test_a_build_dropped_in_order_gets_its_own_pools_back(stub_pools):
    built = {f"alg{i}": lend(0, graphs._take_pool(0)) for i in range(6)}
    del built  # a dict drops its values in the order they were put in
    assert [graphs._take_pool(0) for _ in range(6)] == stub_pools[:6]


def test_pools_are_listed_per_device(stub_pools):
    on0, on1 = graphs._take_pool(0), graphs._take_pool(1)
    owners = [lend(0, on0), lend(1, on1)]
    del owners
    assert (free(0), free(1)) == ([on0], [on1])
    assert graphs._take_pool(1) == on1
    assert graphs._take_pool(1) == "pool2"
    assert graphs._take_pool(0) == on0


def test_release_pools_empties_every_list(stub_pools):
    owners = [lend(index, graphs._take_pool(index)) for index in (0, 0, 1)]
    del owners
    assert sum(len(free) for free in graphs._free_pools.values()) == 3
    graphs.release_pools()
    assert graphs._free_pools == {}
    assert graphs._take_pool(0) == "pool3"


def test_taking_a_pool_is_one_span(stub_pools):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        owner = lend(0, graphs._take_pool(0))
        del owner
        graphs._take_pool(0)
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.name().startswith("rt.")]
    assert names == ["rt.graph.pool.new", "rt.graph.pool.reused"]


def test_threads_taking_and_returning_pools_lose_none_and_share_none(stub_pools):
    held, errors = set(), []
    guard = threading.Lock()

    def work():
        try:
            for _ in range(300):
                pool = graphs._take_pool(0)
                with guard:
                    assert pool not in held, f"{pool} lent twice"
                    held.add(pool)
                owner = lend(0, pool)
                with guard:
                    held.discard(pool)
                del owner  # returns the pool
        except AssertionError as exc:  # pragma: no cover - reported below
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range((os.cpu_count() or 1) + 4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert 1 <= len(stub_pools) <= len(threads)
    assert sorted(free(0)) == sorted(stub_pools)


# --- the hand kernels' launches and counts --------------------------------


def _launch_gemm():
    a, b = torch.randn(8, 8), torch.randn(8, 8)
    kmod.launch(a, b, torch.empty(8, 8), (16, 16, 16), kmod.SHIFT)


def _launch_flash():
    q, kv = torch.randn(1, 128, 4, 32), torch.randn(1, 128, 2, 32)
    fmod.launch(q, kv, kv, torch.empty_like(q), causal=True, sm_scale=None, logit_cap=30.0, window=64)


def _launch_ssd():
    bc = torch.randn(1, 64, 1, 8)
    smod.pass_launcher(torch.randn(1, 64, 2, 16), -torch.rand(1, 64, 2), bc, bc, chunk=32)(smod.ALL_PASSES)


#: each kernel's module and one launch by its wrapper's own launcher
LAUNCHES = {"gemm": (kmod, _launch_gemm), "flash": (fmod, _launch_flash), "ssd": (smod, _launch_ssd)}


@pytest.fixture
def fake_card(monkeypatch):
    """The CUDA calls of a launch and a count, answered on the CPU: no
    stream is being captured, CPU tensors' device (index None) is the
    current one, and its current stream is 7."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_each_wrapper_calls_its_function_with_the_declared_arguments(name, fake_card, monkeypatch):
    mod, launch = LAUNCHES[name]
    calls = []
    monkeypatch.setattr(mod.KERNEL, "fn", lambda *args: calls.append(args) or 0)
    before = mod.KERNEL.launches
    launch()
    (args,) = calls
    assert len(args) == len(mod.KERNEL.argtypes) and args[-1] == 7  # the stream last
    for ctype, arg in zip(mod.KERNEL.argtypes, args):
        ctype(arg)  # raises on a value the declared type does not take
    assert mod.KERNEL.launches == before  # a launch alone counts nothing


@pytest.mark.parametrize("name,err,words", [
    ("gemm", 700, "GEMM kernel launch failed: error 700 (CUDA error) for tile (16, 16, 16)"),
    ("flash", -3, "flash-attention kernel launch failed: error -3 (a TMA tensor map could not be encoded)"),
    ("flash", 1, "flash-attention kernel launch failed: error 1 (CUDA error) for q (1, 128, 4, 32)"),
    ("ssd", 98, "SSD kernel launch failed: error 98 (CUDA error) for xbar (1, 64, 2, 16)"),
])
def test_a_nonzero_return_raises_naming_the_kernel(name, err, words, fake_card, monkeypatch):
    mod, launch = LAUNCHES[name]
    monkeypatch.setattr(mod.KERNEL, "fn", lambda *args: err)
    with pytest.raises(RuntimeError) as raised:
        launch()
    assert words in str(raised.value)


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_reset_zeroes_every_count(name, fake_card):
    kernel = LAUNCHES[name][0].KERNEL
    kernel.reset()
    for key in kernel.keys:
        kernel.count(key)
        kernel.count(key)
    assert kernel.launches == 2 * len(kernel.keys) and set(kernel.launches_by.values()) == {2}
    kernel.reset()
    assert kernel.launches == 0 and kernel.launches_by == dict.fromkeys(kernel.keys, 0)


# --- on the card ---------------------------------------------------------


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port captures CUDA graphs only there")
    return torch.device("cuda", 0)


def fresh(dev):
    """No pool on the free list, nothing cached: a test's clean start."""
    gc.collect()
    graphs.release_pools()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()


def build_and_run(dims, mats):
    """One chain instance's graphs, built (captured and replayed once) and
    dropped."""
    built = build_workloads(generate_chain_algorithms(dims), mats, jit=True)
    for fn in built.values():
        fn()


@pytest.mark.cuda
def test_second_build_of_an_instance_allocates_no_device_memory():
    dev = needs_card()
    fresh(dev)
    dims = (1637, 1102, 1958, 1411, 1290)
    mats = make_chain_inputs(dims, seed=21, device=dev)
    build_and_run(dims, mats)
    assert len(graphs._free_pools[0]) == len(generate_chain_algorithms(dims))
    torch.cuda.empty_cache()
    before = torch.cuda.memory_stats(dev)["num_device_alloc"]
    build_and_run(dims, mats)
    assert torch.cuda.memory_stats(dev)["num_device_alloc"] == before


@pytest.mark.cuda
def test_output_kept_past_its_graph_survives_the_next_capture_in_its_pool():
    dev = needs_card()
    fresh(dev)
    dims = (1200, 1500, 1100, 1300, 1000)
    mats = make_chain_inputs(dims, seed=22, device=dev)
    built = build_workloads(generate_chain_algorithms(dims), mats, jit=True)
    kept = {name: fn() for name, fn in built.items()}
    snapshot = {name: out.clone() for name, out in kept.items()}
    del built  # every graph dropped; its output is kept
    n_free = len(graphs._free_pools[0])
    assert n_free == len(kept)
    other = (1900, 1000, 2000, 1800, 1950)
    built = build_workloads(generate_chain_algorithms(other), make_chain_inputs(other, seed=23, device=dev),
                            jit=True)
    assert len(built) == n_free and free(0) == []  # every pool taken again
    for _ in range(3):
        for fn in built.values():
            fn()
    torch.cuda.synchronize(dev)
    for name, out in kept.items():
        assert torch.equal(out, snapshot[name]), name


@pytest.mark.cuda
def test_release_pools_and_empty_cache_give_the_memory_back():
    dev = needs_card()
    fresh(dev)
    dims = (1400, 1300, 1700, 1200, 1600)
    mats = make_chain_inputs(dims, seed=24, device=dev)
    build_and_run(dims, mats)  # the side stream's one-time set-up, then a clean start
    fresh(dev)
    other = (1800, 1100, 1900, 1500, 1700)
    other_mats = make_chain_inputs(other, seed=25, device=dev)
    base = torch.cuda.memory_reserved(dev)
    build_and_run(dims, mats)
    build_and_run(other, other_mats)
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(dev) > base  # the free list holds the pools
    graphs.release_pools()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(dev) == base


@pytest.mark.cuda
def test_each_hand_kernel_in_a_capture_counts_once_a_replay():
    """Flash attention (both dtypes), the SSD scan and the GEMM launched
    inside ``graphs.capture``: each replay counts one launch, under its
    key, and gives the eager launch's output bit for bit."""
    dev = needs_card()
    gen = torch.Generator(device=dev).manual_seed(32)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash(dtype):
        q, kv = randn(1, 256, 4, 64, dtype=dtype), randn(1, 256, 2, 64, dtype=dtype)
        return lambda: fmod.flash_attention_kernel(q, kv, kv)

    bc = randn(1, 256, 2, 64)
    xbar, logda = randn(1, 256, 4, 64), -randn(1, 256, 4).abs()
    a, b = randn(256, 128), randn(128, 192)  # rows on 16-byte boundaries: copy mode 16
    cases = [(fmod, "float32", flash(torch.float32)), (fmod, "bfloat16", flash(torch.bfloat16)),
             (smod, "scan", lambda: smod.ssd_scan_kernel(xbar, logda, bc, bc, chunk=64)),
             (kmod, 16, lambda: kmod.matmul_kernel(a, b))]
    for mod, key, fn in cases:
        eager = fn()
        replay = graphs.capture(fn, dev)
        mod.KERNEL.reset()
        for _ in range(3):
            out = replay()
        assert (mod.KERNEL.launches, mod.KERNEL.launches_by[key]) == (3, 3), (mod.__name__, key)
        assert torch.equal(out, eager), (mod.__name__, key)
