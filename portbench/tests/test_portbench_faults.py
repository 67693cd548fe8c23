"""``correct`` comes out false for the control (the reference computed in
TF32 in the program's place) and for each fault a cell can have, planted in
the timed path underneath a run driven as on the chip."""

import dataclasses
import importlib

import pytest

CELLS = ["chain-census", "gemm-chain-rank", "ssd-chunk-rank"]


def alter_answer(out):
    out = out.clone()
    out[(0,) * out.dim()] += 1.0
    return out


def drop_half(out):
    """Half of the batch left out: its rows (or, for one row, its tokens) zero."""
    out = out.clone()
    if out.shape[0] > 1:
        out[out.shape[0] // 2:] = 0.0
    else:
        out[:, out.shape[1] // 2:] = 0.0
    return out


def answer_fault_target(cell, change):
    """(module, attribute, faulty replacement) that alters every answer of
    ``cell``'s timed path where it is produced."""
    if cell == "ssd-chunk-rank":
        import repro_torch.autotune.variants as variants

        real = variants.ssd_chunked
        return variants, "ssd_chunked", lambda *a, **k: (change(real(*a, **k)[0]),) + real(*a, **k)[1:]
    import repro_torch.expressions.algorithms as algorithms

    real = algorithms.execute_steps
    return algorithms, "execute_steps", lambda *a: change(real(*a))


def plant(monkeypatch, cell, fault):
    """Break the timed path of ``cell`` underneath the harness."""
    if fault == "verdict":
        module = {"chain-census": "repro_torch.core.sweep",
                  "gemm-chain-rank": "repro_torch.core",
                  "ssd-chunk-rank": "repro_torch.autotune.tuner"}[cell]
        mod = importlib.import_module(module)
        real = mod.flops_discriminant_test

        def flipped(*args, **kwargs):
            report = real(*args, **kwargs)
            return dataclasses.replace(report, is_anomaly=not report.is_anomaly)

        monkeypatch.setattr(mod, "flops_discriminant_test", flipped)
        return
    monkeypatch.setattr(*answer_fault_target(cell, alter_answer if fault == "answer" else drop_half))


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(run_small, cell):
    result = run_small(cell, control=True)
    assert not result["correct"]
    err = "y_err" if cell == "ssd-chunk-rank" else "product_err"
    assert result["checks"][err]["value"] > result["checks"][err]["limit"]


@pytest.mark.parametrize("fault", ["answer", "half", "verdict"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(monkeypatch, run_small, cell, fault):
    plant(monkeypatch, cell, fault)
    result = run_small(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_fault_only_inside_the_window_is_not_correct(monkeypatch, run_small, cell):
    """Answers altered only while the window's units run, sound before and
    after it: the check judges what the window timed, not a rebuild."""
    from portbench.harness import load_module

    from .conftest import load_small

    driver = load_module("drivers", load_small(cell)[2]["driver"]).Driver
    module, name, faulty = answer_fault_target(cell, alter_answer)
    real_unit = driver.unit

    def unit(self):
        sound = getattr(module, name)
        setattr(module, name, faulty)
        try:
            return real_unit(self)
        finally:
            setattr(module, name, sound)

    monkeypatch.setattr(driver, "unit", unit)
    result = run_small(cell)
    assert not result["correct"], result["checks"]
