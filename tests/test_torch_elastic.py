"""The port's elastic trainer and its launcher on the CPU: the reference's
membership-change sequence (``tests/test_system.py``), auto-resume, and the
launcher as a user runs it. On one device a checkpoint restores the same
bits, so a resumed or re-meshed run gives an uninterrupted run's losses
exactly (tolerance 0)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager, all_steps  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ForwardOptions, ModelConfig, init_lm_params  # noqa: E402
from repro_torch.train import AdamW, ElasticConfig, ElasticTrainer, HostMesh, cosine_schedule  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# the reference's system-test config
CFG = ModelConfig(
    name="sys-test", n_layers=4, d_model=64, n_heads=8, n_kv_heads=4,
    d_ff=128, vocab_size=512, dtype="float32", param_dtype="float32",
)


def _trainer(ckpt_dir, checkpoint_every=4):
    return ElasticTrainer(
        cfg=CFG,
        optimizer=AdamW(schedule=cosine_schedule(1e-3, 2, 50)),
        data=SyntheticLM(DataConfig(vocab_size=512, seq_len=32, global_batch=8)),
        ckpt=CheckpointManager(str(ckpt_dir), keep=3),
        make_mesh_fn=lambda n_hosts: HostMesh(data=n_hosts, model=2),
        opts=ForwardOptions(attn_impl="reference"),
        elastic_cfg=ElasticConfig(checkpoint_every=checkpoint_every),
        device="cpu",
    )


def _params():
    return init_lm_params(CFG, seed=0, device="cpu")[0]


def test_elastic_train_survives_membership_change(tmp_path):
    trainer = _trainer(tmp_path / "elastic")
    trainer.start(n_hosts=4, init_params_fn=_params)
    assert trainer.mesh.shape == {"data": 4, "model": 2}
    history = trainer.run(12, membership_events={6: 2})   # lose half the hosts before step 6
    assert [h["step"] for h in history] == list(range(12))
    losses = [h["loss"] for h in history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert trainer.mesh.shape["data"] == 2
    assert all_steps(str(tmp_path / "elastic")) == [5, 7, 11]   # keep 3: 3, 5 (the event), 7, 11

    straight = _trainer(tmp_path / "straight")
    straight.start(n_hosts=4, init_params_fn=_params)
    assert [h["loss"] for h in straight.run(12)] == losses


def test_auto_resume_gives_the_uninterrupted_losses(tmp_path):
    whole = _trainer(tmp_path / "whole")
    whole.start(n_hosts=1, init_params_fn=_params)
    expect = [h["loss"] for h in whole.run(8)]

    first = _trainer(tmp_path / "parts")
    first.start(n_hosts=1, init_params_fn=_params)
    head = [h["loss"] for h in first.run(4)]           # checkpoint after step 3
    resumed = _trainer(tmp_path / "parts")
    resumed.start(n_hosts=2, init_params_fn=lambda: pytest.fail("resume must not draw new params"))
    assert resumed.step == 4 and int(resumed.state.opt.step) == 4
    tail = resumed.run(4)
    assert [h["step"] for h in tail] == [4, 5, 6, 7]
    assert head + [h["loss"] for h in tail] == expect


def test_data_width_must_divide_the_global_batch(tmp_path):
    trainer = _trainer(tmp_path)
    with pytest.raises(ValueError, match="data width"):
        trainer.start(n_hosts=3, init_params_fn=_params)


def test_launcher_runs_on_cpu_with_a_simulated_failure(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "4",
         "--simulate-failure", "2:1", "--ckpt-dir", str(tmp_path / "ckpt")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr[-4000:]
    assert "final loss=" in run.stdout and "on cpu (data width 1)" in run.stdout
    assert all_steps(str(tmp_path / "ckpt")) == [1]


def test_launcher_refuses_cuda_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--device", "cuda", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
