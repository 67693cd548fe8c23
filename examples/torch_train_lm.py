"""End-to-end training driver on the PyTorch port: synthetic data ->
sharded train loop -> checkpoints -> resume.

Default trains a ~100M-param llama-style model for a few hundred steps
through the sharding plan on the host's mesh (``launch.mesh.make_host_mesh``:
a world of one here, the ranks of ``torchrun`` when started under it):
params, optimizer state and batches are DTensors laid out by
``make_plan``/``tree_shardings``/``batch_spec``, on ``--device`` (``cuda`` by
default, ``cpu`` on request):

    PYTHONPATH=src python examples/torch_train_lm.py                  # ~100M
    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 40 [--device cpu]
    PYTHONPATH=src python examples/torch_train_lm.py --resume         # from ckpt

Loss decreases on the structured synthetic stream (copy-chain signal).
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed import NamedSharding, batch_spec, make_plan, shard_tensor, shard_tree, tree_shardings
from repro_torch.launch.compat import destroy_process_group, implicit_replication
from repro_torch.launch.mesh import describe, make_host_mesh
from repro_torch.models import ForwardOptions, ModelConfig, init_lm_params
from repro_torch.models.flops import param_counts
from repro_torch.train import AdamW, AdamWState, TrainState, cosine_schedule, init_train_state, make_train_step

PRESETS = {
    # ~100M params: 12L x 768 with a 32k vocab (GPT-2-small-ish)
    "100m": ModelConfig(
        name="train-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=2048, vocab_size=32768, dtype="float32", param_dtype="float32",
    ),
    "10m": ModelConfig(
        name="train-10m", n_layers=6, d_model=256, n_heads=8, n_kv_heads=4,
        d_ff=704, vocab_size=8192, dtype="float32", param_dtype="float32",
    ),
    "tiny": ModelConfig(
        name="train-tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=352, vocab_size=1024, dtype="float32", param_dtype="float32",
    ),
}


def _value(v) -> float:
    return float(v.full_tensor() if hasattr(v, "full_tensor") else v)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="100m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    mesh = make_host_mesh(device_type=dev.type)
    print(f"mesh: {describe(mesh)} on {dev}")
    try:
        pc = param_counts(cfg)
        print(f"model {cfg.name}: {pc.total/1e6:.1f}M params")

        data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        ))
        optimizer = AdamW(schedule=cosine_schedule(args.lr, 20, args.steps))
        opts = ForwardOptions(attn_impl="reference")
        step_fn = make_train_step(cfg, optimizer, opts)

        plan = make_plan(cfg, mesh, mode="train")
        meta, axes = init_lm_params(cfg, device="meta")
        psh = tree_shardings(plan, axes, meta)
        state_sh = TrainState(params=psh, opt=AdamWState(step=None, master=psh, mu=psh, nu=psh))

        ckpt = CheckpointManager(args.ckpt_dir, keep=3)
        start_step, restored = 0, None
        if args.resume:
            restored = ckpt.restore_latest(init_train_state(cfg, optimizer, meta), shardings=state_sh)
        if restored is not None:
            state, last_step, extra = restored
            start_step = int(extra.get("next_step", last_step + 1))
            print(f"resumed from step {last_step}")
        else:
            params, _ = init_lm_params(cfg, seed=0, device=dev)
            state = init_train_state(cfg, optimizer, shard_tree(params, psh))
            del params

        bsh = NamedSharding(mesh, batch_spec(mesh, args.batch, 1))
        t0 = time.time()
        with implicit_replication():
            for step in range(start_step, args.steps):
                batch = {k: shard_tensor(torch.as_tensor(v, device=dev), bsh)
                         for k, v in data.batch(step).items()}
                state, metrics = step_fn(state, batch)
                if step % args.log_every == 0 or step == args.steps - 1:
                    toks = args.batch * args.seq
                    loss, nll, gnorm = (_value(metrics[k]) for k in ("loss", "nll", "grad_norm"))
                    dt = time.time() - t0
                    print(
                        f"step {step:4d}  loss={loss:.4f} "
                        f"nll={nll:.4f} "
                        f"gnorm={gnorm:.2f} "
                        f"({toks*(step-start_step+1)/max(dt,1e-9)/1e3:.1f}k tok/s)"
                    )
                if (step + 1) % args.ckpt_every == 0:
                    ckpt.save(step, state, extra={"next_step": step + 1})
        ckpt.save(args.steps - 1, state, extra={"next_step": args.steps})
        print("done; checkpoint in", args.ckpt_dir)
    finally:
        destroy_process_group()


if __name__ == "__main__":
    main()
