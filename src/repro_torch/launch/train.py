"""Training launcher (the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --smoke \\
        --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/repro_ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 --simulate-failure 2:1
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --steps 6 --simulate-failure 3:2

Wires the stack: arch registry -> sharding plan over the processes' mesh ->
elastic trainer (checkpoint/auto-resume, membership events) ->
deterministic data pipeline, on ``--device`` (``cuda`` unless asked
otherwise; a missing GPU is refused). The arch's SMOKE config, its weights
drawn from seed 0.

Under ``torchrun`` (``python -m torch.distributed.run``) the rank, the
world size and the rendezvous come from its environment; run alone, the
launcher is a world of one. The group runs on ``nccl`` on the card and
``gloo`` with ``--device cpu``, one process a device. As the reference's
launcher splits its devices, ``n_hosts`` hosts make a ``(dp, world // dp)``
mesh of axes (data, model), ``dp = max(min(n_hosts, world), 1)``; the run
starts on one host. ``--simulate-failure STEP:NEW_HOSTS`` re-meshes before
STEP: the group is re-formed over the ranks the new mesh holds, the others
leave, and the checkpoint is restored onto the new mesh. A checkpoint
directory that already holds checkpoints is resumed from.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCH_NAMES, get_config
from ..data import DataConfig, SyntheticLM
from ..device import resolve_device
from ..models import ForwardOptions, init_lm_params
from ..train.elastic import ElasticConfig, ElasticTrainer
from ..train.optimizer import AdamW, cosine_schedule
from .compat import ElasticGroup, make_mesh, mesh_axis_sizes


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument(
        "--simulate-failure", default=None,
        help="STEP:NEW_HOSTS — elastic re-mesh before STEP",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    if cfg.is_encoder_decoder:
        raise SystemExit("training launcher drives LM archs; whisper uses "
                         "the encdec loss path in tests")
    dev = resolve_device(args.device)

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
    ))
    optimizer = AdamW(schedule=cosine_schedule(args.lr, 10, args.steps))
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)

    under_torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if under_torchrun and dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    group = ElasticGroup("nccl" if dev.type == "cuda" else "gloo",
                         init_method="env://" if under_torchrun else None)
    world = group.world_size

    def hosts_dp(n_hosts: int) -> int:
        return max(min(n_hosts, world), 1)

    try:
        trainer = ElasticTrainer(
            cfg=cfg,
            optimizer=optimizer,
            data=data,
            ckpt=ckpt,
            make_mesh_fn=lambda n: make_mesh((hosts_dp(n), world // hosts_dp(n)), ("data", "model"), dev.type),
            opts=ForwardOptions(attn_impl="reference"),
            elastic_cfg=ElasticConfig(checkpoint_every=args.ckpt_every),
            device=dev,
            group=group,
            mesh_size_fn=lambda n: hosts_dp(n) * (world // hosts_dp(n)),
        )
        trainer.start(
            n_hosts=1,
            init_params_fn=lambda: init_lm_params(cfg, seed=0, device=dev)[0],
        )

        events = {}
        if args.simulate_failure:
            step_s, hosts_s = args.simulate_failure.split(":")
            events[int(step_s)] = int(hosts_s)

        history = trainer.run(args.steps, membership_events=events)
        if trainer.left:
            print(f"rank {group.rank} left the group before step {trainer.step} "
                  f"after {len(history)} steps")
            return 0
        if group.rank == 0:
            for h in history[:: max(len(history) // 10, 1)]:
                print(f"step {h['step']:4d} loss={h['loss']:.4f} nll={h['nll']:.4f}")
            for r in trainer.recoveries:
                print(f"re-mesh before step {r['step']}: save {r['save_s']:.2f} s, "
                      f"re-form {r['reform_s']:.2f} s, restore {r['restore_s']:.2f} s")
            print(f"final loss={history[-1]['loss']:.4f} on {dev} "
                  f"(data width {mesh_axis_sizes(trainer.mesh)['data']}) over {group.world_size} of {world} ranks; "
                  f"checkpoints in {args.ckpt_dir}")
    finally:
        group.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
