"""Training launcher (the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --smoke \\
        --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/repro_ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 --simulate-failure 2:1

Wires the stack: arch registry -> elastic trainer (checkpoint/auto-resume,
membership events) -> deterministic data pipeline, on ``--device``
(``cuda`` unless asked otherwise; a missing GPU is refused). The arch's SMOKE
config, its weights drawn from seed 0. ``--simulate-failure
STEP:NEW_HOSTS`` exercises the elastic re-mesh path mid-run: hosts are
simulated data-parallel groups over the one device. A checkpoint directory
that already holds checkpoints is resumed from.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

from ..checkpoint import CheckpointManager
from ..configs import ARCH_NAMES, get_config
from ..data import DataConfig, SyntheticLM
from ..device import resolve_device
from ..models import ForwardOptions, init_lm_params
from ..train.elastic import ElasticConfig, ElasticTrainer, HostMesh
from ..train.optimizer import AdamW, cosine_schedule


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

    trainer = ElasticTrainer(
        cfg=cfg,
        optimizer=optimizer,
        data=data,
        ckpt=ckpt,
        make_mesh_fn=HostMesh,   # n_hosts -> data width; model width 1
        opts=ForwardOptions(attn_impl="reference"),
        elastic_cfg=ElasticConfig(checkpoint_every=args.ckpt_every),
        device=dev,
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
    for h in history[:: max(len(history) // 10, 1)]:
        print(f"step {h['step']:4d} loss={h['loss']:.4f} nll={h['nll']:.4f}")
    print(f"final loss={history[-1]['loss']:.4f} on {dev} (data width {trainer.mesh.shape['data']}); "
          f"checkpoints in {args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
