"""Serving launcher: batched generation against any registry arch (the
reference's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --tokens 24
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --temperature 0

The arch's SMOKE config, its weights drawn from seed 0 and its prompts from
seed 1 on ``--device`` (``cuda`` unless asked otherwise; a missing GPU is
refused). Two generations: the first pays the device's warm-up (on the
card, the capture of the engine's CUDA graphs), the second is timed as
steady state.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from ..configs import ARCH_NAMES, get_config
from ..device import block, resolve_device
from ..models import init_lm_params
from ..serve.engine import ServingEngine


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description="batched generation against a registry arch (SMOKE config)")
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    if cfg.is_encoder_decoder:
        raise SystemExit("pick an LM arch for the generation launcher")
    dev = resolve_device(args.device)
    params, _ = init_lm_params(cfg, seed=0, device=dev)
    engine = ServingEngine(
        cfg, params,
        max_len=args.prompt_len + args.tokens + 8,
        temperature=args.temperature,
        device=dev,
    )
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen, device=dev)
    # the first call pays the device's warm-up; block before reading the
    # clock so both timings measure execution, not asynchronous launches
    t0 = time.time()
    out = block(engine.generate(prompts, n_new=args.tokens))
    dt_first = time.time() - t0
    t0 = time.time()
    out = block(engine.generate(prompts, n_new=args.tokens))
    dt = time.time() - t0
    print(f"{args.arch} (smoke) on {dev}: {args.batch}x{args.tokens} tokens in "
          f"{dt_first:.2f}s incl. warm-up, then {dt:.2f}s steady-state "
          f"({args.batch * args.tokens / dt:.1f} tok/s)")
    print("sample:", out[0, args.prompt_len:].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
