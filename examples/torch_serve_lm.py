"""Serving example on the PyTorch port: prefill + batched token-by-token
decode with KV caches.

Initialises a smoke-scale model (seed-0 weights), prefills a batch of
prompts and generates continuations, demonstrating the cache layouts the
decode_32k / long_500k dry-run cells exercise at cluster scale. On the card
the engine replays its prefill and decode steps as CUDA graphs; ``--device
cpu`` runs them eagerly.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch granite-8b --tokens 32 [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import block, resolve_device
from repro_torch.models import init_lm_params
from repro_torch.serve import ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=True)
    if cfg.is_encoder_decoder:
        raise SystemExit("use whisper-style driving for enc-dec; pick an LM arch")
    dev = resolve_device(args.device)
    params, _ = init_lm_params(cfg, seed=0, device=dev)

    engine = ServingEngine(
        cfg, params,
        max_len=args.prompt_len + args.tokens + 8,
        temperature=args.temperature,
        device=dev,
    )
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen)
    t0 = time.time()
    out = engine.generate(prompts, n_new=args.tokens)
    block(out)
    dt = time.time() - t0
    print(f"arch={args.arch} (smoke config) batch={args.batch} on {dev}")
    print(f"generated {args.tokens} tokens/seq in {dt:.2f}s "
          f"({args.batch*args.tokens/dt:.1f} tok/s)")
    for row in range(min(2, args.batch)):
        print(f"  seq{row}: {out[row, args.prompt_len:].tolist()[:16]} ...")


if __name__ == "__main__":
    main()
