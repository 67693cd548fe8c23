"""Serving engine: prefill + batched decode with KV-cache management (the
reference's ``serve/engine.py``).

``make_serve_step``/``make_prefill`` build the step functions;
``ServingEngine`` drives token-by-token generation with greedy or
temperature sampling on one device. The reference jits its two step
functions; here they run eagerly, one launch per operation (capturing the
decode step as one CUDA graph is later work). A decode step takes the
cache length as a host integer, so it makes no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models import (
    ForwardOptions,
    ModelConfig,
    encdec_decode_step,
    encdec_prefill,
    init_lm_state,
    lm_decode_step,
    lm_prefill,
)

Tree = Any


def make_serve_step(cfg: ModelConfig, opts: ForwardOptions = ForwardOptions()):
    """(params, state, tokens [b,1], cache_len) -> (logits [b,V], state)."""
    if cfg.is_encoder_decoder:
        def step(params, state, tokens, cache_len):
            return encdec_decode_step(cfg, params, state, tokens, cache_len, opts=opts)
        return step

    def step(params, state, tokens, cache_len):
        return lm_decode_step(cfg, params, state, tokens, cache_len, opts=opts)
    return step


def make_prefill(cfg: ModelConfig, opts: ForwardOptions = ForwardOptions()):
    if cfg.is_encoder_decoder:
        def prefill(params, state, enc_embeds):
            return encdec_prefill(cfg, params, state, enc_embeds, opts=opts)
        return prefill

    def prefill(params, state, tokens=None, embeds=None):
        return lm_prefill(cfg, params, state, tokens=tokens, embeds=embeds, opts=opts)
    return prefill


@dataclass
class ServingEngine:
    """Token-by-token generation driver on ``device`` (``cuda`` unless the
    caller asks for the CPU; a missing GPU is refused). ``last_logits``
    holds the logits [b, vocab] the last generated token was drawn from."""

    cfg: ModelConfig
    params: Tree
    max_len: int = 256
    opts: ForwardOptions = ForwardOptions()
    temperature: float = 0.0
    device: DeviceLike = "cuda"
    last_logits: Optional[torch.Tensor] = field(default=None, repr=False)
    _step: Optional[Callable] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self._step = make_serve_step(self.cfg, self.opts)
        self._prefill = make_prefill(self.cfg, self.opts)

    def generate(
        self,
        prompt_tokens: torch.Tensor,       # [b, s_prompt]
        n_new: int,
        seed: int = 0,
    ) -> torch.Tensor:
        """Greedy/temperature generation; returns [b, s_prompt + n_new].

        Sampling at ``temperature > 0`` draws from a ``torch.Generator``
        seeded with ``seed``, so its tokens differ from the reference's
        ``jax.random`` draws by design; greedy tokens are the reference's.
        """
        prompt = torch.as_tensor(prompt_tokens, device=self.device)
        b, s_prompt = prompt.shape
        state = init_lm_state(self.cfg, b, self.max_len, self.device)
        logits, state = self._prefill(self.params, state, prompt)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = [prompt]
        last = self._sample(logits, gen).to(prompt.dtype)
        for t in range(n_new):
            out.append(last)
            if t == n_new - 1:
                break
            logits, state = self._step(self.params, state, last, s_prompt + t)
            last = self._sample(logits, gen).to(prompt.dtype)
        self.last_logits = logits
        return torch.cat(out, dim=1)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)
