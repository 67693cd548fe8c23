"""Serving engine: prefill + batched decode with KV-cache management (the
reference's ``serve/engine.py``).

``make_serve_step``/``make_prefill`` build the step functions in the
reference's functional form (a new state each call); the tests and the
encoder-decoder use them, and the encoder-decoder step runs eagerly.
``ServingEngine`` drives token-by-token generation of a decoder LM (the
reference's engine is LM-only as well) with greedy or temperature sampling
on one device.

The reference jits its two steps. On the card the engine runs their
counterpart: it owns static buffers per batch size (the decode state at
``max_len``, the newest token [b, 1] and the position, a 0-d int64 tensor),
captures the decode step once per batch size and the prefill once per
(batch, prompt length) as CUDA graphs that write into those buffers
(``graphs.capture_async``), and replays them. Each graph ends by writing
the greedy token and the next position on the device, so ``generate``
reads nothing back to the host between steps; sampling at
``temperature > 0`` runs outside the graphs. A capture that fails raises:
nothing falls back to eager launches. On the CPU, or with ``graphs=False``
on the card (the yardstick of the graphs), the same in-place steps run
eagerly, one launch per operation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..graphs import capture_async
from ..models import (
    ForwardOptions,
    ModelConfig,
    encdec_decode_step,
    encdec_prefill,
    init_lm_state,
    lm_decode_inplace,
    lm_decode_step,
    lm_prefill,
    lm_prefill_inplace,
)
from ..models.layers import tree_leaves

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
class Slot:
    """One batch size's static buffers and steps. ``decode()`` and a
    ``prefills[s][1]()`` return the logits [b, vocab] f32 and leave the
    greedy token in ``token`` and the next position in ``position``; a
    prefill reads its prompt from ``prefills[s][0]``."""

    state: Tree
    token: torch.Tensor        # [b, 1] int64
    position: torch.Tensor     # 0-d int64: tokens in the cache
    decode: Callable[[], torch.Tensor]
    prefills: Dict[int, Tuple[torch.Tensor, Callable[[], torch.Tensor]]] = field(default_factory=dict)


@dataclass
class ServingEngine:
    """Token-by-token generation driver on ``device`` (``cuda`` unless the
    caller asks for the CPU; a missing GPU is refused). ``graphs`` is None
    for CUDA graphs on the card and eager steps on the CPU; False runs the
    eager steps on the card; True on the CPU raises. ``last_logits`` holds
    the logits [b, vocab] the last generated token was drawn from."""

    cfg: ModelConfig
    params: Tree
    max_len: int = 256
    opts: ForwardOptions = ForwardOptions()
    temperature: float = 0.0
    device: DeviceLike = "cuda"
    graphs: Optional[bool] = None
    last_logits: Optional[torch.Tensor] = field(default=None, repr=False)
    slots: Dict[int, Slot] = field(default_factory=dict, repr=False, init=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.cfg.is_encoder_decoder:
            raise ValueError(f"{self.cfg.name}: the serving engine generates with decoder LMs only")
        if self.graphs is None:
            self.graphs = self.device.type == "cuda"
        elif self.graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, not {self.device}")

    def _compile(self, body: Callable[[], torch.Tensor]) -> Callable[[], torch.Tensor]:
        return capture_async(body, self.device) if self.graphs else body

    def slot(self, batch: int) -> Slot:
        """The static buffers and the decode step of ``batch`` (captured on
        first use)."""
        if batch in self.slots:
            return self.slots[batch]
        dev = self.device
        state = init_lm_state(self.cfg, batch, self.max_len, dev)
        token = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        position = torch.zeros((), dtype=torch.int64, device=dev)

        def decode() -> torch.Tensor:
            logits = lm_decode_inplace(self.cfg, self.params, state, token, position, opts=self.opts)
            token.copy_(torch.argmax(logits, dim=-1, keepdim=True))
            position.add_(1)
            return logits

        self.slots[batch] = Slot(state, token, position, self._compile(decode))
        return self.slots[batch]

    def prefill(self, slot: Slot, s_prompt: int) -> Tuple[torch.Tensor, Callable[[], torch.Tensor]]:
        """(prompt buffer [b, s_prompt], step) of ``slot`` (captured on
        first use): the state zeroed, then filled from the prompt."""
        if s_prompt in slot.prefills:
            return slot.prefills[s_prompt]
        prompt = torch.zeros((slot.token.shape[0], s_prompt), dtype=torch.int64, device=self.device)

        def prefill() -> torch.Tensor:
            for leaf in tree_leaves(slot.state):
                leaf.zero_()
            logits = lm_prefill_inplace(self.cfg, self.params, slot.state, tokens=prompt, opts=self.opts)
            slot.token.copy_(torch.argmax(logits, dim=-1, keepdim=True))
            slot.position.fill_(s_prompt)
            return logits

        slot.prefills[s_prompt] = (prompt, self._compile(prefill))
        return slot.prefills[s_prompt]

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
        slot = self.slot(b)
        prompt_buf, prefill = self.prefill(slot, s_prompt)
        prompt_buf.copy_(prompt)
        logits = prefill()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = [prompt]
        for t in range(n_new):
            if self.temperature > 0.0:
                probs = torch.softmax(logits / self.temperature, dim=-1)
                slot.token.copy_(torch.multinomial(probs, 1, generator=gen))
            out.append(slot.token.to(prompt.dtype, copy=True))
            if t == n_new - 1:
                break
            logits = slot.decode()
        self.last_logits = logits.clone()  # a graph's output is rewritten by its next replay
        return torch.cat(out, dim=1)
