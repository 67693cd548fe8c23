"""llava-next-mistral-7b — [vlm] mistral-7b backbone: 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000, sliding window 4096; anyres tiling vision
frontend is a STUB (``input_specs`` provides precomputed patch embeddings
spliced into the token-embedding sequence).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified-tier]
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.frontend import VisionStubSpec

FULL = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    activation="swiglu",
    frontend="vision_stub",
    tie_embeddings=False,
)

VISION = VisionStubSpec(patches_per_tile=576, max_tiles=5)

SMOKE = FULL.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    sliding_window=16,
    dtype="float32",
    param_dtype="float32",
)
