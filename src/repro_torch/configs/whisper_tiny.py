"""whisper-tiny — [audio] enc-dec, 4L encoder + 4L decoder, d_model=384 6H
(kv=6) d_ff=1536 vocab=51865; the conv frontend is a STUB (``input_specs``
provides precomputed frame embeddings [b, 1500, 384]).
[arXiv:2212.04356; unverified-tier]

Backbone-only notes: the original decoder uses learned positional
embeddings and a 448-token context; this stub backbone uses RoPE in the
decoder so the assigned 4k/32k shape cells are well-defined (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.frontend import AudioStubSpec

FULL = ModelConfig(
    name="whisper-tiny",
    family="audio",
    is_encoder_decoder=True,
    n_layers=4,
    n_encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    norm_type="layernorm",
    norm_eps=1e-5,
    activation="gelu",
    frontend="audio_stub",
    tie_embeddings=True,
)

AUDIO = AudioStubSpec(n_frames=1500)

SMOKE = FULL.replace(
    n_layers=2,
    n_encoder_layers=2,
    encoder_seq=32,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
    param_dtype="float32",
)
