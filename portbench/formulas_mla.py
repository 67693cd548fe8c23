"""The yardstick's arithmetic for latent attention: frozen FLOP and byte
formulas of one extend step, in the names of the ``mla`` site's variants.

``q`` new tokens against a latent cache of ``L`` positions (the new ones
among them), the full q x L score rectangle counted, the function's work
and not an implementation's. The shared projections: queries (d to
H x (dn + dr)), the latent down-projection (d to r + dr), the output
(H x dv to d). ``decompress`` expands every cached latent into per-head K
(dn) and V (dv), then scores at dn + dr and weights at dv; ``absorb``
folds W_UK into the queries (dn to r per head), scores at r + dr against
the one latent head, weights at r, then applies W_UV (r to dv per head).
The blockwise (``_chunked``) forms compute the same products.
"""

from __future__ import annotations

from typing import Dict, Mapping

from .formulas import PEAK_HBM_BYTES_PER_S, PEAK_TF32_FLOPS

VARIANTS = ("absorb", "absorb_chunked", "decompress", "decompress_chunked")


def widths(config: Mapping) -> Dict[str, int]:
    """d, H, r, dn, dr, dv from a configuration file's published keys."""
    return {"d": int(config["hidden_size"]), "h": int(config["num_attention_heads"]),
            "r": int(config["kv_lora_rank"]), "dn": int(config["qk_nope_head_dim"]),
            "dr": int(config["qk_rope_head_dim"]), "dv": int(config["v_head_dim"])}


def mla_flops(w: Mapping[str, int], q: int, L: int, b: int = 1) -> Dict[str, float]:
    d, h, r, dn, dr, dv = (w[k] for k in ("d", "h", "r", "dn", "dr", "dv"))
    shared = 2.0 * q * d * h * (dn + dr) + 2.0 * q * d * (r + dr) + 2.0 * q * h * dv * d
    decompress = shared + 2.0 * L * r * h * (dn + dv) + 2.0 * q * L * h * (dn + dr) + 2.0 * q * L * h * dv
    absorb = (shared + 2.0 * q * h * dn * r + 2.0 * q * L * h * (r + dr) + 2.0 * q * L * h * r
              + 2.0 * q * h * r * dv)
    return {"absorb": b * absorb, "absorb_chunked": b * absorb,
            "decompress": b * decompress, "decompress_chunked": b * decompress}


def mla_bytes(w: Mapping[str, int], q: int, L: int, b: int = 1, itemsize: int = 4) -> int:
    """The function's bytes, the same for every variant: the latent cache
    read once, the layer's attention weights read once, the hidden states
    in and out."""
    d, h, r, dn, dr, dv = (w[k] for k in ("d", "h", "r", "dn", "dr", "dv"))
    weights = d * h * (dn + dr) + d * (r + dr) + r + r * h * (dn + dv) + h * dv * d
    return (b * L * (r + dr) + weights + 2 * b * q * d) * itemsize


def mla_bound_s(flops: float, nbytes: int) -> float:
    """Least time the chip could take for one call."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
