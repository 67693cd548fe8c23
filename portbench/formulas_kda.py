"""The yardstick's arithmetic for Kimi Delta Attention: frozen FLOP and
byte formulas of the chunked core at chunk length C, in the names of the
``kda_chunk`` site's variants (``chunk_<C>``).

Per chunk and head, every product of the chunked algorithm at leading
order (elementwise scalings left out), the masked parts counted where they
are computed: the pairs below the diagonal sub-blocks of 16 (for A and P),
2 · 2 · d_k · C · (C − 16); the diagonal sub-blocks whole, 2 · 2 · C · 16 · d_k;
the UT transform's triangular solve, C² (d_k + d_v); the state pass,
U = U' − W S and the state's update, 2 · 2 · C · d_k · d_v; the output from
the incoming state and P U (P's zero half included), 2 · C · d_k · d_v +
2 · C² · d_v. A sequence is padded to whole chunks.
"""

from __future__ import annotations

from typing import Dict, Mapping

from .formulas import PEAK_HBM_BYTES_PER_S, PEAK_TF32_FLOPS

SUB = 16


def widths(config: Mapping) -> Dict[str, int]:
    """h, d_k, d_v of the KDA layers from a configuration file's published keys."""
    lin = config["linear_attn_config"]
    return {"h": int(lin["num_heads"]), "dk": int(lin["head_dim"]), "dv": int(lin["head_dim"])}


def kda_flops(b: int, s: int, h: int, dk: int, dv: int, chunk: int) -> float:
    n = -(-s // chunk)
    per_chunk = 3 * chunk * chunk * (dk + dv) + 2 * chunk * SUB * dk + 6 * chunk * dk * dv
    return float(b * n * h * per_chunk)


def kda_bytes(b: int, s: int, h: int, dk: int, dv: int, itemsize: int = 4) -> int:
    """The function's bytes, the same for every chunk length: q, k, v and g
    in, β in, the state in and out, the output out."""
    tokens = b * s * h
    return (tokens * (3 * dk + dv) + tokens + 2 * b * h * dk * dv + tokens * dv) * itemsize


def kda_bound_s(flops: float, nbytes: int) -> float:
    """Least time the chip could take for one call."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
