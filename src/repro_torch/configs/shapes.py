"""Assigned input shapes and the (architecture x shape) cell grid.

LM transformer shapes are seq_len x global_batch. ``decode_*``/``long_*``
lower ``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``. ``long_500k`` requires sub-quadratic sequence mixing and is
skipped for pure full-attention archs (recorded per-arch below and in
DESIGN.md §4).

This module also owns the repo's ONE shape-bucketing rule
(:func:`shape_bucket` / :func:`bucket_bounds`): log-spaced instance-size
buckets shared by the census report tables
(:func:`repro_torch.core.sweep.size_bucket` delegates here) and the
serving oracle's cache keys (:mod:`repro_torch.serve.cache`), so "which
bucket does size n fall in" has exactly one answer everywhere. A copy of the reference's
``repro.configs.shapes``, with :data:`ARCH_SKIPS` for the port's own archs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: Archs for which long_500k runs (sub-quadratic or windowed sequence mixing
#: at 500k). All others skip it with the reason recorded here.
LONG_CONTEXT_ARCHS = ("gemma2-27b", "jamba-v0.1-52b", "mamba2-1.3b")

SKIPS: Dict[Tuple[str, str], str] = {
    ("qwen2-moe-a2.7b", "long_500k"): "pure full attention: 500k dense KV prefill is quadratic",
    ("granite-moe-3b-a800m", "long_500k"): "pure full attention: 500k dense KV prefill is quadratic",
    ("command-r-plus-104b", "long_500k"): "pure full attention: 500k dense KV prefill is quadratic",
    ("qwen3-14b", "long_500k"): "pure full attention: 500k dense KV prefill is quadratic",
    ("granite-8b", "long_500k"): "pure full attention: 500k dense KV prefill is quadratic",
    ("llava-next-mistral-7b", "long_500k"): "mistral SWA backbone, but vision-prefill → 500k decode cell is out of the VLM serving envelope; skipped with the full-attention group",
    ("whisper-tiny", "long_500k"): "enc-dec with 1500-frame encoder context; 500k decode undefined",
}

#: Archs of the port's own (none in the reference) whose sharding plans are
#: not written yet: every shape of theirs, named or given as
#: kind:seq_len:batch, is skipped with this reason.
ARCH_SKIPS: Dict[str, str] = {
    "deepseek-v2-lite": "latent attention has no sharding plan yet: its latent cache, absorbed "
                        "and decompressed attention run on one device only",
    "kimi-linear-48b-a3b": "Kimi Delta Attention has no sharding plan yet: its recurrent and "
                           "convolution states, and the latent cache beside them, run on one "
                           "device only",
}
SKIPS.update({(arch, shape): reason for arch, reason in ARCH_SKIPS.items() for shape in SHAPES})


def cells(arch_names: List[str]) -> List[Tuple[str, str, Optional[str]]]:
    """All (arch, shape, skip_reason) cells — 40 total for 10 archs."""
    out = []
    for arch in arch_names:
        for shape in SHAPES:
            out.append((arch, shape, SKIPS.get((arch, shape))))
    return out


# ------------------------------------------------------------ size buckets ---


def _octave_boundaries(lo: int, per_octave: int) -> List[int]:
    """Integer bucket boundaries partitioning the octave ``[lo, 2*lo)``:
    ``per_octave + 1`` geometrically spaced values from ``lo`` to ``2*lo``
    inclusive, deduplicated (tiny octaves collapse sub-buckets rather than
    emit empty ones). Pure integer/float arithmetic on fixed inputs —
    deterministic across runs and platforms."""
    bounds = [lo]
    for j in range(1, per_octave):
        b = int(round(lo * 2.0 ** (j / per_octave)))
        if b > bounds[-1]:
            bounds.append(b)
    bounds.append(2 * lo)
    return bounds


def bucket_bounds(size: int, per_octave: int = 1) -> Tuple[int, int]:
    """The log-spaced bucket ``[lo, hi)`` containing ``size`` (>= 1).

    ``per_octave`` sub-buckets per power-of-two octave; the octave itself
    is found by exact integer doubling, so ``per_octave=1`` reproduces the
    census's historical power-of-two buckets bit-for-bit. Every boundary
    is the ``lo`` of exactly one bucket and the ``hi`` of its neighbour —
    buckets partition ``[1, inf)`` with no gaps or overlaps."""
    size = int(size)
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    if per_octave < 1:
        raise ValueError(f"per_octave must be >= 1, got {per_octave}")
    octave = 1
    while octave * 2 <= size:
        octave *= 2
    if per_octave == 1:
        return octave, octave * 2
    bounds = _octave_boundaries(octave, per_octave)
    for lo, hi in zip(bounds, bounds[1:]):
        if lo <= size < hi:
            return lo, hi
    raise AssertionError(  # pragma: no cover — the octave contains size
        f"size {size} escaped its octave [{octave}, {2 * octave})"
    )


def shape_bucket(size: int, per_octave: int = 1) -> str:
    """The bucket label ``"[lo, hi)"`` for ``size`` — the exact string the
    census report tables group by and the oracle cache keys embed."""
    lo, hi = bucket_bounds(size, per_octave)
    return f"[{lo}, {hi})"
