"""repro_torch.data — deterministic shard-aware synthetic pipeline."""

from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
