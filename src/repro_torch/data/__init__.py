"""Synthetic LM data: a copy of `repro/data/pipeline.py` (numpy only)."""

from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_batch

__all__ = ["DataConfig", "SyntheticLM", "make_batch"]
