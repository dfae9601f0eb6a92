"""The training data pipeline (``pipeline``)."""

from .pipeline import DataConfig, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline"]
