"""Learned eviction scoring (int32 fixed point)."""

from .policy import LearnedConfig, make_scorer, score_rows

__all__ = ["LearnedConfig", "make_scorer", "score_rows"]
