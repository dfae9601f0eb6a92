"""The learned & adaptive lane.

``policy`` — the int32 fixed-point learned eviction scorer that plugs
into ``cache/base``; imported eagerly (no dependency on the cache layer,
so ``cache.simulator`` can import it without a cycle). ``adapt`` (the
online MITHRIL search) and ``train`` (the policy heads' training) depend
on the cache/sweep stack and the optimizer, and load lazily, so
``import repro_torch.learn`` stays light.
"""

from .policy import (DEFAULT_LOGREG, DEFAULT_MLP, LearnedConfig, features,
                     make_scorer, params_to_weights, score_rows)

_LAZY = {
    "SearchGrid": "adapt", "AdaptResult": "adapt", "hill_climb": "adapt",
    "bandit": "adapt", "arm_label": "adapt",
    "extract_features": "train", "train_configs": "train",
    "train_head": "train", "train_heads": "train",
}

__all__ = ["DEFAULT_LOGREG", "DEFAULT_MLP", "LearnedConfig", "features",
           "make_scorer", "params_to_weights", "score_rows", *sorted(_LAZY)]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
