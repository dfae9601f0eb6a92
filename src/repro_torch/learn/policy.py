"""Learned admission/eviction scoring in int32 fixed point.

Counterpart of ``repro/learn/policy.py``. A tiny model over per-way
features replaces the LRU victim rule:

  recency  — clock - stamp (requests since last touch)
  freq     — accesses while resident
  assoc    — MITHRIL association count at insert time (0 without MITHRIL)
  pf_flag  — unused-prefetch indicator

scored per way, higher = more worth keeping; ``cache/base._insert_rows``
evicts the minimum-score way. ``logreg`` is one linear layer, ``mlp``
one ReLU hidden layer.

Arithmetic contract: scoring is int32 fixed point END TO END — features
are integers in Q16, weights are quantized to Q8 (clipped to |w| <= 8),
and the model is applied with a fixed unrolled accumulation order using
only integer +, *, >> and ``maximum``, so it is bit for bit the
reference's on every device. The ``>>`` here is the reference's
arithmetic int32 shift (its operand is >= 0 after the ReLU).

The default weights are the reference's checked-in constants.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# power-of-two caps => cap-clip + shift-to-Q16 are exact integer ops
RECENCY_CAP = 65536
FREQ_CAP = 256
ASSOC_CAP = 64

N_FEATURES = 4
HIDDEN = 8

# fixed-point formats. Features are Q16 in [0, 2^16]; weights Q8 with
# |w| <= W_CLIP (so w_q <= 2^11); a product is Q24 <= 2^27 and a
# 4-term dot plus bias stays < 2^30. The MLP hidden value (Q24, >= 0
# after ReLU) is downshifted to Q10 before the Q8 second layer, so the
# 8-term output sum stays < 2^30 as well — no int32 overflow anywhere.
FEAT_SHIFT = 16
W_SHIFT = 8
W_CLIP = 8.0
H_SHIFT = 14

# (w_recency, w_freq, w_assoc, w_pf_flag, bias) — trained by the
# reference's ``learn/train.py --scale quick`` (seed 0, 400 AdamW steps
# on reuse-within-horizon labels); see DESIGN.md §12.
DEFAULT_LOGREG: Tuple[float, ...] = (
    -1.1381481885910034, 7.492378234863281, 8.387887954711914,
    -0.05348353460431099, -0.11491527408361435,
)

# ((W1 rows) x HIDDEN, (b1) x HIDDEN, (w2) x HIDDEN, b2) — same protocol.
DEFAULT_MLP: Tuple = (
    ((-6.203922748565674, 2.6507558822631836, 1.4115256071090698,
      0.3110857307910919),
     (-0.8995513319969177, -7.032577037811279, -7.945453643798828,
      0.4709131717681885),
     (-6.626741886138916, 2.5318052768707275, 2.6264774799346924,
      0.8765924572944641),
     (-6.124184608459473, 1.9351627826690674, 2.27750825881958,
      -0.3775727152824402),
     (-0.4594772458076477, -2.2915468215942383, -3.8599119186401367,
      -0.5023788809776306),
     (0.2675999402999878, 5.604794979095459, 6.563817024230957,
      0.09154906123876572),
     (-5.936407089233398, 1.142720103263855, 2.2753679752349854,
      0.30979418754577637),
     (-0.32513299584388733, -0.9545162320137024, -0.1909407079219818,
      0.3603300452232361)),
    (0.42236050963401794, 0.8091490864753723, 0.44413378834724426,
     0.4178300201892853, 0.6613292694091797, -0.3966968059539795,
     0.413311630487442, -0.5836288928985596),
    (2.7321231365203857, -2.860799789428711, 2.5785255432128906,
     2.7946181297302246, -1.6041102409362793, -3.742579936981201,
     3.1020960807800293, -0.18957392871379852),
    -0.9243564605712891,
)


@dataclasses.dataclass(frozen=True)
class LearnedConfig:
    """Frozen, hashable learned-policy parameters.

    ``kind`` selects the model; ``weights`` is a flat 5-tuple for
    ``logreg`` and the ``(W1, b1, w2, b2)`` nested tuple for ``mlp``.
    Tuples (not arrays) keep the enclosing ``SimConfig`` usable as a
    dict / ``lru_cache`` key.
    """
    kind: str = "logreg"                       # logreg | mlp
    weights: Tuple = DEFAULT_LOGREG

    def __post_init__(self) -> None:
        if self.kind not in ("logreg", "mlp"):
            raise ValueError(f"bad learned-policy kind: {self.kind}")
        if self.kind == "logreg":
            if len(self.weights) != N_FEATURES + 1:
                raise ValueError(
                    f"logreg wants {N_FEATURES + 1} weights, "
                    f"got {len(self.weights)}")
        else:
            w1, b1, w2, b2 = self.weights
            if (len(w1) != len(b1) or len(w1) != len(w2)
                    or any(len(row) != N_FEATURES for row in w1)):
                raise ValueError("inconsistent mlp weight shapes")
            float(b2)   # must be a scalar

    @property
    def hidden(self) -> int:
        return 0 if self.kind == "logreg" else len(self.weights[0])


def quantize(w: float) -> int:
    """A float weight as a Q8 integer, clipped to ``|w| <= W_CLIP``.

    Applied at trace/build time (weights are static Python floats), so
    the request path only ever sees the integer.
    """
    return int(round(max(-W_CLIP, min(W_CLIP, float(w))) * (1 << W_SHIFT)))


def features(recency, freq, assoc, pf_flag):
    """Per-way Q16 feature tensors: cap-clip then an exact power-of-two
    rescale to the shared Q16 scale (int32 in [0, 2^16])."""
    rec = recency.clamp(0, RECENCY_CAP) * ((1 << FEAT_SHIFT) // RECENCY_CAP)
    fr = freq.clamp(0, FREQ_CAP) * ((1 << FEAT_SHIFT) // FREQ_CAP)
    ac = assoc.clamp(0, ASSOC_CAP) * ((1 << FEAT_SHIFT) // ASSOC_CAP)
    pf = pf_flag * (1 << FEAT_SHIFT)
    return rec, fr, ac, pf


def score_rows(cfg: LearnedConfig, recency, freq, assoc, pf_flag):
    """Keep-scores for the ways of a bucket — higher keeps, argmin evicts.

    int32 fixed point with the reference's fixed accumulation order
    (feature 0..3, hidden 0..H-1). Returns int32 of the input's shape.
    """
    f = features(recency, freq, assoc, pf_flag)
    if cfg.kind == "logreg":
        *w, b = cfg.weights
        s = torch.full_like(f[0], quantize(b) << FEAT_SHIFT)
        for wi, fi in zip(w, f):
            s = s + quantize(wi) * fi
        return s
    w1, b1, w2, b2 = cfg.weights
    s = torch.full_like(f[0], quantize(b2) << (FEAT_SHIFT - H_SHIFT
                                               + W_SHIFT))
    for j in range(len(w1)):
        h = torch.full_like(f[0], quantize(b1[j]) << FEAT_SHIFT)
        for wi, fi in zip(w1[j], f):
            h = h + quantize(wi) * fi
        h = h.clamp(min=0)                         # ReLU
        h = h >> H_SHIFT                           # Q24 -> Q10, h >= 0
        s = s + quantize(w2[j]) * h
    return s


def make_scorer(cfg: LearnedConfig):
    """Closure in the shape ``cache/base._insert_rows`` expects."""
    def scorer(recency, freq, assoc, pf_flag):
        return score_rows(cfg, recency, freq, assoc, pf_flag)
    return scorer


def params_to_weights(kind: str, params) -> Tuple:
    """Trained head parameters (``models/policy_head.py``: a dict of
    tensors or arrays) -> the config tuples, laid out as the
    reference's."""
    import numpy as np

    def f32(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    if kind == "logreg":
        w, b = f32(params["w"]), f32(params["b"])
        return tuple(float(v) for v in w) + (float(b),)
    w1, b1 = f32(params["w1"]), f32(params["b1"])
    w2, b2 = f32(params["w2"]), f32(params["b2"])
    return (tuple(tuple(float(v) for v in w1[:, j])
                  for j in range(w1.shape[1])),
            tuple(float(v) for v in b1),
            tuple(float(v) for v in w2),
            float(b2))
