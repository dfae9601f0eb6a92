"""The cost model: model-level rooflines of a cell's step and per-kernel
rooflines of the MITHRIL launches.

Two halves:

* **Cells.** :func:`analyze_cell` prices a whole training, prefill or
  decode step from ``launch.dryrun.run_cell``, which runs the cell's
  step once on ``meta`` tensors, its parameters DTensors on the
  production mesh over a fake process group, and counts what each
  device does: flops, operand and result bytes, collectives by kind.
  The eager run executes every layer and every attention tile, so none
  of the reference's corrections for loop bodies compiled once (its
  layer-group probes, :func:`attention_extra`, :func:`rwkv_chunk_extra`)
  is added on top; those functions are kept, with the reference's
  arithmetic, for what they compute.
* **Kernels.** :func:`analyze_kernel` prices one launch of the
  reference's four Pallas kernels from its geometry
  (:data:`KERNEL_MODELS`), as the reference prices them: the traffic
  of their copy-through layouts (every table in and out once) and
  integer ops as flops. That is not a least time for the card's
  kernels, which touch only the rows they probe; their bounds, on the
  data of a run, are :mod:`.touched`'s.

Peaks come from :func:`machine_peaks`: an H100 SXM card's published
figures (989 TFLOP/s bf16 dense, 3.35 TB/s) are trusted, the
reference's TPU v5e constants (197 TFLOP/s bf16, 819 GB/s, 50 GB/s a
link) stay under ``"tpu"``, and anything else gets finite nominal peaks
flagged ``trusted=False``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

import torch

from ..configs import SHAPES, get_config
from ..configs.base import ModelConfig
from ..models.attention import block_plan
from ..models.rwkv6 import CHUNK as RWKV_CHUNK

PEAK_FLOPS = 197e12      # TPU v5e: bf16 / chip
HBM_BW = 819e9           # TPU v5e: bytes/s / chip
ICI_BW = 50e9            # TPU v5e: bytes/s / link

# NVIDIA H100 SXM (the data sheet's dense rates at the 700 W limit)
H100_PEAK_FLOPS = 989e12     # bf16 dense
H100_HBM_BW = 3.35e12        # bytes/s
H100_LINK_BW = 450e9         # NVLink 4: 900 GB/s both directions together


# ---------------------------------------------------------------------------
# analytic attention tile accounting (the reference's arithmetic)
# ---------------------------------------------------------------------------

def _attn_tile_counts(sq: int, skv: int, causal: bool, window: int):
    """Total executed kv-tiles across all q blocks (matches the flash
    loop's tile bounds)."""
    bq, bk = block_plan(sq, skv)
    n_q, n_k = sq // bq, skv // bk
    total = 0
    for qi in range(n_q):
        hi = n_k
        lo = 0
        if causal:
            hi = min(((qi + 1) * bq + bk - 1) // bk, n_k)
        if window:
            lo = max((qi * bq - window) // bk, 0)
        total += max(0, hi - lo)
    return total, n_q, bq, bk


def _attn_tile_flops(cfg: ModelConfig, b: int, bq: int, bk: int,
                     train: bool) -> float:
    """FLOPs of ONE kv tile: fwd = 2 matmuls (scores + pv); bwd adds 5."""
    h, hd = cfg.n_heads, cfg.head_dim
    one_mm = 2.0 * b * h * bq * bk * hd
    fwd = 2 * one_mm
    if not train:
        return fwd
    # remat recompute (fwd again) + bwd tiles (dv, dp, ds*k, dk = ~5 mm)
    return fwd + fwd + 5 * one_mm


def attention_extra(cfg: ModelConfig, b: int, sq: int, skv: int,
                    kind: str, n_dev: int) -> float:
    """Analytic flops of the (tiles-1) attention iterations a compiled
    loop body counts once, per device, summed over attention layers."""
    extra = 0.0
    for lk in cfg.pattern:
        if lk not in ("attn", "local"):
            continue
        window = cfg.window if (lk == "local" or cfg.attn_kind == "swa") else 0
        tiles, n_q, bq, bk = _attn_tile_counts(sq, skv, True, window)
        per_tile = _attn_tile_flops(cfg, b, bq, bk, kind == "train")
        extra += (tiles - 1) * per_tile
    if cfg.is_encoder_decoder and kind == "train":
        tiles, n_q, bq, bk = _attn_tile_counts(cfg.encoder_seq,
                                               cfg.encoder_seq, False, 0)
        per = _attn_tile_flops(cfg, b, bq, bk, True)
        extra += cfg.n_encoder_layers * (tiles - 1) * per
        # decoder cross-attention over encoder_seq
        tiles_x, _, bqx, bkx = _attn_tile_counts(sq, cfg.encoder_seq,
                                                 False, 0)
        extra += cfg.n_layers * (tiles_x - 1) * _attn_tile_flops(
            cfg, b, bqx, bkx, True)
    return extra / n_dev


def rwkv_chunk_extra(cfg: ModelConfig, b: int, s: int, kind: str,
                     n_dev: int) -> float:
    """Inter-chunk state-carry scan: (S/CHUNK - 1) iterations a compiled
    loop body counts once."""
    if "rwkv" not in cfg.pattern or s < RWKV_CHUNK:
        return 0.0
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    per_chunk = 3.0 * b * h * hd * hd          # decay*state + add kv
    mult = 4.0 if kind == "train" else 1.0
    n_chunks = s // RWKV_CHUNK
    return cfg.n_layers * (n_chunks - 1) * per_chunk * mult / n_dev


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    """A step's per-device cost against a machine's peaks (default: the
    reference's TPU v5e constants; :func:`analyze_cell` gives the
    card's)."""
    arch: str
    shape: str
    mesh: str
    flops_dev: float
    bytes_dev: float
    coll_dev: float
    n_dev: int
    model_flops: float
    peak_flops: float = PEAK_FLOPS
    peak_bw: float = HBM_BW
    link_bw: float = ICI_BW

    @property
    def compute_s(self) -> float:
        return self.flops_dev / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_dev / self.peak_bw

    @property
    def collective_s(self) -> float:
        return self.coll_dev / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_dev * self.n_dev
        return self.model_flops / total if total else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline-model step time: dominant term (others overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / modeled step time."""
        ideal = self.model_flops / (self.n_dev * self.peak_flops)
        return ideal / self.step_time_s if self.step_time_s else 0.0

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "bottleneck": self.bottleneck,
                "useful_ratio": self.useful_ratio,
                "roofline_fraction": self.roofline_fraction}


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    n_act = cfg.param_count(active_only=True)
    tokens = batch * seq if kind != "decode" else batch
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_act * tokens


def analyze_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                 strategy: str = "fsdp", dryrun_result: Optional[dict] = None
                 ) -> Roofline:
    """The cell's roofline on H100 peaks from a dry run (``dryrun_result``
    or a fresh ``launch.dryrun.run_cell``, which needs a process of its
    own: it starts a fake process group). The counts are the eager
    step's, every layer and tile executed: no correction is added."""
    from ..launch.dryrun import run_cell
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    r = dryrun_result or run_cell(arch, shape_name, multi_pod, strategy,
                                  save=False)
    if not r.get("ok"):
        raise RuntimeError(f"cell not ok: {r}")
    return Roofline(
        arch=arch, shape=shape_name, mesh=r["mesh"],
        flops_dev=r["flops_hlo_once"], bytes_dev=r["bytes_hlo_once"],
        coll_dev=float(sum(r["collective_bytes_once"].values())),
        n_dev=r["n_devices"],
        model_flops=model_flops(cfg, shape.kind, shape.global_batch,
                                shape.seq_len),
        peak_flops=H100_PEAK_FLOPS, peak_bw=H100_HBM_BW,
        link_bw=H100_LINK_BW)


def save_roofline(rl: Roofline, out_dir: str = "results/roofline"):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(
            out_dir, f"{rl.arch}_{rl.shape}_{rl.mesh}.json"), "w") as f:
        json.dump(rl.to_dict(), f, indent=1)


# ---------------------------------------------------------------------------
# per-kernel roofline
# ---------------------------------------------------------------------------
#
# Bytes moved is the copy-through traffic each launch's layout implies
# (every block a launch reads in and writes out: an upper bound for
# in-place kernels — a kernel can touch fewer bytes, never more). Flops
# counts the integer compare/select lattice (int ops as flops).

_NOMINAL_FLOPS = 1e12    # untrusted placeholder peaks for unknown devices
_NOMINAL_BW = 100e9


@dataclasses.dataclass(frozen=True)
class MachinePeaks:
    backend: str
    flops_per_s: float
    bytes_per_s: float
    trusted: bool


def _is_h100_sxm(name: str) -> bool:
    return "H100" in name and "PCIe" not in name


def machine_peaks(device: Union[None, str, torch.device] = None
                  ) -> MachinePeaks:
    """Peak flops and bandwidth of ``device``: None is the live device
    (the card when there is one, else the CPU), ``"tpu"`` the
    reference's TPU v5e, a CUDA device or a card's name (as
    ``torch.cuda.get_device_name`` gives it) an H100 SXM's published
    figures when it is one. Never raises: anything else gets finite
    nominal peaks with ``trusted=False``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    name = str(device)
    if name == "tpu":
        return MachinePeaks("tpu", PEAK_FLOPS, HBM_BW, True)
    if name.startswith("cuda") and torch.cuda.is_available():
        name = torch.cuda.get_device_name(torch.device(name))
    if _is_h100_sxm(name):
        return MachinePeaks(name, H100_PEAK_FLOPS, H100_HBM_BW, True)
    return MachinePeaks(name, _NOMINAL_FLOPS, _NOMINAL_BW, False)


def _record_fused_cost(g: dict):
    """One ``mithril_record_fused`` launch: every lane's record + mining
    tables stream through once in, once out (the copy-through bound),
    plus the scalar lane blocks; compute is the W-way probe, R-slot
    stamp and S-slot insert select lattice."""
    lanes, nb, w = g["lanes"], g["n_buckets"], g["ways"]
    r, nm, s = g["r_sup"], g["mine_rows"], g["s_sup"]
    table_words = nb * w * (5 + r) + nm * (2 + s)
    bytes_ = lanes * (2 * table_words + 6) * 4
    flops = lanes * (16 + 8 * w + 6 * r + 8 * s)
    return float(bytes_), float(flops)


def _mine_batched_cost(g: dict):
    """One ``mithril_pairwise_batched`` mining barrier: the sorted
    mining table in + candidate pairs out per lane; compute is the
    window*S*S timestamp-closeness compare grid per row."""
    lanes = g.get("lanes", 1)
    n, s, window = g["mine_rows"], g["s_sup"], g["window"]
    bytes_ = lanes * (n * s + 2 * n + n * window) * 4 * 2
    flops = lanes * n * window * s * 3
    return float(bytes_), float(flops)


def _hash_lookup_cost(g: dict):
    """One ``hash_lookup`` prefetch-table probe launch: the whole
    set-associative prefetch table (keys + P-wide candidate rows)
    streams in once per launch, plus the query block in and the
    candidate lists out; compute is the mix32 hash, the W-way
    compare/argmax and the P-wide found select per query."""
    q, nb = g["queries"], g["n_buckets"]
    w, p = g["ways"], g["plist"]
    bytes_ = (nb * w * (1 + p) + q * (1 + p)) * 4
    flops = q * (8.0 + 4 * w + 2 * p)
    return float(bytes_), float(flops)


def _paged_decode_cost(g: dict):
    """One ``paged_decode`` step: the whole paged KV working set is
    read once (decode is bandwidth-bound), q in / o out; compute is the
    two matmuls over the gathered pages."""
    b, hq, hkv = g["batch"], g["heads_q"], g["heads_kv"]
    hd, ps, npg = g["head_dim"], g["page_size"], g["n_pages"]
    bytes_ = (2 * b * npg * ps * hkv * hd + 2 * b * hq * hd) * 4
    flops = 4.0 * b * hq * npg * ps * hd
    return float(bytes_), float(flops)


#: kernel name -> cost fn(geometry dict) -> (bytes_moved, flops).
#: Names match the ``ops`` launch counters.
KERNEL_MODELS = {
    "mithril_record_fused": _record_fused_cost,
    "mithril_mine_batched": _mine_batched_cost,
    "hash_lookup": _hash_lookup_cost,
    "paged_decode": _paged_decode_cost,
}


@dataclasses.dataclass
class KernelRoofline:
    kernel: str
    geometry: dict
    backend: str
    bytes_moved: float
    flops: float
    peak_flops: float
    peak_bw: float
    trusted_peaks: bool

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, flops per byte moved."""
        return self.flops / self.bytes_moved

    @property
    def peak_fraction(self) -> float:
        """Attainable fraction of machine peak flops at this intensity
        (1.0 when compute-bound: the memory roofline does not bind)."""
        return min(1.0, self.intensity * self.peak_bw / self.peak_flops)

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "intensity": self.intensity,
                "peak_fraction": self.peak_fraction}


def analyze_kernel(name: str, geometry: dict,
                   backend: Union[None, str, torch.device] = None
                   ) -> KernelRoofline:
    """Per-kernel roofline point for one launch geometry."""
    peaks = machine_peaks(backend)
    bytes_, flops = KERNEL_MODELS[name](dict(geometry))
    return KernelRoofline(
        kernel=name, geometry=dict(geometry), backend=peaks.backend,
        bytes_moved=bytes_, flops=flops,
        peak_flops=peaks.flops_per_s, peak_bw=peaks.bytes_per_s,
        trusted_peaks=peaks.trusted)
