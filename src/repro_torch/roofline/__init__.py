"""The cost model: cell rooflines from the dry run and per-kernel
rooflines of the MITHRIL launches (``analysis``)."""

from .analysis import (H100_HBM_BW, H100_PEAK_FLOPS, HBM_BW, ICI_BW,
                       KERNEL_MODELS, PEAK_FLOPS, KernelRoofline,
                       MachinePeaks, Roofline, analyze_cell, analyze_kernel,
                       attention_extra, machine_peaks, model_flops,
                       rwkv_chunk_extra, save_roofline)

__all__ = ["H100_HBM_BW", "H100_PEAK_FLOPS", "HBM_BW", "ICI_BW",
           "KERNEL_MODELS", "PEAK_FLOPS", "KernelRoofline", "MachinePeaks",
           "Roofline", "analyze_cell", "analyze_kernel", "attention_extra",
           "machine_peaks", "model_flops", "rwkv_chunk_extra",
           "save_roofline"]
