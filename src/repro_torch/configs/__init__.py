"""Configurations of the paper's own experiments."""

from .mithril_paper import PAPER_MITHRIL, SUITE_MITHRIL, paper_sim

__all__ = ["PAPER_MITHRIL", "SUITE_MITHRIL", "paper_sim"]
